"""Split-KV single-query attention for the LM decode path.

:func:`flash_decode` computes, for one new query token per sequence,
q (B, Hq, D) against caches k, v (B, S, Hkv, D) with valid prefix
``lengths`` (B,):

    s   = (q * scale) . k^T               [tanh(s / c) * c with a soft-cap]
    s   = -1e30 where not (ki < len, window: ki > len - 1 - w)
    out = sum_k p v / max(sum_k p, 1e-30),   p = exp(s - max s), 0 if masked

which is the TPU kernel's function (``_decode_kernel``) and equals the
decode path's ``_sdpa`` with ``kv_valid_len = pos + 1``. For a CUDA tensor
the wrapper launches the two kernels of ``csrc/flash_decode.cu`` (the
split pass, then the pass that combines the splits) or raises, and counts
the pair as one launch in ``flash_decode.launches``; for a CPU tensor it
runs
:func:`flash_decode_plain`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.dcn_fused import _check_operands, _stream
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, NEG_INF,
                                                 NO_WINDOW, _check_gqa,
                                                 _check_options)

# Blocks the split pass aims to have in flight: three resident blocks on
# each of the H100's 132 SMs.
_TARGET_BLOCKS = 3 * 132
_MIN_SPLIT_KEYS = 64


def flash_decode_plain(q, k_cache, v_cache, lengths, *,
                       window: int | None = None,
                       softcap: float | None = None,
                       scale: float) -> torch.Tensor:
    """Plain torch version of the decode kernel (masked full softmax)."""
    b, hq, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q.float() * scale).reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    ki = torch.arange(s_len, device=q.device)[None, :]
    length = lengths.long()[:, None]
    mask = ki < length
    if window is not None:
        mask &= ki > length - 1 - window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, d)


def default_splits(batch: int, kv_heads: int, s_len: int) -> int:
    """KV splits per (sequence, kv head) that put about ``_TARGET_BLOCKS``
    blocks on the card, with at least ``_MIN_SPLIT_KEYS`` keys a split."""
    pairs = max(batch * kv_heads, 1)
    return max(1, min(math.ceil(_TARGET_BLOCKS / pairs),
                      math.ceil(s_len / _MIN_SPLIT_KEYS)))


def flash_decode(q, k_cache, v_cache, lengths, *, window: int | None = None,
                 softcap: float | None = None, scale: float | None = None,
                 num_splits: int | None = None) -> torch.Tensor:
    """(B, Hq, D) float32 attention output of the new token; see the
    module doc. ``lengths`` is int32; a length past S counts as S.
    ``num_splits`` (CUDA only) overrides :func:`default_splits`; the result
    does not depend on it beyond float32 summation order."""
    dev = _check_operands(dict(q=q, k_cache=k_cache, v_cache=v_cache),
                          dict(lengths=lengths))
    if (q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != q.shape[0]
            or k_cache.shape[3] != q.shape[2]
            or tuple(lengths.shape) != (q.shape[0],)):
        raise ValueError(
            f"q {tuple(q.shape)} must be (B, Hq, D), k/v caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} (B, S, Hkv, "
            f"D) and lengths {tuple(lengths.shape)} (B,)")
    b, hq, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    _check_gqa(hq, hkv)
    _check_options(window, softcap)
    scale = float(scale) if scale is not None else d ** -0.5
    if dev.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  window=window, softcap=softcap,
                                  scale=scale)
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 4 and at most "
                         f"{MAX_HEAD_DIM} for the CUDA kernel")
    splits = num_splits or default_splits(b, hkv, s_len)
    if not 1 <= splits <= max(s_len, 1):
        raise ValueError(f"num_splits {splits} must be in [1, S={s_len}]")
    from repro_torch.kernels import _build

    lib = _build.load()
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # Per-split partial state (m, l, acc) for the combine pass.
    part_ml = torch.empty((2, b * hq, splits), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((b * hq, splits, d), dtype=torch.float32,
                           device=dev)
    win = NO_WINDOW if window is None else int(window)
    stream = _stream(q)
    err = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), b,
        s_len, hq, hkv, d, splits, win, scale,
        0.0 if softcap is None else float(softcap), stream)
    _build.check(err, "flash_decode_launch")
    err = lib.flash_decode_combine_launch(
        lengths.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), b, s_len, hq, d, splits, win, stream)
    _build.check(err, "flash_decode_combine_launch")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
