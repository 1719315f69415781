"""Flash attention for the LM prefill path (causal, GQA, sliding window,
tanh logit soft-cap).

:func:`flash_attention` computes, for q (B, Sq, Hq, D) against k, v
(B, Skv, Hkv, D) with q head ``h`` reading kv head ``h // (Hq / Hkv)``:

    s   = (q * scale) . k^T               [tanh(s / c) * c with a soft-cap]
    qi  = i + (Skv - Sq)                  (the query's absolute key time)
    s   = -1e30 where not (ki < Skv, causal: qi >= ki, window: qi - ki < w)
    out = sum_k p v / max(sum_k p, 1e-30),   p = exp(s - max s), 0 if masked

which is the TPU kernel's function (``_flash_kernel``): a query row with no
visible key gives 0. For a CUDA tensor the wrapper launches the kernel in
``csrc/flash_attention.cu`` or raises, and counts the launch in
``flash_attention.launches``; for a CPU tensor it runs
:func:`flash_attention_plain`, the masked full-softmax form with the same
conventions. The kernel takes head dims that are multiples of 4 up to
144, with the tiles :func:`tile_config` gives; a larger one raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dcn_fused import _check_operands, _stream

NEG_INF = -1e30
# ``window=None`` goes to the kernel as INT32_MAX: qi - ki < 2**31 - 1
# holds for every int32 position, so the sentinel is the same mask as no
# window at all. ``softcap=None`` goes as 0, which no valid cap takes.
NO_WINDOW = 2**31 - 1
MAX_HEAD_DIM = 256
# Head dims the CUDA kernel takes: multiples of 4 up to 144 (the configs'
# largest, Gemma-2's), zero-padded to a multiple of 16 in shared memory.
MAX_KERNEL_HEAD_DIM = 144
BLOCK_K = 32                    # keys per K/V tile of the kernel
SMEM_LIMIT = 232_448            # shared memory a block may use on Hopper


def tile_config(d: int) -> dict:
    """The CUDA kernel's tiles for head dim ``d``: ``dp`` (d padded to a
    multiple of 16), ``block_q`` query rows a block (one warpgroup of 128
    threads per 64 rows: 128 where the shared memory holds it, else 64),
    ``block_k`` keys a tile, ``threads`` and ``smem_bytes``: q's TF32 high
    and low parts, the current K and V^T tiles' high and low parts, the
    next K and V tiles as they land (rows of ``dp + 4`` floats) and their
    mbarrier, ``4 * (2 * block_q * dp + 4 * block_k * dp + 2 * block_k *
    (dp + 4)) + 8``."""
    if d % 4 or not 4 <= d <= MAX_KERNEL_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 4 in [4, "
                         f"{MAX_KERNEL_HEAD_DIM}] for the CUDA kernel")
    dp = -(-d // 16) * 16

    def smem(block_q):
        return 4 * (2 * block_q * dp + 4 * BLOCK_K * dp
                    + 2 * BLOCK_K * (dp + 4)) + 8

    block_q = 128 if smem(128) <= SMEM_LIMIT else 64
    return dict(dp=dp, block_q=block_q, block_k=BLOCK_K,
                threads=2 * block_q, smem_bytes=smem(block_q))


def _check_options(window, softcap) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")


def _check_gqa(hq: int, hkv: int) -> None:
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          scale: float) -> torch.Tensor:
    """Plain torch version of the flash kernel (full masked softmax with
    the kernel's -1e30 / max(l, 1e-30) conventions)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # (b, q, h, g, 1)
    return (out / l.clamp_min(1e-30)).reshape(b, sq, hq, d)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Sq, Hq, D) float32 attention output; see the module doc.
    ``scale`` defaults to D**-0.5."""
    dev = _check_operands(dict(q=q, k=k, v=v), {})
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Sq, Hq, D) and "
                         f"k, v {tuple(k.shape)} / {tuple(v.shape)} equal "
                         f"(B, Skv, Hkv, D)")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in batch or head_dim")
    _check_gqa(hq, hkv)
    _check_options(window, softcap)
    scale = float(scale) if scale is not None else d ** -0.5
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    tiles = tile_config(d)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned for the CUDA "
                         "kernel")
    from repro_torch.kernels import _build

    lib = _build.load()
    out = torch.empty((b, sq, hq, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, hq, hkv, d, int(causal),
            NO_WINDOW if window is None else int(window), tiles["block_q"],
            scale, 0.0 if softcap is None else float(softcap), _stream(q))
    _build.check(err, "flash_attention_launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
