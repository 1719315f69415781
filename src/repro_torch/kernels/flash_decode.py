"""Split-KV single-query attention for the LM decode path.

:func:`flash_decode` computes, for one new query token per sequence,
q (B, Hq, D) against caches k, v (B, S, Hkv, D) with valid prefix
``lengths`` (B,):

    s   = (q * scale) . k^T               [tanh(s / c) * c with a soft-cap]
    s   = -1e30 where not (ki < len, window: ki > len - 1 - w)
    out = sum_k p v / max(sum_k p, 1e-30),   p = exp(s - max s), 0 if masked

which is the TPU kernel's function (``_decode_kernel``) and equals the
decode path's ``_sdpa`` with ``kv_valid_len = pos + 1``. As the TPU
kernel, it takes q in float32, bf16 or float16 and the caches in any of
those types (one type for both), computes in float32 and returns
``q.dtype``: a 16-bit cache under a float32 q gives the float32 result on
the widened cache (the widening is exact). ``round_kv`` (a dtype, or None)
rounds each K and V value to that type where it is read: what a bf16 or
float16 model's decode path computes over a wider cache, whose JAX form
casts the cache to the model's type first; the kernel reads the cache as
stored, with no copy. Without it the function is the TPU kernel's, which
widens without rounding. For a CUDA tensor the wrapper launches one
kernel or raises, and counts it in ``flash_decode.launches``, by the
types of q and the cache in ``flash_decode.dtypes`` and by body in
``flash_decode.bodies``; for a CPU tensor it runs
:func:`flash_decode_plain`. For the dry run's fake tensor on a ``meta``
device it makes the CUDA call's checks and reports the launch to the
running ``launch.op_analysis``, which counts it, in place of launching
anything (``launches`` counts only kernels launched). The wrapper reads
nothing back from the card: each sequence's visible keys are cut into
splits on the device. :func:`decode_body` picks the body from shapes,
types and alignment before the launch:

* ``"split"``: a float32 or float16 cache, ``csrc/flash_decode.cu``, grid
  (sequence x kv head, split); the splits follow :func:`split_ranges`
  under the upper limit :func:`default_splits` (or ``num_splits``), and
  the last block of each sequence and kv head merges them through scratch
  and a ticket. A float16 cache is read as stored, 2 bytes a value.
* ``"cluster"``: a bf16 cache, ``csrc/flash_decode_bf16.cu``, read as
  stored, one thread block cluster of :func:`cluster_size` blocks per
  sequence and kv head, rows taking the sequences in
  :func:`cluster_order`, keys cut by :func:`cluster_ranges`; the splits
  merge in the cluster's shared memory, so a launch holds no state on the
  host. It takes a float32 or bf16 q; a float16 q is widened (exactly) and
  the result rounded once to float16.
* ``"general"``: ``csrc/attention_any.cu``, every other shape the TPU
  kernel takes: any head dim, more than ``MAX_GROUP`` query heads a kv head
  (the group's heads are the MMA rows, so a K / V tile is read once a
  chunk of 32 heads), operands off a 16-byte boundary, any B x Hkv, and a
  rounding the fast bodies do not make; both products on the tensor
  cores, on ``flash_attention.general_plan``'s plan. Its splits are the
  split body's (:func:`split_ranges` under the same limit), merged the
  same way. Head dims past its shared memory take the wide path
  (``csrc/attention_wide.cu``: CUDA cores, 8 heads a block, not split).
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import is_fake_meta
from repro_torch.kernels.dcn_fused import (H100_SMS, _check_operands, _stream,
                                          dtype_code)
from repro_torch.kernels.flash_attention import (ATTN_DTYPES, MAX_HEAD_DIM,
                                                 NEG_INF, NO_WINDOW,
                                                 _check_gqa, _check_options,
                                                 check_attention_dtypes,
                                                 count_body, general_launch,
                                                 general_plan)

# The bf16 cluster body's grid carries B x Hkv in a dimension of at most
# 65,535 blocks.
MAX_GRID_ROWS = 65535
# Blocks of equal work the kernel's split rule aims at, per SM; the
# grid's upper limit on splits lets one sequence take twice its even share.
_BLOCKS_PER_SM = 4
# Fewest keys of a split that is not its sequence's only one, and the key
# tile (one warp stage of csrc/flash_decode.cu) whose whole multiples the
# splits are cut in.
_MIN_SPLIT_KEYS = 64
KEY_TILE = 8
# The kernel's `target` under an explicit split count: 64 keys a split.
_NO_TARGET = 2**31 - 1
# Query heads per kv head the fast bodies hold in registers, at most (the
# general body takes any group, 16 heads an MMA row fragment).
MAX_GROUP = 8
# Per (device, stream): the float32-cache kernel's zeroed tickets, one per
# (sequence, kv head); every launch leaves them zero again.
_TICKETS: dict = {}
# The bf16-cache kernel (csrc/flash_decode_bf16.cu): keys a stage (a
# consumer warp's unit, whole multiples of which its splits are cut in),
# the cluster limit (the portable one), and the blocks an SM its shared
# memory is sized for.
STAGE_KEYS = 16
MAX_CLUSTER = 8
_CLUSTER_BLOCKS_PER_SM = 3


def flash_decode_plain(q, k_cache, v_cache, lengths, *,
                       window: int | None = None,
                       softcap: float | None = None,
                       scale: float, round_kv=None) -> torch.Tensor:
    """Plain torch version of the decode kernel (masked full softmax in
    float32), in ``q.dtype``; ``round_kv`` as for :func:`flash_decode`."""
    if round_kv is not None:
        k_cache = k_cache.to(round_kv)
        v_cache = v_cache.to(round_kv)
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
    return out.reshape(b, hq, d).to(q.dtype)


def default_splits(batch: int, kv_heads: int, s_len: int,
                   sm_count: int = H100_SMS) -> int:
    """Upper limit on the KV splits per (sequence, kv head), from shapes
    alone: twice a sequence's even share of ``_BLOCKS_PER_SM * sm_count``
    blocks, never more than a full cache of ``_MIN_SPLIT_KEYS``-key
    splits."""
    pairs = max(batch * kv_heads, 1)
    return max(1, min(math.ceil(2 * _BLOCKS_PER_SM * sm_count / pairs),
                      math.ceil(s_len / _MIN_SPLIT_KEYS)))


def _visible(lengths, s_len: int, window: int | None):
    """(first visible key, visible keys) of each sequence."""
    out = []
    for length in lengths:
        lo = max(0, length - window) if window is not None else 0
        out.append((lo, max(0, min(length, s_len) - lo)))
    return out


def split_ranges(lengths, s_len: int, splits: int, kv_heads: int,
                 window: int | None = None,
                 target: int | None = _BLOCKS_PER_SM * H100_SMS
                 ) -> list[list[tuple[int, int]]]:
    """Per sequence, the key ranges ``[a, e)`` the kernel gives its splits.

    A sequence's visible keys ``[max(0, length - window), min(length,
    s_len))`` (as :func:`flash_decode_plain` masks them) are cut into
    ``clamp(visible // keys, 1, splits)`` near-equal runs of whole
    ``KEY_TILE``-key tiles, the last one ending at the range's end; none
    when no key is visible. ``keys`` is ``kv_heads`` times the batch's
    visible keys over ``target`` blocks, at least ``_MIN_SPLIT_KEYS``,
    rounded up to whole tiles; with ``target=None`` (an explicit
    ``num_splits``) it is ``_MIN_SPLIT_KEYS``. The kernels' ``split_of``
    (``csrc/kv_split.cuh``, one copy for the split and general bodies) is
    this rule."""
    vis = _visible(lengths, s_len, window)
    total = sum(n for _, n in vis)
    keys = _MIN_SPLIT_KEYS
    if target is not None:
        keys = max(keys, -(-total * kv_heads // target))
    keys = -(-keys // KEY_TILE) * KEY_TILE
    out = []
    for lo, n_vis in vis:
        if n_vis == 0:
            out.append([])
            continue
        n = min(splits, max(1, n_vis // keys))
        n_t = -(-n_vis // KEY_TILE)
        out.append([(lo + KEY_TILE * (n_t * i // n),
                     min(lo + n_vis, lo + KEY_TILE * (n_t * (i + 1) // n)))
                    for i in range(n)])
    return out


def cluster_size(batch: int, kv_heads: int, s_len: int,
                 sm_count: int = H100_SMS,
                 num_splits: int | None = None) -> int:
    """Blocks of the bf16-cache kernel's cluster, one cluster per
    (sequence, kv head), from shapes alone: twice a pair's even share of
    one wave (``_CLUSTER_BLOCKS_PER_SM`` blocks an SM), at most
    ``MAX_CLUSTER``, the cache's stages and ``num_splits``. Up to 45 pairs
    the grid is one wave on an H100, which runs 45 clusters of 8 at once
    at three blocks an SM."""
    pairs = max(batch * kv_heads, 1)
    c = -(-2 * _CLUSTER_BLOCKS_PER_SM * sm_count // pairs)
    c = min(c, MAX_CLUSTER, -(-s_len // STAGE_KEYS), num_splits or c)
    return max(1, c)


def cluster_order(lengths, s_len: int, window: int | None = None
                  ) -> list[int]:
    """The sequence each cluster row of the bf16-cache kernel serves (row
    r: kv heads ``r * Hkv ..``): most visible keys first, ties by index,
    so the longest blocks start first. The kernel's ``ranked`` is this
    rule."""
    vis = _visible(lengths, s_len, window)
    return sorted(range(len(vis)), key=lambda i: (-vis[i][1], i))


def cluster_ranges(lengths, s_len: int, cluster: int,
                   window: int | None = None,
                   num_splits: int | None = None
                   ) -> list[list[tuple[int, int]]]:
    """Per sequence, the key ranges ``[a, e)`` of the bf16-cache kernel's
    blocks that have keys, in cluster rank (= split) order.

    A sequence's visible keys are ``nt`` stages of ``STAGE_KEYS``; its
    ``n`` splits are the stages themselves, or with ``num_splits`` the
    rule of :func:`split_ranges`' explicit count, ``min(num_splits,
    visible // 64)`` (at least one) runs of whole stages; ``nb = min(
    cluster, n)`` blocks take them, block j the consecutive splits ``[j n
    / nb, (j + 1) n / nb)`` as one range. None when no key is visible. The
    kernel's ``range_of`` is this rule."""
    out = []
    for lo, n_vis in _visible(lengths, s_len, window):
        if n_vis == 0:
            out.append([])
            continue
        nt = -(-n_vis // STAGE_KEYS)
        n = (max(1, min(num_splits, n_vis // _MIN_SPLIT_KEYS))
             if num_splits else nt)
        nb = min(cluster, n)
        out.append([(lo + STAGE_KEYS * (j * n // nb * nt // n),
                     min(lo + n_vis,
                         lo + STAGE_KEYS * ((j + 1) * n // nb * nt // n)))
                    for j in range(nb)])
    return out


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets for launches on ``stream``."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def decode_body(d: int, g: int, dtype=torch.float32, aligned: bool = True,
                pairs: int = 1, round_kv=None) -> str:
    """The body of #8 for head dim ``d``, ``g`` query heads a kv head, a
    cache of ``dtype``, q and the caches on 16-byte boundaries
    (``aligned``), ``pairs`` = B x Hkv and the rounding ``round_kv``:
    ``"cluster"`` (a bf16 cache, no rounding, ``pairs`` within a grid
    dimension), ``"split"`` (a float32 cache, or a float16 one without
    rounding) where each 16-byte copy holds whole values of a row (``d`` a
    multiple of 4, or of 8 for a 16-bit cache), ``d`` is at most
    ``MAX_HEAD_DIM`` and ``g`` at most ``MAX_GROUP``; else ``"general"``.
    A pure function of its arguments: the wrapper calls it before
    launching anything."""
    if not aligned or g > MAX_GROUP or d > MAX_HEAD_DIM:
        return "general"
    if dtype == torch.float32:
        return "split" if d % 4 == 0 else "general"
    if d % 8 or round_kv is not None:
        return "general"
    if dtype == torch.bfloat16:
        return "cluster" if pairs <= MAX_GRID_ROWS else "general"
    return "split"


def flash_decode(q, k_cache, v_cache, lengths, *, window: int | None = None,
                 softcap: float | None = None, scale: float | None = None,
                 num_splits: int | None = None,
                 round_kv=None) -> torch.Tensor:
    """(B, Hq, D) attention output of the new token in ``q.dtype``; see
    the module doc. ``lengths`` is int32; a length past S counts as S.
    ``num_splits`` (CUDA only) overrides the split rule: each sequence
    takes ``min(num_splits, visible keys // 64)`` splits (at least one), in
    place of its share of the batch under :func:`default_splits`; over a
    bf16 cache at most ``MAX_CLUSTER`` blocks take them, each a run of
    consecutive splits (:func:`cluster_ranges`). The result does not
    depend on the splits beyond float32 summation order. ``round_kv``:
    None, ``torch.bfloat16`` or ``torch.float16``."""
    check_attention_dtypes(q=q, k_cache=k_cache, v_cache=v_cache)
    dev = _check_operands(dict(q=q, k_cache=k_cache, v_cache=v_cache),
                          dict(lengths=lengths), dtypes=ATTN_DTYPES,
                          fake=True)
    if (q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != q.shape[0]
            or k_cache.shape[3] != q.shape[2]
            or tuple(lengths.shape) != (q.shape[0],)):
        raise ValueError(
            f"q {tuple(q.shape)} must be (B, Hq, D), k/v caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} (B, S, Hkv, "
            f"D) and lengths {tuple(lengths.shape)} (B,)")
    if round_kv not in (None, torch.bfloat16, torch.float16):
        raise ValueError(f"round_kv must be None, torch.bfloat16 or "
                         f"torch.float16, got {round_kv!r}")
    if round_kv == k_cache.dtype:
        round_kv = None             # rounding to the cache's own type
    b, hq, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    _check_gqa(hq, hkv)
    _check_options(window, softcap)
    scale = float(scale) if scale is not None else d ** -0.5
    if dev.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  window=window, softcap=softcap,
                                  scale=scale, round_kv=round_kv)
    fake = is_fake_meta(q)
    aligned = fake or all(t.data_ptr() % 16 == 0
                          for t in (q, k_cache, v_cache))
    body = decode_body(d, hq // hkv, k_cache.dtype, aligned, b * hkv,
                       round_kv)
    sms = H100_SMS if fake else \
        torch.cuda.get_device_properties(dev).multi_processor_count
    splits = num_splits or default_splits(b, hkv, s_len, sms)
    if not 1 <= splits <= min(max(s_len, 1), 65535):
        raise ValueError(f"num_splits {splits} must be in [1, S={s_len}] "
                         f"and at most 65535")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if body == "general":
        plan = general_plan(1, d, hq // hkv, b * hkv, q.dtype, k_cache.dtype,
                            round_kv=round_kv, splits=splits, ptrs=(
                                (0, 0, 0) if fake else
                                tuple(t.data_ptr()
                                      for t in (q, k_cache, v_cache))))
    if fake:            # the dry run: reported, nothing launched
        from repro_torch.launch import op_analysis

        op_analysis.kernel_launch("flash_decode",
                                  (q, k_cache, v_cache, lengths), out,
                                  plain_flops(b, s_len, hq, d))
        return out
    from repro_torch.kernels import _build

    lib = _build.load()
    stream = _stream(q)
    key = "/".join(str(t.dtype).removeprefix("torch.") for t in (q, k_cache))
    cap = 0.0 if softcap is None else float(softcap)
    target = _BLOCKS_PER_SM * sms if num_splits is None else _NO_TARGET
    if body == "general":
        part = tickets = None
        if plan["splits"] > 1:
            part = torch.empty(b * hq * plan["splits"] * (2 + d) + 4,
                               dtype=torch.float32, device=dev)
            tickets = _tickets(dev, stream, b * hkv * plan["row_tiles"])
        general_launch(lib, q, k_cache, v_cache, lengths, out, 1, plan, sq=1,
                       causal=False, window=window, softcap=softcap,
                       scale=scale, round_to=round_kv, part=part,
                       tickets=tickets, target=target)
    elif body == "cluster":
        # The cluster body takes a float32 or bf16 q: a float16 one is
        # widened (exactly) and the result rounded once.
        qk = q.float() if q.dtype == torch.float16 else q
        ok = out if qk.dtype == q.dtype else torch.empty(
            out.shape, dtype=qk.dtype, device=dev)
        with torch.cuda.device(dev):
            err = lib.flash_decode_bf16_launch(
                qk.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), ok.data_ptr(), b, s_len, hq, hkv, d,
                cluster_size(b, hkv, s_len, sms, num_splits),
                num_splits or 0, NO_WINDOW if window is None else int(window),
                int(qk.dtype == torch.bfloat16), scale, cap, stream)
        _build.check(err, "flash_decode_bf16_launch")
        if ok is not out:
            out.copy_(ok)
    else:
        # Per-split state (m, l, acc) of the sequences that take more than
        # one split, merged by their last block.
        part = torch.empty(b * hq * splits * (2 + d), dtype=torch.float32,
                           device=dev)
        tickets = _tickets(dev, stream, b * hkv)
        with torch.cuda.device(dev):
            err = lib.flash_decode_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                out.data_ptr(), b, s_len, hq, hkv, d, splits, target,
                NO_WINDOW if window is None else int(window),
                dtype_code(q.dtype), dtype_code(k_cache.dtype),
                0 if round_kv is None else dtype_code(round_kv), scale, cap,
                stream)
        _build.check(err, "flash_decode_launch")
    count_body(flash_decode, body, key)
    return out


def plain_flops(b: int, s_len: int, hq: int, d: int) -> int:
    """The FLOPs of :func:`flash_decode_plain` on these shapes: its two
    products over every cache row, as ``torch.utils.flop_counter`` counts
    them (and the JAX ``_sdpa``'s dots). The dry run charges them to each
    launch."""
    return 4 * b * s_len * hq * d


flash_decode.launches = 0
# Launches by "q dtype/cache dtype", e.g. "float32/bfloat16".
flash_decode.dtypes = {}
# Launches by body (:func:`decode_body`: "split", "cluster", "general").
flash_decode.bodies = {}
