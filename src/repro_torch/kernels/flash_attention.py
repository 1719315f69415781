"""Flash attention for the LM prefill path (causal, GQA, sliding window,
tanh logit soft-cap).

:func:`flash_attention` computes, for q (B, Sq, Hq, D) against k, v
(B, Skv, Hkv, D) with q head ``h`` reading kv head ``h // (Hq / Hkv)``:

    s   = (q * scale) . k^T               [tanh(s / c) * c with a soft-cap]
    qi  = i + (Skv - Sq)                  (the query's absolute key time)
    s   = -1e30 where not (ki < Skv, causal: qi >= ki, window: qi - ki < w)
    out = sum_k p v / max(sum_k p, 1e-30),   p = exp(s - max s), 0 if masked

which is the TPU kernel's function (``_flash_kernel``): a query row with no
visible key gives 0. As the TPU kernel, it takes float32, bf16 or float16
operands, computes in float32 (a 16-bit value widens exactly) and returns
``q.dtype``. For a CUDA tensor the wrapper launches one kernel or raises,
and counts the launch in ``flash_attention.launches``, by the kernel's
operand type in ``flash_attention.dtypes`` and by body in
``flash_attention.bodies``. :func:`attention_body` picks the body from the
head dim, the type and the operands' alignment before the launch:

* ``"tf32"``: ``csrc/flash_attention.cu``'s float32 kernel (3xTF32
  products), float32 operands, head dims that are multiples of 4 up to
  144;
* ``"16bit"``: its 16-bit kernel (bf16 or float16 wgmma on swizzled TMA
  tiles, P rounded to the operands' type for the P V product, the output
  rounded once), bf16 or float16 operands, head dims that are multiples of
  8 up to 144;
* ``"general"``: ``csrc/attention_any.cu``, every other shape the TPU
  kernel takes: any head dim, operands off a 16-byte boundary; both
  products on the tensor cores (``mma.sync``: bf16 / float16 with P
  rounded to the operands' type, 3xTF32 in float32), launched on
  :func:`general_plan`'s plan; a head dim whose whole-D tiles pass the
  shared memory (from 1185 in float32, 1409 in 16 bits) takes its wide
  path, ``csrc/attention_wide.cu`` (CUDA cores, 128 output
  columns a block, the scores recomputed a slice).

Every body's grid is flat (one block a row's query tile, or a row's slice),
so the (batch x head) rows are bounded only by 2^31 - 1 blocks.

The fast bodies' tiles are :func:`tile_config`'s. Mixed operands (a 16-bit
q over float32 k, v, or the reverse) are widened to float32, which is
exact, and go to a float32 body; the output is cast to ``q.dtype``. For a
CPU tensor it runs :func:`flash_attention_plain`, the masked full-softmax
form with the same conventions. For the dry run's fake tensor on a
``meta`` device (``launch.dryrun``) it makes the CUDA call's checks and
reports the launch to the running ``launch.op_analysis``, which counts it,
in place of launching anything (``launches`` counts only kernels
launched); its output is an empty tensor of the result's shape.
"""

from __future__ import annotations

import torch

from repro_torch._device import is_fake_meta
from repro_torch.kernels.dcn_fused import _check_operands, _stream, dtype_code

NEG_INF = -1e30
# ``window=None`` goes to the kernel as INT32_MAX: qi - ki < 2**31 - 1
# holds for every int32 position, so the sentinel is the same mask as no
# window at all. ``softcap=None`` goes as 0, which no valid cap takes.
NO_WINDOW = 2**31 - 1
# The largest head dim of #8's fast bodies (csrc/flash_decode*.cu).
MAX_HEAD_DIM = 256
# Head dims #7's fast bodies take: multiples of 4 (float32) or 8 (16-bit)
# up to 144 (the configs' largest, Gemma-2's), zero-padded to a multiple of
# 16 in shared memory; the general body takes the rest.
MAX_KERNEL_HEAD_DIM = 144
BLOCK_K = 32                    # keys per K/V tile of the float32 kernel
BLOCK_K_BF16 = 64               # and of the bf16 kernel
STAGES_BF16 = 4                 # K / V tiles each ring of it holds
SMEM_LIMIT = 232_448            # shared memory a block may use on Hopper
# The general body (csrc/attention_any.cu): keys a K / V tile at most, the
# tiles its ring holds (at least, at most), O columns a warp holds in
# registers, warps a block.
GENERAL_KEYS = 64
GENERAL_STAGES = 2
GENERAL_MAX_STAGES = 4
GENERAL_COLS = 256
GENERAL_WARPS = 8
# #8's row fragments a block at most (32 query heads a group chunk). A
# fragment's warps share nothing with another fragment's: Falcon-7B's 71
# heads as five fragments of one block gave each warp a whole tile's
# products and softmax, and the block that merges the splits all 71 rows
# of partials; two fragments of two column warps halve the first and
# spread the second over three blocks (PERF.md §6, `kernel_ab --only any`).
GENERAL_DECODE_FRAGS = 2
# Output columns a block of the general route's wide path holds
# (csrc/attention_wide.cu `DV`): the head dims the tensor-core body's tiles
# do not fit are cut into slices of this many on the grid's y dimension.
WIDE_COLS = 128
# The operand types of #7 and #8 (each computes in float32).
ATTN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
HALF_DTYPES = (torch.bfloat16, torch.float16)


def check_attention_dtypes(**operands) -> None:
    """#7's and #8's operand types: each float32, bfloat16 or float16,
    and the key and value operands (the last two) of one type."""
    for name, t in operands.items():
        if t.dtype not in ATTN_DTYPES:
            raise ValueError(f"{name} must be float32, bfloat16 or float16, "
                             f"got {t.dtype}")
    (kn, k), (vn, v) = list(operands.items())[-2:]
    if k.dtype != v.dtype:
        raise ValueError(f"{kn} ({k.dtype}) and {vn} ({v.dtype}) must share "
                         f"one dtype")


def tile_config(d: int, dtype=torch.float32) -> dict:
    """The CUDA kernel's tiles for head dim ``d`` and operand ``dtype``:
    ``dp`` (d padded to a multiple of 16), ``block_q`` query rows a block
    (64 a consumer warpgroup of 128 threads), ``block_k`` keys a tile,
    ``threads`` and ``smem_bytes``.

    float32: ``block_q`` 128 where the shared memory holds it, else 64;
    32-key tiles; q's TF32 high and low parts, the current K and V^T
    tiles' high and low parts, the next K and V tiles as they land (rows
    of ``dp + 4`` floats) and their mbarrier, ``4 * (2 * block_q * dp + 4
    * block_k * dp + 2 * block_k * (dp + 4)) + 8`` bytes.

    bfloat16 or float16 (``d`` a multiple of 8; one kernel, both 2-byte
    types): ``block_q`` 128, 64-key tiles, two
    consumer warpgroups and a producer warp (288 threads, 168 registers
    a thread). Every tile lands by TMA in swizzled panels of ``swizzle``
    bytes a row: 128 (64 values) where ``dp`` is a multiple of 64, else
    64 where it is one of 32, else 32. K and V each have a ring of
    ``stages`` = 4 tiles; the bytes are 1,024 to align the base, q ``2 *
    block_q * dp``, the rings ``4 * stages * block_k * dp`` and ``4 *
    stages + 1`` mbarriers of 8 (the rings' and q's): 185,480 at ``dp``
    144. Per 64-key tile a warpgroup runs ``dp / 16`` wgmma steps for Q
    K^T and 4 for P V, each ``dp`` wide: a padded ``dp`` costs ``dp /
    d`` times the operations of ``d``."""
    if dtype in HALF_DTYPES:
        if d % 8 or not 8 <= d <= MAX_KERNEL_HEAD_DIM:
            raise ValueError(f"head_dim {d} must be a multiple of 8 in [8, "
                             f"{MAX_KERNEL_HEAD_DIM}] for the 16-bit CUDA "
                             f"kernel")
        dp = -(-d // 16) * 16
        bq, bk, stages = 128, BLOCK_K_BF16, STAGES_BF16
        swizzle = 128 if dp % 64 == 0 else 64 if dp % 32 == 0 else 32
        return dict(dp=dp, block_q=bq, block_k=bk, threads=2 * 128 + 32,
                    smem_bytes=1024 + 2 * bq * dp + 4 * stages * bk * dp
                    + 8 * (4 * stages + 1), swizzle=swizzle, stages=stages)
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


def attention_body(d: int, dtype=torch.float32, aligned: bool = True) -> str:
    """The body of #7 for head dim ``d`` on operands of ``dtype`` (mixed
    operands: float32), whose pointers all lie on 16-byte boundaries
    (``aligned``): ``"tf32"`` (the float32 kernel), ``"16bit"`` (the
    bf16 / float16 kernel) where :func:`tile_config` takes ``d``, else
    ``"general"``. A pure function of its arguments: the wrapper calls it
    before launching anything."""
    if aligned:
        step = 8 if dtype in HALF_DTYPES else 4
        if d % step == 0 and step <= d <= MAX_KERNEL_HEAD_DIM:
            return "16bit" if dtype in HALF_DTYPES else "tf32"
    return "general"


def copy_width(ptr: int, d: int, size: int) -> int:
    """The general body's copy of rows of ``d`` values of ``size`` bytes
    from address ``ptr``: 16 or 4 bytes (``cp.async``) where both the
    address and the row's bytes are whole multiples of it, else one value
    a load."""
    for width in (16, 4):
        if ptr % width == 0 and d * size % width == 0:
            return width
    return size


def general_layout(d: int, rf: int, cw: int, bk: int, stages: int,
                   half: bool, kv_size: int) -> dict:
    """The general body's shared memory (``layout`` in
    ``csrc/attention_any.cu``, the same rule) for head dim ``d``, ``rf``
    row fragments of 16 rows, ``cw`` column warps a fragment, ``bk``-key
    tiles and a ring of ``stages``; ``half``: the 16-bit body (q, k, v of
    one 16-bit type), else TF32; ``kv_size`` bytes a K / V value.

    ``dp``: d padded to a multiple of 16; ``col_w``: O columns a column
    warp holds; ``cs`` S warps a fragment (the largest power of two within
    ``cw`` and the tile's MMA steps), each scoring ``bk / cs`` keys. Regions,
    from a 1024-byte aligned base: the K and V rings (``stages`` tiles of
    ``bk`` rows in panels of 128 bytes, ``dp`` rounded up to whole panels),
    q (``16 rf`` rows of ``dp + 8`` 16-bit values or ``dp + 4`` floats,
    q * scale), P (``rf`` x 16 rows of ``bk + 8`` 16-bit values or ``bk +
    4`` floats), the row maxima and sums (``2 rf cw`` x 16 floats), the
    ring's four mbarriers and 16 bytes of merge flag; the output's stage
    (``16 rf`` rows of ``dp + 4`` floats) reuses the rings' and q's bytes,
    which are made at least as many; 1024 bytes to align the base."""
    dp = -(-d // 16) * 16
    col_w = -(-(-(-dp // cw)) // 16) * 16
    steps = bk // (16 if half else 8)
    cs = 1
    while 2 * cs <= min(cw, steps):
        cs *= 2
    qsz = 2 if half else 4
    wk = 128 // kv_size
    dpw = -(-dp // wk) * wk
    ldq = dp + 8 if half else dp + 4
    ldp = bk + 8 if half else bk + 4
    ring = stages * bk * dpw * kv_size
    p_off = max(2 * ring + 16 * rf * ldq * qsz, 16 * rf * (dp + 4) * 4)
    smem = (p_off + rf * 16 * ldp * qsz + 2 * rf * cw * 16 * 4
            + 8 * GENERAL_MAX_STAGES + 16 + 1024)
    return dict(dp=dp, col_w=col_w, cs=cs, smem_bytes=smem)


def general_plan(mode: int, d: int, rows: int, pairs: int, q_dtype,
                 kv_dtype, *, round_kv=None, ptrs=(0, 0, 0),
                 splits: int = 1) -> dict:
    """The launch plan of the general body, a pure function of shapes,
    types and addresses. ``mode`` 0 (#7): ``rows`` = Sq, ``pairs`` = B x
    Hq; 1 (#8): ``rows`` = the group Hq / Hkv, ``pairs`` = B x Hkv,
    ``splits`` the upper limit on a sequence's splits. ``ptrs``: the
    addresses of q, k, v.

    ``path``: ``"16bit"`` where q and the caches are of one 16-bit type
    and nothing is rounded, else ``"tf32"``. ``cw`` column warps a row
    fragment hold O's ``dp`` columns, at most ``GENERAL_COLS`` each (#8:
    at least four warps a block where the columns allow); ``rf`` row
    fragments of 16 rows (#7: up to 8, 128 query rows; #8: the group's
    heads, up to ``GENERAL_DECODE_FRAGS`` fragments a chunk) and ``bk`` keys a
    tile (64, or 32, 16, 8 (TF32 only) where a wide head dim would pass
    ``SMEM_LIMIT``): the largest ``bk``, then the largest ``rf``, whose
    shared memory at ``GENERAL_STAGES`` stages (:func:`general_layout`)
    fits; then the ring takes up to ``GENERAL_MAX_STAGES`` stages where that
    keeps the block within half an SM's shared memory. ``copy``: the copy
    widths of q, k, v (:func:`copy_width`; 16 for k or v: TMA boxes).
    ``row_tiles``: query tiles a (batch, head) (#7) or group chunks (#8);
    ``blocks`` = pairs x row_tiles x splits, at most 2^31 - 1.

    A head dim whose smallest tiles pass ``SMEM_LIMIT``, or whose columns
    pass the block's warps (from D 1185 over float32 caches, 1409 with q
    and the caches 16-bit, 1793 for another q over 16-bit caches), takes
    ``path`` ``"wide"``:
    ``csrc/attention_wide.cu``, on CUDA cores in 25 KB of shared memory
    whatever D is, ``block_rows`` 32 (#7) or 8 (#8) a block, ``col_slices``
    of ``WIDE_COLS`` columns on the grid's y dimension, not split. Raises
    ``ValueError`` for a grid past 2^31 - 1 blocks."""
    half = (q_dtype == kv_dtype and kv_dtype in HALF_DTYPES
            and round_kv is None)
    kv_size = 2 if kv_dtype in HALF_DTYPES else 4
    q_size = 2 if q_dtype in HALF_DTYPES else 4
    dp = -(-d // 16) * 16
    cw = -(-dp // GENERAL_COLS)
    if cw > GENERAL_WARPS:
        return _wide_plan(mode, d, rows, pairs)
    rf_top = max(1, min(-(-rows // 16), GENERAL_WARPS // cw))
    if mode == 1:
        rf_top = min(rf_top, GENERAL_DECODE_FRAGS)
        cw = max(cw, min(4 // rf_top, dp // 16))
    steps = ((GENERAL_KEYS, 32, 16) if half
             else (GENERAL_KEYS, 32, 16, 8))

    def smem(rf, bk, stages):
        return general_layout(d, rf, cw, bk, stages, half,
                              kv_size)["smem_bytes"]

    fit = None
    for bk in steps:
        for rf in range(rf_top, 0, -1):
            if smem(rf, bk, GENERAL_STAGES) <= SMEM_LIMIT:
                fit = rf, bk
                break
        if fit:
            break
    if fit is None:
        return _wide_plan(mode, d, rows, pairs)
    rf, bk = fit
    stages = GENERAL_STAGES
    room = max(smem(rf, bk, stages), SMEM_LIMIT // 2)
    while (stages < GENERAL_MAX_STAGES
           and smem(rf, bk, stages + 1) <= room):
        stages += 1
    lay = general_layout(d, rf, cw, bk, stages, half, kv_size)
    row_tiles = -(-rows // (16 * rf))
    splits = splits if mode == 1 else 1
    blocks = _grid_blocks(pairs * row_tiles * splits)
    copy = tuple(copy_width(p, d, n) for p, n in
                 zip(ptrs, (q_size, kv_size, kv_size)))
    return dict(path="16bit" if half else "tf32", dp=lay["dp"], rf=rf,
                block_rows=16 * rf, cw=cw, col_w=lay["col_w"],
                cs=lay["cs"], bk=bk, stages=stages, threads=32 * rf * cw,
                smem_bytes=lay["smem_bytes"], copy=copy,
                row_tiles=row_tiles, splits=splits, blocks=blocks)


def _grid_blocks(blocks: int) -> int:
    if blocks > 2**31 - 1:
        raise ValueError(f"the general body's grid of {blocks} blocks is "
                         f"past 2^31 - 1")
    return blocks


def _wide_plan(mode: int, d: int, rows: int, pairs: int) -> dict:
    """:func:`general_plan`'s ``"wide"`` plan (``csrc/attention_wide.cu``):
    4 warps over 32 rows (#7) or 8 query heads (#8) a block, one block a
    ``WIDE_COLS``-column slice of the output."""
    block_rows = 32 if mode == 0 else 8
    row_tiles = -(-rows // block_rows)
    col_slices = -(-d // WIDE_COLS)
    if col_slices > 65535:
        raise ValueError(f"head_dim {d}: the wide path's {col_slices} "
                         f"column slices pass the grid's 65,535")
    return dict(path="wide", block_rows=block_rows, threads=128,
                col_slices=col_slices, row_tiles=row_tiles, splits=1,
                blocks=_grid_blocks(pairs * row_tiles))


def general_launch(lib, q, k, v, lengths, out, mode: int, plan: dict, *,
                   sq: int, causal: bool, window, softcap, scale: float,
                   round_to=None, part=None, tickets=None,
                   target: int = 1) -> None:
    """One launch of ``csrc/attention_any.cu`` (``csrc/attention_wide.cu``
    on a ``"wide"`` plan) on :func:`general_plan`'s ``plan`` (mode 0: #7's
    operands; mode 1: #8's with ``lengths``, the caches as k, v, the split
    rule's ``target`` and, with more than one split, the float32 ``part``
    scratch and the zeroed ``tickets``); ``round_to`` (mode 1) rounds K and
    V to that type where read."""
    from repro_torch.kernels import _build

    b, hkv, d = k.shape[0], k.shape[2], k.shape[3]
    hq = q.shape[-2]
    window = NO_WINDOW if window is None else int(window)
    softcap = 0.0 if softcap is None else float(softcap)
    if plan["path"] == "wide":
        with torch.cuda.device(q.device):
            err = lib.attention_wide_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if lengths is None else lengths.data_ptr(),
                out.data_ptr(), mode, b, sq, k.shape[1], hq, hkv, d,
                int(causal), window, dtype_code(q.dtype), dtype_code(k.dtype),
                0 if round_to is None else dtype_code(round_to), scale,
                softcap, _stream(q))
        _build.check(err, "attention_wide_launch")
        return
    with torch.cuda.device(q.device):
        err = lib.attention_any_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), out.data_ptr(),
            mode, b, sq, k.shape[1], hq, hkv, d, int(causal), window,
            dtype_code(q.dtype), dtype_code(k.dtype),
            0 if round_to is None else dtype_code(round_to), plan["rf"],
            plan["cw"], plan["bk"], plan["stages"], *plan["copy"],
            plan["splits"], target, scale, softcap, _stream(q))
    _build.check(err, "attention_any_launch")


def count_body(fn, body: str, key: str) -> None:
    """One launch of ``fn``'s kernel: counted, tallied by the operand type
    ``key`` in ``fn.dtypes`` and by ``body`` in ``fn.bodies``."""
    fn.launches += 1
    fn.dtypes[key] = fn.dtypes.get(key, 0) + 1
    fn.bodies[body] = fn.bodies.get(body, 0) + 1


def _check_gqa(hq: int, hkv: int) -> None:
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          scale: float) -> torch.Tensor:
    """Plain torch version of the flash kernel (full masked softmax in
    float32 with the kernel's -1e30 / max(l, 1e-30) conventions), in
    ``q.dtype``."""
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
    return (out / l.clamp_min(1e-30)).reshape(b, sq, hq, d).to(q.dtype)


def plain_flops(b: int, sq: int, skv: int, hq: int, d: int) -> int:
    """The FLOPs of :func:`flash_attention_plain` on these shapes: its two
    products, S = Q K^T and P V, over every (query, key) pair, as
    ``torch.utils.flop_counter`` counts them (and the JAX ``_sdpa``'s
    dots). The dry run charges them to each launch."""
    return 4 * b * sq * skv * hq * d


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Sq, Hq, D) attention output in ``q.dtype``; see the module
    doc. ``scale`` defaults to D**-0.5."""
    check_attention_dtypes(q=q, k=k, v=v)
    dev = _check_operands(dict(q=q, k=k, v=v), {}, dtypes=ATTN_DTYPES,
                          fake=True)
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
    out_dtype = q.dtype
    if q.dtype != k.dtype:      # mixed: widened exactly, a float32 body
        q, k, v = q.float(), k.float(), v.float()
    fake = is_fake_meta(q)
    aligned = fake or all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    body = attention_body(d, q.dtype, aligned)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out.to(out_dtype)
    if body == "general":
        plan = general_plan(0, d, sq, b * hq, q.dtype, k.dtype, ptrs=(
            (0, 0, 0) if fake else (q.data_ptr(), k.data_ptr(),
                                    v.data_ptr())))
    if fake:            # the dry run: reported, nothing launched
        from repro_torch.launch import op_analysis

        op_analysis.kernel_launch("flash_attention", (q, k, v), out,
                                  plain_flops(b, sq, skv, hq, d))
        return out.to(out_dtype)
    from repro_torch.kernels import _build

    lib = _build.load()
    if body == "general":
        general_launch(lib, q, k, v, None, out, 0, plan, sq=sq,
                       causal=causal, window=window, softcap=softcap,
                       scale=scale)
    else:
        tiles = tile_config(d, q.dtype)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, skv, hq, hkv, d, int(causal),
                NO_WINDOW if window is None else int(window),
                tiles["block_q"], scale,
                0.0 if softcap is None else float(softcap))
        with torch.cuda.device(dev):
            if body == "16bit":
                err = lib.flash_attention_16_launch(
                    *args, dtype_code(q.dtype), _stream(q))
            else:
                err = lib.flash_attention_launch(*args, _stream(q))
        _build.check(err, f"flash_attention ({body} body)")
    count_body(flash_attention, body, str(q.dtype).removeprefix("torch."))
    return out.to(out_dtype)


flash_attention.launches = 0
# Launches by the type of the operands the kernel ran on ("float32" for
# a float32 body, mixed operands included; "bfloat16"; "float16").
flash_attention.dtypes = {}
# Launches by body (:func:`attention_body`: "tf32", "16bit", "general").
flash_attention.bodies = {}
