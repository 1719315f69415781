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
  kernel takes: any head dim, operands off a 16-byte boundary; float32
  inside, slow.

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


def general_launch(lib, q, k, v, lengths, out, mode: int, *, sq: int,
                   causal: bool, window, softcap, scale: float,
                   round_to=None) -> None:
    """One launch of ``csrc/attention_any.cu`` (mode 0: #7's operands, mode
    1: #8's with ``lengths`` and the caches as k, v); ``round_to`` (mode 1)
    rounds K and V to that type where read."""
    from repro_torch.kernels import _build

    b, hkv, d = k.shape[0], k.shape[2], k.shape[3]
    hq = q.shape[-2]
    with torch.cuda.device(q.device):
        err = lib.attention_any_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            mode, b, sq, k.shape[1], hq, hkv, d, int(causal),
            NO_WINDOW if window is None else int(window),
            dtype_code(q.dtype), dtype_code(k.dtype),
            0 if round_to is None else dtype_code(round_to), scale,
            0.0 if softcap is None else float(softcap), _stream(q))
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
    if fake:            # the dry run: reported, nothing launched
        from repro_torch.launch import op_analysis

        op_analysis.kernel_launch("flash_attention", (q, k, v), out,
                                  plain_flops(b, sq, skv, hq, d))
        return out.to(out_dtype)
    from repro_torch.kernels import _build

    lib = _build.load()
    if body == "general":
        general_launch(lib, q, k, v, None, out, 0, sq=sq, causal=causal,
                       window=window, softcap=softcap, scale=scale)
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
