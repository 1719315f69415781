"""Transformer building blocks of the LM serving path.

Norms (RMS / LayerNorm), rotary embeddings (full and partial), GQA
attention with qk-norm, sliding window and logit soft-cap, DeepSeek MLA
(multi-head latent attention), and dense MLPs (SwiGLU / GeGLU / GELU). Layouts are the JAX package's: activations
(B, S, H, D), projection weights (d, h, k) and (h, k, d). Functions are
``fn(params, cfg, x, ...)`` on plain dicts of tensors.

Attention has two entry points:

* :func:`attention_train`: full-sequence causal attention (the prefill
  path). With ``use_flash`` it goes through the flash kernel
  (``kernels.flash_attention``, CUDA on a card, its plain version on the
  CPU), whose output is in q's dtype (bf16 activations stay bf16);
  otherwise through ``_sdpa`` / ``_sdpa_chunked``.
* :func:`attention_decode`: one new token against a KV cache, through the
  split-KV decode kernel on a card (handed the cache as it is stored,
  float32 or bf16, with no copy) and through ``_sdpa`` on the CPU (the
  cache cast to the activations' dtype first, as in the JAX package).
  The dry run's fake tensors take the kernel's branch, as on a card
  (``_device.takes_kernel``): the wrapper reports the call to the
  analysis there instead of launching.

A cross-attention layer (``cfg.cross``, llama-3.2-vision's image layers)
takes K/V from encoder states of width ``d_cross`` and applies no rotary
embedding. Its train form attends non-causally over every state (the
flash kernel with ``causal=False``); its decode form reads a static cache
of the states' K/V (``lm.build_cross_cache``) and never writes it.

Tensor-parallel forms (:func:`attention_train_tp`,
:func:`attention_decode_tp`, :func:`mla_train_tp`, :func:`mla_decode_tp`,
:func:`mlp_tp`) take one entry a model rank: the rank's slice of the
params (its query heads and kv heads, or its MLP columns) and its device.
Each rank computes its partial of the output projection (or of the down
projection) on its own device, and the partials are summed onto x's
device: the all-reduce after attention and after the MLP. Where the query
heads split but the kv heads do not, a rank reads the kv heads its query
heads map to (:func:`kv_heads_of`), so the GQA groups stay right; a cross
layer splits as self-attention does, each rank over its kv heads of the
image K/V. :func:`owned`, :func:`own_slice`, :func:`col_parts`,
:func:`row_parts` and :func:`rmsnorm_tp` are the plumbing the recurrent
mixers' split forms share (``models.ssm``, ``models.xlstm``): which units
a rank computes, its slice of a leaf, a column-split product whose output
columns move to the ranks that need them, a row-split product's partial
sums, and a norm over channels the ranks hold in parts.

MLA has the same pair: :func:`mla_train` concatenates the nope and rope
parts and runs ``sdpa_any`` (its qk dim 192 and unequal v dim are not
shapes the flash kernel takes, and the JAX package runs no kernel there
either); :func:`mla_decode` is the absorbed form over the latent cache, in
plain float32 ops.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch._device import takes_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.params import Maker

# ---------------------------------------------------------------------------
# Config fragments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # stablelm: 0.25 partial rotary
    qk_norm: bool = False            # qwen3
    window: int | None = None        # gemma2 local layers
    attn_softcap: float | None = None  # gemma2
    cross: bool = False              # llama-3.2-vision cross-attn layers
    d_cross: int | None = None       # encoder width for cross-attn
    qk_scale: float | None = None
    impl: str = "ref"                # "ref" | "chunked" (online softmax)
    chunk: int = 2048                # KV chunk for the chunked impl

    @property
    def q_dim(self):
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    kind: str = "swiglu"  # swiglu | geglu | gelu


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(mk: Maker, d: int):
    return {"scale": mk((d,), (None,), init="zeros")}  # (1+scale) convention


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def init_layernorm(mk: Maker, d: int):
    return {"scale": mk((d,), (None,), init="ones"),
            "bias": mk((d,), (None,), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def make_norm(kind: str):
    if kind == "rms":
        return init_rmsnorm, rmsnorm
    if kind == "layer":
        return init_layernorm, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, *, theta: float, fraction: float = 1.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    inv, rot = rope_frequencies(d, fraction, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv              # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(mk: Maker, cfg: AttnConfig):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d_kv_in = cfg.d_cross if (cfg.cross and cfg.d_cross) else d
    p = {
        "wq": mk((d, hq, hd), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": mk((d_kv_in, hkv, hd), ("embed", "kv_heads", "head_dim"),
                 init="fan_in"),
        "wv": mk((d_kv_in, hkv, hd), ("embed", "kv_heads", "head_dim"),
                 init="fan_in"),
        "wo": mk((hq, hd, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(mk, hd)
        p["k_norm"] = init_rmsnorm(mk, hd)
    return p


def _proj(x, w):
    """(B, S, d) x (d, h, k) -> (B, S, h, k)."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _qkv(p, cfg: AttnConfig, x, kv_src, positions):
    """q from ``x``, k and v from ``kv_src``; no rotary embedding on a
    cross layer."""
    q = _proj(x, p["wq"])
    k, v = _proj(kv_src, p["wk"]), _proj(kv_src, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if not cfg.cross:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction)
    return q, k, v


def _out_proj(out, wo):
    return torch.einsum("bshk,hkd->bsd", out, wo.to(out.dtype))


def _sdpa(q, k, v, cfg: AttnConfig, *, causal: bool, q_offset=None,
          kv_valid_len=None):
    """Grouped softmax attention, fp32 logits.

    q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D). q_offset: (B,) absolute position of
    q[0] (decode); kv_valid_len: (B,) #valid cache entries.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = cfg.qk_scale if cfg.qk_scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if cfg.attn_softcap is not None:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    dev = q.device
    ki = torch.arange(skv, device=dev)[None, None, :]
    if q_offset is None:
        qi = torch.arange(sq, device=dev)[None, :, None] + (skv - sq)
    else:
        qi = (torch.arange(sq, device=dev)[None, :, None]
              + q_offset.long()[:, None, None])
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qi >= ki
    if cfg.window is not None:
        mask &= qi - ki < cfg.window
    if kv_valid_len is not None:
        mask &= ki < kv_valid_len.long()[:, None, None]
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _sdpa_chunked(q, k, v, cfg: AttnConfig, *, causal: bool):
    """Online-softmax attention over KV chunks: the (Sq, Skv) score matrix
    never exists; the live working set is (Sq, chunk). Same function as
    ``_sdpa``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = cfg.qk_scale if cfg.qk_scale is not None else d ** -0.5
    ck = min(cfg.chunk, skv)
    skv_pad = -(-skv // ck) * ck
    if skv_pad != skv:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_pad - skv))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_pad - skv))
    dev = q.device
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d)
    qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    m = torch.full((b, hkv, g, sq), -1e30, device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for j in range(skv_pad // ck):
        kj = k[:, j * ck:(j + 1) * ck].float()
        vj = v[:, j * ck:(j + 1) * ck].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj)
        if cfg.attn_softcap is not None:
            logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
        ki = j * ck + torch.arange(ck, device=dev)[None, :]
        mask = ki < skv
        if causal:
            mask = mask & (qi >= ki)
        if cfg.window is not None:
            mask = mask & (qi - ki < cfg.window)
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vj)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def sdpa_any(q, k, v, cfg: AttnConfig, *, causal: bool):
    if cfg.impl == "chunked":
        return _sdpa_chunked(q, k, v, cfg, causal=causal)
    return _sdpa(q, k, v, cfg, causal=causal)


def attention_train(p, cfg: AttnConfig, x, *, positions=None, kv_src=None,
                    use_flash: bool = False):
    """Full-sequence attention of x (B, S, d_model): causal self-attention,
    or on a cross layer non-causal attention over ``kv_src`` (B, S_kv,
    d_cross). A cross layer without ``kv_src`` raises ``ValueError``,
    where the JAX package would attend over ``x`` itself, later tokens
    included."""
    if cfg.cross and kv_src is None:
        raise ValueError("a cross-attention layer needs its encoder states "
                         "(kv_src / batch['cross_states'])")
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, cfg, x, x if kv_src is None else kv_src, positions)
    causal = not cfg.cross
    if use_flash:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=cfg.window,
                              softcap=cfg.attn_softcap, scale=cfg.qk_scale)
    else:
        out = sdpa_any(q, k, v, cfg, causal=causal)
    return _out_proj(out, p["wo"])


def kv_heads_of(n_heads: int, n_kv_heads: int, model: int,
                rank: int) -> tuple[int, int]:
    """[lo, hi): the kv heads the query heads of ``rank`` read when the
    model axis splits ``n_heads`` query heads ``model`` ways."""
    g = n_heads // n_kv_heads
    q0, q1 = rank * n_heads // model, (rank + 1) * n_heads // model
    return q0 // g, (q1 - 1) // g + 1


def _rank_attn(p, cfg: AttnConfig, rank: int, model: int):
    """Rank ``rank``'s params and config: ``p`` holds its query heads and
    either its kv heads or all of them, which are cut here to the ones
    its query heads read."""
    hq = p["wq"].shape[1]
    lo, hi = kv_heads_of(cfg.n_heads, cfg.n_kv_heads, model, rank)
    if p["wk"].shape[1] == cfg.n_kv_heads and hi - lo != cfg.n_kv_heads:
        p = {**p, "wk": p["wk"][:, lo:hi], "wv": p["wv"][:, lo:hi]}
    hkv = hi - lo
    g = cfg.n_heads // cfg.n_kv_heads
    if p["wk"].shape[1] != hkv or (hkv > 1 and (
            hq % g or (rank * hq) % g)):
        raise ValueError(
            f"rank {rank} of {model}: {hq} query heads over kv heads "
            f"[{lo}, {hi}) of {cfg.n_kv_heads} are not whole GQA groups")
    return p, dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv)


def _sum_onto(parts, device):
    out = None
    for y in parts:
        y = y.to(device)
        out = y if out is None else out + y
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel plumbing of the split mixers (MLA, Mamba, mLSTM, sLSTM)
# ---------------------------------------------------------------------------

def owned(n_units: int, held: int, model: int) -> list[tuple[int, int]]:
    """Per model rank, the [lo, hi) of ``n_units`` units (heads or
    channels) it computes: its own block where a spec splits them (each
    rank then holds ``held`` < ``n_units``), else all of them at rank 0
    and none elsewhere."""
    if held == n_units:
        return [(0, n_units)] + [(0, 0)] * (model - 1)
    return [(r * held, (r + 1) * held) for r in range(model)]


def own_slice(w, dim: int, lo: int, hi: int):
    """Rows [lo, hi) along ``dim`` of a leaf, for the rank that owns them:
    the leaf itself where the rank holds just those (its split slice),
    else cut from the whole leaf it holds."""
    return w if w.shape[dim] == hi - lo else w.narrow(dim, lo, hi - lo)


def _merged(ranges) -> list[tuple[int, int]]:
    """Column ranges with each one that starts where the last ends joined
    to it."""
    out: list[tuple[int, int]] = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def col_parts(ranks, name: str, x, width: int, want):
    """``x @ W`` for ``W = p[name]`` (d, width), as each rank needs it: the
    output columns of the ranges ``want[r]`` concatenated, on rank r's
    device (None where it wants none). Each rank holds a block of W's
    columns or all of them. A rank multiplies x by the columns it holds,
    and the pieces then move to the ranks that need them: the all-to-all
    of GSPMD's column reshard (no weight column leaves its rank)."""
    held = ranks[0][0][name].shape[-1]
    if held == width:
        out = []
        for (p, dev), ranges in zip(ranks, want):
            if not ranges:
                out.append(None)
                continue
            spans = _merged(ranges)
            w = p[name] if spans == [(0, width)] else torch.cat(
                [p[name][..., a:b] for a, b in spans], -1)
            out.append(torch.matmul(x.to(dev), w.to(x.dtype)))
        return out
    blocks: dict[int, torch.Tensor] = {}

    def block(k):
        if k not in blocks:
            p, dev = ranks[k]
            blocks[k] = torch.matmul(x.to(dev), p[name].to(x.dtype))
        return blocks[k]

    out = []
    for (_, dev), ranges in zip(ranks, want):
        pieces = []
        for a, b in ranges:
            for k in range(a // held, -(-b // held)):
                lo, hi = max(a, k * held) - k * held, min(b, (k + 1) * held) \
                    - k * held
                pieces.append(block(k)[..., lo:hi].to(dev))
        out.append(torch.cat(pieces, -1) if pieces else None)
    return out


def row_parts(ranks, name: str, acts, own, width: int) -> list:
    """The partial products ``acts @ W`` for ``W = p[name]`` (width, ...),
    whose rows (channels) each rank holds in a block or whole, where rank
    r holds the activation channels ``own[r]`` (``acts[r]``, None for
    none): one partial a rank that multiplies, on its device. Their sum
    is the whole product (the all-reduce that follows a row-split
    weight); where the rows of W and the channels a rank holds differ,
    the channels move to the rank that holds the rows."""
    held = ranks[0][0][name].shape[0]
    parts = []
    if held == width:
        for (p, _), (lo, hi), a in zip(ranks, own, acts):
            if hi > lo:
                w = own_slice(p[name], 0, lo, hi)
                parts.append(torch.matmul(a, w.to(a.dtype)))
        return parts
    for k, (p, dev) in enumerate(ranks):
        lo, hi = k * held, (k + 1) * held
        pieces = [a[..., max(lo, o0) - o0:min(hi, o1) - o0].to(dev)
                  for a, (o0, o1) in zip(acts, own)
                  if min(hi, o1) > max(lo, o0)]
        a_k = torch.cat(pieces, -1)
        parts.append(torch.matmul(a_k, p[name].to(a_k.dtype)))
    return parts


def rmsnorm_tp(scales, xs, width: int, device, eps: float = 1e-6):
    """:func:`rmsnorm` over ``width`` channels that the ranks hold in
    parts: ``xs[r]`` rank r's channels (None for none), ``scales[r]`` their
    scale. The ranks' sums of squares are added (an all-reduce of one
    value a position), and each rank normalises its own channels."""
    sq = [torch.sum(x.float() * x.float(), dim=-1, keepdim=True)
          for x in xs if x is not None]
    var = _sum_onto(sq, device) / width
    out = []
    for x, scale in zip(xs, scales):
        if x is None:
            out.append(None)
            continue
        y = x.float() * torch.rsqrt(var.to(x.device) + eps)
        out.append((y * (1.0 + scale.float())).to(x.dtype))
    return out


def attention_train_tp(ranks, cfg: AttnConfig, x, *, kv_src=None,
                       use_flash: bool = False):
    """:func:`attention_train` split over the model ranks ``ranks``, a
    list of (params slice, device) (see the module docstring)."""
    def part(r, p, dev):
        p, lcfg = _rank_attn(p, cfg, r, len(ranks))
        return attention_train(
            p, lcfg, x.to(dev), use_flash=use_flash,
            kv_src=None if kv_src is None else kv_src.to(dev))
    return _sum_onto((part(r, p, dev) for r, (p, dev) in enumerate(ranks)),
                     x.device)


def attention_decode_tp(ranks, cfg: AttnConfig, x, pos):
    """:func:`attention_decode` split over the model ranks ``ranks``, a
    list of (params slice, device, cache): each rank's cache holds its kv
    heads on its device and takes its new row in place."""
    def part(r, p, dev, cache):
        p, lcfg = _rank_attn(p, cfg, r, len(ranks))
        if cache["k"].shape[2] != lcfg.n_kv_heads:
            raise ValueError(f"rank {r}'s cache holds {cache['k'].shape[2]} "
                             f"kv heads, its query heads read "
                             f"{lcfg.n_kv_heads}")
        return attention_decode(p, lcfg, x.to(dev), cache, pos.to(dev))[0]
    return _sum_onto((part(r, *rank) for r, rank in enumerate(ranks)),
                     x.device)


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, *,
                  dtype=torch.bfloat16, device="cpu", lead=()):
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, cfg: AttnConfig, x, cache, pos):
    """x: (B, 1, D); cache {"k","v"}: (B, Smax, Hkv, D); pos: (B,) int.

    Returns (out (B, 1, D), cache). The new K/V row is written into the
    cache IN PLACE at ``pos`` (clamped to [0, Smax - 1], as the JAX
    package's ``dynamic_update_slice`` clamps it), and the same dict comes
    back. On a card the attention runs in the split-KV decode kernel with
    ``lengths = pos + 1``, over the cache tensors themselves (a bf16 cache
    is read as stored and widened in the kernel, exactly; a float32 cache
    under a bf16 or float16 model is rounded to the model's type value by
    value as the kernel reads it, ``round_kv``); on the CPU through ``_sdpa`` with
    ``q_offset=pos, kv_valid_len=pos + 1`` over the cache cast to
    ``x.dtype``, exactly as the JAX package. Both compute the JAX
    function: K and V in ``x.dtype``.

    A cross layer's cache holds the encoder states' K/V (every row valid,
    filled by ``lm.build_cross_cache``) and is never written: the query
    (no rotary embedding) attends to all of its rows, through the decode
    kernel with ``lengths`` = the row count on a card, through ``_sdpa``
    with ``causal=False, q_offset=pos`` on the CPU, as the JAX package.
    """
    if cfg.cross:
        return _cross_decode(p, cfg, x, cache, pos), cache
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, x, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(b, device=ck.device)
    at = pos.long().clamp(0, ck.shape[1] - 1)
    ck[rows, at] = k_new[:, 0].to(ck.dtype)
    cv[rows, at] = v_new[:, 0].to(cv.dtype)
    if takes_kernel(x):
        out = flash_decode(q[:, 0].contiguous(), ck, cv,
                           (pos + 1).to(torch.int32), window=cfg.window,
                           softcap=cfg.attn_softcap, scale=cfg.qk_scale,
                           round_kv=_rounds_cache(x, ck))[:, None]
    else:
        out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), cfg, causal=True,
                    q_offset=pos, kv_valid_len=pos + 1)
    return _out_proj(out, p["wo"]), cache


def _rounds_cache(x, cache):
    """The type the JAX decode path's cast of the cache to ``x.dtype``
    rounds it to, or None where the cast is exact: a 16-bit model rounds a
    cache of another type (float32, or the other 16-bit type) to its own;
    a float32 model widens exactly."""
    if x.dtype == cache.dtype or x.dtype == torch.float32:
        return None
    return x.dtype


def _cross_decode(p, cfg: AttnConfig, x, cache, pos):
    q = _proj(x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    ck, cv = cache["k"], cache["v"]
    if takes_kernel(x):
        if cfg.window is not None:
            # The kernel places the query at key lengths - 1; the JAX
            # function places it at ``pos``, which only a window reads.
            raise ValueError("a windowed cross-attention layer has no "
                             "decode kernel form")
        lengths = torch.full((x.shape[0],), ck.shape[1], dtype=torch.int32,
                             device=x.device)
        out = flash_decode(q[:, 0].contiguous(), ck, cv, lengths,
                           softcap=cfg.attn_softcap, scale=cfg.qk_scale,
                           round_kv=_rounds_cache(x, ck))[:, None]
    else:
        out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), cfg, causal=False,
                    q_offset=pos)
    return _out_proj(out, p["wo"])


def cross_kv(p, cfg: AttnConfig, states, rank: int = 0, model: int = 1):
    """A cross layer's K and V of the encoder ``states`` (B, S_kv,
    d_cross), each (B, S_kv, Hkv, D); with ``model`` > 1, of the kv heads
    that rank ``rank``'s query heads read, from the rank's own ``wk`` /
    ``wv`` slice (``p`` the rank's params). No ``k_norm``, as the JAX
    ``build_cross_cache``."""
    if model > 1:
        p, _ = _rank_attn(p, cfg, rank, model)
    return tuple(torch.einsum("bsd,dhk->bshk", states,
                              p[name].to(states.dtype))
                 for name in ("wk", "wv"))


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MlaConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self):
        return self.d_nope + self.d_rope


def init_mla(mk: Maker, cfg: MlaConfig):
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq_a": mk((d, cfg.q_lora_rank), ("embed", "q_lora"), init="fan_in"),
        "q_a_norm": init_rmsnorm(mk, cfg.q_lora_rank),
        "wq_b": mk((cfg.q_lora_rank, h, cfg.qk_dim),
                   ("q_lora", "heads", "head_dim"), init="fan_in"),
        "wkv_a": mk((d, cfg.kv_lora_rank + cfg.d_rope), ("embed", "kv_lora"),
                    init="fan_in"),
        "kv_a_norm": init_rmsnorm(mk, cfg.kv_lora_rank),
        "wk_b": mk((cfg.kv_lora_rank, h, cfg.d_nope),
                   ("kv_lora", "heads", "head_dim"), init="fan_in"),
        "wv_b": mk((cfg.kv_lora_rank, h, cfg.d_v),
                   ("kv_lora", "heads", "head_dim"), init="fan_in"),
        "wo": mk((h, cfg.d_v, d), ("heads", "head_dim", "embed"),
                 init="fan_in"),
    }


def _mla_qkr(p, cfg: MlaConfig, x, positions):
    """Queries, the latent and the shared rope key of train and decode."""
    q_a = rmsnorm(p["q_a_norm"], torch.matmul(x, p["wq_a"].to(x.dtype)))
    q = torch.einsum("bsr,rhk->bshk", q_a, p["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :cfg.d_nope], q[..., cfg.d_nope:]
    q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)

    kv_a = torch.matmul(x, p["wkv_a"].to(x.dtype))
    c_kv = rmsnorm(p["kv_a_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = kv_a[..., cfg.kv_lora_rank:][:, :, None, :]   # shared head
    k_rope = apply_rope(k_rope, positions, theta=cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def mla_train(p, cfg: MlaConfig, x, *, positions=None, impl: str = "ref",
              chunk: int = 2048):
    """Full-sequence causal MLA of x (B, S, d_model), over the heads ``p``
    holds (a model rank's slice holds its own)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"].to(x.dtype))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"].to(x.dtype))

    # q.k = q_nope.k_nope + q_rope.k_rope == concat(q).concat(k) with the
    # shared rope key broadcast per head: the standard SDPA paths.
    h = p["wq_b"].shape[1]
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.d_rope).to(k_nope.dtype)], dim=-1)
    acfg = AttnConfig(d_model=cfg.d_model, n_heads=h, n_kv_heads=h,
                      head_dim=cfg.qk_dim, qk_scale=cfg.qk_dim ** -0.5,
                      impl=impl, chunk=chunk)
    # v has d_v dims (may differ from qk_dim): pad v to qk_dim then slice.
    v_in = F.pad(v, (0, cfg.qk_dim - cfg.d_v)) if cfg.d_v != cfg.qk_dim \
        else v
    out = sdpa_any(q_full, k_full, v_in, acfg, causal=True)[..., :cfg.d_v]
    return torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype))


def init_mla_cache(cfg: MlaConfig, batch: int, max_len: int, *,
                   dtype=torch.bfloat16, device="cpu", lead=()):
    """The latent and the shared rope key per token: (kv_lora_rank +
    d_rope) floats instead of 2 * H * D (576 against 32,768 for
    deepseek-v3)."""
    shape = (*lead, batch, max_len, cfg.kv_lora_rank + cfg.d_rope)
    return {"ckv": torch.zeros(shape, dtype=dtype, device=device)}


def mla_decode(p, cfg: MlaConfig, x, cache, pos):
    """Absorbed-matmul latent decode of x (B, 1, D) at ``pos`` (B,): the
    attention runs in the latent space, with W_uk folded into the query and
    W_uv into the output. The new latent row is written into
    ``cache["ckv"]`` IN PLACE at ``pos`` (clamped to [0, Smax - 1], as
    ``dynamic_update_slice`` clamps it) and the same dict comes back;
    every cache row ``ki <= pos`` is attended."""
    b = x.shape[0]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkr(p, cfg, x, pos[:, None])
    ckv = cache["ckv"]
    rows = torch.arange(b, device=ckv.device)
    at = pos.long().clamp(0, ckv.shape[1] - 1)
    ckv[rows, at] = torch.cat([c_kv_new, k_rope_new], dim=-1)[:, 0].to(
        ckv.dtype)
    c_lat = ckv[..., :cfg.kv_lora_rank].float()             # (B, S, R)
    k_rope = ckv[..., cfg.kv_lora_rank:].float()            # (B, S, dr)

    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope.float(),
                         p["wk_b"].float())                 # absorb W_uk
    scale = cfg.qk_dim ** -0.5
    logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, c_lat)
              + torch.einsum("bqhn,bkn->bhqk", q_rope.float(), k_rope)) \
        * scale
    ki = torch.arange(ckv.shape[1], device=x.device)[None, None, None, :]
    logits = torch.where(ki <= pos.long()[:, None, None, None], logits,
                         -1e30)
    probs = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", probs, c_lat)    # (B, 1, H, R)
    out = torch.einsum("bqhr,rhv->bqhv", o_lat,
                       p["wv_b"].float()).to(x.dtype)       # absorb W_uv
    return torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype)), cache


def mla_train_tp(ranks, cfg: MlaConfig, x, *, impl: str = "ref",
                 chunk: int = 2048):
    """:func:`mla_train` split over the model ranks ``ranks``, a list of
    (params slice, device): a rank holds its heads of ``wq_b`` / ``wk_b``
    / ``wv_b`` and their rows of ``wo``, computes the replicated latent
    and rope key itself, attends over its heads and projects them; the
    partial outputs are summed onto x's device."""
    return _sum_onto((mla_train(p, cfg, x.to(dev), impl=impl,
                                chunk=chunk) for p, dev in ranks), x.device)


def mla_decode_tp(ranks, cfg: MlaConfig, x, pos):
    """:func:`mla_decode` split over the model ranks ``ranks``, a list of
    (params slice, device, cache): each rank's cache is its own copy of
    the row's whole latent cache, into which it writes the same new row;
    it absorbs only its own heads, and the partial outputs are summed."""
    return _sum_onto((mla_decode(p, cfg, x.to(dev), cache, pos.to(dev))[0]
                      for p, dev, cache in ranks), x.device)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(mk: Maker, cfg: MlpConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.kind in ("swiglu", "geglu"):
        return {
            "w_gate": mk((d, f), ("embed", "mlp"), init="fan_in"),
            "w_up": mk((d, f), ("embed", "mlp"), init="fan_in"),
            "w_down": mk((f, d), ("mlp", "embed"), init="fan_in"),
        }
    return {
        "w_up": mk((d, f), ("embed", "mlp"), init="fan_in"),
        "w_down": mk((f, d), ("mlp", "embed"), init="fan_in"),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_tp(ranks, cfg: MlpConfig, x):
    """:func:`mlp` split over the model ranks ``ranks``, a list of
    (params slice, device), each holding its columns of the up and gate
    projections and its rows of the down projection."""
    return _sum_onto((mlp(p, cfg, x.to(dev)) for p, dev in ranks), x.device)


def mlp(p, cfg: MlpConfig, x):
    if cfg.kind in ("swiglu", "geglu"):
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        u = torch.matmul(x, p["w_up"].to(x.dtype))
        act = F.silu(g) if cfg.kind == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = _gelu(torch.matmul(x, p["w_up"].to(x.dtype)))
    return torch.matmul(h, p["w_down"].to(x.dtype))
