"""Transformer building blocks of the LM serving path.

Norms (RMS / LayerNorm), rotary embeddings (full and partial), GQA
attention with qk-norm, sliding window and logit soft-cap, and dense MLPs
(SwiGLU / GeGLU / GELU). Layouts are the JAX package's: activations
(B, S, H, D), projection weights (d, h, k) and (h, k, d). Functions are
``fn(params, cfg, x, ...)`` on plain dicts of tensors.

Attention has two entry points:

* :func:`attention_train`: full-sequence causal attention (the prefill
  path). With ``use_flash`` it goes through the flash kernel
  (``kernels.flash_attention``, CUDA on a card, its plain version on the
  CPU); otherwise through ``_sdpa`` / ``_sdpa_chunked``.
* :func:`attention_decode`: one new token against a KV cache, through the
  split-KV decode kernel on a card and through ``_sdpa`` on the CPU.

Cross-attention and DeepSeek MLA are not ported yet (ROADMAP.md §1, the
MLA/MoE/Mamba/xLSTM/cross-attention item).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.params import Maker

_NOT_PORTED = ("cross-attention is not ported yet (ROADMAP.md §1, the "
               "MLA/MoE/Mamba/xLSTM/cross-attention item)")


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
    if cfg.cross:
        raise NotImplementedError(_NOT_PORTED)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": mk((d, hq, hd), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": mk((d, hkv, hd), ("embed", "kv_heads", "head_dim"),
                 init="fan_in"),
        "wv": mk((d, hkv, hd), ("embed", "kv_heads", "head_dim"),
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


def _qkv(p, cfg: AttnConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
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


def attention_train(p, cfg: AttnConfig, x, *, positions=None,
                    use_flash: bool = False):
    """Full-sequence causal attention of x (B, S, d_model)."""
    if cfg.cross:
        raise NotImplementedError(_NOT_PORTED)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, cfg, x, positions)
    if use_flash:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=cfg.window,
                              softcap=cfg.attn_softcap, scale=cfg.qk_scale)
    else:
        out = sdpa_any(q, k, v, cfg, causal=True)
    return _out_proj(out, p["wo"])


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
    ``lengths = pos + 1``; on the CPU through ``_sdpa`` with
    ``q_offset=pos, kv_valid_len=pos + 1``, exactly as the JAX package.
    """
    if cfg.cross:
        raise NotImplementedError(_NOT_PORTED)
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(b, device=ck.device)
    at = pos.long().clamp(0, ck.shape[1] - 1)
    ck[rows, at] = k_new[:, 0].to(ck.dtype)
    cv[rows, at] = v_new[:, 0].to(cv.dtype)
    if x.device.type == "cuda":
        out = flash_decode(q[:, 0].contiguous(), ck.to(x.dtype),
                           cv.to(x.dtype), (pos + 1).to(torch.int32),
                           window=cfg.window, softcap=cfg.attn_softcap,
                           scale=cfg.qk_scale)[:, None]
    else:
        out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), cfg, causal=True,
                    q_offset=pos, kv_valid_len=pos + 1)
    return _out_proj(out, p["wo"]), cache


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


def mlp(p, cfg: MlpConfig, x):
    if cfg.kind in ("swiglu", "geglu"):
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        u = torch.matmul(x, p["w_up"].to(x.dtype))
        act = F.silu(g) if cfg.kind == "swiglu" else _gelu(g)
        h = act * u
    else:
        h = _gelu(torch.matmul(x, p["w_up"].to(x.dtype)))
    return torch.matmul(h, p["w_down"].to(x.dtype))
