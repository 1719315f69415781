"""Mamba (S6 selective-scan) block — the SSM layers of jamba-v0.1.

The JAX package bounds the scan's working set by chunking, and so does
the port: the (B, I, N) state is carried across sequence chunks of
``chunk_size`` steps, and the (B, W, I, N) expansion of one chunk is all
that lives at a time. Under autograd each chunk runs under
``torch.utils.checkpoint``, as the JAX package wraps it in
``jax.checkpoint``, so the backward pass recomputes the expansion instead
of keeping it; under ``torch.no_grad()`` the chunks run plain.

Within a chunk the recurrence ``h' = da * h + dbu`` is the JAX package's
associative scan with the combine ``(a1 * a2, b1 * a2 + b2)``, here a
log-depth Hillis–Steele scan over the chunk axis. It sums in another
order than XLA's scan, so the two agree to a tolerance, not bit for bit.

Decode is the O(1) single-step recurrence over the carried (conv window,
ssm state) cache, which ``mamba_decode`` updates in place. There is no
hand-written kernel here, as there is no Pallas kernel in the JAX
package's Mamba: the products are ``torch.einsum`` and the scan is
elementwise ``torch`` ops.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.params import Maker

# The cache's initial values, leaf by leaf: ``init_mamba_cache`` builds
# from them and a serving slot is reset to them.
CACHE_INIT = {"conv": 0.0, "ssm": 0.0}


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int | None = None
    chunk_size: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank if self.dt_rank else -(-self.d_model // 16)


def init_mamba(mk: Maker, cfg: MambaConfig):
    d, i, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    return {
        "in_proj": mk((d, 2 * i), ("embed", "mlp"), init="fan_in"),
        "conv_w": mk((cfg.d_conv, i), (None, "mlp"), init="fan_in", scale=1.0),
        "conv_b": mk((i,), ("mlp",), init="zeros"),
        "x_proj": mk((i, r + 2 * n), ("mlp", None), init="fan_in"),
        "dt_w": mk((r, i), (None, "mlp"), init="fan_in"),
        "dt_b": mk((i,), ("mlp",), init="ones"),
        "a_log": mk((i, n), ("mlp", None), init="ones"),
        "d_skip": mk((i,), ("mlp",), init="ones"),
        "out_proj": mk((i, d), ("mlp", "embed"), init="fan_in"),
    }


def _ssm_inputs(p, cfg: MambaConfig, u):
    """u: (B, W, I) conv'd + silu'd inputs -> (dA, dBu, C) of the chunk:
    (B, W, I, N), (B, W, I, N), (B, W, N), float32."""
    xdb = torch.einsum("bwi,ir->bwr", u, p["x_proj"].to(u.dtype))
    r, n = cfg.rank, cfg.d_state
    dt = F.softplus(
        torch.einsum("bwr,ri->bwi", xdb[..., :r], p["dt_w"].to(u.dtype))
        .float() + p["dt_b"].float())
    b_in = xdb[..., r:r + n].float()                       # (B, W, N)
    c_out = xdb[..., r + n:].float()                       # (B, W, N)
    a = -torch.exp(p["a_log"].float())                     # (I, N)
    da = torch.exp(dt[..., None] * a)                      # (B, W, I, N)
    dbu = (dt * u.float())[..., None] * b_in[..., None, :]
    return da, dbu, c_out


def _chunk_scan(carry_h, da, dbu):
    """The scan of ``h' = da * h + dbu`` within one chunk.

    carry_h: (B, I, N); da / dbu: (B, W, I, N). -> (h_last, all h). Each
    doubling step combines every position with the one ``s`` before it,
    out of place (autograd keeps the operands)."""
    a, b = da, dbu
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], b[:, :-s] * a[:, s:] + b[:, s:]], 1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], 1)
        s *= 2
    h_all = b + a * carry_h[:, None]
    return h_all[:, -1], h_all


def _causal_conv(p, cfg: MambaConfig, x, conv_state=None):
    """Depthwise causal conv1d, kernel ``d_conv``. x: (B, S, I) -> (silu
    of the conv, the last ``d_conv - 1`` inputs)."""
    k = cfg.d_conv
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    w = p["conv_w"].to(x.dtype)
    out = sum(xp[:, j:j + x.shape[1]] * w[j] for j in range(k))
    out = out + p["conv_b"].to(x.dtype)
    return F.silu(out), xp[:, -(k - 1):]


def mamba_train(p, cfg: MambaConfig, x):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    i = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    u, z = xz[..., :i], xz[..., i:]
    u, _ = _causal_conv(p, cfg, u)

    w = min(cfg.chunk_size, s)
    s_pad = -(-s // w) * w
    if s_pad != s:  # pad tail; padded steps only affect sliced-off outputs
        u = F.pad(u, (0, 0, 0, s_pad - s))

    def step(h, u_chunk):
        da, dbu, c_out = _ssm_inputs(p, cfg, u_chunk)
        h_last, h_all = _chunk_scan(h, da, dbu)
        y = torch.einsum("bwin,bwn->bwi", h_all, c_out)
        return h_last, y.to(x.dtype)

    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, step, use_reentrant=False)
    h = torch.zeros((b, i, cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(0, s_pad, w):
        h, y = step(h, u[:, c:c + w])
        ys.append(y)
    y = torch.cat(ys, 1)[:, :s]
    u = u[:, :s]
    y = y + u * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))


def init_mamba_cache(cfg: MambaConfig, batch: int, *, dtype=torch.bfloat16,
                     device="cpu", lead=()):
    i, n, k = cfg.d_inner, cfg.d_state, cfg.d_conv
    shapes = {"conv": (batch, k - 1, i), "ssm": (batch, i, n)}
    return {name: torch.full((*lead, *shape), CACHE_INIT[name], dtype=dtype,
                             device=device)
            for name, shape in shapes.items()}


def mamba_decode(p, cfg: MambaConfig, x, cache):
    """Single-token step. x: (B, 1, D); cache {conv (B, K-1, I), ssm
    (B, I, N)}, written IN PLACE. -> (out (B, 1, D), cache)."""
    i = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    u, z = xz[..., :i], xz[..., i:]
    u, conv_new = _causal_conv(p, cfg, u, conv_state=cache["conv"])

    da, dbu, c_out = _ssm_inputs(p, cfg, u)                # W = 1
    h = cache["ssm"].float() * da[:, 0] + dbu[:, 0]
    y = torch.einsum("bin,bn->bi", h, c_out[:, 0])[:, None].to(x.dtype)
    y = y + u * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))
    cache["conv"].copy_(conv_new)
    cache["ssm"].copy_(h)
    return out, cache
