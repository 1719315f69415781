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

Over a mesh's "model" axis (:func:`mamba_tp`) each rank owns a block of
the inner channels,
as the JAX package's specs split them on ``mlp``; the scan runs per
channel, so only the products with ``in_proj``, ``x_proj`` and
``out_proj`` cross ranks.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (_sum_onto, col_parts, own_slice,
                                       owned, row_parts)
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


def _ssm_inputs(p, cfg: MambaConfig, u, xdb=None):
    """u: (B, W, I) conv'd + silu'd inputs -> (dA, dBu, C) of the chunk:
    (B, W, I, N), (B, W, I, N), (B, W, N), float32. ``xdb`` is u's
    ``x_proj`` product (B, W, r + 2n), made here when None; a rank of a
    split layer is handed the ranks' sum of it."""
    if xdb is None:
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


def _scan(p, cfg: MambaConfig, u, xdb=None):
    """The selective scan of u (B, S, I) in chunks of ``chunk_size`` ->
    y (B, S, I) in u's dtype, before the skip and the gate; ``xdb`` as in
    :func:`_ssm_inputs`, for the whole sequence."""
    b, s, i = u.shape
    w = min(cfg.chunk_size, s)
    s_pad = -(-s // w) * w
    if s_pad != s:  # pad tail; padded steps only affect sliced-off outputs
        u = F.pad(u, (0, 0, 0, s_pad - s))
        if xdb is not None:
            xdb = F.pad(xdb, (0, 0, 0, s_pad - s))

    def step(h, u_chunk, xdb_chunk):
        da, dbu, c_out = _ssm_inputs(p, cfg, u_chunk, xdb_chunk)
        h_last, h_all = _chunk_scan(h, da, dbu)
        y = torch.einsum("bwin,bwn->bwi", h_all, c_out)
        return h_last, y.to(u.dtype)

    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, step, use_reentrant=False)
    h = torch.zeros((b, i, cfg.d_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    for c in range(0, s_pad, w):
        h, y = step(h, u[:, c:c + w],
                    None if xdb is None else xdb[:, c:c + w])
        ys.append(y)
    return torch.cat(ys, 1)[:, :s]


def _step(p, cfg: MambaConfig, u, cache, xdb=None):
    """One decode step of the scan: u (B, 1, I) -> y (B, 1, I) before the
    skip and the gate; writes the new ssm state into ``cache`` in place."""
    da, dbu, c_out = _ssm_inputs(p, cfg, u, xdb)            # W = 1
    h = cache["ssm"].float() * da[:, 0] + dbu[:, 0]
    y = torch.einsum("bin,bn->bi", h, c_out[:, 0])[:, None].to(u.dtype)
    cache["ssm"].copy_(h)
    return y


def _gated(p, y, u, z):
    """The scan's output with the skip term, gated by silu(z)."""
    return (y + u * p["d_skip"].to(y.dtype)) * F.silu(z)


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
    i = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    u, z = xz[..., :i], xz[..., i:]
    u, _ = _causal_conv(p, cfg, u)
    y = _gated(p, _scan(p, cfg, u), u, z)
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
    y = _gated(p, _step(p, cfg, u, cache), u, z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))
    cache["conv"].copy_(conv_new)
    return out, cache


# The leaves a rank of a split layer holds for its own channels, with the
# dimension that indexes them.
_PER_CHANNEL = {"conv_w": 1, "conv_b": 0, "dt_w": 1, "dt_b": 0, "a_log": 0,
                "d_skip": 0}


def mamba_tp(ranks, cfg: MambaConfig, x, caches=None):
    """:func:`mamba_train` (``caches`` None) or :func:`mamba_decode` (one
    step against ``caches[r]``, rank r's conv window and ssm state of its
    channels, written in place; None at a rank that owns none) split over
    the model ranks ``ranks``, a list of (params slice, device). Rank r
    computes the inner channels it owns (:func:`layers.owned`: its block
    where the specs split them, else all at rank 0): the conv and the
    scan run per channel on its slices of ``conv_w`` / ``conv_b`` /
    ``dt_w`` / ``dt_b`` / ``a_log`` / ``d_skip``. ``in_proj``'s columns
    are split in blocks of the concatenated [u | z], so no rank holds the
    u and z columns of the same channels: each rank multiplies by the
    columns it holds and the output columns move to their channels'
    ranks. ``x_proj`` and ``out_proj`` split on their rows, so the ranks'
    products are partial sums: ``x_proj``'s (B, S, r + 2n) is summed
    before ``dt``, B and C are read, ``out_proj``'s is the output."""
    i = cfg.d_inner
    own = owned(i, ranks[0][0]["conv_w"].shape[1], len(ranks))
    xz = col_parts(ranks, "in_proj", x, 2 * i,
                   [[(lo, hi), (i + lo, i + hi)] if hi > lo else []
                    for lo, hi in own])
    mine, us, zs, convs = ([None] * len(ranks) for _ in range(4))
    for r, ((p, _), (lo, hi), t) in enumerate(zip(ranks, own, xz)):
        if hi == lo:
            continue
        mine[r] = {k: own_slice(p[k], d, lo, hi)
                   for k, d in _PER_CHANNEL.items()}
        zs[r] = t[..., hi - lo:]
        us[r], convs[r] = _causal_conv(mine[r], cfg, t[..., :hi - lo],
                                       None if caches is None
                                       else caches[r]["conv"])
    xdb = _sum_onto(row_parts(ranks, "x_proj", us, own, i), x.device)
    ys = []
    for r, (q, u, z) in enumerate(zip(mine, us, zs)):
        if q is None:
            ys.append(None)
            continue
        if caches is None:
            y = _scan(q, cfg, u, xdb.to(u.device))
        else:
            y = _step(q, cfg, u, caches[r], xdb.to(u.device))
            caches[r]["conv"].copy_(convs[r])
        ys.append(_gated(q, y, u, z))
    return _sum_onto(row_parts(ranks, "out_proj", ys, own, i), x.device)
