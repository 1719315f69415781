"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

mLSTM runs in the JAX package's exact chunkwise-parallel form: within a
chunk the update is a masked attention-like product, and across chunks
the (C, n, m) state is carried. The stabiliser m_t = max(logf_t +
m_{t-1}, logi_t) unrolls to A_t + max(m_0, max_s(logi_s - A_s)) with
A = cumsum(logf) (``torch.cumsum`` / ``torch.cummax``). The chunk loop,
its padding and its checkpointing follow ``models.ssm``: under autograd
each chunk runs under ``torch.utils.checkpoint``, under
``torch.no_grad()`` plain.

sLSTM has a true hidden-to-hidden recurrence (R z_{t-1}) with a per-head
block-diagonal R, so it runs one time step after another.

Both decode in O(1) state per slot; the decode steps update their caches
in place. The carried ``m`` starts at -1e30, not 0 (``*_CACHE_INIT``).
There is no hand-written kernel here, as there is no Pallas kernel in the
JAX package's xLSTM.

Over a mesh's "model" axis (:func:`mlstm_tp`, :func:`slstm_tp`) each rank
owns a block of the heads, as the JAX package's specs split them on
``heads`` / ``mlp``: the recurrences run per head, and only the
projections, mLSTM's norm over every channel (summed squares) and
sLSTM's output half (the hidden state gathered) cross ranks.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (MlpConfig, _sum_onto, col_parts,
                                       init_rmsnorm, mlp, mlp_tp,
                                       own_slice, owned, rmsnorm,
                                       rmsnorm_tp, row_parts)
from repro_torch.models.params import Maker

_M0 = -1e30
# The caches' initial values, leaf by leaf: the ``init_*_cache`` functions
# and the train paths' first carry build from them, and a serving slot is
# reset to them.
MLSTM_CACHE_INIT = {"c": 0.0, "n": 0.0, "m": _M0}
SLSTM_CACHE_INIT = {"c": 0.0, "n": 0.0, "h": 0.0, "m": _M0}


@dataclasses.dataclass(frozen=True)
class XlstmConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0      # mLSTM up-projection
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 64

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def d_head(self) -> int:
        return self.d_inner // self.n_heads


def _full(shapes: dict, init: dict, *, device, lead=()):
    return {k: torch.full((*lead, *s), init[k], dtype=torch.float32,
                          device=device) for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(mk: Maker, cfg: XlstmConfig):
    d, i, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = i // h
    return {
        "up": mk((d, 2 * i), ("embed", "mlp"), init="fan_in"),
        # per-head block-diagonal q/k/v (as in xLSTM-1.3B)
        "wq": mk((h, dh, dh), ("heads", None, None), init="fan_in"),
        "wk": mk((h, dh, dh), ("heads", None, None), init="fan_in"),
        "wv": mk((h, dh, dh), ("heads", None, None), init="fan_in"),
        "w_if": mk((i, 2 * h), ("mlp", None), init="fan_in"),
        "b_if": mk((2 * h,), (None,), init="zeros"),
        "norm": init_rmsnorm(mk, i),
        "down": mk((i, d), ("mlp", "embed"), init="fan_in"),
    }


def _mlstm_qkvif(p, u, gates=None):
    """u: (B, W, H * Dh) -> q, k, v (B, H, W, Dh), logi / logf (B, H, W)
    float32; H and Dh are ``wq``'s (a rank's heads of a split layer).
    ``gates`` (B, W, 2H) float32, the input and forget gates' pre-
    activations with their bias, are made here from ``w_if`` / ``b_if``
    when None."""
    b, w, _ = u.shape
    h, dh = p["wq"].shape[0], p["wq"].shape[1]
    uh = u.reshape(b, w, h, dh).transpose(1, 2)            # (B, H, W, Dh)
    q = torch.einsum("bhwd,hde->bhwe", uh, p["wq"].to(u.dtype))
    k = torch.einsum("bhwd,hde->bhwe", uh, p["wk"].to(u.dtype)) * dh ** -0.5
    v = torch.einsum("bhwd,hde->bhwe", uh, p["wv"].to(u.dtype))
    if gates is None:
        gates = (torch.einsum("bwi,ig->bwg", u, p["w_if"].to(u.dtype))
                 .float() + p["b_if"].float())
    logi = gates[..., :h].transpose(1, 2)
    logf = F.logsigmoid(gates[..., h:]).transpose(1, 2)
    return q, k, v, logi, logf


def _mlstm_chunk(c0, n0, m0, q, k, v, logi, logf):
    """One chunk. Carry: C (B, H, Dk, Dv), n (B, H, Dk), m (B, H). ->
    (C, n, m, h_out (B, H, W, Dv))."""
    w = q.shape[2]
    a = torch.cumsum(logf, dim=2)                          # (B, H, W)
    g = torch.cummax(logi - a, dim=2).values
    m = a + torch.maximum(m0[..., None], g)                # (B, H, W)

    qf, kf, vf = q.float(), k.float(), v.float()

    # intra-chunk decay matrix; the upper triangle is masked before the
    # exp (it is 0 either way), so no inf enters the backward pass
    dmat = (a[..., :, None] - a[..., None, :]
            + logi[..., None, :] - m[..., :, None])
    tri = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    dmat = torch.exp(dmat.masked_fill(~tri, float("-inf")))  # (B,H,W,W)

    scores = torch.einsum("bhtd,bhsd->bhts", qf, kf) * dmat
    h_intra = torch.einsum("bhts,bhsv->bhtv", scores, vf)
    bscale = torch.exp(a + m0[..., None] - m)              # (B, H, W)
    h_inter = bscale[..., None] * torch.einsum("bhtd,bhdv->bhtv", qf, c0)
    n_t = (bscale[..., None] * n0[:, :, None]
           + torch.einsum("bhts,bhsd->bhtd", dmat, kf))    # (B, H, W, Dk)
    den = torch.maximum(torch.abs(torch.einsum("bhtd,bhtd->bht", qf, n_t)),
                        torch.exp(-m))
    h_out = (h_intra + h_inter) / den[..., None]           # (B, H, W, Dv)

    # end-of-chunk state
    a_w = a[..., -1:]                                      # (B, H, 1)
    m_next = (a_w + torch.maximum(m0[..., None], g[..., -1:]))[..., 0]
    wlast = torch.exp(a_w - a + logi - m_next[..., None])  # (B, H, W)
    cscale = torch.exp(a_w[..., 0] + m0 - m_next)          # (B, H)
    c_next = (cscale[..., None, None] * c0
              + torch.einsum("bhsd,bhsv->bhdv", wlast[..., None] * kf, vf))
    n_next = cscale[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", wlast,
                                                   kf)
    return c_next, n_next, m_next, h_out


def _mlstm_scan(chunk: int, q, k, v, logi, logf, dtype):
    """The chunkwise-parallel mLSTM over the whole sequence: q, k, v (B,
    H, S, Dh), logi / logf (B, H, S) -> h (B, S, H * Dh) in ``dtype``."""
    b, h, s, dh = q.shape
    w = min(chunk, s)
    s_pad = -(-s // w) * w
    if s_pad != s:  # pad tail; padded steps only affect sliced-off outputs
        q, k, v = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (q, k, v))
        logi, logf = (F.pad(t, (0, s_pad - s)) for t in (logi, logf))

    step = _mlstm_chunk
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, step, use_reentrant=False)
    carry = tuple(_full({"c": (b, h, dh, dh), "n": (b, h, dh), "m": (b, h)},
                        MLSTM_CACHE_INIT, device=q.device).values())
    hs = []
    for c in range(0, s_pad, w):
        *carry, h_c = step(*carry, *(t[:, :, c:c + w]
                                     for t in (q, k, v, logi, logf)))
        hs.append(h_c)
    # (B, H, S_pad, Dv) -> (B, S_pad, H * Dv) -> slice to S
    return (torch.cat(hs, 2).transpose(1, 2).reshape(b, s_pad, h * dh)
            [:, :s].to(dtype))


def mlstm_train(p, cfg: XlstmConfig, x):
    """x: (B, S, D) -> (B, S, D)."""
    i = cfg.d_inner
    uz = torch.einsum("bsd,de->bse", x, p["up"].to(x.dtype))
    u, z = uz[..., :i], uz[..., i:]
    h_all = _mlstm_scan(cfg.chunk_size, *_mlstm_qkvif(p, u), x.dtype)
    h_all = rmsnorm(p["norm"], h_all)
    y = h_all * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, p["down"].to(x.dtype))


def init_mlstm_cache(cfg: XlstmConfig, batch: int, *, device="cpu",
                     lead=()):
    h, dh = cfg.n_heads, cfg.d_head
    return _full({"c": (batch, h, dh, dh), "n": (batch, h, dh),
                  "m": (batch, h)}, MLSTM_CACHE_INIT, device=device,
                 lead=lead)


def _mlstm_step(cache, q, k, v, logi, logf):
    """One decode step of the recurrence: q, k, v (B, H, 1, Dh), logi /
    logf (B, H, 1) -> h (B, 1, H * Dh) float32; the new (C, n, m) are
    written into ``cache`` in place."""
    b = q.shape[0]
    qf, kf, vf = (t[:, :, 0].float() for t in (q, k, v))
    logi, logf = logi[..., 0], logf[..., 0]

    m0 = cache["m"]
    m = torch.maximum(logf + m0, logi)
    fg = torch.exp(logf + m0 - m)
    ig = torch.exp(logi - m)
    c = (fg[..., None, None] * cache["c"]
         + ig[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n = fg[..., None] * cache["n"] + ig[..., None] * kf
    num = torch.einsum("bhd,bhdv->bhv", qf, c)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                        torch.exp(-m))
    for name, t in (("c", c), ("n", n), ("m", m)):
        cache[name].copy_(t)
    return (num / den[..., None]).reshape(b, 1, -1)


def mlstm_decode(p, cfg: XlstmConfig, x, cache):
    """Single step. x: (B, 1, D); ``cache`` is written IN PLACE. ->
    (out (B, 1, D), cache)."""
    i = cfg.d_inner
    uz = torch.einsum("bsd,de->bse", x, p["up"].to(x.dtype))
    u, z = uz[..., :i], uz[..., i:]
    h_out = _mlstm_step(cache, *_mlstm_qkvif(p, u)).to(x.dtype)
    h_out = rmsnorm(p["norm"], h_out)
    y = h_out * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, p["down"].to(x.dtype)), cache


def mlstm_tp(ranks, cfg: XlstmConfig, x, caches=None):
    """:func:`mlstm_train` (``caches`` None) or :func:`mlstm_decode` (one
    step against ``caches[r]``, rank r's (C, n, m) of its heads, written in
    place) split over the model ranks ``ranks``, a list of (params slice,
    device). Rank r computes the heads it owns (:func:`layers.owned`) and
    their channels: ``wq`` / ``wk`` / ``wv`` are per head. ``up``'s
    columns are split in blocks of the concatenated [u | z], so each rank
    multiplies by the columns it holds and the output columns move to
    their heads' ranks. ``w_if`` splits on its rows: the ranks' gate
    products (B, S, 2H) are partial sums, summed before each rank takes
    its heads' gates. The norm runs over all ``d_inner`` channels, from
    the ranks' summed squares (:func:`layers.rmsnorm_tp`). ``down`` splits
    on its rows: partial outputs, summed."""
    i, h, dh = cfg.d_inner, cfg.n_heads, cfg.d_head
    heads = owned(h, ranks[0][0]["wq"].shape[0], len(ranks))
    own = [(a * dh, b * dh) for a, b in heads]
    uz = col_parts(ranks, "up", x, 2 * i,
                   [[(lo, hi), (i + lo, i + hi)] if hi > lo else []
                    for lo, hi in own])
    us = [None if t is None else t[..., :t.shape[-1] // 2] for t in uz]
    gates = _sum_onto(row_parts(ranks, "w_if", us, own, i), x.device)
    hs, zs = [None] * len(ranks), [None] * len(ranks)
    for r, ((p, dev), (a, b), u, t) in enumerate(zip(ranks, heads, us, uz)):
        if b == a:
            continue
        q = {k: own_slice(p[k], 0, a, b) for k in ("wq", "wk", "wv")}
        g = torch.cat([gates[..., a:b], gates[..., h + a:h + b]], -1)
        bias = torch.cat([p["b_if"][a:b], p["b_if"][h + a:h + b]])
        g = g.to(dev).float() + bias.float()
        qkvif = _mlstm_qkvif(q, u, g)
        if caches is None:
            hs[r] = _mlstm_scan(cfg.chunk_size, *qkvif, x.dtype)
        else:
            hs[r] = _mlstm_step(caches[r], *qkvif).to(x.dtype)
        zs[r] = t[..., t.shape[-1] // 2:]
    scales = [None if b == a else own_slice(p["norm"]["scale"], 0, lo, hi)
              for (p, _), (a, b), (lo, hi) in zip(ranks, heads, own)]
    ys = [None if hr is None else hr * F.silu(z)
          for hr, z in zip(rmsnorm_tp(scales, hs, i, x.device), zs)]
    return _sum_onto(row_parts(ranks, "down", ys, own, i), x.device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(mk: Maker, cfg: XlstmConfig):
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    f = int(d * cfg.slstm_proj_factor)
    return {
        "w": mk((d, 4 * d), ("embed", "mlp"), init="fan_in"),   # z,i,f,o
        "r": mk((h, dh, 4 * dh), ("heads", None, None), init="fan_in"),
        "b": mk((4 * d,), (None,), init="zeros"),
        "norm": init_rmsnorm(mk, d),
        "up_gate": mk((d, f), ("embed", "mlp"), init="fan_in"),
        "up": mk((d, f), ("embed", "mlp"), init="fan_in"),
        "down": mk((f, d), ("mlp", "embed"), init="fan_in"),
    }


def _slstm_cell(p, wx, state):
    """wx: (B, 4D) input projection for this step, in the per-head gate
    layout; state (c, n, h, m), each (B, D). -> the new state. The head
    count is ``r``'s (a rank's heads of a split layer)."""
    c, n, hid, m = state
    b, d = hid.shape
    h = p["r"].shape[0]
    dh = d // h
    # gate layout per head: [z, i, f, o] each dh wide
    rh = torch.einsum("bhx,hxy->bhy", hid.reshape(b, h, dh).float(),
                      p["r"].float())                      # (B, H, 4 * dh)
    rh4 = rh.reshape(b, h, 4, dh)
    wx4 = wx.float().reshape(b, h, 4, dh)
    pre = wx4 + rh4 + p["b"].float().reshape(1, h, 4, dh)
    z = torch.tanh(pre[:, :, 0])
    logi = pre[:, :, 1]
    logf = F.logsigmoid(pre[:, :, 2])
    o = torch.sigmoid(pre[:, :, 3])
    mh = m.reshape(b, h, dh)
    m_new = torch.maximum(logf + mh, logi)
    ig = torch.exp(logi - m_new)
    fg = torch.exp(logf + mh - m_new)
    ch = fg * c.reshape(b, h, dh) + ig * z
    nh = fg * n.reshape(b, h, dh) + ig
    hid_new = o * ch / torch.clamp(nh, min=1e-6)
    return (ch.reshape(b, d), nh.reshape(b, d),
            hid_new.reshape(b, d), m_new.reshape(b, d))


def _slstm_gates(n_heads: int, wx):
    """(..., 4D) projection in the (z, i, f, o)-per-d layout -> the
    per-head layout ``_slstm_cell`` reads."""
    d = wx.shape[-1] // 4
    lead = wx.shape[:-1]
    return (wx.reshape(*lead, 4, n_heads, d // n_heads)
            .transpose(-3, -2).reshape(*lead, 4 * d))


def _slstm_out(p, hid, dtype):
    """The sLSTM block's output half: norm, gated up-projection, down."""
    h_all = rmsnorm(p["norm"], hid.to(dtype))
    g = torch.einsum("bsd,df->bsf", h_all, p["up_gate"].to(dtype))
    u = torch.einsum("bsd,df->bsf", h_all, p["up"].to(dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["down"].to(dtype))


def _slstm_run(p, wx, state):
    """The cell over every position of wx (B, S, 4D), one step after
    another, from ``state`` -> every position's hidden state (B, S, D)."""
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(p, wx[:, t], state)
        hs.append(state[2])
    return torch.stack(hs, 1)


def slstm_train(p, cfg: XlstmConfig, x):
    """x: (B, S, D) -> (B, S, D); one cell step a position."""
    b, s, d = x.shape
    wx = _slstm_gates(cfg.n_heads, torch.einsum("bsd,de->bse", x,
                                                p["w"].to(x.dtype)))
    state = tuple(_full({k: (b, d) for k in SLSTM_CACHE_INIT},
                        SLSTM_CACHE_INIT, device=x.device).values())
    return _slstm_out(p, _slstm_run(p, wx, state), x.dtype)


def init_slstm_cache(cfg: XlstmConfig, batch: int, *, device="cpu",
                     lead=()):
    return _full({k: (batch, cfg.d_model) for k in SLSTM_CACHE_INIT},
                 SLSTM_CACHE_INIT, device=device, lead=lead)


def slstm_decode(p, cfg: XlstmConfig, x, cache):
    """Single step. x: (B, 1, D); ``cache`` is written IN PLACE. ->
    (out (B, 1, D), cache)."""
    wx = _slstm_gates(cfg.n_heads, torch.einsum("bsd,de->bse", x,
                                                p["w"].to(x.dtype))[:, 0])
    state = _slstm_cell(p, wx, tuple(cache[k] for k in "cnhm"))
    out = _slstm_out(p, state[2][:, None], x.dtype)
    for name, t in zip("cnhm", state):
        cache[name].copy_(t)
    return out, cache


def slstm_tp(ranks, cfg: XlstmConfig, x, caches=None):
    """:func:`slstm_train` (``caches`` None) or :func:`slstm_decode` (one
    step against ``caches[r]``, rank r's (c, n, h, m) channels of its
    heads, written in place) split over the model ranks ``ranks``, a list
    of (params slice, device). Rank r runs the cell on the heads it owns
    (:func:`layers.owned`), with its slice of the block-diagonal ``r`` and
    of the replicated bias ``b``. ``w``'s columns are split in blocks of
    the (z, i, f, o)-per-channel layout, so each rank multiplies by the
    columns it holds and the output columns move to their channels'
    ranks. The output half normalises over all d channels: the ranks'
    hidden states are gathered (an activation, not a weight), and
    ``up_gate`` / ``up`` / ``down`` then run as :func:`layers.mlp_tp`
    where the specs split them, else whole on rank 0 (their leaves
    replicated)."""
    b, _, d = x.shape
    h = cfg.n_heads
    dh = d // h
    heads = owned(h, ranks[0][0]["r"].shape[0], len(ranks))
    own = [(a * dh, e * dh) for a, e in heads]
    wx = col_parts(ranks, "w", x, 4 * d,
                   [[(g * d + lo, g * d + hi) for g in range(4)]
                    if hi > lo else [] for lo, hi in own])
    hids = []
    for r, ((p, dev), (a, e), w_r) in enumerate(zip(ranks, heads, wx)):
        if e == a:
            continue
        q = {"r": own_slice(p["r"], 0, a, e),
             "b": own_slice(p["b"], 0, 4 * a * dh, 4 * e * dh)}
        w_r = _slstm_gates(e - a, w_r)
        if caches is None:
            state = tuple(_full({k: (b, (e - a) * dh)
                                 for k in SLSTM_CACHE_INIT},
                                SLSTM_CACHE_INIT, device=dev).values())
            hids.append(_slstm_run(q, w_r, state))
            continue
        state = _slstm_cell(q, w_r[:, 0],
                            tuple(caches[r][k] for k in "cnhm"))
        for name, t in zip("cnhm", state):
            caches[r][name].copy_(t)
        hids.append(state[2][:, None])
    # The norm reads every channel: the ranks' hidden states (activations)
    # are gathered onto x's device.
    hid = torch.cat([t.to(x.device) for t in hids], -1)
    p0 = ranks[0][0]
    h_all = rmsnorm(p0["norm"], hid.to(x.dtype))
    mlp_cfg = MlpConfig(d, int(d * cfg.slstm_proj_factor), "swiglu")
    mlps = [({"w_gate": p["up_gate"], "w_up": p["up"], "w_down": p["down"]},
             dev) for p, dev in ranks]
    if p0["up_gate"].shape[1] != mlp_cfg.d_ff:          # split columns
        return mlp_tp(mlps, mlp_cfg, h_all)
    return mlp(mlps[0][0], mlp_cfg, h_all)
