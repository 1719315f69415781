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
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import init_rmsnorm, rmsnorm
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


def _mlstm_qkvif(p, cfg: XlstmConfig, u):
    """u: (B, W, I) -> q, k, v (B, H, W, Dh), logi / logf (B, H, W)
    float32."""
    b, w, _ = u.shape
    h, dh = cfg.n_heads, cfg.d_head
    uh = u.reshape(b, w, h, dh).transpose(1, 2)            # (B, H, W, Dh)
    q = torch.einsum("bhwd,hde->bhwe", uh, p["wq"].to(u.dtype))
    k = torch.einsum("bhwd,hde->bhwe", uh, p["wk"].to(u.dtype)) * dh ** -0.5
    v = torch.einsum("bhwd,hde->bhwe", uh, p["wv"].to(u.dtype))
    gates = (torch.einsum("bwi,ig->bwg", u, p["w_if"].to(u.dtype)).float()
             + p["b_if"].float())
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


def mlstm_train(p, cfg: XlstmConfig, x):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    i, h, dh = cfg.d_inner, cfg.n_heads, cfg.d_head
    uz = torch.einsum("bsd,de->bse", x, p["up"].to(x.dtype))
    u, z = uz[..., :i], uz[..., i:]
    q, k, v, logi, logf = _mlstm_qkvif(p, cfg, u)

    w = min(cfg.chunk_size, s)
    s_pad = -(-s // w) * w
    if s_pad != s:  # pad tail; padded steps only affect sliced-off outputs
        q, k, v = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (q, k, v))
        logi, logf = (F.pad(t, (0, s_pad - s)) for t in (logi, logf))

    step = _mlstm_chunk
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, step, use_reentrant=False)
    carry = tuple(_full({"c": (b, h, dh, dh), "n": (b, h, dh), "m": (b, h)},
                        MLSTM_CACHE_INIT, device=x.device).values())
    hs = []
    for c in range(0, s_pad, w):
        *carry, h_c = step(*carry, *(t[:, :, c:c + w]
                                     for t in (q, k, v, logi, logf)))
        hs.append(h_c)
    # (B, H, S_pad, Dv) -> (B, S_pad, H * Dv = I) -> slice to S
    h_all = (torch.cat(hs, 2).transpose(1, 2).reshape(b, s_pad, i)[:, :s]
             .to(x.dtype))
    h_all = rmsnorm(p["norm"], h_all)
    y = h_all * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, p["down"].to(x.dtype))


def init_mlstm_cache(cfg: XlstmConfig, batch: int, *, device="cpu",
                     lead=()):
    h, dh = cfg.n_heads, cfg.d_head
    return _full({"c": (batch, h, dh, dh), "n": (batch, h, dh),
                  "m": (batch, h)}, MLSTM_CACHE_INIT, device=device,
                 lead=lead)


def mlstm_decode(p, cfg: XlstmConfig, x, cache):
    """Single step. x: (B, 1, D); ``cache`` is written IN PLACE. ->
    (out (B, 1, D), cache)."""
    b = x.shape[0]
    i = cfg.d_inner
    uz = torch.einsum("bsd,de->bse", x, p["up"].to(x.dtype))
    u, z = uz[..., :i], uz[..., i:]
    q, k, v, logi, logf = _mlstm_qkvif(p, cfg, u)          # W = 1
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
    h_out = (num / den[..., None]).reshape(b, 1, i).to(x.dtype)
    h_out = rmsnorm(p["norm"], h_out)
    y = h_out * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["down"].to(x.dtype))
    for name, t in (("c", c), ("n", n), ("m", m)):
        cache[name].copy_(t)
    return out, cache


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


def _slstm_cell(p, cfg: XlstmConfig, wx, state):
    """wx: (B, 4D) input projection for this step, in the per-head gate
    layout; state (c, n, h, m), each (B, D). -> the new state."""
    c, n, hid, m = state
    b, d = hid.shape
    h, dh = cfg.n_heads, d // cfg.n_heads
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


def _slstm_gates(cfg: XlstmConfig, wx):
    """(..., 4D) projection in the (z, i, f, o)-per-d layout -> the
    per-head layout ``_slstm_cell`` reads."""
    d = wx.shape[-1] // 4
    lead = wx.shape[:-1]
    return (wx.reshape(*lead, 4, cfg.n_heads, d // cfg.n_heads)
            .transpose(-3, -2).reshape(*lead, 4 * d))


def _slstm_out(p, hid, dtype):
    """The sLSTM block's output half: norm, gated up-projection, down."""
    h_all = rmsnorm(p["norm"], hid.to(dtype))
    g = torch.einsum("bsd,df->bsf", h_all, p["up_gate"].to(dtype))
    u = torch.einsum("bsd,df->bsf", h_all, p["up"].to(dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["down"].to(dtype))


def slstm_train(p, cfg: XlstmConfig, x):
    """x: (B, S, D) -> (B, S, D); one cell step a position."""
    b, s, d = x.shape
    wx = _slstm_gates(cfg, torch.einsum("bsd,de->bse", x,
                                        p["w"].to(x.dtype)))
    state = tuple(_full({k: (b, d) for k in SLSTM_CACHE_INIT},
                        SLSTM_CACHE_INIT, device=x.device).values())
    hs = []
    for t in range(s):
        state = _slstm_cell(p, cfg, wx[:, t], state)
        hs.append(state[2])
    return _slstm_out(p, torch.stack(hs, 1), x.dtype)


def init_slstm_cache(cfg: XlstmConfig, batch: int, *, device="cpu",
                     lead=()):
    return _full({k: (batch, cfg.d_model) for k in SLSTM_CACHE_INIT},
                 SLSTM_CACHE_INIT, device=device, lead=lead)


def slstm_decode(p, cfg: XlstmConfig, x, cache):
    """Single step. x: (B, 1, D); ``cache`` is written IN PLACE. ->
    (out (B, 1, D), cache)."""
    wx = _slstm_gates(cfg, torch.einsum("bsd,de->bse", x,
                                        p["w"].to(x.dtype))[:, 0])
    state = _slstm_cell(p, cfg, wx, tuple(cache[k] for k in "cnhm"))
    out = _slstm_out(p, state[2][:, None], x.dtype)
    for name, t in zip("cnhm", state):
        cache[name].copy_(t)
    return out, cache
