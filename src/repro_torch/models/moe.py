"""Mixture-of-Experts MLP: routing, capacity-slot dispatch, the batched
expert FFN and the gated combine, on one device or expert-parallel over a
mesh's "model" axis.

Dispatch is the JAX package's gather/scatter into static *capacity slots*
(no dense one-hot dispatch product): each (token, k) pair gets a position
within its expert by a per-``k`` cumulative count, pairs past the capacity
``cap`` go to a drop bin (the last row of the slot buffer), the expert FFN
runs as one batched product over all ``(E, cap)`` slots, and the kept
pairs' outputs are gathered back and summed with their gates in float32.

On one device (``mesh=None``) the port computes what the JAX package
computes over a (data=1, model=ep) mesh: every padded expert at once, with
``cap`` counted from ``n_experts_padded``. A slot's position is counted per
expert, so it does not depend on which rank owns the expert, and the sum
of the ranks' partial outputs is this single computation. The JAX local
path asserts ``ep == 1`` instead; the port accepts any ``ep`` (ROADMAP.md
§3, deliberate differences).

Over a mesh (``mesh=``, a ``launch.mesh.DeviceMesh`` whose model size must
be ``ep``) the port runs the JAX ``shard_map`` body rank by rank from one
controller: rank r owns experts ``[r * e_loc, (r + 1) * e_loc)``, and
rank (i, r) runs on ``mesh.device(i, r)``.

* ``weight_mode="fsdp"``: tokens split over the data rows (the batch
  whole on one row when it does not divide), ``cap`` counted from the
  row's own tokens, the rank's experts gathered whole over "data" (FSDP)
  onto its device, partials summed over "model" onto the row's device.
* ``weight_mode="tp_f"``: every rank sees every token; the weights stay
  in place, each data row holding a slice of the expert FFN width, and
  the partials are summed over (data, model).

A shared expert runs tensor-parallel over "model" (each rank its slice of
the shared FFN's columns). ``aux`` is the mean over shards of each
shard's own load-balancing term (the JAX ``pmean``).

There is no hand-written kernel here, as there is no Pallas kernel in the
JAX package's MoE: the expert products are ``torch.bmm`` and the dispatch
is ``index_add`` / indexing.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import MlpConfig, mlp
from repro_torch.models.params import Maker

_MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                 # per-expert intermediate width
    n_experts: int            # logical expert count (pre-padding)
    top_k: int
    n_shared: int = 0         # shared-expert multiplier (deepseek: 1)
    router: str = "softmax"   # "softmax" | "sigmoid" (deepseek aux-free)
    capacity_factor: float = 1.25
    ep: int = 1               # expert-parallel degree (model-axis size)
    routed_scale: float = 1.0  # deepseek routed_scaling_factor
    # The JAX package's expert-weight layout over a mesh ("fsdp" | "tp_f");
    # it does not change the function, and one device ignores it.
    weight_mode: str = "fsdp"

    @property
    def n_experts_padded(self) -> int:
        return math.ceil(self.n_experts / self.ep) * self.ep

    @property
    def e_loc(self) -> int:
        return self.n_experts_padded // self.ep


def init_moe(mk: Maker, cfg: MoeConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    p = {
        "router": mk((d, e), ("embed", None), init="fan_in"),
        "w_gate": mk((e, d, f), ("expert", "embed_fsdp", "mlp"),
                     init="fan_in"),
        "w_up": mk((e, d, f), ("expert", "embed_fsdp", "mlp"), init="fan_in"),
        "w_down": mk((e, f, d), ("expert", "mlp_fsdp", "embed"),
                     init="fan_in"),
    }
    if cfg.router == "sigmoid":
        p["e_bias"] = mk((e,), (None,), init="zeros")  # aux-loss-free bias
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {
            "w_gate": mk((d, fs), ("embed", "mlp"), init="fan_in"),
            "w_up": mk((d, fs), ("embed", "mlp"), init="fan_in"),
            "w_down": mk((fs, d), ("mlp", "embed"), init="fan_in"),
        }
    return p


def _top_k(x, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, ties in
    index order (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: MoeConfig, x_flat):
    """-> gates (T, K) f32, expert ids (T, K) int64, aux loss scalar."""
    logits = x_flat.float() @ p["router"].float()
    e = cfg.n_experts_padded
    pad = torch.arange(e, device=x_flat.device) >= cfg.n_experts
    if cfg.n_experts < e:  # mask padded experts off
        logits = torch.where(pad[None], _MASKED, logits)

    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["e_bias"].float()[None]
        if cfg.n_experts < e:
            sel = torch.where(pad[None], _MASKED, sel)
        _, eids = _top_k(sel, cfg.top_k)
        picked = torch.take_along_dim(scores, eids, dim=-1)
        gates = picked / torch.clamp_min(picked.sum(-1, keepdim=True), 1e-9)
        gates = gates * cfg.routed_scale
        probs = scores / torch.clamp_min(scores.sum(-1, keepdim=True), 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, eids = _top_k(probs, cfg.top_k)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # Switch-style load-balance aux (a metric for sigmoid/aux-free).
    t = x_flat.shape[0]
    # Counted by index_add, which needs no host sync (bincount has one).
    flat = eids.reshape(-1)
    counts = torch.zeros((e,), device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, device=flat.device))
    frac = counts / (t * cfg.top_k)
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    return gates, eids, aux


def _expert_ffn(x_slots, w_gate, w_up, w_down):
    """(E, C, D) -> (E, C, D), SwiGLU per expert."""
    dt = x_slots.dtype
    g = torch.bmm(x_slots, w_gate.to(dt))
    u = torch.bmm(x_slots, w_up.to(dt))
    return torch.bmm(F.silu(g) * u, w_down.to(dt))


def capacity(cfg: MoeConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens."""
    return max(8, int(tokens * cfg.top_k / cfg.n_experts_padded
                      * cfg.capacity_factor))


def _routed(w, cfg: MoeConfig, x_flat, gates, eids, lo: int):
    """The experts ``[lo, lo + n)`` of ``w`` (n = ``w["w_gate"].shape[0]``)
    over x_flat (T, D) -> their float32 partial output (T, D)."""
    t, d = x_flat.shape
    n_loc = w["w_gate"].shape[0]
    cap = capacity(cfg, t)
    n_slots = n_loc * cap
    x_slots = x_flat.new_zeros((n_slots + 1, d))     # last row = drop bin
    slot_of, keep_of = [], []
    # Per-k dispatch keeps transients at (T, D) instead of (T*K, D).
    occupancy = torch.zeros((n_loc,), dtype=torch.int64,
                            device=x_flat.device)
    every = n_loc == cfg.n_experts_padded   # one device: no mask needed
    for k in range(cfg.top_k):
        le = eids[:, k]                                        # (T,)
        if every:
            onehot = F.one_hot(le, n_loc)                      # (T, E)
        else:
            local = (le >= lo) & (le < lo + n_loc)
            le = (le - lo).clamp(0, n_loc - 1)
            onehot = F.one_hot(le, n_loc) * local[:, None]     # (T, E_loc)
        pos = torch.cumsum(onehot, dim=0) - 1
        pos_k = torch.take_along_dim(pos, le[:, None], dim=1)[:, 0]
        pos_k = pos_k + occupancy[le]
        occupancy = occupancy + onehot.sum(0)
        keep = pos_k < cap if every else local & (pos_k < cap)
        slot = torch.where(keep, le * cap + pos_k, n_slots)
        x_slots = x_slots.index_add(
            0, slot, torch.where(keep[:, None], x_flat, 0.0))
        slot_of.append(slot)
        keep_of.append(keep)

    y_slots = _expert_ffn(x_slots[:n_slots].reshape(n_loc, cap, d),
                          w["w_gate"], w["w_up"], w["w_down"])
    y_slots = torch.cat([y_slots.reshape(n_slots, d),
                         y_slots.new_zeros((1, d))], 0)

    y = torch.zeros((t, d), dtype=torch.float32, device=x_flat.device)
    for k in range(cfg.top_k):
        contrib = y_slots[slot_of[k]].float()
        wk = torch.where(keep_of[k], gates[:, k], 0.0)
        y = y + contrib * wk[:, None]
    return y


def _shared(p, cfg: MoeConfig, x):
    return mlp(p, MlpConfig(cfg.d_model, p["w_up"].shape[1]), x)


def _moe_core(p, cfg: MoeConfig, x):
    """x: (B, S, D) -> (out (B, S, D), aux) over all padded experts."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    gates, eids, aux = _route(p, cfg, x_flat)
    out = _routed(p, cfg, x_flat, gates, eids, 0).to(x.dtype)
    out = out.reshape(b, s, d)
    if cfg.n_shared:
        out = out + _shared(p["shared"], cfg, x)
    return out, aux


def _batch_rows(batch: int, data: int) -> list[tuple[int, int]]:
    """The batch rows of each data row: ``data`` equal runs, or the whole
    batch on one row when ``data`` does not divide it (the JAX rule:
    tokens replicate over a data axis that does not divide the batch)."""
    if batch % data:
        return [(0, batch)]
    n = batch // data
    return [(i * n, (i + 1) * n) for i in range(data)]


def _rank_weights(p, cfg: MoeConfig, mesh, i: int, r: int, f_split: int):
    """Rank (i, r)'s expert weights on ``mesh.device(i, r)``: its
    ``e_loc`` experts (whole in d_model), and under ``tp_f`` data row i's
    slice of the FFN width (``f_split`` slices); and its slice of the
    shared expert's columns. ``p`` is the whole tree or a placed
    ``ShardedTree``, whose ``local`` gathers the FSDP-split d_model."""
    dev = mesh.device(i, r)
    m = mesh.shape["model"]
    if isinstance(p, dict):
        def get(t):
            return mesh.replica(t, dev)
        loc = {k: v for k, v in p.items() if k != "shared"}
        shared = p.get("shared")
    else:
        loc = p.local(i, r)
        shared = loc.pop("shared", None)
        get = None
    w = {}
    for name in ("w_gate", "w_up", "w_down"):
        t = loc[name]
        if t.shape[0] == cfg.n_experts_padded:
            t = t[r * cfg.e_loc:(r + 1) * cfg.e_loc]
        if f_split > 1:                  # tp_f: F over the data rows
            f_dim = 1 if name == "w_down" else 2
            n = t.shape[f_dim] // f_split
            t = t.narrow(f_dim, i * n, n)
        w[name] = get(t) if get else t
    if shared is not None:
        fs = cfg.d_ff * cfg.n_shared
        sh = {}
        for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0)):
            t = shared[name]
            if t.shape[dim] == fs:
                if fs % m:
                    raise ValueError(f"the shared expert's {fs} columns do "
                                     f"not split over model={m}")
                t = t.narrow(dim, r * (fs // m), fs // m)
            sh[name] = get(t) if get else t
        w["shared"] = sh
    return w


def moe_sharded(p, cfg: MoeConfig, xs: list, mesh):
    """The MoE over ``mesh`` of the batch rows ``xs`` (row i on
    ``mesh.device(i, 0)``, ``len(xs)`` the mesh's data size, or 1 when the
    batch does not divide over it) -> (rows out, aux). ``p`` is the whole
    tree or a placed ``ShardedTree``."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    if m != cfg.ep:
        raise ValueError(f"moe over a mesh of model size {m} needs "
                         f"MoeConfig.ep == {m}, got ep={cfg.ep}")
    router = p["router"] if isinstance(p, dict) else p["router"].whole(0)
    e_bias = p.get("e_bias") if isinstance(p, dict) else (
        p["e_bias"].whole(0) if "e_bias" in p else None)
    route_p = {"router": router} if e_bias is None else \
        {"router": router, "e_bias": e_bias}

    def route(x_flat):
        return _route({k: v.to(x_flat.device) for k, v in route_p.items()},
                      cfg, x_flat)

    n_rows = len(xs)
    if cfg.weight_mode == "tp_f":
        x0 = torch.cat([x.to(xs[0].device) for x in xs], 0)
        b, s, dm = x0.shape
        gates, eids, aux = route(x0.reshape(b * s, dm))
        total, shared = None, None
        for i in range(n_rows):
            for r in range(m):
                dev = mesh.device(i, r)
                w = _rank_weights(p, cfg, mesh, i, r, n_rows)
                xf = x0.reshape(b * s, dm).to(dev)
                y = _routed(w, cfg, xf, gates.to(dev), eids.to(dev),
                            r * cfg.e_loc)
                if cfg.n_shared:         # routed partials in x's dtype
                    y = y.to(x0.dtype).float()
                    if i == 0:           # the shared partials vary over r
                        sy = _shared(w["shared"], cfg, xf).float()
                        sy = sy.to(x0.device)
                        shared = sy if shared is None else shared + sy
                y = y.to(x0.device)
                total = y if total is None else total + y
        if shared is not None:
            total = total + shared
        out = total.to(x0.dtype).reshape(b, s, dm)
        rows = _batch_rows(b, n_rows)
        return [out[b0:b1].to(x.device) for (b0, b1), x in zip(rows, xs)], \
            aux

    outs, auxs = [], []
    for i, x in enumerate(xs):
        b, s, dm = x.shape
        x_flat = x.reshape(b * s, dm)
        gates, eids, aux = route(x_flat)
        total = None
        for r in range(m):
            dev = mesh.device(i, r)
            w = _rank_weights(p, cfg, mesh, i, r, 1)
            xf = x_flat.to(dev)
            y = _routed(w, cfg, xf, gates.to(dev), eids.to(dev),
                        r * cfg.e_loc)
            if cfg.n_shared:
                y = y.to(x.dtype).float() + \
                    _shared(w["shared"], cfg, xf).float()
            y = y.to(x.device)
            total = y if total is None else total + y
        outs.append(total.to(x.dtype).reshape(b, s, dm))
        auxs.append(aux)
    return outs, torch.stack([a.to(xs[0].device) for a in auxs]).mean()


def moe_apply(p, cfg: MoeConfig, x, *, mesh=None):
    """MoE forward of x (B, S, D) -> (out, aux): on x's device without a
    mesh (for any ``ep``), else over ``mesh`` (see the module docstring),
    the result gathered back onto x's device."""
    if mesh is None:
        return _moe_core(p, cfg, x)
    rows = _batch_rows(x.shape[0], mesh.shape["data"])
    xs = [x[b0:b1].to(mesh.device(i, 0)) for i, (b0, b1) in enumerate(rows)]
    outs, aux = moe_sharded(p, cfg, xs, mesh)
    return torch.cat([o.to(x.device) for o in outs], 0), aux.to(x.device)
