"""Mixture-of-Experts MLP: routing, capacity-slot dispatch, the batched
expert FFN and the gated combine.

Dispatch is the JAX package's gather/scatter into static *capacity slots*
(no dense one-hot dispatch product): each (token, k) pair gets a position
within its expert by a per-``k`` cumulative count, pairs past the capacity
``cap`` go to a drop bin (the last row of the slot buffer), the expert FFN
runs as one batched product over all ``(E, cap)`` slots, and the kept
pairs' outputs are gathered back and summed with their gates in float32.

On one device the port computes what the JAX package computes over a
(data=1, model=ep) mesh: every padded expert at once, with ``cap`` counted
from ``n_experts_padded``. A slot's position is counted per expert, so it
does not depend on which rank owns the expert, and the sum of the ranks'
partial outputs is this single computation. The JAX local path
(``mesh=None``) asserts ``ep == 1`` instead; the port accepts any ``ep``
(ROADMAP.md §3, deliberate differences). A mesh is not ported yet.

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


def _moe_core(p, cfg: MoeConfig, x):
    """x: (B, S, D) -> (out (B, S, D), aux) over all padded experts."""
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    gates, eids, aux = _route(p, cfg, x_flat)

    e = cfg.n_experts_padded
    cap = capacity(cfg, t)
    n_slots = e * cap
    x_slots = x.new_zeros((n_slots + 1, d))          # last row = drop bin
    slot_of, keep_of = [], []
    # Per-k dispatch keeps transients at (T, D) instead of (T*K, D).
    occupancy = torch.zeros((e,), dtype=torch.int64, device=x.device)
    for k in range(cfg.top_k):
        le = eids[:, k]                                        # (T,)
        onehot = F.one_hot(le, e)                              # (T, E)
        pos = torch.cumsum(onehot, dim=0) - 1
        pos_k = torch.take_along_dim(pos, le[:, None], dim=1)[:, 0]
        pos_k = pos_k + occupancy[le]
        occupancy = occupancy + onehot.sum(0)
        keep = pos_k < cap
        slot = torch.where(keep, le * cap + pos_k, n_slots)
        x_slots = x_slots.index_add(
            0, slot, torch.where(keep[:, None], x_flat, 0.0))
        slot_of.append(slot)
        keep_of.append(keep)

    y_slots = _expert_ffn(x_slots[:n_slots].reshape(e, cap, d),
                          p["w_gate"], p["w_up"], p["w_down"])
    y_slots = torch.cat([y_slots.reshape(n_slots, d),
                         y_slots.new_zeros((1, d))], 0)

    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for k in range(cfg.top_k):
        contrib = y_slots[slot_of[k]].float()
        w = torch.where(keep_of[k], gates[:, k], 0.0)
        y = y + contrib * w[:, None]
    out = y.to(x.dtype).reshape(b, s, d)

    if cfg.n_shared:
        out = out + mlp(p["shared"], MlpConfig(d, cfg.d_ff * cfg.n_shared), x)
    return out, aux


def moe_apply(p, cfg: MoeConfig, x, *, mesh=None):
    """MoE forward of x (B, S, D) -> (out, aux) on one device, for any
    ``ep`` (see the module docstring)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply(mesh=...) is not ported yet (ROADMAP.md §1, the "
            "DecodeEngine(mesh=) / launch/sharding.py item)")
    return _moe_core(p, cfg, x)
