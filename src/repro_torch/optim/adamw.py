"""AdamW over trees of tensors, cosine schedule, global-norm clipping.

Plain functions over the param trees the port uses (the JAX package's
``optim.adamw``, no ``torch.optim``): the state is ``{"step": int32
scalar tensor, "m": tree, "v": tree}``, arithmetic runs in float32 and the
moments may be kept in bfloat16 (``AdamWConfig.state_dtype``). Decoupled
weight decay applies to tensors of two or more dimensions only. The
update is written in place, as the JAX trainer donates its buffers.

Params placed on a mesh (``models.params.ShardedTree``) take placed
gradients and moments (``init_opt_state`` places them as the params):
each distinct slice of a leaf is updated once, on its home device, and
written into every device that holds it, and the global norm counts
each logical element once, as the JAX step's norm over global arrays.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models.params import ShardedTree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    state_dtype: torch.dtype = torch.float32


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr``; a
    float32 scalar on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    if isinstance(params, ShardedTree):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=params.mesh.device(0, 0)),
                "m": params.zeros(cfg.state_dtype),
                "v": params.zeros(cfg.state_dtype)}
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _distinct(tree) -> list:
    """Each logical element's tensors once: a placed tree's slices' home
    copies, else the leaves."""
    if isinstance(tree, ShardedTree):
        return [held[0] for leaf in tree.slices() for held in leaf]
    return tree_leaves(tree)


def global_norm(tree) -> torch.Tensor:
    parts = _distinct(tree)
    dev = parts[0].device
    return torch.sqrt(sum(torch.sum(torch.square(l.float())).to(dev)
                          for l in parts))


def _clip_scale(norm: torch.Tensor, max_norm) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """-> (grads scaled to a global norm of at most ``max_norm``, the
    global norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, written into ``params`` and ``state`` leaf by leaf
    (the JAX step's donated buffers: only one leaf's temporaries are alive
    at a time). -> (params, state, {"lr", "grad_norm"}), the same trees
    that came in."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    # Clipping scales each gradient as it is used, so no clipped copy of
    # the whole gradient tree is ever alive (clip_by_global_norm's values).
    scale = None if cfg.clip_norm is None else _clip_scale(gnorm,
                                                           cfg.clip_norm)
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    trees = (params, grads, state["m"], state["v"])
    if isinstance(params, ShardedTree):  # a distinct slice: its holders
        flat = [[h for leaf in t.slices() for h in leaf] for t in trees]
    else:
        flat = [[[l] for l in tree_leaves(t)] for t in trees]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("params, grads and the moments differ in leaves")
    for ps, gs, ms, vs in zip(*flat):
        p, g, m, v = ps[0], gs[0], ms[0], vs[0]
        # A placed slice's home may be another device than the step's.
        lr_, bc1_, bc2_ = lr.to(p.device), bc1.to(p.device), bc2.to(p.device)
        scale_ = None if scale is None else scale.to(p.device)
        gf = g.float() if scale_ is None else \
            (g.float() * scale_).to(g.dtype).float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        step_vec = (mf / bc1_) / (torch.sqrt(vf / bc2_) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:  # decoupled decay on matrices only
            pf = pf * (1.0 - lr_ * cfg.weight_decay)
        for held, value in ((ps, pf - lr_ * step_vec), (ms, mf), (vs, vf)):
            _write(held, value)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _write(held: list, value: torch.Tensor) -> None:
    """``value`` into every tensor of ``held``, once per distinct memory:
    on a device that a mesh lists several times the holders view the
    same storage."""
    done = []
    for t in held:
        key = (t.device, t.data_ptr(), tuple(t.shape), t.stride())
        if key not in done:
            t.copy_(value)
            done.append(key)
