"""Train / prefill / decode steps placed on a device mesh.

``build_step`` is the JAX package's single entry point for the trainer,
the server and the dry-run: it resolves the sharding rule table for
(config, shape), resolves the spec of every param and input on the mesh,
and returns the step with everything needed to run it without allocating
a parameter (``meta`` tensors end to end). The prefill and decode steps
take the JAX step's arguments: params (whole, or placed once with
``ShardedTree.place(params, bundle.param_shardings, mesh)``, the fast
path) and the inputs; they run tensor-parallel over the mesh from one
controller (``models.transformer``) and return the logits assembled on
``mesh.device(0, 0)``. The decode step's cache is a
``transformer.ShardedCache`` (a whole cache is placed on its first
call), updated in place and returned.

Training over a mesh is the next slice: ``kind="train"`` runs on a (1, 1)
mesh only, as :func:`build_train_step`, the loss and its gradient by
autograd (the JAX package's ``jax.value_and_grad``), then
``adamw_update``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch._tree import tree_leaves, value_and_grad
from repro_torch.configs import base as cfgbase
from repro_torch.launch.sharding import param_tree_specs, sharding_rules
from repro_torch.models import lm
from repro_torch.models.params import ShardedTree
from repro_torch.models.transformer import (ModelConfig, ShardedCache,
                                            heads_split, shard_cache)
from repro_torch.optim import AdamWConfig, adamw_update


def build_train_step(cfg: ModelConfig,
                     opt_cfg: AdamWConfig | None = None) -> Callable:
    """-> ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``batch`` is ``{"tokens": (B, S+1[, n_cb])}``, with ``"cross_states"``
    (B, S_kv, d_cross) for a cross-attention model (numpy or tensors;
    moved to the params' device). ``metrics`` holds ``ce``, ``aux``,
    ``loss``, ``lr`` and ``grad_norm`` as scalar tensors. The update is written
    into ``params`` and ``opt_state`` (the JAX step's donated buffers),
    which come back as the same trees."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        (_, metrics), grads = value_and_grad(
            lambda p: lm.lm_loss(p, cfg, batch), params)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {
            **{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


@dataclasses.dataclass
class StepBundle:
    """The step ``fn``, the rule table it was resolved under and the spec
    tree of the params (``ShardedTree.place``)."""

    fn: Callable
    rules: dict
    param_shardings: Any


def build_step(cfg: ModelConfig, shape: cfgbase.ShapeCell, mesh,
               opt_cfg: AdamWConfig | None = None,
               param_dtype=torch.bfloat16,
               donate: bool = True,
               rules_override: dict | None = None) -> StepBundle:
    """The ``shape.kind`` step of ``cfg`` on ``mesh`` (a
    ``launch.mesh.DeviceMesh``); see the module docstring. ``donate=False``
    leaves a placed cache passed to the decode step unchanged (the step
    works on a copy)."""
    long_ctx = shape.name == "long_500k"
    rules = rules_override if rules_override is not None else \
        sharding_rules(cfg, kind=shape.kind, long_ctx=long_ctx)
    pspecs, _ = param_tree_specs(cfg, mesh, rules, param_dtype)

    if shape.kind == "train":
        if mesh.shape["data"] * mesh.shape["model"] > 1:
            raise NotImplementedError(
                "build_step(kind='train') over a mesh larger than (1, 1) is "
                "the next slice of the port (ROADMAP.md §1 item 5: "
                "training over the mesh)")
        return StepBundle(build_train_step(cfg, opt_cfg), rules, pspecs)

    def placed(params):
        if isinstance(params, ShardedTree):
            return params
        return ShardedTree.place(params, pspecs, mesh)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return lm.lm_prefill(placed(params), cfg, batch, {"mesh": mesh})

        return StepBundle(prefill_step, rules, pspecs)

    def decode_step(params, cache, token, pos):
        params = placed(params)
        if not isinstance(cache, ShardedCache):
            cache = shard_cache(cfg, cache, mesh,
                                heads_split(params["layers"], cfg))
        elif not donate:
            cache = shard_cache(cfg, cache.gather(), mesh, cache.split)
        return lm.lm_decode_step(params, cfg, cache, token, pos,
                                 {"mesh": mesh})

    return StepBundle(decode_step, rules, pspecs)
