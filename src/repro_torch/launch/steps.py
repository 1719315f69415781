"""Train / prefill / decode steps placed on a device mesh.

``build_step`` is the JAX package's single entry point for the trainer,
the server and the dry-run: it resolves the sharding rule table for
(config, shape), resolves the spec of every param and input on the mesh,
and returns the step with everything needed to run it without allocating
a parameter (``meta`` tensors end to end). Every step takes the JAX
step's arguments: params (whole, placed on their first call, or placed
once with ``ShardedTree.place(params, bundle.param_shardings, mesh)``,
the fast path) and the inputs, and runs over the mesh from one
controller (``models.transformer``).

* prefill returns the logits assembled on ``mesh.device(0, 0)``;
* decode takes a ``transformer.ShardedCache`` (a whole cache is placed on
  its first call), updates it in place and returns it;
* train (``fn(params, opt_state, batch)``) runs ``lm.lm_loss`` over the
  mesh, its gradient with respect to every held slice
  (:func:`value_and_grad_placed`, autograd in place of the JAX
  package's ``jax.value_and_grad``), then ``adamw_update`` on the
  placed params and moments (``opt_shardings``), and returns the placed
  trees, updated in place (the JAX step's donated buffers).
  ``build_train_step`` is the same step on whole trees on one device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch._tree import tree_leaves, tree_map, value_and_grad
from repro_torch.configs import base as cfgbase
from repro_torch.launch.sharding import param_tree_specs, sharding_rules
from repro_torch.models import lm
from repro_torch.models.params import ShardedTree, map_tree
from repro_torch.models.transformer import (ModelConfig, ShardedCache,
                                            cache_split, shard_cache)
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state


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


def value_and_grad_placed(fn: Callable, params: ShardedTree):
    """``fn(params)`` and the gradient of its value (the first element
    when it returns a tuple) with respect to the logical params, as a
    tree placed as ``params``.

    Every held slice ``params.shards[i][r]`` is a leaf of its own
    (detached, so ``params`` never require grad), so autograd gives each
    device the part of the gradient its own reads caused: a data row's
    part for a leaf that every row holds, rank 0's for one that
    ``ShardedTree.whole`` reads, each reader's for a slice that
    ``ShardedTree.local`` gathers (FSDP). A slice's gradient is the sum
    of its holders' parts, taken once on its home device (the JAX
    data-parallel all-reduce) and held by every holder
    (``ShardedTree.per_slice``)."""
    req = params.map(lambda t: t.detach().requires_grad_(True))
    out = fn(req)
    value = out[0] if isinstance(out, tuple) else out
    held = req.flat_leaves()
    n_leaf = len(held[0])
    parts = list(torch.autograd.grad(
        value, [t for dev in held for t in dev], allow_unused=True))

    def total(j, ks):
        home = held[ks[0]][j]
        acc = None
        for k in ks:
            g, parts[k * n_leaf + j] = parts[k * n_leaf + j], None
            if g is not None:
                g = g.to(home.device)
                acc = g if acc is None else acc + g
        return torch.zeros_like(home) if acc is None else acc

    grads = params.per_slice(total)
    out = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                   else t, out)
    return out, grads


def _copied(tree: ShardedTree) -> ShardedTree:
    """A copy of a placed tree, one tensor a distinct slice."""
    held = tree.flat_leaves()
    return tree.per_slice(lambda j, ks: held[ks[0]][j].clone())


@dataclasses.dataclass
class StepBundle:
    """The step ``fn``, the rule table it was resolved under, the spec
    tree of the params (``ShardedTree.place``) and, for a train step,
    that of the optimizer state: ``{"step": (), "m": param specs, "v":
    param specs}``. :attr:`args_abstract` gives fake stand-ins of its
    arguments, made on first use."""

    fn: Callable
    rules: dict
    param_shardings: Any
    opt_shardings: Any = None
    abstract: Callable | None = dataclasses.field(default=None, repr=False)

    @functools.cached_property
    def args_abstract(self) -> tuple:
        """Fake stand-ins (``FakeTensorMode``: no memory) of ``fn``'s
        arguments as the step receives them on its mesh, the JAX
        package's ``ShapeDtypeStruct`` arguments: (params, opt_state,
        batch) for train, (params, batch) for prefill and (params, cache,
        token, pos) for decode (a bf16 cache, as ``configs.base.
        input_specs`` makes it). The params, the AdamW moments and a
        decode cache are placed (``ShardedTree.place``, ``shard_cache``):
        every device holds its own slices; the step count and the inputs
        lie on ``mesh.device(0, 0)``. ``launch.op_analysis.analyze_step``
        runs ``fn`` on them."""
        return self.abstract()


def _abstract_args(cfg: ModelConfig, shape: cfgbase.ShapeCell, mesh,
                   pspecs, params_ab, opt_cfg: AdamWConfig | None) -> tuple:
    """:attr:`StepBundle.args_abstract` of a cell: made inside a fresh
    ``FakeTensorMode``, whole on the (fake) CPU, then placed as the step
    receives them (a plain ``meta`` tensor would take no device index,
    and ops on it would lie on no device of the mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = mesh.device(0, 0)
    host = lambda t: torch.empty(t.shape, dtype=t.dtype)
    on_out = lambda t: torch.empty(t.shape, dtype=t.dtype, device=out)
    with FakeTensorMode():
        params = ShardedTree.place(map_tree(host, params_ab), pspecs, mesh)
        ins = cfgbase.input_specs(cfg, shape)
        if shape.kind == "train":
            return (params, init_opt_state(params, opt_cfg),
                    map_tree(on_out, ins["batch"]))
        if shape.kind == "prefill":
            return params, map_tree(on_out, ins["batch"])
        cache = shard_cache(cfg, map_tree(host, ins["cache"]), mesh,
                            cache_split(params["layers"], cfg))
        return params, cache, on_out(ins["token"]), \
            torch.zeros(ins["pos"].shape, dtype=torch.int32, device=out)


def build_step(cfg: ModelConfig, shape: cfgbase.ShapeCell, mesh,
               opt_cfg: AdamWConfig | None = None,
               param_dtype=torch.bfloat16,
               donate: bool = True,
               rules_override: dict | None = None) -> StepBundle:
    """The ``shape.kind`` step of ``cfg`` on ``mesh`` (a
    ``launch.mesh.DeviceMesh``); see the module docstring. ``donate=False``
    leaves the params and optimizer state passed to the train step, and a
    placed cache passed to the decode step, unchanged (the step works on
    a copy)."""
    long_ctx = shape.name == "long_500k"
    rules = rules_override if rules_override is not None else \
        sharding_rules(cfg, kind=shape.kind, long_ctx=long_ctx)
    pspecs, params_ab = param_tree_specs(cfg, mesh, rules, param_dtype)
    abstract = functools.partial(
        _abstract_args, cfg, shape, mesh, pspecs, params_ab,
        (opt_cfg or AdamWConfig()) if shape.kind == "train" else None)

    def placed(params):
        if isinstance(params, ShardedTree):
            return params
        return ShardedTree.place(params, pspecs, mesh)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        ospecs = {"step": (), "m": pspecs, "v": pspecs}
        ctx = {"mesh": mesh}
        out = mesh.device(0, 0)

        def place_opt(state):
            return {"step": state["step"].to(out),
                    **{k: placed(state[k]) for k in ("m", "v")}}

        def train_step(params, opt_state, batch):
            params, opt_state = placed(params), place_opt(opt_state)
            if not donate:
                params = _copied(params)
                opt_state = {"step": opt_state["step"].clone(),
                             **{k: _copied(opt_state[k]) for k in ("m", "v")}}
            batch = {k: torch.as_tensor(v).to(out) for k, v in batch.items()}
            (_, metrics), grads = value_and_grad_placed(
                lambda p: lm.lm_loss(p, cfg, batch, ctx), params)
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt_cfg)
            return params, opt_state, {**metrics, **om}

        return StepBundle(train_step, rules, pspecs, ospecs, abstract)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return lm.lm_prefill(placed(params), cfg, batch, {"mesh": mesh})

        return StepBundle(prefill_step, rules, pspecs, abstract=abstract)

    def decode_step(params, cache, token, pos):
        params = placed(params)
        if not isinstance(cache, ShardedCache):
            cache = shard_cache(cfg, cache, mesh,
                                cache_split(params["layers"], cfg))
        elif not donate:
            cache = shard_cache(cfg, cache.gather(), mesh, cache.split)
        return lm.lm_decode_step(params, cfg, cache, token, pos,
                                 {"mesh": mesh})

    return StepBundle(decode_step, rules, pspecs, abstract=abstract)
