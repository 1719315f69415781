"""Logical-axis -> mesh sharding rules, per arch x shape, and placing a
parameter tree on a mesh by them.

The rule tables are the JAX package's, entry for entry: they map the
logical axes recorded at param-init time (``models.params``) to mesh
axes, and ``resolve_spec`` drops a mesh axis that does not divide its
dimension or is already used, so e.g. smollm's 15 heads degrade to
replication instead of failing.

Policy:
  * activations: batch over ("pod", "data"); tensor parallelism over
    "model" (heads, kv heads, MLP columns, vocabulary, experts);
  * weights: the same dims over "model"; for archs of more than 8 GB of
    bf16 params the d_model dim is also FSDP-sharded over ("pod",
    "data"), and a layer's leaf is gathered onto its row's device at its
    use (``ShardedTree.local``);
  * decode caches: the JAX rule puts kv_seq on "model" (split-S, the
    softmax combined across chips). The port's decode cache follows its
    own layout instead — each model rank holds the kv heads its query
    heads read (``transformer.shard_cache``) — since the decode kernel
    #8 returns normalised outputs with nothing to merge across a split
    sequence (ROADMAP.md §3). ``sharding_rules`` still returns the JAX
    entry.

The mesh has no "pod" axis; the rules name it, as the JAX ones do, and
``resolve_spec`` drops it. In place of the JAX ``to_shardings`` +
``device_put``, ``ShardedTree.place(params, specs, mesh)`` places a tree:
device (i, r) holds each leaf's slice for data row i and model rank r.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.params import (abstract_params, param_axes,
                                       param_bytes, tree_specs)
from repro_torch.models.transformer import ModelConfig

FSDP_BYTES_THRESHOLD = 8e9  # params sizes above this get FSDP'd d_model


def sharding_rules(cfg: ModelConfig, *, kind: str = "train",
                   long_ctx: bool = False,
                   fsdp: bool | None = None) -> dict:
    if fsdp is None:
        ab = abstract_params(lambda mk: lm.make_lm(mk, cfg),
                             dtype=torch.bfloat16)
        fsdp = param_bytes(ab) > FSDP_BYTES_THRESHOLD
    dp = ("pod", "data")
    return {
        "batch": dp,
        "vocab": "model",
        "embed": dp if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "embed_fsdp": dp,      # MoE expert weights always FSDP (they dominate)
        "mlp_fsdp": dp,
        "q_lora": None,
        "kv_lora": None,
        "layers": None,        # the layer-stack axis: never mesh-sharded
        "heads_inner": "model",
        "codebook": None,
        "kv_seq": (("data", "model") if long_ctx
                   else ("model" if kind == "decode" else None)),
    }


def param_tree_specs(cfg: ModelConfig, mesh, rules, dtype=torch.bfloat16):
    """-> (spec tree, ``meta`` param tree) of ``cfg`` under ``rules``."""
    axes = param_axes(lambda mk: lm.make_lm(mk, cfg))
    ab = abstract_params(lambda mk: lm.make_lm(mk, cfg), dtype=dtype)
    return tree_specs(axes, ab, rules, mesh), ab


def batch_specs(mesh, rules, input_axes_tree, input_specs_tree):
    """The spec tree of a cell's inputs (``configs.base.input_axes`` and
    ``input_specs``)."""
    return tree_specs(input_axes_tree, input_specs_tree, rules, mesh)
