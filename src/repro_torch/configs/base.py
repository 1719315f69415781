"""The four input-shape cells of the LM configurations, and which of them
a configuration supports.

Each arch file exports ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests).
``input_specs`` builds ``meta`` tensors standing in for every model input
of a (config, shape) cell, and ``input_axes`` their logical axes, which
``launch.sharding.batch_specs`` resolves on a mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.params import LogicalAxes
from repro_torch.models.transformer import ModelConfig, cache_axes


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

SMOKE_SHAPES = {
    "train": ShapeCell("smoke_train", "train", 32, 2),
    "decode": ShapeCell("smoke_decode", "decode", 32, 2),
}


def cell_supported(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """long_500k needs sub-quadratic decode."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-softmax attention: 512k-token decode is "
                       "quadratic-history; skipped per DESIGN.md §4")
    return True, ""


def _token_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.n_codebooks > 1:
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell,
                cache_dtype=torch.bfloat16) -> dict:
    """``meta`` stand-ins for every input of this cell (the JAX package's
    ``ShapeDtypeStruct`` tree). A decode cell's cache is
    ``lm.init_cache`` on ``meta``: its xLSTM leaves are float32, as in the
    concrete cache."""
    b, s = shape.global_batch, shape.seq
    if shape.kind in ("train", "prefill"):
        seq = s + 1 if shape.kind == "train" else s
        specs = {"tokens": _meta(_token_shape(cfg, b, seq), torch.int32)}
        if cfg.d_cross:
            specs["cross_states"] = _meta(
                (b, cfg.n_cross_tokens, cfg.d_cross), torch.bfloat16)
        return {"batch": specs}
    # decode: one new token against a seq-long cache
    return {
        "token": _meta(_token_shape(cfg, b, 1), torch.int32),
        "pos": _meta((b,), torch.int32),
        "cache": lm.init_cache(cfg, b, s, dtype=cache_dtype, device="meta"),
    }


def input_axes(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """LogicalAxes mirror of :func:`input_specs`."""
    tok_ax = LogicalAxes(("batch", None, None) if cfg.n_codebooks > 1
                         else ("batch", None))
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": tok_ax}
        if cfg.d_cross:
            specs["cross_states"] = LogicalAxes(("batch", None, None))
        return {"batch": specs}
    return {"token": tok_ax, "pos": LogicalAxes(("batch",)),
            "cache": cache_axes(cfg)}
