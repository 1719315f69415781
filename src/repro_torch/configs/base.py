"""The four input-shape cells of the LM configurations, and which of them
a configuration supports.

Each arch file exports ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests). The dry-run's
``input_specs`` / ``input_axes`` are not ported (they lower JAX programs).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig


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
