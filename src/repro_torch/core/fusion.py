"""Stage-fusion planner — paper §IV-D (BLI (+) conv fusion).

Decides, per deformable-conv layer, whether the three processing stages
(offset conv -> BLI -> main conv) are executed

  * ``FUSED``    : stages 2+3 tiled together; the deformed-feature
                   intermediate (K*K x the input feature map) lives only in
                   on-chip memory (shared memory on the GPU) — the CUDA
                   kernel ``repro_torch.kernels.dcn_fused`` implements
                   this dataflow; or
  * ``STAGED``   : each stage round-trips through DRAM/HBM — only chosen
                   when a fused tile cannot fit on-chip even at the minimum
                   tile size.

The planner mirrors the paper's observation that the index tensor is small
and always buffered on-chip, while the deformed features dominate and are
what fusion must keep on-chip.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum


class FusionMode(str, Enum):
    FUSED = "fused"
    STAGED = "staged"


@dataclass(frozen=True)
class LayerShape:
    h: int
    w: int
    c_in: int
    c_out: int
    kernel_size: int = 3
    dtype_bytes: int = 1  # paper: 8-bit fixed point; the f32 path uses 4


@dataclass(frozen=True)
class FusionPlan:
    mode: FusionMode
    tile_pixels: int          # output pixels processed per fused tile
    vmem_bytes: int           # on-chip working set of one fused tile
    dram_bytes_saved: int     # intermediate round-trip avoided vs STAGED


def fused_tile_bytes(shape: LayerShape, tile_pixels: int,
                     halo: int = 2) -> int:
    """On-chip working set of one fused output tile.

    input halo tile + deformed patch matrix + conv weights + output tile.
    The deformed patch matrix is (tile_pixels, K*K*C_in) — the tensor the
    paper keeps on-chip. The halo region covers the clamped offset range;
    ``halo`` is in units of tile side lengths (offsets clamped to R force
    halo <= R, DESIGN.md §2).
    """
    kk2 = shape.kernel_size ** 2
    side = max(1, int(math.sqrt(tile_pixels)))
    in_side = side * (1 + halo)
    input_tile = in_side * in_side * shape.c_in * shape.dtype_bytes
    deformed = tile_pixels * kk2 * shape.c_in * shape.dtype_bytes
    weights = kk2 * shape.c_in * shape.c_out * shape.dtype_bytes
    output = tile_pixels * shape.c_out * shape.dtype_bytes
    coords = tile_pixels * kk2 * 2 * 4  # fp32 indices (index buffer)
    return input_tile + deformed + weights + output + coords


def plan_fusion(shape: LayerShape, onchip_budget_bytes: int,
                min_tile_pixels: int = 64) -> FusionPlan:
    """Pick the largest fused tile that fits the on-chip budget.

    Tries power-of-two tile sizes from the full plane downwards; falls back
    to STAGED only if even ``min_tile_pixels`` does not fit (e.g. enormous
    C_in*C_out weight working sets).
    """
    total_pixels = shape.h * shape.w
    kk2 = shape.kernel_size ** 2
    saved = 2 * total_pixels * kk2 * shape.c_in * shape.dtype_bytes
    min_tile_pixels = min(min_tile_pixels, total_pixels)  # tiny planes fuse

    t = 1 << (total_pixels - 1).bit_length()  # >= total_pixels, pow2
    while t >= min_tile_pixels:
        vmem = fused_tile_bytes(shape, min(t, total_pixels))
        if vmem <= onchip_budget_bytes:
            return FusionPlan(FusionMode.FUSED, min(t, total_pixels), vmem,
                              dram_bytes_saved=saved)
        t //= 2
    return FusionPlan(FusionMode.STAGED, min_tile_pixels,
                      fused_tile_bytes(shape, min_tile_pixels),
                      dram_bytes_saved=0)


def plan_network(shapes: list[LayerShape], onchip_budget_bytes: int
                 ) -> list[FusionPlan]:
    return [plan_fusion(s, onchip_budget_bytes) for s in shapes]


@dataclass(frozen=True)
class GroupPlan:
    """One *cross-layer* fused group: consecutive layers whose boundary
    feature planes never round-trip through DRAM (§IV-D taken network-wide,
    Fig. 18). ``start``/``stop`` index the layer-shape chain half-open."""

    start: int
    stop: int
    plans: tuple[FusionPlan, ...]
    dram_bytes_saved: int     # interior boundary planes (write+read) elided

    @property
    def n_layers(self) -> int:
        return self.stop - self.start


def plan_fused_groups(shapes: list[LayerShape], onchip_budget_bytes: int,
                      ) -> list[GroupPlan]:
    """Partition a chain of same-resolution layers into fused groups.

    Layers whose per-layer plan is FUSED are merged into maximal runs; a
    STAGED layer (its fused tile cannot fit on-chip even at the minimum
    tile size) becomes a singleton group whose boundaries materialize.
    The interior boundary planes of a multi-layer group are the §IV-D
    saving, counted as one write plus one read of each interior plane.
    """
    plans = plan_network(shapes, onchip_budget_bytes)
    groups: list[GroupPlan] = []
    run_start: int | None = None

    def flush(stop: int) -> None:
        nonlocal run_start
        if run_start is None:
            return
        saved = sum(2 * shapes[j].h * shapes[j].w * shapes[j].c_out
                    * shapes[j].dtype_bytes
                    for j in range(run_start, stop - 1))
        groups.append(GroupPlan(run_start, stop,
                                tuple(plans[run_start:stop]), saved))
        run_start = None

    for i, p in enumerate(plans):
        if p.mode is FusionMode.STAGED:
            flush(i)
            groups.append(GroupPlan(i, i + 1, (p,), 0))
        elif run_start is None:
            run_start = i
    flush(len(plans))
    return groups
