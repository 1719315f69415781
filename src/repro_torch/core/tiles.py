"""Tile Dependency Table (TDT) — paper §IV-C, Fig. 9.

Input and output feature maps are divided into fixed tiles. For each
*output* tile the TDT records, as a bit vector over *input* tiles, which
input tiles its deformable convolution touches: every deformed sample
needs the 4 integer-grid neighbours of its (row, col) coordinate, and
each neighbour lands in exactly one input tile (the paper's boundary
comparator + decoder, here an integer divide).

``tdt_from_coords`` is the torch scatter version (the host schedule
backend runs it on the CPU); the on-device kernel lives in
``repro_torch.kernels.dcn_schedule``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TileGrid(NamedTuple):
    """A tiling of an (H, W) feature plane into th x tw tiles."""

    h: int
    w: int
    th: int
    tw: int

    @property
    def rows(self) -> int:
        return math.ceil(self.h / self.th)

    @property
    def cols(self) -> int:
        return math.ceil(self.w / self.tw)

    @property
    def num_tiles(self) -> int:
        return self.rows * self.cols

    def tile_of(self, r, c):
        """Tile id of integer pixel coordinates (vectorised)."""
        return (r // self.th) * self.cols + (c // self.tw)

    def tile_bytes(self, channels: int, dtype_bytes: int = 1) -> int:
        return self.th * self.tw * channels * dtype_bytes


def neighbour_tiles(coords: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Input-tile id of each of the 4 BLI neighbours of every coordinate:
    coords (..., 2) float -> (..., 4) int64."""
    r0 = torch.floor(coords[..., 0]).long().clamp(0, grid.h - 1)
    c0 = torch.floor(coords[..., 1]).long().clamp(0, grid.w - 1)
    r1 = (r0 + 1).clamp(0, grid.h - 1)
    c1 = (c0 + 1).clamp(0, grid.w - 1)
    return torch.stack([grid.tile_of(r0, c0), grid.tile_of(r0, c1),
                        grid.tile_of(r1, c0), grid.tile_of(r1, c1)], dim=-1)


def tdt_from_coords(coords: torch.Tensor, in_grid: TileGrid,
                    out_grid: TileGrid) -> torch.Tensor:
    """TDT of one image: coords (H, W, KK, 2) -> B (T_out, T_in) bool,
    B[o, i] True iff output tile o depends on input tile i."""
    h, w, kk, _ = coords.shape
    dev = coords.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    out_tile = out_grid.tile_of(rows, cols)[..., None, None]
    out_tile = out_tile.expand(h, w, kk, 4)
    in_tile = neighbour_tiles(coords, in_grid)
    b = torch.zeros((out_grid.num_tiles, in_grid.num_tiles),
                    dtype=torch.bool, device=dev)
    b[out_tile.reshape(-1), in_tile.reshape(-1)] = True
    return b


def tdt_standard_conv(in_grid: TileGrid, out_grid: TileGrid,
                      kernel_size: int = 3) -> np.ndarray:
    """TDT of a *standard* convolution (regular sliding window)."""
    r = (kernel_size - 1) // 2
    b = np.zeros((out_grid.num_tiles, in_grid.num_tiles), bool)
    for tr in range(out_grid.rows):
        for tc in range(out_grid.cols):
            o = tr * out_grid.cols + tc
            r_lo = max(tr * out_grid.th - r, 0)
            r_hi = min((tr + 1) * out_grid.th - 1 + r, in_grid.h - 1)
            c_lo = max(tc * out_grid.tw - r, 0)
            c_hi = min((tc + 1) * out_grid.tw - 1 + r, in_grid.w - 1)
            for ir in range(r_lo // in_grid.th, r_hi // in_grid.th + 1):
                for ic in range(c_lo // in_grid.tw, c_hi // in_grid.tw + 1):
                    b[o, ir * in_grid.cols + ic] = True
    return b


def compose_tdt(b_down: np.ndarray, b_up: np.ndarray) -> np.ndarray:
    """Chain two TDTs across a layer boundary:
    C[o, i] = OR_m b_down[o, m] AND b_up[m, i] (boolean matmul)."""
    d = np.asarray(b_down, dtype=bool)
    u = np.asarray(b_up, dtype=bool)
    if d.shape[1] != u.shape[0]:
        raise ValueError(
            f"TDT shapes do not chain: down {d.shape} x up {u.shape}")
    # int32, not uint8: a pair sharing a multiple of 256 intermediate
    # tiles would wrap to 0 and silently drop the dependency.
    return (d.astype(np.int32) @ u.astype(np.int32)) > 0


def compose_tdt_chain(b_layers: list[np.ndarray]) -> np.ndarray:
    """Composite TDT of a layer chain (execution order): last-layer
    output tiles -> first-layer input tiles."""
    if not b_layers:
        raise ValueError("empty layer chain")
    comp = np.asarray(b_layers[-1], bool)
    for b in b_layers[-2::-1]:
        comp = compose_tdt(comp, b)
    return comp


def compose_tdt_chain_device(b_layers: list) -> torch.Tensor:
    """:func:`compose_tdt_chain` as tensor ops on the tables' device, so
    a group's composite TDT flows from the TDT kernel into the greedy
    kernel with no host round trip.

    torch has no integer matmul on CUDA, so the product runs in float32.
    It is exact: entries are 0/1 and a sum counts at most n_mid
    intermediate tiles, far below 2**24 (TF32 would also keep 0/1 and
    accumulates in float32)."""
    if not b_layers:
        raise ValueError("empty layer chain")
    comp = torch.as_tensor(b_layers[-1]) != 0
    for b in b_layers[-2::-1]:
        up = torch.as_tensor(b, device=comp.device) != 0
        if comp.shape[1] != up.shape[0]:
            raise ValueError(
                f"TDT shapes do not chain: down {tuple(comp.shape)} x up "
                f"{tuple(up.shape)}")
        comp = (comp.float() @ up.float()) > 0
    return comp
