"""Tile packing for the batch-fused executor.

The fused kernel (``kernels.dcn_fused.dcn_fused_batch``) consumes every
image's input tiles ``(N*T_in, tp, C)`` plus per-output-pixel ``(idx,
coeff)`` tensors whose indices are PLANE-GLOBAL packed addresses
``tile_id * tile_pixels + offset`` — the software analogue of the paper's
address converter (Eq. 4). The kernel localises them against each dep
slot's tile, so the packing never depends on a schedule.

Shapes that do not divide by the tile size are handled by padding the
plane up to ``rows*th x cols*tw``: sampling coordinates are clamped
in-range upstream, so padded pixels are never addressed, and padded
*output* pixels carry ``coeff = 0`` and are discarded on scatter.

All functions are tensor ops on the inputs' device; with the device
scheduling backend the whole prepass after the coords digest stays on
the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.deform import bli_coefficients
from repro_torch.core.scheduler import DeviceSchedule
from repro_torch.core.tiles import TileGrid
from repro_torch.obs import get_tracer


def plane_to_tiles(x: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(..., H, W, C) -> (..., num_tiles, th*tw, C), zero-padded to the
    tile grid."""
    *lead, h, w, c = x.shape
    hp, wp = grid.rows * grid.th, grid.cols * grid.tw
    if (hp, wp) != (h, w):
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.reshape(*lead, grid.rows, grid.th, grid.cols, grid.tw, c)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, grid.num_tiles, grid.th * grid.tw, c)


def tiles_to_plane(y_tiles: torch.Tensor, grid: TileGrid, h: int,
                   w: int) -> torch.Tensor:
    """(..., num_tiles, th*tw, C) -> (..., H, W, C): inverse of
    :func:`plane_to_tiles`."""
    *lead, _, _, c = y_tiles.shape
    n = len(lead)
    y = y_tiles.reshape(*lead, grid.rows, grid.cols, grid.th, grid.tw, c)
    y = y.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    y = y.reshape(*lead, grid.rows * grid.th, grid.cols * grid.tw, c)
    return y[..., :h, :w, :]


def pack_plane_operands(coords: torch.Tensor, grid: TileGrid, p_pad: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, coeff) kernel operands for EVERY output tile, in plane order,
    with plane-global packed addresses ``tile_id * tile_pixels + offset``.

    coords: (..., H, W, KK, 2) -> idx int32 / coeff float32, each
    (..., num_tiles, p_pad, KK, 4). Same Eq. 4/5 formulas as the JAX
    package's packing.
    """
    *lead, h, w, kk, _ = coords.shape
    th, tw, rows, cols = grid.th, grid.tw, grid.rows, grid.cols
    tp = th * tw
    dev = coords.device

    floor_rc, coeffs = bli_coefficients(coords)
    r0 = floor_rc[..., 0].clamp(0, grid.h - 1)
    c0 = floor_rc[..., 1].clamp(0, grid.w - 1)
    r1 = (r0 + 1).clamp(0, grid.h - 1)
    c1 = (c0 + 1).clamp(0, grid.w - 1)
    nb_r = torch.stack([r0, r0, r1, r1], dim=-1)           # (..., H,W,KK,4)
    nb_c = torch.stack([c0, c1, c0, c1], dim=-1)
    idx = (((nb_r // th) * cols + nb_c // tw) * tp
           + (nb_r % th) * tw + nb_c % tw)

    # Replicate-pad ragged edges; overhang output pixels carry coeff 0
    # (their contribution is discarded on scatter) and address 0.
    r_idx = torch.arange(rows * th, device=dev).clamp_max(h - 1)
    c_idx = torch.arange(cols * tw, device=dev).clamp_max(w - 1)
    valid = ((torch.arange(rows * th, device=dev) < h)[:, None]
             & (torch.arange(cols * tw, device=dev) < w)[None, :])
    valid = valid[..., None, None]
    idx_p = torch.where(valid, idx[..., r_idx, :, :, :][..., c_idx, :, :],
                        torch.zeros((), dtype=idx.dtype, device=dev))
    cf_p = coeffs[..., r_idx, :, :, :][..., c_idx, :, :] * valid

    def to_tiles(a):
        a = a.reshape(*lead, rows, th, cols, tw, kk, 4)
        n = len(lead)
        a = a.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4, n + 5)
        a = a.reshape(*lead, rows * cols, tp, kk, 4)
        if p_pad != tp:
            a = F.pad(a, (0, 0, 0, 0, 0, p_pad - tp))
        return a

    return (to_tiles(idx_p).to(torch.int32).contiguous(),
            to_tiles(cf_p).to(torch.float32).contiguous())


class BatchDispatch(NamedTuple):
    """Concatenated per-image schedules as batch-fused kernel operands.

    One row per (image, schedule step) slot, images back to back with
    per-image base offsets applied (``img * t_out`` for output rows,
    ``img * t_in`` for dep tiles). Ragged schedule lengths pad to the
    uniform per-image row count with ``oid = -1`` / ``dep_cnt = 0`` slots
    whose dep entries repeat the image's last real dep.
    """

    row_id: torch.Tensor    # (G,) int32 img*t_out + max(oid, 0)
    dep_glb: torch.Tensor   # (G, k_pad) int32 img*t_in + dep (load order)
    dep_cnt: torch.Tensor   # (G,) int32, 0 on padded slots
    oid: torch.Tensor       # (G,) int32 concatenated oids, -1 on padding


def pack_batch_schedules(scheds: list[DeviceSchedule], t_in: int,
                         t_out: int, device) -> BatchDispatch:
    """Concatenate per-image dense schedules into one batch grid on
    ``device``. Device schedules stay on the card end to end; host-built
    schedules (numpy) are uploaded as they are. All images must share the
    tile grid (same row count per image)."""
    if not scheds:
        raise ValueError("empty batch")
    n_rows = scheds[0].n_rows
    if any(s.n_rows != n_rows for s in scheds):
        raise ValueError("per-image schedules disagree on row count — "
                         "images in a batch must share the tile grid")
    k_pad = max(s.k_pad for s in scheds)
    rows, deps, cnts, oids = [], [], [], []

    def dev_i32(a):
        return torch.as_tensor(a, device=device).to(torch.int32)

    with get_tracer().span("pack.batch_schedules", batch=len(scheds),
                           rows=n_rows):
        for i, s in enumerate(scheds):
            oid_i = dev_i32(s.oid).reshape(-1)
            dep_i = dev_i32(s.dep_tbl)
            cnt_i = dev_i32(s.dep_cnt).reshape(-1)
            if dep_i.shape[1] < k_pad:
                dep_i = F.pad(dep_i, (0, k_pad - dep_i.shape[1]))
            valid = oid_i >= 0
            # Padded suffix rows repeat the image's last real dep.
            last_row = (valid.sum() - 1).clamp_min(0)
            last_dep = dep_i[last_row, (cnt_i[last_row] - 1).clamp_min(0)]
            dep_i = torch.where(valid[:, None], dep_i, last_dep)
            rows.append(i * t_out + oid_i.clamp_min(0))
            deps.append(i * t_in + dep_i)
            cnts.append(cnt_i)
            oids.append(oid_i)
        return BatchDispatch(
            row_id=torch.cat(rows).to(torch.int32),
            dep_glb=torch.cat(deps).to(torch.int32).contiguous(),
            dep_cnt=torch.cat(cnts).to(torch.int32),
            oid=torch.cat(oids).to(torch.int32))
