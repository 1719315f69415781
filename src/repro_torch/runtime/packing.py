"""Tile packing for the tile-pipeline and graph executors.

The fused kernels (``kernels.dcn_fused``) consume input tiles plus
per-output-pixel ``(idx, coeff)`` tensors whose indices address a packed
buffer — the software analogue of the paper's on-chip input buffer and
address converter (Eq. 4). Two address forms:

* slot-local (per-image ``batched`` and ``per_tile`` dispatch):
  :func:`build_neighbour_tables` decodes each neighbour's (tile, offset)
  once per image on the host, and :func:`pack_output_tile` /
  :func:`pack_schedule_tiles` rewrite them into ``slot(tile) * tp +
  offset`` for a schedule's dep-slot assignment (numpy, like the JAX
  package's packing);
* plane-global (``batch_fused``): :func:`pack_plane_operands` emits
  ``tile_id * tp + offset`` for every tile in plane order; the kernel
  localises them against each dep slot's tile, so the packing never
  depends on a schedule and stays on the tensors' device.

Shapes that do not divide by the tile size are handled by padding the
plane up to ``rows*th x cols*tw``: sampling coordinates are clamped
in-range upstream, so padded pixels are never addressed, and padded
*output* pixels carry ``coeff = 0`` and are discarded on scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


class NeighbourTables(NamedTuple):
    """Per-pixel BLI neighbour data in host memory (one image).

    All arrays are (H, W, KK, 4) over the 4 integer-grid neighbours in the
    order (r0,c0) (r0,c1) (r1,c0) (r1,c1) — matching Eq. 5 / the kernels.
    """

    tile_id: np.ndarray   # int32 input-tile id of each neighbour
    offset: np.ndarray    # int32 raster offset of the neighbour in its tile
    coeff: np.ndarray     # float32 BLI coefficients (eta, theta, mu, gamma)


def build_neighbour_tables(coords: torch.Tensor, grid: TileGrid
                           ) -> NeighbourTables:
    """coords (H, W, KK, 2) float -> host-side neighbour tables, with the
    clipping and coefficient rules of ``core.deform.bilinear_sample``."""
    floor_rc, coeffs = bli_coefficients(coords.detach().cpu())
    floor_rc = floor_rc.numpy()
    r0 = np.clip(floor_rc[..., 0], 0, grid.h - 1)
    c0 = np.clip(floor_rc[..., 1], 0, grid.w - 1)
    r1 = np.clip(r0 + 1, 0, grid.h - 1)
    c1 = np.clip(c0 + 1, 0, grid.w - 1)
    nb_r = np.stack([r0, r0, r1, r1], axis=-1)
    nb_c = np.stack([c0, c1, c0, c1], axis=-1)
    tile_id = (nb_r // grid.th) * grid.cols + (nb_c // grid.tw)
    offset = (nb_r % grid.th) * grid.tw + (nb_c % grid.tw)
    return NeighbourTables(tile_id.astype(np.int32),
                           offset.astype(np.int32),
                           coeffs.numpy().astype(np.float32))


def pack_output_tile(nb: NeighbourTables, grid: TileGrid, out_tile: int,
                     dep_tiles: list[int], p_pad: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's (idx, coeff) operands for one output tile.

    Rewrites each neighbour's (tile_id, offset) into an address in the
    packed buffer that concatenates ``dep_tiles`` in load order: ``slot *
    tile_pixels + offset``. Output pixels beyond the real plane get
    ``coeff = 0`` and address 0. Returns idx (p_pad, KK, 4) int32 and
    coeff (p_pad, KK, 4) float32.
    """
    th, tw, cols = grid.th, grid.tw, grid.cols
    tp = th * tw
    kk = nb.coeff.shape[2]

    slot = np.zeros(grid.num_tiles, np.int32)
    slot[np.asarray(dep_tiles, np.int64)] = np.arange(len(dep_tiles),
                                                      dtype=np.int32)
    tr, tc = divmod(out_tile, cols)
    rr = np.arange(tr * th, (tr + 1) * th)
    cc = np.arange(tc * tw, (tc + 1) * tw)
    valid = (rr[:, None] < grid.h) & (cc[None, :] < grid.w)    # (th, tw)
    rr_c = np.minimum(rr, grid.h - 1)
    cc_c = np.minimum(cc, grid.w - 1)

    t_ids = nb.tile_id[rr_c][:, cc_c]                          # (th,tw,KK,4)
    offs = nb.offset[rr_c][:, cc_c]
    cfs = nb.coeff[rr_c][:, cc_c] * valid[..., None, None]
    # TDT guarantee: every neighbour tile of a real pixel of ``out_tile``
    # is in ``dep_tiles``.
    idx = slot[t_ids] * tp + offs
    idx = np.where(valid[..., None, None], idx, 0).astype(np.int32)

    idx = idx.reshape(tp, kk, 4)
    cfs = cfs.reshape(tp, kk, 4).astype(np.float32)
    if p_pad != tp:
        idx = np.pad(idx, ((0, p_pad - tp), (0, 0), (0, 0)))
        cfs = np.pad(cfs, ((0, p_pad - tp), (0, 0), (0, 0)))
    return idx, cfs


def pack_schedule_tiles(nb: NeighbourTables, grid: TileGrid, out_tiles,
                        dep_lists, p_pad: int, k_pad: int
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """A whole schedule's operands for ``dcn_fused_schedule``: per
    scheduled output tile, :func:`pack_output_tile` over its dep list.

      dep_tbl (T, k_pad) int32  — dep tile ids, zero-padded (the kernel
                                  skips slots >= dep_cnt)
      dep_cnt (T,)       int32  — true dep count; an empty dep list
                                  leaves an all-zero row (bias only)
      idx     (T, p_pad, KK, 4) int32
      coeff   (T, p_pad, KK, 4) float32
    """
    kk = nb.coeff.shape[2]
    t = len(out_tiles)
    dep_tbl = np.zeros((t, k_pad), np.int32)
    dep_cnt = np.zeros((t,), np.int32)
    idx = np.zeros((t, p_pad, kk, 4), np.int32)
    coeff = np.zeros((t, p_pad, kk, 4), np.float32)
    with get_tracer().span("pack.schedule_tiles", tiles=t, k_pad=k_pad):
        for n, (tile, deps) in enumerate(zip(out_tiles, dep_lists)):
            deps = [int(d) for d in deps]
            if len(deps) > k_pad:
                raise ValueError(f"{len(deps)} deps exceed k_pad={k_pad}")
            if not deps:
                continue
            idx[n], coeff[n] = pack_output_tile(nb, grid, int(tile), deps,
                                                p_pad)
            dep_tbl[n, :len(deps)] = deps
            dep_cnt[n] = len(deps)
    return dep_tbl, dep_cnt, idx, coeff


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
