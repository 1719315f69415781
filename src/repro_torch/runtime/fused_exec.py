"""Cross-layer fused network executor (paper §IV-D taken network-wide).

Executes a :class:`~repro_torch.runtime.graph.NetGraph` under the
accelerator's cross-layer dataflow: inside each fused group, boundary
planes between layers carry no *modeled* DRAM traffic — the
:class:`~repro_torch.runtime.trace.NetworkTrace` prices exactly
group-input tile loads (FIFO buffer model), group outputs, weights and
pool/upsample boundary planes, matching
``core.simulator.simulate_network`` byte for byte.

Three dispatch modes (``GraphConfig.dispatch``):

  * ``"batch_fused"`` (the serving engine's) — per segment of the whole
    batch, the stage-1 chain runs batched, per-image composite schedules
    are built in dense dispatch form (cached by quantized coords), and
    ONE dispatch per layer segment runs the whole batch: the batch-fused
    BLI(+)conv kernel for DCN layers, one batched dense conv for standard
    layers. With ``schedule_backend="device"`` the TDTs, the composite
    and Algorithm 1 of all of a group's cache misses run as ONE kernel
    launch (``schedule_group_batch``) whose arrays feed the dispatch
    directly.
    Segment s+1's prepass runs on a staging thread while segment s
    executes.
  * ``"batched"`` — per image: a host prepass (dense stage-1 chain, TDTs,
    one composite Algorithm-1 schedule per group, packed operands), then
    one dispatch per (group, layer segment): the schedule kernel for DCN
    layers, one dense conv over the assembled plane for standard layers.
    Image i+1's prepass overlaps image i's execution. The serving
    engine's degraded step runs this mode.
  * ``"per_tile"`` — per image, the demand-driven loop: each group-output
    tile pulls its producer tiles recursively through a bounded
    recompute-on-evict :class:`TileBuffer` (eviction costs FLOPs, never
    modeled DRAM); one tile-kernel launch or halo conv per produced tile.

All modes execute the same Algorithm-1 schedule, whose group-input load
order is what the trace records and the simulator prices.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.deform import conv2d, deformable_conv2d, \
    offsets_to_coords
from repro_torch.core.scheduler import (DeviceSchedule, TileSchedule,
                                        pow2_pad, schedule_tiles,
                                        sequential_schedule)
from repro_torch.core.tiles import (TileGrid, compose_tdt_chain,
                                    tdt_from_coords, tdt_standard_conv)
from repro_torch.kernels.dcn_fused import (dcn_fused_batch,
                                           dcn_fused_batch_sharded,
                                           dcn_fused_schedule,
                                           dcn_fused_tile)
from repro_torch.kernels.dcn_schedule import (schedule_group_batch,
                                              tdt_dispatch_arrays,
                                              tdt_from_coords_device)
from repro_torch.obs import Tracer, get_tracer, use_tracer
from repro_torch.runtime.cache import (ScheduleCache, chain_digest,
                                       conv_digest, coords_digest,
                                       default_schedule_cache)
from repro_torch.runtime.graph import (DeformNode, FusedGroup, NetGraph,
                                       PoolNode, Segment, UpsampleNode,
                                       boundary_bytes, group_weight_bytes,
                                       partition_graph_cached)
from repro_torch.runtime.packing import (build_neighbour_tables,
                                         pack_batch_schedules,
                                         pack_output_tile,
                                         pack_plane_operands,
                                         pack_schedule_tiles, plane_to_tiles,
                                         tiles_to_plane)
from repro_torch.runtime.pipeline import (schedule_cache_key, run_staged,
                                          validate_dispatch_config)
from repro_torch.runtime.shard import (ShardPlan, allgather_nbytes,
                                       plan_batch_shards, resolve_shard_mesh,
                                       scatter_shard_rows,
                                       shard_batch_schedules, stack_rows)
from repro_torch.runtime.trace import (GroupTrace, LayerBufferStats,
                                       NetworkTrace, TileRecord)

ONCHIP_BUDGET_BYTES = (128 + 256) * 1024   # paper Table I: input + output buf


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Network-graph executor knobs."""

    tile: int | tuple[int, int] = 8       # tile side(s), shared per group
    buffer_tiles: int | None = None       # M for the composite schedule
    # Intermediate tile-buffer capacity per layer plane (per_tile dispatch).
    # None = derive from onchip_budget_bytes (budget split across the
    # group's layers); an int pins it, and undersizing only costs
    # recomputes, never correctness.
    inter_buffer_tiles: int | None = None
    schedule: str = "alg1"                # "alg1" | "sequential"
    block_p: int = 128                    # pixel block: pads P to a multiple
    onchip_budget_bytes: int = ONCHIP_BUDGET_BYTES  # drives group planning
    use_schedule_cache: bool = True
    # "batch_fused" (default here, the serving path): the concatenated
    #   schedules of all batch images as one kernel grid per layer segment.
    # "batched": one schedule launch per (group, layer segment) PER IMAGE.
    # "per_tile": the demand-driven per-tile dispatch loop.
    dispatch: str = "batch_fused"
    # "host": TDT scatter + Algorithm-1 loop on the host (numpy).
    # "device": both as CUDA kernels, bit-exact vs the host path.
    schedule_backend: str = "host"
    # Units staged ahead of execution (segments for batch_fused, images
    # otherwise): 1 = serial, 2 = prepass unit i+1 on a worker thread
    # while unit i executes.
    staging_depth: int = 2
    # Staging-worker watchdog deadline (seconds); None = wait forever. A
    # staged prepass that misses it triggers failover to synchronous
    # prepass for the rest of the run (see pipeline.run_staged).
    watchdog_s: float | None = None
    # Batch-axis scale-out (batch_fused only): a
    # repro_torch.launch.mesh.DeviceMesh, or data_parallel=D (a mesh over
    # the first D CUDA devices, built at run time). Each mesh device runs
    # the concatenated schedules of its local images; one process drives
    # every device, and the logits gather once on the caller's device.
    mesh: Any = None
    data_parallel: int | None = None
    # Simulator-guided plan autotuning (repro_torch.tuning): "off" =
    # greedy partition at the default tile; "offline" = search (once per
    # plan key, cached) for the best cuts + per-group tile shapes;
    # "cached-only" = use a cached plan if present, never search (for
    # replicas that must not pay search latency).
    autotune: str = "off"
    # Directory for the persistent TunedPlan store; None = in-memory
    # only (the plan still survives across engines in this process).
    plan_cache_dir: str | None = None
    # Max simulator evaluations the search may pay per plan.
    autotune_budget: int = 128
    # Fault injector (repro_torch.testing.FaultInjector) — tests only,
    # excluded from config equality.
    faults: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        validate_dispatch_config(self)

    @property
    def tile_hw(self) -> tuple[int, int]:
        t = self.tile
        th, tw = (t, t) if isinstance(t, int) else (int(t[0]), int(t[1]))
        if th < 1 or tw < 1:
            raise ValueError(f"tile sides must be >= 1, got {(th, tw)}")
        return th, tw


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def apply_layer_dense(plane: torch.Tensor, node, p,
                      max_displacement: float | None = None) -> torch.Tensor:
    """Dense reference for one layer node on a (H, W, C) plane."""
    if isinstance(node, DeformNode):
        y = deformable_conv2d(plane[None], p, node.kernel_size, node.variant,
                              max_displacement)[0]
    else:
        y = conv2d(plane[None], p["w"], p["b"])[0]
    return torch.relu(y) if node.relu else y


def apply_boundary_batch(planes: torch.Tensor, node: Segment
                         ) -> torch.Tensor:
    """Pool/upsample between groups on (N, H, W, C) planes."""
    if isinstance(node, PoolNode):
        k = node.window
        y = F.max_pool2d(planes.permute(0, 3, 1, 2), k, k)
        return y.permute(0, 2, 3, 1).contiguous()
    f = node.factor
    return planes.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)


def apply_boundary_dense(plane: torch.Tensor, node: Segment) -> torch.Tensor:
    """Pool/upsample on one (H, W, C) plane."""
    return apply_boundary_batch(plane[None], node)[0]


def run_graph_dense(convs: list, graph: NetGraph, x: torch.Tensor,
                    max_displacement: float | None = None) -> torch.Tensor:
    """Dense execution of the whole graph, image by image — the numerics
    oracle of the tiled executor."""
    outs = []
    for i in range(x.shape[0]):
        plane = x[i]
        for node in graph.nodes:
            if isinstance(node, (PoolNode, UpsampleNode)):
                plane = apply_boundary_dense(plane, node)
            else:
                plane = apply_layer_dense(plane, node, convs[node.param_idx],
                                          max_displacement)
        outs.append(plane)
    return torch.stack(outs)


def _advance_dense_batch(planes: torch.Tensor, node, p,
                         max_displacement: float | None) -> torch.Tensor:
    """Batched stage-1 chain advance (one dense op for all images)."""
    if isinstance(node, DeformNode):
        y = deformable_conv2d(planes, p, node.kernel_size, node.variant,
                              max_displacement)
    else:
        y = conv2d(planes, p["w"], p["b"])
    return torch.relu(y) if node.relu else y


def _segment_grid(seg: FusedGroup, th: int, tw: int) -> TileGrid:
    """Tile grid of one fused group: the group's autotuned tile shape
    when the plan set one, the config default otherwise — either way
    clamped to the group's plane (interior groups sit at lower
    resolution than the input)."""
    if seg.tile_hw is not None:
        th, tw = seg.tile_hw
    return TileGrid(seg.h, seg.w, min(th, seg.h), min(tw, seg.w))


def _valid_masks(grid: TileGrid, dtype, device) -> torch.Tensor:
    """(T, tp, 1): 1 inside the real H x W plane, 0 on tile padding."""
    rr = torch.arange(grid.rows * grid.th, device=device) < grid.h
    cc = torch.arange(grid.cols * grid.tw, device=device) < grid.w
    valid = (rr[:, None] & cc[None, :])[..., None].to(dtype)
    return plane_to_tiles(valid, grid).contiguous()


class TileBuffer:
    """Bounded on-chip store for one intermediate plane's output tiles.

    FIFO eviction like the paper's input buffer; a miss on a previously
    produced tile means recompute (fusion forbids the DRAM round trip).
    Used by the ``per_tile`` dispatch mode.
    """

    def __init__(self, capacity_tiles: int):
        if capacity_tiles < 1:
            raise ValueError("tile buffer capacity must be >= 1 tile")
        self.capacity = int(capacity_tiles)
        self._tiles: dict[int, Any] = {}
        self._queue: list[int] = []
        self._ever: set[int] = set()
        self.computes = 0
        self.recomputes = 0
        self.resident_bytes = 0
        self.max_resident_bytes = 0

    def get(self, tile: int):
        return self._tiles.get(tile)

    def put(self, tile: int, value, nbytes: int) -> None:
        self.computes += 1
        if tile in self._ever:
            self.recomputes += 1
        self._ever.add(tile)
        if tile not in self._tiles:
            self._queue.append(tile)
        self._tiles[tile] = value
        self.resident_bytes += nbytes
        while len(self._queue) > self.capacity:
            evicted = self._queue.pop(0)
            self._tiles.pop(evicted, None)
            self.resident_bytes -= nbytes  # uniform tile size per plane
        self.max_resident_bytes = max(self.max_resident_bytes,
                                      self.resident_bytes)


def _inter_capacity(cfg: GraphConfig, group: FusedGroup, node, tp: int,
                    dtype_bytes: int) -> int:
    """Tile-buffer capacity for one layer plane: an even split of the
    on-chip budget across the group's layers, in that plane's tile size."""
    if cfg.inter_buffer_tiles is not None:
        return cfg.inter_buffer_tiles
    per_layer = cfg.onchip_budget_bytes // max(1, group.n_layers)
    return max(1, per_layer // (tp * node.c_out * dtype_bytes))


def _assemble_halo(dep_arrays: list, deps: np.ndarray, grid: TileGrid,
                   out_tile: int, r: int, c: int) -> torch.Tensor:
    """Paste dependent tiles into the (th+2r, tw+2r, C) halo window of
    ``out_tile``. Positions no tile covers stay zero — the SAME-conv zero
    padding, because produced tiles are masked beyond the real plane."""
    th, tw = grid.th, grid.tw
    tr, tc = divmod(out_tile, grid.cols)
    r_lo, c_lo = tr * th - r, tc * tw - r
    win = torch.zeros((th + 2 * r, tw + 2 * r, c), dtype=dep_arrays[0].dtype,
                      device=dep_arrays[0].device)
    for d, arr in zip(deps, dep_arrays):
        dr, dc = divmod(int(d), grid.cols)
        a0, a1 = max(dr * th, r_lo), min((dr + 1) * th, r_lo + th + 2 * r)
        b0, b1 = max(dc * tw, c_lo), min((dc + 1) * tw, c_lo + tw + 2 * r)
        if a1 <= a0 or b1 <= b0:
            continue
        win[a0 - r_lo:a1 - r_lo, b0 - c_lo:b1 - c_lo] = arr.reshape(
            th, tw, c)[a0 - dr * th:a1 - dr * th, b0 - dc * tw:b1 - dc * tw]
    return win


@dataclasses.dataclass
class _LayerDispatch:
    """One DCN layer's schedule-launch operands, packed in the prepass."""

    out_order: np.ndarray                 # (T,) grid order of output tiles
    dep_tbl: np.ndarray                   # (T, k_pad) dep table
    dep_cnt: np.ndarray                   # (T,) true dep count per tile
    idx: np.ndarray                       # (T, p_pad, KK, 4)
    coeff: np.ndarray                     # (T, p_pad, KK, 4)


@dataclasses.dataclass
class _GroupArtifacts:
    """Prepass products for one fused group of one image."""

    grid: TileGrid
    m: int                                # schedule buffer capacity
    b_layers: list[np.ndarray]            # per-layer TDTs
    nbs: list                             # per-layer NeighbourTables | None
    sched: TileSchedule                   # composite Algorithm-1 schedule
    cache_hit: bool | None
    schedule_s: float = 0.0
    schedule_device_s: float = 0.0
    # batched dispatch only: per-layer packed operands (None for conv
    # layers), packed on the staging thread.
    packed: list[_LayerDispatch | None] | None = None


def _group_schedule_artifacts(
    x_g: torch.Tensor,                    # (H, W, C) dense chain state
    group: FusedGroup,
    convs: list,
    grid: TileGrid,
    m: int,
    cfg: GraphConfig,
    max_displacement: float | None,
    cache: ScheduleCache | None,
    need_out_plane: bool,
    tracer: Tracer | None = None,
) -> tuple[_GroupArtifacts, torch.Tensor]:
    """Prepass for one group of one image: per-layer TDTs + neighbour
    tables + composite schedule (cached under the quantized-coords chain
    digest), the batched operands, and the group's dense output plane
    when ``need_out_plane`` (a later group still holds a DeformNode whose
    offset conv consumes it)."""
    tr = tracer if tracer is not None else get_tracer()
    needs_plane = [need_out_plane
                   or any(isinstance(nd, DeformNode)
                          for nd in group.nodes[j + 1:])
                   for j in range(group.n_layers)]
    plane = x_g
    nbs: list = []
    digests: list[str] = []
    dcn_coords: list = []
    for j, node in enumerate(group.nodes):
        p = convs[node.param_idx]
        if isinstance(node, DeformNode):
            offsets = conv2d(plane[None], p.w_off, p.b_off)
            coords = offsets_to_coords(offsets.float(), node.kernel_size,
                                       node.variant, max_displacement)[0]
            nbs.append(build_neighbour_tables(coords, grid))
            digests.append(coords_digest(coords, grid))
            dcn_coords.append(coords)
        else:
            nbs.append(None)
            digests.append(conv_digest(node.kernel_size, grid))
            dcn_coords.append(None)
        if needs_plane[j]:
            plane = apply_layer_dense(plane, node, p, max_displacement)

    def build():
        device = cfg.schedule_backend == "device"
        b_layers = []
        with tr.span("prepass.tdt", backend=cfg.schedule_backend,
                     layers=group.n_layers):
            for node, coords in zip(group.nodes, dcn_coords):
                if coords is None:
                    b_layers.append(tdt_standard_conv(grid, grid,
                                                      node.kernel_size))
                elif device:
                    b_layers.append(tdt_from_coords_device(
                        coords, grid, grid).cpu().numpy())
                else:
                    b_layers.append(tdt_from_coords(coords.cpu(), grid,
                                                    grid).numpy())
        comp = compose_tdt_chain(b_layers)
        if cfg.schedule == "alg1":
            sched = schedule_tiles(comp, m, backend=cfg.schedule_backend,
                                   device=x_g.device)
        else:
            sched = sequential_schedule(comp)
        return b_layers, sched

    with tr.timed("prepass.schedule", backend=cfg.schedule_backend) as ssp:
        if cache is None:
            b_layers, sched = build()
            hit = None
        else:
            key = schedule_cache_key(chain_digest(digests, grid), grid, m,
                                     cfg)
            (b_layers, sched), hit = cache.get_or_build(key, build)
        ssp.set(cached=hit)
    schedule_s = ssp.dur

    # The schedule cache cannot cover the packing: idx follows the
    # quantized coords (the key) but the coefficients keep the fractions.
    packed: list[_LayerDispatch | None] | None = None
    if cfg.dispatch == "batched":
        tp = grid.th * grid.tw
        bp = min(cfg.block_p, tp)
        p_pad = tp if tp % bp == 0 else _round_up(tp, cfg.block_p)
        oid_arr = np.asarray(sched.oid, np.int32)
        last = group.n_layers - 1
        packed = []
        with tr.span("pack", dispatch="batched", layers=group.n_layers):
            for j, node in enumerate(group.nodes):
                if not isinstance(node, DeformNode):
                    packed.append(None)
                    continue
                # Grid order: the Algorithm-1 schedule for the group's
                # output layer; plane order for interior layers (their
                # tiles never touch DRAM, so order is free).
                out_order = (oid_arr if j == last
                             else np.arange(grid.num_tiles, dtype=np.int32))
                dep_lists = [np.flatnonzero(b_layers[j][t])
                             for t in out_order]
                k_pad = pow2_pad(max((len(d) for d in dep_lists),
                                     default=1))
                dep_tbl, dep_cnt, idx, coeff = pack_schedule_tiles(
                    nbs[j], grid, out_order, dep_lists, p_pad, k_pad)
                packed.append(_LayerDispatch(out_order, dep_tbl, dep_cnt,
                                             idx, coeff))

    art = _GroupArtifacts(
        grid=grid, m=m, b_layers=list(b_layers), nbs=nbs, sched=sched,
        cache_hit=hit, packed=packed, schedule_s=schedule_s,
        schedule_device_s=(schedule_s if cfg.schedule_backend == "device"
                           else 0.0))
    return art, plane


def _deform_after(segments: list[Segment]) -> list[bool]:
    """Per segment: does a LATER segment still hold a DeformNode (so the
    dense stage-1 chain must keep advancing past this one)?"""
    out = [False] * len(segments)
    seen = False
    for s in range(len(segments) - 1, -1, -1):
        out[s] = seen
        if isinstance(segments[s], FusedGroup) and any(
                isinstance(nd, DeformNode) for nd in segments[s].nodes):
            seen = True
    return out


def _image_prepass(x_i: torch.Tensor, segments: list[Segment], convs: list,
                   cfg: GraphConfig, max_displacement: float | None,
                   cache: ScheduleCache | None,
                   tracer: Tracer | None = None
                   ) -> list[_GroupArtifacts | None]:
    """Prepass of one whole image: the dense stage-1 chain runs ahead
    through the segments as far as the last DeformNode's offset conv
    needs it, emitting per-group schedule artifacts."""
    th, tw = cfg.tile_hw
    deform_after = _deform_after(segments)
    arts: list[_GroupArtifacts | None] = []
    plane = x_i
    for s, seg in enumerate(segments):
        if isinstance(seg, (PoolNode, UpsampleNode)):
            if deform_after[s]:
                plane = apply_boundary_dense(plane, seg)
            arts.append(None)
        else:
            grid = _segment_grid(seg, th, tw)
            m = (grid.num_tiles if cfg.buffer_tiles is None
                 else cfg.buffer_tiles)
            art, plane = _group_schedule_artifacts(
                plane, seg, convs, grid, m, cfg, max_displacement, cache,
                need_out_plane=deform_after[s], tracer=tracer)
            arts.append(art)
    return arts


def _exec_group_per_tile(x_tiles: torch.Tensor, group: FusedGroup,
                         convs: list, cfg: GraphConfig, art: _GroupArtifacts,
                         masks: torch.Tensor, dtype_bytes: int
                         ) -> tuple[torch.Tensor, list[LayerBufferStats],
                                    int]:
    """Demand-driven loop: one launch per produced tile, intermediates in
    bounded recompute-on-evict TileBuffers."""
    grid, b_layers, nbs, sched = art.grid, art.b_layers, art.nbs, art.sched
    dev = x_tiles.device
    tp = grid.th * grid.tw
    bp = min(cfg.block_p, tp)
    p_pad = tp if tp % bp == 0 else _round_up(tp, cfg.block_p)
    k_pad = [pow2_pad(int(b.sum(axis=1).max())) for b in b_layers]
    buffers = [TileBuffer(_inter_capacity(cfg, group, nd, tp, dtype_bytes))
               for nd in group.nodes]

    def produce(j: int, t: int) -> torch.Tensor:
        if j < 0:
            return x_tiles[t]
        cached = buffers[j].get(t)
        if cached is not None:
            return cached
        node = group.nodes[j]
        deps = np.flatnonzero(b_layers[j][t])
        dep_arrays = [produce(j - 1, int(d)) for d in deps]
        p = convs[node.param_idx]
        if isinstance(node, DeformNode):
            idx, coeff = pack_output_tile(nbs[j], grid, t, deps.tolist(),
                                          p_pad)
            x_packed = torch.zeros((k_pad[j], tp, node.c_in),
                                   dtype=x_tiles.dtype, device=dev)
            x_packed[:len(deps)] = torch.stack(dep_arrays)
            kk = node.kernel_size ** 2
            y = dcn_fused_tile(
                x_packed.reshape(k_pad[j] * tp, node.c_in),
                torch.as_tensor(idx, device=dev),
                torch.as_tensor(coeff, device=dev),
                p.w.reshape(kk, node.c_in, node.c_out), p.b,
                block_p=cfg.block_p)[:tp]
        else:
            r = (node.kernel_size - 1) // 2
            win = _assemble_halo(dep_arrays, deps, grid, t, r, node.c_in)
            y = conv2d(win[None], p["w"], p["b"], padding="VALID")[0]
            y = y.reshape(tp, node.c_out)
        if node.relu:
            y = torch.relu(y)
        y = y * masks[t]    # zero padded-plane pixels: halo reads see zeros
        buffers[j].put(t, y, tp * node.c_out * dtype_bytes)
        return y

    last = group.n_layers - 1
    out = torch.zeros((grid.num_tiles, tp, group.c_out), dtype=x_tiles.dtype,
                      device=dev)
    for out_tile in sched.oid:
        out[out_tile] = produce(last, out_tile)
    stats = [LayerBufferStats(kind=nd.kind, tiles_computed=b.computes,
                              recomputes=b.recomputes,
                              max_resident_bytes=b.max_resident_bytes)
             for nd, b in zip(group.nodes, buffers)]
    return out, stats, sum(b.computes for b in buffers)


def _exec_group_batched(x_tiles: torch.Tensor, group: FusedGroup,
                        convs: list, cfg: GraphConfig, art: _GroupArtifacts,
                        masks: torch.Tensor, dtype_bytes: int
                        ) -> tuple[torch.Tensor, list[LayerBufferStats],
                                   int]:
    """One launch per layer segment: DCN layers run the whole tile
    schedule through the schedule kernel (operands packed in the
    prepass), conv layers as one dense conv over the assembled plane;
    outputs scatter back to tile order in one op."""
    grid = art.grid
    dev = x_tiles.device
    h, w = grid.h, grid.w
    tp = grid.th * grid.tw
    num = grid.num_tiles
    last = group.n_layers - 1

    def up(a):
        return torch.as_tensor(a, device=dev)

    tiles = x_tiles
    stats: list[LayerBufferStats] = []
    for j, node in enumerate(group.nodes):
        p = convs[node.param_idx]
        if isinstance(node, DeformNode):
            ld = art.packed[j]
            kk = node.kernel_size ** 2
            y = dcn_fused_schedule(
                tiles.contiguous(), up(ld.dep_tbl), up(ld.dep_cnt),
                up(ld.idx), up(ld.coeff),
                p.w.reshape(kk, node.c_in, node.c_out), p.b,
                block_p=cfg.block_p)[:, :tp]
            if node.relu:
                y = torch.relu(y)
            order = up(ld.out_order.astype(np.int64))
            y = y * masks[order]
            if j == last:
                tiles = torch.zeros((num, tp, node.c_out), dtype=y.dtype,
                                    device=dev)
                tiles[order] = y
            else:
                tiles = y
            computed = len(ld.out_order)
        else:
            plane = tiles_to_plane(tiles, grid, h, w)
            yp = conv2d(plane[None].contiguous(), p["w"], p["b"])[0]
            if node.relu:
                yp = torch.relu(yp)
            tiles = plane_to_tiles(yp, grid)
            computed = num
        stats.append(LayerBufferStats(
            kind=node.kind, tiles_computed=computed, recomputes=0,
            max_resident_bytes=num * tp * node.c_out * dtype_bytes))
    return tiles, stats, group.n_layers


def _run_group(x_g: torch.Tensor, group: FusedGroup, convs: list,
               cfg: GraphConfig, art: _GroupArtifacts
               ) -> tuple[torch.Tensor, GroupTrace]:
    h, w, c_in = x_g.shape
    grid, sched = art.grid, art.sched
    tp = grid.th * grid.tw
    dtype_bytes = x_g.element_size()
    masks = _valid_masks(grid, x_g.dtype, x_g.device)       # (T, tp, 1)
    exec_fn = (_exec_group_batched if cfg.dispatch == "batched"
               else _exec_group_per_tile)
    y_tiles, layer_stats, dispatches = exec_fn(
        plane_to_tiles(x_g, grid), group, convs, cfg, art, masks,
        dtype_bytes)

    tile_bytes = tp * c_in * dtype_bytes
    trace = GroupTrace(
        grid=grid, tile_bytes=tile_bytes, buffer_tiles=art.m,
        schedule=cfg.schedule, schedule_cache_hit=art.cache_hit,
        schedule_backend=cfg.schedule_backend, dtype_bytes=dtype_bytes,
        layer_channels=group.layer_channels,
        output_bytes=h * w * group.c_out * dtype_bytes,
        weight_bytes=group_weight_bytes(group, dtype_bytes),
        b_layers=list(art.b_layers), kernel_dispatches=dispatches,
        dispatch=cfg.dispatch)
    trace.layer_stats = layer_stats
    for out_tile, loads in zip(sched.oid, sched.iid):
        trace.records.append(TileRecord(
            out_tile=out_tile, dep_tiles=tuple(loads),
            loaded_bytes=len(loads) * tile_bytes,
            buffer_bytes=len(loads) * tile_bytes))
    return tiles_to_plane(y_tiles, grid, h, w).contiguous(), trace


@dataclasses.dataclass
class _ImageGroupSched:
    """One image's schedule bundle for one fused group, in dense dispatch
    form (the schedule-cache value)."""

    b_layers: list                        # per-layer TDTs (tensor or np)
    exec_scheds: list                     # per-layer DeviceSchedule | None:
    #   interior DCN layers dispatch in plane order over their own TDT
    #   rows; the LAST layer dispatches in the composite Algorithm-1
    #   order (its dep rows still come from its own TDT — the composite
    #   iid is the group-input load order the trace records).
    ds: DeviceSchedule                    # composite schedule (records)


@dataclasses.dataclass
class _BatchLayerOps:
    """One DCN layer's batch-fused operands (whole batch; shard-stacked
    when a plan shards the batch)."""

    batch: Any                            # packing.BatchDispatch | None
    idx: torch.Tensor                     # (N*T, p_pad, KK, 4) int32, or
    coeff: torch.Tensor                   #   (D, n_max*T, ...) per shard
    shard: Any = None                     # shard.ShardedDispatch | None


@dataclasses.dataclass
class _BatchGroupArtifacts:
    """Prepass products of one fused group for the WHOLE batch."""

    grid: TileGrid
    m: int
    bundles: list[_ImageGroupSched]
    cache_hits: list[bool | None]
    layer_ops: list[_BatchLayerOps | None]
    schedule_s: float = 0.0
    schedule_device_s: float = 0.0


def _group_batch_prepass(
    planes: torch.Tensor,                 # (N, H, W, C) dense chain state
    group: FusedGroup,
    convs: list,
    grid: TileGrid,
    m: int,
    cfg: GraphConfig,
    max_displacement: float | None,
    cache: ScheduleCache | None,
    need_out_plane: bool,
    tracer: Tracer | None = None,
    plan: ShardPlan | None = None,
) -> tuple[_BatchGroupArtifacts, torch.Tensor]:
    """Batch-level prepass for one group: the stage-1 chain runs batched,
    per-image composite schedules are built in dense form (cached —
    partial batch hits skip scheduling for the hit images), and the
    per-layer operands are concatenated with per-image base offsets (per
    shard, with a shard ``plan``: each shard keeps its own padding)."""
    tr = tracer if tracer is not None else get_tracer()
    n = planes.shape[0]
    dev = planes.device
    device = cfg.schedule_backend == "device" and cfg.schedule == "alg1"
    t_out = grid.num_tiles
    k_pad = pow2_pad(t_out)
    tp = grid.th * grid.tw
    bp = min(cfg.block_p, tp)
    p_pad = tp if tp % bp == 0 else _round_up(tp, cfg.block_p)
    last = group.n_layers - 1

    needs_plane = [need_out_plane
                   or any(isinstance(nd, DeformNode)
                          for nd in group.nodes[j + 1:])
                   for j in range(group.n_layers)]
    plane = planes
    coords_layers: list = []
    for j, node in enumerate(group.nodes):
        p = convs[node.param_idx]
        if isinstance(node, DeformNode):
            offsets = conv2d(plane, p.w_off, p.b_off)
            coords_layers.append(offsets_to_coords(
                offsets.float(), node.kernel_size, node.variant,
                max_displacement).contiguous())
        else:
            coords_layers.append(None)
        if needs_plane[j]:
            plane = _advance_dense_batch(plane, node, p, max_displacement)

    def host_bundle(i: int) -> _ImageGroupSched:
        b_layers: list = []
        with tr.span("prepass.tdt", backend=cfg.schedule_backend, image=i):
            for j, node in enumerate(group.nodes):
                if coords_layers[j] is None:
                    b_layers.append(tdt_standard_conv(grid, grid,
                                                      node.kernel_size))
                else:
                    b_layers.append(tdt_from_coords(
                        coords_layers[j][i].cpu(), grid, grid).numpy())
        comp = compose_tdt_chain(b_layers)
        if cfg.schedule == "alg1":
            sched = schedule_tiles(comp, m)
        else:
            sched = sequential_schedule(comp)
        ds = DeviceSchedule.from_host(sched, t_out)
        exec_scheds: list = []
        for j, node in enumerate(group.nodes):
            if not isinstance(node, DeformNode):
                exec_scheds.append(None)
                continue
            dep_j, cnt_j = tdt_dispatch_arrays(
                torch.as_tensor(b_layers[j], device=dev), k_pad)
            if j == last:
                oid = torch.as_tensor(ds.oid, device=dev).reshape(-1)
                sel = oid.clamp_min(0).long()
                exec_scheds.append(DeviceSchedule(
                    oid, dep_j[sel],
                    torch.where(oid >= 0, cnt_j[sel],
                                torch.zeros_like(cnt_j[sel])),
                    torch.zeros_like(oid)))
            else:
                ar = torch.arange(t_out, dtype=torch.int32, device=dev)
                exec_scheds.append(DeviceSchedule(
                    ar, dep_j, cnt_j, torch.zeros_like(ar)))
        return _ImageGroupSched(b_layers, exec_scheds, ds)

    def device_bundles(images: list[int]) -> list[_ImageGroupSched]:
        """ONE scheduling launch for every listed image of the group."""
        with tr.span("prepass.tdt", backend=cfg.schedule_backend,
                     images=len(images)):
            out = schedule_group_batch(
                [node.kernel_size if c is None else c
                 for node, c in zip(group.nodes, coords_layers)],
                images, grid, m, k_pad, device=dev)
        bundles = []
        for k in range(len(images)):
            im = out.image(k, own=len(images) > 1)
            bundles.append(_ImageGroupSched(
                im.tdt,
                [DeviceSchedule(*e) if e is not None else None
                 for e in im.exec],
                DeviceSchedule(im.oid, im.dep_tbl, im.dep_cnt, im.overlap)))
        return bundles

    # Cache keys from one host copy of each DCN layer's coordinates.
    keys: list = [None] * n
    if cache is not None:
        host = [None if c is None else c.cpu().numpy()
                for c in coords_layers]
        digests = [[conv_digest(node.kernel_size, grid) if h is None
                    else coords_digest(h[i], grid)
                    for node, h in zip(group.nodes, host)]
                   for i in range(n)]

    bundles: list = [None] * n
    hits: list = [None] * n
    with tr.timed("prepass.schedule", backend=cfg.schedule_backend,
                  batch=n) as ssp:
        # Device backend: misses are resolved first and built together;
        # a repeat of a miss counts as the hit get_or_build would see.
        first: dict = {}                  # key -> the image building it
        for i in range(n):
            if cfg.faults is not None:
                cfg.faults.check("prepass", image=i)
            if cache is None:
                if device:
                    first[i] = i
                else:
                    bundles[i] = host_bundle(i)
                continue
            keys[i] = schedule_cache_key(chain_digest(digests[i], grid),
                                         grid, m, cfg, "dense")
            if not device:
                bundles[i], hits[i] = cache.get_or_build(
                    keys[i], lambda i=i: host_bundle(i))
            elif keys[i] in first:
                cache.note_repeat()
                hits[i] = True
            else:
                bundles[i] = cache.get(keys[i])
                hits[i] = bundles[i] is not None
                if not hits[i]:
                    first[keys[i]] = i
        if first:
            for (key, i), bundle in zip(first.items(),
                                        device_bundles(list(first.values()))):
                bundles[i] = bundle
                if cache is not None:
                    cache.put(key, bundle)
            for i in range(n):
                if bundles[i] is None:
                    bundles[i] = bundles[first[keys[i]]]
        ssp.set(hits=sum(bool(h) for h in hits))
    schedule_s = ssp.dur
    if cache is not None:
        cache.note_batch_assembly(sum(bool(h) for h in hits),
                                  images=len(hits))

    layer_ops: list[_BatchLayerOps | None] = []
    with tr.span("pack", dispatch="batch_fused", batch=n,
                 layers=group.n_layers):
        for j, node in enumerate(group.nodes):
            if not isinstance(node, DeformNode):
                layer_ops.append(None)
                continue
            kk = node.kernel_size ** 2
            idx, coeff = pack_plane_operands(coords_layers[j], grid, p_pad)
            idx = idx.reshape(n * t_out, p_pad, kk, 4)
            coeff = coeff.reshape(n * t_out, p_pad, kk, 4)
            scheds = [bundles[i].exec_scheds[j] for i in range(n)]
            if plan is None:
                layer_ops.append(_BatchLayerOps(
                    pack_batch_schedules(scheds, t_out, t_out, dev), idx,
                    coeff))
            else:
                layer_ops.append(_BatchLayerOps(
                    None, stack_rows(idx, plan, t_out),
                    stack_rows(coeff, plan, t_out),
                    shard=shard_batch_schedules(scheds, t_out, t_out, plan,
                                                dev)))

    art = _BatchGroupArtifacts(
        grid=grid, m=m, bundles=bundles, cache_hits=hits,
        layer_ops=layer_ops, schedule_s=schedule_s,
        schedule_device_s=schedule_s if device else 0.0)
    return art, plane


def _exec_group_batch_fused(planes: torch.Tensor, group: FusedGroup,
                            convs: list, cfg: GraphConfig,
                            art: _BatchGroupArtifacts, mesh=None,
                            plan: ShardPlan | None = None
                            ) -> tuple[torch.Tensor, int]:
    """Execute one fused group for the whole batch: ONE dispatch per
    layer segment (the batch-fused kernel for DCN layers, one batched
    dense conv for standard layers). With ``mesh``/``plan`` each DCN
    segment stacks its tile rows into per-shard slabs, runs the kernel
    once per shard on the shard's device, and scatters and unstacks the
    result; conv segments and plane assembly run on the TRUE batch on
    the caller's device with the single-device shapes, so the sharded
    result is bitwise the unsharded one."""
    n = planes.shape[0]
    if cfg.faults is not None:
        cfg.faults.check("dispatch", images=plan.n if plan else n)
    grid = art.grid
    h, w = grid.h, grid.w
    tp = grid.th * grid.tw
    t = grid.num_tiles
    last = group.n_layers - 1
    masks = None
    if any(isinstance(nd, DeformNode) for nd in group.nodes):
        masks = _valid_masks(grid, planes.dtype, planes.device)

    flat = plane_to_tiles(planes, grid).reshape(n * t, tp, -1).contiguous()
    dispatches = 0
    for j, node in enumerate(group.nodes):
        p = convs[node.param_idx]
        if isinstance(node, DeformNode):
            ops = art.layer_ops[j]
            kk = node.kernel_size ** 2
            w2 = p.w.reshape(kk, node.c_in, node.c_out)
            if plan is not None:
                sh = ops.shard
                y = dcn_fused_batch_sharded(
                    stack_rows(flat, plan, t), sh.row_id, sh.dep_glb,
                    sh.dep_cnt, ops.idx, ops.coeff, w2, p.b, mesh=mesh,
                    t_in=t, sizes=plan.sizes)[:, :, :tp]
                oid = sh.oid
            else:
                y = dcn_fused_batch(
                    flat, ops.batch.row_id, ops.batch.dep_glb,
                    ops.batch.dep_cnt, ops.idx, ops.coeff, w2, p.b,
                    t_in=t)[:, :tp]
                oid = ops.batch.oid
            if node.relu:
                y = torch.relu(y)
            y = y * masks[oid.clamp_min(0).long()]
            if plan is not None:
                # Shard rows back to (image, tile) order, per shard.
                flat = scatter_shard_rows(y, sh, plan, t).contiguous()
            elif j == last:
                # Scatter scheduled rows back to (image, tile) order;
                # ragged-padding rows all land in a dropped dump row, so
                # their duplicate indices never touch a kept row.
                target = torch.where(ops.batch.oid >= 0, ops.batch.row_id,
                                     torch.full_like(ops.batch.row_id,
                                                     n * t)).long()
                y_all = torch.zeros((n * t + 1, tp, node.c_out),
                                    dtype=y.dtype, device=y.device)
                y_all[target] = y
                flat = y_all[:-1]
            else:
                flat = y.contiguous()    # rows already in (img, tile) order
        else:
            pl_j = tiles_to_plane(flat.reshape(n, t, tp, node.c_in), grid,
                                  h, w)
            yp = conv2d(pl_j.contiguous(), p["w"], p["b"])
            if node.relu:
                yp = torch.relu(yp)
            flat = plane_to_tiles(yp, grid).reshape(
                n * t, tp, node.c_out).contiguous()
        dispatches += 1
    out = tiles_to_plane(flat.reshape(n, t, tp, group.c_out), grid, h, w)
    return out.contiguous(), dispatches


def _batch_fused_group_traces(group: FusedGroup, art: _BatchGroupArtifacts,
                              cfg: GraphConfig, dtype_bytes: int,
                              group_idx: int) -> list[GroupTrace]:
    """Per-image GroupTraces of one batch-fused group — host assembly of
    the composite schedules after the group's dispatches."""
    grid = art.grid
    tp = grid.th * grid.tw
    t = grid.num_tiles
    tile_bytes = tp * group.c_in * dtype_bytes
    traces = []
    for i, bundle in enumerate(art.bundles):
        sched = bundle.ds.to_host()
        gt = GroupTrace(
            grid=grid, tile_bytes=tile_bytes, buffer_tiles=art.m,
            schedule=cfg.schedule, schedule_cache_hit=art.cache_hits[i],
            schedule_backend=cfg.schedule_backend,
            dispatch="batch_fused", batch_rows=(i * t, (i + 1) * t),
            dtype_bytes=dtype_bytes, layer_channels=group.layer_channels,
            output_bytes=grid.h * grid.w * group.c_out * dtype_bytes,
            weight_bytes=group_weight_bytes(group, dtype_bytes),
            b_layers=[np.asarray(b.cpu() if torch.is_tensor(b) else b,
                                 bool) for b in bundle.b_layers],
            kernel_dispatches=0)
        gt.image, gt.group = i, group_idx
        gt.layer_stats = [LayerBufferStats(
            kind=nd.kind,
            tiles_computed=(len(sched.oid) if j == group.n_layers - 1
                            and isinstance(nd, DeformNode) else t),
            recomputes=0,
            max_resident_bytes=t * tp * nd.c_out * dtype_bytes)
            for j, nd in enumerate(group.nodes)]
        for out_tile, loads in zip(sched.oid, sched.iid):
            gt.records.append(TileRecord(
                out_tile=out_tile, dep_tiles=tuple(loads),
                loaded_bytes=len(loads) * tile_bytes,
                buffer_bytes=len(loads) * tile_bytes))
        traces.append(gt)
    return traces


def _run_graph_batch_fused(convs: list, segments: list[Segment],
                           x: torch.Tensor, cfg: GraphConfig,
                           cache: ScheduleCache | None,
                           max_displacement: float | None,
                           trace: NetworkTrace, return_trace: bool,
                           tracer: Tracer, mesh=None,
                           shard_sizes=None) -> torch.Tensor:
    """Batch-fused graph execution: the staging unit is a SEGMENT of the
    whole batch — segment s+1's batch prepass overlaps segment s's
    execution on the staging thread.

    With a ``mesh`` every DCN segment runs the kernel once per shard of
    the batch (``shard_sizes`` images each, else the near-even split);
    the prepass chain and the dense segments stay on the true batch, so
    schedules, traces and numerics are the single-device run's. The
    modeled collective is the one gather of the output planes."""
    n = x.shape[0]
    th, tw = cfg.tile_hw
    itemsize = x.element_size()
    plan = (plan_batch_shards(n, mesh.shape["data"], shard_sizes)
            if mesh is not None else None)

    deform_after = _deform_after(segments)

    # The dense stage-1 chain state, advanced in order by the prepass
    # (run_staged's single worker preserves submission order). The epoch
    # guard exists for watchdog failover: after a stuck worker is
    # abandoned and the same segment re-runs synchronously, the worker
    # may still wake, finish and enqueue its work on the stream — its
    # read is rejected (epoch moved on) or its commit discarded, so the
    # chain state can never regress or double-advance.
    pre_lock = threading.Lock()
    pre_state = {"plane": x, "epoch": 0}

    def prepass(s: int):
        seg = segments[s]
        with pre_lock:
            if pre_state["epoch"] != s:
                return None        # stale duplicate from an abandoned worker
            plane_in = pre_state["plane"]
        if isinstance(seg, (PoolNode, UpsampleNode)):
            art = None
            plane = (apply_boundary_batch(plane_in, seg)
                     if deform_after[s] else plane_in)
        else:
            grid = _segment_grid(seg, th, tw)
            m = (grid.num_tiles if cfg.buffer_tiles is None
                 else cfg.buffer_tiles)
            art, plane = _group_batch_prepass(
                plane_in, seg, convs, grid, m, cfg, max_displacement,
                cache, need_out_plane=deform_after[s], tracer=tracer,
                plan=plan)
        with pre_lock:
            if pre_state["epoch"] == s:
                pre_state["plane"] = plane
                pre_state["epoch"] = s + 1
        return art

    exec_state = {"plane": x, "group": 0}
    pending: list[GroupTrace] = []

    def execute(s: int, art):
        seg = segments[s]
        if art is None:
            exec_state["plane"] = apply_boundary_batch(exec_state["plane"],
                                                       seg)
            trace.boundary_bytes += n * boundary_bytes(seg, itemsize)
            return None
        planes, dispatches = _exec_group_batch_fused(
            exec_state["plane"], seg, convs, cfg, art, mesh=mesh, plan=plan)
        exec_state["plane"] = planes
        trace.batch_dispatches += dispatches
        trace.overlap.schedule_s += art.schedule_s
        trace.overlap.schedule_device_s += art.schedule_device_s
        if return_trace:
            pending.extend(_batch_fused_group_traces(
                seg, art, cfg, itemsize, exec_state["group"]))
        exec_state["group"] += 1
        return None

    run_staged(len(segments), prepass, execute, cfg.staging_depth,
               trace.overlap, tracer=tracer, watchdog_s=cfg.watchdog_s,
               faults=cfg.faults)
    pending.sort(key=lambda g: (g.image, g.group))
    trace.groups.extend(pending)
    out = exec_state["plane"]
    if plan is not None:
        # Each shard keeps its rows until the output planes, which cross
        # to the caller once; the per-segment gathers of this single
        # controller are not modeled traffic.
        trace.shards = plan.n_shards
        trace.allgather_bytes += allgather_nbytes(out)
    return out


def run_graph(convs: list, graph: NetGraph, x: torch.Tensor, *,
              config: GraphConfig | None = None,
              max_displacement: float | None = None,
              return_trace: bool = False,
              schedule_cache: ScheduleCache | None = None,
              tracer: Tracer | None = None,
              shard_sizes=None,
              tuned_plan="auto"):
    """Execute a backbone graph over a batch: (N,H,W,C) -> (N,H',W',C').

    ``convs`` is the per-node parameter list (``params["convs"]``):
    ``DeformableConvParams`` for DeformNodes, ``{"w", "b"}`` dicts for
    ConvNodes, all on ``x``'s device. Numerically matches
    :func:`run_graph_dense` to float tolerance; with ``return_trace`` it
    also returns the :class:`NetworkTrace` of the executed DRAM traffic.
    ``schedule_cache`` overrides the process-wide cache (serving engines
    pass their own); ``tracer`` routes span tracing.

    With ``config.mesh`` / ``config.data_parallel`` (batch_fused only) the
    batch shards over the mesh's "data" axis; ``shard_sizes`` pins the
    images of each shard (the serving engine's replica placement — must
    sum to N, zeros allowed). The result is bitwise the single-device
    run's, and traces do not depend on the placement.

    With ``config.autotune`` enabled the partition and per-group tile
    shapes come from the simulator-guided tuner (``repro_torch.tuning``):
    ``tuned_plan="auto"`` resolves through the plan cache per the config
    knobs; pass a ``TunedPlan`` (or None for explicitly-greedy) to skip
    resolution — the serving engine resolves once at construction and
    replays the same plan on every step. Executed traces stay exactly
    equal to the DRAM simulator under any tuned plan.
    """
    cfg = config or GraphConfig()
    if tuple(x.shape[1:]) != (graph.in_h, graph.in_w, graph.in_c):
        raise ValueError(
            f"input {tuple(x.shape[1:])} does not match the graph's "
            f"({graph.in_h}, {graph.in_w}, {graph.in_c}) input plane — "
            f"rebuild the graph for this image size")
    th, tw = cfg.tile_hw
    if th > graph.in_h or tw > graph.in_w:
        raise ValueError(
            f"tile {th}x{tw} exceeds the {graph.in_h}x{graph.in_w} input "
            f"plane — choose tile sides <= the plane (interior groups at "
            f"lower resolution are clamped automatically)")
    tr = tracer if tracer is not None else get_tracer()
    if schedule_cache is not None:
        cache: ScheduleCache | None = schedule_cache
    else:
        cache = default_schedule_cache() if cfg.use_schedule_cache else None
    trace = NetworkTrace()
    n = x.shape[0]
    if n == 0:
        h, w, c = graph.out_shape
        y = torch.zeros((0, h, w, c), dtype=x.dtype, device=x.device)
        return (y, trace) if return_trace else y

    # "auto": resolve per cfg.autotune (cache-through; "offline" may pay
    # a search on first use). Callers that already hold a plan — the
    # serving engine resolves once at construction — pass it (or None
    # for explicitly-greedy) so the hot path never re-resolves.
    if tuned_plan == "auto":
        tuned_plan = None
        if cfg.autotune != "off":
            from repro_torch.tuning import resolve_tuned_plan
            tuned_plan = resolve_tuned_plan(
                convs, graph, autotune=cfg.autotune,
                onchip_budget_bytes=cfg.onchip_budget_bytes,
                dtype_bytes=x.element_size(), tile_hw=cfg.tile_hw,
                buffer_tiles=cfg.buffer_tiles, schedule=cfg.schedule,
                batch=n, budget=cfg.autotune_budget,
                plan_cache_dir=cfg.plan_cache_dir,
                max_displacement=max_displacement, tracer=tr)
    segments = partition_graph_cached(graph, cfg.onchip_budget_bytes,
                                      dtype_bytes=x.element_size(),
                                      autotune=cfg.autotune,
                                      tuned=tuned_plan)
    mesh = resolve_shard_mesh(cfg.mesh, cfg.data_parallel)
    if shard_sizes is not None and mesh is None:
        raise ValueError(
            "shard_sizes= requires a sharded config (mesh= or "
            "data_parallel= with a data axis > 1)")
    if cfg.dispatch == "batch_fused":
        with use_tracer(tr):
            y = _run_graph_batch_fused(convs, segments, x, cfg, cache,
                                       max_displacement, trace,
                                       return_trace, tr, mesh=mesh,
                                       shard_sizes=shard_sizes)
        return (y, trace) if return_trace else y

    def prepass(i: int):
        if cfg.faults is not None:
            cfg.faults.check("prepass", image=i)
        return _image_prepass(x[i], segments, convs, cfg, max_displacement,
                              cache, tracer=tr)

    def execute_image(i: int, arts) -> torch.Tensor:
        if cfg.faults is not None:
            cfg.faults.check("dispatch", image=i)
        plane = x[i]
        g = 0
        for seg, art in zip(segments, arts):
            if art is None:
                plane = apply_boundary_dense(plane, seg)
                trace.boundary_bytes += boundary_bytes(seg, x.element_size())
            else:
                plane, gt = _run_group(plane, seg, convs, cfg, art)
                gt.image, gt.group = i, g
                g += 1
                trace.overlap.schedule_s += art.schedule_s
                trace.overlap.schedule_device_s += art.schedule_device_s
                trace.groups.append(gt)
        return plane

    with use_tracer(tr):
        outs = run_staged(n, prepass, execute_image, cfg.staging_depth,
                          trace.overlap, tracer=tr,
                          watchdog_s=cfg.watchdog_s, faults=cfg.faults)
    y = torch.stack(outs)
    return (y, trace) if return_trace else y


def network_sim_specs(trace: NetworkTrace) -> list[dict]:
    """``core.simulator.simulate_network`` group specs from an executed
    trace — byte-identical TDT inputs, so the fused prediction must equal
    the executed FIFO replay exactly."""
    return [dict(b_layers=gt.b_layers, grid=gt.grid,
                 layer_channels=gt.layer_channels,
                 weight_bytes=gt.weight_bytes,
                 buffer_tiles=gt.buffer_tiles, dtype_bytes=gt.dtype_bytes,
                 schedule=gt.schedule)
            for gt in trace.groups]
