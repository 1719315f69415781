"""Cross-layer fused network executor (paper §IV-D taken network-wide).

Executes a :class:`~repro_torch.runtime.graph.NetGraph` under the
accelerator's cross-layer dataflow: inside each fused group, boundary
planes between layers carry no *modeled* DRAM traffic — the
:class:`~repro_torch.runtime.trace.NetworkTrace` prices exactly
group-input tile loads (FIFO buffer model), group outputs, weights and
pool/upsample boundary planes, matching
``core.simulator.simulate_network`` byte for byte.

This slice ports the ``batch_fused`` dispatch mode, the one the serving
engine runs. Per segment of the whole batch:

  prepass   the stage-1 chain runs batched (dense offset convs, and the
            dense layers as far ahead as a later offset conv needs),
            per-image TDTs and composite Algorithm-1 schedules are built
            in dense dispatch form (cached by quantized coords), and the
            per-layer operands are concatenated over the batch. With
            ``schedule_backend="device"`` the TDT and Algorithm 1 run as
            CUDA kernels and their arrays feed the dispatch directly.
            Segment s+1's prepass runs on a staging thread while segment
            s executes.
  execute   ONE dispatch per layer segment: the batch-fused BLI(+)conv
            kernel for DCN layers, one batched dense conv for standard
            layers; scheduled rows scatter back to (image, tile) order.

The ``batched`` and ``per_tile`` modes are left for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.deform import conv2d, deformable_conv2d, \
    offsets_to_coords
from repro_torch.core.scheduler import (DeviceSchedule, pow2_pad,
                                        schedule_arrays_device,
                                        schedule_tiles, sequential_schedule)
from repro_torch.core.tiles import (TileGrid, compose_tdt_chain,
                                    compose_tdt_chain_device,
                                    tdt_from_coords, tdt_standard_conv)
from repro_torch.kernels.dcn_fused import dcn_fused_batch
from repro_torch.kernels.dcn_schedule import (tdt_dispatch_arrays,
                                              tdt_from_coords_device)
from repro_torch.obs import Tracer, get_tracer, use_tracer
from repro_torch.runtime.cache import (ScheduleCache, chain_digest,
                                       conv_digest, coords_digest,
                                       default_schedule_cache)
from repro_torch.runtime.graph import (DeformNode, FusedGroup, NetGraph,
                                       PoolNode, Segment, UpsampleNode,
                                       boundary_bytes, group_weight_bytes,
                                       partition_graph_cached)
from repro_torch.runtime.packing import (pack_batch_schedules,
                                         pack_plane_operands, plane_to_tiles,
                                         tiles_to_plane)
from repro_torch.runtime.pipeline import run_staged, validate_dispatch_config
from repro_torch.runtime.trace import (GroupTrace, LayerBufferStats,
                                       NetworkTrace, TileRecord)

ONCHIP_BUDGET_BYTES = (128 + 256) * 1024   # paper Table I: input + output buf


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Network-graph executor knobs."""

    tile: int | tuple[int, int] = 8       # tile side(s), shared per group
    buffer_tiles: int | None = None       # M for the composite schedule
    schedule: str = "alg1"                # "alg1" | "sequential"
    block_p: int = 128                    # pixel block: pads P to a multiple
    onchip_budget_bytes: int = ONCHIP_BUDGET_BYTES  # drives group planning
    use_schedule_cache: bool = True
    # Only "batch_fused" runs in this slice: the concatenated schedules of
    # all batch images as one kernel grid per layer segment.
    dispatch: str = "batch_fused"
    # "host": TDT scatter + Algorithm-1 loop on the host (numpy).
    # "device": both as CUDA kernels, bit-exact vs the host path.
    schedule_backend: str = "host"
    # Segments staged ahead of execution: 1 = serial, 2 = prepass segment
    # s+1 on a worker thread while segment s executes.
    staging_depth: int = 2

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
    """Tile grid of one fused group, clamped to the group's plane."""
    return TileGrid(seg.h, seg.w, min(th, seg.h), min(tw, seg.w))


def _valid_masks(grid: TileGrid, dtype, device) -> torch.Tensor:
    """(T, tp, 1): 1 inside the real H x W plane, 0 on tile padding."""
    rr = torch.arange(grid.rows * grid.th, device=device) < grid.h
    cc = torch.arange(grid.cols * grid.tw, device=device) < grid.w
    valid = (rr[:, None] & cc[None, :])[..., None].to(dtype)
    return plane_to_tiles(valid, grid).contiguous()


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
    """One DCN layer's batch-fused operands (whole batch)."""

    batch: Any                            # packing.BatchDispatch
    idx: torch.Tensor                     # (N*T, p_pad, KK, 4) int32
    coeff: torch.Tensor                   # (N*T, p_pad, KK, 4) float32


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
) -> tuple[_BatchGroupArtifacts, torch.Tensor]:
    """Batch-level prepass for one group: the stage-1 chain runs batched,
    per-image composite schedules are built in dense form (cached —
    partial batch hits skip scheduling for the hit images), and the
    per-layer operands are concatenated with per-image base offsets."""
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

    def build_bundle(i: int) -> _ImageGroupSched:
        b_layers: list = []
        with tr.span("prepass.tdt", backend=cfg.schedule_backend, image=i):
            for j, node in enumerate(group.nodes):
                if coords_layers[j] is None:
                    B = tdt_standard_conv(grid, grid, node.kernel_size)
                    b_layers.append(torch.as_tensor(B, device=dev)
                                    if device else B)
                elif device:
                    b_layers.append(tdt_from_coords_device(
                        coords_layers[j][i], grid, grid))
                else:
                    b_layers.append(tdt_from_coords(
                        coords_layers[j][i].cpu(), grid, grid).numpy())
        if device:
            comp = compose_tdt_chain_device(b_layers)
            ds = schedule_arrays_device(comp, m, k_pad=k_pad)
        else:
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

    bundles, hits = [], []
    with tr.timed("prepass.schedule", backend=cfg.schedule_backend,
                  batch=n) as ssp:
        for i in range(n):
            if cache is None:
                bundles.append(build_bundle(i))
                hits.append(None)
                continue
            digests = []
            for j, node in enumerate(group.nodes):
                if coords_layers[j] is None:
                    digests.append(conv_digest(node.kernel_size, grid))
                else:
                    digests.append(coords_digest(coords_layers[j][i], grid))
            key = (chain_digest(digests, grid), grid.th, grid.tw, m,
                   cfg.schedule, "dense")
            bundle, hit = cache.get_or_build(key,
                                             lambda i=i: build_bundle(i))
            bundles.append(bundle)
            hits.append(hit)
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
            scheds = [bundles[i].exec_scheds[j] for i in range(n)]
            layer_ops.append(_BatchLayerOps(
                pack_batch_schedules(scheds, t_out, t_out, dev),
                idx.reshape(n * t_out, p_pad, kk, 4),
                coeff.reshape(n * t_out, p_pad, kk, 4)))

    art = _BatchGroupArtifacts(
        grid=grid, m=m, bundles=bundles, cache_hits=hits,
        layer_ops=layer_ops, schedule_s=schedule_s,
        schedule_device_s=schedule_s if device else 0.0)
    return art, plane


def _exec_group_batch_fused(planes: torch.Tensor, group: FusedGroup,
                            convs: list, art: _BatchGroupArtifacts
                            ) -> tuple[torch.Tensor, int]:
    """Execute one fused group for the whole batch: ONE dispatch per
    layer segment (the batch-fused kernel for DCN layers, one batched
    dense conv for standard layers)."""
    n = planes.shape[0]
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
            y = dcn_fused_batch(
                flat, ops.batch.row_id, ops.batch.dep_glb,
                ops.batch.dep_cnt, ops.idx, ops.coeff, w2, p.b,
                t_in=t)[:, :tp]
            if node.relu:
                y = torch.relu(y)
            y = y * masks[ops.batch.oid.clamp_min(0).long()]
            if j == last:
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
                           tracer: Tracer) -> torch.Tensor:
    """Batch-fused graph execution: the staging unit is a SEGMENT of the
    whole batch — segment s+1's batch prepass overlaps segment s's
    execution on the staging thread."""
    n = x.shape[0]
    th, tw = cfg.tile_hw
    itemsize = x.element_size()

    deform_after = [False] * len(segments)
    seen = False
    for s in range(len(segments) - 1, -1, -1):
        deform_after[s] = seen
        if isinstance(segments[s], FusedGroup) and any(
                isinstance(nd, DeformNode) for nd in segments[s].nodes):
            seen = True

    # The dense stage-1 chain state, advanced in order by the prepass
    # (run_staged's single worker preserves submission order).
    pre_state = {"plane": x}

    def prepass(s: int):
        seg = segments[s]
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
                cache, need_out_plane=deform_after[s], tracer=tracer)
        pre_state["plane"] = plane
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
            exec_state["plane"], seg, convs, art)
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
               trace.overlap, tracer=tracer)
    pending.sort(key=lambda g: (g.image, g.group))
    trace.groups.extend(pending)
    return exec_state["plane"]


def run_graph(convs: list, graph: NetGraph, x: torch.Tensor, *,
              config: GraphConfig | None = None,
              max_displacement: float | None = None,
              return_trace: bool = False,
              schedule_cache: ScheduleCache | None = None,
              tracer: Tracer | None = None):
    """Execute a backbone graph over a batch: (N,H,W,C) -> (N,H',W',C').

    ``convs`` is the per-node parameter list (``params["convs"]``):
    ``DeformableConvParams`` for DeformNodes, ``{"w", "b"}`` dicts for
    ConvNodes, all on ``x``'s device. Numerically matches
    :func:`run_graph_dense` to float tolerance; with ``return_trace`` it
    also returns the :class:`NetworkTrace` of the executed DRAM traffic.
    ``schedule_cache`` overrides the process-wide cache (serving engines
    pass their own); ``tracer`` routes span tracing.
    """
    cfg = config or GraphConfig()
    if cfg.dispatch != "batch_fused":
        raise NotImplementedError(
            f"dispatch={cfg.dispatch!r} is not ported yet: the per-image "
            f"'batched' and 'per_tile' modes come with the tile-pipeline "
            f"slice of the port; use dispatch='batch_fused'")
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

    segments = partition_graph_cached(graph, cfg.onchip_budget_bytes,
                                      dtype_bytes=x.element_size())
    with use_tracer(tr):
        y = _run_graph_batch_fused(convs, segments, x, cfg, cache,
                                   max_displacement, trace, return_trace,
                                   tr)
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
