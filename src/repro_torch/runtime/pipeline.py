"""The tile-pipeline executor: TDT -> schedule -> pack -> fused kernel.

``dcn_pipeline`` runs one deformable convolution over an ``(N, H, W, C)``
batch the way the paper's accelerator does (§IV-C/D): the stage-1 offset
conv runs dense (a library conv), the sampling coordinates drive a
per-image tile dependency table and Algorithm-1 schedule (the paper's
scheduler is a hardware block running ahead of the PE array), and the
schedule executes through the fused BLI(+)conv kernels. Three dispatch
modes (``PipelineConfig.dispatch``):

  * ``"batched"`` (default) — one image's whole schedule in one launch of
    ``kernels.dcn_fused.dcn_fused_schedule``; outputs scatter back in one
    op;
  * ``"per_tile"`` — one ``dcn_fused_tile`` launch per schedule entry;
  * ``"batch_fused"`` — the concatenated schedules of the whole batch in
    one ``dcn_fused_batch`` launch.

``run_staged`` overlaps the host prepass of unit i+1 (schedule build,
packing) with the execution of unit i on one worker thread. Both threads
issue work on the device's default stream, so the worker's tensors are
ready for the executing thread in stream order with no events. Its
watchdog turns a wedged worker into a failover to synchronous prepass.
Gradients do not flow through this path.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any

import numpy as np
import torch

from repro_torch.core.deform import DeformableConvParams, conv2d, \
    offsets_to_coords
from repro_torch.core.scheduler import (DeviceSchedule, TileSchedule,
                                        pow2_pad, schedule_arrays_device,
                                        schedule_tiles, sequential_schedule)
from repro_torch.core.tiles import TileGrid, tdt_from_coords
from repro_torch.kernels.dcn_fused import (dcn_fused_batch,
                                           dcn_fused_batch_sharded,
                                           dcn_fused_schedule,
                                           dcn_fused_tile)
from repro_torch.kernels.dcn_schedule import tdt_from_coords_device
from repro_torch.kernels.ops import round_up
from repro_torch.obs import Tracer, default_registry, get_tracer, \
    use_tracer
from repro_torch.runtime.cache import coords_digest, default_schedule_cache
from repro_torch.runtime.packing import (NeighbourTables,
                                         build_neighbour_tables,
                                         pack_batch_schedules,
                                         pack_output_tile,
                                         pack_plane_operands,
                                         pack_schedule_tiles, plane_to_tiles,
                                         tiles_to_plane)
from repro_torch.runtime.shard import (ShardPlan, allgather_nbytes,
                                       plan_batch_shards, resolve_shard_mesh,
                                       scatter_shard_rows,
                                       shard_batch_schedules, stack_rows)
from repro_torch.runtime.trace import ImageTrace, PipelineTrace, TileRecord

DISPATCH_MODES = ("batched", "per_tile", "batch_fused")

# Process-wide like core.scheduler.host_schedule_builds: callers that
# need a per-engine view keep a construction-time baseline and report
# their delta.
staging_watchdog_failovers = default_registry().counter(
    "staging.watchdog_failovers",
    help="staged prepasses that missed the watchdog deadline and were "
         "re-run synchronously on the driving thread")


def run_staged(n: int, prepass, execute, depth: int, overlap,
               tracer: Tracer | None = None,
               watchdog_s: float | None = None, faults=None) -> list:
    """``prepass(i)`` builds unit i's artifacts, ``execute(i, art)`` runs
    them. With ``depth > 1`` up to ``depth - 1`` prepasses run ahead on a
    single worker thread (submission order is preserved); ``overlap`` (an
    :class:`~repro_torch.runtime.trace.OverlapSpans`) accumulates the
    ``prepass`` / ``prepass.wait`` spans. Returns the execute results.

    ``watchdog_s`` bounds each wait on the worker: a prepass that does not
    deliver in time is treated as wedged — the queue fails over to
    synchronous prepass for the rest of the run
    (``staging.watchdog_failover`` instant + process counter), and the
    stuck worker is abandoned, never joined: its pool shuts down without
    waiting and with its queued work cancelled. Callers whose prepass
    advances shared state guard it with an epoch, so the abandoned
    worker's late commit is a no-op (see ``fused_exec``). ``faults`` is a
    test-only injector consulted for ``worker_stall`` sleeps.
    """
    tr = tracer if tracer is not None else get_tracer()

    def staged(i: int):
        if faults is not None:
            faults.stall("worker_stall")
        with tr.timed("prepass", unit=i) as sp:
            art = prepass(i)
        return art, sp

    outs = []
    if depth == 1 or n == 1:
        for i in range(n):
            with tr.timed("prepass.wait", unit=i) as wsp:
                art, sp = staged(i)
            overlap.add_span(sp)
            overlap.add_span(wsp)
            outs.append(execute(i, art))
        return outs
    pool = ThreadPoolExecutor(max_workers=1)
    failed_over = False
    try:
        futs: deque = deque()
        nxt = 0
        while nxt < n and len(futs) < depth - 1:
            futs.append(pool.submit(staged, nxt))
            nxt += 1
        for i in range(n):
            with tr.timed("prepass.wait", unit=i) as wsp:
                if failed_over or not futs:
                    art, sp = staged(i)
                else:
                    try:
                        art, sp = futs.popleft().result(timeout=watchdog_s)
                    except _FutTimeout:
                        failed_over = True
                        staging_watchdog_failovers.bump()
                        tr.instant("staging.watchdog_failover", unit=i)
                        art, sp = staged(i)
            overlap.add_span(sp)
            overlap.add_span(wsp)
            if not failed_over and nxt < n:
                futs.append(pool.submit(staged, nxt))
                nxt += 1
            outs.append(execute(i, art))
    finally:
        # A wedged worker would hang a waiting shutdown: after a failover
        # abandon it (queued work is cancelled; the running thread exits
        # on its own — injected stalls are finite by contract).
        pool.shutdown(wait=not failed_over, cancel_futures=failed_over)
    return outs


def validate_dispatch_config(cfg) -> None:
    """Shared ``__post_init__`` checks of the executor configs: tile
    sides, dispatch mode, schedule backend, staging depth, watchdog,
    sharding (``batch_fused`` only) and the autotune mode and budget."""
    cfg.tile_hw                          # validates tile sides
    if cfg.dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch mode: {cfg.dispatch!r}")
    if cfg.schedule_backend not in ("host", "device"):
        raise ValueError(
            f"unknown schedule backend: {cfg.schedule_backend!r}")
    if cfg.schedule not in ("alg1", "sequential"):
        raise ValueError(f"unknown schedule: {cfg.schedule!r}")
    if cfg.staging_depth < 1:
        raise ValueError(
            f"staging_depth must be >= 1, got {cfg.staging_depth}")
    if cfg.watchdog_s is not None and cfg.watchdog_s <= 0:
        raise ValueError(
            f"watchdog_s must be > 0 (or None), got {cfg.watchdog_s}")
    dp = cfg.data_parallel
    if dp is not None and dp < 1:
        raise ValueError(f"data_parallel must be >= 1, got {dp}")
    if ((cfg.mesh is not None or (dp or 1) > 1)
            and cfg.dispatch != "batch_fused"):
        raise ValueError(
            "mesh=/data_parallel= sharding only applies to "
            f"dispatch='batch_fused', got dispatch={cfg.dispatch!r}")
    if cfg.autotune not in ("off", "offline", "cached-only"):
        raise ValueError(
            f"autotune must be 'off', 'offline' or 'cached-only', "
            f"got {cfg.autotune!r}")
    if cfg.autotune_budget < 1:
        raise ValueError(
            f"autotune_budget must be >= 1, got {cfg.autotune_budget}")


def clamp_tile_config(cfg, h: int, w: int):
    """Clamp a config's tile to an (h, w) input plane — model and serving
    entry points accept any image size, while the raw executors reject
    tile > plane. Works for ``PipelineConfig`` and ``GraphConfig``."""
    th, tw = cfg.tile_hw
    if th <= h and tw <= w:
        return cfg
    return dataclasses.replace(cfg, tile=(min(th, h), min(tw, w)))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Executor knobs (everything except the layer's own parameters)."""

    tile: int | tuple[int, int] = 8      # output/input tile side(s)
    buffer_tiles: int | None = None      # M for Algorithm 1; None = all
    schedule: str = "alg1"               # "alg1" | "sequential"
    block_p: int = 128                   # pixel block: pads P to a multiple
    use_schedule_cache: bool = True      # LRU-cache TDT+Algorithm-1 builds
    # "batched": one image's whole schedule in one launch.
    # "batch_fused": the concatenated schedules of the whole batch in one
    #   launch (the schedule arrays feed it directly on the device backend).
    # "per_tile": one launch per schedule entry.
    dispatch: str = "batched"
    # "host": TDT scatter + Algorithm-1 loop on the host (numpy).
    # "device": both as CUDA kernels, bit-exact vs the host path.
    schedule_backend: str = "host"
    # Images staged ahead: 1 = serial, 2 = prepass image i+1 on a worker
    # thread while image i executes.
    staging_depth: int = 2
    # Staging-worker watchdog: None = wait forever; a float bounds each
    # wait on a staged prepass, after which the run fails over to
    # synchronous prepass.
    watchdog_s: float | None = None
    # Batch-axis scale-out (batch_fused only): a
    # repro_torch.launch.mesh.DeviceMesh, or data_parallel=D (a mesh over
    # the first D CUDA devices, built at run time). Each mesh device runs
    # the concatenated schedules of its local images.
    mesh: Any = None
    data_parallel: int | None = None
    # Simulator-guided tile autotuning (repro_torch.tuning): "off" = use
    # the configured tile; "offline" = search once per layer geometry for
    # the (tile_h, tile_w) with the least simulated DRAM traffic and
    # cache the winner; "cached-only" = use a cached winner, never
    # search. plan_cache_dir persists winners across processes.
    autotune: str = "off"
    plan_cache_dir: str | None = None
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


def schedule_cache_key(digest: str, grid: TileGrid, m: int, cfg,
                       *extra) -> tuple:
    """Schedule-cache key. Tile dims are hashed inside the digest via the
    grid but stay explicit too: the same coords under another tile shape
    must never collide. An injected ``cache_miss`` fault salts it."""
    key = (digest, grid.th, grid.tw, m, cfg.schedule) + extra
    if cfg.faults is not None:
        salt = cfg.faults.miss_salt()
        if salt is not None:
            key = key + (salt,)
    return key


@dataclasses.dataclass
class _ImageArtifacts:
    """Prepass products of one image: schedule + packed kernel operands."""

    sched: TileSchedule
    cache_hit: bool | None
    nb: NeighbourTables
    k_pad: int
    schedule_s: float = 0.0
    schedule_device_s: float = 0.0
    # batched dispatch only: stacked kernel operands for the whole schedule
    dep_tbl: np.ndarray | None = None
    dep_cnt: np.ndarray | None = None
    idx: np.ndarray | None = None
    coeff: np.ndarray | None = None


def _pipeline_prepass(coords_i: torch.Tensor, grid: TileGrid, m: int,
                      p_pad: int, cfg: PipelineConfig,
                      tracer: Tracer | None = None) -> _ImageArtifacts:
    """Prepass of one image: TDT -> schedule (cached) -> neighbour tables
    -> (batched) packed operands. With ``schedule_backend="device"`` the
    TDT and the Algorithm-1 selection run as CUDA kernels and the host
    only assembles the schedule."""
    tr = tracer if tracer is not None else get_tracer()

    def build_schedule():
        with tr.span("prepass.tdt", backend=cfg.schedule_backend):
            if cfg.schedule_backend == "device":
                B = tdt_from_coords_device(coords_i, grid, grid)
            else:
                B = tdt_from_coords(coords_i.cpu(), grid, grid)
        if cfg.schedule == "alg1":
            return schedule_tiles(B, m, backend=cfg.schedule_backend)
        return sequential_schedule(B)

    with tr.timed("prepass.schedule",
                  backend=cfg.schedule_backend) as ssp:
        if cfg.use_schedule_cache:
            key = schedule_cache_key(coords_digest(coords_i, grid), grid,
                                     m, cfg)
            sched, cache_hit = default_schedule_cache().get_or_build(
                key, build_schedule)
        else:
            sched, cache_hit = build_schedule(), None
        ssp.set(cached=cache_hit)
    schedule_s = ssp.dur

    with tr.span("pack", dispatch=cfg.dispatch):
        nb = build_neighbour_tables(coords_i, grid)
        # One packed-buffer size for the image's dispatches: the dep-tile
        # count padded to a power of two.
        oid, deps, counts = sched.dense()
        art = _ImageArtifacts(
            sched=sched, cache_hit=cache_hit, nb=nb, k_pad=deps.shape[1],
            schedule_s=schedule_s,
            schedule_device_s=(schedule_s
                               if cfg.schedule_backend == "device"
                               else 0.0))
        if cfg.dispatch == "batched":
            dep_lists = [d[:c] for d, c in zip(deps, counts)]
            (art.dep_tbl, art.dep_cnt, art.idx,
             art.coeff) = pack_schedule_tiles(nb, grid, oid, dep_lists,
                                              p_pad, art.k_pad)
    return art


def _pipeline_exec(x_i: torch.Tensor, art: _ImageArtifacts,
                   w2: torch.Tensor, b: torch.Tensor, cfg: PipelineConfig,
                   grid: TileGrid, m: int, p_pad: int
                   ) -> tuple[torch.Tensor, ImageTrace]:
    h, w, c = x_i.shape
    dev = x_i.device
    tp = grid.th * grid.tw
    sched, nb, k_pad = art.sched, art.nb, art.k_pad
    c_out = w2.shape[-1]

    tile_bytes = tp * c * x_i.element_size()
    trace = ImageTrace(grid=grid, tile_bytes=tile_bytes, buffer_tiles=m,
                       schedule=cfg.schedule,
                       schedule_cache_hit=art.cache_hit,
                       dispatch=cfg.dispatch,
                       schedule_backend=cfg.schedule_backend)

    x_tiles = plane_to_tiles(x_i, grid).contiguous()       # (T, tp, C)
    buffer_bytes = k_pad * tp * c * x_i.element_size()

    def up(a):
        return torch.as_tensor(a, device=dev)

    if cfg.dispatch == "batched":
        y_sched = dcn_fused_schedule(
            x_tiles, up(art.dep_tbl), up(art.dep_cnt), up(art.idx),
            up(art.coeff), w2, b, block_p=cfg.block_p)[:, :tp]
        y_tiles = torch.zeros((grid.num_tiles, tp, c_out), dtype=x_i.dtype,
                              device=dev)
        y_tiles[up(np.asarray(sched.oid, np.int64))] = y_sched
        trace.kernel_dispatches = 1
    else:
        y_tiles = torch.zeros((grid.num_tiles, tp, c_out), dtype=x_i.dtype,
                              device=dev)
        for out_tile, deps in zip(sched.oid, sched.iid):
            idx, coeff = pack_output_tile(nb, grid, out_tile, deps, p_pad)
            x_packed = torch.zeros((k_pad, tp, c), dtype=x_i.dtype,
                                   device=dev)
            x_packed[:len(deps)] = x_tiles[up(np.asarray(deps, np.int64))]
            y_t = dcn_fused_tile(x_packed.reshape(k_pad * tp, c), up(idx),
                                 up(coeff), w2, b, block_p=cfg.block_p)
            y_tiles[out_tile] = y_t[:tp]
            trace.kernel_dispatches += 1

    for out_tile, deps in zip(sched.oid, sched.iid):
        trace.records.append(TileRecord(
            out_tile=out_tile, dep_tiles=tuple(deps),
            loaded_bytes=len(deps) * tile_bytes,
            buffer_bytes=buffer_bytes))
    return tiles_to_plane(y_tiles, grid, h, w), trace


def build_dense_schedule(coords_i: torch.Tensor, grid: TileGrid, m: int,
                         cfg, cache) -> tuple[DeviceSchedule, bool | None]:
    """One image's schedule in dense dispatch form (cached).

    With ``schedule_backend="device"`` (and the alg1 schedule) the TDT,
    the greedy selection and the schedule->dispatch handoff all run on
    the card: the arrays stay there and NO host ``TileSchedule`` is
    built. The host backend (and the sequential ablation) builds the
    classic schedule and densifies it.
    """

    def build() -> DeviceSchedule:
        if cfg.schedule_backend == "device":
            B = tdt_from_coords_device(coords_i, grid, grid)
            if cfg.schedule == "alg1":
                return schedule_arrays_device(B, m)
        else:
            B = tdt_from_coords(coords_i.cpu(), grid, grid)
        sched = (schedule_tiles(B, m) if cfg.schedule == "alg1"
                 else sequential_schedule(B))
        return DeviceSchedule.from_host(sched, grid.num_tiles)

    if cache is None:
        return build(), None
    # A "dense" discriminator: the cached value type differs from the
    # per-image TileSchedule entries under the same digest.
    key = schedule_cache_key(coords_digest(coords_i, grid), grid, m, cfg,
                             "dense")
    return cache.get_or_build(key, build)


@dataclasses.dataclass
class _BatchArtifacts:
    """Prepass products of one whole batch (batch-fused dispatch)."""

    scheds: list[DeviceSchedule]
    cache_hits: list[bool | None]
    batch: Any                    # packing.BatchDispatch (None if sharded)
    idx: torch.Tensor             # (N*T, p_pad, KK, 4) plane-global
    coeff: torch.Tensor           # (N*T, p_pad, KK, 4)
    schedule_s: float = 0.0
    schedule_device_s: float = 0.0
    shard: Any = None             # shard.ShardedDispatch when sharded


def _pipeline_batch_prepass(coords: torch.Tensor, grid: TileGrid, m: int,
                            p_pad: int, cfg: PipelineConfig,
                            tracer: Tracer | None = None,
                            plan: ShardPlan | None = None) -> _BatchArtifacts:
    """Whole-batch prepass: per-image dense schedules (cached; a partial
    batch hit skips scheduling for the hit images) concatenated into one
    batch grid, plus the plane-ordered packed operands. With a shard
    ``plan`` the schedules concatenate per shard instead (each shard
    keeps its own ragged padding)."""
    tr = tracer if tracer is not None else get_tracer()
    n = coords.shape[0]
    cache = default_schedule_cache() if cfg.use_schedule_cache else None
    with tr.timed("prepass.schedule", backend=cfg.schedule_backend,
                  batch=n) as ssp:
        scheds, hits = [], []
        for i in range(n):
            if cfg.faults is not None:
                cfg.faults.check("prepass", image=i)
            ds, hit = build_dense_schedule(coords[i], grid, m, cfg, cache)
            scheds.append(ds)
            hits.append(hit)
        if plan is None:
            batch, shard = pack_batch_schedules(
                scheds, grid.num_tiles, grid.num_tiles, coords.device), None
        else:
            batch, shard = None, shard_batch_schedules(
                scheds, grid.num_tiles, grid.num_tiles, plan, coords.device)
    schedule_s = ssp.dur
    if cache is not None:
        cache.note_batch_assembly(sum(bool(h) for h in hits),
                                  images=len(hits))
    with tr.span("pack", dispatch="batch_fused", batch=n):
        idx, coeff = pack_plane_operands(coords, grid, p_pad)
    kk = coords.shape[3]
    device = cfg.schedule_backend == "device" and cfg.schedule == "alg1"
    return _BatchArtifacts(
        scheds=scheds, cache_hits=hits, batch=batch,
        idx=idx.reshape(n * grid.num_tiles, p_pad, kk, 4),
        coeff=coeff.reshape(n * grid.num_tiles, p_pad, kk, 4),
        schedule_s=schedule_s,
        schedule_device_s=schedule_s if device else 0.0, shard=shard)


def _pipeline_batch_exec(x: torch.Tensor, art: _BatchArtifacts,
                         w2: torch.Tensor, b: torch.Tensor,
                         cfg: PipelineConfig, grid: TileGrid, m: int,
                         trace: PipelineTrace, return_trace: bool,
                         mesh=None, plan: ShardPlan | None = None
                         ) -> torch.Tensor:
    n, h, w, c = x.shape
    tp = grid.th * grid.tw
    t = grid.num_tiles
    c_out = w2.shape[-1]
    if cfg.faults is not None:
        cfg.faults.check("dispatch", images=n)
    x_tiles = plane_to_tiles(x, grid).reshape(n * t, tp, c).contiguous()
    if plan is None:
        y_rows = dcn_fused_batch(x_tiles, art.batch.row_id,
                                 art.batch.dep_glb, art.batch.dep_cnt,
                                 art.idx, art.coeff, w2, b, t_in=t)[:, :tp]
        # Scatter valid rows back to (image, tile) order; ragged-padding
        # rows land in a dump row that is dropped.
        target = torch.where(art.batch.oid >= 0, art.batch.row_id,
                             torch.full_like(art.batch.row_id, n * t)).long()
        y_all = torch.zeros((n * t + 1, tp, c_out), dtype=x.dtype,
                            device=x.device)
        y_all[target] = y_rows.to(x.dtype)
        y_flat = y_all[:-1]
    else:
        sh = art.shard
        y_rows = dcn_fused_batch_sharded(
            stack_rows(x_tiles, plan, t), sh.row_id, sh.dep_glb, sh.dep_cnt,
            stack_rows(art.idx, plan, t), stack_rows(art.coeff, plan, t),
            w2, b, mesh=mesh, t_in=t, sizes=plan.sizes)[:, :, :tp]
        y_flat = scatter_shard_rows(y_rows.to(x.dtype), sh, plan, t)
        trace.allgather_bytes += allgather_nbytes(y_flat)
        trace.shards = plan.n_shards
    y = tiles_to_plane(y_flat.reshape(n, t, tp, c_out), grid, h, w)

    trace.batch_dispatches += 1
    tile_bytes = tp * c * x.element_size()
    for i in range(n):
        im = ImageTrace(grid=grid, tile_bytes=tile_bytes, buffer_tiles=m,
                        schedule=cfg.schedule,
                        schedule_cache_hit=art.cache_hits[i],
                        dispatch="batch_fused",
                        schedule_backend=cfg.schedule_backend,
                        batch_rows=(i * t, (i + 1) * t))
        if return_trace:
            # Host assembly for traces only. buffer_bytes uses the
            # schedule's own padded dep count, as the per-image path
            # does, not DeviceSchedule.k_pad (pow2_pad(num_tiles)).
            sched = art.scheds[i].to_host()
            k_pad = pow2_pad(max((len(d) for d in sched.iid), default=1))
            buffer_bytes = k_pad * tp * c * x.element_size()
            for out_tile, deps in zip(sched.oid, sched.iid):
                im.records.append(TileRecord(
                    out_tile=out_tile, dep_tiles=tuple(deps),
                    loaded_bytes=len(deps) * tile_bytes,
                    buffer_bytes=buffer_bytes))
        trace.images.append(im)
    return y.contiguous()


def dcn_pipeline(x: torch.Tensor, params: DeformableConvParams, *,
                 kernel_size: int = 3, variant: str = "dcn2",
                 max_displacement: float | None = None,
                 tile: int | tuple[int, int] = 8,
                 buffer_tiles: int | None = None, schedule: str = "alg1",
                 block_p: int = 128, return_trace: bool = False,
                 config: PipelineConfig | None = None,
                 tracer: Tracer | None = None):
    """Scheduler-driven deformable conv over a batch: (N,H,W,C) ->
    (N,H,W,O), on ``x``'s device (the params must live there too).

    Per image: stage-1 offsets -> coords -> TDT -> Algorithm-1 schedule
    -> fused-kernel execution (one schedule launch per image by default,
    per-tile launches with ``dispatch="per_tile"``, one launch for the
    batch with ``"batch_fused"``) -> scatter. Numerically matches
    ``core.deform.deformable_conv2d`` to float tolerance; also returns a
    :class:`PipelineTrace` of the packed-tile traffic with
    ``return_trace``. ``config`` overrides the executor keywords.
    """
    cfg = config or PipelineConfig(tile=tile, buffer_tiles=buffer_tiles,
                                   schedule=schedule, block_p=block_p)
    tr = tracer if tracer is not None else get_tracer()
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    th, tw = cfg.tile_hw
    if th > h or tw > w:
        raise ValueError(
            f"tile {th}x{tw} exceeds the {h}x{w} feature plane — choose "
            f"tile sides <= the plane")
    kk = kernel_size * kernel_size
    c_out = params.w.shape[-1]

    offsets = conv2d(x, params.w_off, params.b_off)               # Eq. 1
    coords = offsets_to_coords(offsets.float(), kernel_size, variant,
                               max_displacement).contiguous()
    w2 = params.w.reshape(kk, x.shape[-1], c_out).contiguous()
    b = params.b.contiguous()

    trace = PipelineTrace()
    if n == 0:
        y = torch.zeros(tuple(x.shape[:3]) + (c_out,), dtype=x.dtype,
                        device=x.device)
        return (y, trace) if return_trace else y
    if cfg.autotune != "off":
        # Single layer, nothing to cut: the search degenerates to the
        # tile shape with the least simulated DRAM (first image's coords
        # as the representative input; winner cached per layer
        # geometry, so later batches skip straight to it).
        from repro_torch.tuning import resolve_tuned_tile
        tt = resolve_tuned_tile(
            coords[0], h, w, c_in=int(x.shape[-1]), c_out=int(c_out),
            kernel_size=kernel_size, autotune=cfg.autotune,
            dtype_bytes=x.element_size(), tile_hw=(th, tw),
            buffer_tiles=cfg.buffer_tiles, schedule=cfg.schedule,
            budget=cfg.autotune_budget,
            plan_cache_dir=cfg.plan_cache_dir, tracer=tr)
        if tt is not None:
            th, tw = tt
    grid = TileGrid(h, w, th, tw)
    tp = grid.th * grid.tw
    m = grid.num_tiles if cfg.buffer_tiles is None else cfg.buffer_tiles
    bp = min(cfg.block_p, tp)
    p_pad = tp if tp % bp == 0 else round_up(tp, cfg.block_p)

    if cfg.dispatch == "batch_fused":
        # One batch-level prepass replaces the per-image staging loop: the
        # whole batch's schedules concatenate into ONE kernel dispatch (one
        # per shard when a mesh shards the batch axis).
        mesh = resolve_shard_mesh(cfg.mesh, cfg.data_parallel)
        plan = (plan_batch_shards(n, mesh.shape["data"])
                if mesh is not None else None)
        with tr.timed("prepass", batch=n) as psp:
            art = _pipeline_batch_prepass(coords, grid, m, p_pad, cfg,
                                          tracer=tr, plan=plan)
        trace.overlap.add_span(psp)
        trace.overlap.prepass_wait_s += psp.dur
        trace.overlap.schedule_s += art.schedule_s
        trace.overlap.schedule_device_s += art.schedule_device_s
        with use_tracer(tr):
            y = _pipeline_batch_exec(x, art, w2, b, cfg, grid, m, trace,
                                     return_trace, mesh=mesh, plan=plan)
        return (y, trace) if return_trace else y

    def prepass(i: int) -> _ImageArtifacts:
        if cfg.faults is not None:
            cfg.faults.check("prepass", image=i)
        return _pipeline_prepass(coords[i], grid, m, p_pad, cfg, tracer=tr)

    def execute(i: int, art: _ImageArtifacts) -> torch.Tensor:
        if cfg.faults is not None:
            cfg.faults.check("dispatch", image=i)
        with use_tracer(tr):
            y_i, im_tr = _pipeline_exec(x[i], art, w2, b, cfg, grid, m,
                                        p_pad)
        trace.overlap.schedule_s += art.schedule_s
        trace.overlap.schedule_device_s += art.schedule_device_s
        trace.images.append(im_tr)
        return y_i

    outs = run_staged(n, prepass, execute, cfg.staging_depth,
                      trace.overlap, tracer=tr, watchdog_s=cfg.watchdog_s,
                      faults=cfg.faults)
    y = torch.stack(outs).contiguous()
    return (y, trace) if return_trace else y
