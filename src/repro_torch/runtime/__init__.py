"""Tile-pipeline + network-graph runtime — the paper's execution paths.

Per-layer pipeline (``dcn_pipeline``), per batch element and layer:

  stage 1   offset conv -> sampling coordinates      (core.deform)
  TDT       coords -> tile dependency table          (core.tiles)
  schedule  Algorithm 1 / sequential ordering        (core.scheduler)
  pack      halo/dependent input tiles + per-pixel
            (idx, coeff) tensors, padded for shapes
            not divisible by the tile size           (runtime.packing)
  execute   fused BLI(+)conv CUDA kernel over the
            schedule, scattered back into the
            (N, H, W, C_out) output                  (kernels.dcn_fused)

Network-graph executor (§IV-D network-wide): a graph IR over the model
backbone (runtime.graph) is partitioned into cross-layer fused groups —
greedily, or along an autotuned plan (``repro_torch.tuning``); each group
runs ONE Algorithm-1 schedule over a composite TDT chained through its
layers, in the ``batch_fused`` (the serving path), ``batched`` or
``per_tile`` dispatch mode (runtime.fused_exec). ``batch_fused`` can
shard the batch axis over the devices of a mesh (runtime.shard). Schedules are memoized
in an LRU keyed on quantized coordinates (runtime.cache).

Executors emit traces (runtime.trace) whose byte counts equal the
DRAM-traffic simulator's exactly.
"""

from repro_torch.runtime.cache import ScheduleCache, default_schedule_cache
from repro_torch.runtime.fused_exec import (
    GraphConfig,
    TileBuffer,
    run_graph,
    run_graph_dense,
)
from repro_torch.runtime.graph import (
    ConvNode,
    DeformNode,
    FusedGroup,
    NetGraph,
    PoolNode,
    UpsampleNode,
    build_graph,
    partition_graph,
    partition_graph_cached,
    partition_graph_tuned,
)
from repro_torch.runtime.packing import (
    BatchDispatch,
    NeighbourTables,
    build_neighbour_tables,
    pack_batch_schedules,
    pack_output_tile,
    pack_plane_operands,
    pack_schedule_tiles,
    plane_to_tiles,
)
from repro_torch.runtime.pipeline import (
    PipelineConfig,
    clamp_tile_config,
    dcn_pipeline,
)
from repro_torch.runtime.shard import (
    ShardPlan,
    plan_batch_shards,
    resolve_shard_mesh,
)
from repro_torch.runtime.trace import (
    GroupTrace,
    ImageTrace,
    LatencyStats,
    LayerBufferStats,
    NetworkTrace,
    OverlapSpans,
    PipelineTrace,
    TileRecord,
)

__all__ = [
    "BatchDispatch",
    "NeighbourTables",
    "build_neighbour_tables",
    "pack_batch_schedules",
    "pack_output_tile",
    "pack_plane_operands",
    "pack_schedule_tiles",
    "plane_to_tiles",
    "PipelineConfig",
    "dcn_pipeline",
    "ScheduleCache",
    "default_schedule_cache",
    "ShardPlan",
    "plan_batch_shards",
    "resolve_shard_mesh",
    "GraphConfig",
    "TileBuffer",
    "clamp_tile_config",
    "run_graph",
    "run_graph_dense",
    "ConvNode",
    "DeformNode",
    "FusedGroup",
    "NetGraph",
    "PoolNode",
    "UpsampleNode",
    "build_graph",
    "partition_graph",
    "partition_graph_cached",
    "partition_graph_tuned",
    "GroupTrace",
    "ImageTrace",
    "LatencyStats",
    "LayerBufferStats",
    "NetworkTrace",
    "OverlapSpans",
    "PipelineTrace",
    "TileRecord",
]
