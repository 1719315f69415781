"""Execution traces of the tile-pipeline and network-graph executors.

The trace is the executor-side counterpart of the DRAM-traffic simulator
(``repro_torch.core.simulator``): where the simulator *predicts* tile
loads from the TDT and a FIFO buffer model, the trace records what the
executor *actually packed and dispatched*. Replaying the recorded load
sequence through the same ``FifoBuffer`` must reproduce the simulator's
scheduled tile-load count exactly — ``tests/test_torch_*.py`` and
``chip_smoke.py`` assert it for the per-layer pipeline
(``PipelineTrace``) and the cross-layer fused groups (``GroupTrace`` /
``NetworkTrace``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.scheduler import FifoBuffer
from repro_torch.core.tiles import TileGrid
from repro_torch.obs import Histogram


@dataclass(frozen=True)
class TileRecord:
    """One schedule entry as executed: output tile + what was packed."""

    out_tile: int
    dep_tiles: tuple[int, ...]   # input tiles packed, in load order
    loaded_bytes: int            # len(dep_tiles) * tile_bytes (no reuse)
    buffer_bytes: int            # padded on-chip packed buffer (S * C * b)


@dataclass
class ImageTrace:
    """Trace of one batch element through one deformable layer."""

    grid: TileGrid
    tile_bytes: int              # one input tile, in the executed dtype
    buffer_tiles: int            # M used for scheduling
    schedule: str                # "alg1" | "sequential"
    records: list[TileRecord] = field(default_factory=list)
    # None = schedule cache disabled for this image; True/False = hit/miss.
    schedule_cache_hit: bool | None = None
    # Kernel-dispatch accounting: host-issued compute dispatches (fused
    # kernel calls + halo convs). Per-tile dispatch pays one per schedule
    # entry; batched grid dispatch pays one per layer segment; batch-fused
    # dispatches are shared by the whole batch and counted ONCE on the
    # enclosing PipelineTrace/NetworkTrace (``batch_dispatches``), so this
    # stays 0 for "batch_fused" images.
    kernel_dispatches: int = 0
    dispatch: str = "per_tile"   # "per_tile" | "batched" | "batch_fused"
    # Which scheduler built this image's TDT + Algorithm-1 order:
    # "host" = numpy reference loop, "device" = CUDA kernels.
    schedule_backend: str = "host"
    # batch-fused dispatch only: this image's (start, stop) row span in
    # the concatenated batch grid — its per-image slice of the single
    # fused dispatch. Grid order within the span is the image's own
    # schedule order, so ``records`` (and the simulator cross-check)
    # are unchanged vs per-image dispatch.
    batch_rows: tuple[int, int] | None = None

    @property
    def packed_tile_loads(self) -> int:
        """Input tiles packed with no cross-tile reuse (upper bound)."""
        return sum(len(r.dep_tiles) for r in self.records)

    @property
    def packed_bytes(self) -> int:
        return sum(r.loaded_bytes for r in self.records)

    @property
    def max_buffer_bytes(self) -> int:
        return max((r.buffer_bytes for r in self.records), default=0)

    def fifo_replay(self, buffer_tiles: int | None = None) -> FifoBuffer:
        """Replay the executed load sequence through the FIFO buffer model.

        With ``buffer_tiles`` equal to the simulator's capacity this yields
        exactly the simulator's tile-load count for the same schedule.
        """
        buf = FifoBuffer(self.buffer_tiles if buffer_tiles is None
                         else buffer_tiles)
        for r in self.records:
            for t in r.dep_tiles:
                buf.touch(t)
        return buf


class LatencyStats(Histogram):
    """Per-request latency accounting of a serving engine.

    Samples are submit->result wall seconds (queueing delay + every
    serving step the request waited through + its own service time), so
    the tail percentiles reflect what a client actually observes under
    the arrival process — the serving counterpart of the per-call
    ``OverlapSpans``. A thin seconds-suffixed veneer over the telemetry
    :class:`~repro_torch.obs.Histogram`, so serving engines register it
    directly in their :class:`~repro_torch.obs.MetricsRegistry`.

    Edge cases are well-defined rather than index arithmetic: an empty
    snapshot reports ``None`` mean/percentiles, a single sample reports
    that sample.
    """

    def __init__(self, samples_s=None):
        super().__init__(name="latency_s",
                         help="submit->result request latency (s)")
        for v in (samples_s or ()):
            self.observe(float(v))

    def add(self, latency_s: float) -> None:
        self.observe(float(latency_s))

    @property
    def samples_s(self) -> list[float]:
        return self.samples

    @property
    def mean_s(self) -> float | None:
        """Mean latency in seconds (None with no samples)."""
        return self.mean

    def percentile_s(self, q: float) -> float | None:
        """q-th percentile latency in seconds; None with no samples,
        the sample itself with exactly one."""
        return self.percentile(q)

    def summary(self) -> dict:
        """The stats block serving engines and benchmarks report."""
        return {
            "count": self.count,
            "mean_s": self.mean_s,
            "p50_s": self.percentile_s(50.0),
            "p95_s": self.percentile_s(95.0),
            "p99_s": self.percentile_s(99.0),
        }

    render = summary


@dataclass
class OverlapSpans:
    """Host-prepass vs device-execution overlap accounting of one executor
    call (the multi-image staging queue): how much of the host-side
    prepass (stage-1 offsets, TDT build, schedule, packing) was hidden
    under device execution of earlier images.

    No longer measured with bespoke timer bookkeeping: the executors
    record ``prepass`` / ``prepass.wait`` / ``prepass.schedule`` spans
    through the telemetry tracer (``repro_torch.obs``) and this accounting is
    re-derived from those spans via :meth:`add_span` /
    :meth:`from_spans` — the trace fields are sums of span durations.
    """

    prepass_s: float = 0.0       # total host prepass wall time
    prepass_wait_s: float = 0.0  # prepass time the execute loop blocked on
    # Scheduling-stage split of the prepass: how much of it was the
    # TDT + Algorithm-1 build, and how much of *that* ran through the
    # on-device scheduler ("schedule_backend": "device") rather than the
    # host Python loop. With the device backend the staging thread
    # shrinks to packing only.
    schedule_s: float = 0.0          # TDT + schedule build wall time
    schedule_device_s: float = 0.0   # portion served by the device path

    # Span name -> accumulated field; "prepass.schedule" additionally
    # feeds schedule_device_s when its backend attr is "device".
    SPAN_FIELDS = {"prepass": "prepass_s",
                   "prepass.wait": "prepass_wait_s",
                   "prepass.schedule": "schedule_s"}

    def add_span(self, span) -> None:
        """Fold one tracer span (or measured ``timed`` handle) into the
        accounting; spans with unrelated names are ignored."""
        field_name = self.SPAN_FIELDS.get(span.name)
        if field_name is None:
            return
        setattr(self, field_name, getattr(self, field_name) + span.dur)
        if (span.name == "prepass.schedule"
                and span.attrs.get("backend") == "device"):
            self.schedule_device_s += span.dur

    @classmethod
    def from_spans(cls, spans) -> "OverlapSpans":
        """Re-derive the whole accounting from a span sequence."""
        o = cls()
        for s in spans:
            o.add_span(s)
        return o

    def merge(self, other: "OverlapSpans") -> None:
        """Accumulate another call's accounting (serving engines fold
        per-step traces into engine totals)."""
        self.prepass_s += other.prepass_s
        self.prepass_wait_s += other.prepass_wait_s
        self.schedule_s += other.schedule_s
        self.schedule_device_s += other.schedule_device_s

    @property
    def host_overlap_frac(self) -> float:
        """Fraction of prepass time hidden under execution (0 = serial)."""
        if self.prepass_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.prepass_wait_s / self.prepass_s)

    @property
    def schedule_device_frac(self) -> float:
        """Fraction of schedule-build time on the device backend."""
        if self.schedule_s <= 0:
            return 0.0
        return min(1.0, self.schedule_device_s / self.schedule_s)


@dataclass
class PipelineTrace:
    """Per-image traces of one ``dcn_pipeline`` call."""

    images: list[ImageTrace] = field(default_factory=list)
    overlap: OverlapSpans = field(default_factory=OverlapSpans)
    # Batch-fused dispatches: kernel calls shared by the WHOLE batch
    # (one per layer segment), counted here instead of per image.
    batch_dispatches: int = 0
    # Batch-axis scale-out: mesh shards the dispatch ran over, and the
    # measured byte volume of the single logits all-gather (0 when
    # single-device). Collective traffic, so NOT part of the per-image
    # DRAM model the simulator cross-checks.
    shards: int = 1
    allgather_bytes: int = 0

    @property
    def packed_bytes(self) -> int:
        return sum(im.packed_bytes for im in self.images)

    @property
    def kernel_dispatches(self) -> int:
        return (self.batch_dispatches
                + sum(im.kernel_dispatches for im in self.images))

    @property
    def dispatches_per_batch(self) -> int:
        """Host-issued dispatches of this call — for batch-fused mode the
        whole call is one batch, so this equals ``kernel_dispatches``."""
        return self.kernel_dispatches

    @property
    def host_overlap_frac(self) -> float:
        return self.overlap.host_overlap_frac

    @property
    def schedule_device_frac(self) -> float:
        return self.overlap.schedule_device_frac

    @property
    def packed_tile_loads(self) -> int:
        return sum(im.packed_tile_loads for im in self.images)

    @property
    def schedule_cache_hits(self) -> int:
        return sum(im.schedule_cache_hit is True for im in self.images)

    @property
    def schedule_cache_misses(self) -> int:
        return sum(im.schedule_cache_hit is False for im in self.images)

    def fifo_loads(self, buffer_tiles: int | None = None) -> int:
        return sum(im.fifo_replay(buffer_tiles).loads for im in self.images)


# ---------------------------------------------------------------------------
# Network-graph executor traces (cross-layer fused groups)
# ---------------------------------------------------------------------------


@dataclass
class LayerBufferStats:
    """On-chip accounting of one layer's output-tile buffer inside a fused
    group: intermediates never touch DRAM, so the only costs are the
    bounded resident footprint and recomputes after eviction."""

    kind: str                    # "conv" | "deform"
    tiles_computed: int = 0      # dispatches (first computes + recomputes)
    recomputes: int = 0          # tiles evicted then produced again
    max_resident_bytes: int = 0  # tile-buffer high-water mark


@dataclass
class GroupTrace(ImageTrace):
    """One fused group of one batch element as executed.

    ``records`` holds the group-level schedule: per composite-schedule
    entry, the *group-input* tiles in load order — ``fifo_replay`` of that
    sequence must equal the network simulator's fused prediction exactly.
    ``b_layers`` keeps the per-layer TDTs the schedule was built from so
    the simulator cross-check consumes byte-identical inputs.
    """

    image: int = 0
    group: int = 0
    dtype_bytes: int = 4
    layer_channels: list[tuple[int, int]] = field(default_factory=list)
    output_bytes: int = 0        # group output plane write
    weight_bytes: int = 0
    layer_stats: list[LayerBufferStats] = field(default_factory=list)
    b_layers: list[np.ndarray] = field(default_factory=list)

    @property
    def input_load_bytes(self) -> int:
        return self.fifo_replay().loads * self.tile_bytes

    @property
    def total_dram_bytes(self) -> int:
        # Interior planes contribute nothing: that is the fusion.
        return self.input_load_bytes + self.output_bytes + self.weight_bytes

    @property
    def total_recomputes(self) -> int:
        return sum(s.recomputes for s in self.layer_stats)

    @property
    def max_resident_bytes(self) -> int:
        return max((s.max_resident_bytes for s in self.layer_stats),
                   default=0)


@dataclass
class NetworkTrace:
    """Trace of one ``run_graph`` call: all groups of all batch elements,
    plus the dense boundary ops (pool/upsample) between groups."""

    groups: list[GroupTrace] = field(default_factory=list)
    boundary_bytes: int = 0      # pool/upsample plane read+write traffic
    overlap: OverlapSpans = field(default_factory=OverlapSpans)
    # Batch-fused dispatches: kernel calls shared by the WHOLE batch
    # (one per layer segment), counted here instead of per group trace.
    batch_dispatches: int = 0
    # Batch-axis scale-out: mesh shards the dispatch ran over, and the
    # measured byte volume of the single logits all-gather (0 when
    # single-device). Collective traffic, so NOT part of the per-image
    # DRAM model the simulator cross-checks.
    shards: int = 1
    allgather_bytes: int = 0

    @property
    def kernel_dispatches(self) -> int:
        return (self.batch_dispatches
                + sum(g.kernel_dispatches for g in self.groups))

    @property
    def dispatches_per_batch(self) -> int:
        """Host-issued dispatches of this call — for batch-fused mode the
        whole call is one batch, so this equals ``kernel_dispatches``."""
        return self.kernel_dispatches

    @property
    def host_overlap_frac(self) -> float:
        return self.overlap.host_overlap_frac

    @property
    def schedule_device_frac(self) -> float:
        return self.overlap.schedule_device_frac

    @property
    def input_load_bytes(self) -> int:
        return sum(g.input_load_bytes for g in self.groups)

    @property
    def output_write_bytes(self) -> int:
        return sum(g.output_bytes for g in self.groups)

    @property
    def weight_read_bytes(self) -> int:
        return sum(g.weight_bytes for g in self.groups)

    @property
    def total_dram_bytes(self) -> int:
        return (self.input_load_bytes + self.output_write_bytes
                + self.weight_read_bytes + self.boundary_bytes)

    @property
    def schedule_cache_hits(self) -> int:
        return sum(g.schedule_cache_hit is True for g in self.groups)

    @property
    def schedule_cache_misses(self) -> int:
        return sum(g.schedule_cache_hit is False for g in self.groups)

    @property
    def total_recomputes(self) -> int:
        return sum(g.total_recomputes for g in self.groups)
