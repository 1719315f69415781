"""Memory-traffic + DRAM-energy simulator for deformable convolution.

Reproduces the paper's evaluation methodology (§V):

  * DRAM traffic is counted in tile loads under a FIFO-replacement on-chip
    buffer (the paper's input buffer, Table I: 128 KB), for the three
    strategies of Fig. 14/16:
       - ``naive``      : "W/O bit vector"  — per-output-feature demand
                          loading; no tile-level dependency dedup.
       - ``bitvec``     : "W/ bit vector + W/O scheduling" — sequential
                          output tiles, per-tile deduplicated loads.
       - ``scheduled``  : "W/ bit vector + W/ scheduling" — Algorithm 1.
  * DRAM energy follows Micron's power-calculator methodology the paper
    cites (Table II): per-access energies for ACT/RD/WR/IO plus a
    background-power term over the execution time.
  * Fusion accounting (§IV-D, Fig. 18): without BLI(+)conv fusion the
    deformed-feature intermediate — K*K x the input feature map — is
    written to and read back from DRAM; with fusion it never leaves
    on-chip buffers.

All byte counts are exact functions of the schedule; the energy constants
are the paper's Table II. Execution-time modelling for the platform
comparison lives in ``benchmarks/bench_platforms.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scheduler import (FifoBuffer, TileSchedule, schedule_tiles,
                        sequential_schedule)
from .tiles import TileGrid, compose_tdt_chain

# ---------------------------------------------------------------------------
# DRAM energy model (paper Table II, Micron DDR3 power calculator)
# ---------------------------------------------------------------------------

# Power in mW at DDR3-1600 (800 MHz IO clock), per Table II.
P_ACT_MW = 63.7
P_RD_MW = 52.1
P_WR_MW = 52.1
P_READ_IO_MW = 32.7
P_WRITE_ODT_MW = 136.1
P_BG_MW = 67.7

# DDR3-1600 x16: peak 12.8 GB/s. Energy/byte = P / BW for the dynamic
# terms that scale with traffic; BG power integrates over wall time.
_DDR_BW_BYTES_PER_S = 12.8e9


@dataclass(frozen=True)
class DramEnergyModel:
    """Per-byte dynamic energies (pJ/B) + background power (W)."""

    read_pj_per_byte: float = ((P_ACT_MW + P_RD_MW + P_READ_IO_MW)
                               / 1e3 / _DDR_BW_BYTES_PER_S * 1e12)
    write_pj_per_byte: float = ((P_ACT_MW + P_WR_MW + P_WRITE_ODT_MW)
                                / 1e3 / _DDR_BW_BYTES_PER_S * 1e12)
    background_w: float = P_BG_MW / 1e3

    def energy_j(self, read_bytes: float, write_bytes: float,
                 exec_time_s: float) -> float:
        return (self.read_pj_per_byte * read_bytes * 1e-12
                + self.write_pj_per_byte * write_bytes * 1e-12
                + self.background_w * exec_time_s)


# ---------------------------------------------------------------------------
# Traffic simulation
# ---------------------------------------------------------------------------


@dataclass
class TrafficReport:
    strategy: str
    tile_loads: int            # input tiles fetched from DRAM
    reuse_hits: int            # on-chip tile reuse events
    input_read_bytes: int      # tile_loads * tile_bytes
    intermediate_bytes: int    # deformed-feature DRAM round trip (0 if fused)
    output_write_bytes: int
    weight_read_bytes: int

    @property
    def total_dram_bytes(self) -> int:
        return (self.input_read_bytes + self.intermediate_bytes
                + self.output_write_bytes + self.weight_read_bytes)


def _replay(schedule: TileSchedule, buffer_tiles: int) -> FifoBuffer:
    buf = FifoBuffer(buffer_tiles)
    for loads in schedule.iid:
        for t in loads:
            buf.touch(t)
    return buf


def simulate_naive(per_pixel_tiles: np.ndarray,
                   buffer_tiles: int) -> FifoBuffer:
    """'W/O bit vector': output features execute in raster order and demand
    their input tiles one by one — no output-tile-level dedup is possible
    because the overall dependency information is unknown.

    per_pixel_tiles: (H, W, KK, 4) int input-tile ids (from
    ``tiles.per_pixel_input_tiles``).
    """
    buf = FifoBuffer(buffer_tiles)
    flat = np.asarray(per_pixel_tiles).reshape(per_pixel_tiles.shape[0]
                                               * per_pixel_tiles.shape[1], -1)
    for px in flat:
        # within one output feature, the 4*KK accesses are served from the
        # currently-resident tiles (a single feature's working set).
        for t in dict.fromkeys(px.tolist()):
            buf.touch(t)
    return buf


def simulate_strategies(
    B: np.ndarray,
    per_pixel_tiles: np.ndarray,
    in_grid: TileGrid,
    channels: int,
    c_out: int,
    kernel_size: int,
    buffer_bytes: int,
    dtype_bytes: int = 1,
    fused: bool = True,
) -> dict[str, TrafficReport]:
    """Run all three strategies of paper Fig. 14/16 on one deformable conv.

    Returns a dict strategy -> TrafficReport. ``fused`` toggles the
    §IV-D BLI(+)conv fusion accounting for the deformed intermediate.
    """
    tile_bytes = in_grid.tile_bytes(channels, dtype_bytes)
    buffer_tiles = max(1, buffer_bytes // tile_bytes)
    h, w = in_grid.h, in_grid.w
    kk2 = kernel_size * kernel_size

    out_bytes = h * w * c_out * dtype_bytes
    weight_bytes = (kk2 * channels * c_out          # main conv
                    + kk2 * channels * 2 * kk2) * dtype_bytes  # offset conv
    inter_bytes = 0 if fused else 2 * h * w * kk2 * channels * dtype_bytes

    def report(name: str, buf: FifoBuffer) -> TrafficReport:
        return TrafficReport(
            strategy=name,
            tile_loads=buf.loads,
            reuse_hits=buf.hits,
            input_read_bytes=buf.loads * tile_bytes,
            intermediate_bytes=inter_bytes,
            output_write_bytes=out_bytes,
            weight_read_bytes=weight_bytes,
        )

    naive_buf = simulate_naive(per_pixel_tiles, buffer_tiles)
    bitvec_buf = _replay(sequential_schedule(B), buffer_tiles)
    sched_buf = _replay(schedule_tiles(B, buffer_tiles), buffer_tiles)

    return {
        "naive": report("naive", naive_buf),
        "bitvec": report("bitvec", bitvec_buf),
        "scheduled": report("scheduled", sched_buf),
    }


# ---------------------------------------------------------------------------
# Network-level traffic (cross-layer fusion, §IV-D taken network-wide)
# ---------------------------------------------------------------------------


@dataclass
class GroupTrafficReport:
    """Predicted DRAM traffic of one fused group (or its per-layer run)."""

    n_layers: int
    tile_loads: int            # input tiles fetched from DRAM
    reuse_hits: int
    input_read_bytes: int
    intermediate_bytes: int    # interior boundary-plane writes (0 if fused)
    output_write_bytes: int    # group output plane
    weight_read_bytes: int

    @property
    def total_dram_bytes(self) -> int:
        return (self.input_read_bytes + self.intermediate_bytes
                + self.output_write_bytes + self.weight_read_bytes)


@dataclass
class NetworkTrafficReport:
    """Whole-network traffic: per-group reports + dense boundary ops."""

    mode: str                  # "fused" | "layerwise"
    groups: list[GroupTrafficReport]
    boundary_bytes: int = 0    # pool/upsample plane read+write between groups

    @property
    def tile_loads(self) -> int:
        return sum(g.tile_loads for g in self.groups)

    @property
    def total_dram_bytes(self) -> int:
        return (sum(g.total_dram_bytes for g in self.groups)
                + self.boundary_bytes)


def _schedule_and_replay(B: np.ndarray, buffer_tiles: int,
                         schedule: str) -> FifoBuffer:
    if schedule == "alg1":
        sched = schedule_tiles(B, buffer_tiles)
    elif schedule == "sequential":
        sched = sequential_schedule(B)
    else:
        raise ValueError(f"unknown schedule: {schedule!r}")
    return _replay(sched, buffer_tiles)


def simulate_group(
    b_layers: list[np.ndarray],
    grid: TileGrid,
    layer_channels: list[tuple[int, int]],
    weight_bytes: int,
    buffer_tiles: int,
    dtype_bytes: int = 1,
    fused: bool = True,
    schedule: str = "alg1",
) -> GroupTrafficReport:
    """Predict one group's DRAM traffic from its per-layer TDTs.

    ``fused=True`` runs ONE Algorithm-1 schedule over the composite TDT
    (``compose_tdt`` chained over the group's layers): only group-input
    tiles are fetched and interior planes stay on-chip. ``fused=False``
    models the per-layer execution of the same layers: each layer is
    scheduled on its own TDT, and every interior boundary plane is written
    to DRAM (its read-back is the next layer's tile loads).
    """
    if len(b_layers) != len(layer_channels):
        raise ValueError("need one (c_in, c_out) pair per layer TDT")
    h, w = grid.h, grid.w
    if fused:
        comp = compose_tdt_chain(b_layers)
        buf = _schedule_and_replay(comp, buffer_tiles, schedule)
        loads, hits = buf.loads, buf.hits
        input_bytes = loads * grid.tile_bytes(layer_channels[0][0],
                                              dtype_bytes)
        inter_bytes = 0
    else:
        loads = hits = input_bytes = 0
        for b, (c_in, _) in zip(b_layers, layer_channels):
            buf = _schedule_and_replay(np.asarray(b, bool), buffer_tiles,
                                       schedule)
            loads += buf.loads
            hits += buf.hits
            input_bytes += buf.loads * grid.tile_bytes(c_in, dtype_bytes)
        inter_bytes = sum(h * w * c_out * dtype_bytes
                          for _, c_out in layer_channels[:-1])
    return GroupTrafficReport(
        n_layers=len(b_layers),
        tile_loads=loads,
        reuse_hits=hits,
        input_read_bytes=input_bytes,
        intermediate_bytes=inter_bytes,
        output_write_bytes=h * w * layer_channels[-1][1] * dtype_bytes,
        weight_read_bytes=weight_bytes,
    )


def simulate_network(group_specs: list[dict], boundary_bytes: int = 0,
                     fused: bool = True) -> NetworkTrafficReport:
    """Network-level §IV-D accounting over pre-built group specs.

    Each spec is a kwargs dict for :func:`simulate_group` (without
    ``fused``). The executor trace (``runtime.trace.NetworkTrace``) must
    match the ``fused=True`` prediction exactly — bench_graph asserts it.
    """
    reports = [simulate_group(fused=fused, **spec) for spec in group_specs]
    return NetworkTrafficReport(mode="fused" if fused else "layerwise",
                                groups=reports, boundary_bytes=boundary_bytes)


def dram_energy(report: TrafficReport, exec_time_s: float,
                model: DramEnergyModel | None = None) -> float:
    """Joules for one layer's DRAM traffic under the Table II model."""
    model = model or DramEnergyModel()
    reads = report.input_read_bytes + report.weight_read_bytes \
        + report.intermediate_bytes // 2
    writes = report.output_write_bytes + report.intermediate_bytes // 2
    return model.energy_j(reads, writes, exec_time_s)
