"""Runtime tile scheduler — paper §IV-C, Algorithm 1, Fig. 10.

The host half is a copy of the JAX package's numpy reference:
``output_tile_scheduling`` greedily picks the un-executed output tile whose
input-tile dependency vector overlaps most with the current one;
``input_tile_scheduling`` orders the next tile's dependent input tiles in
three priority classes (resident, everything else, shared-with-current);
the on-chip input buffer uses FIFO replacement.

``schedule_arrays_device`` runs the same selection on the card through the
greedy CUDA kernel (``repro_torch.kernels.dcn_schedule``) and emits the
schedule directly as dispatch arrays, bit-exact with the host loop;
``schedule_tiles(..., backend="device")`` runs it and assembles the
classic ``TileSchedule`` on the host (the per-image executors).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.dcn_schedule import (dispatch_arrays_from_klass,
                                              greedy_schedule_arrays)
from repro_torch.obs import default_registry

# Host-side schedule constructions the hot path depends on. With
# ``schedule_backend="device"`` the batch-fused executor builds none: the
# greedy kernel's arrays flow straight into the dispatch operands.
host_schedule_builds = default_registry().counter(
    "host_schedule_builds",
    help="host-side TileSchedule constructions (0 on the device "
         "scheduling hot path)")
# ``DeviceSchedule.to_host`` assemblies for traces and simulator
# cross-checks. They run after a segment's dispatch and feed no kernel,
# so they are counted apart from the builds above.
trace_schedule_assemblies = default_registry().counter(
    "trace_schedule_assemblies",
    help="DeviceSchedule.to_host() assemblies for traces (off the "
         "dispatch path)")


def pow2_pad(x: int) -> int:
    """Smallest power of two >= max(1, x) — the packed dep-slot padding."""
    return 1 << (max(1, x) - 1).bit_length()


@dataclass
class TileSchedule:
    """Result of Algorithm 1.

    oid:  execution order of output tiles (len = #output tiles with deps).
    iid:  per scheduled output tile, the ordered list of its dependent
          input tiles (priority classes already applied).
    """

    oid: list[int]
    iid: list[list[int]]
    reuse_overlap: list[int] = field(default_factory=list)

    def dense(self, k_pad: int | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(oid (T,), deps (T, k_pad) zero-padded, counts (T,)) int32."""
        t = len(self.oid)
        k_max = max((len(d) for d in self.iid), default=1)
        if k_pad is None:
            k_pad = pow2_pad(k_max)
        elif k_pad < k_max:
            raise ValueError(f"k_pad={k_pad} below max dep count {k_max}")
        oid = np.asarray(self.oid, np.int32).reshape(t)
        deps = np.zeros((t, k_pad), np.int32)
        counts = np.zeros((t,), np.int32)
        for n, d in enumerate(self.iid):
            deps[n, :len(d)] = d
            counts[n] = len(d)
        return oid, deps, counts


class FifoBuffer:
    """FIFO-replacement on-chip tile buffer model (capacity = M tiles)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("buffer capacity must be >= 1 tile")
        self.capacity = int(capacity)
        self.queue: list[int] = []  # front = oldest
        self.resident: set[int] = set()
        self.loads = 0
        self.hits = 0

    def touch(self, tile: int) -> bool:
        """Access ``tile``; load it if absent. Returns True on a hit."""
        if tile in self.resident:
            self.hits += 1
            return True
        self.loads += 1
        if len(self.queue) >= self.capacity:
            evicted = self.queue.pop(0)
            self.resident.discard(evicted)
        self.queue.append(tile)
        self.resident.add(tile)
        return False

    def occupancy_vector(self, n: int) -> np.ndarray:
        oc = np.zeros(n, dtype=bool)
        oc[list(self.resident)] = True
        return oc


def _to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _ids_of(vec: np.ndarray) -> list[int]:
    return np.flatnonzero(vec).tolist()


def output_tile_scheduling(B: np.ndarray, os_mask: np.ndarray,
                           curr_id: int) -> int:
    """Algorithm 1, output_tile_scheduling: first maximum overlap wins."""
    overlap = (B & B[curr_id]).sum(axis=1)
    overlap[~os_mask] = -1
    return int(np.argmax(overlap))


def input_tile_scheduling(B: np.ndarray, curr_id: int, next_id: int,
                          oc: np.ndarray) -> list[int]:
    """Algorithm 1, input_tile_scheduling (3 priority classes)."""
    loaded_vec = oc & B[next_id]
    last_load_vec = B[curr_id] & B[next_id] & ~loaded_vec
    seq_load_vec = B[next_id] & ~loaded_vec & ~last_load_vec
    return _ids_of(loaded_vec) + _ids_of(seq_load_vec) + _ids_of(last_load_vec)


def schedule_tiles(B, buffer_tiles: int, backend: str = "host", *,
                   device=None) -> TileSchedule:
    """Full Algorithm 1. B: (n_out, n_in) bool TDT; buffer_tiles: M, the
    on-chip input-buffer capacity in tiles. ``backend="host"`` runs the
    numpy loop below; ``"device"`` the greedy kernel on ``device`` (B's
    own device when B is a tensor), bit-exact with the host loop (see
    :func:`schedule_tiles_device`)."""
    if backend == "device":
        return schedule_tiles_device(B, buffer_tiles, device=device)
    if backend != "host":
        raise ValueError(f"unknown schedule backend: {backend!r}")
    B = _to_numpy(B).astype(bool)
    n_out, n_in = B.shape
    os_mask = B.any(axis=1)
    buf = FifoBuffer(buffer_tiles)

    first = int(np.argmax(np.where(os_mask, B.sum(axis=1), -1)))
    oid = [first]
    iid = [_ids_of(B[first])]
    overlaps: list[int] = []
    for t in iid[0]:
        buf.touch(t)
    os_mask[first] = False

    while os_mask.any():
        curr = oid[-1]
        nxt = output_tile_scheduling(B, os_mask, curr)
        oc = buf.occupancy_vector(n_in)
        order = input_tile_scheduling(B, curr, nxt, oc)
        oid.append(nxt)
        iid.append(order)
        overlaps.append(int((B[curr] & B[nxt]).sum()))
        for t in order:
            buf.touch(t)
        os_mask[nxt] = False

    host_schedule_builds.bump()
    return TileSchedule(oid=oid, iid=iid, reuse_overlap=overlaps)


def assemble_device_schedule(oid_seq, klass, overlap) -> TileSchedule:
    """A ``TileSchedule`` from the greedy kernel's dense outputs.

    oid_seq: (n_out,) int32 — scheduled tile per step, -1 once every
             dependent tile is done (a contiguous suffix).
    klass:   (n_out, n_in) int32 — per-step input priority class
             (0 loaded / 1 sequential / 2 shared-with-last / 3 non-dep);
             the load order is ids(0) ++ ids(1) ++ ids(2), each
             ascending, exactly ``input_tile_scheduling``'s classes.
    overlap: (n_out,) int32 — per-step reuse overlap.

    O(total deps) host bookkeeping; the selection ran on the device.
    """
    oid_seq = _to_numpy(oid_seq).reshape(-1)
    klass = _to_numpy(klass)
    overlap = _to_numpy(overlap).reshape(-1)
    n_sched = int((oid_seq >= 0).sum())
    iid = [np.flatnonzero(klass[t] == 0).tolist()
           + np.flatnonzero(klass[t] == 1).tolist()
           + np.flatnonzero(klass[t] == 2).tolist()
           for t in range(n_sched)]
    host_schedule_builds.bump()
    return TileSchedule(oid=oid_seq[:n_sched].tolist(), iid=iid,
                        reuse_overlap=overlap[1:n_sched].tolist())


def schedule_tiles_device(B, buffer_tiles: int, *,
                          device=None) -> TileSchedule:
    """Algorithm 1 through the greedy kernel, assembled on the host —
    bit-exact with :func:`schedule_tiles` (same first tile, first-max
    ties, priority classes and FIFO residency). ``device`` places a
    numpy ``B``; a tensor stays where it is."""
    bt = torch.as_tensor(B, device=device)
    oid_seq, klass, ovl = greedy_schedule_arrays(bt, int(buffer_tiles))
    return assemble_device_schedule(oid_seq, klass, ovl)


def sequential_schedule(B: np.ndarray) -> TileSchedule:
    """Ablation baseline 'W/ bit vector + W/O scheduling': output tiles in
    id order, each loading its dependent input tiles in ascending order."""
    B = _to_numpy(B).astype(bool)
    oid = [o for o in range(B.shape[0]) if B[o].any()]
    iid = [_ids_of(B[o]) for o in oid]
    host_schedule_builds.bump()
    return TileSchedule(oid=oid, iid=iid)


@dataclass
class DeviceSchedule:
    """Algorithm-1 schedule as dense dispatch-ready arrays, one row per
    possible scheduling step (``n_out`` rows):

      oid     (n_out,)        int32 — scheduled tile per step, -1 padding
      dep_tbl (n_out, k_pad)  int32 — dependent input tiles in load order
      dep_cnt (n_out,)        int32 — true dep count per step
      overlap (n_out,)        int32 — per-step reuse overlap diagnostic

    Arrays are tensors on the compute device (device backend) or numpy
    (host backend); both backends emit identical values. ``to_host()``
    assembles the classic ``TileSchedule`` for traces.
    """

    oid: Any
    dep_tbl: Any
    dep_cnt: Any
    overlap: Any
    _host: TileSchedule | None = None

    @property
    def n_rows(self) -> int:
        return int(self.oid.shape[0])

    @property
    def k_pad(self) -> int:
        return int(self.dep_tbl.shape[1])

    def to_host(self) -> TileSchedule:
        """Assemble (and memoize) the host ``TileSchedule`` — for traces
        and cross-checks, after the dispatch that used the arrays."""
        if self._host is None:
            oid = _to_numpy(self.oid).reshape(-1)
            dep = _to_numpy(self.dep_tbl)
            cnt = _to_numpy(self.dep_cnt).reshape(-1)
            ovl = _to_numpy(self.overlap).reshape(-1)
            n_sched = int((oid >= 0).sum())
            trace_schedule_assemblies.bump()
            self._host = TileSchedule(
                oid=oid[:n_sched].tolist(),
                iid=[dep[t, :cnt[t]].tolist() for t in range(n_sched)],
                reuse_overlap=ovl[1:n_sched].tolist())
        return self._host

    @classmethod
    def from_host(cls, sched: TileSchedule, n_out: int,
                  k_pad: int | None = None) -> "DeviceSchedule":
        """Dense padded form (numpy) of a host-built schedule."""
        t = len(sched.oid)
        if t > n_out:
            raise ValueError(f"schedule has {t} steps > n_out={n_out}")
        oid_d, deps_d, cnt_d = sched.dense(k_pad)
        oid = np.full((n_out,), -1, np.int32)
        oid[:t] = oid_d
        dep_tbl = np.zeros((n_out, deps_d.shape[1]), np.int32)
        dep_tbl[:t] = deps_d
        cnt = np.zeros((n_out,), np.int32)
        cnt[:t] = cnt_d
        ovl = np.zeros((n_out,), np.int32)
        ro = np.asarray(sched.reuse_overlap[:max(t - 1, 0)], np.int32)
        ovl[1:1 + ro.size] = ro
        return cls(oid, dep_tbl, cnt, ovl, _host=sched)


def schedule_arrays_device(B, m: int, *,
                           k_pad: int | None = None) -> DeviceSchedule:
    """Algorithm 1 on the tensor's device, emitted directly as dispatch
    arrays: the greedy kernel runs the selection, and its class rows
    become load-ordered dep tables by a stable argsort. ``k_pad`` defaults
    to ``pow2_pad(n_in)`` — static, so no sync on the max dep count."""
    n_in = B.shape[1]
    if k_pad is None:
        k_pad = pow2_pad(n_in)
    oid_seq, klass, ovl = greedy_schedule_arrays(B, int(m))
    oid, dep_tbl, cnt = dispatch_arrays_from_klass(oid_seq, klass, k_pad)
    return DeviceSchedule(oid, dep_tbl, cnt, ovl.reshape(-1))
