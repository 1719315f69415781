"""Persistent cache of autotuned partition / tile-shape plans.

The autotuner (:mod:`repro_torch.tuning.autotune`) searches over group cut
points and per-group ``(tile_h, tile_w)`` shapes, scoring every
candidate with the exact DRAM simulator. The search is pure offline
work, so its result — a :class:`TunedPlan` — is cached per
``(net digest, img_size, batch, onchip_budget, …)``: in memory as an
LRU (sibling of :class:`repro_torch.runtime.cache.ScheduleCache`) and
optionally on disk (the ``plan_cache_dir=`` knob), so a serving
process pays the search once and every later engine, replica or
restart reuses the winning plan.

Disk format: one JSON file per key, named by the sha1 of the key's
repr, written atomically (tmp + ``os.replace``). Corrupt, truncated or
version-skewed files are treated as cache misses — the caller falls
back to a fresh search and rewrites the entry; a bad file can never
poison a run.

The key and the file format are those of the JAX package's plan cache,
kept byte for byte, so a plan file written by either package is served
by the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from collections import OrderedDict

from repro_torch.obs import default_registry

PLAN_FORMAT_VERSION = 1

# Process-wide counters on the default registry: the serving engine
# reports the delta from its construction-time baseline, mirroring how
# ``host_schedule_builds`` / ``staging.watchdog_failovers`` are exposed.
plan_cache_hits = default_registry().counter(
    "plan_cache.hits",
    help="tuned-plan cache hits (memory or disk) this process")
plan_cache_misses = default_registry().counter(
    "plan_cache.misses",
    help="tuned-plan cache misses (searches paid) this process")


@dataclasses.dataclass(frozen=True)
class TunedGroup:
    """One fused group of a tuned plan: the graph-node index span
    ``[start, stop)`` it fuses, plus the tile shape its schedules and
    dispatches use (overriding the config default for this group)."""

    start: int
    stop: int
    tile_h: int
    tile_w: int


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """Winning plan for one cache key.

    All-tuple fields keep the plan hashable, so it can ride inside the
    ``partition_graph_cached`` lru memo key — the stale-plan fix: two
    runs differing only in their tuned plan must never share memoized
    segments. ``dram_bytes`` / ``greedy_dram_bytes`` are the simulated
    layer-segment totals on the tuner's representative input (boundary
    planes and total weight bytes are partition-invariant, so the
    comparison is exact for ranking).
    """

    key: tuple
    groups: tuple[TunedGroup, ...]
    dram_bytes: int
    greedy_dram_bytes: int
    candidates: int
    search_s: float

    def to_json(self) -> dict:
        return {
            "version": PLAN_FORMAT_VERSION,
            "key": list(self.key),
            "groups": [[g.start, g.stop, g.tile_h, g.tile_w]
                       for g in self.groups],
            "dram_bytes": int(self.dram_bytes),
            "greedy_dram_bytes": int(self.greedy_dram_bytes),
            "candidates": int(self.candidates),
            "search_s": float(self.search_s),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "TunedPlan":
        if not isinstance(obj, dict):
            raise ValueError("plan entry is not an object")
        if obj.get("version") != PLAN_FORMAT_VERSION:
            raise ValueError("plan format version mismatch")
        groups = tuple(TunedGroup(int(a), int(b), int(th), int(tw))
                       for a, b, th, tw in obj["groups"])
        return cls(key=_freeze(obj["key"]), groups=groups,
                   dram_bytes=int(obj["dram_bytes"]),
                   greedy_dram_bytes=int(obj["greedy_dram_bytes"]),
                   candidates=int(obj["candidates"]),
                   search_s=float(obj["search_s"]))


def _freeze(v):
    """JSON round-trips tuples as lists; re-freeze them for hashing."""
    return tuple(_freeze(x) for x in v) if isinstance(v, list) else v


def net_digest(graph) -> str:
    """Structural digest of a :class:`NetGraph`: the nodes are frozen
    dataclasses, so ``repr`` covers channels, kernel sizes, variants,
    relu flags and the input plane — anything that changes the graph
    changes the digest."""
    return hashlib.sha1(repr(graph).encode()).hexdigest()


def plan_key(graph, *, batch, onchip_budget_bytes, dtype_bytes,
             tile_hw, buffer_tiles, schedule,
             max_displacement=None) -> tuple:
    """Cache key: everything that can change the winning plan.

    Supersets the contract key ``(net digest, img_size, batch,
    onchip_budget)`` with the remaining scoring inputs — dtype width,
    the default tile the seed plan uses, the FIFO depth override and
    the schedule flavour. A flat tuple of JSON primitives, so it
    survives the disk round-trip exactly.
    """
    return (net_digest(graph), int(graph.in_h), int(graph.in_w),
            int(batch), int(onchip_budget_bytes), int(dtype_bytes),
            int(tile_hw[0]), int(tile_hw[1]),
            None if buffer_tiles is None else int(buffer_tiles),
            str(schedule),
            None if max_displacement is None
            else float(max_displacement))


class PlanCache:
    """Thread-safe LRU of ``key -> TunedPlan`` with optional disk
    persistence (one JSON file per key under ``cache_dir``)."""

    def __init__(self, maxsize: int = 64,
                 cache_dir: str | None = None):
        self.maxsize = int(maxsize)
        self.cache_dir = cache_dir
        self._lock = threading.Lock()
        self._mem: OrderedDict[tuple, TunedPlan] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: tuple) -> str:
        name = hashlib.sha1(repr(key).encode()).hexdigest()
        return os.path.join(self.cache_dir, f"plan-{name}.json")

    def get(self, key: tuple) -> TunedPlan | None:
        with self._lock:
            plan = self._mem.get(key)
            if plan is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                plan_cache_hits.inc()
                return plan
        plan = self._load(key)
        with self._lock:
            if plan is not None:
                self._remember(key, plan)
                self.hits += 1
                self.disk_hits += 1
                plan_cache_hits.inc()
            else:
                self.misses += 1
                plan_cache_misses.inc()
        return plan

    def _load(self, key: tuple) -> TunedPlan | None:
        """Disk lookup. Any malformed entry — unreadable, bad JSON,
        version skew, key mismatch, nonsense groups — is a miss (the
        caller re-searches and rewrites), never an exception."""
        if not self.cache_dir:
            return None
        try:
            with open(self._path(key), "r", encoding="utf-8") as f:
                plan = TunedPlan.from_json(json.load(f))
            if plan.key != key:
                raise ValueError("stored key mismatch")
            if any(g.stop <= g.start or g.tile_h < 1 or g.tile_w < 1
                   for g in plan.groups):
                raise ValueError("malformed groups")
            return plan
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _remember(self, key: tuple, plan: TunedPlan) -> None:
        self._mem[key] = plan
        self._mem.move_to_end(key)
        while len(self._mem) > self.maxsize:
            self._mem.popitem(last=False)

    def put(self, key: tuple, plan: TunedPlan) -> None:
        with self._lock:
            self._remember(key, plan)
        if not self.cache_dir:
            return
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(plan.to_json(), f)
            os.replace(tmp, self._path(key))
        except OSError:
            # Best-effort persistence: a read-only or full disk must not
            # fail the run — the plan still lives in the memory LRU.
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()

    def info(self) -> dict:
        with self._lock:
            return {"size": len(self._mem), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "disk_hits": self.disk_hits,
                    "dir": self.cache_dir}

    def publish(self, registry, prefix: str = "plan_cache") -> None:
        """Mirror cache state into a :class:`MetricsRegistry` as gauges
        (per-instance view; the process-wide counters above aggregate
        across every cache)."""
        info = self.info()
        for k in ("size", "hits", "misses", "disk_hits"):
            registry.gauge(f"{prefix}.{k}").set(info[k])


_DEFAULT_PLAN_CACHE = PlanCache(maxsize=64)
_DIR_CACHES: dict[str, PlanCache] = {}
_DIR_LOCK = threading.Lock()


def default_plan_cache(cache_dir: str | None = None) -> PlanCache:
    """Process-wide plan cache. One shared instance per ``cache_dir``
    (so every engine / run over the same directory shares the memory
    layer); a single memory-only instance when no directory is set."""
    if cache_dir is None:
        return _DEFAULT_PLAN_CACHE
    path = os.path.abspath(cache_dir)
    with _DIR_LOCK:
        pc = _DIR_CACHES.get(path)
        if pc is None:
            pc = _DIR_CACHES[path] = PlanCache(maxsize=64,
                                               cache_dir=path)
        return pc
