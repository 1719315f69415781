"""LRU cache for host-side tile schedules, keyed on quantized coordinates.

Building the TDT and running Algorithm 1 per image is the prepass's
scheduling cost (on the host, or in kernels with the device backend).
Both depend on the sampling coordinates only through their *clipped
integer floors* — the quantity the paper's boundary comparator (Fig. 9)
decodes — so two inputs whose floors agree produce byte-identical TDTs
and schedules. The cache key is a digest
of that quantization (exact, not lossy: a floor flip changes the key), so
repeated inputs — benchmark loops, serving replays — skip the rebuild
entirely. Hit/miss counters surface on ``NetworkTrace`` and the engine.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

import numpy as np

from repro_torch.core.tiles import TileGrid


def coords_digest(coords: Any, grid: TileGrid) -> str:
    """Digest of the clipped floor quantization of sampling coordinates.

    ``coords`` is (..., 2) float (row, col). The TDT depends only on
    clip(floor(r), 0, h-1) / clip(floor(c), 0, w-1) (the +1 neighbours are
    determined by these), so the digest is an exact schedule key. The
    digest strings equal the JAX package's on the same coordinates.

    A tensor on the card is copied to the host here: one sync per image
    and DCN layer, paid even by the device scheduling backend.
    """
    c = (coords.detach().cpu().numpy() if hasattr(coords, "detach")
         else np.asarray(coords))
    r0 = np.clip(np.floor(c[..., 0]), 0, grid.h - 1).astype(np.int32)
    c0 = np.clip(np.floor(c[..., 1]), 0, grid.w - 1).astype(np.int32)
    h = hashlib.sha1()
    h.update(repr(tuple(grid)).encode())
    h.update(np.ascontiguousarray(r0).tobytes())
    h.update(np.ascontiguousarray(c0).tobytes())
    return h.hexdigest()


def conv_digest(kernel_size: int, grid: TileGrid) -> str:
    """Static key for a standard-conv layer's TDT (no data dependence)."""
    return f"conv:k{kernel_size}:{tuple(grid)}"


def chain_digest(layer_digests: list[str], grid: TileGrid) -> str:
    """Key for a cross-layer composite schedule: the group's layer chain."""
    h = hashlib.sha1()
    h.update(repr(tuple(grid)).encode())
    for d in layer_digests:
        h.update(d.encode())
    return h.hexdigest()


class ScheduleCache:
    """Bounded LRU mapping schedule keys -> prebuilt schedule artifacts.

    Thread-safe: the multi-image staging queue runs prepass (and therefore
    cache lookups) on a worker thread while the main thread dispatches.
    """

    def __init__(self, maxsize: int = 128):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # Batch-fused accounting: per-image lookups inside a batch
        # assembly (a partial batch hit = some images skip scheduling
        # while the misses are built and spliced into the batch grid).
        # ``image_lookups`` counts every per-image membership check so
        # the hit accounting stays a rate even when a serving engine
        # coalesces dynamically sized slot batches.
        self.image_hits = 0
        self.image_lookups = 0
        self.batch_assemblies = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Hashable) -> Any | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def get_or_build(self, key: Hashable, build: Callable[[], Any]
                     ) -> tuple[Any, bool]:
        """Return (value, was_hit); builds and inserts on miss."""
        value = self.get(key)
        if value is not None:
            return value, True
        value = build()
        self.put(key, value)
        return value, False

    def note_batch_assembly(self, image_hits: int,
                            images: int = 0) -> None:
        """Record one batch-grid assembly: how many of its ``images``
        were served from the cache (partial batch hits)."""
        with self._lock:
            self.batch_assemblies += 1
            self.image_hits += int(image_hits)
            self.image_lookups += int(images)

    @property
    def image_hit_rate(self) -> float:
        """Per-image hit rate across batch assemblies (coalesced slot
        batches count each admitted image once)."""
        with self._lock:
            if not self.image_lookups:
                return 0.0
            return self.image_hits / self.image_lookups

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0
            self.image_hits = 0
            self.image_lookups = 0
            self.batch_assemblies = 0

    def info(self) -> dict[str, int]:
        with self._lock:
            return {"size": len(self._entries), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "image_hits": self.image_hits,
                    "image_lookups": self.image_lookups,
                    "batch_assemblies": self.batch_assemblies}

    def publish(self, registry, prefix: str = "schedule_cache") -> None:
        """Mirror the cache counters into a
        :class:`repro_torch.obs.MetricsRegistry` as gauges (plus the derived
        hit rates), so ``registry.snapshot()`` carries the cache state
        alongside the rest of the telemetry."""
        info = self.info()
        for k, v in info.items():
            registry.gauge(f"{prefix}.{k}").set(v)
        lookups = info["hits"] + info["misses"]
        registry.gauge(f"{prefix}.hit_rate").set(
            info["hits"] / lookups if lookups else 0.0)
        registry.gauge(f"{prefix}.image_hit_rate").set(
            info["image_hits"] / info["image_lookups"]
            if info["image_lookups"] else 0.0)


_DEFAULT_CACHE = ScheduleCache(maxsize=128)


def default_schedule_cache() -> ScheduleCache:
    """The process-wide cache the executors use unless given their own."""
    return _DEFAULT_CACHE
