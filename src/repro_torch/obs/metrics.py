"""Typed metrics: Counter / Gauge / Histogram behind one registry.

Unifies the counters that previously lived as ad-hoc attributes across
``runtime/cache.py``, ``core/scheduler.py`` and ``serving/engine.py``:
a :class:`MetricsRegistry` owns named metric objects and renders them
all through one ``snapshot() -> dict`` — the single source of truth the
serving engine's ``stats``, the benchmark gates and the CI artifacts
read.

Zero-dep (stdlib only) so ``core`` and ``kernels`` can import it
without cycles; percentiles are computed with the same linear
interpolation as ``numpy.percentile`` but without index arithmetic on
empty/singleton samples (None / the sample respectively).
"""

from __future__ import annotations

import math
import threading


def percentile(samples, q: float):
    """q-th percentile (linear interpolation, like numpy's default).

    Well-defined edge cases instead of index arithmetic: ``None`` with
    no samples, the sample itself with exactly one.
    """
    n = len(samples)
    if n == 0:
        return None
    s = sorted(samples)
    if n == 1:
        return float(s[0])
    pos = (n - 1) * (float(q) / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    # Back-compat aliases for the pre-registry instrumentation counter
    # API (``core.scheduler.host_schedule_builds.bump()`` / ``.count``).
    def bump(self) -> None:
        self.inc()

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    @property
    def count(self) -> int:
        return self.value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def render(self):
        return self.value


class Gauge:
    """Last-set value (depths, rates, config echoes)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, dv) -> None:
        with self._lock:
            self._value += dv

    @property
    def value(self):
        with self._lock:
            return self._value

    def render(self):
        return self.value


class Histogram:
    """Sample distribution with percentile summaries.

    Keeps raw samples (serving runs are CI-sized; the latency population
    is what benchmarks archive anyway). ``summary()`` reports count /
    mean / p50 / p95 / p99 with the edge-case contract of
    :func:`percentile`.
    """

    kind = "histogram"

    def __init__(self, name: str = "", help: str = ""):
        self.name = name
        self.help = help
        self._samples: list[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(float(v))

    @property
    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def mean(self):
        with self._lock:
            if not self._samples:
                return None
            return sum(self._samples) / len(self._samples)

    def percentile(self, q: float):
        return percentile(self.samples, q)

    def summary(self) -> dict:
        s = self.samples
        return {
            "count": len(s),
            "mean": (sum(s) / len(s)) if s else None,
            "p50": percentile(s, 50.0),
            "p95": percentile(s, 95.0),
            "p99": percentile(s, 99.0),
        }

    def render(self):
        return self.summary()


class MetricsRegistry:
    """Named metric objects + one ``snapshot()`` over all of them."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, help)

    def register(self, name: str, metric) -> None:
        """Adopt an externally constructed metric object (it must expose
        ``render()``); e.g. the serving engine's ``LatencyStats``."""
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None and existing is not metric:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{name: value} for counters/gauges, {name: summary dict} for
        histograms — one machine-readable view of every metric."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.render() for name, m in items}


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry (home of cross-cutting counters like
    ``host_schedule_builds``)."""
    return _DEFAULT
