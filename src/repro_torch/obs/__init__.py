"""Unified telemetry for the DCN serving stack (zero external deps).

Three layers, one package:

* ``obs.tracer`` — nested, thread-aware wall-time spans
  (``prepass.schedule``, ``dispatch.batch_fused``, ``serve.step``, …)
  with a true no-op disabled path; the executors' ``OverlapSpans``
  accounting is re-derived from these spans.
* ``obs.metrics`` — typed Counter/Gauge/Histogram objects behind a
  :class:`MetricsRegistry` whose ``snapshot()`` is the single
  machine-readable view of every serving/scheduling counter.
* ``obs.export`` — Chrome-trace/Perfetto JSON export of a recorded run
  (loads in ``chrome://tracing`` / ui.perfetto.dev) plus plain-JSON
  dumps of metrics snapshots and serving timelines.

Stdlib-only on purpose: ``core`` and ``kernels`` import it without
cycles, and tracing can thread through the whole hot path — kernels'
dispatch wrappers, both executors, packing, the scheduler backends and
the serving engine — at negligible cost when disabled.
"""

from repro_torch.obs.export import (
    chrome_trace,
    chrome_trace_events,
    validate_chrome_trace,
    write_chrome_trace,
    write_json,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    percentile,
)
from repro_torch.obs.tracer import (
    Span,
    Stopwatch,
    Tracer,
    get_tracer,
    global_tracer,
    use_tracer,
)

__all__ = [
    "Span",
    "Stopwatch",
    "Tracer",
    "get_tracer",
    "global_tracer",
    "use_tracer",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "percentile",
    "chrome_trace",
    "chrome_trace_events",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_json",
]
