"""Span tracing: nested, thread-aware wall-time spans with a no-op
disabled path.

A :class:`Tracer` records :class:`Span` entries — named wall-time
intervals with per-thread nesting — via context managers:

    tr = Tracer(enabled=True)
    with tr.span("prepass.schedule", backend="device"):
        build()

Two entry points with different disabled-path contracts:

* ``span(name, **attrs)`` — export-only instrumentation. When the
  tracer is disabled it returns a shared no-op context manager: no
  allocation, no clock read, nothing recorded. Safe to sprinkle on hot
  paths (kernel dispatch wrappers).
* ``timed(name, **attrs)`` — structural accounting. The duration is
  ALWAYS measured (the returned object's ``.dur`` is valid after the
  ``with`` block) but the span is only *recorded* when the tracer is
  enabled. The executors' ``OverlapSpans`` bookkeeping is re-derived
  from these spans (``OverlapSpans.add_span``), so overlap counters
  stay exact whether or not tracing is on.

Thread model: each thread keeps its own span stack (parenting never
crosses threads — the staging worker's prepass spans are roots on its
own track), and the span list is lock-protected, so the multi-image
staging queue and concurrent serving submitters can all record into one
tracer. Export to Chrome-trace/Perfetto JSON lives in
``repro_torch.obs.export``.

Zero-dep by design: stdlib only, importable from ``core``/``kernels``
without cycles.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    """One finished wall-time interval."""

    name: str
    ts: float                       # start, seconds on the perf_counter clock
    dur: float = 0.0                # seconds
    sid: int = 0                    # unique id within the tracer
    parent: int | None = None       # enclosing span's sid (same thread)
    tid: int = 0                    # OS thread ident
    thread_name: str = ""
    attrs: dict = field(default_factory=dict)


class _NullSpan:
    """Shared no-op context manager for the disabled ``span()`` path."""

    __slots__ = ()
    name = None
    dur = 0.0
    attrs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Stopwatch:
    """Measure-only context manager: ``.dur`` valid after the block.

    What ``Tracer.timed`` degrades to when tracing is disabled, and the
    shared timing helper for benchmarks that previously hand-rolled
    ``perf_counter`` pairs.
    """

    __slots__ = ("name", "attrs", "dur", "_t0")

    def __init__(self, name: str | None = None, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs if attrs is not None else {}
        self.dur = 0.0
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur = time.perf_counter() - self._t0
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self


class _LiveSpan:
    """Recording context manager: appends a Span to the tracer on exit."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        th = threading.current_thread()
        self._tracer = tracer
        self._span = Span(name=name, ts=0.0, tid=th.ident or 0,
                          thread_name=th.name, attrs=attrs)

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        sp = self._span
        sp.sid = tr._next_id()
        sp.parent = stack[-1] if stack else None
        stack.append(sp.sid)
        sp.ts = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sp = self._span
        sp.dur = time.perf_counter() - sp.ts
        stack = self._tracer._stack()
        if stack and stack[-1] == sp.sid:
            stack.pop()
        self._tracer._record(sp)
        return False

    def set(self, **attrs):
        """Attach/overwrite attributes mid-span (e.g. results known only
        after the work ran)."""
        self._span.attrs.update(attrs)
        return self

    @property
    def dur(self) -> float:
        return self._span.dur

    @property
    def name(self) -> str:
        return self._span.name

    @property
    def attrs(self) -> dict:
        return self._span.attrs


class Tracer:
    """Collects spans; disabled by default (see module docstring)."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._id = 0
        self._local = threading.local()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **attrs):
        """Export-only span: a true no-op when the tracer is disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, attrs)

    def timed(self, name: str, **attrs):
        """Always-measured span: ``.dur`` is valid after the block even
        when disabled (recorded into ``spans`` only when enabled)."""
        if not self.enabled:
            return Stopwatch(name, attrs)
        return _LiveSpan(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker event (Chrome-trace ``ph: "i"``)."""
        if not self.enabled:
            return
        th = threading.current_thread()
        sp = Span(name=name, ts=time.perf_counter(), dur=0.0,
                  sid=self._next_id(), tid=th.ident or 0,
                  thread_name=th.name, attrs=attrs)
        sp.attrs["instant"] = True
        self._record(sp)

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self.spans = []

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)

    def snapshot(self) -> list[Span]:
        """Copy of the recorded spans (safe to iterate while recording)."""
        with self._lock:
            return list(self.spans)

    def spans_since(self, mark: int) -> list[Span]:
        """Spans recorded after a previous ``len(tracer)`` mark."""
        with self._lock:
            return list(self.spans[mark:])

    # -- internals ----------------------------------------------------------

    def _stack(self) -> list[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)


# ---------------------------------------------------------------------------
# Global/current tracer: a process-wide default (disabled) plus a
# thread-local override so a serving engine can route the executors and
# kernel dispatch wrappers it drives into its own tracer.
# ---------------------------------------------------------------------------

_GLOBAL = Tracer(enabled=False)
_OVERRIDE = threading.local()


def global_tracer() -> Tracer:
    """The process-wide default tracer (disabled until enabled)."""
    return _GLOBAL


def get_tracer() -> Tracer:
    """The current tracer: the innermost ``use_tracer`` override on this
    thread, else the global default."""
    stack = getattr(_OVERRIDE, "stack", None)
    if stack:
        return stack[-1]
    return _GLOBAL


@contextmanager
def use_tracer(tracer: Tracer):
    """Route ``get_tracer()`` on THIS thread to ``tracer`` for the block
    (executors use it so kernel dispatch wrappers record into the same
    tracer as the surrounding call)."""
    stack = getattr(_OVERRIDE, "stack", None)
    if stack is None:
        stack = _OVERRIDE.stack = []
    stack.append(tracer)
    try:
        yield tracer
    finally:
        stack.pop()
