"""Exporters: Chrome-trace/Perfetto JSON out of a :class:`Tracer`.

The emitted document is the Trace Event Format both ``chrome://tracing``
and https://ui.perfetto.dev load directly: a ``traceEvents`` list of
complete ``"ph": "X"`` events (microsecond ``ts``/``dur``) plus
``"ph": "M"`` metadata naming the tracks. Track layout:

* pid 0 ("host threads") — one tid per OS thread that recorded spans,
  so the staging worker's prepass track sits under the main thread's
  execute track and the overlap is visible directly.
* pid 1 ("engine steps") — every ``serve.step`` span is duplicated onto
  a per-step track (tid = step id), annotated with the step's dispatch
  counts and DRAM bytes, so one artifact shows where each serving
  step's wall went.

``validate_chrome_trace`` is the schema check the benchmark gate and
the tests share.
"""

from __future__ import annotations

import json
import numbers

from repro_torch.obs.tracer import Span, Tracer

_SERVE_STEP = "serve.step"


def _json_value(v):
    """Coerce an attr value to something JSON-serializable."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return repr(v)


def _args(span: Span) -> dict:
    return {k: _json_value(v) for k, v in span.attrs.items()
            if k != "instant"}


def chrome_trace_events(tracer_or_spans) -> list[dict]:
    """Render spans as Trace Event Format events (see module docstring)."""
    if isinstance(tracer_or_spans, Tracer):
        spans = tracer_or_spans.snapshot()
    else:
        spans = list(tracer_or_spans)
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "host threads"}},
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "engine steps"}},
    ]
    if not spans:
        return events
    t0 = min(s.ts for s in spans)

    # Compact, deterministic thread ids in order of first appearance.
    tids: dict[int, int] = {}
    for s in sorted(spans, key=lambda s: s.ts):
        if s.tid not in tids:
            tids[s.tid] = len(tids)
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tids[s.tid],
                           "args": {"name": s.thread_name
                                    or f"thread-{s.tid}"}})

    for s in sorted(spans, key=lambda s: s.ts):
        ts_us = (s.ts - t0) * 1e6
        if s.attrs.get("instant"):
            events.append({"name": s.name, "ph": "i", "s": "t",
                           "ts": ts_us, "pid": 0, "tid": tids[s.tid],
                           "args": _args(s)})
            continue
        ev = {"name": s.name, "cat": s.name.split(".", 1)[0], "ph": "X",
              "ts": ts_us, "dur": s.dur * 1e6, "pid": 0,
              "tid": tids[s.tid], "args": _args(s)}
        events.append(ev)
        if s.name == _SERVE_STEP and "step" in s.attrs:
            step = int(s.attrs["step"])
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": step,
                           "args": {"name": f"step {step}"}})
            events.append(dict(ev, pid=1, tid=step))
    return events


def chrome_trace(tracer_or_spans) -> dict:
    """Full Chrome-trace document (the JSON-object flavor)."""
    return {"traceEvents": chrome_trace_events(tracer_or_spans),
            "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer_or_spans) -> dict:
    doc = chrome_trace(tracer_or_spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc) -> list[str]:
    """Schema-check a Chrome-trace document; [] means loadable.

    Checks the invariants ``chrome://tracing`` / Perfetto rely on:
    a ``traceEvents`` list whose complete events carry name/ph plus
    numeric non-negative ts/dur and integer pid/tid, and JSON
    serializability of the whole document.
    """
    problems: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a dict with a 'traceEvents' key"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i} missing string 'name'")
        ph = ev.get("ph")
        if ph not in ("X", "M", "i"):
            problems.append(f"event {i} has unsupported ph={ph!r}")
            continue
        if not isinstance(ev.get("pid"), int):
            problems.append(f"event {i} missing int 'pid'")
        if not isinstance(ev.get("tid"), int):
            problems.append(f"event {i} missing int 'tid'")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} has invalid ts={ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} has invalid dur={dur!r}")
    return problems


def write_json(path: str, obj) -> None:
    """Dump a metrics snapshot / serving timeline as indented JSON."""
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=_json_value)
