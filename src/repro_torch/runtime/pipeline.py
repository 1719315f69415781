"""Staging queue and config checks shared by the graph executor.

``run_staged`` overlaps the host-side prepass of unit i+1 (stage-1 chain,
TDT, schedule, packing) with the execution of unit i on one worker
thread. Both threads issue work on the device's default stream, so the
worker's tensors are ready for the executing thread in stream order with
no events. The per-layer ``dcn_pipeline`` executor is not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from repro_torch.obs import Tracer, get_tracer

DISPATCH_MODES = ("batched", "per_tile", "batch_fused")


def run_staged(n: int, prepass, execute, depth: int, overlap,
               tracer: Tracer | None = None) -> list:
    """``prepass(i)`` builds unit i's artifacts, ``execute(i, art)`` runs
    them. With ``depth > 1`` up to ``depth - 1`` prepasses run ahead on a
    single worker thread (submission order is preserved); ``overlap`` (an
    :class:`~repro_torch.runtime.trace.OverlapSpans`) accumulates the
    ``prepass`` / ``prepass.wait`` spans. Returns the execute results."""
    tr = tracer if tracer is not None else get_tracer()

    def staged(i: int):
        with tr.timed("prepass", unit=i) as sp:
            art = prepass(i)
        return art, sp

    outs = []
    if depth == 1 or n == 1:
        for i in range(n):
            with tr.timed("prepass.wait", unit=i) as wsp:
                art, sp = staged(i)
            overlap.add_span(sp)
            overlap.add_span(wsp)
            outs.append(execute(i, art))
        return outs
    with ThreadPoolExecutor(max_workers=1) as pool:
        futs: deque = deque()
        nxt = 0
        while nxt < n and len(futs) < depth - 1:
            futs.append(pool.submit(staged, nxt))
            nxt += 1
        for i in range(n):
            with tr.timed("prepass.wait", unit=i) as wsp:
                art, sp = futs.popleft().result()
            overlap.add_span(sp)
            overlap.add_span(wsp)
            if nxt < n:
                futs.append(pool.submit(staged, nxt))
                nxt += 1
            outs.append(execute(i, art))
    return outs


def validate_dispatch_config(cfg) -> None:
    """``GraphConfig.__post_init__`` checks: tile sides, dispatch mode,
    schedule backend and staging depth."""
    cfg.tile_hw                          # validates tile sides
    if cfg.dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch mode: {cfg.dispatch!r}")
    if cfg.schedule_backend not in ("host", "device"):
        raise ValueError(
            f"unknown schedule backend: {cfg.schedule_backend!r}")
    if cfg.schedule not in ("alg1", "sequential"):
        raise ValueError(f"unknown schedule: {cfg.schedule!r}")
    if cfg.staging_depth < 1:
        raise ValueError(
            f"staging_depth must be >= 1, got {cfg.staging_depth}")


def clamp_tile_config(cfg, h: int, w: int):
    """Clamp a config's tile to an (h, w) input plane — model and serving
    entry points accept any image size, while the raw executor rejects
    tile > plane."""
    th, tw = cfg.tile_hw
    if th <= h and tw <= w:
        return cfg
    return dataclasses.replace(cfg, tile=(min(th, h), min(tw, w)))
