#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, each fatal on failure:

1. build   — compile ``src/repro_torch/csrc/*.cu`` for sm_90a and load them;
2. kernels — capture the operands of one full-width prepass of VGG19-3
             DCN-II at 224x224, then hold each CUDA kernel against its
             plain torch version on those operands (the fused BLI(+)conv
             within 1e-4 * max|ref|, the TDT and greedy kernels bit-exact,
             the greedy kernel also against the numpy ``schedule_tiles``)
             and time both;
3. serve   — drive ``DcnServingEngine`` (slots=4, tile 8, device
             scheduling) with 8 requests of 1-2 images, one replayed;
             every request must resolve with finite logits that match the
             dense reference, every kernel must have launched, no host
             schedule may be built, a host-scheduled engine must produce
             identical trace records, and every step's trace must equal
             the DRAM simulator;
4. profile — one more step under ``torch.profiler``: wall, device busy
             time and idle share, and the top device activities and host
             operators.

The last lines are the card's name and power limit, one JSON object with
the per-kernel numbers, and ``{"ok": true, "device": {...}}``. Without a
CUDA device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_BATCH = 4
# fp32 CUDA-core peak (FLOP/s) and memory rate (B/s) by card name, from
# NVIDIA's data sheets; the SXM part is the default.
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12),
         "H200": (67e12, 4.8e12)}
PEAK_SXM = (67e12, 3.35e12)
FUSED_RTOL = 1e-4     # kernel vs plain: float32 sums in another order
LOGIT_RTOL = 1e-3     # served vs dense: 16 layers of reordered sums


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


_FLUSH = []


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed by CUDA
    events after a write of 128 MB that evicts the 50 MB L2 cache — the
    serving path finds its operands cold."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def device_busy(events) -> tuple[float, dict[str, list[float]]]:
    """Device busy time (us) of a profiler trace — the union of the
    intervals of its device-side activities (kernels, copies, memsets),
    so that nothing is counted twice — and each activity's durations by
    name. Host operators also carry device time in ``key_averages()``,
    which is why the events themselves are read."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name.setdefault(e.name, []).append(
            e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy, by_name


def profile_step(eng, batch, card: str) -> None:
    """One serving step of 4 unseen images under ``torch.profiler``: the
    step's wall time, the device's busy time and idle share, the top
    device activities and the top host operators by self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.submit(batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if len(done) != 1 or done[0].error is not None:
        fail("the profiled step did not resolve cleanly")
    busy_us, by_name = device_busy(prof.events())
    if busy_us <= 0:
        fail("the profiler recorded no device activity in a serving step")
    tr = eng.last_trace
    print(f"[profile] {card}: one step of {len(batch)} unseen images: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"(idle {100 * (1 - busy_us / wall_us):.1f} %), host prepass "
          f"{tr.overlap.prepass_s * 1e3:.1f} ms of which the execute "
          f"loop waited {tr.overlap.prepass_wait_s * 1e3:.1f} ms, "
          f"schedule build {tr.overlap.schedule_s * 1e3:.1f} ms")
    for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  device {sum(d) / 1e3:8.2f} ms x{len(d):<5d} {name[:90]}")
    for e in sorted(prof.key_averages(),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:8.2f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.core.deform import conv2d, randomize_offset_conv
    from repro_torch.core.simulator import simulate_network
    from repro_torch.kernels import _build
    from repro_torch.kernels import dcn_fused as kf
    from repro_torch.kernels import dcn_schedule as ks
    from repro_torch.models.dcn_models import (DcnNetConfig, apply_head,
                                               init_dcn_net)
    from repro_torch.runtime import fused_exec as fx
    from repro_torch.runtime.cache import ScheduleCache
    from repro_torch.runtime.graph import (DeformNode, PoolNode,
                                           UpsampleNode, build_graph)
    from repro_torch.serving import DcnServingEngine

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    print("settings: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False "
          "cudnn.deterministic=True (TF32 would move the floors of the "
          "sampling coordinates, and with them the schedules)")
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = next(
        (v for k, v in PEAKS.items() if k in kind), PEAK_SXM)
    print(f"card: {card}; peaks used for bounds: {peak_flops / 1e12:g} "
          f"TFLOP/s fp32, {peak_bw / 1e12:g} TB/s")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # -- model ---------------------------------------------------------------
    cfg = DcnNetConfig("vgg19", n_deform=3, variant="dcn2", img_size=224,
                       width_mult=1.0, num_classes=1000)
    params = init_dcn_net(SEED, cfg, device=dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    params["convs"] = [
        randomize_offset_conv(p, gen, 2.0 / p.w.shape[2])
        if hasattr(p, "w_off") else p for p in params["convs"]]
    graph = build_graph(cfg)
    rng = np.random.default_rng(SEED + 2)
    images = rng.normal(size=(16, 224, 224, 3)).astype(np.float32)

    # Mean |offset| of the first DCN layer on image 0 (dense chain).
    plane = torch.as_tensor(images[:1], device=dev)
    for node in graph.nodes:
        if isinstance(node, DeformNode):
            p = params["convs"][node.param_idx]
            off = conv2d(plane, p.w_off, p.b_off)
            print(f"[model] VGG19-{cfg.n_deform} DCN-II {cfg.img_size}x"
                  f"{cfg.img_size} width {cfg.width_mult}, "
                  f"{cfg.num_classes} classes; first DCN layer "
                  f"{node.h}x{node.w}x{node.c_in}: mean |offset| = "
                  f"{float(off.abs().mean()):.4f} px")
            break
        if isinstance(node, (PoolNode, UpsampleNode)):
            plane = fx.apply_boundary_batch(plane, node)
        else:
            plane = fx._advance_dense_batch(
                plane, node, params["convs"][node.param_idx], None)

    # -- phase 2: kernels against their plain versions -----------------------
    captured = {"fused": [], "tdt": [], "greedy": []}
    # Recording shims stand in for the kernel wrappers where the executor
    # and the scheduler look them up; the wrappers themselves (and their
    # launch counters) stay untouched.
    orig = (fx.dcn_fused_batch, fx.tdt_from_coords_device,
            sched_mod.greedy_schedule_arrays)

    def rec_fused(*a, **k):
        captured["fused"].append((a, k))
        return orig[0](*a, **k)

    def rec_tdt(coords, in_grid, out_grid):
        captured["tdt"].append((coords, in_grid, out_grid))
        return orig[1](coords, in_grid, out_grid)

    def rec_greedy(b, m):
        captured["greedy"].append((b, m))
        return orig[2](b, m)

    fx.dcn_fused_batch, fx.tdt_from_coords_device = rec_fused, rec_tdt
    sched_mod.greedy_schedule_arrays = rec_greedy
    try:
        xb = torch.as_tensor(images[:N_BATCH], device=dev)
        fx.run_graph(params["convs"], graph, xb,
                     config=fx.GraphConfig(tile=8, schedule_backend="device"),
                     schedule_cache=ScheduleCache())
        torch.cuda.synchronize()
    finally:
        fx.dcn_fused_batch, fx.tdt_from_coords_device = orig[:2]
        sched_mod.greedy_schedule_arrays = orig[2]
    if not all(captured.values()):
        fail(f"prepass did not reach every kernel: "
             f"{ {k: len(v) for k, v in captured.items()} }")

    kernels = {}
    # (1) batch-fused BLI(+)conv, first DCN segment of the batch.
    a, k = captured["fused"][0]
    x_t, row, dep, cnt, idx, coeff, w, b = a
    t_in = k["t_in"]
    got = kf.dcn_fused_batch(*a, **k)
    ref = kf.dcn_fused_batch_plain(*a, **k)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= FUSED_RTOL * scale:
        fail(f"dcn_fused_batch: max|d|={err} > {FUSED_RTOL}*{scale}")
    for a2, k2 in captured["fused"][1:]:
        e2 = float((kf.dcn_fused_batch(*a2, **k2)
                    - kf.dcn_fused_batch_plain(*a2, **k2)).abs().max())
        if not e2 <= FUSED_RTOL * scale:
            fail(f"dcn_fused_batch (later segment): max|d|={e2}")
    g_rows, p_pix = row.shape[0], idx.shape[1]
    kk, c_in, c_out = w.shape
    live = int((cnt > 0).sum())
    flops = 2 * live * p_pix * kk * c_in * c_out + 8 * live * p_pix * kk * c_in
    nbytes = sum(t.numel() * t.element_size() for t in a) \
        + g_rows * p_pix * c_out * 4
    patch = torch.randn(g_rows * p_pix, kk * c_in, device=dev)
    w2 = w.reshape(kk * c_in, c_out)
    kernels["dcn_fused_batch"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_batch.cu",
        replaces="src/repro/kernels/dcn_fused.py:249",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: kf.dcn_fused_batch(*a, **k), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_batch_plain(*a, **k), 5),
        library_ms=cuda_time_ms(lambda: torch.matmul(patch, w2), 50),
        flops=flops, bytes=nbytes,
        shape=f"G={g_rows} P={p_pix} KK={kk} C={c_in} O={c_out} "
              f"k_pad={dep.shape[1]} live_rows={live}")

    # (2) TDT, every captured DCN layer image; timed on the first.
    for coords, gin, gout in captured["tdt"]:
        t_k = ks.tdt_from_coords_device(coords, gin, gout)
        t_p = ks.tdt_plain(coords, gin, gout)
        if not torch.equal(t_k, t_p):
            fail(f"tdt_from_coords_device differs from its plain version "
                 f"on {tuple(coords.shape)}")
    coords, gin, gout = captured["tdt"][0]
    kernels["tdt_from_coords_device"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:62", max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ks.tdt_from_coords_device(coords, gin, gout),
                        200),
        plain_ms=cuda_time_ms(lambda: ks.tdt_plain(coords, gin, gout), 20),
        library_ms=None, flops=0,
        bytes=coords.numel() * 4 + gout.num_tiles * gin.num_tiles,
        shape=f"coords {tuple(coords.shape)} -> "
              f"({gout.num_tiles}, {gin.num_tiles})")

    # (3) greedy Algorithm 1: every captured table against the plain
    # version and the numpy host loop; timed on the largest.
    for bt, m in captured["greedy"]:
        outs_k = ks.greedy_schedule_arrays(bt, m)
        outs_p = ks.greedy_plain(bt, m)
        if not all(torch.equal(u, v) for u, v in zip(outs_k, outs_p)):
            fail(f"greedy kernel differs from its plain version on "
                 f"{tuple(bt.shape)}")
        oid, dep_tbl, dcnt = ks.dispatch_arrays_from_klass(
            outs_k[0], outs_k[1], sched_mod.pow2_pad(bt.shape[1]))
        dev_s = sched_mod.DeviceSchedule(oid, dep_tbl, dcnt,
                                         outs_k[2].reshape(-1)).to_host()
        host_s = sched_mod.schedule_tiles(bt.cpu().numpy(), m)
        if (dev_s.oid, dev_s.iid, dev_s.reuse_overlap) != \
                (host_s.oid, host_s.iid, host_s.reuse_overlap):
            fail(f"greedy kernel differs from schedule_tiles on "
                 f"{tuple(bt.shape)}")
    bt, m = max(captured["greedy"], key=lambda e: e[0].numel())
    n_out, n_in = bt.shape
    kernels["greedy_schedule_arrays"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:142", max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ks.greedy_schedule_arrays(bt, m), 10),
        plain_ms=cuda_time_ms(lambda: ks.greedy_plain(bt, m), 1, warmup=1),
        library_ms=None, flops=0,
        bytes=n_out * n_in * (1 + 4) + 8 * n_out,
        shape=f"TDT ({n_out}, {n_in}), m={m}")
    print(f"[kernels] all {sum(len(v) for v in captured.values())} captured "
          f"calls agree with their plain versions (dcn_fused_batch within "
          f"{FUSED_RTOL}*max|ref|, TDT and greedy bit-exact, greedy also "
          f"== numpy schedule_tiles)")

    # -- phase 3: the main path ---------------------------------------------
    requests = [[0], [1, 2], [3], [4, 5], [6], [0], [7, 8], [9]]

    def make_engine(backend):
        eng = DcnServingEngine(
            params, cfg, slots=4, device=dev,
            graph=fx.GraphConfig(tile=8, schedule_backend=backend))
        eng.submit(images[10:12])          # warm-up: cuDNN, conv schedules
        eng.drain()
        return eng

    def serve(eng):
        """Submit every request, step until all resolve; per-step traces."""
        reqs = [eng.submit(images[ids]) for ids in requests]
        traces, done = [], []
        t0 = time.perf_counter()
        while len(done) < len(reqs):
            done += eng.step()
            traces.append(eng.last_trace)
        torch.cuda.synchronize()
        return reqs, traces, time.perf_counter() - t0

    eng = make_engine("device")
    builds0 = eng.host_schedule_builds
    for fn in (kf.dcn_fused_batch, ks.tdt_from_coords_device,
               ks.greedy_schedule_arrays):
        fn.launches = 0
    reqs, traces, wall = serve(eng)
    launches = {"dcn_fused_batch": kf.dcn_fused_batch.launches,
                "tdt_from_coords_device": ks.tdt_from_coords_device.launches,
                "greedy_schedule_arrays": ks.greedy_schedule_arrays.launches}
    builds = eng.host_schedule_builds - builds0
    steps = len(traces)

    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    if builds != 0:
        fail(f"{builds} host schedule builds on the device-scheduled path")
    bad = [r.rid for r in reqs if not r.done or r.error is not None]
    if bad:
        fail(f"requests {bad} did not resolve cleanly: "
             f"{[repr(r.error) for r in reqs if r.error]}")
    worst = 0.0
    for r, ids in zip(reqs, requests):
        out = r.result()
        if out.shape != (len(ids), 1000) or not np.isfinite(out).all():
            fail(f"request {r.rid}: logits {out.shape} not finite/shaped")
        xr = torch.as_tensor(images[ids], device=dev)
        ref = apply_head(params, cfg, fx.run_graph_dense(
            params["convs"], graph, xr)).cpu().numpy()
        d = float(np.abs(out - ref).max())
        s = float(np.abs(ref).max())
        if not d <= LOGIT_RTOL * s:
            fail(f"request {r.rid}: max|logit - dense| = {d} > "
                 f"{LOGIT_RTOL} * {s}")
        worst = max(worst, d / s)
    print(f"[serve] {len(reqs)} requests, {sum(map(len, requests))} images "
          f"in {steps} steps; logits finite; max|served - dense| / "
          f"max|dense| = {worst:.3e} (limit {LOGIT_RTOL})")

    for tr in traces:
        sim = simulate_network(fx.network_sim_specs(tr),
                               boundary_bytes=tr.boundary_bytes)
        if sim.total_dram_bytes != tr.total_dram_bytes:
            fail(f"trace DRAM {tr.total_dram_bytes} != simulator "
                 f"{sim.total_dram_bytes}")

    def records(tr):
        return [[(g.image, g.group)] + [dataclasses.astuple(r)
                                        for r in g.records]
                for g in tr.groups]

    host_eng = make_engine("host")
    _, host_traces, _ = serve(host_eng)
    if [records(t) for t in traces] != [records(t) for t in host_traces]:
        fail("device- and host-scheduled engines produced different "
             "trace records")
    if host_eng.host_schedule_builds == 0:
        fail("the host-scheduled engine built no host schedule")
    print(f"[serve] trace == DRAM simulator on all {steps} steps; host-"
          f"scheduled engine gives identical records")

    lat = sorted(r.latency_s for r in reqs)
    n_img = sum(map(len, requests))

    def pct(q):
        return float(np.percentile(np.asarray(lat), q))

    stats = eng.stats
    print(f"[serve] {card}: {n_img / wall:.3f} images/s, request latency "
          f"p50 {pct(50) * 1e3:.1f} ms p99 {pct(99) * 1e3:.1f} ms, "
          f"{steps} steps, {stats['kernel_dispatches']} dispatches, "
          f"schedule-cache image hit rate {stats['image_hit_rate']:.3f}")

    # -- phase 4: where one serving step's time goes -------------------------
    profile_step(eng, images[12:16], card)

    out_k = []
    for name, kd in kernels.items():
        compute_ms = kd.pop("flops") / peak_flops * 1e3
        bytes_ms = kd.pop("bytes") / peak_bw * 1e3
        kd["bound_ms"] = max(compute_ms, bytes_ms)
        kd["bound_by"] = "operations" if compute_ms > bytes_ms else "bytes"
        kd["launches"] = launches[name]
        shape = kd.pop("shape")
        lib_ms = kd["library_ms"]
        print(f"[kernel] {card}: {name} at {shape}: {kd['ms']:.4f} ms "
              f"(bound {kd['bound_ms']:.4f} ms by {kd['bound_by']}, plain "
              f"{kd['plain_ms']:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}), "
              f"{kd['launches']} launches in {steps} steps")
        out_k.append({"name": name, **kd})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": out_k}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
