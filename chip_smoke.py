#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, each fatal on failure:

1.  build   — compile ``src/repro_torch/csrc/*.cu`` for sm_90a and load
              them;
2.  kernels — capture the operands of full-width runs of VGG19-3 DCN-II at
              224x224 (a ``batch_fused`` prepass of 4 images, a
              ``batched`` prepass of one image, and the 14x14x512 DCN
              layer through ``ops.deformable_conv2d_pallas`` and
              ``ops.bli_pallas``), then hold each CUDA kernel against its
              plain torch version on those operands (the fused kernels
              within 1e-4 * max|ref|, the BLI kernel within 1e-6 *
              max|ref|, the TDT and greedy kernels bit-exact, the greedy
              kernel also against the numpy ``schedule_tiles``) and time
              kernel, plain version and library call;
3.  serve   — drive ``DcnServingEngine`` (slots=4, tile 8, device
              scheduling) with 8 requests of 1-2 images, one replayed;
              every request must resolve with finite logits that match the
              dense reference, every kernel must have launched, no host
              schedule may be built, no step may retry or degrade, a
              host-scheduled engine must produce identical trace records,
              and every step's trace must equal the DRAM simulator;
3b. faults  — the same engine with an injected fault: an image-tagged
              dispatch fault fails exactly its request while its
              step-mates resolve through the evicted retry; an untagged
              one degrades the step to per-image ``batched`` dispatch
              through the schedule kernel, whose outputs must match the
              dense reference and ``infer()``; every trace equals the
              simulator;
3c. modes   — ``run_graph(dispatch="per_tile")`` on one image through the
              tile kernel (logits vs dense, trace == simulator), the
              ``"pallas"`` and ``"pipeline"`` model backends vs dense, and
              ``ops.bli_pallas`` vs ``core.deform.bilinear_sample``;
4.  profile — one more step under ``torch.profiler``: wall, device busy
              time and idle share, and the top device activities and host
              operators.

Each path is driven with every kernel's launch count set to 0 just
before it and read just after. The last lines are the card's name and
power limit, one JSON object with the per-kernel numbers, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
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
BLI_RTOL = 1e-6       # BLI kernel vs plain / reference: four-term sums
LOGIT_RTOL = 1e-3     # served vs dense: 16 layers of reordered sums
# Device cycles the stream sleeps before each timed window, so the host
# enqueues the window's launches while the device is still busy and the
# events time the device work, not the host's launch overhead.
HOLD_CYCLES = 1_000_000


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
    serving path finds its operands cold — and a device sleep that lets
    the host enqueue the window before the device reaches it."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


@contextlib.contextmanager
def recording(module, name: str, store: list):
    """Stand a recording shim in for ``module.name`` (a kernel wrapper as
    its caller looks it up): each call's arguments go to ``store`` and the
    wrapper itself, launch counter included, runs unchanged."""
    orig = getattr(module, name)

    def shim(*a, **k):
        store.append((a, k))
        return orig(*a, **k)

    setattr(module, name, shim)
    try:
        yield
    finally:
        setattr(module, name, orig)


def rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, max|ref|)."""
    return (float((got - ref).abs().max()), float(ref.abs().max()))


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
    from repro_torch.core.deform import (bilinear_sample, conv2d,
                                         offsets_to_coords,
                                         randomize_offset_conv)
    from repro_torch.core.simulator import simulate_network
    from repro_torch.kernels import _build
    from repro_torch.kernels import dcn_bli as kb
    from repro_torch.kernels import dcn_fused as kf
    from repro_torch.kernels import dcn_schedule as ks
    from repro_torch.kernels import ops
    from repro_torch.models.dcn_models import (DcnNetConfig, apply_head,
                                               dcn_net_apply, init_dcn_net)
    from repro_torch.runtime import fused_exec as fx
    from repro_torch.runtime.cache import ScheduleCache
    from repro_torch.runtime.graph import (DeformNode, PoolNode,
                                           UpsampleNode, build_graph)
    from repro_torch.serving import DcnServingEngine, RequestFailedError
    from repro_torch.testing import FaultError, FaultInjector

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
    wrappers = {"dcn_fused_batch": kf.dcn_fused_batch,
                "tdt_from_coords_device": ks.tdt_from_coords_device,
                "greedy_schedule_arrays": ks.greedy_schedule_arrays,
                "dcn_fused_schedule": kf.dcn_fused_schedule,
                "dcn_fused_tile": kf.dcn_fused_tile,
                "bli_tile_matmul": kb.bli_tile_matmul}
    launches = {}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts(*names):
        got = {n: wrappers[n].launches for n in names}
        for name, n in got.items():
            if n <= 0:
                fail(f"{name} was not launched on its path")
        launches.update(got)
        return got

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
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

    def dense_logits(x_np):
        xr = torch.as_tensor(x_np, device=dev)
        return apply_head(params, cfg, fx.run_graph_dense(
            params["convs"], graph, xr)).cpu().numpy()

    def check_logits(what, out, ref):
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"{what}: logits {out.shape} not finite/shaped like "
                 f"{ref.shape}")
        d, sc = float(np.abs(out - ref).max()), float(np.abs(ref).max())
        if not d <= LOGIT_RTOL * sc:
            fail(f"{what}: max|logit - ref| = {d} > {LOGIT_RTOL} * {sc}")
        return d / sc

    def check_sim(what, traces):
        for tr in traces:
            sim = simulate_network(fx.network_sim_specs(tr),
                                   boundary_bytes=tr.boundary_bytes)
            if sim.total_dram_bytes != tr.total_dram_bytes:
                fail(f"{what}: trace DRAM {tr.total_dram_bytes} != "
                     f"simulator {sim.total_dram_bytes}")

    # The first DCN layer's input plane (image 0, dense chain) and params.
    plane = torch.as_tensor(images[:1], device=dev)
    for node in graph.nodes:
        if isinstance(node, DeformNode):
            p_dcn = params["convs"][node.param_idx]
            off = conv2d(plane, p_dcn.w_off, p_dcn.b_off)
            dcn_coords = offsets_to_coords(off, 3, cfg.variant)
            dcn_in = plane.contiguous()
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
    captured = {k: [] for k in ("fused", "tdt", "greedy", "sched",
                                "plane_tile", "bli")}
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording(fx, "dcn_fused_batch",
                                      captured["fused"]))
        stack.enter_context(recording(fx, "tdt_from_coords_device",
                                      captured["tdt"]))
        stack.enter_context(recording(sched_mod, "greedy_schedule_arrays",
                                      captured["greedy"]))
        xb = torch.as_tensor(images[:N_BATCH], device=dev)
        fx.run_graph(params["convs"], graph, xb,
                     config=fx.GraphConfig(tile=8, schedule_backend="device"),
                     schedule_cache=ScheduleCache())
    with recording(fx, "dcn_fused_schedule", captured["sched"]):
        fx.run_graph(params["convs"], graph, xb[:1],
                     config=fx.GraphConfig(tile=8, dispatch="batched",
                                           schedule_backend="device"),
                     schedule_cache=ScheduleCache())
    with recording(ops, "dcn_fused_tile", captured["plane_tile"]):
        ops.deformable_conv2d_pallas(dcn_in, p_dcn)
    with recording(ops, "bli_tile_matmul", captured["bli"]):
        ops.bli_pallas(dcn_in, dcn_coords)
    torch.cuda.synchronize()
    if not all(captured.values()):
        fail(f"prepass did not reach every kernel: "
             f"{ {k: len(v) for k, v in captured.items()} }")

    def fused_flops(live_px, kk, c_in, c_out):
        return 2 * live_px * kk * c_in * c_out + 8 * live_px * kk * c_in

    def nbytes_of(tensors, out_numel):
        return sum(t.numel() * t.element_size() for t in tensors) \
            + out_numel * 4

    def contraction(rows, w):
        """The library yardstick of a fused kernel: torch.matmul of the
        (rows, KK*C) patch with the (KK*C, O) weights."""
        kk, c_in, c_out = w.shape
        patch = torch.randn(rows, kk * c_in, device=dev)
        w2 = w.reshape(kk * c_in, c_out)
        return cuda_time_ms(lambda: torch.matmul(patch, w2), 50)

    def hold_fused(name, calls, fn, plain, rtol):
        """Every captured call of ``fn`` against ``plain`` (which takes the
        call's tensors and, for #1, its ``t_in``); returns the first
        call's error."""
        errs = []
        for a, k in calls:
            d, sc = rel_err(fn(*a, **k),
                            plain(*a, **{n: v for n, v in k.items()
                                         if n == "t_in"}))
            torch.cuda.synchronize()
            if not d <= rtol * sc:
                fail(f"{name}: max|d|={d} > {rtol}*{sc}")
            errs.append(d)
        return errs[0]

    kernels = {}
    # (1) batch-fused BLI(+)conv, first DCN segment of the batch.
    a, k = captured["fused"][0]
    x_t, row, dep, cnt, idx, coeff, w, b = a
    err = hold_fused("dcn_fused_batch", captured["fused"],
                     kf.dcn_fused_batch, kf.dcn_fused_batch_plain,
                     FUSED_RTOL)
    g_rows, p_pix = row.shape[0], idx.shape[1]
    kk, c_in, c_out = w.shape
    live = int((cnt > 0).sum())
    kernels["dcn_fused_batch"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_batch.cu",
        replaces="src/repro/kernels/dcn_fused.py:249",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: kf.dcn_fused_batch(*a, **k), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_batch_plain(*a, **k), 5),
        library_ms=contraction(g_rows * p_pix, w),
        flops=fused_flops(live * p_pix, kk, c_in, c_out),
        bytes=nbytes_of(a, g_rows * p_pix * c_out),
        shape=f"G={g_rows} P={p_pix} KK={kk} C={c_in} O={c_out} "
              f"k_pad={dep.shape[1]} live_rows={live}")

    # (2) TDT, every captured DCN layer image; timed on the first by its
    # own launch into a preallocated table (no wrapper host work).
    for coords, gin, gout in (c for c, _ in captured["tdt"]):
        t_k = ks.tdt_from_coords_device(coords, gin, gout)
        t_p = ks.tdt_plain(coords, gin, gout)
        if not torch.equal(t_k, t_p):
            fail(f"tdt_from_coords_device differs from its plain version "
                 f"on {tuple(coords.shape)}")
    coords, gin, gout = captured["tdt"][0][0]
    tdt_out = torch.empty((gout.num_tiles, gin.num_tiles), dtype=torch.bool,
                          device=dev)
    h_, w_, kk_, _ = coords.shape
    tdt_args = (coords.data_ptr(), tdt_out.data_ptr(), h_, w_, kk_, gout.th,
                gout.tw, gout.cols, gout.num_tiles, gin.h, gin.w, gin.th,
                gin.tw, gin.cols, gin.num_tiles,
                torch.cuda.current_stream().cuda_stream)

    def tdt_launch():
        _build.check(lib.tdt_from_coords_launch(*tdt_args), "tdt launch")

    kernels["tdt_from_coords_device"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:62", max_abs_err=0.0,
        ms=cuda_time_ms(tdt_launch, 200),
        plain_ms=cuda_time_ms(lambda: ks.tdt_plain(coords, gin, gout), 20),
        library_ms=None, flops=0,
        bytes=coords.numel() * 4 + gout.num_tiles * gin.num_tiles,
        shape=f"coords {tuple(coords.shape)} -> "
              f"({gout.num_tiles}, {gin.num_tiles}), preallocated output")

    # (3) greedy Algorithm 1: every captured table against the plain
    # version and the numpy host loop; timed on the largest.
    for bt, m in (c for c, _ in captured["greedy"]):
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
    bt, m = max((c for c, _ in captured["greedy"]),
                key=lambda e: e[0].numel())
    n_out, n_in = bt.shape
    kernels["greedy_schedule_arrays"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:142", max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ks.greedy_schedule_arrays(bt, m), 10),
        plain_ms=cuda_time_ms(lambda: ks.greedy_plain(bt, m), 1, warmup=1),
        library_ms=None, flops=0,
        bytes=n_out * n_in * (1 + 4) + 8 * n_out,
        shape=f"TDT ({n_out}, {n_in}), m={m}")

    # (4) one image's schedule, first DCN group of the batched prepass.
    a4, k4 = captured["sched"][0]
    err4 = hold_fused("dcn_fused_schedule", captured["sched"],
                      kf.dcn_fused_schedule, kf.dcn_fused_schedule_plain,
                      FUSED_RTOL)
    x4, dep4, cnt4, idx4, cf4, w4 = a4[:6]
    t4, p4 = idx4.shape[:2]
    live4 = int((cnt4 > 0).sum())
    kernels["dcn_fused_schedule"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_schedule.cu",
        replaces="src/repro/kernels/dcn_fused.py:116", max_abs_err=err4,
        ms=cuda_time_ms(lambda: kf.dcn_fused_schedule(*a4, **k4), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_schedule_plain(*a4), 5),
        library_ms=contraction(t4 * p4, w4),
        flops=fused_flops(live4 * p4, *w4.shape),
        bytes=nbytes_of(a4, t4 * p4 * w4.shape[2]),
        shape=f"T={t4} T_in={x4.shape[0]} tp={x4.shape[1]} P={p4} "
              f"KK={w4.shape[0]} C={w4.shape[1]} O={w4.shape[2]} "
              f"k_pad={dep4.shape[1]} live_rows={live4}")

    # (5) one tile with its halo resident: held here on the whole
    # 14x14x512 plane of deformable_conv2d_pallas; the per_tile path's own
    # tiles are captured and held in phase 3c, where it is also timed.
    a5, k5 = captured["plane_tile"][0]
    err5_plane = hold_fused("dcn_fused_tile (whole plane)",
                            captured["plane_tile"], kf.dcn_fused_tile,
                            kf.dcn_fused_tile_plain, FUSED_RTOL)
    x5, idx5, cf5, w5 = a5[:4]
    live5 = int((cf5.reshape(*cf5.shape[:-2], -1) != 0).any(-1).sum())
    plane_tile = dict(
        err=err5_plane,
        ms=cuda_time_ms(lambda: kf.dcn_fused_tile(*a5, **k5), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_tile_plain(*a5), 5),
        library_ms=contraction(idx5.shape[-3], w5),
        bound_ms=max(fused_flops(live5, *w5.shape) / peak_flops,
                     nbytes_of(a5, idx5.shape[-3] * w5.shape[2])
                     / peak_bw) * 1e3,
        shape=f"S={x5.shape[-2]} P={idx5.shape[-3]} live={live5} "
              f"KK={w5.shape[0]} C={w5.shape[1]} O={w5.shape[2]}")

    # (6) standalone BLI at the 14x14x512 DCN layer.
    a6, k6 = captured["bli"][0]
    x6, idx6, cf6 = a6
    d6, s6 = rel_err(kb.bli_tile_matmul(*a6, **k6), kb.bli_tile_plain(*a6))
    if not d6 <= BLI_RTOL * s6:
        fail(f"bli_tile_matmul: max|d|={d6} > {BLI_RTOL}*{s6}")
    n6, p6, c6 = x6.shape[0], idx6.shape[1], x6.shape[2]
    live6 = int((cf6 != 0).any(-1).sum())
    w_bag, i_bag, c_bag = x6[0], idx6[0].long(), cf6[0]
    kernels["bli_tile_matmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_bli.cu",
        replaces="src/repro/kernels/dcn_bli.py:32", max_abs_err=d6,
        ms=cuda_time_ms(lambda: kb.bli_tile_matmul(*a6, **k6), 200),
        plain_ms=cuda_time_ms(lambda: kb.bli_tile_plain(*a6), 20),
        library_ms=cuda_time_ms(lambda: torch.nn.functional.embedding_bag(
            i_bag, w_bag, per_sample_weights=c_bag, mode="sum"), 200),
        flops=8 * live6 * c6,
        bytes=nbytes_of(a6, n6 * p6 * c6),
        shape=f"S={x6.shape[1]} P={p6} (live {live6}) C={c6}")
    print(f"[kernels] all {sum(len(v) for v in captured.values())} captured "
          f"calls agree with their plain versions (fused kernels within "
          f"{FUSED_RTOL}*max|ref|, BLI within {BLI_RTOL}*max|ref|, TDT and "
          f"greedy bit-exact, greedy also == numpy schedule_tiles)")
    print(f"[kernel] {card}: dcn_fused_tile on the whole plane "
          f"({plane_tile['shape']}): {plane_tile['ms']:.4f} ms (bound "
          f"{plane_tile['bound_ms']:.4f} ms by operations, plain "
          f"{plane_tile['plain_ms']:.4f} ms, library "
          f"{plane_tile['library_ms']:.4f} ms), max|d| "
          f"{plane_tile['err']:.3e}")

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

    def no_ladder(what, eng):
        st = eng.stats
        if st["step_retries"] or st["degraded_steps"]:
            fail(f"{what}: {st['step_retries']} retries and "
                 f"{st['degraded_steps']} degraded steps without an "
                 f"injected fault")

    eng = make_engine("device")
    builds0 = eng.host_schedule_builds
    reset_counts()
    reqs, traces, wall = serve(eng)
    read_counts("dcn_fused_batch", "tdt_from_coords_device",
                "greedy_schedule_arrays")
    builds = eng.host_schedule_builds - builds0
    steps = len(traces)
    no_ladder("serve", eng)
    if builds != 0:
        fail(f"{builds} host schedule builds on the device-scheduled path")
    bad = [r.rid for r in reqs if not r.done or r.error is not None]
    if bad:
        fail(f"requests {bad} did not resolve cleanly: "
             f"{[repr(r.error) for r in reqs if r.error]}")
    worst = max(check_logits(f"request {r.rid}", r.result(),
                             dense_logits(images[ids]))
                for r, ids in zip(reqs, requests))
    print(f"[serve] {len(reqs)} requests, {sum(map(len, requests))} images "
          f"in {steps} steps; logits finite; max|served - dense| / "
          f"max|dense| = {worst:.3e} (limit {LOGIT_RTOL})")
    check_sim("serve", traces)

    def records(tr):
        return [[(g.image, g.group)] + [dataclasses.astuple(r)
                                        for r in g.records]
                for g in tr.groups]

    host_eng = make_engine("host")
    _, host_traces, _ = serve(host_eng)
    no_ladder("host-scheduled serve", host_eng)
    if [records(t) for t in traces] != [records(t) for t in host_traces]:
        fail("device- and host-scheduled engines produced different "
             "trace records")
    if host_eng.host_schedule_builds == 0:
        fail("the host-scheduled engine built no host schedule")
    print(f"[serve] trace == DRAM simulator on all {steps} steps; host-"
          f"scheduled engine gives identical records; no retried or "
          f"degraded step")

    lat = sorted(r.latency_s for r in reqs)
    n_img = sum(map(len, requests))

    def pct(q):
        return float(np.percentile(np.asarray(lat), q))

    stats = eng.stats
    print(f"[serve] {card}: {n_img / wall:.3f} images/s, request latency "
          f"p50 {pct(50) * 1e3:.1f} ms p99 {pct(99) * 1e3:.1f} ms, "
          f"{steps} steps, {stats['kernel_dispatches']} dispatches, "
          f"schedule-cache image hit rate {stats['image_hit_rate']:.3f}")

    # -- phase 3b: fault-tolerant serving, the degraded step -----------------
    def fault_engine(**plan):
        inj = FaultInjector(**plan)
        e = DcnServingEngine(
            params, cfg, slots=4, device=dev, faults=inj,
            graph=fx.GraphConfig(tile=8, schedule_backend="device"))
        seen = []
        absorb = e._absorb_trace

        def keep(tr):
            seen.append(tr)
            absorb(tr)

        e._absorb_trace = keep
        return e, inj, seen

    def fault_run(ids, **plan):
        e, inj, seen = fault_engine(**plan)
        rq = [e.submit(images[i]) for i in ids]
        t0 = time.perf_counter()
        done = e.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sorted(r.rid for r in done) != [r.rid for r in rq]:
            fail(f"fault run {plan}: requests did not resolve exactly once")
        check_sim(f"fault run {plan}", seen)
        return e, inj, rq, wall

    # Tagged: the fault names its image; that request fails, its
    # step-mates resolve through the evicted retry.
    tag_ids = [10, 11, 12, 13]
    e_t, inj_t, rq_t, _ = fault_run(tag_ids, kinds=("dispatch",), rate=1.0,
                                    max_fires=1, seed=3)
    failed = [r for r in rq_t if r.failed]
    st = e_t.stats
    if (inj_t.fired["dispatch"] != 1 or len(failed) != 1
            or not isinstance(failed[0].error, RequestFailedError)
            or not isinstance(failed[0].error.__cause__, FaultError)
            or (st["step_retries"], st["degraded_steps"]) != (1, 0)):
        fail(f"tagged fault: fired {inj_t.fired}, failed "
             f"{[repr(r.error) for r in failed]}, retries "
             f"{st['step_retries']}, degraded {st['degraded_steps']}")
    for r, i in zip(rq_t, tag_ids):
        if not r.failed:
            check_logits(f"tagged-fault step-mate {r.rid}", r.result(),
                         dense_logits(images[i:i + 1]))
    print(f"[faults] tagged dispatch fault: request {failed[0].rid} failed "
          f"with RequestFailedError({type(failed[0].error.__cause__).__name__}"
          f"), its {len(rq_t) - 1} step-mates served by the evicted retry; "
          f"retries 1, degraded 0")

    # Untagged: no image to evict, so the step degrades to per-image
    # batched dispatch through the schedule kernel.
    deg_ids = [4, 5, 6, 7]
    reset_counts()
    e_u, inj_u, rq_u, wall_u = fault_run(
        deg_ids, kinds=("dispatch",), rate=1.0, max_fires=1,
        tag_image=False, seed=7)
    deg_counts = read_counts("dcn_fused_schedule")
    st = e_u.stats
    if (inj_u.fired["dispatch"] != 1 or any(r.failed for r in rq_u)
            or st["degraded_steps"] < 1 or st["step_retries"] != 1):
        fail(f"untagged fault: fired {inj_u.fired}, failed "
             f"{[r.rid for r in rq_u if r.failed]}, stats {st}")
    if any(g.dispatch != "batched" for g in e_u.last_trace.groups):
        fail("the degraded step did not run dispatch='batched'")
    worst_u = 0.0
    for r, i in zip(rq_u, deg_ids):
        out = r.result()
        worst_u = max(worst_u,
                      check_logits(f"degraded request {r.rid}", out,
                                   dense_logits(images[i:i + 1])),
                      check_logits(f"degraded request {r.rid} vs infer()",
                                   out, e_u.infer(images[i:i + 1])
                                   .cpu().numpy()))
    print(f"[faults] untagged dispatch fault: the step degraded to "
          f"per-image batched dispatch ({st['degraded_steps']} degraded, "
          f"{st['step_retries']} retried) in {wall_u * 1e3:.1f} ms; "
          f"dcn_fused_schedule launched {deg_counts['dcn_fused_schedule']} "
          f"times; {len(rq_u)} requests served, max rel. deviation from "
          f"dense and infer() {worst_u:.3e}; traces == simulator")

    # -- phase 3c: per_tile dispatch, the pallas/pipeline backends, BLI ------
    x1 = torch.as_tensor(images[14:15], device=dev)
    ref1 = dense_logits(images[14:15])
    reset_counts()
    tile_calls = []
    t0 = time.perf_counter()
    with recording(fx, "dcn_fused_tile", tile_calls):
        y_pt, tr_pt = fx.run_graph(
            params["convs"], graph, x1,
            config=fx.GraphConfig(tile=8, dispatch="per_tile",
                                  schedule_backend="device"),
            schedule_cache=ScheduleCache(), return_trace=True)
    torch.cuda.synchronize()
    wall_pt = time.perf_counter() - t0
    read_counts("dcn_fused_tile")
    check_logits("per_tile", apply_head(params, cfg, y_pt).cpu().numpy(),
                 ref1)
    check_sim("per_tile", [tr_pt])
    err5 = hold_fused("dcn_fused_tile (per_tile path)", tile_calls,
                      kf.dcn_fused_tile, kf.dcn_fused_tile_plain, FUSED_RTOL)
    a5t, k5t = tile_calls[0]
    x5t, idx5t, cf5t, w5t = a5t[:4]
    live5t = int((cf5t.reshape(cf5t.shape[0], -1) != 0).any(-1).sum())
    kernels["dcn_fused_tile"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_schedule.cu",
        replaces="src/repro/kernels/dcn_fused.py:38", max_abs_err=err5,
        ms=cuda_time_ms(lambda: kf.dcn_fused_tile(*a5t, **k5t), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_tile_plain(*a5t), 5),
        library_ms=contraction(idx5t.shape[0], w5t),
        flops=fused_flops(live5t, *w5t.shape),
        bytes=nbytes_of(a5t, idx5t.shape[0] * w5t.shape[2]),
        shape=f"S={x5t.shape[0]} P={idx5t.shape[0]} live={live5t} "
              f"KK={w5t.shape[0]} C={w5t.shape[1]} O={w5t.shape[2]}")
    print(f"[modes] per_tile at {cfg.img_size}x{cfg.img_size}: "
          f"{tr_pt.kernel_dispatches} dispatches "
          f"({launches['dcn_fused_tile']} tile-kernel launches, "
          f"{tr_pt.total_recomputes} recomputes) in {wall_pt:.2f} s; logits "
          f"match dense; trace == simulator")
    for backend in ("pallas", "pipeline"):
        out = dcn_net_apply(params, cfg, x1, backend=backend).cpu().numpy()
        d = check_logits(f"backend={backend}", out, ref1)
        print(f"[modes] dcn_net_apply(backend={backend!r}): max rel. "
              f"deviation from dense {d:.3e}")
    reset_counts()
    deformed = ops.bli_pallas(dcn_in, dcn_coords)
    torch.cuda.synchronize()
    read_counts("bli_tile_matmul")
    d, sc = rel_err(deformed, bilinear_sample(dcn_in, dcn_coords))
    if not d <= BLI_RTOL * sc:
        fail(f"bli_pallas vs bilinear_sample: max|d|={d} > {BLI_RTOL}*{sc}")
    print(f"[modes] bli_pallas {tuple(deformed.shape)} vs bilinear_sample: "
          f"max|d| {d:.3e} (limit {BLI_RTOL}*{sc:.3f})")

    # -- phase 4: where one serving step's time goes -------------------------
    profile_step(eng, images[12:16], card)
    no_ladder("profiled step", eng)

    out_k = []
    for name in wrappers:
        kd = kernels[name]
        compute_ms = kd.pop("flops") / peak_flops * 1e3
        bytes_ms = kd.pop("bytes") / peak_bw * 1e3
        kd["bound_ms"] = max(compute_ms, bytes_ms)
        kd["bound_by"] = "operations" if compute_ms > bytes_ms else "bytes"
        kd["launches"] = launches[name]
        shape = kd.pop("shape")
        lib_ms = kd["library_ms"]
        print(f"[kernel] {card}: {name} at {shape}: {kd['ms']:.4f} ms "
              f"(bound {kd['bound_ms']:.6f} ms by {kd['bound_by']}, plain "
              f"{kd['plain_ms']:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}), "
              f"{kd['launches']} launches on its path")
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
