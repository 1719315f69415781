"""Time the split-C DCN kernels (#1, #4, #5), the flash kernel (#7) and
the decode kernel (#8) of one source tree of ``repro_torch``, to compare
two trees on one card.

    python tools/kernel_ab.py --src build/parent/src
    python tools/kernel_ab.py --src src --only flash

Run from the repository root on a machine with a CUDA card. ``--src`` is
the directory that holds the ``repro_torch`` package to time; its kernels
are built from that tree's own sources (into ``build/`` beside it). To
compare a commit with its parent, unpack the parent into a directory that
``.gitignore`` lists (``git archive``) and run parent, change, change,
parent in one session on one card.

The DCN operands are the ones ``chip_smoke.py`` phase 2 holds: VGG19-3
DCN-II at 224x224 with the same seeds, #1 from a 4-image ``run_graph``
(batch_fused), #4 from one image through ``batched``, #5 from one image
through ``per_tile`` (one tile) and from ``deformable_conv2d_pallas`` on
the whole 14x14x512 plane; each is timed in float32 and, where the tree
takes it, on the same values rounded to bf16 (its grid printed on a
``GRID`` line), beside ``torch.matmul`` of its contraction in float32 and
in bf16 (``matmul_f32`` / ``matmul_bf16`` keys; the bf16 one rounds the
patch, so it is not the same function: a yardstick only). #8 is timed on random
float32 operands at Qwen3-1.7B's decode shapes (B=4 S=512 and B=8
S=32768, Hq=16 Hkv=8 D=128), and with ``round_kv`` under a bf16 q where
the tree has it; over bf16 caches under a float32 and a bf16 q at
``DECODE_BF16``'s five shapes (Qwen3's serving shape and 32k cache,
llama-3.2-vision's self layer and cross cache, a Gemma-2 window with 64
splits forced), each beside SDPA bf16 on the same values (``sdpa ...``
keys) and its bytes bound at 2 B a value (``bound ...`` keys, computed). #7 is timed on random bf16 operands at the five shapes
``chip_smoke.py`` phase 13a holds (``BF16_SIZES["flash"]``: Qwen3-1.7B and
granite prefill, a Gemma-2 local layer, llama-3.2-vision's self and
cross layers) and in float32 at Qwen3-1.7B's 4 x 2048 prefill. The
general bodies of #7 and #8 (``csrc/attention_any.cu``) are timed at
``chip_smoke.py`` phase 18d's two timed shapes (#7: Gemma-7B's D 256, 1 x
2048, 16 / 16 heads, causal; #8: Falcon-7B's 71 query heads over one kv
head, D 64, B 4 x 2048 rows, lengths drawn from seed SEED + 20) in
float32, bf16 and float16, each beside SDPA in the same type (``any_flash
<type>``, ``any_decode <type>``, ``sdpa any_... <type>`` keys), #8 also at
8 splits forced (``any_decode <type> splits 8``) and, where the plan cuts
a group into chunks (``GENERAL_DECODE_FRAGS``), with the whole group in one
block (``any_decode <type> one block a group``); the general body is
also timed against the split body at the latter's own shapes
(``SPLIT_SHAPES``) over float32 and float16 caches (``split <shape>
<type>``, ``general <shape> <type>``). Times are
means of CUDA-event windows after an L2-evicting write
(``chip_smoke.cuda_time_ms``). ``--only`` times one group: ``dcn``,
``flash``, ``decode`` or ``any``.

Prints the card's name and power limit, one ``PTXAS`` line per split-C,
bf16 DCN, flash and decode kernel instantiation with its registers and
spills (and one per ptxas warning, a serialized wgmma among them), and
one ``RESULT <src> {json}`` line of times in ms.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts the checkout's src on the path)

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_KERNEL = re.compile(r"(split_kernel|split_combine|bf16_kernel|decode_kernel|"
                     r"decode_bf16_kernel|flash_kernel_bf16|flash_kernel)"
                     r"(I.*?E)Ev")


def ptxas_lines(build_log: str) -> list[str]:
    """``<kernel><template args> | <spills> | <registers>`` for each
    split-C, bf16 DCN, flash and decode kernel entry of an ``nvcc -Xptxas
    -v`` log, and every ptxas warning (a serialized wgmma among them)."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "serialized" in line or ("warning" in line.lower()
                                    and "ptxas" in line.lower()):
            out.append(f"warning | {line.strip()}")
            continue
        m = _ENTRY.search(line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = k.group(1) + k.group(2) if k else None
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name} | {spill} | {line.split(':', 1)[-1].strip()}")
            name = None
    return out


def dcn_operands(torch, np):
    """The first captured call of #1, #4 and #5 (per tile, whole plane)
    at chip_smoke's VGG19-3 operands: (name, wrapper, args, kwargs,
    positions of x / w / b)."""
    from repro_torch.core.deform import randomize_offset_conv
    from repro_torch.kernels import dcn_fused as kf
    from repro_torch.kernels import ops
    from repro_torch.models.dcn_models import DcnNetConfig, init_dcn_net
    from repro_torch.runtime import fused_exec as fx
    from repro_torch.runtime.cache import ScheduleCache
    from repro_torch.runtime.graph import (DeformNode, PoolNode,
                                           UpsampleNode, build_graph)

    dev = torch.device("cuda")
    cfg = DcnNetConfig("vgg19", n_deform=3, variant="dcn2", img_size=224,
                       width_mult=1.0, num_classes=1000)
    params = init_dcn_net(cs.SEED, cfg, device=dev)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    params["convs"] = [
        randomize_offset_conv(p, gen, 2.0 / p.w.shape[2])
        if hasattr(p, "w_off") else p for p in params["convs"]]
    graph = build_graph(cfg)
    images = np.random.default_rng(cs.SEED + 2).normal(
        size=(16, 224, 224, 3)).astype(np.float32)
    x = torch.as_tensor(images[:cs.N_BATCH], device=dev)
    got = {k: [] for k in ("batch", "sched", "tile", "plane")}
    with cs.recording(fx, "dcn_fused_batch", got["batch"]):
        fx.run_graph(params["convs"], graph, x,
                     schedule_cache=ScheduleCache(),
                     config=fx.GraphConfig(tile=8, schedule_backend="device"))
    for mode, key, name in (("batched", "sched", "dcn_fused_schedule"),
                            ("per_tile", "tile", "dcn_fused_tile")):
        with cs.recording(fx, name, got[key]):
            fx.run_graph(params["convs"], graph, x[:1],
                         schedule_cache=ScheduleCache(),
                         config=fx.GraphConfig(tile=8, dispatch=mode,
                                               schedule_backend="device"))
    # The whole plane of the first DCN layer (image 0), as chip_smoke's
    # phase 2 captures it.
    plane = x[:1]
    for node in graph.nodes:
        if isinstance(node, DeformNode):
            p_dcn = params["convs"][node.param_idx]
            break
        if isinstance(node, (PoolNode, UpsampleNode)):
            plane = fx.apply_boundary_batch(plane, node)
        else:
            plane = fx._advance_dense_batch(
                plane, node, params["convs"][node.param_idx], None)
    with cs.recording(ops, "dcn_fused_tile", got["plane"]):
        ops.deformable_conv2d_pallas(plane.contiguous(), p_dcn)
    torch.cuda.synchronize()
    at = {"batch": (0, 6, 7), "sched": (0, 5, 6), "tile": (0, 3, 4),
          "plane": (0, 3, 4)}
    fns = {"batch": kf.dcn_fused_batch, "sched": kf.dcn_fused_schedule,
           "tile": kf.dcn_fused_tile, "plane": kf.dcn_fused_tile}
    return [(k, fns[k], list(got[k][0][0]), got[k][0][1], at[k])
            for k in at]


# #8 over a bf16 cache: (name, B, S, Hq, Hkv, D, options, lengths). The
# llama self layer's lengths sum to the 663 visible keys of the operands
# chip_smoke.py phase 13b times; the Gemma-2 lengths are ragged around its
# 4096-key window.
DECODE_BF16 = [
    ("Qwen3 serving", 4, 512, 16, 8, 128, {}, [459, 443, 420, 438]),
    ("32k", 8, 32768, 16, 8, 128, {},
     [2278, 26576, 30867, 8568, 5556, 2530, 26181, 31014]),
    ("llama self", 4, 512, 32, 8, 128, {}, [201, 77, 236, 149]),
    ("llama cross", 4, 1601, 32, 8, 128, {}, [1601] * 4),
    ("Gemma-2 window 64 splits", 4, 8192, 32, 16, 144,
     dict(window=4096, softcap=50.0, num_splits=64),
     [6519, 2048, 8192, 4711]),
]


# DECODE_BF16's shapes that phase 18a times #8's split body at.
SPLIT_SHAPES = ("Qwen3 serving", "32k", "llama cross")


def bf16_decode_operands(torch, b, s, hq, hkv, d, lengths, seed):
    """Random bf16 caches and a float32 q (rounded to bf16 values, so the
    bf16 q is the same numbers) and int32 lengths, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    return q.float(), k, v, torch.tensor(lengths, dtype=torch.int32,
                                         device="cuda")


def visible_keys(lengths, s, window=None) -> int:
    """Keys the masks leave visible, summed over the batch."""
    return sum(max(0, min(n, s) - (max(0, n - window) if window else 0))
               for n in lengths)


def decode_operands(torch, b, s, lengths, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hq, hkv, d = 16, 8, 128
    q = torch.randn((b, hq, d), generator=gen, device="cuda")
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def flash_operands(torch, b, sq, skv, hq, hkv, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                          (b, skv, hkv, d))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", choices=("dcn", "flash", "decode", "any"))
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    import repro_torch

    if not repro_torch.__file__.startswith(src):
        raise SystemExit(f"kernel_ab: imported {repro_torch.__file__}, not "
                         f"the tree under {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    print(cs.card_line())
    _build.load()
    for line in ptxas_lines(getattr(_build, "build_log", "")):
        print(f"PTXAS {args.src} {line}")

    def want(group):
        return args.only in (None, group)

    res = {}
    for key, fn, a, kw, at in dcn_operands(torch, np) if want("dcn") else []:
        res[key] = cs.cuda_time_ms(lambda: fn(*a, **kw), args.iters)
        # torch.matmul of the contraction, (output pixels, KK * C) by
        # (KK * C, O), in float32 and in bf16.
        w = a[at[1]]
        idx = a[{"batch": 4, "sched": 3}.get(key, 1)]
        rows = (a[1].shape[0] * idx.shape[1] if key == "batch"
                else idx.numel() // (idx.shape[-2] * 4))
        w2 = w.reshape(-1, w.shape[-1])
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            patch = torch.randn(rows, w2.shape[0], device="cuda").to(dt)
            wt = w2.to(dt)
            res[f"matmul_{tag} {key}"] = cs.cuda_time_ms(
                lambda: torch.matmul(patch, wt), args.iters)
        a16 = [t.to(torch.bfloat16) if i in at else t
               for i, t in enumerate(a)]
        try:
            fn(*a16, **kw)
        except ValueError:      # a tree whose kernel refuses bf16
            continue
        res[key + "_bf16"] = cs.cuda_time_ms(lambda: fn(*a16, **kw),
                                             args.iters)
        print(f"GRID {args.src} {key}_bf16 {fn.last_grid}")
    flash = [(f"flash_bf16 {name}", torch.bfloat16, shape, opts)
             for name, *shape, opts in cs.BF16_SIZES["flash"]]
    flash.append(("flash_f32 Qwen3-1.7B prefill", torch.float32,
                  (4, 2048, 2048, 16, 8, 128), {}))
    for tag, dtype, shape, opts in flash if want("flash") else []:
        q, k, v = flash_operands(torch, *shape, dtype, cs.SEED + 13)
        res[tag] = cs.cuda_time_ms(lambda: fa.flash_attention(q, k, v,
                                                              **opts),
                                   args.iters)
        del q, k, v
    params = inspect.signature(fd.flash_decode).parameters
    rounds = "round_kv" in params
    # round_kv is a bool in trees before fp16, a dtype since.
    rk = rounds and (torch.bfloat16 if params["round_kv"].default is None
                     else True)
    decode = [("decode_serve", 4, 512, [459, 443, 420, 438]),
              ("decode_32k", 8, 32768, [2278, 26576, 30867, 8568, 5556,
                                        2530, 26181, 31014])]
    for tag, b, s, lengths in decode if want("decode") else []:
        q, k, v, lens = decode_operands(torch, b, s, lengths, cs.SEED + 30)
        res[tag] = cs.cuda_time_ms(lambda: fd.flash_decode(q, k, v, lens),
                                   args.iters)
        if rounds:
            qb = q.to(torch.bfloat16)
            res[tag + "_round_kv"] = cs.cuda_time_ms(
                lambda: fd.flash_decode(qb, k, v, lens, round_kv=rk),
                args.iters)
    for name, b, s, hq, hkv, d, opts, lengths in (
            DECODE_BF16 if want("decode") else []):
        q, k, v, lens = bf16_decode_operands(torch, b, s, hq, hkv, d,
                                             lengths, cs.SEED + 31)
        qb = q.to(torch.bfloat16)
        for tag, qq in ((f"decode_bf16 {name} f32 q", q),
                        (f"decode_bf16 {name} bf16 q", qb)):
            res[tag] = cs.cuda_time_ms(
                lambda: fd.flash_decode(qq, k, v, lens, **opts), args.iters)
        w = opts.get("window")
        ki = torch.arange(s, device="cuda")[None, :]
        mask = ki < lens[:, None].long()
        if w is not None:
            mask &= ki > lens[:, None].long() - 1 - w
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        res[f"sdpa_bf16 {name}"] = cs.cuda_time_ms(cs.sdpa_yardstick(
            qb[:, :, None], kt, vt, attn_mask=mask[:, None, None, :],
            scale=d ** -0.5), args.iters)
        nbytes = 2 * 2 * visible_keys(lengths, s, w) * hkv * d
        res[f"bound_bf16 {name}"] = nbytes / 3.35e12 * 1e3
        del q, qb, k, v, kt, vt
    for dtype in ((torch.float32, torch.bfloat16, torch.float16)
                  if want("any") else ()):
        short = str(dtype).removeprefix("torch.")
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
        name, b, sq, skv, hq, hkv, d, opts = next(
            c for c in cs.F16_SIZES["any_flash"]
            if c[0] == cs.F16_SIZES["timed_flash"])
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                   for sh in ((b, sq, hq, d), (b, skv, hkv, d),
                              (b, skv, hkv, d)))
        res[f"any_flash {short}"] = cs.cuda_time_ms(
            lambda: fa.flash_attention(q, k, v, **opts), args.iters)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        res[f"sdpa any_flash {short}"] = cs.cuda_time_ms(cs.sdpa_yardstick(
            qt, kt, vt, is_causal=opts.get("causal", True)), args.iters)
        del q, k, v, qt, kt, vt
        name, b, s, hq, hkv, d, opts = next(
            c for c in cs.F16_SIZES["any_decode"]
            if c[0] == cs.F16_SIZES["timed_decode"])
        lens = torch.as_tensor(np.random.default_rng(cs.SEED + 20).integers(
            0, s + 1, size=b), dtype=torch.int32, device="cuda")
        q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
        kc, vc = (torch.randn((b, s, hkv, d), generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        for n in (None, 8):     # the split rule's count, and 8 forced
            res[f"any_decode {short}" + (f" splits {n}" if n else "")] = \
                cs.cuda_time_ms(lambda: fd.flash_decode(
                    q, kc, vc, lens, num_splits=n, **opts), args.iters)
        if hasattr(fa, "GENERAL_DECODE_FRAGS"):
            # The whole group in one block (five fragments of one warp).
            frags, fa.GENERAL_DECODE_FRAGS = fa.GENERAL_DECODE_FRAGS, 8
            res[f"any_decode {short} one block a group"] = cs.cuda_time_ms(
                lambda: fd.flash_decode(q, kc, vc, lens, **opts), args.iters)
            fa.GENERAL_DECODE_FRAGS = frags
        ki = torch.arange(s, device="cuda")[None, :]
        mask = (ki < lens[:, None].long())[:, None, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        res[f"sdpa any_decode {short}"] = cs.cuda_time_ms(cs.sdpa_yardstick(
            q[:, :, None], kt, vt, attn_mask=mask, scale=d ** -0.5),
            args.iters)
        del q, kc, vc, kt, vt
    # The general body at the split body's own shapes (phase 18a's: Qwen3's
    # serving shape and 32k cache, llama-3.2-vision's cross cache) over
    # float32 and float16 caches, q of the cache's type: the split body as
    # routed, and the general body forced by routing the call to it.
    for name, b, s, hq, hkv, d, opts, lengths in (
            [c for c in DECODE_BF16 if c[0] in SPLIT_SHAPES]
            if want("any") and hasattr(fa, "general_plan") else []):
        ops = bf16_decode_operands(torch, b, s, hq, hkv, d, lengths,
                                   cs.SEED + 31)
        lens = ops[3]
        for cache in (torch.float32, torch.float16):
            short = str(cache).removeprefix("torch.")
            q, k, v = (t.to(cache) for t in ops[:3])
            routed = fd.decode_body
            for body in ("split", "general"):
                if body == "general":
                    fd.decode_body = lambda *a, **kw: "general"
                try:
                    fd.flash_decode.bodies = {}
                    fd.flash_decode(q, k, v, lens)
                    assert fd.flash_decode.bodies == {body: 1}, \
                        fd.flash_decode.bodies
                    res[f"{body} {name} {short}"] = cs.cuda_time_ms(
                        lambda: fd.flash_decode(q, k, v, lens), args.iters)
                finally:
                    fd.decode_body = routed
            del q, k, v
    print(f"RESULT {args.src} "
          f"{json.dumps({k: round(t, 6) for k, t in res.items()})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
