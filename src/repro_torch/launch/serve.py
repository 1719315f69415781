"""Serving command line: initialise a model and run the continuous-batching
decode engine on it.

    python -m repro_torch.launch.serve --arch qwen3-1.7b [--device cpu]

Serves the arch's smoke config with random weights from ``--seed``, as
the JAX package's serve script does; prompts are drawn with numpy from
``--seed``. Runs on the card unless ``--device cpu``. As the JAX script,
it builds a (1, 1) mesh (``make_host_mesh(1, 1)`` on the card,
``DeviceMesh.on("cpu")`` under ``--device cpu``) and hands it to the
engine (``DecodeEngine(mesh=)``), so the MoE blocks run through the
expert-parallel path; a config whose ``ep`` is not 1 would need a larger
mesh, and the smoke configs have ``ep == 1``. A cross-attention
arch (llama-3.2-vision) is served, as by the JAX script, with its cross
cache left at zero (no image), and the script says so.

The script serves float32 params over a float32 cache and has no dtype
flag, as the JAX script has none. A bf16 or float16 model is served from
Python: ``lm.init_lm(cfg, seed, dtype=torch.float16)`` (or
``torch.bfloat16``) builds 16-bit params and ``DecodeEngine(params, cfg,
..., cache_dtype=torch.float16)`` keeps 16-bit caches; on a card the flash
kernels (#7 at prefill, #8 at decode) then run on 16-bit operands, #8
reading the caches as stored. A float32 model may keep a 16-bit cache as
well: #8 widens it in the kernel, exactly; a 16-bit model over a float32
cache has #8 round each value to the model's type as it reads it, as the
JAX package casts the cache.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
from repro_torch.models import lm
from repro_torch.serving import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.SUPPORTED_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=True)
    params = lm.init_lm(cfg, args.seed, device=args.device)
    mesh = make_host_mesh(1, 1) \
        if resolve_device(args.device).type == "cuda" \
        else DeviceMesh.on(args.device)
    engine = DecodeEngine(params, cfg, batch=args.batch,
                          max_len=args.max_len, mesh=mesh,
                          device=args.device)
    if cfg.d_cross:
        print(f"[serve] {cfg.name}: no image states given; the cross "
              f"layers decode against a zero cross cache (fill it with "
              f"lm.build_cross_cache to condition on an image)")

    rng = np.random.default_rng(args.seed + 1)
    for rid in range(args.requests):
        plen = int(rng.integers(2, 8))
        shape = (plen, cfg.n_codebooks) if cfg.n_codebooks > 1 else (plen,)
        prompt = rng.integers(0, cfg.vocab, size=shape).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    done = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"[serve] {cfg.name} on {engine.device}: {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, continuous "
          f"batching over {args.batch} slots, {engine.steps} steps)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt_len={len(r.prompt)} out={r.out[:8]}…")


if __name__ == "__main__":
    main()
