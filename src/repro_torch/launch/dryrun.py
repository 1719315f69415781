"""Multi-pod dry run: every (architecture x input-shape) cell on the
production meshes, run on fake tensors, with each chip's memory, FLOPs,
HBM-traffic proxy and copied bytes recorded.

The JAX package lowers and compiles each cell for 256 or 512 forced host
devices and reads the compiled HLO. The port runs the card's own program
instead: ``build_step`` on a mesh of ``meta:i`` devices
(``launch.mesh.make_production_mesh``), once, on the fake stand-ins of
its arguments (``StepBundle.args_abstract``), under
``launch.op_analysis.analyze_step``, which charges every aten op and
kernel launch to its device. It runs on a machine without a card or JAX.
Each cell runs the program the card runs: a prefill cell with
``use_flash=True`` (#7), a decode cell through #8, a train cell through
``_sdpa`` (no kernel has a backward); #7 / #8 are counted, not run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 40 x 2 cells

One JSON record a cell lands in ``dryrun_torch/<arch>__<shape>__<mesh>
.json`` at the repo root (``--out`` elsewhere), with the JAX record's keys
but ``trace_s`` (the run's wall time) for ``lower_s`` / ``compile_s``, no
``generated_code_bytes``, XLA ``cost`` or ``hlo_bytes``, and the
collectives by the port function that copied, not by HLO kind. An
existing record is kept unless ``--force``. A pod1 cell issues every
rank's ops from one thread: it takes minutes (PERF.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.op_analysis import analyze_step
from repro_torch.launch.sharding import sharding_rules
from repro_torch.launch.steps import build_step
from repro_torch.optim import AdamWConfig

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "dryrun_torch")


# --- the JAX dry run's hillclimb variants: config / rule overrides ------

def _v_remat_full(cfg, rules):
    return dataclasses.replace(cfg, remat="full"), rules


def _v_flashlike(cfg, rules):
    return dataclasses.replace(cfg, remat="full", attn_impl="chunked",
                               attn_chunk=2048), rules


def _v_fsdp(cfg, rules):
    """Drop TP, go 256-way FSDP+DP on the single-pod mesh: batch and the
    d_model weight dim both shard over ("data", "model")."""
    rules = dict(rules)
    rules.update(batch=("data", "model"), embed=("data", "model"),
                 heads=None, kv_heads=None, mlp=None, vocab=None,
                 heads_inner=None)
    return cfg, rules


def _v_cap1(cfg, rules):
    moe = dataclasses.replace(cfg.moe, capacity_factor=1.0)
    return dataclasses.replace(cfg, moe=moe), rules


def _v_chunk512(cfg, rules):
    return dataclasses.replace(cfg, attn_chunk=512), rules


def _v_serve_tp(cfg, rules):
    """Decode layout: weights stationary. Expert FFNs switch to the F-
    sharded TP path (no per-step FSDP gathers); dense weights drop the
    d_model FSDP axis (TP over "model" alone suffices at decode)."""
    rules = dict(rules)
    rules["embed"] = None
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, weight_mode="tp_f"))
    return cfg, rules


VARIANTS = {
    "remat_full": _v_remat_full,
    "flashlike": _v_flashlike,
    "fsdp": _v_fsdp,
    "cap1": _v_cap1,
    "chunk512": _v_chunk512,
    "serve_tp": _v_serve_tp,
}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             force: bool = False, art_dir: str = ART_DIR,
             variant: str | None = None) -> dict:
    """One cell's record, written to ``art_dir`` (kept there unless
    ``force``)."""
    os.makedirs(art_dir, exist_ok=True)
    stem = f"{arch}__{shape_name}__{mesh_name}"
    if variant:
        stem += f"__{variant}"
    path = os.path.join(art_dir, stem + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    ok, why = configs.cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "seq": shape.seq,
           "global_batch": shape.global_batch}
    if not ok:
        rec.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_name == "pod2"))
    rules_override = None
    if variant:
        rules = sharding_rules(cfg, kind=shape.kind,
                               long_ctx=(shape_name == "long_500k"))
        for v in variant.split(","):
            cfg, rules = VARIANTS[v](cfg, rules)
        rules_override = rules
        rec["variant"] = variant
    if shape.kind == "prefill":
        cfg = dataclasses.replace(cfg, use_flash=True)
    t0 = time.time()
    try:
        bundle = build_step(cfg, shape, mesh,
                            opt_cfg=AdamWConfig(state_dtype=torch.bfloat16),
                            rules_override=rules_override)
        score_dims = {shape.seq, cfg.attn_chunk,
                      -(-shape.seq // cfg.attn_chunk) * cfg.attn_chunk}
        ana = analyze_step(bundle.fn, *bundle.args_abstract, mesh=mesh,
                           score_dims=score_dims)
        colls = ana["collectives"]
        rec.update(
            status="ok",
            chips=mesh_chips(mesh),
            trace_s=round(time.time() - t0, 1),
            memory=ana["memory"],
            collectives={**colls, "total_bytes": sum(
                c["bytes"] for c in colls.values())},
            analysis={k: ana[k] for k in (
                "flops", "traffic_bytes", "attn_traffic_bytes",
                "traffic_by_kind", "collective_bytes", "collectives",
                "kernels", "ops", "off_mesh_ops", "per_device")},
        )
    except Exception as e:  # record the failure; the grid keeps going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="comma-joined hillclimb overrides: "
                         + ",".join(VARIANTS))
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in configs.ARCHS:
            for s in configs.SHAPES:
                for m in ("pod1", "pod2"):
                    cells.append((a, s, m))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells.append((args.arch, args.shape, args.mesh))

    failures = 0
    for a, s, m in cells:
        rec = run_cell(a, s, m, force=args.force, art_dir=args.out,
                       variant=args.variant)
        status = rec["status"]
        if status == "ok":
            ana = rec["analysis"]
            print(f"[dryrun] {a:24s} {s:12s} {m}: OK   "
                  f"trace={rec['trace_s']}s flops/dev={ana['flops']:.3g} "
                  f"coll/dev={ana['collective_bytes']:.3g}B", flush=True)
            mem = rec["memory"]
            print(f"         args={mem['argument_bytes'] / 1e9:.2f}GB "
                  f"out={mem['output_bytes'] / 1e9:.2f}GB "
                  f"temp={mem['temp_bytes'] / 1e9:.2f}GB per device",
                  flush=True)
        elif status == "skipped":
            print(f"[dryrun] {a:24s} {s:12s} {m}: SKIP {rec['reason'][:60]}",
                  flush=True)
        else:
            failures += 1
            print(f"[dryrun] {a:24s} {s:12s} {m}: FAIL {rec['error'][:120]}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
