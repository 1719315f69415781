"""Where the bf16 split-C DCN kernels (#1, #4, #5) spend their time: clock64
per phase of a block's path, summed over every block of one launch.

    python tools/dcn_phases.py                      # this tree
    python tools/dcn_phases.py --src build/parent/src

Run from the repository root on a machine with a CUDA card. The script
copies ``<src>/repro_torch`` into ``build/dcn_phases/src`` (``.gitignore``
lists ``build/``), inserts timers into the copy's body of the bf16 calls
(the tree's own source is not touched), builds it and launches each call
once, after two untimed launches and an L2-evicting write, on the
operands ``chip_smoke.py`` phase 2 captures (``tools/kernel_ab.py``
``dcn_operands``) rounded to bf16: #1 at a 4-image ``batch_fused`` call,
#4 on one image, #5 per tile and on the whole plane.

Two bodies are known. The split body of ``csrc/dcn_fused_split.cuh``
(``split_kernel``, which ran bf16 calls in 2xTF32 until the Hopper body
replaced it) and the Hopper body of ``csrc/dcn_fused_bf16.cuh``
(``bf16_kernel``). For each call one ``PROF`` line gives the blocks that
ran the stage loop, their stages, each kernel's span on the global timer
(the split body's combine pass apart) and, per stage, a warp's mean
cycles in each phase, with its share of a block's path:

* ``pro``: from the block's start to the stage loop (tables, the
  resolution of each neighbour, the first copies);
* split body: ``afrag`` (w's A fragments reloaded from shared memory and
  widened), ``issue`` (the wgmma products), ``copy`` (starting the next
  stage's cp.async copies), ``wait`` (for this thread's copies, and the
  barrier at a chunk's first stage), ``interp`` (the next stage's
  interpolation and TF32 split), ``wwait`` (``wgmma_wait``), ``acc``
  (``acc += d``), ``bar`` (the stage's block barrier);
* Hopper body: ``wfull`` (the wait for the stage's w slice), ``issue``
  (the stage's six products), ``hwait`` (the wait for a chunk's halo),
  ``interp`` (the next stage's interpolation and three-piece split),
  ``wwait`` (``wgmma.wait_group 0`` and the slot's release); beside the
  path, a warp's cycles from the block's start to its barriers set up, to
  its raw tables landed and to its tables resolved (within ``pro``), and
  from the loop's end to the first cluster barrier passed (within
  ``epi``);
* ``epi``: after the loop to the block's end (the split body's partial
  sums or output; the Hopper body's merge of the cluster's slices).

The timers cost cycles and move the schedule: read the shares, and time
the kernel with ``tools/kernel_ab.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

# Slots of the profile array. 0-11: phase cycles summed over warps (the
# prologue and epilogue too); 12 warps; 13 stages summed over warps; 14 /
# 15 the main kernel's span, 16 / 17 the combine pass's (global timer,
# ns); 18 blocks (Hopper body: warpgroups) that ran the loop; 20 the
# Hopper body's cycles to its raw tables landed.
NSLOT = 24
_PRELUDE = """
static __device__ unsigned long long g_prof[24];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PADD(i, x) atomicAdd(&g_prof[i], (unsigned long long)(x))
static int prof_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof));
}
static int prof_reset() {
  unsigned long long z[24] = {0};
  z[14] = z[16] = ~0ull;
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""
# Appended to each .cu that includes the body: its own readers (each
# translation unit has its own copy of the counters).
_READERS = """
extern "C" int dcn_prof_read_{tag}(void* dst) {{ return prof_read(dst); }}
extern "C" int dcn_prof_reset_{tag}() {{ return prof_reset(); }}
"""

# The split body (dcn_fused_split.cuh, split_kernel and split_combine).
SPLIT_PHASES = ["pro", "afrag", "issue", "copy", "wait", "interp", "wwait",
                "acc", "bar", "epi"]
_SPLIT = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const long long P0 = clock64();\n"
     "  if (tid == 0) atomicMin(&g_prof[14], gtimer());\n"
     "  long long PC[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, PT;\n"),
    ("  __syncthreads();\n  for (int s = 0; s < n_stages; ++s) {\n"
     "    uint32_t ah[2][4], al[2][4];\n",
     "  __syncthreads();\n  PC[0] = clock64() - P0;\n"
     "  for (int s = 0; s < n_stages; ++s) {\n"
     "    PT = clock64();\n"
     "    uint32_t ah[2][4], al[2][4];\n"),
    ("    const float* bh = Bh + (s & 1) * PATCH;\n",
     "    PC[1] += clock64() - PT; PT = clock64();\n"
     "    const float* bh = Bh + (s & 1) * PATCH;\n"),
    ("    wgmma_commit();\n\n    if (s + RING - 1 < n_stages) {\n",
     "    wgmma_commit();\n    PC[2] += clock64() - PT; PT = clock64();\n\n"
     "    if (s + RING - 1 < n_stages) {\n"),
    ("    step();\n    if (s + 1 < n_stages) {\n"
     "      cp_async_wait<RING - 2>();\n"
     "      if (HALO && kk_n == 0) __syncthreads();\n"
     "      interpolate(slot, kk_n, chunk_n, (s + 1) & 1);\n    }\n",
     "    step();\n    PC[3] += clock64() - PT; PT = clock64();\n"
     "    if (s + 1 < n_stages) {\n"
     "      cp_async_wait<RING - 2>();\n"
     "      if (HALO && kk_n == 0) __syncthreads();\n"
     "      PC[4] += clock64() - PT; PT = clock64();\n"
     "      interpolate(slot, kk_n, chunk_n, (s + 1) & 1);\n"
     "      PC[5] += clock64() - PT; PT = clock64();\n    }\n"),
    ("#pragma unroll\n    for (int i = 0; i < 32; ++i) acc[i] += d[i];\n"
     "    __syncthreads();  // patch and w of stage s + 1 visible; stage s "
     "done\n  }\n",
     "    PC[6] += clock64() - PT; PT = clock64();\n"
     "#pragma unroll\n    for (int i = 0; i < 32; ++i) acc[i] += d[i];\n"
     "    PC[7] += clock64() - PT; PT = clock64();\n"
     "    __syncthreads();  // patch and w of stage s + 1 visible; stage s "
     "done\n    PC[8] += clock64() - PT;\n  }\n"
     "  const long long PE = clock64();\n"),
    ("        else\n          part[e] = acc[4 * j + v];\n      }\n    }\n}\n",
     "        else\n          part[e] = acc[4 * j + v];\n      }\n    }\n"
     "  PC[9] = clock64() - PE;\n"
     "  if (lane == 0) {\n"
     "    for (int i = 0; i < 11; ++i) PADD(i < 10 ? i : 20, PC[i]);\n"
     "    PADD(12, 1);\n    PADD(13, n_stages);\n"
     "    if (tid == 0) PADD(18, 1);\n  }\n"
     "  if (tid == 0) atomicMax(&g_prof[15], gtimer());\n}\n"),
    ("  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"
     "  const int o = blockIdx.y * COMBINE_NT + threadIdx.x;\n",
     "  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"
     "  if (threadIdx.x == 0) atomicMin(&g_prof[16], gtimer());\n"
     "  const int o = blockIdx.y * COMBINE_NT + threadIdx.x;\n"),
    ("  out[e] = narrow<T>(v);\n}\n",
     "  out[e] = narrow<T>(v);\n"
     "  if (threadIdx.x == 0) atomicMax(&g_prof[17], gtimer());\n}\n"),
]

# The Hopper body (dcn_fused_bf16.cuh, bf16_kernel): the markers it
# carries for this script (a comment line `// PROF <name>`, which becomes
# the statement of that name in `hopper_edits`).
HOPPER_PHASES = ["pro", "wfull", "issue", "wwait", "hwait", "interp", "epi"]


def instrument(src: str, edits) -> str:
    """``src`` with the timers of ``edits`` and the counters' prelude (put
    before the first ``namespace {``); raises if the body no longer has
    the expected shape."""
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"dcn_phases: the kernel changed shape; update "
                             f"the timers for:\n{old}")
        src = src.replace(old, new)
    k = src.index("namespace {")
    return src[:k] + _PRELUDE + src[k:]


def hopper_edits(src: str):
    """The Hopper body's timers, from its ``// PROF`` markers: each marker
    line becomes the statement of the same name below."""
    stmts = {
        "start": ("  const long long P0 = clock64();\n"
                  "  if (threadIdx.x == 0) atomicMin(&g_prof[14], gtimer());\n"
                  "  long long PC[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, PT = 0, "
                  "PE = 0;\n"),
        "loop": "  PC[0] = clock64() - P0;\n",
        "t": "    PT = clock64();\n",
        "wfull": "    PC[1] += clock64() - PT; PT = clock64();\n",
        "issue": "    PC[2] += clock64() - PT; PT = clock64();\n",
        "wwait": "    PC[3] += clock64() - PT; PT = clock64();\n",
        "hwait": "    PC[4] += clock64() - PT; PT = clock64();\n",
        "interp": "    PC[5] += clock64() - PT; PT = clock64();\n",
        "tab": "    PC[8] = clock64() - P0;\n",
        "bars": "  PC[7] = clock64() - P0;\n",
        "tabw": "    PC[10] = clock64() - P0;\n",
        "epi1": "  PC[9] = clock64() - PE;\n",
        "epi0": "    PE = clock64();\n",
        "end": ("  PC[6] = clock64() - PE;\n"
                "  if ((threadIdx.x & 31) == 0 && wg < 2 && (wg ? act1 : act0)) {\n"
                "    for (int i = 0; i < 11; ++i) PADD(i < 10 ? i : 20, PC[i]);\n"
                "    PADD(12, 1);\n    PADD(13, n_st);\n"
                "    if ((threadIdx.x & 127) == 0) PADD(18, 1);\n  }\n"
                "  if (threadIdx.x == 0) atomicMax(&g_prof[15], gtimer());\n"),
    }
    out = []
    for line in src.splitlines(keepends=True):
        s = line.strip()
        if s.startswith("// PROF "):
            name = s.split()[2]
            if name not in stmts:
                raise SystemExit(f"dcn_phases: unknown marker {name}")
            out.append(stmts[name])
        else:
            out.append(line)
    return "".join(out)


def copy_tree(src: str):
    """An instrumented copy of the ``repro_torch`` under ``src``; -> (the
    copy's ``src`` directory, the body's phase names)."""
    dst = os.path.join(ROOT, "build", "dcn_phases", "src")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    shutil.copytree(os.path.join(src, "repro_torch"),
                    os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "repro_torch", "csrc")
    hopper = os.path.join(csrc, "dcn_fused_bf16.cuh")
    if os.path.exists(hopper):
        path, phases = hopper, HOPPER_PHASES
        with open(path) as f:
            text = hopper_edits(f.read())
        k = text.index("namespace {")
        text = text[:k] + _PRELUDE + text[k:]
    else:
        path, phases = os.path.join(csrc, "dcn_fused_split.cuh"), SPLIT_PHASES
        with open(path) as f:
            text = instrument(f.read(), _SPLIT)
    with open(path, "w") as f:
        f.write(text)
    for name, tag in (("dcn_fused_batch.cu", "batch"),
                      ("dcn_fused_schedule.cu", "sched")):
        with open(os.path.join(csrc, name), "a") as f:
            f.write(_READERS.format(tag=tag))
    return dst, phases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory holding the repro_torch package")
    args = ap.parse_args()
    import kernel_ab

    src, phases = copy_tree(os.path.abspath(args.src))
    hopper = phases is HOPPER_PHASES
    sys.path.insert(0, src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dcn_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build

    if not repro_torch.__file__.startswith(src):
        raise SystemExit(f"dcn_phases: imported {repro_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    lib = _build.load()
    for line in kernel_ab.ptxas_lines(_build.build_log):
        print(f"PTXAS {line}")
    for tag in ("batch", "sched"):
        getattr(lib, f"dcn_prof_read_{tag}").argtypes = [ctypes.c_void_p]
    on_path = phases
    for key, fn, a, kw, at in kernel_ab.dcn_operands(torch, np):
        a16 = [t.to(torch.bfloat16) if i in at else t
               for i, t in enumerate(a)]
        tag = "batch" if key == "batch" else "sched"
        for _ in range(2):
            fn(*a16, **kw)
        flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
        flush.zero_()           # evicts the operands from the L2 cache
        del flush
        torch.cuda.synchronize()
        _build.check(getattr(lib, f"dcn_prof_reset_{tag}")(), "prof_reset")
        fn(*a16, **kw)
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * NSLOT)()
        _build.check(getattr(lib, f"dcn_prof_read_{tag}")(got), "prof_read")
        warps, stages = max(got[12], 1), max(got[13], 1)
        # Loop phases a stage of a warp; the prologue and epilogue a
        # warp's whole run, spread over its stages for the shares.
        per = {n: got[i] / stages for i, n in enumerate(phases)}
        path = sum(per[n] for n in on_path)
        span = (got[15] - got[14]) / 1e3
        comb = ((got[17] - got[16]) / 1e3 if got[17] >= got[16] > 0
                and got[16] != 2 ** 64 - 1 else 0.0)
        print(f"PROF {key} grid {fn.last_grid}: blocks in the loop "
              f"{got[18]}, warps {got[12]}, stages a warp "
              f"{stages / warps:.1f}, kernel span {span:.2f} us"
              + (f", combine span {comb:.2f} us" if not hopper else "")
              + " | cycles a stage: "
              + " ".join(f"{n} {per[n]:.0f}" for n in on_path)
              + " | shares of the path: "
              + " ".join(f"{n} {100 * per[n] / path:.1f}%" for n in on_path)
              + ("" if not hopper else
                 f" | a warp's cycles to the block's barriers set up "
                 f"{got[7] / warps:.0f}, to its raw tables landed "
                 f"{got[20] / warps:.0f}, to its tables resolved "
                 f"{got[8] / warps:.0f} (of pro {got[0] / warps:.0f}), "
                 f"to the first cluster barrier passed {got[9] / warps:.0f}"
                 f" (of epi {got[6] / warps:.0f})"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
