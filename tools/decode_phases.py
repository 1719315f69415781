"""Where #8 over a bf16 cache spends its time: clock64 per phase of the
decode kernel, summed over every block of one launch.

    python tools/decode_phases.py                  # this tree, 3 shapes
    python tools/decode_phases.py --src build/parent/src --shapes all

Run from the repository root on a machine with a CUDA card. The script
copies ``<src>/repro_torch`` into ``build/decode_phases/<n>/src``
(``.gitignore`` lists ``build/``), inserts timers into the copy's kernel
that serves a bf16 cache (the tree's own source is not touched), builds
it and launches it once, after two untimed launches, at each shape of
``tools/kernel_ab.py``'s ``DECODE_BF16`` named by ``--shapes`` (default:
llama-3.2-vision's self layer and cross cache, and Qwen3's 32k cache),
under a bf16 q.

Two bodies are known: the split body of ``csrc/flash_decode.cu``
(``decode_kernel``, which served bf16 caches until the cluster kernel
replaced it) and the cluster body of ``csrc/flash_decode_bf16.cu``. For
each launch one ``PROF`` line gives the blocks, those with keys, the
kernel's span on the global timer, and per block with keys the mean
cycles of its leading thread in each phase:

* ``pro``: from the block's start to its key range known (q, ``lengths``,
  the split rule);
* ``wait0``: the wait for the first K/V bytes; ``waitK``: the waits for
  the later stages;
* ``issue``: starting the copies (the split body's consumers start their
  own); in the cluster body the producer warp's waits for a free stage,
  within ``prod``, its whole run;
* ``math``: scores, softmax and P V over the block's tiles;
* ``tail``: the wait for the block's other warps after its own loop;
* ``wmerge``: the merge of the warps' states;
* ``smerge``: the merge of the splits (split body: the scratch write, the
  fence, the ticket and, in the last block, the re-read; cluster body:
  the sends of the cluster's blocks into rank 0's shared memory and, in
  rank 0, the wait for them and the merge).

Loop phases are means over the warps that ran the loop; the others means
over the blocks with keys (``prod``, the producer warp's whole run, over
the blocks); the shares are of their sum, a block's path. The timers cost
cycles and move the schedule: read the shares, and time the kernel with
``tools/kernel_ab.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

# Slots of the profile array: the phases, then the counters. The loop's
# phases are summed over warps, the others over blocks.
_LOOP = ("wait0", "waitK", "issue", "math")
SLOTS = ["pro", "wait0", "waitK", "issue", "math", "tail", "wmerge",
         "smerge", "prod", "blocks", "busy", "tiles", "t_min", "t_max",
         "warps"]
_PRELUDE = """#include <cstdio>
__device__ unsigned long long g_prof[16];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PADD(i, x) atomicAdd(&g_prof[i], (unsigned long long)(x))
#define PSPAN_START() atomicMin(&g_prof[12], gtimer())
#define PSPAN_END() atomicMax(&g_prof[13], gtimer())
extern "C" int decode_prof_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof));
}
extern "C" int decode_prof_reset() {
  unsigned long long z[16] = {0};
  z[12] = ~0ull;
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""

# The split body (flash_decode.cu, decode_kernel): (old, new) edits.
_SPLIT = [
    ("  constexpr int NT = 32 * NW;\n",
     "  constexpr int NT = 32 * NW;\n"
     "  const long long P0 = clock64();\n"
     "  if (threadIdx.x == 0) PSPAN_START();\n"
     "  long long PW0 = 0, PWK = 0, PI = 0, PM = 0, PT;\n"),
    ("  if (sp >= ne) return;\n",
     "  if (threadIdx.x == 0) {\n"
     "    PADD(9, 1);\n"
     "    if (sp < ne) { PADD(0, clock64() - P0); PADD(10, 1); }\n"
     "    else PSPAN_END();\n"
     "  }\n"
     "  if (sp >= ne) return;\n"),
    ("  for (int i = 0; i < mine; ++i) {\n    issue(i + RING - 1);\n"
     "    cp_async_wait<RING - 1>();  // this lane's copies of tile i "
     "landed\n    __syncwarp();               // ... and every lane's\n",
     "  for (int i = 0; i < mine; ++i) {\n    PT = clock64();\n"
     "    issue(i + RING - 1);\n    PI += clock64() - PT; PT = clock64();\n"
     "    cp_async_wait<RING - 1>();  // this lane's copies of tile i "
     "landed\n    __syncwarp();               // ... and every lane's\n"
     "    if (i == 0) PW0 += clock64() - PT; else PWK += clock64() - PT;\n"
     "    PT = clock64();\n"),
    ("    __syncwarp();  // tile i read: its slot may be refilled\n  }\n",
     "    __syncwarp();  // tile i read: its slot may be refilled\n"
     "    PM += clock64() - PT;\n  }\n"
     "  if (lane == 0) {\n"
     "    PADD(1, PW0); PADD(2, PWK); PADD(3, PI); PADD(4, PM);\n"
     "    PADD(11, mine); PADD(14, 1);\n  }\n"
     "  const long long PL = clock64();\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // every ring drained and "
     "read\n",
     "  cp_async_wait<0>();\n  __syncthreads();  // every ring drained and "
     "read\n  const long long PG = clock64();\n"
     "  if (tid == 0) PADD(5, PG - PL);\n"),
    ("  if (ne == 1) return;\n\n",
     "  const long long PS = clock64();\n"
     "  if (tid == 0) {\n    PADD(6, PS - PG);\n"
     "    if (ne == 1) PSPAN_END();\n  }\n"
     "  if (ne == 1) return;\n\n"),
    ("  if (!last) return;\n",
     "  if (!last) {\n    if (tid == 0) { PADD(7, clock64() - PS); "
     "PSPAN_END(); }\n    return;\n  }\n"),
    ("  if (tid == 0) ticket[pair] = 0;\n}\n",
     "  if (tid == 0) ticket[pair] = 0;\n"
     "  if (tid == 0) { PADD(7, clock64() - PS); PSPAN_END(); }\n}\n"),
]

# The cluster body (flash_decode_bf16.cu, decode_bf16_kernel).
_CLUSTER = [
    ("  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;\n"
     "  const long long P0 = clock64();\n"
     "  if (tid == 0) PSPAN_START();\n"
     "  long long PW0 = 0, PWK = 0, PM = 0, PT;\n"),
    ("  __syncthreads();  // the barriers' init and the range, before any "
     "wait\n",
     "  __syncthreads();  // the barriers' init and the range, before any "
     "wait\n"
     "  if (tid == 0) {\n    PADD(9, 1);\n"
     "    if (r.e > r.a) { PADD(0, clock64() - P0); PADD(10, 1); }\n  }\n"),
    ("  if (wi == NC) {\n",
     "  if (wi == NC) {\n    const long long PP = clock64();\n"),
    ("          if (i >= ring) wait(empty + slot, (i / ring - 1) & 1);\n",
     "          const long long PE = clock64();\n"
     "          if (i >= ring) wait(empty + slot, (i / ring - 1) & 1);\n"
     "          PADD(3, clock64() - PE);\n"),
    ("        if (i >= ring) wait(empty + slot, (i / ring - 1) & 1);\n"
     "        uint8_t* const dst",
     "        const long long PE = clock64();\n"
     "        if (i >= ring) wait(empty + slot, (i / ring - 1) & 1);\n"
     "        if (lane == 0) PADD(3, clock64() - PE);\n"
     "        uint8_t* const dst"),
    ("    }  // producer\n",
     "    }  // producer\n    if (lane == 0) PADD(8, clock64() - PP);\n"),
    ("    wait(full + slot, (i / ring) & 1",
     "    PT = clock64();\n    wait(full + slot, (i / ring) & 1"),
    ("    const uint32_t Ks = smem_u32(rings + slot * stage);\n",
     "    if (i == wi) PW0 += clock64() - PT; else PWK += clock64() - PT;\n"
     "    PT = clock64();\n"
     "    const uint32_t Ks = smem_u32(rings + slot * stage);\n"),
    ("    if (lane == 0) mbar_arrive(empty + slot);\n  }\n",
     "    if (lane == 0) mbar_arrive(empty + slot);\n"
     "    PM += clock64() - PT;\n  }\n"
     "  if (lane == 0) {\n"
     "    PADD(1, PW0); PADD(2, PWK); PADD(4, PM); PADD(14, 1);\n"
     "    PADD(11, ns > wi ? (ns - wi + NC - 1) / NC : 0);\n  }\n"
     "  const long long PL = clock64();\n"),
    ("  consumer_sync();  // every warp done with the ring\n",
     "  consumer_sync();  // every warp done with the ring\n"
     "  const long long PG = clock64();\n"
     "  if (tid == 0) PADD(5, PG - PL);\n"),
    ("  cluster_wait();\n  const uint32_t bar0",
     "  const long long PS = clock64();\n"
     "  if (tid == 0) PADD(6, PS - PG);\n"
     "  cluster_wait();\n  const uint32_t bar0"),
    ("        static_cast<float*>(out)[bh0 * D + 4 * e + u] = o[u];\n"
     "    }\n  }\n",
     "        static_cast<float*>(out)[bh0 * D + 4 * e + u] = o[u];\n"
     "    }\n  }\n"
     "  if (tid == 0) {\n"
     "    if (r.e > r.a) PADD(7, clock64() - PS);\n    PSPAN_END();\n  }\n"),
]


def instrument(src: str, edits, start: str, stop: str) -> str:
    """``src`` with the timers of ``edits`` put into its text between
    ``start`` and ``stop`` (the kernel's body); raises if the body no
    longer has the expected shape."""
    i = src.index(start)
    j = src.index(stop, i)
    body = src[i:j]
    for old, new in edits:
        if body.count(old) != 1:
            raise SystemExit(f"decode_phases: the kernel changed shape; "
                             f"update the timers for:\n{old}")
        body = body.replace(old, new)
    head = src[:i]
    k = head.index("namespace {")
    return head[:k] + _PRELUDE + head[k:] + body + src[j:]


def copy_tree(src: str, n: int) -> str:
    """An instrumented copy of the ``repro_torch`` under ``src``; -> the
    copy's ``src`` directory."""
    dst = os.path.join(ROOT, "build", "decode_phases", str(n), "src")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    shutil.copytree(os.path.join(src, "repro_torch"),
                    os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "repro_torch", "csrc")
    cluster = os.path.join(csrc, "flash_decode_bf16.cu")
    if os.path.exists(cluster):
        path, edits = cluster, _CLUSTER
        start, stop = "decode_bf16_kernel(", "\n// The launch"
    else:
        path, edits = os.path.join(csrc, "flash_decode.cu"), _SPLIT
        start, stop = "decode_kernel(const void*", "\ntemplate <typename T"
    with open(path) as f:
        text = instrument(f.read(), edits, start, stop)
    with open(path, "w") as f:
        f.write(text)
    return dst, edits is _CLUSTER


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--shapes", default="llama self,llama cross,32k",
                    help="comma-separated DECODE_BF16 names, or 'all'")
    args = ap.parse_args()
    import kernel_ab

    src, cluster = copy_tree(os.path.abspath(args.src), 0)
    # The cluster body's producer runs beside the consumers: its waits
    # ("issue") are a block's, and not on the consumers' path.
    loop = ("wait0", "waitK", "math") if cluster else _LOOP
    on_path = [n for n in SLOTS[:8] if not (cluster and n == "issue")]
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("decode_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd

    if not repro_torch.__file__.startswith(src):
        raise SystemExit(f"decode_phases: imported {repro_torch.__file__}")
    print(cs.card_line())
    lib = _build.load()
    lib.decode_prof_read.argtypes = [ctypes.c_void_p]
    names = args.shapes.split(",")
    for name, b, s, hq, hkv, d, opts, lengths in kernel_ab.DECODE_BF16:
        if args.shapes != "all" and name not in names:
            continue
        q, k, v, lens = kernel_ab.bf16_decode_operands(
            torch, b, s, hq, hkv, d, lengths, cs.SEED + 31)
        q = q.to(torch.bfloat16)
        for _ in range(2):
            fd.flash_decode(q, k, v, lens, **opts)
        flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
        flush.zero_()           # evicts the operands from the L2 cache
        del flush
        torch.cuda.synchronize()
        _build.check(lib.decode_prof_reset(), "decode_prof_reset")
        fd.flash_decode(q, k, v, lens, **opts)
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * 16)()
        _build.check(lib.decode_prof_read(got), "decode_prof_read")
        p = dict(zip(SLOTS, got))
        busy, warps = max(p["busy"], 1), max(p["warps"], 1)
        # Block phases a block with keys; loop phases a warp that ran
        # the loop (the block's path runs through one warp's loop).
        ph = {n: p[n] / (warps if n in loop else busy) for n in SLOTS[:9]}
        path = sum(ph[n] for n in on_path)
        print(f"PROF {name} (B={b} S={s} Hq={hq} Hkv={hkv} D={d} {opts}, "
              f"lengths {lengths}): blocks {p['blocks']}, with keys "
              f"{p['busy']}, warps in the loop {p['warps']}, warp-tiles "
              f"{p['tiles']}, span {(p['t_max'] - p['t_min']) / 1e3:.2f} us"
              f" | cycles: " + " ".join(f"{n} {ph[n]:.0f}" for n in SLOTS[:9])
              + " | shares of the path: "
              + " ".join(f"{n} {100 * ph[n] / path:.1f}%" for n in on_path))
        del q, k, v, lens
    return 0


if __name__ == "__main__":
    sys.exit(main())
