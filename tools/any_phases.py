"""Where the general attention body (csrc/attention_any.cu) spends its
cycles: clock64 per phase of the key loop, summed by lane 0 of each warp
of two blocks.

    python tools/any_phases.py                 # #7 Gemma-7B and #8 Falcon-7B
    python tools/any_phases.py --dtype bfloat16

Run from the repository root on a machine with a CUDA card. The script
copies ``src/`` into ``build/any_phases/src`` (``.gitignore`` lists
``build/``), inserts the timers into that copy's ``csrc/attention_any.cu``
(the tree's own source is not touched), builds it and runs #7 at
``chip_smoke.py`` phase 18d's Gemma-7B shape (1 x 2048, 16 / 16 heads, D
256, causal) and #8 at its Falcon-7B shape (B 4 x 2048 rows, 71 / 1 heads,
D 64) once each. Blocks 0 and gridDim.x / 2 print one ``PROF`` line a
warp: the block's key tiles, cycles from the start to the key loop
(``pro``), in the loop and in all up to the output (``total``), and per
phase of the loop summed: the wait for the tile and the block barrier
(``wait``), issuing the next tile's copies (``issue``), the products of S
(``qk``), the softmax and P's store (``soft``), the fragment's barrier
(``bar``) and P V (``pv``). The timers cost cycles of their own and move
the schedule: read the shares, not the sums. The block that merges a
sequence's splits also prints one ``MERGE`` line: cycles from its start to
its partial state written, waiting on the ticket, the merge's first pass
(each row's max and sum) and its second (the values) with the output.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "any_phases")

_START = ("  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;\n")
_TIMERS = (_START + "  const long long T0 = clock64();\n"
           "  long long PF[8] = {0, 0, 0, 0, 0, 0, 0, 0}, TA;\n"
           "#define PB TA = clock64();\n"
           "#define PE(i) PF[i] += clock64() - TA;\n")
_TOP = ("    cp_async_wait(a.stages - 2);  // tile i (and q), this thread's "
        "copies\n"
        "    if (tma_k || tma_v) hop::mbar_wait(full + st, (i / a.stages) "
        "& 1);\n"
        "    __syncthreads();  // every thread's copies; tile i - 1 read by "
        "all\n")
_TOP_T = """    PB cp_async_wait(a.stages - 2);
    if (tma_k || tma_v) hop::mbar_wait(full + st, (i / a.stages) & 1);
    __syncthreads(); PE(0)
"""
_REFILL = "    issue(i + a.stages - 1);  // into the stage tile i - 1 left\n"
_REFILL_T = "    PB issue(i + a.stages - 1); PE(1) PB\n"
_SOFT = ("      // Scale, soft-cap, mask, each a pass of its own taken only "
         "where it\n")
_SOFT_T = "      PE(2) PB\n" + _SOFT
_BAR = """    if (a.cw > 1)
      bar_sync(bar_id, bar_n);  // the fragment's P written
    else
      __syncwarp();
"""
_BAR_T = "    PE(3) PB\n" + _BAR + "    PE(4) PB\n"
_PV_END = """    }
  }
  cp_async_wait(0);
"""
_PV_END_T = """    }
    PE(5)
  }
  const long long TL = clock64();
  cp_async_wait(0);
"""
_LOOP = "  for (int i = 0; i < ntiles; ++i) {\n"
_LOOP_T = "  const long long TP = clock64();\n" + _LOOP
_OUT = "  const bool direct = a.mode == 0 || ne == 1;\n"
_OUT_T = _OUT + """  if (lane == 0 &&
      (blockIdx.x == 0 || blockIdx.x == gridDim.x / 2))
    printf("PROF mode=%d x=%d warp=%d tiles=%d pro=%lld loop=%lld "
           "total=%lld | wait %lld issue %lld qk %lld soft %lld bar %lld "
           "pv %lld\\n", a.mode, (int)blockIdx.x, warp, ntiles, TP - T0,
           TL - TP, clock64() - T0, PF[0], PF[1], PF[2], PF[3], PF[4],
           PF[5]);
"""


_MERGE = ("  // The last of the sequence's ne blocks (this chunk) merges the "
          "splits.\n")
_MERGE_T = "  const long long TM0 = clock64();\n" + _MERGE
_FLAG = "  if (!*flag) return;\n"
_FLAG_T = _FLAG + "  const long long TM1 = clock64();\n"
_PASS2 = "  const int per = a.D % 4 == 0 ? 4 : 1;  // values a thread's load\n"
_PASS2_T = "  const long long TM2 = clock64();\n" + _PASS2
_DONE = "  if (tid == 0) *ticket = 0;\n}"
_DONE_T = """  if (tid == 0) {
    *ticket = 0;
    printf("MERGE x=%d splits=%d rows=%d | to partials %lld ticket %lld "
           "pass1 %lld pass2+out %lld\\n", (int)blockIdx.x, ne, q_valid,
           TM0 - T0, TM1 - TM0, TM2 - TM1, clock64() - TM2);
  }
}"""


def instrument(src: str) -> str:
    """attention_any.cu's text with the timers in; raises if the kernel no
    longer has the expected shape."""
    for old, new in ((_START, _TIMERS), (_TOP, _TOP_T), (_REFILL, _REFILL_T),
                     (_SOFT, _SOFT_T),
                     (_BAR, _BAR_T), (_PV_END, _PV_END_T), (_LOOP, _LOOP_T),
                     (_OUT, _OUT_T), (_MERGE, _MERGE_T), (_FLAG, _FLAG_T),
                     (_PASS2, _PASS2_T), (_DONE, _DONE_T)):
        if src.count(old) != 1:
            raise SystemExit(f"any_phases: the kernel changed shape; update "
                             f"the timers for:\n{old}")
        src = src.replace(old, new)
    return "#include <cstdio>\n" + src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float16",
                    choices=("float16", "bfloat16", "float32"))
    ap.add_argument("--splits", type=int, default=None,
                    help="#8's num_splits (default: its split rule)")
    args = ap.parse_args()
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(COPY, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(COPY, "src", "repro_torch", "csrc", "attention_any.cu")
    with open(cu) as f:
        text = instrument(f.read())
    with open(cu, "w") as f:
        f.write(text)
    sys.path.insert(0, os.path.join(COPY, "src"))
    import torch

    if not torch.cuda.is_available():
        print("any_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(1, 2048, 16, 256), randn(1, 2048, 16, 256), randn(
        1, 2048, 16, 256)
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    q, kc, vc = randn(4, 71, 64), randn(4, 2048, 1, 64), randn(4, 2048, 1, 64)
    lens = torch.tensor([969, 1048, 1547, 1947], dtype=torch.int32,
                        device="cuda")
    fd.flash_decode(q, kc, vc, lens, num_splits=args.splits)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
