"""Where #7's bf16 kernel spends its cycles: clock64 per phase of the key
loop, summed by each consumer warpgroup's leader thread of two blocks.

    python tools/flash_phases.py              # llama self layer, D 128
    python tools/flash_phases.py --d 64 --hq 24

Run from the repository root on a machine with a CUDA card. The script
copies ``src/`` into ``build/flash_phases/src`` (``.gitignore`` lists
``build/``), inserts the timers into that copy's
``csrc/flash_attention.cu`` (the tree's own source is not touched), builds
it and runs the kernel once at B 4, Sq = Skv = 2048, ``--hq`` / 8 heads,
causal. Blocks (0, 0) and (gridDim.x / 2, 0) print one ``PROF`` line a
warpgroup: the block's key tiles and the warpgroup's own, cycles until
q landed (``waitQ``) and in all (``total``), and per phase of the loop's
rounds summed: the wait for K (``waitK``), starting S (``qk``), O's
rescale, the wait for V and starting P V (``pv``), the waits for S
(``w1``) and for P V (``w0``), the softmax (``soft``) and the packing of
P (``pack``). The timers cost cycles of their own and move the schedule:
read the shares, not the sums, and time the kernel with
``tools/kernel_ab.py``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "flash_phases")

_LOOP = """    wait(full_k + t % ST, (t / ST) & 1);
    qk(t);
    pv(t - 1);
    wgmma_wait_n<1>();  // S(t)
    fence_regs(s);
    release(empty_k + t % ST);
    softmax(t);
    wgmma_wait_n<0>();  // P(t - 1) V(t - 1)
    pv_done(t - 1);
    pack_p();"""
_TIMED = """    PB wait(full_k + t % ST, (t / ST) & 1); PE(0)
    PB qk(t); PE(1)
    PB pv(t - 1); PE(2)
    PB wgmma_wait_n<1>();  // S(t)
    fence_regs(s); PE(3)
    release(empty_k + t % ST);
    PB softmax(t); PE(4)
    PB wgmma_wait_n<0>();  // P(t - 1) V(t - 1)
    pv_done(t - 1); PE(5)
    PB pack_p(); PE(6)"""
_START = "  const int tid = threadIdx.x;\n"
_TIMERS = (_START + "  const long long T0 = clock64();\n"
           "  long long PF[8] = {0, 0, 0, 0, 0, 0, 0, 0}, TA;\n"
           "#define PB TA = clock64();\n"
           "#define PE(i) PF[i] += clock64() - TA;\n")
_QWAIT = ("  wait(q_full, 0);  // even with no tile: no copy outlives the "
          "block\n")
_END = """      }
    }
  }
}
"""
_PRINT = """      }
    }
  }
  if (ct == 0 && blockIdx.y == 0 &&
      (blockIdx.x == 0 || blockIdx.x == gridDim.x / 2))
    printf("PROF x=%d c=%d D=%d tiles=%d mine=%d waitQ=%lld "
           "total=%lld | waitK %lld qk %lld pv %lld w1 %lld soft %lld "
           "w0 %lld pack %lld\\n", blockIdx.x, c, D, n_tiles, tb - ta,
           PF[7],
           clock64() - T0, PF[0], PF[1], PF[2], PF[3], PF[4], PF[5],
           PF[6]);
}
"""


def instrument(src: str) -> str:
    """The bf16 kernel of ``src`` (flash_attention.cu's text) with the
    timers in; raises if the kernel no longer has the expected shape."""
    i = src.index("flash_kernel_bf16(const __grid_constant__")
    j = src.index("// cuTensorMapEncodeTiled, found once")
    body = src[i:j]
    for old, new in ((_START, _TIMERS), (_LOOP, _TIMED),
                     (_QWAIT, "  PB wait(q_full, 0); PE(7)\n"),
                     (_END, _PRINT)):
        if body.count(old) != 1:
            raise SystemExit(f"flash_phases: the kernel changed shape; "
                             f"update the timers for:\n{old}")
        body = body.replace(old, new)
    return "#include <cstdio>\n" + src[:i] + body + src[j:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--hq", type=int, default=32)
    args = ap.parse_args()
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(COPY, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(COPY, "src", "repro_torch", "csrc",
                      "flash_attention.cu")
    with open(cu) as f:
        text = instrument(f.read())
    with open(cu, "w") as f:
        f.write(text)
    sys.path.insert(0, os.path.join(COPY, "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((4, 2048, args.hq, args.d),
                             (4, 2048, 8, args.d), (4, 2048, 8, args.d)))
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
