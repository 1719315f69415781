"""Whether ``torch.profiler`` returns every device record of a window: the
window ``chip_smoke.py`` profiles #6 in (20 calls of ``bli_tile_matmul``
at the serving shape, each after the L2 flush and a device sleep, or
warm), taken again and again, with no lead-in and behind
``chip_smoke.PROFILE_LEAD`` empty launches (``chip_smoke.profiled_window``).

    python tools/profiler_windows.py
    python tools/profiler_windows.py --age 120

Run from the repository root on a machine with a CUDA card. Groups of six
windows, cold and warm in turns: A with no lead-in and B behind it, in a
fresh process; then ``--age`` seconds of matrix products, and C with no
lead-in, D behind it; then one window of CUDA activity over 20,000
launches, read (as ``chip_smoke.profile_train`` takes a training step),
and E with no lead-in, F behind it. Each window prints the #6 records it
returned of the 20 launched and all its device records of those launched.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--age", type=float, default=60.0,
                    help="seconds of device work before groups C and D")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import dcn_bli as kb

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    a = (torch.as_tensor(rng.normal(size=(1, 196, 512)).astype(np.float32),
                         device="cuda"),
         torch.as_tensor(rng.integers(0, 196, size=(1, 1792, 4)).astype(
             np.int32), device="cuda"),
         torch.as_tensor(rng.uniform(size=(1, 1792, 4)).astype(np.float32),
                         device="cuda"))
    kb.bli_tile_matmul(*a)
    torch.cuda.synchronize()
    print(cs.card_line())
    n, missed = 20, {}

    def group(name, lead):
        for i in range(6):
            cold = i % 2 == 0
            d, seen = cs.profiled_window(lambda: kb.bli_tile_matmul(*a),
                                         "bli_kernel", n, cold, lead)
            missed[name] = missed.get(name, 0) + (len(d) != n)
            print(f"{name}{i} {'cold' if cold else 'warm'}, lead-in {lead}: "
                  f"#6 {len(d)} of {n}, {seen} device records of "
                  f"{lead + (3 if cold else 2) * n}", flush=True)

    group("A", 0)
    group("B", cs.PROFILE_LEAD)
    x = torch.randn(8192, 8192, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.age:
        for _ in range(50):
            x = (x @ x).clamp_(-1, 1)
        torch.cuda.synchronize()
    group("C", 0)
    group("D", cs.PROFILE_LEAD)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = torch.zeros(1024, device="cuda")
        for _ in range(20_000):
            y.add_(1)
        torch.cuda.synchronize()
    prof.events()
    group("E", 0)
    group("F", cs.PROFILE_LEAD)
    print("windows missing a #6 record, by group: " + ", ".join(
        f"{g} {m} of 6" for g, m in missed.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
