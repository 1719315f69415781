"""Quickstart with the PyTorch port: the paper's deformable convolution,
end to end.

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The steps of ``examples/quickstart.py``, on ``--device``:

1. builds a deformable conv (Eq. 1-3) and runs the reference path,
2. runs the SAME layer through the fused kernel (#5: CUDA on a card, its
   plain version on the CPU) and checks they agree,
3. builds the Tile Dependency Table from the layer's real offsets, runs
   Algorithm 1, and prints the DRAM-traffic win over the naive order,
4. runs a small DCN network through the network-graph executor
   (backend="graph") and prints the per-group fused-vs-unfused DRAM
   bytes — the paper's Fig. 18 layer-fusion delta, executed.
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (deformable_conv2d, init_deformable_conv,
                              make_square_grid, per_pixel_input_tiles,
                              schedule_tiles, simulate_network,
                              simulate_strategies, tdt_from_coords)
from repro_torch.core.deform import conv2d, offsets_to_coords
from repro_torch.kernels.ops import deformable_conv2d_pallas
from repro_torch.models.dcn_models import (DcnNetConfig, dcn_net_apply,
                                           init_dcn_net)
from repro_torch.runtime import GraphConfig, build_graph, run_graph
from repro_torch.runtime.fused_exec import network_sim_specs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        # TF32 convs would move the sampling coordinates' floors.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    c_in, c_out, hw = 32, 64, 24

    # 1. deformable conv, reference path
    params = init_deformable_conv(gen, c_in, c_out, variant="dcn2",
                                  device=dev)
    params = params._replace(w_off=(torch.randn(
        params.w_off.shape, generator=gen) * 0.3).to(dev))
    x = torch.randn((1, hw, hw, c_in), generator=gen).to(dev)
    y_ref = deformable_conv2d(x, params)
    print(f"reference path: {tuple(x.shape)} -> {tuple(y_ref.shape)}")

    # 2. the fused kernel (stages 2+3 in one launch)
    y_ker = deformable_conv2d_pallas(x, params)
    np.testing.assert_allclose(y_ker.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    print(f"fused kernel on {dev.type}: matches the reference (rtol 2e-4)")

    # 3. TDT + Algorithm 1 over the layer's actual sampling pattern
    offsets = conv2d(x, params.w_off, params.b_off)
    coords = offsets_to_coords(offsets.float(), 3, "dcn2")[0]
    grid = make_square_grid(hw, hw, 4)
    B = tdt_from_coords(coords, grid, grid).cpu().numpy()
    pp = per_pixel_input_tiles(coords, grid).cpu().numpy()
    rep = simulate_strategies(B, pp, grid, channels=c_in, c_out=c_out,
                              kernel_size=3, buffer_bytes=4096)
    sched = schedule_tiles(B, 4)
    print(f"TDT: {B.shape[0]} output tiles x {B.shape[1]} input tiles, "
          f"density {B.mean():.2f}")
    print(f"tile loads  naive={rep['naive'].tile_loads}  "
          f"bitvec={rep['bitvec'].tile_loads}  "
          f"Alg1={rep['scheduled'].tile_loads}")
    print(f"Alg 1 execution order (first 8 tiles): {sched.oid[:8]}")

    # 4. network-graph executor: cross-layer tile fusion (backend="graph")
    cfg = DcnNetConfig(name="vgg19", n_deform=2, img_size=16,
                       width_mult=0.125, num_classes=4)
    net_params = init_dcn_net(3, cfg, device=dev)
    imgs = torch.randn((1, 16, 16, 3), generator=gen).to(dev)
    logits = dcn_net_apply(net_params, cfg, imgs, backend="graph",
                           graph=GraphConfig(tile=4))
    print(f"graph backend: {tuple(imgs.shape)} -> logits "
          f"{tuple(logits.shape)}")

    graph = build_graph(cfg)
    _, trace = run_graph(net_params["convs"], graph, imgs,
                         config=GraphConfig(tile=4), return_trace=True)
    specs = network_sim_specs(trace)
    fused = simulate_network(specs, boundary_bytes=trace.boundary_bytes)
    unfused = simulate_network(specs, boundary_bytes=trace.boundary_bytes,
                               fused=False)
    for g_f, g_u in zip(fused.groups, unfused.groups):
        if g_f.n_layers > 1:
            print(f"  fused group ({g_f.n_layers} layers): "
                  f"{g_f.total_dram_bytes} B fused vs "
                  f"{g_u.total_dram_bytes} B per-layer")
    saved = 100 * (1 - fused.total_dram_bytes / unfused.total_dram_bytes)
    print(f"network DRAM: fused={fused.total_dram_bytes} B, "
          f"per-layer={unfused.total_dram_bytes} B ({saved:.1f}% saved)")


if __name__ == "__main__":
    main()
