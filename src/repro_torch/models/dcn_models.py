"""The paper's benchmark networks (Table III): VGG19 and SegNet with the
last-k convolution layers replaced by deformable convolutions.

Configurations follow §V-A: {VGG19, SegNet} x {-3, -8, -F} x {DCN-I, II};
replacement proceeds from the output layer toward the input layer.

``dcn_net_apply`` selects an execution ``backend``:

  * ``"dense"``    — the reference path (``core.deform``), the counterpart
                     of the JAX package's ``"xla"`` backend;
  * ``"pallas"``   — each DCN layer through the fused tile kernel, the
                     whole plane as one tile (``kernels.ops``; the name is
                     the JAX package's);
  * ``"pipeline"`` — each DCN layer through the tile-pipeline executor
                     (``runtime.pipeline.dcn_pipeline``);
  * ``"graph"``    — the network-graph executor with cross-layer tile
                     fusion (``runtime.fused_exec``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.deform import conv2d, deformable_conv2d, \
    init_deformable_conv
from repro_torch.kernels.ops import deformable_conv2d_pallas
from repro_torch.runtime.fused_exec import GraphConfig, run_graph
from repro_torch.runtime.graph import build_graph
from repro_torch.runtime.pipeline import (PipelineConfig, clamp_tile_config,
                                          dcn_pipeline)

# (channels, n_convs) per VGG19 stage; maxpool after each stage.
_VGG19_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


@dataclasses.dataclass(frozen=True)
class DcnNetConfig:
    name: str                    # "vgg19" | "segnet"
    n_deform: int                # 3 | 8 | -1 (=F, all)
    variant: str = "dcn2"        # dcn1 | dcn2  (paper DCN-I / DCN-II)
    num_classes: int = 100
    in_channels: int = 3
    img_size: int = 64           # the paper uses ImageNet 224
    width_mult: float = 1.0      # smoke-reduction knob
    max_displacement: float | None = None

    def stage_plan(self, decoder: bool = False):
        """[(c_in, c_out, deformable?)] conv list."""
        stages = [(max(8, int(c * self.width_mult)), n)
                  for c, n in _VGG19_STAGES]
        convs: list[tuple[int, int]] = []
        c_prev = self.in_channels
        for c, n in stages:
            for _ in range(n):
                convs.append((c_prev, c))
                c_prev = c
        if decoder:  # SegNet decoder mirrors the encoder
            dec = []
            rev = list(reversed(convs))
            for i, (ci, co) in enumerate(rev):
                dec.append((co, ci if i < len(rev) - 1 else rev[-1][1]))
            convs = convs + dec
        n_def = len(convs) if self.n_deform < 0 else min(self.n_deform,
                                                         len(convs))
        flags = [i >= len(convs) - n_def for i in range(len(convs))]
        return [(ci, co, f) for (ci, co), f in zip(convs, flags)]


def init_dcn_net(seed, cfg: DcnNetConfig, dtype=torch.float32,
                 device="cuda") -> dict[str, Any]:
    """Random parameters from ``seed`` (an int or a ``torch.Generator``):
    He-initialised convs, zero offset convs, a small-scale head. The
    numbers differ from the JAX package's ``init_dcn_net`` (another
    generator); carry JAX params across with ``convert.params_from_jax``
    to compare the two."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    decoder = cfg.name == "segnet"
    plan = cfg.stage_plan(decoder)
    params: dict[str, Any] = {"convs": []}
    for ci, co, deform in plan:
        if deform:
            params["convs"].append(init_deformable_conv(
                gen, ci, co, 3, cfg.variant, dtype, dev))
        else:
            w = (torch.randn((3, 3, ci, co), generator=gen)
                 * math.sqrt(2.0 / (9 * ci)))
            params["convs"].append({
                "w": w.to(device=dev, dtype=dtype),
                "b": torch.zeros((co,), dtype=dtype, device=dev)})
    c_last = plan[-1][1]
    head = "seg_head" if decoder else "fc"
    shape = (1, 1, c_last, cfg.num_classes) if decoder else \
        (c_last, cfg.num_classes)
    params[head] = {
        "w": (torch.randn(shape, generator=gen) * 0.02).to(device=dev,
                                                           dtype=dtype),
        "b": torch.zeros((cfg.num_classes,), dtype=dtype, device=dev)}
    return params


def _pool_positions(cfg: DcnNetConfig) -> set[int]:
    """Conv indices after which a 2x2 maxpool (encoder) happens."""
    pos, i = set(), 0
    for _, n in _VGG19_STAGES:
        i += n
        pos.add(i - 1)
    return pos


def dcn_net_apply(params, cfg: DcnNetConfig, x: torch.Tensor, *,
                  backend: str = "dense",
                  pipeline: PipelineConfig | None = None,
                  graph: GraphConfig | None = None):
    """x: (N, H, W, C) on the params' device. Returns logits (N, classes)
    for vgg19 or per-pixel logits (N, H', W', classes) for segnet.
    ``pipeline`` configures the ``"pipeline"`` backend, ``graph`` the
    ``"graph"`` backend."""
    if backend not in ("dense", "pallas", "pipeline", "graph"):
        raise ValueError(f"unknown backend: {backend!r}")
    decoder = cfg.name == "segnet"
    if backend == "graph":
        gcfg = clamp_tile_config(graph or GraphConfig(), x.shape[1],
                                 x.shape[2])
        y = run_graph(params["convs"], build_graph(cfg), x, config=gcfg,
                      max_displacement=cfg.max_displacement)
        return apply_head(params, cfg, y)

    plan = cfg.stage_plan(decoder)
    pools = _pool_positions(cfg)
    n_enc = sum(n for _, n in _VGG19_STAGES)
    applied_pools: set[int] = set()
    for i, (_, _, deform) in enumerate(plan):
        p = params["convs"][i]
        if deform and backend == "pipeline":
            pcfg = pipeline or PipelineConfig(
                tile=max(2, min(8, x.shape[1] // 2, x.shape[2] // 2)))
            # The requested tile is an upper bound: deep-stage planes
            # shrink below it, so clamp per layer.
            y = dcn_pipeline(x, p, variant=cfg.variant,
                             max_displacement=cfg.max_displacement,
                             config=clamp_tile_config(pcfg, x.shape[1],
                                                      x.shape[2]))
        elif deform and backend == "pallas":
            y = deformable_conv2d_pallas(
                x, p, variant=cfg.variant,
                max_displacement=cfg.max_displacement)
        elif deform:
            y = deformable_conv2d(x, p, variant=cfg.variant,
                                  max_displacement=cfg.max_displacement)
        else:
            y = conv2d(x, p["w"], p["b"])
        x = torch.relu(y)
        if i < n_enc and i in pools and x.shape[1] >= 2 and x.shape[2] >= 2:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                0, 2, 3, 1).contiguous()
            applied_pools.add(i)
        elif decoder and i >= n_enc and (2 * n_enc - 1 - i) in applied_pools:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return apply_head(params, cfg, x)


def apply_head(params, cfg: DcnNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Classifier head: global average pool + fc (vgg19), or the 1x1
    segmentation conv (segnet)."""
    if cfg.name != "segnet":
        x = x.mean(dim=(1, 2))
        return x @ params["fc"]["w"] + params["fc"]["b"]
    return conv2d(x, params["seg_head"]["w"], params["seg_head"]["b"])
