"""Network-graph IR for cross-layer tile fusion (paper §IV-D, Fig. 18).

The paper's fused-layer dataflow keeps the deformed-feature intermediate —
and, taken network-wide, whole boundary feature planes — out of DRAM. This
module is the *plan* side of that: a small IR over the backbone of a
``DcnNetConfig`` (``ConvNode`` / ``DeformNode`` / ``PoolNode`` /
``UpsampleNode``, built from ``stage_plan``) plus a partitioner that cuts
the chain into :class:`FusedGroup` segments using the §IV-D fusion planner
(``core.fusion.plan_fused_groups``).

Within a fused group every layer runs at the same spatial resolution
(stride-1 SAME convs), so tile grids coincide and per-layer tile
dependency tables chain by boolean composition (``core.tiles.compose_tdt``)
into one composite TDT the group is Algorithm-1-scheduled on. Pool and
upsample nodes change resolution and therefore always sit *between*
groups: their planes round-trip DRAM (counted as boundary bytes).

Execution lives in ``runtime.fused_exec``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Union

from repro_torch.core.fusion import (GroupPlan, LayerShape, plan_fused_groups,
                                     plan_network)
from repro_torch.obs import get_tracer

if TYPE_CHECKING:  # avoid a cycle: models.dcn_models imports fused_exec
    from repro_torch.models.dcn_models import DcnNetConfig


@dataclasses.dataclass(frozen=True)
class ConvNode:
    """Standard 3x3 stride-1 SAME conv (+ optional ReLU)."""

    param_idx: int            # index into the model's params["convs"]
    c_in: int
    c_out: int
    h: int                    # input (== output) spatial dims
    w: int
    kernel_size: int = 3
    relu: bool = True
    kind = "conv"


@dataclasses.dataclass(frozen=True)
class DeformNode:
    """Deformable conv (Eq. 1-3): offset conv -> BLI -> main conv."""

    param_idx: int
    c_in: int
    c_out: int
    h: int
    w: int
    kernel_size: int = 3
    variant: str = "dcn2"
    relu: bool = True
    kind = "deform"


@dataclasses.dataclass(frozen=True)
class PoolNode:
    """2x2 stride-2 VALID maxpool — a resolution boundary between groups."""

    h: int                    # input dims
    w: int
    channels: int
    window: int = 2
    kind = "pool"

    @property
    def out_h(self) -> int:
        return (self.h - self.window) // self.window + 1

    @property
    def out_w(self) -> int:
        return (self.w - self.window) // self.window + 1


@dataclasses.dataclass(frozen=True)
class UpsampleNode:
    """Nearest-neighbour 2x upsample (SegNet decoder unpool boundary)."""

    h: int
    w: int
    channels: int
    factor: int = 2
    kind = "upsample"

    @property
    def out_h(self) -> int:
        return self.h * self.factor

    @property
    def out_w(self) -> int:
        return self.w * self.factor


LayerNode = Union[ConvNode, DeformNode]
BoundaryNode = Union[PoolNode, UpsampleNode]
Node = Union[ConvNode, DeformNode, PoolNode, UpsampleNode]


@dataclasses.dataclass(frozen=True)
class NetGraph:
    """A linear backbone graph (VGG/SegNet-style chains have one path)."""

    nodes: tuple[Node, ...]
    in_h: int
    in_w: int
    in_c: int

    def __post_init__(self):
        h, w, c = self.in_h, self.in_w, self.in_c
        for n in self.nodes:
            if isinstance(n, (ConvNode, DeformNode)):
                if (n.h, n.w, n.c_in) != (h, w, c):
                    raise ValueError(
                        f"node {n} does not accept plane ({h},{w},{c})")
                c = n.c_out
            else:
                if (n.h, n.w, n.channels) != (h, w, c):
                    raise ValueError(
                        f"boundary {n} does not accept plane ({h},{w},{c})")
                h, w = n.out_h, n.out_w

    @property
    def out_shape(self) -> tuple[int, int, int]:
        h, w, c = self.in_h, self.in_w, self.in_c
        for n in self.nodes:
            if isinstance(n, (ConvNode, DeformNode)):
                c = n.c_out
            else:
                h, w = n.out_h, n.out_w
        return h, w, c


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """Consecutive same-resolution layers executed under ONE cross-layer
    Algorithm-1 schedule; interior planes live only in the tile buffer."""

    nodes: tuple[LayerNode, ...]
    plan: GroupPlan           # per-layer FusionPlans + modeled DRAM saving
    # Autotuned (tile_h, tile_w) override for this group's schedules and
    # dispatches; None -> the executor config's default tile applies.
    tile_hw: tuple[int, int] | None = None

    @property
    def h(self) -> int:
        return self.nodes[0].h

    @property
    def w(self) -> int:
        return self.nodes[0].w

    @property
    def c_in(self) -> int:
        return self.nodes[0].c_in

    @property
    def c_out(self) -> int:
        return self.nodes[-1].c_out

    @property
    def n_layers(self) -> int:
        return len(self.nodes)

    @property
    def layer_channels(self) -> list[tuple[int, int]]:
        return [(n.c_in, n.c_out) for n in self.nodes]


Segment = Union[FusedGroup, PoolNode, UpsampleNode]


def node_weight_bytes(node: LayerNode, dtype_bytes: int) -> int:
    """DRAM weight traffic of one layer (same formula as the simulator:
    main conv + offset conv for deformable layers)."""
    kk2 = node.kernel_size ** 2
    bytes_ = kk2 * node.c_in * node.c_out * dtype_bytes
    if isinstance(node, DeformNode):
        L = 2 if node.variant == "dcn1" else 2 * kk2
        bytes_ += kk2 * node.c_in * L * dtype_bytes
    return bytes_


def group_weight_bytes(group: FusedGroup, dtype_bytes: int) -> int:
    return sum(node_weight_bytes(n, dtype_bytes) for n in group.nodes)


def boundary_bytes(node: BoundaryNode, dtype_bytes: int) -> int:
    """Dense boundary op: read the input plane + write the output plane."""
    read = node.h * node.w * node.channels * dtype_bytes
    write = node.out_h * node.out_w * node.channels * dtype_bytes
    return read + write


def build_graph(cfg: "DcnNetConfig") -> NetGraph:
    """Build the backbone IR from ``DcnNetConfig.stage_plan`` — the exact
    node sequence ``models.dcn_models.dcn_net_apply`` executes (convs with
    ReLU, encoder pools, decoder unpool upsamples; heads excluded)."""
    # Imported lazily: dcn_models imports runtime.fused_exec -> this module.
    from repro_torch.models.dcn_models import _VGG19_STAGES, _pool_positions

    decoder = cfg.name == "segnet"
    plan = cfg.stage_plan(decoder)
    pools = _pool_positions(cfg)
    n_enc = sum(n for _, n in _VGG19_STAGES)

    nodes: list[Node] = []
    h = w = cfg.img_size
    # Mirror the executed network exactly: encoder pools are skipped once
    # a plane side drops below 2, and a decoder upsample only pairs with a
    # pool that actually ran (shape parity for tiny inputs).
    applied_pools: set[int] = set()
    for i, (ci, co, deform) in enumerate(plan):
        if deform:
            nodes.append(DeformNode(i, ci, co, h, w, variant=cfg.variant))
        else:
            nodes.append(ConvNode(i, ci, co, h, w))
        if i < n_enc and i in pools and h >= 2 and w >= 2:
            nodes.append(PoolNode(h, w, co))
            h, w = nodes[-1].out_h, nodes[-1].out_w
            applied_pools.add(i)
        elif decoder and i >= n_enc and (2 * n_enc - 1 - i) in applied_pools:
            nodes.append(UpsampleNode(h, w, co))
            h, w = nodes[-1].out_h, nodes[-1].out_w
    return NetGraph(tuple(nodes), cfg.img_size, cfg.img_size,
                    cfg.in_channels)


def partition_graph(graph: NetGraph, onchip_budget_bytes: int,
                    dtype_bytes: int = 4) -> list[Segment]:
    """Cut the backbone into executable segments.

    Boundary nodes pass through as-is; each maximal run of layer nodes
    between boundaries is split into :class:`FusedGroup` segments by the
    §IV-D planner (STAGED layers become singleton groups).
    """
    segments: list[Segment] = []
    run: list[LayerNode] = []

    def flush() -> None:
        if not run:
            return
        shapes = [LayerShape(n.h, n.w, n.c_in, n.c_out, n.kernel_size,
                             dtype_bytes) for n in run]
        for gp in plan_fused_groups(shapes, onchip_budget_bytes):
            segments.append(FusedGroup(tuple(run[gp.start:gp.stop]), gp))
        run.clear()

    with get_tracer().span("prepass.partition",
                           nodes=len(graph.nodes)) as sp:
        for node in graph.nodes:
            if isinstance(node, (PoolNode, UpsampleNode)):
                flush()
                segments.append(node)
            else:
                run.append(node)
        flush()
        sp.set(segments=len(segments))
    return segments


def partition_graph_tuned(graph: NetGraph, tuned,
                          onchip_budget_bytes: int,
                          dtype_bytes: int = 4) -> list[Segment]:
    """Cut the backbone along an autotuned plan's explicit cut points.

    ``tuned`` is a ``repro_torch.tuning.TunedPlan``: its groups name
    graph-node index spans ``[start, stop)`` plus the tile shape each
    group's schedules use (carried on ``FusedGroup.tile_hw``). The
    spans must exactly tile the layer-node indices without crossing a
    boundary node — anything else is a stale or foreign plan and
    raises instead of silently mis-executing.
    """
    layer_idx = [i for i, n in enumerate(graph.nodes)
                 if isinstance(n, (ConvNode, DeformNode))]
    covered = [i for g in tuned.groups for i in range(g.start, g.stop)]
    if covered != layer_idx:
        raise ValueError(
            "tuned plan does not tile this graph's layer nodes "
            f"(plan covers {covered[:8]}..., graph has "
            f"{layer_idx[:8]}...)")

    segments: list[Segment] = []
    groups = iter(tuned.groups)
    with get_tracer().span("prepass.partition", nodes=len(graph.nodes),
                           tuned=True) as sp:
        i = 0
        while i < len(graph.nodes):
            node = graph.nodes[i]
            if isinstance(node, (PoolNode, UpsampleNode)):
                segments.append(node)
                i += 1
                continue
            g = next(groups)
            run = graph.nodes[g.start:g.stop]
            shapes = [LayerShape(n.h, n.w, n.c_in, n.c_out,
                                 n.kernel_size, dtype_bytes)
                      for n in run]
            plans = tuple(plan_network(shapes, onchip_budget_bytes))
            saved = sum(2 * n.h * n.w * n.c_out * dtype_bytes
                        for n in run[:-1])
            gp = GroupPlan(0, len(run), plans, saved)
            segments.append(FusedGroup(tuple(run), gp,
                                       tile_hw=(g.tile_h, g.tile_w)))
            i = g.stop
        sp.set(segments=len(segments))
    return segments


@functools.lru_cache(maxsize=64)
def _partition_cached(graph: NetGraph, onchip_budget_bytes: int,
                      dtype_bytes: int, autotune: str,
                      tuned) -> tuple[Segment, ...]:
    if tuned is not None:
        return tuple(partition_graph_tuned(graph, tuned,
                                           onchip_budget_bytes,
                                           dtype_bytes))
    return tuple(partition_graph(graph, onchip_budget_bytes, dtype_bytes))


def partition_graph_cached(graph: NetGraph, onchip_budget_bytes: int,
                           dtype_bytes: int = 4, autotune: str = "off",
                           tuned=None) -> list[Segment]:
    """Memoized :func:`partition_graph` for serving hot paths.

    ``NetGraph`` is a frozen dataclass of frozen nodes and a
    ``TunedPlan`` is all-tuple, so the full key — graph, budget,
    dtype, autotune mode, tuned plan — is hashable and the planner
    sweep (greedy or tuned) runs once per distinct deployment instead
    of once per request step. Every input that can change the plan is
    part of the memo key: a tuned run is never served a stale greedy
    partition (or the other way round), and two different tuned plans
    never collide. Segments are frozen; sharing them across calls is
    safe.
    """
    return list(_partition_cached(graph, int(onchip_budget_bytes),
                                  int(dtype_bytes), str(autotune),
                                  tuned))
