"""Simulator-guided autotuner for partition cuts & per-group tiles.

The DRAM simulator (:mod:`repro_torch.core.simulator`) is cross-checked to
be *exactly* equal to executed traces, which makes it a free, trustworthy
cost model for offline design-space exploration. This module searches
over

* **cut points**: where to split each run of conv/deform layers into
  fused groups (fusing deeper grows the composite-TDT halo; cutting
  pays an interior boundary plane), and
* **per-group tile shapes** ``(tile_h, tile_w)``: the paper's Fig. 17
  lever — finer tiles dedup halo loads, coarser tiles amortize
  per-tile overheads,

scoring every candidate with :func:`simulate_group` on a deterministic
representative input, seeded by the greedy :func:`plan_fused_groups`
plan and refined by coordinate descent (tile passes + merge/split cut
moves) under a configurable simulator-evaluation budget. Only strict
improvements are accepted, so the tuned plan never scores worse than
the greedy seed.

Scoring mirrors the executor exactly: same grid clamping
(``min(tile, plane)``), same FIFO depth rule (``num_tiles`` when
``buffer_tiles`` is None), same TDT construction from the same offset
convs — so "simulated bytes under plan P" is precisely what
``run_graph`` will report when executing plan P on the same input.

The search is host work: the dense chain that yields the sampling
coordinates runs on the params' device, and each DCN layer's
coordinates are copied to the host once; every score after that is
numpy. Scores, moves and the budget are those of the JAX package's
tuner, so the same coordinates give the same plan in both.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.deform import conv2d, offsets_to_coords
from repro_torch.core.fusion import LayerShape, fused_tile_bytes, \
    plan_fused_groups
from repro_torch.core.simulator import simulate_group
from repro_torch.core.tiles import TileGrid, tdt_from_coords, \
    tdt_standard_conv
from repro_torch.obs import get_tracer
from repro_torch.runtime.graph import DeformNode, PoolNode, UpsampleNode, \
    node_weight_bytes
from repro_torch.tuning.plan_cache import PlanCache, TunedGroup, TunedPlan, \
    default_plan_cache, plan_key

AUTOTUNE_MODES = ("off", "offline", "cached-only")

# Candidate tile sides: powers of two (clamped to the plane) plus the
# config default. Grids past _MAX_TILES tiles are skipped — Algorithm-1
# scheduling is superlinear in tile count.
_TILE_SIDES = (1, 2, 4, 8, 16, 32)
_MAX_TILES = 1024


def representative_input(graph, seed: int = 0, device="cuda",
                         dtype=torch.float32) -> torch.Tensor:
    """Deterministic input the tuner scores on: (1, H, W, C) standard
    normal from a ``torch.Generator`` seeded with ``seed``, drawn on the
    host and moved to ``device`` (the card by default, like every entry
    point; ``device="cpu"`` asks for the host). Plans must be a pure
    function of the cache key, so the tuner never peeks at live traffic —
    a seeded image stands in for it (offset convs are the real net's;
    only the pixels are synthetic). It is not the JAX package's image: the
    two RNGs differ."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    x = torch.randn((1, graph.in_h, graph.in_w, graph.in_c),
                    generator=gen, dtype=dtype)
    return x.to(dev)


def _params_device(convs) -> torch.device:
    p = convs[0]
    return (p.w if hasattr(p, "w") else p["w"]).device


def collect_layer_coords(convs, graph, x: torch.Tensor | None = None,
                         max_displacement: float | None = None) -> list:
    """Per-node sampling coordinates of one input image, on the host.

    Advances the dense chain through the whole graph once, on the
    params' device, and records each DeformNode's ``(H, W, KK, 2)``
    float32 coords, copied to the host once (``None`` for standard
    convs and boundary nodes). Coords are tiling-independent, so one
    dense pass serves every candidate grid the search tries.
    """
    # Lazy import: fused_exec imports the tuner (run_graph resolves
    # plans), so the dense helpers are pulled in at call time.
    from repro_torch.runtime.fused_exec import apply_boundary_dense, \
        apply_layer_dense

    dev = _params_device(convs)
    if x is None:
        x = representative_input(graph, device=dev)
    plane = x[0].to(dev)
    out: list = []
    with torch.no_grad():
        for node in graph.nodes:
            if isinstance(node, (PoolNode, UpsampleNode)):
                out.append(None)
                plane = apply_boundary_dense(plane, node)
                continue
            p = convs[node.param_idx]
            if isinstance(node, DeformNode):
                offsets = conv2d(plane[None], p.w_off, p.b_off)
                coords = offsets_to_coords(offsets.float(), node.kernel_size,
                                           node.variant, max_displacement)[0]
                out.append(coords.cpu())
            else:
                out.append(None)
            plane = apply_layer_dense(plane, node, p, max_displacement)
    return out


def tile_candidates(h: int, w: int,
                    tile_hw: tuple[int, int]) -> list[tuple[int, int]]:
    """Candidate ``(tile_h, tile_w)`` shapes for an ``h x w`` plane:
    power-of-two sides clamped to the plane, plus the config default,
    minus grids with more than ``_MAX_TILES`` tiles."""
    hs = sorted({min(s, h) for s in _TILE_SIDES} | {min(tile_hw[0], h)})
    ws = sorted({min(s, w) for s in _TILE_SIDES} | {min(tile_hw[1], w)})
    out = []
    for th in hs:
        for tw in ws:
            if TileGrid(h, w, th, tw).num_tiles <= _MAX_TILES:
                out.append((th, tw))
    return out


class _GroupScorer:
    """Memoized simulated-DRAM scorer over one run of layer nodes.

    ``score(start, stop, th, tw)`` is the exact simulated DRAM bytes of
    ``nodes[start:stop]`` executed as ONE fused group at tile
    ``(th, tw)`` — input halo loads via FIFO replay of the composite
    TDT, the group's weight bytes, and the output plane write. TDTs
    are cached per (node, grid) and scores per (span, tile), so the
    coordinate descent only pays the simulator for genuinely new
    candidates; ``evals`` counts those paid evaluations against the
    search budget.
    """

    def __init__(self, nodes, coords, *, buffer_tiles, dtype_bytes,
                 schedule, tracer):
        self.nodes = list(nodes)
        self.coords = list(coords)
        self.h = self.nodes[0].h
        self.w = self.nodes[0].w
        self.buffer_tiles = buffer_tiles
        self.dtype_bytes = int(dtype_bytes)
        self.schedule = schedule
        self.tracer = tracer
        self.evals = 0
        self._tdts: dict = {}
        self._scores: dict = {}

    def grid(self, th: int, tw: int) -> TileGrid:
        return TileGrid(self.h, self.w,
                        min(th, self.h), min(tw, self.w))

    def _tdt(self, pos: int, grid: TileGrid) -> np.ndarray:
        key = (pos, grid.th, grid.tw)
        b = self._tdts.get(key)
        if b is None:
            c = self.coords[pos]
            if c is None:
                b = tdt_standard_conv(grid, grid,
                                      self.nodes[pos].kernel_size)
            else:
                b = tdt_from_coords(c, grid, grid).numpy()
            self._tdts[key] = b
        return b

    def feasible(self, start: int, stop: int, th: int, tw: int,
                 onchip_budget_bytes: int) -> bool:
        """Every layer's working set at this tile must fit the on-chip
        budget — the same TileBuffer bound ``plan_fusion`` enforces."""
        tp = min(th, self.h) * min(tw, self.w)
        for n in self.nodes[start:stop]:
            shape = LayerShape(n.h, n.w, n.c_in, n.c_out,
                               n.kernel_size, self.dtype_bytes)
            if fused_tile_bytes(shape, tp) > onchip_budget_bytes:
                return False
        return True

    def score(self, start: int, stop: int, th: int, tw: int) -> int:
        key = (start, stop, min(th, self.h), min(tw, self.w))
        cached = self._scores.get(key)
        if cached is not None:
            return cached
        grid = self.grid(th, tw)
        m = (grid.num_tiles if self.buffer_tiles is None
             else self.buffer_tiles)
        b_layers = [self._tdt(p, grid) for p in range(start, stop)]
        channels = [(n.c_in, n.c_out)
                    for n in self.nodes[start:stop]]
        weight = sum(node_weight_bytes(n, self.dtype_bytes)
                     for n in self.nodes[start:stop])
        with self.tracer.span("tuning.score", start=start, stop=stop,
                              tile_h=grid.th, tile_w=grid.tw):
            rep = simulate_group(b_layers, grid, channels, weight, m,
                                 dtype_bytes=self.dtype_bytes,
                                 fused=True, schedule=self.schedule)
        self.evals += 1
        bytes_ = int(rep.total_dram_bytes)
        self._scores[key] = bytes_
        return bytes_


def _tune_run(scorer: _GroupScorer, seed_groups, *, candidates,
              onchip_budget_bytes, budget, evals_before: int):
    """Coordinate descent over one run of layers.

    ``seed_groups`` is a list of ``(start, stop, th, tw)`` (run-local
    indices) from the greedy plan at the default tile. Moves: per-group
    tile swap, merge of adjacent groups, split at an interior point —
    each accepted only on a strict simulated-DRAM improvement, so the
    result can never score worse than the seed. The budget counts paid
    simulator evaluations across the whole plan (memo hits are free).
    """
    groups = list(seed_groups)

    def left() -> int:
        return budget - (evals_before + scorer.evals)

    for _ in range(8):                      # descent passes
        improved = False

        # Tile pass: best feasible candidate tile per group.
        for i, (a, b, th, tw) in enumerate(groups):
            if left() <= 0:
                break
            cur = scorer.score(a, b, th, tw)
            best = (cur, th, tw)
            for cth, ctw in candidates:
                if left() <= 0:
                    break
                if (cth, ctw) == (th, tw):
                    continue
                if not scorer.feasible(a, b, cth, ctw,
                                       onchip_budget_bytes):
                    continue
                c = scorer.score(a, b, cth, ctw)
                if c < best[0]:
                    best = (c, cth, ctw)
            if best[1:] != (th, tw):
                groups[i] = (a, b, best[1], best[2])
                improved = True

        # Merge pass: fuse adjacent groups when the composite halo is
        # cheaper than paying the interior boundary plane. One merge
        # step pays at most 4 evals (two merge candidates + the two
        # current-group scores when unmemoized), so require that much
        # headroom — the budget is a hard cap, not a hint.
        i = 0
        while i < len(groups) - 1 and left() >= 4:
            a, b, th1, tw1 = groups[i]
            b2, c, th2, tw2 = groups[i + 1]
            merged = None
            for th, tw in {(th1, tw1), (th2, tw2)}:
                if not scorer.feasible(a, c, th, tw,
                                       onchip_budget_bytes):
                    continue
                s = scorer.score(a, c, th, tw)
                if merged is None or s < merged[0]:
                    merged = (s, th, tw)
            if merged is not None and merged[0] < (
                    scorer.score(a, b, th1, tw1)
                    + scorer.score(b2, c, th2, tw2)):
                groups[i:i + 2] = [(a, c, merged[1], merged[2])]
                improved = True
            else:
                i += 1

        # Split pass: cut a group when two shallower halos beat one
        # deep composite halo (halves inherit the parent tile; the
        # next tile pass re-optimizes them independently). A split
        # step pays the whole-group score (<= 1 eval) plus 2 evals per
        # cut point tried.
        i = 0
        while i < len(groups) and left() >= 3:
            a, b, th, tw = groups[i]
            whole = scorer.score(a, b, th, tw)
            cut = None
            for mid in range(a + 1, b):
                if left() <= 1:
                    break
                s = (scorer.score(a, mid, th, tw)
                     + scorer.score(mid, b, th, tw))
                if s < whole and (cut is None or s < cut[0]):
                    cut = (s, mid)
            if cut is not None:
                groups[i:i + 1] = [(a, cut[1], th, tw),
                                   (cut[1], b, th, tw)]
                improved = True
            i += 1

        if not improved or left() <= 0:
            break
    return groups


def autotune_plan(convs, graph, *, onchip_budget_bytes,
                  dtype_bytes: int = 4,
                  tile_hw: tuple[int, int] = (8, 8),
                  buffer_tiles: int | None = None,
                  schedule: str = "alg1", batch: int = 1,
                  budget: int = 128,
                  max_displacement: float | None = None,
                  x: torch.Tensor | None = None, tracer=None,
                  key: tuple | None = None) -> TunedPlan:
    """Search for the best partition + per-group tile plan of ``graph``.

    Returns a :class:`TunedPlan` whose ``dram_bytes`` is guaranteed
    ``<= greedy_dram_bytes`` (the greedy seed is a candidate and only
    strict improvements replace it). Per-image score; ``batch`` only
    rides in the cache key (every image of a batch replays the same
    plan, so the per-image argmin is the batch argmin).
    """
    tr = tracer if tracer is not None else get_tracer()
    if key is None:
        key = plan_key(graph, batch=batch,
                       onchip_budget_bytes=onchip_budget_bytes,
                       dtype_bytes=dtype_bytes, tile_hw=tile_hw,
                       buffer_tiles=buffer_tiles, schedule=schedule,
                       max_displacement=max_displacement)
    with tr.timed("tuning.search", nodes=len(graph.nodes),
                  budget=budget) as sp:
        coords = collect_layer_coords(convs, graph, x=x,
                                      max_displacement=max_displacement)
        tuned_groups: list[TunedGroup] = []
        tuned_total = 0
        greedy_total = 0
        evals = 0
        i, n = 0, len(graph.nodes)
        while i < n:
            node = graph.nodes[i]
            if isinstance(node, (PoolNode, UpsampleNode)):
                i += 1
                continue
            j = i
            while j < n and not isinstance(graph.nodes[j],
                                           (PoolNode, UpsampleNode)):
                j += 1
            run = graph.nodes[i:j]
            scorer = _GroupScorer(run, coords[i:j],
                                  buffer_tiles=buffer_tiles,
                                  dtype_bytes=dtype_bytes,
                                  schedule=schedule, tracer=tr)
            th0 = min(tile_hw[0], scorer.h)
            tw0 = min(tile_hw[1], scorer.w)
            shapes = [LayerShape(nd.h, nd.w, nd.c_in, nd.c_out,
                                 nd.kernel_size, dtype_bytes)
                      for nd in run]
            seed = [(gp.start, gp.stop, th0, tw0) for gp in
                    plan_fused_groups(shapes, onchip_budget_bytes)]
            greedy_total += sum(scorer.score(*g) for g in seed)
            cands = tile_candidates(scorer.h, scorer.w, tile_hw)
            tuned = _tune_run(scorer, seed, candidates=cands,
                              onchip_budget_bytes=onchip_budget_bytes,
                              budget=budget, evals_before=evals)
            tuned_total += sum(scorer.score(*g) for g in tuned)
            tuned_groups.extend(
                TunedGroup(i + a, i + b, th, tw)
                for a, b, th, tw in tuned)
            evals += scorer.evals
            i = j
        sp.set(candidates=evals, dram_bytes=tuned_total,
               greedy_dram_bytes=greedy_total)
    return TunedPlan(key=key, groups=tuple(tuned_groups),
                     dram_bytes=int(tuned_total),
                     greedy_dram_bytes=int(greedy_total),
                     candidates=int(evals),
                     search_s=float(sp.dur))


def resolve_tuned_plan(convs, graph, *, autotune: str,
                       onchip_budget_bytes, dtype_bytes: int = 4,
                       tile_hw: tuple[int, int] = (8, 8),
                       buffer_tiles: int | None = None,
                       schedule: str = "alg1", batch: int = 1,
                       budget: int = 128,
                       plan_cache_dir: str | None = None,
                       max_displacement: float | None = None,
                       plan_cache: PlanCache | None = None,
                       tracer=None) -> TunedPlan | None:
    """Cache-through plan resolution — the one entry point executors
    and the serving engine use.

    ``off`` → None (greedy planning, no lookup). ``cached-only`` →
    the cached plan or None (never searches: serving replicas that
    must not pay search latency). ``offline`` → cached plan, or run
    the search and persist the winner.
    """
    if autotune not in AUTOTUNE_MODES:
        raise ValueError(f"unknown autotune mode: {autotune!r}")
    if autotune == "off":
        return None
    cache = plan_cache if plan_cache is not None \
        else default_plan_cache(plan_cache_dir)
    key = plan_key(graph, batch=batch,
                   onchip_budget_bytes=onchip_budget_bytes,
                   dtype_bytes=dtype_bytes, tile_hw=tile_hw,
                   buffer_tiles=buffer_tiles, schedule=schedule,
                   max_displacement=max_displacement)
    plan = cache.get(key)
    if plan is not None:
        return plan
    if autotune == "cached-only":
        return None
    plan = autotune_plan(convs, graph,
                         onchip_budget_bytes=onchip_budget_bytes,
                         dtype_bytes=dtype_bytes, tile_hw=tile_hw,
                         buffer_tiles=buffer_tiles, schedule=schedule,
                         batch=batch, budget=budget,
                         max_displacement=max_displacement,
                         tracer=tracer, key=key)
    cache.put(key, plan)
    return plan


def resolve_tuned_tile(coords, h: int, w: int, *, c_in: int,
                       c_out: int, kernel_size: int, autotune: str,
                       dtype_bytes: int,
                       tile_hw: tuple[int, int],
                       buffer_tiles: int | None, schedule: str,
                       budget: int = 128,
                       plan_cache_dir: str | None = None,
                       plan_cache: PlanCache | None = None,
                       tracer=None) -> tuple[int, int] | None:
    """Single-layer tile-shape tuning for ``dcn_pipeline``.

    The pipeline has one deformable layer and no partition to cut, so
    the search degenerates to picking the tile shape with the least
    simulated input traffic. Keyed on the layer geometry (not the
    coords): the first resolution's coords (one image's ``(H, W, KK,
    2)``, on any device; copied to the host once) act as the
    representative input and the winner is cached for every later call
    — the graph path's rule too, where plans deliberately generalize
    across inputs with the same key.
    """
    if autotune not in AUTOTUNE_MODES:
        raise ValueError(f"unknown autotune mode: {autotune!r}")
    if autotune == "off":
        return None
    cache = plan_cache if plan_cache is not None \
        else default_plan_cache(plan_cache_dir)
    key = ("layer", int(h), int(w), int(c_in), int(c_out),
           int(kernel_size), int(dtype_bytes),
           int(tile_hw[0]), int(tile_hw[1]),
           None if buffer_tiles is None else int(buffer_tiles),
           str(schedule))
    plan = cache.get(key)
    if plan is not None:
        g = plan.groups[0]
        return (g.tile_h, g.tile_w)
    if autotune == "cached-only":
        return None
    tr = tracer if tracer is not None else get_tracer()
    with tr.timed("tuning.search", nodes=1, budget=budget) as sp:
        coords = torch.as_tensor(coords).cpu()
        best = None
        evals = 0
        th0, tw0 = min(tile_hw[0], h), min(tile_hw[1], w)
        cands = [(th0, tw0)] + [
            c for c in tile_candidates(h, w, tile_hw)
            if c != (th0, tw0)]
        for th, tw in cands:
            if evals >= budget and best is not None:
                break
            grid = TileGrid(h, w, min(th, h), min(tw, w))
            m = (grid.num_tiles if buffer_tiles is None
                 else buffer_tiles)
            b = tdt_from_coords(coords, grid, grid).numpy()
            with tr.span("tuning.score", tile_h=grid.th,
                         tile_w=grid.tw):
                rep = simulate_group([b], grid, [(c_in, c_out)], 0, m,
                                     dtype_bytes=dtype_bytes,
                                     fused=True, schedule=schedule)
            evals += 1
            s = int(rep.total_dram_bytes)
            if best is None or s < best[0]:
                best = (s, grid.th, grid.tw)
        sp.set(candidates=evals, dram_bytes=best[0])
    plan = TunedPlan(key=key,
                     groups=(TunedGroup(0, 1, best[1], best[2]),),
                     dram_bytes=best[0], greedy_dram_bytes=best[0],
                     candidates=evals, search_s=float(sp.dur))
    cache.put(key, plan)
    return (best[1], best[2])
