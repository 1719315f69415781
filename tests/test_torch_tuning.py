"""The autotuner slice of the port against the JAX package: the core
helpers it adds, the plan search, the plan cache and its files, tuned
execution through ``run_graph`` and the serving engine, and the package
exports.

Held to: integer work exactly equal (tile ids, histograms, plans, keys,
simulated DRAM bytes, trace records, dispatch counts); coordinates from
the two dense chains within 1e-5; tuned outputs within 1e-4 * max|ref|
(float32 sums in another order, through several layers); executed DRAM
== the simulator. The search is fed the JAX package's coordinates where
plans are compared, since the port's dense chain may round a coordinate
to the other side of a floor.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as j_core
import repro.runtime as j_runtime
import repro.tuning as j_tuning
from repro.core import tiles as j_tiles
from repro.core.deform import DeformableConvParams as JParams
from repro.core.deform import randomize_offset_conv
from repro.models.dcn_models import DcnNetConfig as JNetConfig
from repro.models.dcn_models import init_dcn_net as j_init_dcn_net
from repro.runtime import GraphConfig as JGraphConfig
from repro.runtime import PipelineConfig as JPipelineConfig
from repro.runtime import dcn_pipeline as j_pipeline
from repro.runtime import graph as jg
from repro.runtime import run_graph as j_run_graph
from repro.serving import DcnServingEngine as JEngine
from repro.tuning import autotune as j_autotune
import repro_torch.core as t_core
import repro_torch.runtime as t_runtime
import repro_torch.tuning as t_tuning
from repro_torch.convert import params_from_jax
from repro_torch.core import tiles as t_tiles
from repro_torch.core.deform import DeformableConvParams, deformable_conv2d
from repro_torch.core.simulator import simulate_network
from repro_torch.models.dcn_models import DcnNetConfig
from repro_torch.runtime import graph as tg
from repro_torch.runtime.fused_exec import (ONCHIP_BUDGET_BYTES, GraphConfig,
                                            network_sim_specs, run_graph,
                                            run_graph_dense)
from repro_torch.runtime.graph import build_graph, partition_graph_cached
from repro_torch.runtime.pipeline import PipelineConfig, dcn_pipeline
from repro_torch.serving import DcnServingEngine
from repro_torch.tuning import autotune as t_autotune
from repro_torch.tuning import (PlanCache, TunedGroup, TunedPlan,
                                autotune_plan, plan_cache_hits, plan_key,
                                resolve_tuned_plan, resolve_tuned_tile)

CFG = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
           num_classes=4)
TILE, BUFFER = (4, 4), 4
CHAIN_BUDGET = 512 * 1024


def _coords(seed, h, w, spread=2.0):
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                    -1)[:, :, None, :]
    c = base + rng.normal(scale=spread, size=(h, w, 9, 2))
    return np.clip(c, -1.5, [h + 0.5, w + 0.5]).astype(np.float32)


def _conv_np(rng, c_in, c_out):
    return dict(w=(rng.normal(size=(3, 3, c_in, c_out)) * 0.2)
                .astype(np.float32),
                b=(rng.normal(size=(c_out,)) * 0.1).astype(np.float32))


def _deform_np(rng, c_in, c_out, offset_scale=0.5):
    return dict(w_off=rng.normal(size=(3, 3, c_in, 18)).astype(np.float32)
                * np.float32(offset_scale / c_in),
                b_off=(rng.normal(size=(18,)) * 0.5).astype(np.float32),
                w=(rng.normal(size=(3, 3, c_in, c_out))
                   / np.sqrt(9 * c_in)).astype(np.float32),
                b=(rng.normal(size=(c_out,)) * 0.1).astype(np.float32))


def _to_jax(p):
    if "w_off" in p:
        return JParams(*(jnp.asarray(p[k])
                         for k in ("w_off", "b_off", "w", "b")))
    return {k: jnp.asarray(v) for k, v in p.items()}


def _to_port(p):
    if "w_off" in p:
        return DeformableConvParams(*(torch.as_tensor(p[k])
                                      for k in ("w_off", "b_off", "w", "b")))
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _carry(plan) -> TunedPlan:
    """A JAX-package plan as the port's, through its JSON form."""
    return TunedPlan.from_json(plan.to_json())


def _records(trace):
    return [[(g.image, g.group, g.kernel_dispatches, g.dispatch,
              (g.grid.th, g.grid.tw))]
            + [dataclasses.astuple(r) for r in g.records]
            + [dataclasses.astuple(s) for s in g.layer_stats]
            for g in trace.groups]


@pytest.fixture(scope="module")
def vgg():
    """VGG19-2 DCN-II at 16x16, width 0.125: JAX params (offset convs
    randomised) carried to the port, both graphs, and the JAX tuner's
    coordinates of its representative input."""
    jcfg = JNetConfig(**CFG)
    key = jax.random.PRNGKey(2)
    params = j_init_dcn_net(key, jcfg)
    params["convs"] = [
        randomize_offset_conv(p, jax.random.fold_in(key, 100 + i),
                              2.0 / p.w.shape[2])
        if isinstance(p, JParams) else p
        for i, p in enumerate(params["convs"])]
    params = jax.tree.map(np.asarray, params)
    jparams = jax.tree.map(jnp.asarray, params)
    graph_j = jg.build_graph(jcfg)
    coords = [None if c is None else np.array(c) for c in
              j_autotune.collect_layer_coords(jparams["convs"], graph_j)]
    return dict(jparams=jparams, tparams=params_from_jax(params,
                                                         device="cpu"),
                graph_j=graph_j, graph_t=build_graph(DcnNetConfig(**CFG)),
                coords=coords, budget=ONCHIP_BUDGET_BYTES)


@pytest.fixture(scope="module")
def chain():
    """conv -> DCN -> conv -> pool -> conv at 13x13 (the JAX tuner tests'
    chain; 13 does not divide the tile), numpy params."""
    h = w = 13
    rng = np.random.default_rng(4)
    convs = [_conv_np(rng, 3, 6), _deform_np(rng, 6, 6, 2.0),
             _conv_np(rng, 6, 8), _conv_np(rng, 8, 8)]
    ph, pw = (h - 2) // 2 + 1, (w - 2) // 2 + 1

    def nodes(m):
        return (m.ConvNode(0, 3, 6, h, w), m.DeformNode(1, 6, 6, h, w),
                m.ConvNode(2, 6, 8, h, w), m.PoolNode(h, w, 8),
                m.ConvNode(3, 8, 8, ph, pw))

    jparams = {"convs": [_to_jax(p) for p in convs]}
    graph_j = jg.NetGraph(nodes(jg), h, w, 3)
    coords = [None if c is None else np.array(c) for c in
              j_autotune.collect_layer_coords(jparams["convs"], graph_j)]
    return dict(jparams=jparams,
                tparams={"convs": [_to_port(p) for p in convs]},
                graph_j=graph_j, graph_t=tg.NetGraph(nodes(tg), h, w, 3),
                coords=coords, budget=CHAIN_BUDGET)


@pytest.fixture(scope="module")
def cases(vgg, chain):
    return {"vgg": vgg, "chain": chain}


def _port_plan(case, monkeypatch, **kw):
    """The port's search on the JAX coordinates."""
    monkeypatch.setattr(
        t_autotune, "collect_layer_coords",
        lambda *a, **k: [None if c is None else torch.tensor(c)
                         for c in case["coords"]])
    return autotune_plan(case["tparams"]["convs"], case["graph_t"],
                         onchip_budget_bytes=case["budget"], **kw)


def _jax_plan(case, **kw):
    return j_tuning.autotune_plan(case["jparams"]["convs"], case["graph_j"],
                                  onchip_budget_bytes=case["budget"], **kw)


class TestCoreHelpers:
    @pytest.mark.parametrize("h,w,n", [(13, 11, 5), (14, 14, 4), (7, 9, 1)])
    def test_make_square_grid(self, h, w, n):
        assert tuple(t_tiles.make_square_grid(h, w, n)) == \
            tuple(j_tiles.make_square_grid(h, w, n))

    @pytest.mark.parametrize("th,tw", [(4, 3), (5, 5), (1, 11), (13, 11)])
    def test_access_helpers_equal_jax(self, th, tw):
        h, w = 13, 11
        co = _coords(5, h, w)
        tgrid, jgrid = (t_tiles.TileGrid(h, w, th, tw),
                        j_tiles.TileGrid(h, w, th, tw))
        ct, cj = torch.as_tensor(co), jnp.asarray(co)
        for got, want in (
                (t_tiles.per_pixel_input_tiles(ct, tgrid),
                 j_tiles.per_pixel_input_tiles(cj, jgrid)),
                (t_tiles.access_histogram(ct, h, w),
                 j_tiles.access_histogram(cj, h, w)),
                (t_tiles.tile_access_histogram(ct, tgrid),
                 j_tiles.tile_access_histogram(cj, jgrid))):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestSearch:
    @pytest.mark.parametrize("name,budget,buffer_tiles", [
        ("vgg", 8, BUFFER), ("vgg", 64, BUFFER), ("chain", 96, BUFFER),
        ("chain", 64, None)])
    def test_same_plan_from_the_same_coords(self, cases, monkeypatch, name,
                                            budget, buffer_tiles):
        case = cases[name]
        kw = dict(tile_hw=TILE, buffer_tiles=buffer_tiles, budget=budget)
        got = _port_plan(case, monkeypatch, **kw)
        want = _jax_plan(case, **kw)
        assert got.key == want.key
        assert [dataclasses.astuple(g) for g in got.groups] == \
            [dataclasses.astuple(g) for g in want.groups]
        assert (got.dram_bytes, got.greedy_dram_bytes, got.candidates) == \
            (want.dram_bytes, want.greedy_dram_bytes, want.candidates)
        assert got.dram_bytes <= got.greedy_dram_bytes

    def test_tuned_plan_leaves_the_default_tile(self, cases, monkeypatch):
        """The plans the execution tests replay move off the default
        tile, so they exercise the per-group grid."""
        for name, budget in (("vgg", 64), ("chain", 96)):
            plan = _port_plan(cases[name], monkeypatch, tile_hw=TILE,
                              buffer_tiles=BUFFER, budget=budget)
            assert any((g.tile_h, g.tile_w) != TILE for g in plan.groups)
            assert plan.dram_bytes < plan.greedy_dram_bytes

    @pytest.mark.parametrize("buffer_tiles", [None, 3])
    def test_same_tile_from_the_same_coords(self, chain, buffer_tiles):
        kw = dict(c_in=6, c_out=6, kernel_size=3, autotune="offline",
                  dtype_bytes=4, tile_hw=TILE, buffer_tiles=buffer_tiles,
                  schedule="alg1")
        for co in (chain["coords"][1], _coords(6, 13, 13, spread=3.0)):
            got = resolve_tuned_tile(torch.as_tensor(co), 13, 13,
                                     plan_cache=PlanCache(), **kw)
            want = j_tuning.resolve_tuned_tile(
                jnp.asarray(co), 13, 13, plan_cache=j_tuning.PlanCache(),
                **kw)
            assert got == want

    @pytest.mark.parametrize("name", ["vgg", "chain"])
    def test_coords_match_jax(self, cases, name):
        case = cases[name]
        g = case["graph_j"]
        x = np.random.default_rng(8).normal(
            size=(1, g.in_h, g.in_w, g.in_c)).astype(np.float32)
        want = j_autotune.collect_layer_coords(case["jparams"]["convs"], g,
                                               x=jnp.asarray(x))
        got = t_autotune.collect_layer_coords(case["tparams"]["convs"],
                                              case["graph_t"],
                                              x=torch.as_tensor(x))
        assert [c is None for c in got] == [c is None for c in want]
        assert any(c is not None for c in got)
        for a, b in zip(got, want):
            if b is not None:
                assert a.device.type == "cpu" and a.dtype == torch.float32
                assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5

    def test_representative_input_is_seeded(self, vgg):
        g = vgg["graph_t"]
        a = t_tuning.representative_input(g, seed=3, device="cpu")
        assert tuple(a.shape) == (1, g.in_h, g.in_w, g.in_c)
        assert torch.equal(a, t_tuning.representative_input(g, seed=3,
                                                            device="cpu"))
        assert not torch.equal(a, t_tuning.representative_input(
            g, seed=4, device="cpu"))


class TestPlanFiles:
    def _plan(self, case, monkeypatch):
        return _port_plan(case, monkeypatch, tile_hw=TILE,
                          buffer_tiles=BUFFER, budget=32)

    @pytest.mark.parametrize("name", ["vgg", "chain"])
    def test_plan_key_equal(self, cases, name):
        kw = dict(batch=4, onchip_budget_bytes=ONCHIP_BUDGET_BYTES,
                  dtype_bytes=4, tile_hw=TILE, buffer_tiles=BUFFER,
                  schedule="alg1", max_displacement=None)
        case = cases[name]
        assert plan_key(case["graph_t"], **kw) == \
            j_tuning.plan_key(case["graph_j"], **kw)
        assert t_tuning.net_digest(case["graph_t"]) == \
            j_tuning.net_digest(case["graph_j"])

    def test_jax_file_served_by_port(self, chain, tmp_path):
        want = _jax_plan(chain, tile_hw=TILE, buffer_tiles=BUFFER, budget=32)
        j_tuning.PlanCache(cache_dir=str(tmp_path)).put(want.key, want)
        got = PlanCache(cache_dir=str(tmp_path)).get(want.key)
        assert got == _carry(want)
        assert got.to_json() == want.to_json()

    def test_port_file_served_by_jax(self, chain, monkeypatch, tmp_path):
        plan = self._plan(chain, monkeypatch)
        PlanCache(cache_dir=str(tmp_path)).put(plan.key, plan)
        fresh = j_tuning.PlanCache(cache_dir=str(tmp_path))
        got = fresh.get(plan.key)
        assert got is not None and got.to_json() == plan.to_json()
        assert fresh.disk_hits == 1

    def test_corrupt_file_is_a_clean_miss(self, chain, tmp_path):
        kw = dict(onchip_budget_bytes=CHAIN_BUDGET, tile_hw=TILE,
                  buffer_tiles=BUFFER, budget=32)
        convs, graph = chain["tparams"]["convs"], chain["graph_t"]
        plan = resolve_tuned_plan(convs, graph, autotune="offline",
                                  plan_cache_dir=str(tmp_path), **kw)
        (f,) = tmp_path.glob("plan-*.json")
        f.write_text("{not json")
        fresh = PlanCache(cache_dir=str(tmp_path))
        assert resolve_tuned_plan(convs, graph, autotune="cached-only",
                                  plan_cache=fresh, **kw) is None
        redo = resolve_tuned_plan(convs, graph, autotune="offline",
                                  plan_cache=fresh, **kw)
        assert (redo.key, redo.groups, redo.dram_bytes) == \
            (plan.key, plan.groups, plan.dram_bytes)
        assert json.loads(f.read_text())["key"]      # file rewritten

    def test_wrong_key_in_file_is_a_miss(self, chain, monkeypatch,
                                         tmp_path):
        plan = self._plan(chain, monkeypatch)
        PlanCache(cache_dir=str(tmp_path)).put(plan.key, plan)
        (f,) = tmp_path.glob("plan-*.json")
        doc = json.loads(f.read_text())
        doc["key"][0] = "0" * 40                     # forge the digest
        f.write_text(json.dumps(doc))
        assert PlanCache(cache_dir=str(tmp_path)).get(plan.key) is None

    def test_cached_only_never_searches(self, chain, tmp_path):
        out = resolve_tuned_plan(
            chain["tparams"]["convs"], chain["graph_t"],
            autotune="cached-only", onchip_budget_bytes=CHAIN_BUDGET,
            tile_hw=TILE, buffer_tiles=BUFFER, plan_cache_dir=str(tmp_path))
        assert out is None
        assert list(tmp_path.glob("plan-*.json")) == []

    def test_disk_round_trip_counts_a_hit(self, chain, tmp_path):
        kw = dict(onchip_budget_bytes=CHAIN_BUDGET, tile_hw=TILE,
                  buffer_tiles=BUFFER, budget=32)
        convs, graph = chain["tparams"]["convs"], chain["graph_t"]
        plan = resolve_tuned_plan(convs, graph, autotune="offline",
                                  plan_cache_dir=str(tmp_path), **kw)
        hits0 = plan_cache_hits.count
        again = resolve_tuned_plan(convs, graph, autotune="cached-only",
                                   plan_cache=PlanCache(
                                       cache_dir=str(tmp_path)), **kw)
        assert again == plan
        assert plan_cache_hits.count == hits0 + 1

    def test_plan_json_round_trip(self):
        plan = TunedPlan(
            key=("d" * 40, 8, 8, 1, CHAIN_BUDGET, 4, 4, 4, None, "alg1",
                 None),
            groups=(TunedGroup(0, 2, 4, 8),), dram_bytes=123,
            greedy_dram_bytes=456, candidates=7, search_s=0.5)
        assert TunedPlan.from_json(plan.to_json()) == plan
        assert plan.to_json() == j_tuning.TunedPlan.from_json(
            plan.to_json()).to_json()


JAX_RUNS: dict = {}
PLAN_BUDGET = {"vgg": 64, "chain": 96}


def _images(case, n=2):
    g = case["graph_j"]
    return np.random.default_rng(11).normal(
        size=(n, g.in_h, g.in_w, g.in_c)).astype(np.float32)


def _jax_tuned_run(case, name, dispatch):
    key = (name, dispatch)
    if key not in JAX_RUNS:
        plan = _jax_plan(case, tile_hw=TILE, buffer_tiles=BUFFER,
                         budget=PLAN_BUDGET[name])
        y, trace = j_run_graph(
            case["jparams"]["convs"], case["graph_j"],
            jnp.asarray(_images(case)),
            config=JGraphConfig(tile=TILE, buffer_tiles=BUFFER,
                                dispatch=dispatch,
                                onchip_budget_bytes=case["budget"],
                                use_schedule_cache=False),
            return_trace=True, tuned_plan=plan)
        JAX_RUNS[key] = (plan, np.asarray(y), trace)
    return JAX_RUNS[key]


@pytest.mark.parametrize("name,dispatch,backend", [
    ("vgg", "batch_fused", "device"), ("vgg", "batched", "host"),
    ("chain", "batch_fused", "host"), ("chain", "batch_fused", "device"),
    ("chain", "batched", "device")])
def test_tuned_execution_matches_jax(cases, name, dispatch, backend):
    case = cases[name]
    plan, want, want_tr = _jax_tuned_run(case, name, dispatch)
    x = torch.as_tensor(_images(case))
    cfg = GraphConfig(tile=TILE, buffer_tiles=BUFFER, dispatch=dispatch,
                      schedule_backend=backend,
                      onchip_budget_bytes=case["budget"],
                      use_schedule_cache=False)
    y, trace = run_graph(case["tparams"]["convs"], case["graph_t"], x,
                         config=cfg, return_trace=True,
                         tuned_plan=_carry(plan))
    assert y.shape == want.shape
    assert np.abs(y.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    dense = run_graph_dense(case["tparams"]["convs"], case["graph_t"], x)
    assert (y - dense).abs().max() <= 1e-4 * dense.abs().max()
    assert _records(trace) == _records(want_tr)
    assert {(g.grid.th, g.grid.tw) for g in trace.groups} != {TILE}
    assert (trace.kernel_dispatches, trace.batch_dispatches) == \
        (want_tr.kernel_dispatches, want_tr.batch_dispatches)
    assert trace.total_dram_bytes == want_tr.total_dram_bytes
    sim = simulate_network(network_sim_specs(trace),
                           boundary_bytes=trace.boundary_bytes)
    assert sim.total_dram_bytes == trace.total_dram_bytes


def test_offline_run_graph_resolves_through_the_cache(chain, tmp_path):
    """``tuned_plan="auto"`` with ``autotune="offline"`` searches once,
    persists the plan and executes it: trace == simulator, output ==
    dense, and the executed DRAM equals the plan's score on the tuner's
    own input."""
    convs, graph = chain["tparams"]["convs"], chain["graph_t"]
    x = t_tuning.representative_input(graph, device="cpu")
    cfg = GraphConfig(tile=TILE, buffer_tiles=BUFFER, autotune="offline",
                      autotune_budget=96, plan_cache_dir=str(tmp_path),
                      onchip_budget_bytes=CHAIN_BUDGET)
    y, trace = run_graph(convs, graph, x, config=cfg, return_trace=True)
    (f,) = tmp_path.glob("plan-*.json")
    plan = TunedPlan.from_json(json.loads(f.read_text()))
    assert [(g.grid.th, g.grid.tw) for g in trace.groups] == \
        [(g.tile_h, g.tile_w) for g in plan.groups]
    sim = simulate_network(network_sim_specs(trace),
                           boundary_bytes=trace.boundary_bytes)
    assert sim.total_dram_bytes == trace.total_dram_bytes
    dense = run_graph_dense(convs, graph, x)
    assert (y - dense).abs().max() <= 1e-4 * dense.abs().max()
    _, greedy = run_graph(convs, graph, x, return_trace=True,
                          config=dataclasses.replace(cfg, autotune="off"))
    assert trace.total_dram_bytes <= greedy.total_dram_bytes


def test_pipeline_autotune_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    p = _deform_np(rng, 5, 7, offset_scale=2.0)
    x = rng.normal(size=(2, 13, 10, 5)).astype(np.float32)
    kw = dict(tile=(4, 3), buffer_tiles=5, use_schedule_cache=False,
              autotune="offline")
    want_y, want_tr = j_pipeline(
        jnp.asarray(x), _to_jax(p), return_trace=True,
        config=JPipelineConfig(**kw, plan_cache_dir=str(tmp_path / "j")))
    y, trace = dcn_pipeline(
        torch.as_tensor(x), _to_port(p), return_trace=True,
        config=PipelineConfig(**kw, plan_cache_dir=str(tmp_path / "t")))
    want = np.asarray(want_y)
    assert np.abs(y.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    ref = deformable_conv2d(torch.as_tensor(x), _to_port(p))
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert [(im.grid.th, im.grid.tw) for im in trace.images] == \
        [(im.grid.th, im.grid.tw) for im in want_tr.images]
    assert ([[dataclasses.astuple(r) for r in im.records]
             for im in trace.images]
            == [[dataclasses.astuple(r) for r in im.records]
                for im in want_tr.images])
    assert trace.kernel_dispatches == want_tr.kernel_dispatches


class TestPartitionMemo:
    def test_greedy_and_tuned_kept_apart(self, chain, monkeypatch):
        graph = chain["graph_t"]
        greedy = partition_graph_cached(graph, CHAIN_BUDGET)
        plan = _port_plan(chain, monkeypatch, tile_hw=TILE,
                          buffer_tiles=BUFFER, budget=64)
        tuned = partition_graph_cached(graph, CHAIN_BUDGET,
                                       autotune="offline", tuned=plan)
        tile_hws = [s.tile_hw for s in tuned if hasattr(s, "tile_hw")]
        assert tile_hws and all(t is not None for t in tile_hws)
        assert all(s.tile_hw is None for s in greedy
                   if hasattr(s, "tile_hw"))
        greedy2 = partition_graph_cached(graph, CHAIN_BUDGET)
        assert greedy2 == greedy and greedy2 != tuned
        assert all(a is b for a, b in zip(greedy2, greedy))
        tuned2 = partition_graph_cached(graph, CHAIN_BUDGET,
                                        autotune="offline", tuned=plan)
        assert all(a is b for a, b in zip(tuned2, tuned))

    def test_two_tuned_plans_kept_apart(self, chain, monkeypatch):
        graph = chain["graph_t"]
        plan = _port_plan(chain, monkeypatch, tile_hw=TILE,
                          buffer_tiles=BUFFER, budget=64)
        g0 = plan.groups[0]
        other = dataclasses.replace(plan, groups=(
            dataclasses.replace(g0, tile_h=g0.tile_h % 13 + 1),)
            + plan.groups[1:])
        a = partition_graph_cached(graph, CHAIN_BUDGET, autotune="offline",
                                   tuned=plan)
        b = partition_graph_cached(graph, CHAIN_BUDGET, autotune="offline",
                                   tuned=other)
        assert a[0].tile_hw == (g0.tile_h, g0.tile_w)
        assert b[0].tile_hw == (g0.tile_h % 13 + 1, g0.tile_w)
        assert a[1:] == b[1:]

    def test_partition_matches_jax(self, chain):
        plan = _jax_plan(chain, tile_hw=TILE, buffer_tiles=BUFFER,
                         budget=64)
        want = jg.partition_graph_tuned(chain["graph_j"], plan,
                                        CHAIN_BUDGET)
        got = tg.partition_graph_tuned(chain["graph_t"], _carry(plan),
                                       CHAIN_BUDGET)
        assert repr(got) == repr(want)

    def test_foreign_plan_raises(self, chain, vgg):
        plan = _jax_plan(vgg, tile_hw=TILE, buffer_tiles=BUFFER, budget=8)
        with pytest.raises(ValueError, match="does not tile"):
            tg.partition_graph_tuned(chain["graph_t"], _carry(plan),
                                     CHAIN_BUDGET)


@pytest.mark.parametrize("cls", [GraphConfig, PipelineConfig])
def test_config_validation(cls):
    with pytest.raises(ValueError, match="autotune"):
        cls(autotune="aggressive")
    with pytest.raises(ValueError, match="autotune_budget"):
        cls(autotune="offline", autotune_budget=0)
    assert cls(autotune="cached-only").autotune_budget == 128


class TestServing:
    def _serve(self, eng, x):
        eng.submit(x)
        (done,) = eng.drain()
        return np.asarray(done.result())

    def test_stats_and_metrics_surface_autotune(self, vgg, tmp_path):
        """As the JAX engine: ``plan_cache_hits`` / ``autotune_search_s``
        / ``tuned_groups`` in ``stats`` and ``metrics_snapshot()``; a
        second engine over the same directory hits the cache with zero
        search time; tuned serving equals greedy serving."""
        cfg = DcnNetConfig(**CFG)
        g = GraphConfig(tile=4, buffer_tiles=4, autotune="offline",
                        autotune_budget=64, plan_cache_dir=str(tmp_path))
        eng = DcnServingEngine(vgg["tparams"], cfg, graph=g, slots=2,
                               device="cpu")
        s = eng.stats
        assert s["autotune"] == "offline"
        assert s["tuned_groups"] == eng.tuned_groups > 0
        assert s["autotune_search_s"] == eng.tuned_plan.search_s > 0
        snap = eng.metrics_snapshot()
        for k in ("plan_cache_hits", "tuned_groups", "autotune_search_s"):
            assert snap[f"serving.{k}"] == s[k]

        eng2 = DcnServingEngine(vgg["tparams"], cfg, graph=g, slots=2,
                                device="cpu")
        s2 = eng2.stats
        assert eng2.tuned_plan == eng.tuned_plan
        assert s2["plan_cache_hits"] >= 1
        assert s2["autotune_search_s"] == 0.0

        x = _images(vgg, 1)[0]
        ref = DcnServingEngine(vgg["tparams"], cfg,
                               graph=GraphConfig(tile=4, buffer_tiles=4),
                               slots=2, device="cpu")
        got, want = self._serve(eng2, x), self._serve(ref, x)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        tr = eng2.last_trace
        assert [(gt.grid.th, gt.grid.tw) for gt in tr.groups] == \
            [(gr.tile_h, gr.tile_w) for gr in eng2.tuned_plan.groups]

    def test_autotune_off_engine_untouched(self, vgg):
        eng = DcnServingEngine(vgg["tparams"], DcnNetConfig(**CFG),
                               graph=GraphConfig(tile=4), slots=2,
                               device="cpu")
        s = eng.stats
        assert s["autotune"] == "off"
        assert s["tuned_groups"] == 0
        assert s["plan_cache_hits"] == 0
        assert eng.tuned_plan is None

    def test_engine_serves_a_jax_plan_file_as_jax(self, vgg, tmp_path):
        """A JAX engine searches and writes its plan; a port engine over
        the same directory in ``cached-only`` mode replays that plan and
        serves the JAX engine's logits, also on the degraded step."""
        from repro.testing import FaultInjector as JFaults
        from repro_torch.testing import FaultInjector

        kw = dict(tile=4, buffer_tiles=4, autotune="offline",
                  autotune_budget=64, plan_cache_dir=str(tmp_path))
        jeng = JEngine(vgg["jparams"], JNetConfig(**CFG),
                       graph=JGraphConfig(**kw), slots=2)
        eng = DcnServingEngine(
            vgg["tparams"], DcnNetConfig(**CFG), slots=2, device="cpu",
            graph=GraphConfig(**dict(kw, autotune="cached-only")))
        assert eng.tuned_plan.to_json() == jeng.tuned_plan.to_json()
        assert eng.stats["plan_cache_hits"] == 1
        assert eng.stats["autotune_search_s"] == 0.0
        xs = _images(vgg, 2)
        want = np.stack([self._serve(jeng, x) for x in xs])
        got = np.stack([self._serve(eng, x) for x in xs])
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        # An untagged dispatch fault degrades the step, which replays
        # the tuned plan per image.
        plan = dict(kinds=("dispatch",), rate=1.0, max_fires=1,
                    tag_image=False, seed=7)
        jf = JEngine(vgg["jparams"], JNetConfig(**CFG), slots=2,
                     graph=JGraphConfig(**kw), faults=JFaults(**plan))
        tf = DcnServingEngine(
            vgg["tparams"], DcnNetConfig(**CFG), slots=2, device="cpu",
            graph=GraphConfig(**kw), faults=FaultInjector(**plan))
        reqs = {}
        for e in (jf, tf):
            reqs[e] = [e.submit(x) for x in xs]
            e.drain()
            assert e.stats["degraded_steps"] == 1
        assert {(g.grid.th, g.grid.tw) for g in tf.last_trace.groups} == \
            {(g.tile_h, g.tile_w) for g in tf.tuned_plan.groups}
        got = np.stack([r.result() for r in reqs[tf]])
        want = np.stack([np.asarray(r.result()) for r in reqs[jf]])
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_exports_match_jax():
    """The port's ``core``, ``runtime`` and ``tuning`` export the JAX
    package's names, less the Pallas ``interpret`` resolver, which has no
    CUDA counterpart."""
    left_out = {"resolve_interpret"}
    for t_mod, j_mod in ((t_core, j_core), (t_runtime, j_runtime),
                         (t_tuning, j_tuning)):
        want = {n for n in (getattr(j_mod, "__all__", None)
                            or [n for n in dir(j_mod)
                                if not n.startswith("_")
                                and n not in {"deform", "fusion",
                                              "scheduler", "simulator",
                                              "tiles"}])
                if n not in left_out}
        assert set(t_mod.__all__) == want
        for n in t_mod.__all__:
            assert getattr(t_mod, n) is not None
