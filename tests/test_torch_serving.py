"""The slice as a whole: the port's DcnServingEngine against the JAX
package's on the same carried-across params and images, through
submit/drain, with both schedule backends.

Held to: logits within 1e-4 * max|logit| (float32 sums in another
order), per-image trace records identical, and trace == DRAM simulator.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.core.deform import DeformableConvParams, randomize_offset_conv
from repro.models.dcn_models import DcnNetConfig as JaxNetConfig
from repro.models.dcn_models import init_dcn_net as jax_init_dcn_net
from repro.runtime import GraphConfig as JaxGraphConfig
from repro.serving import DcnServingEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import scheduler as ts
from repro_torch.core.simulator import simulate_network
from repro_torch.models.dcn_models import (DcnNetConfig, dcn_net_apply,
                                           init_dcn_net)
from repro_torch.runtime.fused_exec import (GraphConfig, network_sim_specs,
                                            run_graph_dense)
from repro_torch.runtime.graph import build_graph
from repro_torch.serving import (DcnServingEngine, DeadlineExceededError,
                                 QueueFullError)

CFG = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
           num_classes=4)
# Two full steps on a 4-slot pool: a 2-image request splits across the
# steps, and image 0 is replayed so the schedule cache hits.
REQUESTS = [[0, 1], [2], [3, 4], [5], [0], [6]]


def _records(trace):
    return [[(gt.image, gt.group)] + [dataclasses.astuple(r)
                                      for r in gt.records]
            for gt in trace.groups]


def _drain(eng, xs):
    traces = []
    reqs = [eng.submit(xs[ids]) for ids in REQUESTS]
    done = []
    while len(done) < len(reqs):
        done += eng.step()
        traces.append(eng.last_trace)
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    return np.concatenate([r.result() for r in reqs]), traces


@pytest.fixture(scope="module")
def jax_case():
    jcfg = JaxNetConfig(**CFG)
    key = jax.random.PRNGKey(2)
    params = jax_init_dcn_net(key, jcfg)
    params["convs"] = [
        randomize_offset_conv(p, jax.random.fold_in(key, 100 + i),
                              2.0 / p.w.shape[2])
        if isinstance(p, DeformableConvParams) else p
        for i, p in enumerate(params["convs"])]
    xs = np.random.default_rng(0).normal(size=(7, 16, 16, 3)).astype(
        np.float32)
    eng = JaxEngine(params, jcfg, graph=JaxGraphConfig(tile=4), slots=4)
    logits, traces = _drain(eng, xs)
    return jax.tree.map(np.asarray, params), xs, logits, traces


@pytest.fixture(scope="module")
def port_params(jax_case):
    return params_from_jax(jax_case[0], device="cpu")


@pytest.fixture(scope="module", params=["host", "device"])
def port_run(request, port_params, jax_case):
    eng = DcnServingEngine(
        port_params, DcnNetConfig(**CFG),
        graph=GraphConfig(tile=4, schedule_backend=request.param),
        slots=4, device="cpu")
    b0 = ts.host_schedule_builds.count
    logits, traces = _drain(eng, jax_case[1])
    return (eng, logits, traces, ts.host_schedule_builds.count - b0,
            eng.stats, eng.metrics_snapshot())


def test_logits_match_jax(port_run, jax_case):
    want = jax_case[2]
    got = port_run[1]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_trace_records_match_jax(port_run, jax_case):
    traces, want = port_run[2], jax_case[3]
    assert len(traces) == len(want) == 2
    for got_t, want_t in zip(traces, want):
        assert _records(got_t) == _records(want_t)
        assert got_t.total_dram_bytes == want_t.total_dram_bytes


def test_trace_equals_simulator(port_run):
    for tr in port_run[2]:
        sim = simulate_network(network_sim_specs(tr),
                               boundary_bytes=tr.boundary_bytes)
        assert sim.total_dram_bytes == tr.total_dram_bytes


def test_engine_counters(port_run):
    eng, _, _, builds, s, snap = port_run
    assert s["steps"] == 2 and s["images"] == 8 and s["requests"] == 6
    assert s["image_hits"] >= 1             # the replayed image
    assert s["latency"]["count"] == 6
    assert s["host_schedule_builds"] == builds
    if eng.graph_cfg.schedule_backend == "device":
        assert builds == 0                  # no host schedule on the path
    else:
        assert builds > 0
    assert snap["serving.steps"] == s["steps"]
    assert snap["serving.host_schedule_builds"] == builds


def test_dense_model_and_graph_match(port_params, jax_case):
    cfg = DcnNetConfig(**CFG)
    x = torch.as_tensor(jax_case[1][:2])
    dense = dcn_net_apply(port_params, cfg, x, backend="dense")
    graph = dcn_net_apply(port_params, cfg, x, backend="graph",
                          graph=GraphConfig(tile=4))
    want = jax_case[2][:2]
    scale = np.abs(want).max()
    assert np.abs(dense.numpy() - want).max() <= 1e-4 * scale
    assert np.abs(graph.numpy() - want).max() <= 1e-4 * scale
    y = run_graph_dense(port_params["convs"], build_graph(cfg), x)
    assert y.shape == (2, 1, 1, 64)


def test_other_dispatch_modes_name_the_later_slice(port_params, jax_case):
    """The per-image modes, ported by the tile-pipeline slice, serve the
    same logits as the engine; an unknown mode is still refused."""
    cfg = DcnNetConfig(**CFG)
    x = torch.as_tensor(jax_case[1][:2])
    want = jax_case[2][:2]
    for mode in ("batched", "per_tile"):
        got = dcn_net_apply(port_params, cfg, x, backend="graph",
                            graph=GraphConfig(tile=4, dispatch=mode))
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="unknown dispatch"):
        GraphConfig(dispatch="bogus")


def test_queue_policies_and_deadlines(port_params):
    cfg = DcnNetConfig(**CFG)
    now = [0.0]
    eng = DcnServingEngine(port_params, cfg, graph=GraphConfig(tile=4),
                           slots=1, max_queue=2, queue_policy="reject",
                           clock=lambda: now[0], device="cpu")
    x = np.zeros((16, 16, 3), np.float32)
    eng.submit(x)
    late = eng.submit(x, deadline_s=1.0)
    with pytest.raises(QueueFullError):
        eng.submit(x)
    now[0] = 5.0                          # late expires while queued
    done = eng.drain()
    assert len(done) == 2 and isinstance(late.error, DeadlineExceededError)
    with pytest.raises(ValueError, match="finite"):
        eng.submit(np.full((16, 16, 3), np.nan, np.float32))
    with pytest.raises(ValueError, match="request images"):
        eng.submit(np.zeros((8, 8, 3), np.float32))


def test_init_dcn_net_is_seeded():
    cfg = DcnNetConfig(**CFG)
    a = init_dcn_net(0, cfg, device="cpu")
    b = init_dcn_net(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(a["convs"][3]["w"], b["convs"][3]["w"])
    assert a["fc"]["w"].shape == (64, 4)


def test_a_failing_step_fails_its_requests_once(port_params, monkeypatch):
    from repro_torch.runtime import fused_exec
    from repro_torch.serving import RequestFailedError

    eng = DcnServingEngine(port_params, DcnNetConfig(**CFG),
                           graph=GraphConfig(tile=4), slots=2,
                           device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected executor fault")

    monkeypatch.setattr(fused_exec, "run_graph", boom)
    x = np.zeros((16, 16, 3), np.float32)
    reqs = [eng.submit(np.stack([x, x])), eng.submit(x)]
    done = eng.drain()
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    for r in reqs:
        assert isinstance(r.error, RequestFailedError)
        assert "injected executor fault" in str(r.error)
        with pytest.raises(RequestFailedError):
            r.result()
    assert eng.stats["requests_failed"] == 2
