"""Fault-tolerant serving in the port against the JAX package's engine.

Both engines serve the same images on carried-across parameters under the
same ``FaultPlan`` (the injectors' sha256 draws are the same, so a plan
fires at the same consultations in both). Held to: the same requests
fail, the same ``step_retries`` / ``degraded_steps`` / failure counts,
and the healthy requests' logits within 1e-4 * max|logit|. Also the
staging watchdog's failover (and the epoch guard that makes an abandoned
worker's late commit a no-op), exactly-once resolution under a fault
storm, the counters in ``metrics_snapshot()``, and that a kernel error is
never isolated as a request fault. ``tests/test_resilience.py`` lists the
behaviours mirrored here.
"""

import time

import numpy as np
import pytest
import torch

import jax

from repro.core.deform import DeformableConvParams, randomize_offset_conv
from repro.models.dcn_models import DcnNetConfig as JaxNetConfig
from repro.models.dcn_models import init_dcn_net as jax_init_dcn_net
from repro.runtime import GraphConfig as JaxGraphConfig
from repro.serving import DcnServingEngine as JaxEngine
from repro.testing import FaultInjector as JaxInjector
from repro_torch.convert import params_from_jax
from repro_torch.kernels._build import KernelError
from repro_torch.models.dcn_models import DcnNetConfig
from repro_torch.runtime import fused_exec
from repro_torch.runtime.fused_exec import GraphConfig, run_graph
from repro_torch.runtime.graph import build_graph
from repro_torch.serving import DcnServingEngine, RequestFailedError
from repro_torch.testing import FaultError, FaultInjector

CFG = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
           num_classes=4)


@pytest.fixture(scope="module")
def case():
    key = jax.random.PRNGKey(2)
    jparams = jax_init_dcn_net(key, JaxNetConfig(**CFG))
    jparams["convs"] = [
        randomize_offset_conv(p, jax.random.fold_in(key, 100 + i),
                              2.0 / p.w.shape[2])
        if isinstance(p, DeformableConvParams) else p
        for i, p in enumerate(jparams["convs"])]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    xs = np.random.default_rng(5).normal(size=(8, 16, 16, 3)).astype(
        np.float32)
    return jparams, tparams, xs


def _port(case, **kw):
    kw.setdefault("graph", GraphConfig(tile=4))
    return DcnServingEngine(case[1], DcnNetConfig(**CFG), device="cpu",
                            **kw)


def _serve(eng, xs, max_steps=100):
    reqs = [eng.submit(x) for x in xs]
    done = eng.drain(max_steps=max_steps)
    rids = [r.rid for r in done]
    assert sorted(rids) == [r.rid for r in reqs]      # each exactly once
    assert len(rids) == len(set(rids))
    assert eng.drain() == []
    return reqs


COUNTERS = ("step_retries", "degraded_steps", "requests_failed")
PLANS = {
    "tagged_dispatch": dict(kinds=("dispatch",), rate=1.0, max_fires=1,
                            seed=3),
    "tagged_prepass": dict(kinds=("prepass",), rate=1.0, max_fires=1,
                           seed=5),
    "untagged_transient": dict(kinds=("dispatch",), rate=1.0, max_fires=1,
                               tag_image=False, seed=7),
    "untagged_persistent": dict(kinds=("dispatch",), rate=1.0,
                                tag_image=False, seed=9),
    "storm": dict(kinds=("prepass", "dispatch"), rate=0.3, seed=13),
    "step_mode_storm": dict(kinds=("prepass", "dispatch", "cache_miss"),
                            rate=0.5, mode="step", seed=17),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_same_plan_same_outcome_as_jax(case, plan):
    jparams, _, xs = case
    j_inj, t_inj = JaxInjector(**PLANS[plan]), FaultInjector(**PLANS[plan])
    j_eng = JaxEngine(jparams, JaxNetConfig(**CFG),
                      graph=JaxGraphConfig(tile=4), slots=4, faults=j_inj)
    j_reqs = _serve(j_eng, xs)
    t_eng = _port(case, slots=4, faults=t_inj)
    t_reqs = _serve(t_eng, xs)
    assert [r.failed for r in t_reqs] == [r.failed for r in j_reqs]
    assert t_inj.fired == j_inj.fired
    for k in COUNTERS:
        assert t_eng.stats[k] == j_eng.stats[k], k
    for tr, jr in zip(t_reqs, j_reqs):
        if tr.failed:
            assert isinstance(tr.error, RequestFailedError)
            assert isinstance(tr.error.__cause__, FaultError)
            with pytest.raises(RequestFailedError):
                tr.result()
        else:
            want = jr.result()
            assert np.abs(tr.result() - want).max() <= \
                1e-4 * np.abs(want).max()


def test_degraded_step_equals_fault_free(case):
    """An untagged transient fault degrades the step to per-image batched
    dispatch; every request still matches a fault-free engine."""
    xs = case[2][:4]
    ref = np.concatenate([r.result() for r in _serve(_port(case), xs)])
    eng = _port(case, faults=FaultInjector(
        kinds=("dispatch",), rate=1.0, max_fires=1, tag_image=False))
    got = np.concatenate([r.result() for r in _serve(eng, xs)])
    assert eng.stats["degraded_steps"] == 1
    assert eng.last_trace.groups[0].dispatch == "batched"
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_watchdog_failover_serves_correct_results(case):
    """A staging worker stalled past ``watchdog_s`` is abandoned; the run
    fails over to synchronous prepass with unchanged results, and the
    failover shows in stats and the metrics snapshot."""
    xs = case[2][:3]
    ref = np.concatenate([r.result() for r in _serve(_port(case), xs)])
    inj = FaultInjector(kinds=("worker_stall",), rate=1.0, max_fires=1,
                        stall_s=0.4, seed=15)
    eng = _port(case, faults=inj,
                graph=GraphConfig(tile=4, watchdog_s=0.05))
    got = np.concatenate([r.result() for r in _serve(eng, xs)])
    assert inj.fired["worker_stall"] == 1
    assert eng.stats["watchdog_failovers"] >= 1
    assert eng.metrics_snapshot()["serving.watchdog_failovers"] >= 1
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dispatch", ["batch_fused", "batched"])
def test_abandoned_worker_commit_is_a_no_op(case, dispatch):
    """After a failover the stalled worker wakes and finishes its
    prepass; the epoch guard discards its commit, so a run afterwards
    (and the one that failed over) still equals a fault-free run."""
    g = build_graph(DcnNetConfig(**CFG))
    x = torch.as_tensor(case[2][:2])
    convs = case[1]["convs"]
    ref = run_graph(convs, g, x, config=GraphConfig(tile=4,
                                                    dispatch=dispatch))
    inj = FaultInjector(kinds=("worker_stall",), rate=1.0, max_fires=1,
                        stall_s=0.3)
    t0 = time.perf_counter()
    y = run_graph(convs, g, x, config=GraphConfig(
        tile=4, dispatch=dispatch, watchdog_s=0.02, faults=inj))
    assert inj.fired["worker_stall"] == 1
    time.sleep(max(0.0, 0.5 - (time.perf_counter() - t0)))  # worker done
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    again = run_graph(convs, g, x, config=GraphConfig(tile=4,
                                                      dispatch=dispatch))
    torch.testing.assert_close(again, ref, rtol=0, atol=0)


def test_failure_counters_in_metrics_snapshot(case):
    inj = FaultInjector(kinds=("dispatch",), rate=1.0, max_fires=1, seed=3)
    eng = _port(case, faults=inj)
    _serve(eng, case[2][:3])
    s, snap = eng.stats, eng.metrics_snapshot()
    for name in ("requests_failed", "deadline_expired", "queue_rejected",
                 "queue_shed", "step_retries", "degraded_steps",
                 "watchdog_failovers"):
        assert snap[f"serving.{name}"] == s[name], name
    assert s["step_retries"] == 1 and s["requests_failed"] == 1


def test_kernel_errors_are_not_isolated(case, monkeypatch):
    """A kernel that does not build or launch is a device fault, not a
    request's: it leaves step() instead of entering the ladder."""
    eng = _port(case)

    def broken(*a, **k):
        raise KernelError("dcn_fused_batch_launch: CUDA error 1 at launch")

    monkeypatch.setattr(fused_exec, "run_graph", broken)
    eng.submit(case[2][0])
    with pytest.raises(KernelError):
        eng.step()
    assert eng.stats["step_retries"] == 0
    assert eng.stats["degraded_steps"] == 0


def test_injector_draws_equal_jax():
    for kw in (dict(rate=0.3, seed=1), dict(rate=0.5, seed=4, mode="step"),
               dict(rate=1.0, max_fires=3, seed=2)):
        a, b = JaxInjector(**kw), FaultInjector(**kw)
        x = np.zeros((4, 4, 3), np.float32)
        for step in range(6):
            a.begin_step()
            b.begin_step()
            for kind in ("prepass", "dispatch", "cache_miss", "dispatch"):
                assert a._fire(kind) == b._fire(kind)
            assert a.miss_salt() == b.miss_salt()
            np.testing.assert_array_equal(a.corrupt(x), b.corrupt(x))
        assert a.fired == b.fired and a.total_fired == b.total_fired
