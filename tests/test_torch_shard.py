"""Batch-axis scale-out of the port against the JAX package, on the CPU.

The port shards over a ``DeviceMesh`` that lists the CPU four times (the
counterpart of JAX's forced host devices). The JAX sharded executor
cannot be the oracle here (its ``shard_map`` fails on the installed jax,
``tests/test_shard_parity.py::TestShardedParity``), and the reference's
contract is that a sharded run is bitwise the single-device one. So the
port is held:

* host plumbing (``plan_batch_shards``, ``stack_rows``/``unstack_rows``,
  ``allgather_nbytes``, ``shard_batch_schedules``) equal to the JAX
  functions, array for array — ragged batches, an empty shard, an image
  with an empty schedule, a plan mismatch;
* sharded ``run_graph`` / ``dcn_pipeline`` bitwise equal to the port's
  own unsharded runs, and within 1e-4 * max|want| of the JAX
  single-device runs (float32 sums in another order); trace records
  equal, trace == simulator, ``shards`` and ``allgather_bytes``;
* the replica-aware engine's slot map, admission order and shard sizes
  equal to a JAX ``DcnServingEngine(data_parallel=4)`` built in a
  subprocess with 4 forced host devices (building it never reaches
  ``shard_map``), and exactly-once serving under a ``FaultPlan``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.scheduler import DeviceSchedule as JDeviceSchedule
from repro.core.scheduler import schedule_tiles as j_schedule_tiles
from repro.runtime import GraphConfig as JGraphConfig
from repro.runtime import PipelineConfig as JPipelineConfig
from repro.runtime import dcn_pipeline as j_pipeline
from repro.runtime import graph as jg
from repro.runtime import run_graph as j_run_graph
from repro.runtime import shard as j_shard
from repro_torch.core.scheduler import DeviceSchedule, schedule_tiles
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels.dcn_fused import (dcn_fused_batch,
                                           dcn_fused_batch_sharded,
                                           dcn_fused_batch_sharded_plain)
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh, mesh_chips
from repro_torch.models.dcn_models import DcnNetConfig, init_dcn_net
from repro_torch.runtime import graph as tg
from repro_torch.runtime import packing
from repro_torch.runtime import shard
from repro_torch.runtime.fused_exec import (GraphConfig, network_sim_specs,
                                            run_graph)
from repro_torch.runtime.pipeline import PipelineConfig, dcn_pipeline
from repro_torch.serving import DcnServingEngine, RequestFailedError
from repro_torch.testing import FaultInjector
from tests.test_torch_dispatch import (_conv_np, _deform_np, _records,
                                       _to_jax, _to_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = DeviceMesh.on("cpu", data=4)


# ---------------------------------------------------------------------------
# Host plumbing against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,sizes", [(10, 4, None), (5, 4, [3, 0, 2, 0]),
                                       (2, 4, None), (0, 3, None),
                                       (6, 2, [0, 6])])
def test_plan_batch_shards_equals_jax(n, d, sizes):
    got = shard.plan_batch_shards(n, d, sizes)
    want = j_shard.plan_batch_shards(n, d, sizes)
    assert (got.n, got.spans, got.sizes, got.n_max, got.n_shards) == \
        (want.n, want.spans, want.sizes, want.n_max, want.n_shards)


@pytest.mark.parametrize("args,match", [
    ((5, 2, [2, 2]), "sum to"), ((4, 2, [2, 1, 1]), "entries"),
    ((2, 2, [3, -1]), "negative"), ((4, 0, None), "n_shards"),
    ((-1, 2, None), "n must be")])
def test_plan_batch_shards_errors_equal_jax(args, match):
    for fn in (shard.plan_batch_shards, j_shard.plan_batch_shards):
        with pytest.raises(ValueError, match=match):
            fn(*args)


def test_stack_unstack_and_allgather_equal_jax():
    flat = np.random.default_rng(3).normal(size=(5 * 4, 6, 2)).astype(
        np.float32)
    for sizes in (None, [3, 0, 2, 0], [1, 1, 1, 2], [0, 0, 5, 0]):
        plan = shard.plan_batch_shards(5, 4, sizes)
        got = shard.stack_rows(torch.as_tensor(flat), plan, 4)
        want = j_shard.stack_rows(jnp.asarray(flat),
                                  j_shard.plan_batch_shards(5, 4, sizes), 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = shard.unstack_rows(got, plan, 4)
        np.testing.assert_array_equal(back.numpy(), flat)
        assert shard.allgather_nbytes(back) == \
            j_shard.allgather_nbytes(jnp.asarray(flat)) == flat.nbytes
    empty = shard.plan_batch_shards(0, 2)
    assert tuple(shard.unstack_rows(torch.zeros((2, 0, 6)), empty, 4)
                 .shape) == (0, 6)


def _tables(n, t=4, seed=0):
    """Per-image TDTs of an 8x8 plane in 4x4 tiles (4 tiles)."""
    rng = np.random.default_rng(seed)
    return [rng.random((t, t)) < 0.5 for _ in range(n)]


def _both_scheds(tables, t=4):
    port, jax_ = [], []
    for b in tables:
        port.append(DeviceSchedule.from_host(schedule_tiles(b, 2), t))
        jax_.append(JDeviceSchedule.from_host(j_schedule_tiles(b, 2), t))
    return port, jax_


EMPTY = np.zeros((4, 4), bool)   # the empty-TDT schedule: [0] / [[]]


@pytest.mark.parametrize("tables,sizes", [
    (_tables(5), None),                        # 2, 1, 1, 1: ragged
    (_tables(5, seed=1), [3, 0, 2, 0]),        # empty shards
    ([_tables(1)[0], EMPTY, _tables(1, seed=2)[0]], [2, 1]),  # empty sched
    (_tables(2, seed=3), [1, 0, 1]),
], ids=["ragged", "empty-shards", "empty-schedule", "middle-empty"])
def test_shard_batch_schedules_equal_jax(tables, sizes):
    port, jax_ = _both_scheds(tables)
    d = len(sizes) if sizes else 4
    got = shard.shard_batch_schedules(
        port, 4, 4, shard.plan_batch_shards(len(tables), d, sizes), "cpu")
    want = j_shard.shard_batch_schedules(
        jax_, 4, 4, j_shard.plan_batch_shards(len(tables), d, sizes))
    for name in shard.ShardedDispatch._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == torch.int32 and tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_shard_batch_schedules_plan_mismatch():
    port, jax_ = _both_scheds(_tables(2))
    with pytest.raises(ValueError, match="plan"):
        shard.shard_batch_schedules(port, 4, 4,
                                    shard.plan_batch_shards(3, 2), "cpu")
    with pytest.raises(ValueError, match="plan"):
        j_shard.shard_batch_schedules(jax_, 4, 4,
                                      j_shard.plan_batch_shards(3, 2))


def test_sharded_kernel_call_equals_unsharded():
    """#1 per shard on the operands of a ragged batch with an
    empty-schedule image and an empty shard: scattered back, bitwise the
    single call's rows; the untrimmed plain version over whole slabs
    agrees too, and a shard of no image launches nothing."""
    rng = np.random.default_rng(4)
    t, tp, c, o, kk = 4, 16, 6, 5, 9
    tables = [_tables(1, seed=5)[0], EMPTY, _tables(1, seed=6)[0],
              _tables(1, seed=7)[0]]
    port, _ = _both_scheds(tables)
    n = len(tables)
    x = torch.as_tensor(rng.normal(size=(n * t, tp, c)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, n * t * tp, (n * t, tp, kk, 4))
                          .astype(np.int32))
    coeff = torch.as_tensor(rng.random((n * t, tp, kk, 4))
                            .astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(kk, c, o)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(o,)).astype(np.float32))
    bd = packing.pack_batch_schedules(port, t, t, "cpu")
    y0 = dcn_fused_batch(x, bd.row_id, bd.dep_glb, bd.dep_cnt, idx, coeff,
                         w, b, t_in=t)
    target = torch.where(bd.oid >= 0, bd.row_id,
                         torch.full_like(bd.row_id, n * t)).long()
    want = torch.zeros((n * t + 1, tp, o))
    want[target] = y0
    plan = shard.plan_batch_shards(n, 4, [2, 0, 1, 1])
    sh = shard.shard_batch_schedules(port, t, t, plan, "cpu")
    ops = (shard.stack_rows(x, plan, t), sh.row_id, sh.dep_glb, sh.dep_cnt,
           shard.stack_rows(idx, plan, t), shard.stack_rows(coeff, plan, t))
    y = dcn_fused_batch_sharded(*ops, w, b, mesh=MESH, t_in=t,
                                sizes=plan.sizes)
    assert torch.equal(shard.scatter_shard_rows(y, sh, plan, t), want[:-1])
    assert torch.equal(y[1], b.expand(y.shape[1], tp, o))   # empty shard
    plain = dcn_fused_batch_sharded_plain(*ops, w, b, t_in=t)
    assert torch.equal(shard.scatter_shard_rows(plain, sh, plan, t), want[:-1])
    with pytest.raises(ValueError, match="leading dim"):
        dcn_fused_batch_sharded(*ops, w, b, mesh=DeviceMesh.on("cpu", 3),
                                t_in=t, sizes=[2, 1, 1])
    with pytest.raises(ValueError, match="per shard"):
        dcn_fused_batch_sharded(*ops, w, b, mesh=MESH, t_in=t,
                                sizes=[2, 1, 1])


# ---------------------------------------------------------------------------
# Sharded executors against the port's unsharded runs and the JAX ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph_case():
    """conv -> DCN -> DCN -> conv in one fused group, a pool, conv -> DCN;
    13x11 does not divide by the tiles; a batch of 3 over 4 shards."""
    h, w = 13, 11
    rng = np.random.default_rng(17)
    convs = [_conv_np(rng, 3, 6), _deform_np(rng, 6, 6, 2.0),
             _deform_np(rng, 6, 6, 2.0), _conv_np(rng, 6, 8),
             _conv_np(rng, 8, 8), _deform_np(rng, 8, 5, 2.0)]
    h2, w2 = (h - 2) // 2 + 1, (w - 2) // 2 + 1

    def nodes(m):
        return (m.ConvNode(0, 3, 6, h, w), m.DeformNode(1, 6, 6, h, w),
                m.DeformNode(2, 6, 6, h, w), m.ConvNode(3, 6, 8, h, w),
                m.PoolNode(h, w, 8), m.ConvNode(4, 8, 8, h2, w2),
                m.DeformNode(5, 8, 5, h2, w2))

    x = rng.normal(size=(3, h, w, 3)).astype(np.float32)
    want_y, want_tr = j_run_graph(
        [_to_jax(p) for p in convs], jg.NetGraph(nodes(jg), h, w, 3),
        jnp.asarray(x), config=JGraphConfig(tile=4, dispatch="batch_fused",
                                            use_schedule_cache=False),
        return_trace=True)
    graph = tg.NetGraph(nodes(tg), h, w, 3)
    pconvs = [_to_port(p) for p in convs]
    y0, tr0 = run_graph(pconvs, graph, torch.as_tensor(x),
                        config=GraphConfig(tile=4, schedule_backend="device",
                                           use_schedule_cache=False),
                        return_trace=True)
    return pconvs, graph, x, np.asarray(want_y), want_tr, y0, tr0


@pytest.mark.parametrize("backend,sizes", [
    ("device", None), ("device", [2, 0, 1, 0]), ("host", [1, 1, 0, 1]),
    ("device", [0, 0, 0, 3])])
def test_sharded_run_graph(graph_case, backend, sizes):
    convs, graph, x, want, want_tr, y0, tr0 = graph_case
    y, trace = run_graph(
        convs, graph, torch.as_tensor(x),
        config=GraphConfig(tile=4, schedule_backend=backend, mesh=MESH,
                           use_schedule_cache=False),
        return_trace=True, shard_sizes=sizes)
    assert torch.equal(y, y0)
    assert np.abs(y.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert _records(trace) == _records(tr0) == _records(want_tr)
    assert trace.kernel_dispatches == tr0.kernel_dispatches
    sim = simulate_network(network_sim_specs(trace),
                           boundary_bytes=trace.boundary_bytes)
    assert sim.total_dram_bytes == trace.total_dram_bytes == \
        tr0.total_dram_bytes
    assert (trace.shards, tr0.shards) == (4, 1)
    assert trace.allgather_bytes == y.numel() * 4 and tr0.allgather_bytes == 0


def test_sharded_dcn_pipeline():
    rng = np.random.default_rng(9)
    p = _deform_np(rng, 5, 7, offset_scale=2.0)
    x = rng.normal(size=(5, 13, 10, 5)).astype(np.float32)
    kw = dict(tile=(4, 3), dispatch="batch_fused", buffer_tiles=5,
              use_schedule_cache=False)
    want_y, want_tr = j_pipeline(jnp.asarray(x), _to_jax(p),
                                 config=JPipelineConfig(**kw),
                                 return_trace=True)
    want = np.asarray(want_y)
    y0 = dcn_pipeline(torch.as_tensor(x), _to_port(p),
                      config=PipelineConfig(**kw, schedule_backend="device"))
    for backend in ("host", "device"):
        y, trace = dcn_pipeline(
            torch.as_tensor(x), _to_port(p), return_trace=True,
            config=PipelineConfig(**kw, schedule_backend=backend,
                                  mesh=MESH))
        assert torch.equal(y, y0)
        assert np.abs(y.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        rec = [[dataclasses.astuple(r) for r in im.records]
               for im in trace.images]
        assert rec == [[dataclasses.astuple(r) for r in im.records]
                       for im in want_tr.images]
        assert trace.shards == 4
        t = trace.images[0].grid.num_tiles
        assert trace.allgather_bytes == 5 * t * 12 * 7 * 4


# ---------------------------------------------------------------------------
# Configs and meshes
# ---------------------------------------------------------------------------


def test_config_errors():
    for cfg_cls in (GraphConfig, PipelineConfig):
        for dispatch in ("batched", "per_tile"):
            with pytest.raises(ValueError, match="batch_fused"):
                cfg_cls(dispatch=dispatch, mesh=MESH)
            with pytest.raises(ValueError, match="batch_fused"):
                cfg_cls(dispatch=dispatch, data_parallel=2)
        with pytest.raises(ValueError, match="data_parallel"):
            cfg_cls(dispatch="batch_fused", data_parallel=0)
        cfg_cls(dispatch="batched", data_parallel=1)   # the no-op
    assert shard.resolve_shard_mesh(None, 1) is None
    assert shard.resolve_shard_mesh(DeviceMesh.on("cpu", 1), None) is None
    assert shard.resolve_shard_mesh(MESH, 8) is MESH
    assert MESH == DeviceMesh.on("cpu", data=4) and len({MESH, MESH}) == 1
    assert MESH.shape == {"data": 4, "model": 1} and mesh_chips(MESH) == 4


def test_shard_sizes_need_a_sharded_config(graph_case):
    convs, graph, x = graph_case[:3]
    with pytest.raises(ValueError, match="shard_sizes"):
        run_graph(convs, graph, torch.as_tensor(x),
                  config=GraphConfig(tile=4), shard_sizes=[5])
    with pytest.raises(ValueError, match="sum to"):
        run_graph(convs, graph, torch.as_tensor(x),
                  config=GraphConfig(tile=4, mesh=MESH),
                  shard_sizes=[1, 1, 1, 1])        # 4 images, not 3


def test_make_host_mesh_refuses_missing_devices(graph_case):
    convs, graph, x = graph_case[:3]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="DeviceMesh.on"):
        make_host_mesh(data=have + 1)
    with pytest.raises(ValueError, match="mesh axes"):
        make_host_mesh(data=0)
    with pytest.raises(ValueError, match=f"only {have} "):
        run_graph(convs, graph, torch.as_tensor(x),
                  config=GraphConfig(tile=4, data_parallel=max(2, have + 1)))


def test_weight_replicas_are_made_once():
    mesh = DeviceMesh((torch.device("cpu"), torch.device("meta")))
    w = torch.ones((6, 4))
    view = w.reshape(3, 2, 4)
    meta = torch.device("meta")
    first = mesh.replica(view, meta)
    assert mesh.replica(w.reshape(3, 2, 4), meta) is first  # a new view
    assert mesh.replica(w, torch.device("cpu")) is w
    w.add_(1)                                   # in place: a new copy
    assert mesh.replica(w.reshape(3, 2, 4), meta) is not first
    del w, view
    assert not mesh._replicas


# ---------------------------------------------------------------------------
# The replica-aware engine
# ---------------------------------------------------------------------------

CFG = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
           num_classes=4)
OCCUPANCY = [[], [0], [0, 1], [2, 3, 4], [0, 2, 4, 5], [1, 5], [0, 1, 2, 3],
             [0, 1, 2, 3, 4], [3], [0, 3, 5, 6, 7]]


def _engine_view(eng, slots):
    out = {"slot_replica": list(eng._slot_replica), "orders": [],
           "sizes": []}
    for occ in OCCUPANCY:
        occ = [i for i in occ if i < slots]
        eng._slots = [(None, 0) if i in occ else None for i in range(slots)]
        out["orders"].append(eng._admission_order())
        out["sizes"].append(eng._shard_sizes(
            [eng._slot_replica[i] for i in occ]))
    eng._slots = [None] * slots
    return out


def test_admission_equals_the_jax_engine():
    script = textwrap.dedent("""
        import json
        import jax
        from repro.models.dcn_models import DcnNetConfig
        from repro.runtime import GraphConfig
        from repro.serving import DcnServingEngine
        from tests.test_torch_shard import CFG, _engine_view
        assert jax.device_count() == 4
        out = {}
        for slots in (4, 6, 8):
            # The engine only keeps its params until it serves.
            eng = DcnServingEngine({}, DcnNetConfig(**CFG), slots=slots,
                                   graph=GraphConfig(
                                       tile=4, dispatch="batch_fused",
                                       data_parallel=4))
            assert eng.replicas == 4
            out[slots] = _engine_view(eng, slots)
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = DcnNetConfig(**CFG)
    params = init_dcn_net(0, cfg, device="cpu")
    for slots in (4, 6, 8):
        eng = DcnServingEngine(params, cfg, slots=slots, device="cpu",
                               graph=GraphConfig(tile=4, mesh=MESH))
        assert _engine_view(eng, slots) == want[str(slots)]
    with pytest.raises(ValueError, match="replicas"):
        DcnServingEngine(params, cfg, slots=3, device="cpu",
                         graph=GraphConfig(tile=4, mesh=MESH))


STORM = dict(kinds=("prepass", "dispatch"), rate=0.3, seed=13)


@pytest.mark.parametrize("plan", [None, STORM], ids=["clean", "storm"])
def test_engine_serves_exactly_once(plan):
    """The sharded engine (4 replicas of one slot) against the unsharded
    one under the same plan: the same requests fail, with the same
    retries and degraded steps; the healthy logits are bitwise equal;
    per-replica images add up to the images served."""
    cfg = DcnNetConfig(**CFG)
    params = init_dcn_net(3, cfg, device="cpu")
    xs = np.random.default_rng(5).normal(size=(8, 16, 16, 3)).astype(
        np.float32)
    runs = {}
    for name, mesh in (("one", None), ("four", MESH)):
        inj = FaultInjector(**plan) if plan else None
        eng = DcnServingEngine(params, cfg, slots=4, device="cpu",
                               faults=inj,
                               graph=GraphConfig(tile=4, mesh=mesh))
        reqs = [eng.submit(x) for x in xs]
        done = eng.drain(max_steps=100)
        assert sorted(r.rid for r in done) == [r.rid for r in reqs]
        assert len(done) == len({r.rid for r in done}) and eng.drain() == []
        runs[name] = eng, reqs, inj
    (e1, r1, i1), (e4, r4, i4) = runs["one"], runs["four"]
    assert [r.failed for r in r4] == [r.failed for r in r1]
    for a, b in zip(r4, r1):
        if a.failed:
            assert isinstance(a.error, RequestFailedError)
        else:
            assert np.array_equal(a.result(), b.result())
    st, st1 = e4.stats, e1.stats
    for k in ("step_retries", "degraded_steps", "requests_failed", "images",
              "kernel_dispatches"):
        assert st[k] == st1[k], k
    served = sum(not r.failed for r in r4)
    assert st["replicas"] == 4 and st1["replicas"] == 1
    assert sum(p["images"] for p in st["per_replica"]) == served
    assert st1["per_replica"][0]["images"] == served
    assert st1["allgather_bytes"] == 0
    snap = e4.metrics_snapshot()
    assert "serving.replica3.dispatches" in snap
    if plan is None:
        assert [p["images"] for p in st["per_replica"]] == [2, 2, 2, 2]
        # The 8 images' output planes, gathered once a step.
        assert st["allgather_bytes"] == 8 * 4 * int(np.prod(
            e4.net_graph.out_shape))
        assert all(p["dram_bytes"] > 0 for p in st["per_replica"])
        assert sum(p["dram_bytes"] for p in st["per_replica"]) == \
            st1["per_replica"][0]["dram_bytes"]
    else:
        assert i4.fired == i1.fired and i4.total_fired > 0
