"""bf16 DCN serving: the port against the JAX package in bfloat16.

The same numpy values, rounded to bf16 in both frameworks (x, w and b;
the BLI coefficients stay float32, as the packers give them), go through
the JAX function and the port's:

* the plain versions of #1, #4 and #5 against the JAX kernels in
  interpret mode, within one bf16 ulp at the largest output (2**-7 *
  max|ref|): both sum in float32 and round once, in other orders, so two
  sums may round to neighbouring bf16 values;
* ``dcn_pipeline`` against ``repro.core.deform.deformable_conv2d``
  within 5e-2, the JAX package's own bf16 bound (``tests/test_pipeline``);
* ``run_graph`` in each dispatch mode against JAX's ``run_graph`` on a
  small DCN network: logits within one bf16 ulp of max|ref|, trace
  records (the schedules and their loads) equal to JAX's, and executed
  DRAM bytes equal to the simulator's at 2 bytes a value;
* ``DcnServingEngine.infer`` equal to ``run_graph`` plus the head, the
  sharded ``run_graph`` equal to the unsharded one, and the kernel model
  backends near the dense one;
* a mixed call (x and w of different types) equal to the widened call;
* bf16 images through ``DcnServingEngine.submit`` / ``step()`` against
  the JAX engine: logits within one bf16 ulp, trace records and DRAM
  bytes equal to JAX's and the simulator's at 2 B a value, float32
  images failing in both, and the degraded per-image step in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.deform import DeformableConvParams as JParams
from repro.core.deform import deformable_conv2d as j_deformable_conv2d
from repro.kernels import dcn_fused as j_fused
from repro.models.dcn_models import _apply_head as j_apply_head
from repro.runtime import GraphConfig as JGraphConfig
from repro.runtime import graph as jg
from repro.runtime import run_graph as j_run_graph
from repro_torch.convert import params_from_jax
from repro_torch.core.deform import (DeformableConvParams,
                                     randomize_offset_conv)
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels import dcn_fused as kf
from repro_torch.models.dcn_models import (DcnNetConfig, apply_head,
                                           dcn_net_apply, init_dcn_net)
from repro_torch.runtime import graph as tg
from repro_torch.runtime.graph import build_graph
from repro_torch.runtime.fused_exec import (GraphConfig, network_sim_specs,
                                            run_graph)
from repro_torch.runtime.pipeline import PipelineConfig, dcn_pipeline
from repro_torch.serving import DcnServingEngine
from tests.test_torch_dispatch import _conv_np, _deform_np, _records
from tests.test_torch_kernels import _fused_operands

BF16_ULP = 2.0 ** -7      # one bf16 ulp at the largest output
BF16 = torch.bfloat16


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as float32 values (both frameworks then
    read the same bf16 numbers)."""
    return torch.as_tensor(a).to(BF16).float().numpy()


def _within_ulp(got: torch.Tensor, want) -> None:
    assert got.dtype == BF16
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()


def _port_ops(ops, float_at):
    """numpy operands as torch tensors, bf16 at ``float_at`` (x, w, b)."""
    return [torch.as_tensor(a).to(BF16) if i in float_at
            else torch.as_tensor(a) for i, a in enumerate(ops)]


def _jax_ops(ops, float_at):
    return [jnp.asarray(a, jnp.bfloat16) if i in float_at else jnp.asarray(a)
            for i, a in enumerate(ops)]


# ---------------------------------------------------------------------------
# The plain kernels against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,t,tp,c,o,k_pad", [
    (2, 4, 16, 8, 8, 4),          # every slot of a 2x2 grid
    (3, 9, 4, 5, 7, 8),           # ragged widths, k_pad > deps
])
def test_batch_plain_matches_jax_in_bf16(n, t, tp, c, o, k_pad):
    ops = _fused_operands(n + t + 1, n, t, tp, c, o, k_pad)
    at = (0, 6, 7)                                  # x, w, b
    want = j_fused._dcn_fused_batch_jit(*_jax_ops(ops, at), t_in=t,
                                        block_p=tp, interpret=True)
    assert want.dtype == jnp.bfloat16
    _within_ulp(kf.dcn_fused_batch(*_port_ops(ops, at), t_in=t), want)


def _sched_operands(seed, t, t_in, tp, c, o, k_pad, kk=9):
    """One image's schedule operands: slot-local addresses, padding
    slots, a dep_cnt = 0 row."""
    rng = np.random.default_rng(seed)
    dep = np.stack([np.resize(rng.permutation(t_in), k_pad)
                    for _ in range(t)]).astype(np.int32)
    cnt = rng.integers(1, min(k_pad, t_in) + 1, size=t).astype(np.int32)
    cnt[-1] = 0
    return [rng.normal(size=(t_in, tp, c)).astype(np.float32), dep, cnt,
            rng.integers(0, k_pad * tp, size=(t, tp, kk, 4)).astype(
                np.int32),
            rng.uniform(size=(t, tp, kk, 4)).astype(np.float32),
            (rng.normal(size=(kk, c, o)) / np.sqrt(kk * c)).astype(
                np.float32),
            rng.normal(size=(o,)).astype(np.float32)]


@pytest.mark.parametrize("t,t_in,tp,c,o,k_pad", [(3, 5, 16, 8, 8, 4),
                                                  (4, 9, 4, 5, 7, 8)])
def test_schedule_plain_matches_jax_in_bf16(t, t_in, tp, c, o, k_pad):
    ops = _sched_operands(t + c, t, t_in, tp, c, o, k_pad)
    at = (0, 5, 6)
    want = j_fused._dcn_fused_schedule_jit(*_jax_ops(ops, at), block_p=tp,
                                           interpret=True)
    assert want.dtype == jnp.bfloat16
    _within_ulp(kf.dcn_fused_schedule(*_port_ops(ops, at)), want)


@pytest.mark.parametrize("s,p,c,o", [(40, 16, 6, 5), (64, 32, 16, 24)])
def test_tile_plain_matches_jax_in_bf16(s, p, c, o):
    rng = np.random.default_rng(s + c)
    ops = [rng.normal(size=(s, c)).astype(np.float32),
           rng.integers(-2, s + 3, size=(p, 9, 4)).astype(np.int32),
           rng.uniform(size=(p, 9, 4)).astype(np.float32),
           (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
           rng.normal(size=(o,)).astype(np.float32)]
    at = (0, 3, 4)
    want = j_fused._dcn_fused_tile_jit(*_jax_ops(ops, at), block_p=p,
                                       interpret=True)
    assert want.dtype == jnp.bfloat16
    _within_ulp(kf.dcn_fused_tile(*_port_ops(ops, at)), want)


@pytest.mark.parametrize("which", ["batch", "schedule", "tile"])
def test_mixed_operands_equal_the_widened_call(which):
    """x of one type under w and b of the other: the result in x's dtype,
    equal to the call on the widened operands rounded once to x's
    dtype."""
    if which == "batch":
        ops, kw, at = _fused_operands(5, 2, 4, 16, 8, 8, 4), dict(t_in=4), \
            (0, 6, 7)
        fn = kf.dcn_fused_batch
    elif which == "schedule":
        ops, kw, at = _sched_operands(6, 3, 5, 16, 8, 8, 4), {}, (0, 5, 6)
        fn = kf.dcn_fused_schedule
    else:
        rng = np.random.default_rng(7)
        ops = [rng.normal(size=(2, 40, 6)).astype(np.float32),
               rng.integers(0, 40, size=(2, 16, 9, 4)).astype(np.int32),
               rng.uniform(size=(2, 16, 9, 4)).astype(np.float32),
               rng.normal(size=(9, 6, 5)).astype(np.float32),
               rng.normal(size=(5,)).astype(np.float32)]
        kw, at, fn = {}, (0, 3, 4), kf.dcn_fused_tile
    base = _port_ops(ops, at)
    for x_dtype, wb_dtype in ((BF16, torch.float32), (torch.float32, BF16)):
        mixed = [a.to(x_dtype) if i == at[0] else
                 a.to(wb_dtype) if i in at else a
                 for i, a in enumerate(base)]
        widened = [a.float() if i in at else a for i, a in enumerate(mixed)]
        got = fn(*mixed, **kw)
        assert got.dtype == x_dtype
        assert torch.equal(got, fn(*widened, **kw).to(x_dtype))


# ---------------------------------------------------------------------------
# dcn_pipeline against the JAX oracle (tests/test_pipeline.py's bf16 cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,tile", [(16, 16, 8), (13, 13, 8)])
def test_pipeline_matches_the_jax_oracle_in_bf16(h, w, tile):
    rng = np.random.default_rng(h * 31 + w * 7 + tile)
    p = {k: _bf16(v) for k, v in _deform_np(rng, 6, 10).items()}
    x = _bf16(rng.normal(size=(2, h, w, 6)).astype(np.float32))
    want = np.asarray(jax.jit(j_deformable_conv2d)(
        jnp.asarray(x, jnp.bfloat16),
        JParams(*(jnp.asarray(p[k], jnp.bfloat16)
                  for k in ("w_off", "b_off", "w", "b")))), np.float32)
    tp = DeformableConvParams(*(torch.as_tensor(p[k]).to(BF16)
                                for k in ("w_off", "b_off", "w", "b")))
    for dispatch in ("batch_fused", "batched", "per_tile"):
        y = dcn_pipeline(torch.as_tensor(x).to(BF16), tp,
                         config=PipelineConfig(tile=tile, dispatch=dispatch))
        assert y.dtype == BF16 and y.shape == (2, h, w, 10)
        np.testing.assert_allclose(y.float().numpy(), want, rtol=5e-2,
                                   atol=5e-2)


# ---------------------------------------------------------------------------
# run_graph and the serving engine against the JAX executor
# ---------------------------------------------------------------------------

H, W = 12, 12
CFG = DcnNetConfig(name="vgg19", n_deform=2, num_classes=4)  # the head


@pytest.fixture(scope="module")
def net_case():
    """conv -> DCN -> DCN (one fused group: an interior DCN layer and a
    last one), bf16 params as a JAX tree, a head, and two bf16 images."""
    rng = np.random.default_rng(26)
    convs = [_conv_np(rng, 3, 8), _deform_np(rng, 8, 8, 2.0),
             _deform_np(rng, 8, 8, 2.0)]
    jparams = {
        "convs": [JParams(*(jnp.asarray(p[k], jnp.bfloat16) for k in
                            ("w_off", "b_off", "w", "b")))
                  if "w_off" in p else
                  {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
                  for p in convs],
        "fc": {"w": jnp.asarray(rng.normal(size=(8, 4)) * 0.3, jnp.bfloat16),
               "b": jnp.asarray(rng.normal(size=(4,)) * 0.1, jnp.bfloat16)}}

    def nodes(m):
        return (m.ConvNode(0, 3, 8, H, W), m.DeformNode(1, 8, 8, H, W),
                m.DeformNode(2, 8, 8, H, W))

    x = _bf16(rng.normal(size=(2, H, W, 3)).astype(np.float32))
    return (jparams,
            params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
            jg.NetGraph(nodes(jg), H, W, 3), tg.NetGraph(nodes(tg), H, W, 3),
            x)


@pytest.mark.parametrize("dispatch,backend", [("batched", "host"),
                                              ("per_tile", "host"),
                                              ("batch_fused", "device")])
def test_run_graph_matches_jax_in_bf16(net_case, dispatch, backend):
    jparams, tparams, jgraph, graph, x = net_case
    kw = dict(tile=4, dispatch=dispatch, schedule_backend=backend,
              use_schedule_cache=False)
    want_y, want_tr = j_run_graph(jparams["convs"], jgraph,
                                  jnp.asarray(x, jnp.bfloat16),
                                  config=JGraphConfig(**kw),
                                  return_trace=True)
    assert all(leaf.dtype == BF16 for leaf in tparams["convs"][1])
    y, trace = run_graph(tparams["convs"], graph,
                         torch.as_tensor(x).to(BF16),
                         config=GraphConfig(**kw), return_trace=True)
    assert y.dtype == BF16
    _within_ulp(apply_head(tparams, CFG, y),
                j_apply_head(jparams, None, want_y, False))
    assert _records(trace) == _records(want_tr)
    assert trace.kernel_dispatches == want_tr.kernel_dispatches
    assert trace.total_dram_bytes == want_tr.total_dram_bytes
    for g in trace.groups:               # 2 bytes a value: a 4x4 tile
        assert g.dtype_bytes == 2
        assert g.tile_bytes == 16 * g.layer_channels[0][0] * 2
    sim = simulate_network(network_sim_specs(trace),
                           boundary_bytes=trace.boundary_bytes)
    assert sim.total_dram_bytes == trace.total_dram_bytes


def test_infer_in_bf16_equals_run_graph():
    """``DcnServingEngine.infer`` keeps a bf16 batch's dtype and serves it
    through ``run_graph`` (batch_fused) and the head, bitwise."""
    cfg = DcnNetConfig(name="vgg19", n_deform=2, img_size=16,
                       width_mult=0.125, num_classes=4)
    params = init_dcn_net(0, cfg, dtype=BF16, device="cpu")
    gcfg = GraphConfig(tile=4, schedule_backend="device")
    eng = DcnServingEngine(params, cfg, graph=gcfg, slots=2, device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, 16, 16, 3)).astype(np.float32)).to(BF16)
    got = eng.infer(x)
    want = apply_head(params, cfg, run_graph(params["convs"],
                                             build_graph(cfg), x,
                                             config=gcfg))
    assert got.dtype == BF16 and torch.equal(got, want)


def test_sharded_run_graph_in_bf16_equals_unsharded(net_case):
    """``run_graph`` over a four-way CPU mesh (``runtime/shard.py``, #1
    once per shard) in bf16: bitwise the single-device run, ragged and
    empty shards included."""
    from repro_torch.launch.mesh import DeviceMesh

    _, tparams, _, graph, x = net_case
    xb = torch.as_tensor(np.concatenate([x, x[::-1]])).to(BF16)
    want = run_graph(tparams["convs"], graph, xb, config=GraphConfig(tile=4))
    got = run_graph(tparams["convs"], graph, xb,
                    config=GraphConfig(tile=4,
                                       mesh=DeviceMesh.on("cpu", data=4)),
                    shard_sizes=[2, 1, 0, 1])
    assert got.dtype == BF16 and torch.equal(got, want)


@pytest.mark.parametrize("backend", ["pallas", "pipeline", "graph"])
def test_model_backends_in_bf16(backend):
    """``dcn_net_apply`` on a bf16 network and bf16 images through each
    kernel backend: bf16 logits within the JAX package's bf16 bound
    (5e-2 of max|ref|) of the dense backend, which rounds the deformed
    patch to bf16 where the kernels keep it in float32."""
    cfg = DcnNetConfig(name="vgg19", n_deform=2, img_size=16,
                       width_mult=0.125, num_classes=4)
    params = init_dcn_net(1, cfg, dtype=BF16, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params["convs"] = [
        randomize_offset_conv(p, gen, 2.0 / p.w.shape[2])
        if hasattr(p, "w_off") else p for p in params["convs"]]
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, 16, 16, 3)).astype(np.float32)).to(BF16)
    want = dcn_net_apply(params, cfg, x, backend="dense")
    got = dcn_net_apply(params, cfg, x, backend=backend)
    assert got.dtype == want.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=5e-2 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# bf16 images through DcnServingEngine.submit / step against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_CFG = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
                  num_classes=4)


@pytest.fixture(scope="module")
def engine_case():
    """The JAX VGG19-2 network at 16x16, width 0.125, its offsets
    randomized, in bf16 (a JAX tree and the port's), and six bf16 images
    as an ``ml_dtypes`` array."""
    import ml_dtypes

    from repro.core.deform import randomize_offset_conv as j_randomize
    from repro.models.dcn_models import DcnNetConfig as JNetConfig
    from repro.models.dcn_models import init_dcn_net as j_init_dcn_net

    key = jax.random.PRNGKey(31)
    jparams = j_init_dcn_net(key, JNetConfig(**ENGINE_CFG))
    jparams["convs"] = [
        j_randomize(p, jax.random.fold_in(key, 100 + i), 2.0 / p.w.shape[2])
        if isinstance(p, JParams) else p
        for i, p in enumerate(jparams["convs"])]
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    xs = np.random.default_rng(31).normal(size=(6, 16, 16, 3)).astype(
        ml_dtypes.bfloat16)
    return jparams, tparams, xs


def _engines(case, **faults):
    from repro.models.dcn_models import DcnNetConfig as JNetConfig
    from repro.serving import DcnServingEngine as JEngine
    from repro.testing import FaultInjector as JInjector
    from repro_torch.testing import FaultInjector

    jparams, tparams, _ = case
    j_eng = JEngine(jparams, JNetConfig(**ENGINE_CFG),
                    graph=JGraphConfig(tile=4), slots=4,
                    faults=JInjector(**faults) if faults else None)
    t_eng = DcnServingEngine(
        tparams, DcnNetConfig(**ENGINE_CFG), graph=GraphConfig(tile=4),
        slots=4, device="cpu",
        faults=FaultInjector(**faults) if faults else None)
    return j_eng, t_eng


def _lockstep(j_eng, t_eng, requests):
    """Submit ``requests`` (JAX image batch, port image batch) to both
    engines and step them together; -> (JAX requests, port requests,
    [(JAX trace, port trace)] of each step that served images)."""
    j_reqs = [j_eng.submit(j) for j, _ in requests]
    t_reqs = [t_eng.submit(t) for _, t in requests]
    traces = []
    while not all(r.done for r in j_reqs + t_reqs):
        j_eng.step()
        t_eng.step()
        traces.append((j_eng.last_trace, t_eng.last_trace))
    return j_reqs, t_reqs, traces


def _trace_equals_jax_and_simulator(j_tr, t_tr):
    assert _records(t_tr) == _records(j_tr)
    assert t_tr.total_dram_bytes == j_tr.total_dram_bytes
    assert {g.dtype_bytes for g in t_tr.groups} == {2}
    sim = simulate_network(network_sim_specs(t_tr),
                           boundary_bytes=t_tr.boundary_bytes)
    assert sim.total_dram_bytes == t_tr.total_dram_bytes


def test_engine_step_serves_bf16_images_as_jax(engine_case):
    """bf16 images through ``submit`` / ``step()``: one request a torch
    bf16 tensor, the others ``ml_dtypes`` arrays, the JAX engine fed the
    same values. Logits come back host bf16 tensors within one bf16 ulp
    of the JAX engine's, every step's trace records and DRAM bytes equal
    JAX's at 2 B a value and the simulator's; float32 images fail their
    request in both engines, and the error names both dtypes."""
    _, tparams, xs = engine_case
    j_eng, t_eng = _engines(engine_case)
    requests = [(xs[:1], torch.as_tensor(xs[:1].astype(np.float32)).to(BF16)),
                (xs[1:4], xs[1:4]), (xs[4:], xs[4:])]
    j_reqs, t_reqs, traces = _lockstep(j_eng, t_eng, requests)
    for j, t in zip(j_reqs, t_reqs):
        assert not j.failed and not t.failed
        _within_ulp(t.result(), j.result())
    assert len(traces) == 2
    for j_tr, t_tr in traces:
        _trace_equals_jax_and_simulator(j_tr, t_tr)
    want = t_eng.infer(torch.as_tensor(xs.astype(np.float32)).to(BF16))
    got = torch.cat([t.result() for t in t_reqs])
    _within_ulp(got, want.float().numpy())

    x32 = xs[:2].astype(np.float32)
    j_reqs, t_reqs, _ = _lockstep(j_eng, t_eng, [(x32, x32)])
    assert j_reqs[0].failed and t_reqs[0].failed
    assert "torch.float32 images into an engine whose params are " \
        "torch.bfloat16" in str(t_reqs[0].error.__cause__)
    with pytest.raises(TypeError, match="float32 images"):
        t_eng.infer(torch.as_tensor(x32))


def test_degraded_step_serves_bf16_as_jax(engine_case):
    """An untagged dispatch fault degrades the step to per-image
    ``batched`` dispatch (#4's bf16 body on a card) in both engines; the
    bf16 requests still resolve, within one bf16 ulp of the JAX engine's
    and of a fault-free port engine's, with the same counters."""
    _, _, xs = engine_case
    plan = dict(kinds=("dispatch",), rate=1.0, max_fires=1,
                tag_image=False, seed=7)
    j_eng, t_eng = _engines(engine_case, **plan)
    j_reqs, t_reqs, traces = _lockstep(j_eng, t_eng,
                                       [(xs[:3], xs[:3]), (xs[3:4], xs[3:4])])
    assert t_eng.stats["degraded_steps"] == j_eng.stats["degraded_steps"] \
        == 1
    assert t_eng.last_trace.groups[0].dispatch == "batched"
    _, clean = _engines(engine_case)
    ref = clean.submit(xs[:4])
    clean.drain()
    got = torch.cat([t.result() for t in t_reqs])
    assert got.dtype == BF16
    _within_ulp(got, np.concatenate([j.result() for j in j_reqs]))
    _within_ulp(got, ref.result().float().numpy())
    for j_tr, t_tr in traces:
        _trace_equals_jax_and_simulator(j_tr, t_tr)
