"""float16 through the port's DCN path against the JAX package, on the CPU.

The JAX kernels widen any float type to float32 and return the operand's
type, and the JAX models take any dtype, so a JAX user serves VGG19-3
DCN-II in float16. The same numpy values, rounded to float16 in both
frameworks (the BLI coefficients stay float32, as the packers give them),
go through the JAX function and the port's. Tolerances, against max|ref|:

* the plain versions of #1, #4, #5 and #6 against the JAX kernels in
  interpret mode: one float16 ulp at the largest output (2**-10): both
  sides sum in float32 and round once, so only a sum that lands on the
  other side of a rounding boundary differs; a mixed call equal to the
  widened one;
* VGG19-3 DCN-II at 32x32, width 0.125, from JAX's ``init_dcn_net`` in
  float16 (its offset convs randomized) carried over by ``convert``:
  ``run_graph`` in each dispatch mode against JAX's ``run_graph``: trace
  records (the schedules and their loads) and DRAM bytes equal to JAX's
  and to the simulator's at 2 B a value, logits within ``NET_RTOL``;
  ``infer`` bitwise ``run_graph`` plus the head; ``submit`` / ``step()``
  on float16 host images giving numpy float16 logits within one ulp of
  ``infer``'s, float32 images failing their request with a ``TypeError``.

The dense convolutions follow XLA's float16 rule (``core.deform.conv2d``):
the sum in float32 rounded to float16, then b added in float16. The LM
path in float16 is ``tests/test_torch_fp16_lm.py``; the CUDA kernels'
float16 forms are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 18).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.deform import DeformableConvParams as JParams
from repro.kernels import dcn_bli as j_bli
from repro.kernels import dcn_fused as j_fused
from repro_torch.convert import params_from_jax
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels import dcn_fused as kf
from repro_torch.kernels.dcn_bli import bli_tile_matmul
from repro_torch.models.dcn_models import DcnNetConfig, apply_head
from repro_torch.runtime.fused_exec import (GraphConfig, network_sim_specs,
                                            run_graph)
from repro_torch.runtime.graph import build_graph
from repro_torch.serving import DcnServingEngine
from tests.test_torch_dcn_bf16 import _sched_operands
from tests.test_torch_dispatch import _records
from tests.test_torch_kernels import _fused_operands

F16 = torch.float16
F16_ULP = 2.0 ** -10      # one float16 ulp at the largest output
# VGG19-3's logits against JAX's: each layer's sums round once in both
# frameworks, in other orders, so a value within an ulp of a rounding
# boundary may round the other way, and 19 layers carry those flips on.
# The bf16 smoke-model bound (3e-2, tests/test_torch_bf16.py) scaled by
# bf16's ulp over float16's (8).
NET_RTOL = 3e-2 / 8


def _hold(got, want, tol=F16_ULP):
    """``got`` (torch) within ``tol`` * max|want| of ``want`` (JAX or
    numpy), of the same dtype, finite."""
    want_dtype = str(np.asarray(want).dtype if not hasattr(want, "dtype")
                     else want.dtype)
    assert str(got.dtype).removeprefix("torch.") == want_dtype
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.abs(g - w).max() <= tol * np.abs(w).max()


def _port_ops(ops, at):
    return [torch.as_tensor(a).to(F16) if i in at else torch.as_tensor(a)
            for i, a in enumerate(ops)]


def _jax_ops(ops, at):
    return [jnp.asarray(a, jnp.float16) if i in at else jnp.asarray(a)
            for i, a in enumerate(ops)]


# ---------------------------------------------------------------------------
# The plain kernels against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,t,tp,c,o,k_pad", [(2, 4, 16, 8, 8, 4),
                                              (3, 9, 4, 5, 7, 8)])
def test_batch_plain_matches_jax_in_fp16(n, t, tp, c, o, k_pad):
    ops = _fused_operands(n + t + 1, n, t, tp, c, o, k_pad)
    at = (0, 6, 7)                                  # x, w, b
    want = j_fused._dcn_fused_batch_jit(*_jax_ops(ops, at), t_in=t,
                                        block_p=tp, interpret=True)
    got = kf.dcn_fused_batch(*_port_ops(ops, at), t_in=t)
    _hold(got, want)
    assert kf.dcn_fused_batch.launches == 0         # the plain version


@pytest.mark.parametrize("t,t_in,tp,c,o,k_pad", [(3, 5, 16, 8, 8, 4),
                                                  (4, 9, 4, 5, 7, 8)])
def test_schedule_plain_matches_jax_in_fp16(t, t_in, tp, c, o, k_pad):
    ops = _sched_operands(t + c, t, t_in, tp, c, o, k_pad)
    at = (0, 5, 6)
    want = j_fused._dcn_fused_schedule_jit(*_jax_ops(ops, at), block_p=tp,
                                           interpret=True)
    _hold(kf.dcn_fused_schedule(*_port_ops(ops, at)), want)


@pytest.mark.parametrize("s,p,c,o", [(40, 16, 6, 5), (64, 32, 16, 24)])
def test_tile_plain_matches_jax_in_fp16(s, p, c, o):
    rng = np.random.default_rng(s + c)
    ops = [rng.normal(size=(s, c)).astype(np.float32),
           rng.integers(-2, s + 3, size=(p, 9, 4)).astype(np.int32),
           rng.uniform(size=(p, 9, 4)).astype(np.float32),
           (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
           rng.normal(size=(o,)).astype(np.float32)]
    at = (0, 3, 4)
    want = j_fused._dcn_fused_tile_jit(*_jax_ops(ops, at), block_p=p,
                                       interpret=True)
    _hold(kf.dcn_fused_tile(*_port_ops(ops, at)), want)


@pytest.mark.parametrize("n,s,p,c", [(1, 40, 64, 32), (3, 9, 16, 6)])
def test_bli_plain_matches_jax_in_fp16(n, s, p, c):
    rng = np.random.default_rng(n * s + c)
    x = rng.normal(size=(n, s, c)).astype(np.float16)
    idx = rng.integers(-3, s + 3, size=(n, p, 4)).astype(np.int32)
    cf = rng.uniform(size=(n, p, 4)).astype(np.float32)
    got = bli_tile_matmul(torch.as_tensor(x), torch.as_tensor(idx),
                          torch.as_tensor(cf))
    for i in range(n):
        want = j_bli.bli_tile_matmul(jnp.asarray(x[i]), jnp.asarray(idx[i]),
                                     jnp.asarray(cf[i]), block_p=min(p, 128),
                                     block_c=c, interpret=True)
        _hold(got[i], want)


def test_mixed_fp16_operands_equal_the_widened_call():
    """float16 x under float32 w and b (and the reverse): x's dtype, equal
    to the widened call rounded once, as the bf16 mixed call."""
    ops = _fused_operands(5, 2, 4, 16, 8, 8, 4)
    base = _port_ops(ops, (0, 6, 7))
    for x_dtype, wb_dtype in ((F16, torch.float32), (torch.float32, F16)):
        mixed = [a.to(x_dtype) if i == 0 else a.to(wb_dtype) if i in (6, 7)
                 else a for i, a in enumerate(base)]
        widened = [a.float() if i in (0, 6, 7) else a
                   for i, a in enumerate(mixed)]
        got = kf.dcn_fused_batch(*mixed, t_in=4)
        assert got.dtype == x_dtype
        assert torch.equal(got, kf.dcn_fused_batch(*widened,
                                                   t_in=4).to(x_dtype))


# ---------------------------------------------------------------------------
# VGG19-3 DCN-II in float16 against the JAX executor
# ---------------------------------------------------------------------------

VGG = dict(name="vgg19", n_deform=3, img_size=32, width_mult=0.125,
           num_classes=4)


@pytest.fixture(scope="module")
def vgg_case():
    """JAX's VGG19-3 DCN-II (32x32, width 0.125) from ``init_dcn_net`` in
    float16, its offset convs randomized, the port's params by
    ``convert``, four float16 images, and JAX's ``run_graph`` logits and
    trace on them (batched dispatch: its compiles are the cheapest)."""
    from repro.core.deform import randomize_offset_conv as j_randomize
    from repro.models.dcn_models import DcnNetConfig as JNetConfig
    from repro.models.dcn_models import _apply_head as j_apply_head
    from repro.models.dcn_models import init_dcn_net as j_init_dcn_net
    from repro.runtime import GraphConfig as JGraphConfig
    from repro.runtime import run_graph as j_run_graph
    from repro.runtime.graph import build_graph as j_build_graph

    key = jax.random.PRNGKey(34)
    jcfg = JNetConfig(**VGG)
    # One compile for the whole tree (eager, each leaf compiles its own).
    jparams = jax.jit(lambda k: j_init_dcn_net(k, jcfg, jnp.float16))(key)
    jparams["convs"] = [
        j_randomize(p, jax.random.fold_in(key, 100 + i), 2.0 / p.w.shape[2])
        if isinstance(p, JParams) else p
        for i, p in enumerate(jparams["convs"])]
    jparams = jax.tree.map(lambda a: a.astype(jnp.float16), jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    x = np.random.default_rng(34).normal(size=(4, 32, 32, 3)).astype(
        np.float16)
    kw = dict(tile=4, dispatch="batched", schedule_backend="host",
              use_schedule_cache=False)
    jy, jtr = j_run_graph(jparams["convs"], j_build_graph(jcfg),
                          jnp.asarray(x), config=JGraphConfig(**kw),
                          return_trace=True)
    return tparams, x, kw, j_apply_head(jparams, None, jy, False), jtr


def _graph_run(case, dispatch, backend):
    tparams, x, kw, _, _ = case
    cfg = GraphConfig(**{**kw, "dispatch": dispatch,
                         "schedule_backend": backend})
    y, trace = run_graph(tparams["convs"], build_graph(DcnNetConfig(**VGG)),
                         torch.as_tensor(x), config=cfg, return_trace=True)
    return apply_head(tparams, DcnNetConfig(**VGG), y), trace


@pytest.mark.parametrize("dispatch,backend", [("batch_fused", "device"),
                                              ("batched", "host"),
                                              ("per_tile", "host")])
def test_vgg19_run_graph_matches_jax_in_fp16(vgg_case, dispatch, backend):
    """Each dispatch mode against JAX's batched run: the same schedules
    and loads (records; batched's equal whole), the same DRAM bytes at 2 B
    a value, logits within ``NET_RTOL``."""
    dcn = next(p for p in vgg_case[0]["convs"] if hasattr(p, "w_off"))
    assert all(t.dtype == F16 for t in dcn)
    logits, trace = _graph_run(vgg_case, dispatch, backend)
    _hold(logits, vgg_case[3], NET_RTOL)
    j_trace = vgg_case[4]
    # A group's first record names its dispatch mode and launch count;
    # the rest are its tiles' schedules and loads.
    assert [g[1:] for g in _records(trace)] == \
        [g[1:] for g in _records(j_trace)]
    if dispatch == "batched":
        assert _records(trace) == _records(j_trace)
    assert trace.total_dram_bytes == j_trace.total_dram_bytes
    assert {g.dtype_bytes for g in trace.groups} == {2}
    sim = simulate_network(network_sim_specs(trace),
                           boundary_bytes=trace.boundary_bytes)
    assert sim.total_dram_bytes == trace.total_dram_bytes


def test_vgg19_infer_and_step_serve_fp16(vgg_case):
    """``infer`` on float16 images: bitwise ``run_graph`` plus the head.
    ``submit`` / ``step()`` on float16 host images: numpy float16 logits
    (``np.asarray`` of JAX's) within one ulp of ``infer``'s, traces at 2 B
    a value equal to the simulator; float32 images fail their request,
    the cause a ``TypeError`` naming both dtypes."""
    tparams, x, kw, _, _ = vgg_case
    cfg = DcnNetConfig(**VGG)
    eng = DcnServingEngine(tparams, cfg, graph=GraphConfig(tile=4),
                           slots=4, device="cpu")
    want = eng.infer(torch.as_tensor(x))
    assert want.dtype == F16
    assert torch.equal(want, _graph_run(vgg_case, "batch_fused",
                                        "device")[0])
    reqs = [eng.submit(x[:1]), eng.submit(x[1:3]), eng.submit(x[3:])]
    traces = []
    while not all(r.done for r in reqs):
        eng.step()
        traces.append(eng.last_trace)
    got = [r.result() for r in reqs]
    assert all(isinstance(g, np.ndarray) and g.dtype == np.float16
               for g in got)
    _hold(torch.as_tensor(np.concatenate(got)), want.numpy())
    for tr in traces:
        assert {g.dtype_bytes for g in tr.groups} == {2}
        sim = simulate_network(network_sim_specs(tr),
                               boundary_bytes=tr.boundary_bytes)
        assert sim.total_dram_bytes == tr.total_dram_bytes
    bad = eng.submit(x[:2].astype(np.float32))
    eng.drain()
    assert bad.failed
    assert isinstance(bad.error.__cause__, TypeError)
    assert "torch.float32 images into an engine whose params are " \
        "torch.float16" in str(bad.error.__cause__)


