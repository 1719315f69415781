"""The per-image half of the port against the JAX package: packing,
``kernels.ops``, the ``batched``/``per_tile`` graph executor, the
``dcn_pipeline`` tile pipeline in all three dispatch modes and the
``"pallas"``/``"pipeline"`` model backends, on the same numpy inputs.

Held to: kernels' operands equal (packing is integer work and the same
float formulas), outputs within 1e-4 * max|ref| for executor and model
runs (float32 sums in another order, through several layers) and 1e-5
for single ops, identical trace records and ``layer_stats``, equal
dispatch counts, and executed DRAM == the simulator.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.deform import DeformableConvParams as JParams
from repro.core.tiles import TileGrid as JGrid
from repro.kernels import ops as j_ops
from repro.models.dcn_models import DcnNetConfig as JNetConfig
from repro.models.dcn_models import dcn_net_apply as j_net_apply
from repro.runtime import GraphConfig as JGraphConfig
from repro.runtime import PipelineConfig as JPipelineConfig
from repro.runtime import dcn_pipeline as j_pipeline
from repro.runtime import graph as jg
from repro.runtime import packing as j_pack
from repro.runtime import run_graph as j_run_graph
from repro_torch.core.deform import DeformableConvParams, bilinear_sample
from repro_torch.core.simulator import simulate_network
from repro_torch.core.tiles import TileGrid
from repro_torch.kernels import ops
from repro_torch.models.dcn_models import DcnNetConfig, dcn_net_apply
from repro_torch.runtime import graph as tg
from repro_torch.runtime import packing
from repro_torch.runtime.fused_exec import (GraphConfig, network_sim_specs,
                                            run_graph, run_graph_dense)
from repro_torch.runtime.pipeline import PipelineConfig, dcn_pipeline


def _coords(seed, h, w, spread=2.0):
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                    -1)[:, :, None, :]
    c = base + rng.normal(scale=spread, size=(h, w, 9, 2))
    return np.clip(c, 0, [h - 1, w - 1]).astype(np.float32)


def _deform_np(rng, c_in, c_out, offset_scale=0.5):
    return dict(w_off=rng.normal(size=(3, 3, c_in, 18)).astype(np.float32)
                * np.float32(offset_scale / c_in),
                b_off=(rng.normal(size=(18,)) * 0.5).astype(np.float32),
                w=(rng.normal(size=(3, 3, c_in, c_out))
                   / np.sqrt(9 * c_in)).astype(np.float32),
                b=(rng.normal(size=(c_out,)) * 0.1).astype(np.float32))


def _conv_np(rng, c_in, c_out):
    return dict(w=(rng.normal(size=(3, 3, c_in, c_out)) * 0.2)
                .astype(np.float32),
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


def _records(trace):
    return [[(g.image, g.group, g.kernel_dispatches, g.dispatch)]
            + [dataclasses.astuple(r) for r in g.records]
            + [dataclasses.astuple(s) for s in g.layer_stats]
            for g in trace.groups]


@pytest.fixture(scope="module")
def net_case():
    """conv -> DCN -> DCN -> conv in one fused group (an interior DCN
    layer and a last one), a pool, then conv -> DCN; 13x11 does not
    divide by the tiles."""
    h, w = 13, 11
    rng = np.random.default_rng(7)
    convs = [_conv_np(rng, 3, 6), _deform_np(rng, 6, 6),
             _deform_np(rng, 6, 6), _conv_np(rng, 6, 8), _conv_np(rng, 8, 8),
             _deform_np(rng, 8, 5)]
    h2, w2 = (h - 2) // 2 + 1, (w - 2) // 2 + 1

    def nodes(m):
        return (m.ConvNode(0, 3, 6, h, w), m.DeformNode(1, 6, 6, h, w),
                m.DeformNode(2, 6, 6, h, w), m.ConvNode(3, 6, 8, h, w),
                m.PoolNode(h, w, 8), m.ConvNode(4, 8, 8, h2, w2),
                m.DeformNode(5, 8, 5, h2, w2))

    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    return (convs, jg.NetGraph(nodes(jg), h, w, 3),
            tg.NetGraph(nodes(tg), h, w, 3), x)


JAX_RUNS: dict = {}


def _jax_run(net_case, dispatch, backend, tile, inter):
    key = (dispatch, backend, tile, inter)
    if key not in JAX_RUNS:
        convs, jgraph, _, x = net_case
        JAX_RUNS[key] = j_run_graph(
            [_to_jax(p) for p in convs], jgraph, jnp.asarray(x),
            config=JGraphConfig(tile=tile, dispatch=dispatch,
                                schedule_backend=backend,
                                inter_buffer_tiles=inter,
                                use_schedule_cache=False),
            return_trace=True)
    return JAX_RUNS[key]


class TestPacking:
    def test_neighbour_tables_and_tile_packing_equal_jax(self):
        co = _coords(3, 13, 11)
        jgrid, tgrid = JGrid(13, 11, 4, 3), TileGrid(13, 11, 4, 3)
        j_nb = j_pack.build_neighbour_tables(jnp.asarray(co), jgrid)
        t_nb = packing.build_neighbour_tables(torch.as_tensor(co), tgrid)
        for a, b in zip(t_nb, j_nb):
            np.testing.assert_array_equal(a, np.asarray(b))
        deps = [5, 0, 1, 4, 8]
        for p_pad in (12, 16):
            for a, b in zip(packing.pack_output_tile(t_nb, tgrid, 4, deps,
                                                     p_pad),
                            j_pack.pack_output_tile(j_nb, jgrid, 4, deps,
                                                    p_pad)):
                np.testing.assert_array_equal(a, b)
        out_tiles = [4, 11, 0]
        dep_lists = [deps, [10, 11, 7], []]          # an empty dep list
        for a, b in zip(
                packing.pack_schedule_tiles(t_nb, tgrid, out_tiles,
                                            dep_lists, 16, 8),
                j_pack.pack_schedule_tiles(j_nb, jgrid, out_tiles,
                                           dep_lists, 16, 8)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="exceed k_pad"):
            packing.pack_schedule_tiles(t_nb, tgrid, [4], [deps], 16, 4)


class TestOps:
    def test_coords_to_idx_coeff_equal_jax(self):
        co = _coords(4, 9, 14)
        got = ops.coords_to_idx_coeff(torch.as_tensor(co), 9, 14)
        want = j_ops.coords_to_idx_coeff(jnp.asarray(co), 9, 14)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bli_pallas_matches_jax_and_reference(self, dtype):
        """float32 within 1e-5 of JAX and 1e-6 of ``bilinear_sample``;
        bfloat16 x (float32 coordinates) within one bf16 ulp at the
        largest output of JAX (2**-7 * max|ref|) and within half of one of
        ``bilinear_sample`` over the same bf16 values in float32 (the
        port rounds its float32 sum once)."""
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 9, 14, 5)).astype(np.float32)
        co = np.stack([_coords(6, 9, 14), _coords(7, 9, 14)])
        xt = torch.as_tensor(x).to(getattr(torch, dtype))
        got = ops.bli_pallas(xt, torch.as_tensor(co))
        assert got.dtype == xt.dtype
        got = got.float().numpy()
        want = np.asarray(j_ops.bli_pallas(
            jnp.asarray(x, dtype=getattr(jnp, dtype)), jnp.asarray(co),
            interpret=True)).astype(np.float32)
        ref = bilinear_sample(xt.float(), torch.as_tensor(co)).numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        else:
            assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max()
            assert np.abs(got - ref).max() <= 2**-8 * np.abs(ref).max()

    def test_deformable_conv2d_pallas_matches_jax(self):
        rng = np.random.default_rng(8)
        p = _deform_np(rng, 6, 7, offset_scale=2.0)
        x = rng.normal(size=(2, 12, 10, 6)).astype(np.float32)
        got = ops.deformable_conv2d_pallas(torch.as_tensor(x), _to_port(p))
        want = np.asarray(j_ops.deformable_conv2d_pallas(
            jnp.asarray(x), _to_jax(p), interpret=True))
        assert got.shape == want.shape == (2, 12, 10, 7)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dispatch,backend,tile,inter", [
    ("batched", "host", 4, None),
    ("batched", "device", 4, None),
    ("batched", "device", (3, 5), None),     # rectangular tiles
    ("per_tile", "host", 4, None),
    ("per_tile", "device", (3, 5), None),
    ("per_tile", "host", 4, 6),     # a 6-tile buffer forces recomputes
    ("batch_fused", "device", 4, None),    # one schedule launch a group
])
def test_executor_matches_jax(net_case, dispatch, backend, tile, inter):
    convs, _, graph, x = net_case
    want_y, want_tr = _jax_run(net_case, dispatch, backend, tile, inter)
    y, trace = run_graph(
        [_to_port(p) for p in convs], graph, torch.as_tensor(x),
        config=GraphConfig(tile=tile, dispatch=dispatch,
                           schedule_backend=backend,
                           inter_buffer_tiles=inter,
                           use_schedule_cache=False),
        return_trace=True)
    want = np.asarray(want_y)
    assert y.shape == want.shape
    assert np.abs(y.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    dense = run_graph_dense([_to_port(p) for p in convs], graph,
                            torch.as_tensor(x))
    assert (y - dense).abs().max() <= 1e-4 * dense.abs().max()
    assert _records(trace) == _records(want_tr)
    assert trace.kernel_dispatches == want_tr.kernel_dispatches
    assert trace.total_dram_bytes == want_tr.total_dram_bytes
    sim = simulate_network(network_sim_specs(trace),
                           boundary_bytes=trace.boundary_bytes)
    assert sim.total_dram_bytes == trace.total_dram_bytes
    if inter is not None:
        assert trace.total_recomputes > 0


@pytest.mark.parametrize("dispatch", ["batched", "per_tile", "batch_fused"])
def test_pipeline_matches_jax(dispatch):
    rng = np.random.default_rng(9)
    p = _deform_np(rng, 5, 7, offset_scale=2.0)
    x = rng.normal(size=(2, 13, 10, 5)).astype(np.float32)
    for backend in ("host", "device"):
        kw = dict(tile=(4, 3), dispatch=dispatch, schedule_backend=backend,
                  buffer_tiles=5, use_schedule_cache=False)
        want_y, want_tr = j_pipeline(jnp.asarray(x), _to_jax(p),
                                     config=JPipelineConfig(**kw),
                                     return_trace=True)
        y, trace = dcn_pipeline(torch.as_tensor(x), _to_port(p),
                                config=PipelineConfig(**kw),
                                return_trace=True)
        want = np.asarray(want_y)
        assert np.abs(y.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        assert ([[dataclasses.astuple(r) for r in im.records]
                 for im in trace.images]
                == [[dataclasses.astuple(r) for r in im.records]
                    for im in want_tr.images])
        assert ([(im.dispatch, im.kernel_dispatches, im.batch_rows)
                 for im in trace.images]
                == [(im.dispatch, im.kernel_dispatches, im.batch_rows)
                    for im in want_tr.images])
        assert trace.kernel_dispatches == want_tr.kernel_dispatches
        assert trace.packed_bytes == want_tr.packed_bytes
        assert trace.fifo_loads() == want_tr.fifo_loads()


def test_model_backends_match_jax():
    cfg = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
               num_classes=4)
    rng = np.random.default_rng(10)
    plan = DcnNetConfig(**cfg).stage_plan()
    convs = [_deform_np(rng, ci, co, offset_scale=2.0) if d
             else _conv_np(rng, ci, co) for ci, co, d in plan]
    head = {"w": (rng.normal(size=(plan[-1][1], 4)) * 0.02)
            .astype(np.float32), "b": np.zeros((4,), np.float32)}
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jparams = {"convs": [_to_jax(p) for p in convs],
               "fc": {k: jnp.asarray(v) for k, v in head.items()}}
    tparams = {"convs": [_to_port(p) for p in convs],
               "fc": {k: torch.as_tensor(v) for k, v in head.items()}}
    want = np.asarray(j_net_apply(jparams, JNetConfig(**cfg),
                                  jnp.asarray(x), backend="xla"))
    for backend in ("pallas", "pipeline"):
        got = dcn_net_apply(tparams, DcnNetConfig(**cfg),
                            torch.as_tensor(x), backend=backend)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="unknown backend"):
        dcn_net_apply(tparams, DcnNetConfig(**cfg), torch.as_tensor(x),
                      backend="xla")


def test_config_validation():
    with pytest.raises(ValueError, match="watchdog_s"):
        GraphConfig(watchdog_s=0.0)
    with pytest.raises(ValueError, match="watchdog_s"):
        PipelineConfig(watchdog_s=-1.0)
    with pytest.raises(ValueError, match="unknown dispatch"):
        PipelineConfig(dispatch="bogus")
    with pytest.raises(ValueError, match="exceeds"):
        dcn_pipeline(torch.zeros((1, 4, 4, 2)),
                     _to_port(_deform_np(np.random.default_rng(0), 2, 2)),
                     tile=8)
