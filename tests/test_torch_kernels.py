"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain torch version; these tests feed it
the same numpy operands as the JAX kernel (run in interpret mode, as the
JAX package's own tests run it) and require:

* the batch-fused BLI(+)conv within 1e-5 (float32 sums in another order);
* the TDT and the greedy Algorithm-1 kernels bit-exact, including the
  empty TDT, ties, ragged and rectangular grids and a 784-tile table;
* the dispatch glue (stable argsorts) equal.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.tiles import TileGrid as JGrid
from repro.core.tiles import tdt_standard_conv as j_tdt_standard_conv
from repro.kernels import dcn_fused as j_fused
from repro.kernels import dcn_schedule as j_sched
from repro_torch.core.tiles import TileGrid, tdt_standard_conv
from repro_torch.kernels.dcn_fused import (dcn_fused_batch,
                                           dcn_fused_batch_plain)
from repro_torch.kernels.dcn_schedule import (dispatch_arrays_from_klass,
                                              greedy_plain,
                                              greedy_schedule_arrays,
                                              tdt_dispatch_arrays,
                                              tdt_from_coords_device,
                                              tdt_plain)


def _fused_operands(seed, n, t, tp, c, o, k_pad, kk=9, p_pad=None):
    """Operands meeting the kernel's contract: per row, distinct deps of
    one image in load order; some ragged padding rows (dep_cnt 0)."""
    rng = np.random.default_rng(seed)
    p = p_pad or tp
    g = n * t
    x = rng.normal(size=(n * t, tp, c)).astype(np.float32)
    row = rng.permutation(g).astype(np.int32)
    cnt = rng.integers(0, min(k_pad, t) + 1, size=g).astype(np.int32)
    cnt[0] = min(k_pad, t)
    dep = np.zeros((g, k_pad), np.int32)
    for gi in range(g):
        img = row[gi] // t
        d = rng.permutation(t)
        dep[gi] = img * t + np.resize(d, k_pad)
    idx = rng.integers(0, t * tp, size=(n * t, p, kk, 4)).astype(np.int32)
    coeff = rng.uniform(size=(n * t, p, kk, 4)).astype(np.float32)
    w = (rng.normal(size=(kk, c, o)) / np.sqrt(kk * c)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, row, dep, cnt, idx, coeff, w, b


def _jax_fused(ops, t_in, p):
    x, row, dep, cnt, idx, coeff, w, b = ops
    return np.asarray(j_fused._dcn_fused_batch_jit(
        *(jnp.asarray(a) for a in ops), t_in=t_in, block_p=p,
        interpret=True))


class TestFusedBatch:
    @pytest.mark.parametrize("n,t,tp,c,o,k_pad", [
        (2, 4, 16, 8, 8, 4),          # every slot of a 2x2 grid
        (3, 9, 4, 5, 7, 8),           # ragged widths, k_pad > deps
        (1, 6, 8, 16, 12, 2),         # k_pad below T: truncated tables
    ])
    def test_plain_matches_jax(self, n, t, tp, c, o, k_pad):
        ops = _fused_operands(n + t, n, t, tp, c, o, k_pad)
        want = _jax_fused(ops, t, tp)
        got = dcn_fused_batch(*(torch.as_tensor(a) for a in ops), t_in=t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_padding_rows_write_bias(self):
        ops = list(_fused_operands(7, 2, 4, 16, 8, 8, 4))
        ops[3] = np.zeros_like(ops[3])                 # every row padding
        got = dcn_fused_batch_plain(*(torch.as_tensor(a) for a in ops),
                                    t_in=4)
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(ops[7], got.shape))

    def test_pipeline_operands_match_jax(self, batch_fused_case):
        """Operands the JAX batch-fused prepass really produced."""
        ops, t_in, p = batch_fused_case
        want = _jax_fused(ops, t_in, p)
        got = dcn_fused_batch(*(torch.as_tensor(np.array(a))
                                for a in ops), t_in=t_in)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_rejects_bad_operands(self):
        ops = [torch.as_tensor(a) for a in _fused_operands(1, 1, 4, 16, 8,
                                                           8, 4)]
        bad = list(ops)
        bad[0] = ops[0].double()
        with pytest.raises(ValueError, match="float32"):
            dcn_fused_batch(*bad, t_in=4)
        bad = list(ops)
        bad[4] = ops[4].transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            dcn_fused_batch(*bad, t_in=4)
        with pytest.raises(ValueError, match="multiple"):
            dcn_fused_batch(*ops, t_in=3)


@pytest.fixture(scope="module")
def batch_fused_case():
    """One DCN layer's batch-fused operands from the JAX packing path."""
    from repro.core.scheduler import DeviceSchedule, schedule_tiles
    from repro.core.tiles import tdt_from_coords
    from repro.kernels.dcn_schedule import tdt_dispatch_arrays as j_tda
    from repro.runtime.packing import (pack_batch_schedules,
                                       pack_plane_operands)

    rng = np.random.default_rng(3)
    n, h, c, o, tile = 3, 11, 6, 5, 4
    grid = JGrid(h, h, tile, tile)
    t = grid.num_tiles
    base = np.stack(np.meshgrid(np.arange(h), np.arange(h), indexing="ij"),
                    -1)[:, :, None, :].astype(np.float32)
    coords = np.clip(base + rng.normal(scale=2.0, size=(n, h, h, 9, 2)),
                     0, h - 1).astype(np.float32)
    scheds = []
    for i in range(n):
        b = np.asarray(tdt_from_coords(jnp.asarray(coords[i]), grid, grid))
        ds = DeviceSchedule.from_host(schedule_tiles(b, 3), t)
        dep, cnt = j_tda(jnp.asarray(b), 16)
        oid = jnp.asarray(ds.oid)
        sel = jnp.maximum(oid, 0)
        scheds.append(DeviceSchedule(oid, dep[sel],
                                     jnp.where(oid >= 0, cnt[sel], 0),
                                     jnp.zeros_like(oid)))
    bd = pack_batch_schedules(scheds, t, t)
    idx, coeff = jax.vmap(lambda cc: pack_plane_operands(cc, grid, 16))(
        jnp.asarray(coords))
    x = rng.normal(size=(n * t, 16, c)).astype(np.float32)
    w = rng.normal(size=(9, c, o)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    ops = (x, np.asarray(bd.row_id), np.asarray(bd.dep_glb),
           np.asarray(bd.dep_cnt), np.asarray(idx).reshape(n * t, 16, 9, 4),
           np.asarray(coeff).reshape(n * t, 16, 9, 4), w, b)
    return ops, t, 16


def _coords(seed, h, w, kk=9, spread=2.0, lo=0.0):
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                    -1)[:, :, None, :]
    c = base + rng.normal(scale=spread, size=(h, w, kk, 2))
    return np.clip(c, lo, [h - 1, w - 1]).astype(np.float32)


class TestTdt:
    @pytest.mark.parametrize("h,w,th,tw,lo", [
        (16, 16, 4, 4, 0.0),          # square grid
        (13, 13, 4, 4, 0.0),          # ragged edge tiles
        (14, 10, 4, 3, 0.0),          # rectangular tiles and plane
        (9, 9, 9, 9, 0.0),            # one tile
        (12, 12, 4, 4, -3.0),         # out-of-range coordinates clip
    ])
    def test_bit_exact_vs_jax(self, h, w, th, tw, lo):
        co = _coords(h * w + th, h, w, lo=lo)
        if lo < 0:
            co = co + np.float32(lo)  # push samples below the plane
        jg, tg = JGrid(h, w, th, tw), TileGrid(h, w, th, tw)
        want = np.asarray(j_sched.tdt_from_coords_device(
            jnp.asarray(co), jg, jg, interpret=True))
        got = tdt_from_coords_device(torch.as_tensor(co), tg, tg)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)

    def test_in_grid_differs_from_out_grid(self):
        co = _coords(5, 12, 12)
        jin, jout = JGrid(12, 12, 6, 4), JGrid(12, 12, 4, 4)
        tin, tout = TileGrid(12, 12, 6, 4), TileGrid(12, 12, 4, 4)
        want = np.asarray(j_sched.tdt_from_coords_device(
            jnp.asarray(co), jin, jout, interpret=True))
        np.testing.assert_array_equal(
            tdt_plain(torch.as_tensor(co), tin, tout).numpy(), want)


def _jax_greedy(b, m):
    return tuple(np.asarray(a) for a in j_sched.greedy_schedule_arrays(
        jnp.asarray(b), m, interpret=True))


def _tables():
    rng = np.random.default_rng(11)
    g = JGrid(13, 13, 4, 4)
    return {
        "empty": np.zeros((4, 4), bool),
        "single": np.ones((1, 1), bool),
        "ties": np.ones((6, 6), bool),
        "random": rng.random((12, 12)) < 0.35,
        "rect": rng.random((9, 20)) < 0.3,
        "sparse_rows": (rng.random((10, 7)) < 0.2)
        & (np.arange(10)[:, None] % 3 != 0),
        "ragged_conv": j_tdt_standard_conv(g, g, 3),
    }


class TestGreedy:
    @pytest.mark.parametrize("name", sorted(_tables()))
    @pytest.mark.parametrize("m", [1, 3, 64])
    def test_bit_exact_vs_jax(self, name, m):
        b = _tables()[name]
        want = _jax_greedy(b, m)
        got = greedy_schedule_arrays(torch.as_tensor(b), m)
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.int32
            np.testing.assert_array_equal(g_.numpy(), w_)

    def test_784_tile_standard_conv_table(self):
        """The size the 224x224 conv groups give the scheduler."""
        grid = TileGrid(224, 224, 8, 8)
        b = tdt_standard_conv(grid, grid, 3)
        want = _jax_greedy(b, 784)
        got = greedy_plain(torch.as_tensor(b), 784)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), w_)

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError, match="capacity"):
            greedy_schedule_arrays(torch.ones((2, 2), dtype=torch.bool), 0)
        with pytest.raises(ValueError, match="2-D"):
            greedy_schedule_arrays(torch.ones((2,), dtype=torch.bool), 1)


class TestGlue:
    @pytest.mark.parametrize("k_pad", [4, 8, 16])
    def test_dispatch_arrays_from_klass(self, k_pad):
        rng = np.random.default_rng(k_pad)
        klass = rng.integers(0, 4, size=(9, 8)).astype(np.int32)
        klass[:, 4:] = 3                          # at most 4 deps per row
        oid = np.arange(9, dtype=np.int32)[:, None]
        oid[6:] = -1
        want = j_sched.dispatch_arrays_from_klass(
            jnp.asarray(oid), jnp.asarray(klass), k_pad)
        got = dispatch_arrays_from_klass(torch.as_tensor(oid),
                                         torch.as_tensor(klass), k_pad)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))

    @pytest.mark.parametrize("k_pad", [4, 16])
    def test_tdt_dispatch_arrays(self, k_pad):
        b = np.random.default_rng(k_pad).random((7, 9)) < 0.3
        b[:, 4:] = False
        want = j_sched.tdt_dispatch_arrays(jnp.asarray(b), k_pad)
        got = tdt_dispatch_arrays(torch.as_tensor(b), k_pad)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
