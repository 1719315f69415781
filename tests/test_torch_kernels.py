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


# ---------------------------------------------------------------------------
# Kernels #4 (schedule), #5 (tile) and #6 (BLI): plain versions vs JAX
# ---------------------------------------------------------------------------

from repro.kernels import dcn_bli as j_bli  # noqa: E402
from repro_torch.kernels.dcn_bli import bli_tile_matmul  # noqa: E402
from repro_torch.kernels.dcn_fused import (dcn_fused_schedule,  # noqa: E402
                                           dcn_fused_tile)


def _sched_case(seed, t, t_in, tp, c, o, k_pad, p=None, lo=0, hi=None):
    """Schedule operands: per row distinct deps in [0, T_in); dep_cnt in
    [1, k_pad] with the last row 0; addresses drawn from [lo, hi) — by
    default every slot, padding slots included."""
    rng = np.random.default_rng(seed)
    p = p or tp
    hi = k_pad * tp if hi is None else hi
    dep = np.stack([np.resize(rng.permutation(t_in), k_pad)
                    for _ in range(t)]).astype(np.int32)
    cnt = rng.integers(1, k_pad + 1, size=t).astype(np.int32)
    cnt[-1] = 0
    return (rng.normal(size=(t_in, tp, c)).astype(np.float32), dep, cnt,
            rng.integers(lo, hi, size=(t, p, 9, 4)).astype(np.int32),
            rng.uniform(size=(t, p, 9, 4)).astype(np.float32),
            (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
            rng.normal(size=(o,)).astype(np.float32))


def _jax_sched(ops, block_p=128):
    return np.asarray(j_fused._dcn_fused_schedule_jit(
        *(jnp.asarray(a) for a in ops), block_p=block_p, interpret=True))


class TestFusedSchedule:
    @pytest.mark.parametrize("t,t_in,tp,c,o,k_pad,p", [
        (4, 4, 16, 8, 8, 4, None),    # a 2x2 grid, every slot live
        (5, 9, 15, 5, 7, 8, None),    # rectangular 3x5 tiles, k_pad > T_in
        (3, 6, 12, 6, 4, 4, 16),      # p_pad > tp: padded pixel rows
    ])
    def test_plain_matches_jax(self, t, t_in, tp, c, o, k_pad, p):
        ops = _sched_case(t + tp, t, t_in, tp, c, o, k_pad, p)
        got = dcn_fused_schedule(*(torch.as_tensor(a) for a in ops))
        np.testing.assert_allclose(got.numpy(), _jax_sched(ops),
                                   rtol=1e-5, atol=1e-5)
        # dep_cnt = 0 row (the last): bias only, addresses ignored.
        np.testing.assert_array_equal(got[-1].numpy(),
                                      np.broadcast_to(ops[-1], got[-1].shape))

    def test_out_of_range_addresses_contribute_zero(self):
        ops = _sched_case(9, 3, 5, 16, 6, 6, 4, lo=-16, hi=6 * 16)
        got = dcn_fused_schedule(*(torch.as_tensor(a) for a in ops))
        np.testing.assert_allclose(got.numpy(), _jax_sched(ops),
                                   rtol=1e-5, atol=1e-5)

    def test_packer_operands_match_jax(self, sched_case):
        ops = sched_case
        got = dcn_fused_schedule(*(torch.as_tensor(a) for a in ops))
        np.testing.assert_allclose(got.numpy(), _jax_sched(ops),
                                   rtol=1e-5, atol=1e-5)

    def test_empty_schedule(self):
        ops = [torch.as_tensor(a) for a in _sched_case(1, 2, 4, 16, 8, 8, 4)]
        for i in (1, 2, 3, 4):
            ops[i] = ops[i][:0]
        got = dcn_fused_schedule(*ops)
        assert got.shape == (0, 16, 8)
        want = _jax_sched([a.numpy() for a in ops])
        assert want.shape == got.shape

    def test_rejects_bad_operands(self):
        ops = [torch.as_tensor(a) for a in _sched_case(1, 2, 4, 12, 8, 8, 4)]
        with pytest.raises(ValueError, match="must tile"):
            dcn_fused_schedule(*ops, block_p=8)
        with pytest.raises(ValueError, match="must tile"):
            _jax_sched([a.numpy() for a in ops], block_p=8)
        bad = list(ops)
        bad[2] = ops[2][:1]
        with pytest.raises(ValueError, match="dep_cnt"):
            dcn_fused_schedule(*bad)
        bad = list(ops)
        bad[0] = ops[0].double()
        with pytest.raises(ValueError, match="float32"):
            dcn_fused_schedule(*bad)


@pytest.fixture(scope="module")
def sched_case():
    """One image's schedule operands from the JAX per-image packers."""
    from repro.core.scheduler import schedule_tiles
    from repro.core.tiles import tdt_from_coords
    from repro.runtime.packing import (build_neighbour_tables,
                                       pack_schedule_tiles)

    h, w, c, o = 11, 10, 6, 5
    grid = JGrid(h, w, 4, 3)
    co = jnp.asarray(_coords(21, h, w))
    b = np.asarray(tdt_from_coords(co, grid, grid))
    sched = schedule_tiles(b, 3)
    oid, deps, cnt = sched.dense()
    dep_tbl, dep_cnt, idx, coeff = pack_schedule_tiles(
        build_neighbour_tables(co, grid), grid, oid,
        [d[:k] for d, k in zip(deps, cnt)], 16, deps.shape[1])
    rng = np.random.default_rng(4)
    return (rng.normal(size=(grid.num_tiles, 12, c)).astype(np.float32),
            dep_tbl, dep_cnt, idx, coeff,
            rng.normal(size=(9, c, o)).astype(np.float32),
            rng.normal(size=(o,)).astype(np.float32))


def _tile_case(seed, n, s, p, c, o, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = s if hi is None else hi
    return (rng.normal(size=(n, s, c)).astype(np.float32),
            rng.integers(lo, hi, size=(n, p, 9, 4)).astype(np.int32),
            rng.uniform(size=(n, p, 9, 4)).astype(np.float32),
            (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
            rng.normal(size=(o,)).astype(np.float32))


def _jax_tile(x, idx, coeff, w, b, block_p=128):
    return np.asarray(j_fused._dcn_fused_tile_jit(
        *(jnp.asarray(a) for a in (x, idx, coeff, w, b)), block_p=block_p,
        interpret=True))


class TestFusedTile:
    @pytest.mark.parametrize("n,s,p,c,o,lo,hi", [
        (1, 64, 16, 8, 8, 0, None),      # one tile, in-range addresses
        (3, 48, 32, 5, 7, -3, 52),       # a batch, out-of-range indices
        (2, 40, 24, 6, 4, 0, None),      # P not a power of two
    ])
    def test_plain_matches_jax(self, n, s, p, c, o, lo, hi):
        x, idx, coeff, w, b = _tile_case(s + p, n, s, p, c, o, lo, hi)
        got = dcn_fused_tile(*(torch.as_tensor(a)
                               for a in (x, idx, coeff, w, b)))
        assert got.shape == (n, p, o)
        for i in range(n):
            np.testing.assert_allclose(
                got[i].numpy(), _jax_tile(x[i], idx[i], coeff[i], w, b),
                rtol=1e-5, atol=1e-5)
        one = dcn_fused_tile(*(torch.as_tensor(a) for a in
                               (x[0], idx[0], coeff[0], w, b)))
        np.testing.assert_array_equal(one.numpy(), got[0].numpy())

    def test_rejects_bad_operands(self):
        x, idx, coeff, w, b = (torch.as_tensor(a)
                               for a in _tile_case(1, 1, 16, 12, 4, 4))
        with pytest.raises(ValueError, match="must tile"):
            dcn_fused_tile(x, idx, coeff, w, b, block_p=8)
        with pytest.raises(ValueError, match="must tile"):
            _jax_tile(x[0].numpy(), idx[0].numpy(), coeff[0].numpy(),
                      w.numpy(), b.numpy(), block_p=8)
        with pytest.raises(ValueError, match="does not match"):
            dcn_fused_tile(x, idx[0], coeff[0], w, b)


class TestBli:
    @pytest.mark.parametrize("n,s,p,c,lo,hi,bp,bc", [
        (1, 20, 16, 8, 0, 20, 128, 128),     # in range, whole blocks
        (2, 30, 64, 16, -2, 33, 32, 8),      # out of range, several blocks
        (1, 196, 256, 128, 0, 196, 128, 128),  # the 14x14 plane, KK=1
    ])
    def test_plain_matches_jax(self, n, s, p, c, lo, hi, bp, bc):
        rng = np.random.default_rng(s + p)
        x = rng.normal(size=(n, s, c)).astype(np.float32)
        idx = rng.integers(lo, hi, size=(n, p, 4)).astype(np.int32)
        cf = rng.uniform(size=(n, p, 4)).astype(np.float32)
        got = bli_tile_matmul(torch.as_tensor(x), torch.as_tensor(idx),
                              torch.as_tensor(cf), block_p=bp, block_c=bc)
        for i in range(n):
            want = np.asarray(j_bli.bli_tile_matmul(
                jnp.asarray(x[i]), jnp.asarray(idx[i]), jnp.asarray(cf[i]),
                block_p=bp, block_c=bc, interpret=True))
            np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5,
                                       atol=1e-5)

    def test_gather_reference_matches_jax(self):
        from repro_torch.kernels.dcn_bli import bli_gather_reference

        rng = np.random.default_rng(5)
        x = rng.normal(size=(20, 6)).astype(np.float32)
        idx = rng.integers(0, 20, size=(9, 4)).astype(np.int32)
        cf = rng.uniform(size=(9, 4)).astype(np.float32)
        want = np.asarray(j_bli.bli_gather_reference(
            jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cf)))
        got = bli_gather_reference(torch.as_tensor(x), torch.as_tensor(idx),
                                   torch.as_tensor(cf))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def test_rejects_untiled_shapes(self):
        x = torch.zeros((20, 12))
        idx = torch.zeros((10, 4), dtype=torch.int32)
        cf = torch.zeros((10, 4))
        with pytest.raises(ValueError, match="must tile"):
            bli_tile_matmul(x, idx, cf, block_p=8)
        with pytest.raises(ValueError, match="must tile"):
            bli_tile_matmul(x, idx, cf, block_c=8)
        with pytest.raises(ValueError, match="must tile"):
            j_bli.bli_tile_matmul(jnp.zeros((20, 12)),
                                  jnp.zeros((10, 4), jnp.int32),
                                  jnp.zeros((10, 4)), block_c=8,
                                  interpret=True)
