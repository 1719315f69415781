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

import math

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
from repro_torch.kernels import flash_decode as fd
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



# ---------------------------------------------------------------------------
# Launch policy of the split-C body behind #4 and #5 (plain Python)
# ---------------------------------------------------------------------------

from repro_torch.kernels import dcn_fused as kf  # noqa: E402

# (rows, P, O, C) over one-row tiles, schedules, whole planes, ragged
# channel and pixel counts, and grids that fill the card without a split.
SPLIT_SHAPES = [(1, 64, 512, 512), (1, 256, 512, 512), (4, 64, 512, 512),
                (16, 64, 512, 512), (3, 100, 200, 37), (1, 40, 5, 7),
                (2, 196, 130, 100), (70, 64, 512, 512), (264, 64, 128, 64),
                (1, 64, 64, 3), (9, 128, 256, 1000)]


class TestSplitPolicy:
    @pytest.mark.parametrize("rows,p,o,c", [(264, 64, 128, 512),
                                            (70, 64, 512, 512),
                                            (33, 256, 256, 512),
                                            (300, 1, 1, 4096)])
    def test_no_split_when_the_grid_fills_two_waves(self, rows, p, o, c):
        blocks = math.prod(kf.fused_grid(rows, p, o, 1))
        assert blocks >= 2 * kf.H100_SMS
        assert kf.fused_splits(rows, p, o, c) == 1

    @pytest.mark.parametrize("rows,p,o,c", SPLIT_SHAPES)
    def test_slices_are_whole_chunks_and_never_exceed_them(self, rows, p, o,
                                                           c):
        chunks = math.ceil(c / kf.SPLIT_BC)
        n = kf.fused_splits(rows, p, o, c)
        assert 1 <= n <= chunks
        for want in {1, n, chunks}:
            got, c_split = kf.split_channels(c, want)
            assert got <= want and c_split % kf.SPLIT_BC == 0
            # every slice holds at least one channel, together all C
            assert (got - 1) * c_split < c <= got * c_split
        assert kf.split_channels(c, n)[0] == n

    @pytest.mark.parametrize("sms", [66, 114, 132])
    def test_split_fills_about_two_waves(self, sms):
        for rows, p, o, c in SPLIT_SHAPES:
            base = math.prod(kf.fused_grid(rows, p, o, 1))
            n = kf.fused_splits(rows, p, o, c, sms)
            chunks = math.ceil(c / kf.SPLIT_BC)
            if base < 2 * sms:
                # the grid fits one wave of two blocks an SM ...
                assert base * n <= 2 * sms
                if n < chunks:
                    # ... and one slice fewer per block would overshoot it
                    per = math.ceil(chunks / n)
                    assert per == 1 or base * math.ceil(
                        chunks / (per - 1)) > 2 * sms

    @pytest.mark.parametrize("shape,grid", [
        ((1, 64, 512, 512), (1, 1, 4, 32)),     # #5 per tile, 128 blocks
        ((1, 256, 512, 512), (1, 4, 4, 16)),    # #5 whole plane, 256 blocks
        ((4, 64, 512, 512), (4, 1, 4, 16)),     # #4 schedule, 256 blocks
        ((16, 64, 512, 512), (16, 1, 4, 4)),    # #1 batch of 4, 256 blocks
    ])
    def test_grids_quoted_in_perf(self, shape, grid):
        rows, p, o, c = shape
        assert kf.fused_grid(rows, p, o, kf.fused_splits(*shape)) == grid

    @pytest.mark.parametrize("n", [0, 33, -1])
    def test_rejects_out_of_range_split(self, n):
        with pytest.raises(ValueError, match="n_split"):
            kf.split_channels(512, n)


# (rows, P, O, C) of bf16 split calls: #1 (a 4-image batch), #4, #5 per
# tile and on the whole plane at full width, then awkward sizes.
BF16_SPLIT_SHAPES = [(16, 64, 512, 512), (4, 64, 512, 512), (1, 64, 512, 512),
                     (1, 256, 512, 512), (3, 100, 200, 37), (1, 40, 5, 7),
                     (2, 196, 130, 100), (70, 64, 512, 512), (9, 128, 256, 1000)]


class TestBf16SplitPolicy:
    """The bf16 body's split rule (`fused_splits(dtype=bfloat16)`,
    `bf16_slices`, `fused_cluster`, `fused_grid_bf16`): its stages cut
    into even slices, clusters of at most 8 blocks, one wave of them."""

    @pytest.mark.parametrize("rows,p,o,c", BF16_SPLIT_SHAPES)
    def test_slices_are_whole_stages_none_empty(self, rows, p, o, c):
        chunks = math.ceil(c / kf.BF16_BC)
        n = kf.fused_splits(rows, p, o, c, dtype=torch.bfloat16)
        assert 1 <= n <= chunks
        for want in {1, n, chunks}:
            cuts = kf.bf16_slices(c, 9, want)
            assert len(cuts) == want
            # contiguous, all the stages, each at least one chunk's taps
            assert cuts[0][0] == 0 and cuts[-1][1] == 9 * chunks
            assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
            assert all(e - s >= 9 for s, e in cuts)
            assert max(e - s for s, e in cuts) - min(
                e - s for s, e in cuts) <= 1

    @pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 11, 16, 24, 33])
    def test_clusters_hold_at_most_eight_blocks(self, n):
        cluster, groups = kf.fused_cluster(n)
        assert 1 <= cluster <= kf.MAX_CLUSTER
        assert groups == math.ceil(n / kf.MAX_CLUSTER)
        # the fewest blocks a cluster that hold the slices
        assert cluster * groups >= n > (cluster - 1) * groups
        assert kf.fused_grid_bf16(16, 64, 512, n)[0] == cluster * groups

    @pytest.mark.parametrize("sms", [66, 114, 132])
    def test_clusters_run_in_one_wave(self, sms):
        cap = kf.cluster_model(sms)
        for rows, p, o, c in BF16_SPLIT_SHAPES:
            n = kf.fused_splits(rows, p, o, c, sms, dtype=torch.bfloat16,
                                clusters=cap)
            blocks, o_blocks, pairs = kf.fused_grid_bf16(rows, p, o, n)
            cluster, groups = kf.fused_cluster(n)
            if o_blocks * pairs <= sms:
                assert o_blocks * pairs * groups <= cap[cluster]
                # no more slices would fit the wave
                for k in range(n + 1, math.ceil(c / kf.BF16_BC) + 1):
                    c2, g2 = kf.fused_cluster(k)
                    assert o_blocks * pairs * g2 > cap[c2]
        for rows, p, o, c in BF16_SPLIT_SHAPES:  # the card's own capacity
            n = kf.fused_splits(rows, p, o, c, dtype=torch.bfloat16)
            _, o_blocks, pairs = kf.fused_grid_bf16(rows, p, o, n)
            cluster, groups = kf.fused_cluster(n)
            if o_blocks * pairs <= kf.H100_SMS:
                assert o_blocks * pairs * groups <= kf.H100_CLUSTERS[cluster]

    @pytest.mark.parametrize("shape,grid", [
        ((16, 64, 512, 512), (3, 4, 8)),      # #1, a batch of 4
        ((4, 64, 512, 512), (12, 4, 2)),      # #4, two clusters of 6
        ((1, 64, 512, 512), (16, 4, 1)),      # #5 per tile, two of 8
        ((1, 256, 512, 512), (12, 4, 2)),     # #5 whole plane
    ])
    def test_grids_quoted_in_perf(self, shape, grid):
        rows, p, o, c = shape
        n = kf.fused_splits(*shape, dtype=torch.bfloat16)
        assert kf.fused_grid_bf16(rows, p, o, n) == grid

    @pytest.mark.parametrize("n", [0, 17, -1])
    def test_rejects_out_of_range_split(self, n):
        with pytest.raises(ValueError, match="n_split"):
            kf.bf16_slices(512, 9, n)


def _visible(length, s_len, window):
    """Keys that ``flash_decode_plain`` leaves visible, by its own mask."""
    ki = np.arange(s_len)
    mask = ki < length
    if window is not None:
        mask &= ki > length - 1 - window
    return np.flatnonzero(mask)


DECODE_LENGTHS = [-3, 0, 1, 7, 63, 64, 65, 127, 128, 130, 300, 511, 512,
                  513, 900]


class TestDecodeSplitRanges:
    """The rule by which the decode kernel (#8) cuts each sequence's
    visible keys into splits (``split_ranges``; the kernel's ``split_of``
    computes the same on the card)."""

    @pytest.mark.parametrize("window", [None, 1, 17, 100, 600])
    @pytest.mark.parametrize("splits", [1, 3, 8, 64])
    def test_ranges_partition_the_visible_keys(self, splits, window):
        s_len = 512
        for length in DECODE_LENGTHS:
            (got,) = fd.split_ranges([length], s_len, splits, 8, window)
            vis = _visible(length, s_len, window)
            keys = np.concatenate([np.arange(a, e) for a, e in got]
                                  + [np.zeros(0, np.int64)])
            np.testing.assert_array_equal(keys, vis)   # exact, in order
            if vis.size == 0:
                assert got == []
                continue
            assert 1 <= len(got) <= splits
            assert all(e > a for a, e in got)         # none empty
            if len(got) > 1:
                assert min(e - a for a, e in got) >= fd._MIN_SPLIT_KEYS
            # whole key tiles from the range's start, near-equal
            lo = got[0][0]
            assert all((a - lo) % fd.KEY_TILE == 0 for a, _ in got)
            tiles = [-(-(e - a) // fd.KEY_TILE) for a, e in got]
            assert max(tiles) - min(tiles) <= 1

    @pytest.mark.parametrize("length,window,want", [
        (130, None, 2), (127, None, 1), (512, None, 8), (900, None, 8),
        (900, 600, 3), (900, 300, 0), (512, 100, 1), (512, 128, 2),
        (0, None, 0)])
    def test_split_count_follows_the_visible_keys(self, length, window,
                                                  want):
        """Splits come from the visible keys (64 a split at least), not
        from the cache's capacity."""
        (got,) = fd.split_ranges([length], 512, 8, 8, window)
        assert len(got) == want

    @pytest.mark.parametrize("lengths,window", [
        ([21981, 26379, 743, 26475, 15364, 16887, 20652, 9366], None),
        ([8025, 442, 2277, 3141], 4096),
        ([32768, 1, 1, 1, 1, 1, 1, 1], None),
        ([275, 112, 168, 109], None)])
    def test_splits_share_the_batch_evenly(self, lengths, window):
        """Across the batch every split that is not its sequence's only
        one holds between ``keys`` and about twice ``keys`` keys, and the
        blocks number about the target (the serving shape: every split at
        the 64-key floor)."""
        s_len, hkv, target = 32768, 8, 528
        cap = fd.default_splits(len(lengths), hkv, s_len)
        ranges = fd.split_ranges(lengths, s_len, cap, hkv, window, target)
        visible = sum(e - a for seq in ranges for a, e in seq)
        keys = max(fd._MIN_SPLIT_KEYS, -(-visible * hkv // target))
        keys = -(-keys // fd.KEY_TILE) * fd.KEY_TILE
        blocks = hkv * sum(map(len, ranges))
        assert blocks <= max(target, hkv * len(lengths))
        for seq in ranges:
            if len(seq) > 1:
                sizes = [e - a for a, e in seq]
                assert min(sizes) >= keys
                if len(seq) < cap:     # the upper limit did not bind
                    assert max(sizes) < 2 * keys + fd.KEY_TILE

    @pytest.mark.parametrize("splits", [1, 5, 64])
    def test_explicit_split_count(self, splits):
        """``num_splits`` (``target=None``): each sequence takes
        ``min(splits, visible // 64)`` splits, at least one."""
        lengths = [21981, 26379, 743, 26475, 0, 64, 127, 5000]
        ranges = fd.split_ranges(lengths, 32768, splits, 8, target=None)
        assert [len(r) for r in ranges] == [
            min(splits, max(1, n // 64)) if n else 0 for n in lengths]

    @pytest.mark.parametrize("b,hkv,s_len,want", [
        (4, 8, 512, 8), (8, 8, 32768, 17), (1, 1, 100, 2),
        (64, 16, 4096, 2)])
    def test_default_splits_is_an_upper_limit_from_shapes(self, b, hkv,
                                                          s_len, want):
        assert fd.default_splits(b, hkv, s_len) == want


# Ragged batches of the bf16-cache kernel's cluster rule: the serving
# shapes, the 32k cache, lengths around a stage and past S, none visible.
CLUSTER_BATCHES = [
    [459, 443, 420, 438], [201, 77, 236, 149], [1601] * 4,
    [2278, 26576, 30867, 8568, 5556, 2530, 26181, 31014],
    [0, 1, 31, 32, 33, 64, 255, 256, 257, 600, -3]]


class TestDecodeClusterRanges:
    """The rule by which the bf16-cache decode kernel cuts each sequence's
    visible keys over the blocks of its cluster (``cluster_ranges``; the
    kernel's ``range_of`` and ``ranked`` compute the same on the card)."""

    @pytest.mark.parametrize("num_splits", [None, 1, 3, 64])
    @pytest.mark.parametrize("window", [None, 1, 40, 4096])
    @pytest.mark.parametrize("lengths", CLUSTER_BATCHES)
    def test_ranges_cover_the_visible_keys_in_whole_stages(
            self, lengths, window, num_splits):
        """Every visible key once, in order; whole stages from the range's
        start (the last may end early); at most the cluster's blocks, none
        empty; a forced count gives min(num_splits, visible // 64) splits
        (at least one), each block a run of them."""
        s_len = max(max(lengths), 1)
        cluster = fd.cluster_size(len(lengths), 8, s_len,
                                  num_splits=num_splits)
        assert 1 <= cluster <= fd.MAX_CLUSTER
        for length, got in zip(lengths, fd.cluster_ranges(
                lengths, s_len, cluster, window, num_splits)):
            vis = _visible(length, s_len, window)
            keys = np.concatenate([np.arange(a, e) for a, e in got]
                                  + [np.zeros(0, np.int64)])
            np.testing.assert_array_equal(keys, vis)
            if vis.size == 0:
                assert got == []
                continue
            assert 1 <= len(got) <= cluster
            assert all(e > a for a, e in got)
            lo = got[0][0]
            assert all((a - lo) % fd.STAGE_KEYS == 0 for a, _ in got)
            n = (max(1, min(num_splits, vis.size // 64)) if num_splits
                 else -(-vis.size // fd.STAGE_KEYS))
            assert len(got) == min(cluster, n)
            if num_splits:
                # each block a run of whole splits of the forced count
                (one,) = fd.cluster_ranges([length], s_len, n, window,
                                           num_splits)
                bounds = {a for a, _ in one}
                assert {a for a, _ in got} <= bounds

    @pytest.mark.parametrize("b,hkv,s_len,num_splits,want", [
        (4, 8, 512, None, 8), (4, 8, 1601, None, 8), (8, 8, 32768, None, 8),
        (4, 16, 8192, 64, 8), (64, 8, 4096, None, 2), (512, 8, 4096, None, 1),
        (1, 1, 100, None, 7), (4, 8, 512, 3, 3), (2, 1, 20, None, 2)])
    def test_cluster_size_from_shapes(self, b, hkv, s_len, num_splits,
                                      want):
        assert fd.cluster_size(b, hkv, s_len,
                               num_splits=num_splits) == want

    @pytest.mark.parametrize("lengths", CLUSTER_BATCHES)
    def test_one_wave_at_the_serving_shapes(self, lengths):
        """Up to 45 (sequence, kv head) pairs the grid is one wave: at
        most 360 blocks, the 45 clusters of 8 an H100 runs at once at
        three blocks an SM; every block of a sequence with a stage for
        each has keys."""
        for hkv in (1, 8):
            b, s_len = len(lengths), max(max(lengths), 1)
            cluster = fd.cluster_size(b, hkv, s_len)
            if b * hkv <= 45:
                assert cluster * b * hkv <= 360
            for length, got in zip(lengths, fd.cluster_ranges(
                    lengths, s_len, cluster)):
                stages = -(-_visible(length, s_len, None).size
                           // fd.STAGE_KEYS)
                assert len(got) == min(cluster, stages)

    @pytest.mark.parametrize("window", [None, 100])
    @pytest.mark.parametrize("lengths", CLUSTER_BATCHES)
    def test_clusters_take_the_heaviest_sequence_first(self, lengths,
                                                       window):
        order = fd.cluster_order(lengths, 32768, window)
        assert sorted(order) == list(range(len(lengths)))
        vis = [_visible(n, 32768, window).size for n in lengths]
        for a, b in zip(order, order[1:]):
            assert vis[a] > vis[b] or (vis[a] == vis[b] and a < b)


class TestBli:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,s,p,c,lo,hi,bp,bc", [
        (1, 20, 16, 8, 0, 20, 128, 128),     # in range, whole blocks
        (2, 30, 64, 16, -2, 33, 32, 8),      # out of range, several blocks
        (1, 196, 256, 128, 0, 196, 128, 128),  # the 14x14 plane, KK=1
    ])
    def test_plain_matches_jax(self, n, s, p, c, lo, hi, bp, bc, dtype):
        """float32 within 1e-5; bfloat16 (the same f32 inputs rounded to
        bf16 in both frameworks, f32 sums rounded once) within one bf16
        ulp at the largest output, 2**-7 * max|ref|: the TPU kernel sums
        the four terms in column order, the port in j order, and the two
        f32 sums may round to neighbouring bf16 values."""
        rng = np.random.default_rng(s + p)
        x = rng.normal(size=(n, s, c)).astype(np.float32)
        idx = rng.integers(lo, hi, size=(n, p, 4)).astype(np.int32)
        cf = rng.uniform(size=(n, p, 4)).astype(np.float32)
        got = bli_tile_matmul(torch.as_tensor(x).to(getattr(torch, dtype)),
                              torch.as_tensor(idx), torch.as_tensor(cf),
                              block_p=bp, block_c=bc)
        assert got.dtype == getattr(torch, dtype)
        for i in range(n):
            want = np.asarray(j_bli.bli_tile_matmul(
                jnp.asarray(x[i], dtype=getattr(jnp, dtype)),
                jnp.asarray(idx[i]), jnp.asarray(cf[i]),
                block_p=bp, block_c=bc, interpret=True)).astype(np.float32)
            g = got[i].float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
            else:
                assert np.abs(g - want).max() <= 2**-7 * np.abs(want).max()

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
    def test_rejects_other_dtypes(self, dtype):
        """float64 x raises; float16 x, which #6 refused until it took
        float16, now gives float16 rows of the right value (the case keeps
        its place in this test). Coefficients of either type raise."""
        x = torch.arange(160, dtype=dtype).reshape(20, 8)
        idx = torch.tensor([[0, 1, 2, 25]] * 16, dtype=torch.int32)
        cf = torch.tensor([[0.5, 0.25, 0.25, 1.0]] * 16)
        if dtype == torch.float16:
            got = bli_tile_matmul(x, idx, cf)
            want = 0.5 * x[0].float() + 0.25 * x[1].float() \
                + 0.25 * x[2].float()
            assert got.dtype == torch.float16
            assert torch.equal(got.float(), want.expand(16, 8))
        else:
            with pytest.raises(ValueError,
                               match="float32, bfloat16 or float16"):
                bli_tile_matmul(x, idx, cf)
        with pytest.raises(ValueError, match="coeff must be float32"):
            bli_tile_matmul(torch.zeros((20, 8)), idx,
                            torch.zeros((16, 4), dtype=dtype))

    @pytest.mark.parametrize("h,w", [(6, 8), (7, 5), (1, 3)])
    def test_parity_planes_equal_jax(self, h, w):
        from repro_torch.kernels.dcn_bli import parity_planes

        x = np.random.default_rng(h * w).normal(size=(h, w, 3)).astype(
            np.float32)
        got = parity_planes(torch.as_tensor(x))
        want = j_bli.parity_planes(jnp.asarray(x))
        assert len(got) == len(want) == 4
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))

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


class TestBliPlan:
    """The launch shape of the BLI kernel (``dcn_bli.bli_plan``), plain
    Python: what the CUDA kernel is given on the card."""

    @pytest.mark.parametrize("n,elem,grid,rows", [
        (1, 4, (32, 16, 1), 56),    # serving shape, f32
        (1, 2, (64, 8, 1), 28),     # bf16: 64-channel slices
        (4, 4, (8, 16, 4), 224),    # a serving step's four images
        (4, 2, (16, 8, 4), 112),
    ])
    def test_serving_shapes_fill_one_wave(self, n, elem, grid, rows):
        from repro_torch.kernels.dcn_bli import BLI_BLOCKS_PER_SM, bli_plan

        plan = bli_plan(n, 1792, 196, 512, elem)
        assert (plan.vec, plan.lw) == (True, 8)
        assert plan.grid == grid and plan.rows == rows
        assert math.prod(grid) <= BLI_BLOCKS_PER_SM * kf.H100_SMS
        assert plan.rows * plan.grid[0] >= 1792 and plan.rows % 4 == 0

    @pytest.mark.parametrize("n,p,s,c,elem", [
        (1, 1792, 196, 512, 4), (4, 1792, 196, 512, 4), (4, 1792, 196, 512, 2),
        (2, 1792, 196, 512, 4), (1, 8192, 196, 256, 4), (1, 4096, 49, 64, 2),
        (8, 1024, 400, 128, 4), (1, 1024, 3136, 256, 4), (3, 64, 9, 8, 4)])
    def test_row_chunks_cover_every_row_once(self, n, p, s, c, elem):
        from repro_torch.kernels.dcn_bli import BLI_BLOCKS_PER_SM, bli_plan

        plan = bli_plan(n, p, s, c, elem)
        assert plan.rows * plan.grid[0] >= p > plan.rows * (plan.grid[0] - 1)
        assert plan.rows % (32 // plan.lw) == 0
        assert plan.grid[1] * plan.lw * 16 == c * elem and plan.grid[2] == n
        assert math.prod(plan.grid) <= BLI_BLOCKS_PER_SM * kf.H100_SMS

    def test_large_plane_moves_16_byte_words(self):
        from repro_torch.kernels.dcn_bli import bli_plan

        for elem in (4, 2):
            plan = bli_plan(1, 1024, 3136, 256, elem)
            assert plan.vec and plan.lw == 8
            assert plan.grid == ({4: 64, 2: 128}[elem], 2 * elem, 1)
        assert bli_plan(1, 16, 0, 8, 4).grid == (1, 1, 1)

    @pytest.mark.parametrize("c,elem,lw", [(6, 4, 2), (6, 2, 2), (9, 2, 1),
                                           (12, 2, 4), (20, 2, 4)])
    def test_unaligned_rows_gather_elements(self, c, elem, lw):
        from repro_torch.kernels.dcn_bli import bli_plan

        plan = bli_plan(1, 1024, 9, c, elem)
        assert (plan.vec, plan.lw) == (False, lw)
        assert plan.grid[1] * plan.lw == c
        assert not bli_plan(1, 1024, 9, 8, 4, aligned=False).vec


@pytest.mark.parametrize("which", ["dcn_fused_batch", "dcn_fused_schedule",
                                   "dcn_fused_tile"])
def test_other_kernels_still_refuse_bf16(which):
    """The split-C DCN kernels #1, #4 and #5 take bf16 as the other
    kernels do (``tests/test_torch_dcn_bf16.py``) and float16 too: a
    float16 call returns float16, the float32 sum plus b rounded once
    (here a row of no dep, or a tile of zero coefficients: b itself). The
    test keeps the name it had while these kernels refused bf16 and then
    float16, so that its history stays one test's."""
    h = torch.zeros((2, 4, 4), dtype=torch.float16)     # x: 2 tiles of 4
    w = torch.ones((1, 4, 4), dtype=torch.float16)       # KK = 1, C = O = 4
    b = torch.tensor([1.5, -2.0, 0.25, 3.0], dtype=torch.float16)
    i1 = torch.zeros((2,), dtype=torch.int32)            # no dep: b alone
    i2 = torch.zeros((2, 1), dtype=torch.int32)
    idx = torch.zeros((2, 4, 1, 4), dtype=torch.int32)   # (rows, P, KK, 4)
    cf = torch.zeros((2, 4, 1, 4))
    call = {"dcn_fused_batch": lambda: kf.dcn_fused_batch(
                h, i1, i2, i1, idx, cf, w, b, t_in=1),
            "dcn_fused_schedule": lambda: kf.dcn_fused_schedule(
                h, i2, i1, idx, cf, w, b),
            "dcn_fused_tile": lambda: kf.dcn_fused_tile(h, idx, cf, w,
                                                        b)}[which]
    got = call()
    assert got.dtype == torch.float16
    assert torch.equal(got, b.expand(got.shape))


def _attention_call(which, q_dtype, kv_dtype):
    from repro_torch.kernels import flash_attention as fa

    q = torch.ones((1, 3, 4, 8), dtype=q_dtype)
    kv = torch.ones((1, 5, 2, 8), dtype=kv_dtype)
    if which == "flash_attention":
        return fa.flash_attention(q, kv, kv)
    return fd.flash_decode(q[:, 0].contiguous(), kv, kv,
                           torch.tensor([4], dtype=torch.int32))


@pytest.mark.parametrize("which", ["flash_attention", "flash_decode"])
def test_attention_kernels_take_bf16_and_return_q_dtype(which):
    """#7 and #8 take bf16 operands and a bf16 cache under a float32 q
    (and the reverse), as the TPU kernels do, and return q's dtype."""
    for q_dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16),
                              (torch.float32, torch.bfloat16),
                              (torch.bfloat16, torch.float32)):
        out = _attention_call(which, q_dtype, kv_dtype)
        assert out.dtype == q_dtype
        assert torch.allclose(out.float(), torch.ones_like(out.float()))


@pytest.mark.parametrize("which", ["flash_attention", "flash_decode"])
def test_attention_kernels_refuse_fp16(which):
    """#7 and #8 take float16 operands and a float16 cache under a float32
    q, as the TPU kernels do, and return q's dtype: over keys and values
    of ones the output is ones. (The test kept its name from when they
    refused float16.)"""
    for q_dtype, kv_dtype in ((torch.float16, torch.float16),
                              (torch.float32, torch.float16),
                              (torch.float16, torch.float32)):
        out = _attention_call(which, q_dtype, kv_dtype)
        assert out.dtype == q_dtype
        assert torch.equal(out.float(), torch.ones_like(out.float()))