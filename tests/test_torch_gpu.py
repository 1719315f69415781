"""The port's CUDA kernels against their plain torch versions, on the
card. Every test carries the ``gpu`` marker and skips without a CUDA
device (a CUDA kernel has no CPU mode). This file imports no JAX, so it
runs on a machine that has only the port:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.tiles import TileGrid, tdt_standard_conv
from repro_torch.kernels.dcn_fused import (dcn_fused_batch,
                                           dcn_fused_batch_plain)
from repro_torch.kernels.dcn_schedule import (greedy_plain,
                                              greedy_schedule_arrays,
                                              schedule_group_batch,
                                              schedule_group_batch_plain,
                                              tdt_from_coords_device,
                                              tdt_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _coords(seed, h, w, spread=2.0):
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                    -1)[:, :, None, :]
    c = base + rng.normal(scale=spread, size=(h, w, 9, 2))
    return torch.as_tensor(np.clip(c, 0, [h - 1, w - 1]).astype(np.float32))


@pytest.mark.parametrize("h,w,th,tw", [(14, 14, 8, 8), (13, 13, 4, 4),
                                       (16, 10, 4, 3), (224, 224, 8, 8)])
def test_tdt_kernel(h, w, th, tw):
    co = _coords(h + w, h, w)
    g = TileGrid(h, w, th, tw)
    got = tdt_from_coords_device(co.cuda(), g, g).cpu()
    assert torch.equal(got, tdt_plain(co, g, g))


def _tables():
    rng = np.random.default_rng(11)
    g = TileGrid(224, 224, 8, 8)
    return [np.zeros((4, 4), bool), np.ones((1, 1), bool),
            np.ones((6, 6), bool), rng.random((12, 12)) < 0.35,
            rng.random((9, 20)) < 0.3, tdt_standard_conv(g, g, 3)]


@pytest.mark.parametrize("which", range(6))
@pytest.mark.parametrize("m", [1, 3, 784])
def test_greedy_kernel(which, m):
    bt = torch.as_tensor(_tables()[which])
    got = greedy_schedule_arrays(bt.cuda(), m)
    for g_, w_ in zip(got, greedy_plain(bt, m)):
        assert torch.equal(g_.cpu(), w_)


@pytest.mark.parametrize("m", [1, 784])
def test_greedy_kernel_scratch_path(m):
    """The 784-tile table with its bit rows in global scratch, and in
    shared memory, against the plain version; a rerun is bitwise equal."""
    bt = torch.as_tensor(_tables()[5])
    want = greedy_plain(bt, m)
    for in_smem in (False, True, False):
        got = greedy_schedule_arrays(bt.cuda(), m, tables_in_smem=in_smem)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu(), w_)


def test_tdt_and_greedy_rerun_bitwise():
    co = _coords(3, 56, 56).cuda()
    g = TileGrid(56, 56, 8, 8)
    a, b = tdt_from_coords_device(co, g, g), tdt_from_coords_device(co, g, g)
    assert torch.equal(a, b)
    x, y = greedy_schedule_arrays(a, 5), greedy_schedule_arrays(a, 5)
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def _group_case(name):
    """(layers on the CPU, grid, images, m, forced table placement):
    the warp body (<= 32 tiles) and the block body at (49, 49),
    (196, 196) and (784, 784), the last also with global scratch."""
    plane, tile, specs, n, images, m, in_smem = {
        "serving shape": (14, 8, ["dcn"], 4, [0, 1, 2, 3], 4, None),
        "ragged chain, skips": (13, 4, [3, "dcn", "dcn"], 3, [2, 0], 3, None),
        "many images": (14, 8, [3, "dcn"], 280, list(range(280)), 2, None),
        "49 tiles": (56, 8, ["dcn"], 2, [0, 1], 4, None),
        "49 tiles, padded suffix": (56, 8, ["table"], 2, [1], 7, None),
        "196 tiles chain": (112, 8, [3, "dcn", 3], 2, [1, 0], 16, None),
        "196 tiles scratch": (112, 8, ["dcn", "dcn"], 1, [0], 9, False),
        "784 tiles": (224, 8, [3, "dcn"], 1, [0], 64, None),
        "784 tiles scratch": (224, 8, [3, "dcn"], 1, [0], 64, False),
    }[name]
    rng = np.random.default_rng(len(name))
    grid = TileGrid(plane, plane, tile, tile)
    t = grid.num_tiles
    layers = []
    for spec in specs:
        if spec == "dcn":
            layers.append(torch.stack([_coords(int(rng.integers(1 << 30)),
                                               plane, plane)
                                       for _ in range(n)]))
        elif spec == "table":
            b = rng.random((n, t, t)) < 0.1
            b[:, 1::4] = False
            layers.append(torch.as_tensor(b))
        else:
            layers.append(spec)
    return layers, grid, images, m, in_smem


GROUP_CASES = ["serving shape", "ragged chain, skips", "many images",
               "49 tiles", "49 tiles, padded suffix", "196 tiles chain",
               "196 tiles scratch", "784 tiles", "784 tiles scratch"]


@pytest.mark.parametrize("name", GROUP_CASES)
def test_group_kernel(name):
    """``schedule_group_batch`` against its plain version, every output of
    every listed image bit-exact; a rerun is bitwise equal."""
    layers, grid, images, m, in_smem = _group_case(name)
    k_pad = 1 << (grid.num_tiles - 1).bit_length()
    want = schedule_group_batch_plain(layers, images, grid, m, k_pad)
    cuda = [lay.cuda() if torch.is_tensor(lay) else lay for lay in layers]
    runs = [schedule_group_batch(cuda, images, grid, m, k_pad,
                                 device="cuda", tables_in_smem=in_smem)
            for _ in range(2)]
    torch.cuda.synchronize()
    for k in range(len(images)):
        w = want.image(k).tensors()
        for got in runs:
            g = got.image(k, own=True).tensors()
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_group_kernel_counts_one_launch():
    layers, grid, images, m, _ = _group_case("ragged chain, skips")
    cuda = [lay.cuda() if torch.is_tensor(lay) else lay for lay in layers]
    n0 = schedule_group_batch.launches
    schedule_group_batch(cuda, images, grid, m, 16)
    schedule_group_batch(cuda, [], grid, m, 16)        # nothing listed
    assert schedule_group_batch.launches == n0 + 1


# Tile shapes the tuner can give a 14x14 DCN group (tile sides {1, 2, 4,
# 8, 14}): P = 1, 2, 14, 28 and 196 pixels a tile, the last padded to 256
# as the executor pads it; 196 and 98 tiles run the group kernel's block
# body, 14, 7 and 1 its warp body.
TUNED_TILES = [(1, 1), (1, 2), (1, 14), (2, 14), (14, 14)]


def _tuned_group(th, tw, n=4, m=6):
    """A 14x14 DCN group of ``n`` images at tile (th, tw): its layer
    coords, grid, images, FIFO depth and dispatch k_pad, as the
    batch-fused prepass hands them to the group kernel."""
    grid = TileGrid(14, 14, th, tw)
    coords = torch.stack([_coords(100 + 7 * i, 14, 14, spread=3.0)
                          for i in range(n)])
    return [coords], grid, list(range(n)), m, \
        1 << (grid.num_tiles - 1).bit_length()


@pytest.mark.parametrize("th,tw", TUNED_TILES)
def test_group_kernel_tuned_grid(th, tw):
    layers, grid, images, m, k_pad = _tuned_group(th, tw)
    want = schedule_group_batch_plain(layers, images, grid, m, k_pad)
    got = schedule_group_batch([layers[0].cuda()], images, grid, m, k_pad,
                               device="cuda")
    torch.cuda.synchronize()
    for k in range(len(images)):
        for a, b in zip(got.image(k, own=True).tensors(),
                        want.image(k).tensors()):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("th,tw", TUNED_TILES)
def test_batch_kernel_tuned_tile(th, tw):
    """#1 on the operands the batch-fused path packs for a 14x14x512 DCN
    layer of 4 images at tile (th, tw): the plain version within 1e-4 *
    max|ref|, a bitwise rerun."""
    from repro_torch.core.scheduler import DeviceSchedule
    from repro_torch.runtime.packing import (pack_batch_schedules,
                                             pack_plane_operands)

    layers, grid, images, m, k_pad = _tuned_group(th, tw)
    n, t, tp = len(images), grid.num_tiles, th * tw
    p_pad = tp if tp % min(128, tp) == 0 else -(-tp // 128) * 128
    out = schedule_group_batch_plain(layers, images, grid, m, k_pad)
    batch = pack_batch_schedules(
        [DeviceSchedule(*out.image(k).exec[0]) for k in range(n)], t, t,
        "cpu")
    idx, coeff = pack_plane_operands(layers[0], grid, p_pad)
    rng = np.random.default_rng(th * 16 + tw)
    ops = [torch.as_tensor(rng.normal(size=(n * t, tp, 512))
                           .astype(np.float32)),
           batch.row_id, batch.dep_glb, batch.dep_cnt,
           idx.reshape(n * t, p_pad, 9, 4), coeff.reshape(n * t, p_pad, 9, 4),
           torch.as_tensor((rng.normal(size=(9, 512, 512)) / 68)
                           .astype(np.float32)),
           torch.as_tensor(rng.normal(size=(512,)).astype(np.float32))]
    want = dcn_fused_batch_plain(*ops, t_in=t)
    args = [a.contiguous().cuda() for a in ops]
    got = dcn_fused_batch(*args, t_in=t)
    assert got.shape == (batch.row_id.shape[0], p_pad, 512)
    assert float((got.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    assert torch.equal(dcn_fused_batch(*args, t_in=t), got)


def _fused_operands(seed, n, t, tp, c, o, k_pad, kk=9):
    rng = np.random.default_rng(seed)
    g = n * t
    row = rng.permutation(g).astype(np.int32)
    cnt = rng.integers(0, min(k_pad, t) + 1, size=g).astype(np.int32)
    dep = np.stack([(row[i] // t) * t + np.resize(rng.permutation(t), k_pad)
                    for i in range(g)]).astype(np.int32)
    ops = (rng.normal(size=(n * t, tp, c)), row, cnt, dep,
           rng.integers(0, t * tp, size=(n * t, tp, kk, 4)),
           rng.uniform(size=(n * t, tp, kk, 4)),
           rng.normal(size=(kk, c, o)) / np.sqrt(kk * c),
           rng.normal(size=(o,)))
    x, row, cnt, dep, idx, cf, w, b = ops
    return [torch.as_tensor(a) for a in (
        x.astype(np.float32), row, dep, cnt, idx.astype(np.int32),
        cf.astype(np.float32), w.astype(np.float32), b.astype(np.float32))]


@pytest.mark.parametrize("shape", [(2, 4, 16, 8, 8, 4), (3, 9, 4, 5, 7, 8),
                                   (4, 4, 64, 512, 512, 4)])
def test_fused_kernel(shape):
    ops = _fused_operands(0, *shape)
    t = shape[1]
    want = dcn_fused_batch_plain(*ops, t_in=t)
    got = dcn_fused_batch(*(a.cuda() for a in ops), t_in=t).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _batch_operands(seed, n, t, tp, c, o, k_pad, kk=9):
    """Batch-fused operands of ``n`` images in one call, rows shuffled
    across images, with addresses outside the image's plane (negative and
    past its last tile) and a last row of dep_cnt = 0."""
    ops = _fused_operands(seed, n, t, tp, c, o, k_pad, kk)
    rng = np.random.default_rng(seed + 100)
    ops[3][-1] = 0
    ops[4] = torch.as_tensor(rng.integers(-tp, (t + 1) * tp,
                                          size=ops[4].shape).astype(np.int32))
    return ops


# (N, T, tp = P, C, O, k_pad): full width (4 images), then C not a multiple
# of the 16-channel chunk (nor of 4) with O not a multiple of the
# 128-channel tile and P not a multiple of the 64-pixel tile, then 7
# chunks with O not a multiple of 4, then deps of 1600 rows (the gather
# path).
SPLIT_BATCH_SHAPES = [(4, 4, 64, 512, 512, 4), (3, 6, 100, 37, 200, 4),
                      (2, 9, 40, 100, 130, 8), (2, 20, 100, 24, 72, 16)]


@pytest.mark.parametrize("shape", SPLIT_BATCH_SHAPES)
def test_batch_kernel_split(shape):
    """#1 on the split-C body: the plain version at n_split = 1, the
    default and 32 (or the chunk count), split invariance, bitwise
    reruns, a dep_cnt = 0 row that is exactly b, and the launched grid."""
    from repro_torch.kernels.dcn_fused import (SPLIT_BC, fused_grid,
                                               fused_splits)

    n, t, tp, c, o, _ = shape
    ops = _batch_operands(8, *shape)
    want = dcn_fused_batch_plain(*ops, t_in=t)
    args = [a.cuda() for a in ops]
    scale = float(want.abs().max())
    outs = {}
    for split in (1, None, min(32, math.ceil(c / SPLIT_BC))):
        outs[split] = dcn_fused_batch(*args, t_in=t, n_split=split)
        got = outs[split]
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        assert float((got - outs[1]).abs().max()) <= 1e-5 * scale
        assert torch.equal(got[-1], args[-1].expand(tp, o))
    assert torch.equal(dcn_fused_batch(*args, t_in=t), outs[None])
    g = n * t
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert dcn_fused_batch.last_grid == fused_grid(
        g, tp, o, fused_splits(g, tp, o, c, sms))


def _sched_operands(seed, t, t_in, tp, c, o, k_pad, kk=9):
    """Schedule-kernel operands with every awkward case: addresses in
    padding slots (>= dep_cnt), beyond k_pad*tp and negative, and a
    dep_cnt = 0 row."""
    rng = np.random.default_rng(seed)
    dep = np.stack([rng.permutation(t_in)[:k_pad] if k_pad <= t_in
                    else np.resize(rng.permutation(t_in), k_pad)
                    for _ in range(t)]).astype(np.int32)
    cnt = rng.integers(1, k_pad + 1, size=t).astype(np.int32)
    cnt[-1] = 0
    idx = rng.integers(-tp, (k_pad + 1) * tp, size=(t, tp, kk, 4))
    return [torch.as_tensor(a) for a in (
        rng.normal(size=(t_in, tp, c)).astype(np.float32), dep, cnt,
        idx.astype(np.int32),
        rng.uniform(size=(t, tp, kk, 4)).astype(np.float32),
        (rng.normal(size=(kk, c, o)) / np.sqrt(kk * c)).astype(np.float32),
        rng.normal(size=(o,)).astype(np.float32))]


@pytest.mark.parametrize("shape", [(3, 5, 16, 8, 8, 4), (5, 9, 4, 5, 7, 8),
                                   (4, 4, 64, 512, 512, 4)])
def test_schedule_kernel(shape):
    from repro_torch.kernels.dcn_fused import (dcn_fused_schedule,
                                               dcn_fused_schedule_plain)

    ops = _sched_operands(1, *shape)
    want = dcn_fused_schedule_plain(*ops)
    got = dcn_fused_schedule(*(a.cuda() for a in ops)).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got[-1], ops[-1].expand_as(got[-1]).contiguous())
    empty = dcn_fused_schedule(*(a[:0].cuda() if i in (1, 2, 3, 4) else
                                 a.cuda() for i, a in enumerate(ops)))
    assert empty.shape == (0, shape[2], shape[4])


@pytest.mark.parametrize("shape", [(1, 40, 16, 6, 5), (3, 256, 64, 8, 8),
                                   (1, 196, 256, 512, 512)])
def test_tile_kernel(shape):
    from repro_torch.kernels.dcn_fused import (dcn_fused_tile,
                                               dcn_fused_tile_plain)

    n, s, p, c, o = shape
    rng = np.random.default_rng(2)
    ops = [torch.as_tensor(a) for a in (
        rng.normal(size=(n, s, c)).astype(np.float32),
        rng.integers(-2, s + 3, size=(n, p, 9, 4)).astype(np.int32),
        rng.uniform(size=(n, p, 9, 4)).astype(np.float32),
        (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
        rng.normal(size=(o,)).astype(np.float32))]
    want = dcn_fused_tile_plain(*ops)
    got = dcn_fused_tile(*(a.cuda() for a in ops)).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    one = dcn_fused_tile(*(a[0].cuda() if i < 3 else a.cuda()
                           for i, a in enumerate(ops))).cpu()
    assert float((one - want[0]).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _hold_splits(fn, args, c, want):
    """``fn`` (#4 or #5) at n_split = 1, the default, 3 (an uneven cut
    where C has more than 3 chunks) and the chunk count: each within
    1e-4 * max|ref| of the plain version and within 1e-5 * max|ref| of
    n_split = 1; a second run of the default is bitwise equal. Returns the
    outputs by requested split (None = default)."""
    from repro_torch.kernels.dcn_fused import SPLIT_BC

    chunks = math.ceil(c / SPLIT_BC)
    outs = {n: fn(*args, n_split=n)
            for n in dict.fromkeys((1, None, min(3, chunks), chunks))}
    assert torch.equal(fn(*args), outs[None])
    scale = float(want.abs().max())
    for got in outs.values():
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        assert float((got - outs[1]).abs().max()) <= 1e-5 * scale
    return outs


# (T, T_in, tp = P, C, O, k_pad): full width, then C not a multiple of the
# 16-channel chunk (nor of 4) with O not a multiple of the 128-channel
# tile and P not a multiple of the 64-pixel tile, then 7 chunks (no split
# count but 1 and 7 divides them) with O not a multiple of 4, then deps
# of 1600 rows, too many to keep two chunks of in shared memory (the
# gather path).
SPLIT_SCHED_SHAPES = [(4, 4, 64, 512, 512, 4), (3, 6, 100, 37, 200, 4),
                      (5, 9, 40, 100, 130, 8), (3, 20, 100, 24, 72, 16)]


@pytest.mark.parametrize("shape", SPLIT_SCHED_SHAPES)
def test_schedule_kernel_split(shape):
    """#4 under every split: the plain version, split invariance, bitwise
    reruns, and a dep_cnt = 0 row that is exactly b (the bias is added
    once, not once a slice)."""
    from repro_torch.kernels.dcn_fused import (dcn_fused_schedule,
                                               dcn_fused_schedule_plain)

    ops = _sched_operands(5, *shape)
    want = dcn_fused_schedule_plain(*ops)
    outs = _hold_splits(dcn_fused_schedule, [a.cuda() for a in ops],
                        shape[3], want)
    bias = ops[-1].expand(shape[2], shape[4]).cuda()
    for got in outs.values():
        assert torch.equal(got[-1], bias)


# (N, S, P, C, O): a per_tile tile and the whole plane at full width, then
# the awkward shapes of SPLIT_SCHED_SHAPES, then a 1600-row halo (the
# gather path).
SPLIT_TILE_SHAPES = [(1, 256, 64, 512, 512), (1, 196, 256, 512, 512),
                     (2, 150, 100, 37, 200), (3, 50, 40, 100, 130),
                     (2, 1600, 64, 48, 136)]


@pytest.mark.parametrize("shape", SPLIT_TILE_SHAPES)
def test_tile_kernel_split(shape):
    """#5 under every split: the plain version, split invariance and
    bitwise reruns."""
    from repro_torch.kernels.dcn_fused import (dcn_fused_tile,
                                               dcn_fused_tile_plain)

    n, s, p, c, o = shape
    rng = np.random.default_rng(6)
    ops = [torch.as_tensor(a) for a in (
        rng.normal(size=(n, s, c)).astype(np.float32),
        rng.integers(-2, s + 3, size=(n, p, 9, 4)).astype(np.int32),
        rng.uniform(size=(n, p, 9, 4)).astype(np.float32),
        (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
        rng.normal(size=(o,)).astype(np.float32))]
    _hold_splits(dcn_fused_tile, [a.cuda() for a in ops], c,
                 dcn_fused_tile_plain(*ops))


def test_split_launch_grid():
    """The launched grid is the policy's at the three full-width shapes
    (#5 per tile, #5 whole plane, #4)."""
    from repro_torch.kernels.dcn_fused import (dcn_fused_schedule,
                                               dcn_fused_tile, fused_grid,
                                               fused_splits)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, s, p in ((1, 256, 64), (1, 196, 256)):
        x = torch.zeros((n, s, 512), device="cuda")
        idx = torch.zeros((n, p, 9, 4), dtype=torch.int32, device="cuda")
        dcn_fused_tile(x, idx, idx.float(), torch.zeros((9, 512, 512),
                       device="cuda"), torch.zeros(512, device="cuda"))
        assert dcn_fused_tile.last_grid == fused_grid(
            n, p, 512, fused_splits(n, p, 512, 512, sms))
    ops = [a.cuda() for a in _sched_operands(5, *SPLIT_SCHED_SHAPES[0])]
    dcn_fused_schedule(*ops)
    assert dcn_fused_schedule.last_grid == fused_grid(
        4, 64, 512, fused_splits(4, 64, 512, 512, sms))


# The BLI kernel (#6): (N, S, P, C, index range beyond [0, S)). Held to
# its plain version within 1e-6 * max|ref| in float32 and 2**-7 * max|ref|
# (one bf16 ulp at the largest output) in bfloat16, and bitwise equal to
# itself on a rerun.
BLI_GPU_CASES = [
    (1, 20, 16, 8, 2),
    (2, 196, 1792, 512, 2),
    (4, 196, 1792, 512, 2),      # a serving step
    (1, 3136, 1024, 256, 2),     # a 56x56 plane
    (1, 9, 8, 6, 2),             # rows not 16-byte aligned
    (2, 30, 64, 20, 2),          # 20 bf16: not aligned
    (1, 40, 2048, 64, 60),       # most indices out of range
    (1, 64, 8192, 256, 2),       # long P over few rows of x
]


def _bli_case(n, s, p, c, spill, dtype):
    rng = np.random.default_rng(n + s + p + c)
    x = torch.as_tensor(rng.normal(size=(n, s, c)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-spill, s + spill, size=(n, p, 4))
                          .astype(np.int32))
    cf = torch.as_tensor(rng.uniform(size=(n, p, 4)).astype(np.float32))
    return x.to(dtype), idx, cf


def _hold_bli(got, want, dtype):
    tol = 1e-6 if dtype == torch.float32 else 2**-7
    assert got.dtype == dtype
    assert float((got.float().cpu() - want).abs().max()) <= \
        tol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLI_GPU_CASES)
def test_bli_kernel(shape, dtype):
    from repro_torch.kernels.dcn_bli import bli_tile_matmul, bli_tile_plain

    n, s, p, c, spill = shape
    x, idx, cf = _bli_case(n, s, p, c, spill, dtype)
    ops = (x.cuda(), idx.cuda(), cf.cuda())
    launches = bli_tile_matmul.launches
    got = bli_tile_matmul(*ops, block_p=p, block_c=c)
    assert bli_tile_matmul.launches == launches + 1
    _hold_bli(got, bli_tile_plain(x, idx, cf).float(), dtype)
    assert torch.equal(bli_tile_matmul(*ops, block_p=p, block_c=c), got)


# Flash attention (#7): (B, Sq, Skv, Hq, Hkv, D, options). Within
# 1e-4 * max|ref| of the plain version (float32 sums in another order).
FLASH_GPU_CASES = [
    (2, 128, 128, 4, 4, 64, {}),
    (1, 200, 200, 16, 8, 128, {}),
    (1, 77, 300, 8, 2, 128, {}),                       # ragged Sq < Skv
    (2, 1, 90, 4, 2, 64, {}),
    (1, 300, 300, 4, 2, 144, dict(window=64, softcap=50.0)),
    (1, 150, 150, 4, 2, 144, dict(window=17)),
    (1, 130, 130, 4, 4, 64, dict(softcap=5.0)),
    (1, 64, 140, 4, 2, 20, dict(causal=False)),
    (1, 100, 60, 4, 2, 32, {}),                        # Sq > Skv: empty rows
    # Head dims off the configs' (zero-padded to a multiple of 16).
    (1, 96, 96, 4, 2, 8, {}),
    (1, 100, 100, 4, 2, 36, dict(window=30)),
    (2, 70, 70, 4, 4, 72, dict(softcap=20.0)),
    (1, 90, 150, 4, 1, 100, {}),
    # Lengths around the 32-key tile and the 64-row warpgroup.
    (1, 63, 63, 4, 2, 128, {}),
    (1, 64, 64, 4, 2, 64, {}),
    (1, 65, 65, 4, 2, 144, {}),
    (1, 127, 127, 4, 2, 128, dict(window=40)),
    (2, 129, 129, 4, 2, 128, {}),
    # Query heads per kv head.
    (1, 100, 100, 4, 4, 128, {}),
    (1, 100, 100, 8, 2, 64, {}),
    (1, 100, 100, 16, 2, 128, dict(softcap=30.0)),
    # Non-causal over a ragged key count (cross-attention over image
    # tokens): Sq > Skv, and Sq < Skv, at D 128 and 4 query heads a kv head.
    (1, 300, 201, 8, 2, 128, dict(causal=False)),
    (2, 130, 97, 32, 8, 128, dict(causal=False)),
    (1, 77, 250, 8, 2, 128, dict(causal=False)),
]


@pytest.mark.parametrize("case", range(len(FLASH_GPU_CASES)))
def test_flash_attention_kernel(case):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    b, sq, skv, hq, hkv, d, opts = FLASH_GPU_CASES[case]
    rng = np.random.default_rng(20 + case)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    want = flash_attention_plain(q, k, v, scale=d ** -0.5, **opts)
    got = flash_attention(q.cuda(), k.cuda(), v.cuda(), **opts).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_flash_attention_kernel_reruns_bitwise():
    """#7 sums in a fixed order (no atomics): a rerun is bitwise equal."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(40)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32)).cuda()
               for s in ((2, 300, 16, 128), (2, 300, 8, 128),
                         (2, 300, 8, 128)))
    first = flash_attention(q, k, v)
    assert torch.equal(flash_attention(q, k, v), first)


def _decode_operands(seed, b, s, hq, hkv, d, lengths):
    rng = np.random.default_rng(seed)
    q, kc, vc = (torch.as_tensor(rng.normal(size=sh).astype(np.float32))
                 for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    return q, kc, vc, torch.as_tensor(np.asarray(lengths, np.int32))


@pytest.mark.parametrize("opts", [{}, dict(window=100), dict(softcap=30.0),
                                  dict(window=40, softcap=50.0)])
@pytest.mark.parametrize("dims", [(4, 512, 16, 8, 128), (2, 700, 32, 16, 144),
                                  (3, 300, 15, 5, 64)])
def test_flash_decode_kernel(dims, opts):
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)

    b, s, hq, hkv, d = dims
    lengths = [1, s, s // 3, s + 5][:b]                # s + 5 counts as s
    ops = _decode_operands(7, b, s, hq, hkv, d, lengths)
    want = flash_decode_plain(*ops, scale=d ** -0.5, **opts)
    got = flash_decode(*(t.cuda() for t in ops), **opts).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_flash_decode_kernel_over_a_full_cross_cache():
    """#8 as a cross layer decodes: every row of a 201-row cache (a
    multiple of neither the 64-key split floor nor a tile) visible in
    every sequence, 4 query heads a kv head, D 128."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)

    ops = _decode_operands(63, 4, 201, 32, 8, 128, [201] * 4)
    want = flash_decode_plain(*ops, scale=128 ** -0.5)
    got = flash_decode(*(t.cuda() for t in ops)).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_flash_decode_split_invariance():
    """The split-KV reduction is exact: the split count moves only the
    float32 summation order (1e-5 * max|out|)."""
    from repro_torch.kernels.flash_decode import flash_decode

    ops = [t.cuda() for t in _decode_operands(9, 3, 2048, 16, 8, 128,
                                              [2048, 1000, 5])]
    outs = [flash_decode(*ops, num_splits=n) for n in (1, 3, 16, 64)]
    scale = float(outs[0].abs().max())
    for o in outs[1:]:
        assert float((o - outs[0]).abs().max()) <= 1e-5 * scale


# Ragged decode lengths: none visible, one key, around the 64-key split
# floor, the whole cache and past it.
RAGGED_LENGTHS = [0, 1, 63, 64, 65, 512, 600]


@pytest.mark.parametrize("opts", [{}, dict(window=100), dict(softcap=30.0),
                                  dict(window=40, softcap=50.0)])
@pytest.mark.parametrize("lengths", [RAGGED_LENGTHS, [1, 17, 64, 40]])
def test_flash_decode_ragged_splits(lengths, opts):
    """#8 on ragged lengths (and on a batch whose lengths are all <= 64,
    the serving shape's first steps): the plain version within 1e-4 *
    max|ref|, 1 vs the default vs 64 splits within 1e-5 * max|ref|, and
    bitwise-equal reruns (the tickets are left at zero)."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)

    b, s, hq, hkv, d = len(lengths), 512, 16, 8, 128
    ops = _decode_operands(11, b, s, hq, hkv, d, lengths)
    want = flash_decode_plain(*ops, scale=d ** -0.5, **opts)
    args = [t.cuda() for t in ops]
    outs = {n: flash_decode(*args, num_splits=n, **opts)
            for n in (1, None, 64)}
    scale = float(want.abs().max())
    for got in outs.values():
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
        assert float((got - outs[1]).abs().max()) <= 1e-5 * scale
    for i, n in enumerate(lengths):
        if n <= 0:
            assert not outs[None][i].any()
    assert torch.equal(flash_decode(*args, **opts), outs[None])
    assert torch.equal(flash_decode(*args, num_splits=64, **opts), outs[64])


# ---------------------------------------------------------------------------
# bf16: #7's bf16 kernel, #8 over a bf16 cache
# ---------------------------------------------------------------------------

# Two bf16 ulps at the largest output: both sides compute in float32 and
# round the output once; the kernel also rounds P to bf16 for P V.
BF16_RTOL = 2.0 ** -7

# (B, Sq, Skv, Hq, Hkv, D, options) of #7 in bf16: head dims 64 / 128 /
# 144, 1-4 query heads a kv head, causal, non-causal over ragged key counts
# above and below Sq, window, soft-cap, and lengths around the 64-row
# warpgroup. The cases after the first twelve probe the TMA ring of
# 64-key tiles: key counts at block_k +- 1 (63, 65 above), 2 block_k +- 1
# and 4 block_k + 1, more keys than the ring's 4 stages hold (600 / 700 /
# 1000), head dims 80 / 112 (32 B swizzle) and 96 (64 B), windows below
# one tile, warpgroups of one block that see different tiles (one fewer
# at the end, one skipped at the start), a block with no rows for its
# second warpgroup, and causal rows with no visible key at all.
FLASH_BF16_CASES = [
    (2, 200, 200, 4, 4, 64, {}),
    (2, 300, 300, 8, 4, 128, {}),
    (1, 129, 129, 6, 2, 144, {}),
    (1, 257, 257, 8, 2, 128, dict(window=77)),
    (1, 150, 150, 4, 2, 144, dict(window=33, softcap=50.0)),
    (1, 130, 130, 4, 1, 64, dict(softcap=5.0)),
    (1, 100, 333, 4, 2, 64, {}),                       # causal, Sq < Skv
    (1, 300, 201, 8, 2, 128, dict(causal=False)),      # Sq > Skv
    (2, 77, 250, 8, 2, 128, dict(causal=False)),       # Sq < Skv
    (1, 63, 63, 4, 2, 128, {}),
    (1, 65, 65, 4, 2, 144, {}),
    (2, 129, 129, 4, 2, 128, dict(window=64)),
    (1, 127, 127, 4, 2, 128, {}),
    (1, 64, 129, 4, 2, 128, dict(causal=False)),
    (1, 100, 257, 8, 2, 128, dict(causal=False)),
    (1, 1000, 1000, 4, 1, 128, {}),
    (1, 300, 700, 4, 2, 144, dict(causal=False)),
    (1, 600, 600, 4, 2, 64, dict(softcap=30.0)),
    (1, 200, 300, 4, 2, 80, {}),
    (2, 150, 150, 4, 2, 96, dict(window=100)),
    (1, 333, 333, 6, 3, 112, dict(softcap=20.0)),
    (1, 400, 400, 4, 2, 128, dict(window=5)),
    (1, 192, 256, 4, 2, 128, {}),
    (1, 300, 300, 4, 2, 128, dict(window=40)),
    (1, 60, 60, 4, 2, 128, {}),
    (1, 300, 100, 4, 2, 64, {}),
]


def _bf16_normal(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _within(got, want, rtol):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("case", range(len(FLASH_BF16_CASES)))
def test_flash_attention_bf16_kernel(case):
    """#7 on bf16 operands: a bf16 output within two bf16 ulps of the
    plain version's (the same values, float32 math), one launch of the
    bf16 kernel, and a bitwise-equal rerun."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, hq, hkv, d, opts = FLASH_BF16_CASES[case]
    rng = np.random.default_rng(70 + case)
    q, k, v = (_bf16_normal(rng, *s).cuda()
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **opts)
    fa.flash_attention.dtypes = {}
    got = fa.flash_attention(q, k, v, **opts)
    assert got.dtype == torch.bfloat16
    assert fa.flash_attention.dtypes == {"bfloat16": 1}
    _within(got, want, BF16_RTOL)
    assert torch.equal(fa.flash_attention(q, k, v, **opts), got)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mixed_operands_widen_exactly(q_dtype):
    """A q of one dtype over k, v of the other runs the float32 kernel on
    the widened (exact) operands and returns q's dtype: the float32
    kernel's bound for a float32 output, one bf16 rounding for a bf16
    one."""
    from repro_torch.kernels import flash_attention as fa

    other = torch.bfloat16 if q_dtype == torch.float32 else torch.float32
    rng = np.random.default_rng(90)
    q = _bf16_normal(rng, 2, 90, 8, 128).to(q_dtype).cuda()
    k, v = (_bf16_normal(rng, 2, 201, 2, 128).to(other).cuda()
            for _ in range(2))
    want = fa.flash_attention_plain(q, k, v, causal=False,
                                    scale=128 ** -0.5)
    fa.flash_attention.dtypes = {}
    got = fa.flash_attention(q, k, v, causal=False)
    assert got.dtype == q_dtype and fa.flash_attention.dtypes == {
        "float32": 1}
    _within(got, want, 1e-4 if q_dtype == torch.float32 else BF16_RTOL)


def _bf16_cache_operands(seed, b, s, hq, hkv, d, lengths, q_dtype):
    rng = np.random.default_rng(seed)
    q = _bf16_normal(rng, b, hq, d).to(q_dtype)
    kc, vc = (_bf16_normal(rng, b, s, hkv, d) for _ in range(2))
    return [t.cuda() for t in (q, kc, vc, torch.as_tensor(np.asarray(
        lengths, np.int32)))]


@pytest.mark.parametrize("opts", [{}, dict(window=100), dict(softcap=30.0),
                                  dict(window=40, softcap=50.0)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_over_a_bf16_cache(q_dtype, opts):
    """#8 reading a bf16 cache as stored, under a float32 q (the float32
    result on the widened cache: 1e-4 * max|ref|) and a bf16 q (two bf16
    ulps), at ragged lengths (none visible, one key, around the 64-key
    split floor, the whole cache and past it) and 1 / default / 64
    splits, each within the bound; a sequence with no visible key gives 0
    and a rerun is bitwise equal."""
    from repro_torch.kernels import flash_decode as fd

    b, s, hq, hkv, d = len(RAGGED_LENGTHS), 512, 16, 8, 128
    ops = _bf16_cache_operands(12, b, s, hq, hkv, d, RAGGED_LENGTHS, q_dtype)
    want = fd.flash_decode_plain(*ops, scale=d ** -0.5, **opts)
    rtol = 1e-4 if q_dtype == torch.float32 else BF16_RTOL
    fd.flash_decode.dtypes = {}
    outs = {n: fd.flash_decode(*ops, num_splits=n, **opts)
            for n in (1, None, 64)}
    key = f"{str(q_dtype).removeprefix('torch.')}/bfloat16"
    assert fd.flash_decode.dtypes == {key: 3}
    for got in outs.values():
        assert got.dtype == q_dtype
        _within(got, want, rtol)
    for i, n in enumerate(RAGGED_LENGTHS):
        if n <= 0:
            assert not outs[None][i].any()
    assert torch.equal(fd.flash_decode(*ops, **opts), outs[None])


def test_flash_decode_bf16_cache_equals_the_upcast_cache():
    """Over a bf16 cache, #8 under a float32 q gives the float32 kernel's
    result on the upcast cache, up to float32 summation order (the
    widening is exact)."""
    from repro_torch.kernels import flash_decode as fd

    q, kc, vc, lens = _bf16_cache_operands(13, 4, 1601, 32, 8, 128,
                                           [1601] * 4, torch.float32)
    got = fd.flash_decode(q, kc, vc, lens)
    want = fd.flash_decode(q, kc.float(), vc.float(), lens)
    _within(got, want, 1e-5)


@pytest.mark.parametrize("d", [64, 128, 144])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_flash_decode_bf16_cluster_kernel(g, d):
    """#8's cluster kernel over a bf16 cache at g query heads a kv head
    and head dim d, under a float32 q (1e-4 * max|ref|) and a bf16 q (two
    bf16 ulps), on lengths around a 32-key stage, the whole cache and past
    it; a rerun is bitwise equal."""
    from repro_torch.kernels import flash_decode as fd

    lengths = [1, 31, 33, 160, 300, 305]
    for q_dtype, rtol in ((torch.float32, 1e-4),
                          (torch.bfloat16, BF16_RTOL)):
        ops = _bf16_cache_operands(70 + g + d, len(lengths), 300, 2 * g, 2,
                                   d, lengths, q_dtype)
        want = fd.flash_decode_plain(*ops, scale=d ** -0.5)
        got = fd.flash_decode(*ops)
        assert got.dtype == q_dtype
        _within(got, want, rtol)
        assert torch.equal(fd.flash_decode(*ops), got)


@pytest.mark.parametrize("opts", [{}, dict(window=100), dict(softcap=30.0),
                                  dict(window=40, softcap=50.0)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_bf16_stage_and_cluster_edges(q_dtype, opts):
    """#8's cluster kernel at lengths 0, 1, around a stage and around the
    keys that give every block of a cluster one stage, S and past S, with
    1, the default and 64 splits: each within the bound of its q, the
    split counts within 1e-5 * max|ref| of each other under a float32 q
    (a bf16 output rounds each), no visible key gives 0, and a rerun is
    bitwise equal."""
    from repro_torch.kernels import flash_decode as fd

    b, s, hq, hkv, d = 10, 512, 16, 4, 128
    edge = fd.cluster_size(b, hkv, s) * fd.STAGE_KEYS
    lengths = [0, 1, 31, 32, 33, edge - 1, edge, edge + 1, s, s + 7]
    ops = _bf16_cache_operands(15, b, s, hq, hkv, d, lengths, q_dtype)
    want = fd.flash_decode_plain(*ops, scale=d ** -0.5, **opts)
    rtol = 1e-4 if q_dtype == torch.float32 else BF16_RTOL
    outs = {n: fd.flash_decode(*ops, num_splits=n, **opts)
            for n in (1, None, 64)}
    for got in outs.values():
        _within(got, want, rtol)
        if q_dtype == torch.float32:
            assert float((got - outs[1]).abs().max()) <= 1e-5 * float(
                want.abs().max())
    assert not outs[None][0].any() and not outs[64][0].any()
    for n in (None, 64):
        assert torch.equal(fd.flash_decode(*ops, num_splits=n, **opts),
                           outs[n])


@pytest.mark.parametrize("opts", [{}, dict(window=5000, softcap=30.0),
                                  dict(num_splits=64)])
@pytest.mark.parametrize("d", [64, 128, 144])
def test_flash_decode_bf16_long_cache(d, opts):
    """A cache long enough that a block streams 1024 keys or more, where
    the kernel copies by TMA into its swizzled panels: within the bound of
    each q against the plain version, no visible key gives 0, a rerun is
    bitwise equal."""
    from repro_torch.kernels import flash_decode as fd

    lengths = [12000, 7001, 130, 0]
    kw = {k: v for k, v in opts.items() if k != "num_splits"}
    for q_dtype, rtol in ((torch.float32, 1e-4),
                          (torch.bfloat16, BF16_RTOL)):
        ops = _bf16_cache_operands(17 + d, 4, 12000, 8, 2, d, lengths,
                                   q_dtype)
        want = fd.flash_decode_plain(*ops, scale=d ** -0.5, **kw)
        got = fd.flash_decode(*ops, **opts)
        _within(got, want, rtol)
        assert not got[3].any()
        assert torch.equal(fd.flash_decode(*ops, **opts), got)


def test_flash_decode_bf16_replays_in_a_cuda_graph():
    """A bf16-cache #8 launch captured in a CUDA graph (no scratch, no
    ticket: nothing to warm) replays bitwise equal to the eager call, and
    reads ``lengths`` on the card at each replay."""
    from repro_torch.kernels import flash_decode as fd

    ops = _bf16_cache_operands(16, 4, 1601, 32, 8, 128, [1601, 900, 37, 0],
                               torch.bfloat16)
    eager = fd.flash_decode(*ops)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fd.flash_decode(*ops)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(*ops)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    ops[3].copy_(torch.tensor([5, 1601, 640, 1], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fd.flash_decode(*ops))


def test_attention_decode_hands_the_stored_cache_to_the_kernel(monkeypatch):
    """On the card ``attention_decode`` (self and cross layers) hands #8
    the cache tensors themselves, a bf16 cache under float32 activations
    included: no ``.to(x.dtype)`` copy."""
    from repro_torch.models import layers

    seen = []
    orig = layers.flash_decode

    def recording(q, k_cache, v_cache, lengths, **kw):
        seen.append((k_cache.data_ptr(), v_cache.data_ptr(), q.dtype,
                     k_cache.dtype))
        return orig(q, k_cache, v_cache, lengths, **kw)

    monkeypatch.setattr(layers, "flash_decode", recording)
    rng = np.random.default_rng(14)
    for cross in (False, True):
        cfg = layers.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2,
                                head_dim=16, cross=cross,
                                d_cross=32 if cross else None)
        d_kv = 32 if cross else 64
        p = {"wq": rng.normal(size=(64, 4, 16)), "wk": rng.normal(
            size=(d_kv, 2, 16)), "wv": rng.normal(size=(d_kv, 2, 16)),
            "wo": rng.normal(size=(4, 16, 64))}
        for x_dtype in (torch.float32, torch.bfloat16):
            pt = {n: torch.as_tensor(a.astype(np.float32) * 0.2).to(
                x_dtype).cuda() for n, a in p.items()}
            cache = layers.init_kv_cache(cfg, 2, 40, dtype=torch.bfloat16,
                                         device="cuda")
            cache["k"].normal_()
            cache["v"].normal_()
            x = torch.randn(2, 1, 64, device="cuda").to(x_dtype)
            pos = torch.tensor([3, 17], dtype=torch.int32, device="cuda")
            seen.clear()
            out, back = layers.attention_decode(pt, cfg, x, cache, pos)
            assert back is cache and out.dtype == x_dtype
            assert seen == [(cache["k"].data_ptr(), cache["v"].data_ptr(),
                             x_dtype, torch.bfloat16)]


def test_llama_vision_smoke_in_bf16_on_the_card():
    """llama-3.2-vision smoke with bf16 params and bf16 image states on
    the card: ``lm_prefill(use_flash=True)`` runs #7's bf16 kernel once a
    layer (the cross layer non-causally), and 8 teacher-forced
    ``lm_decode_step``s over a bf16 cache (the cross cache filled by
    ``build_cross_cache``) run #8 once a layer and step on bf16 q and
    cache; logits within 3e-2 * max|ref| of the same model on the CPU (the
    plain versions; whole-model bf16 rounding, as in
    ``tests/test_torch_bf16.py``); a ``cache_dtype=bfloat16``
    ``DecodeEngine`` then serves three requests on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine, Request

    cfg = dataclasses.replace(
        configs.get_config("llama-3.2-vision-11b", smoke=True),
        use_flash=True)
    params = lm.init_lm(cfg, 0, device="cpu", dtype=torch.bfloat16)
    on_card = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(65)
    states = _bf16_normal(rng, 2, cfg.n_cross_tokens, cfg.d_cross)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 37))
                           .astype(np.int32))
    flash_attention.launches, flash_attention.dtypes = 0, {}
    got = lm.lm_prefill(on_card, cfg, {"tokens": toks.cuda(),
                                       "cross_states": states.cuda()})
    assert flash_attention.launches == cfg.n_layers
    assert flash_attention.dtypes == {"bfloat16": cfg.n_layers}
    _within(got, lm.lm_prefill(params, cfg, {"tokens": toks,
                                             "cross_states": states}), 3e-2)

    caches = {}
    for p, dev in ((params, "cpu"), (on_card, "cuda")):
        c = lm.init_cache(cfg, 2, 16, dtype=torch.bfloat16, device=dev)
        caches[dev] = lm.build_cross_cache(p, cfg, c, states.to(dev))
    pos = np.array([0, 4], np.int32)
    flash_decode.launches, flash_decode.dtypes = 0, {}
    for _ in range(8):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 1))
                              .astype(np.int32))
        want, _ = lm.lm_decode_step(params, cfg, caches["cpu"], tok,
                                    torch.as_tensor(pos))
        got, _ = lm.lm_decode_step(on_card, cfg, caches["cuda"], tok.cuda(),
                                   torch.as_tensor(pos).cuda())
        _within(got, want, 3e-2)
        pos = pos + 1
    assert flash_decode.dtypes == {"bfloat16/bfloat16": 8 * cfg.n_layers}

    eng = DecodeEngine(on_card, cfg, batch=2, max_len=24,
                       cache_dtype=torch.bfloat16, device="cuda")
    eng.cache = lm.build_cross_cache(on_card, cfg, eng.cache, states.cuda())
    for rid, n in enumerate((5, 2, 9)):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, size=n).tolist(), max_new=6))
    flash_decode.launches = 0
    done = eng.run()
    assert len(done) == 3 and all(len(r.out) == 6 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)
    assert flash_decode.launches == cfg.n_layers * eng.steps > 0


def _bf16_fused_case(which, shape):
    """(wrapper, plain version, operands with x, w and b rounded to bf16
    and the coefficients float32, extra keyword arguments, C) for #1, #4
    or #5 at one of the split shapes above."""
    from repro_torch.kernels import dcn_fused as kf

    if which == "batch":
        ops = _batch_operands(8, *shape)
        fns, kw, c = (kf.dcn_fused_batch, kf.dcn_fused_batch_plain), dict(
            t_in=shape[1]), shape[3]
    elif which == "schedule":
        ops = _sched_operands(5, *shape)
        fns, kw, c = (kf.dcn_fused_schedule, kf.dcn_fused_schedule_plain), \
            {}, shape[3]
    else:
        n, s, p, c, o = shape
        rng = np.random.default_rng(6)
        ops = [torch.as_tensor(a) for a in (
            rng.normal(size=(n, s, c)).astype(np.float32),
            rng.integers(-2, s + 3, size=(n, p, 9, 4)).astype(np.int32),
            rng.uniform(size=(n, p, 9, 4)).astype(np.float32),
            (rng.normal(size=(9, c, o)) / np.sqrt(9 * c)).astype(np.float32),
            rng.normal(size=(o,)).astype(np.float32))]
        fns, kw = (kf.dcn_fused_tile, kf.dcn_fused_tile_plain), {}
    ops = [a.to(torch.bfloat16) if i in (0, len(ops) - 2, len(ops) - 1)
           else a for i, a in enumerate(ops)]
    return (*fns, ops, kw, c)


BF16_FUSED_CASES = ([("batch", s) for s in SPLIT_BATCH_SHAPES]
                    + [("schedule", s) for s in SPLIT_SCHED_SHAPES]
                    + [("tile", s) for s in SPLIT_TILE_SHAPES])


@pytest.mark.parametrize("case", range(len(BF16_FUSED_CASES)))
def test_fused_kernels_in_bf16(case):
    """#1, #4 and #5 on bf16 x, w and b (float32 coefficients), at the
    full-width shapes and the awkward ones (C not a multiple of 8 or 4, O
    not a multiple of 8, the gather path): a bf16 output within two bf16
    ulps of the plain version's (float32 inside, one rounding) at n_split
    = 1, the default and the bf16 body's chunk count, one bf16 launch
    each, a bitwise rerun, and a dep_cnt = 0 row that is exactly b."""
    from repro_torch.kernels.dcn_fused import BF16_BC

    fn, plain, ops, kw, c = _bf16_fused_case(*BF16_FUSED_CASES[case])
    want = plain(*ops, **kw)
    assert want.dtype == torch.bfloat16
    args = [a.cuda() for a in ops]
    fn.dtypes = {}
    splits = list(dict.fromkeys((1, None, math.ceil(c / BF16_BC))))
    outs = {n: fn(*args, **kw, n_split=n) for n in splits}
    assert fn.dtypes == {"bfloat16": len(splits)}
    for got in outs.values():
        assert got.dtype == torch.bfloat16
        _within(got, want, BF16_RTOL)
    assert torch.equal(fn(*args, **kw), outs[None])
    if BF16_FUSED_CASES[case][0] != "tile":       # the dep_cnt = 0 row
        for got in outs.values():
            assert torch.equal(got[-1], args[-1].expand_as(got[-1]))


@pytest.mark.parametrize("which", ["batch", "schedule", "tile"])
def test_fused_kernels_widen_mixed_operands(which):
    """x bf16 under float32 w and b (and the reverse): the wrapper widens
    to the float32 kernel (exact) and rounds the result once to x's
    dtype."""
    shape = {"batch": SPLIT_BATCH_SHAPES[0], "schedule": SPLIT_SCHED_SHAPES[0],
             "tile": SPLIT_TILE_SHAPES[0]}[which]
    fn, plain, ops, kw, _ = _bf16_fused_case(which, shape)
    for x_dtype, wb_dtype in ((torch.bfloat16, torch.float32),
                              (torch.float32, torch.bfloat16)):
        mixed = [a.to(x_dtype) if i == 0 else
                 a.to(wb_dtype) if i >= len(ops) - 2 else a
                 for i, a in enumerate(ops)]
        fn.dtypes = {}
        got = fn(*(a.cuda() for a in mixed), **kw)
        assert got.dtype == x_dtype and fn.dtypes == {"float32": 1}
        _within(got, plain(*mixed, **kw),
                BF16_RTOL if x_dtype == torch.bfloat16 else 1e-4)


def _bf16_hold(fn, plain, args, kw, want, **call):
    """One bf16 call within two bf16 ulps of the plain version's result,
    bitwise equal on a rerun and launched once in bf16; -> the result."""
    fn.dtypes = {}
    got = fn(*args, **kw, **call)
    assert got.dtype == torch.bfloat16 and fn.dtypes == {"bfloat16": 1}
    _within(got, want, BF16_RTOL)
    assert torch.equal(fn(*args, **kw, **call), got)
    return got


# (which, shape) of the bf16 body's copy paths: C and O whose rows are
# whole 16-byte copies (TMA boxes for w and the halo) against C and O
# whose rows are not (the producer warp copies value by value).
BF16_COPY_CASES = [("batch", (2, 4, 64, 64, 128, 4)),
                   ("batch", (2, 4, 64, 60, 124, 4)),
                   ("schedule", (3, 5, 64, 96, 256, 4)),
                   ("schedule", (3, 5, 64, 90, 250, 4)),
                   ("tile", (2, 120, 64, 64, 192)),
                   ("tile", (2, 120, 64, 66, 190))]


@pytest.mark.parametrize("case", range(len(BF16_COPY_CASES)))
def test_bf16_body_copy_paths(case):
    """The TMA and the value-by-value copies give the plain version's
    result (within two bf16 ulps, bitwise reruns) at n_split 1 and the
    default, and a dep_cnt = 0 row that is exactly b."""
    which, shape = BF16_COPY_CASES[case]
    fn, plain, ops, kw, c = _bf16_fused_case(which, shape)
    want = plain(*ops, **kw)
    args = [a.cuda() for a in ops]
    for n in (1, None):
        got = _bf16_hold(fn, plain, args, kw, want, n_split=n)
        if which != "tile":
            assert torch.equal(got[-1], args[-1].expand_as(got[-1]))


@pytest.mark.parametrize("which", ["batch", "schedule", "tile"])
def test_bf16_body_at_a_base_off_16_bytes(which):
    """x and w whose first value sits 2 bytes past a 16-byte boundary
    (TMA refuses such a base): the value-by-value copies, the plain
    version's result."""
    shape = {"batch": (2, 4, 64, 64, 128, 4),
             "schedule": (3, 5, 64, 96, 256, 4),
             "tile": (2, 120, 64, 64, 192)}[which]
    fn, plain, ops, kw, _ = _bf16_fused_case(which, shape)
    want = plain(*ops, **kw)
    args = [a.cuda() for a in ops]
    for i in (0, len(args) - 2):           # x and w, one value in
        buf = torch.empty(args[i].numel() + 1, dtype=torch.bfloat16,
                          device="cuda")
        moved = buf[1:].view(args[i].shape)
        moved.copy_(args[i])
        assert moved.data_ptr() % 16 == 2
        args[i] = moved
    _bf16_hold(fn, plain, args, kw, want)


# (C, n_split) of #1 in bf16: C = 32 n channels in n slices, a cluster of
# every size 1-8, then slices past one cluster (16 slices: two clusters of
# 8; 11: two clusters of 6, the last block of the second with no slice),
# whose clusters' sums meet in the workspace.
BF16_CLUSTER_CASES = [(32 * n, n) for n in range(1, 9)] + [(512, 16),
                                                           (352, 11)]


@pytest.mark.parametrize("c,n_split", BF16_CLUSTER_CASES)
def test_bf16_body_cluster_sizes(c, n_split):
    """#1 in bf16 at every cluster size and at splits past one cluster:
    the plain version's result, bitwise reruns (the workspace's clusters
    added in a fixed order, whichever finishes last), the grid of
    ``fused_grid_bf16``, a dep_cnt = 0 row that is exactly b."""
    from repro_torch.kernels import dcn_fused as kf

    shape = (2, 4, 64, c, 256, 4)
    fn, plain, ops, kw, _ = _bf16_fused_case("batch", shape)
    want = plain(*ops, **kw)
    args = [a.cuda() for a in ops]
    got = _bf16_hold(fn, plain, args, kw, want, n_split=n_split)
    assert len(kf.bf16_slices(c, 9, n_split)) == n_split
    assert fn.last_grid == kf.fused_grid_bf16(8, 64, 256, n_split)
    cluster, groups = kf.fused_cluster(n_split)
    assert cluster <= 8 and fn.last_grid[0] == cluster * groups
    assert torch.equal(got[-1], args[-1].expand_as(got[-1]))


def test_bf16_body_cluster_capacity():
    """The card's cluster capacity (cudaOccupancyMaxActiveClusters) falls
    with the cluster size and the default splits of #1, #4 and #5 at full
    width run their clusters in one wave."""
    from repro_torch.kernels import dcn_fused as kf

    cap = kf.card_clusters(torch.device("cuda", 0))
    assert sorted(cap) == list(range(1, kf.MAX_CLUSTER + 1))
    assert all(cap[k] >= cap[k + 1] >= 1 for k in range(1, kf.MAX_CLUSTER))
    for rows, p in ((16, 64), (4, 64), (1, 64), (1, 256)):
        n = kf.fused_splits(rows, p, 512, 512, dtype=torch.bfloat16,
                            clusters=cap)
        blocks, o_blocks, pairs = kf.fused_grid_bf16(rows, p, 512, n)
        cluster, groups = kf.fused_cluster(n)
        assert blocks == cluster * groups
        assert o_blocks * pairs * groups <= cap[cluster]


@pytest.mark.parametrize("opts", [{}, dict(window=100, softcap=30.0)])
def test_flash_decode_rounds_a_float32_cache(opts):
    """``round_kv=torch.bfloat16`` over a float32 cache under a bf16 q:
    within two bf16 ulps of the plain version's (which rounds the cache to
    bf16 first) and of the kernel over the cache cast to bf16; a float32
    cache of bf16 values gives the unrounded call's result bitwise; and
    a cache within 0.2 ulp of bf16 values under a float32 q gives the bf16
    cache's result within 1e-5, where the unrounded read moves it by
    more."""
    from repro_torch.kernels import flash_decode as fd

    b, s, hq, hkv, d = len(RAGGED_LENGTHS), 512, 16, 8, 128
    q, kc, vc, lens = (t.cuda() for t in _decode_operands(
        15, b, s, hq, hkv, d, RAGGED_LENGTHS))
    q = q.to(torch.bfloat16)
    want = fd.flash_decode_plain(q, kc, vc, lens, scale=d ** -0.5,
                                 round_kv=torch.bfloat16, **opts)
    fd.flash_decode.dtypes = {}
    got = fd.flash_decode(q, kc, vc, lens, round_kv=torch.bfloat16, **opts)
    assert got.dtype == torch.bfloat16
    assert fd.flash_decode.dtypes == {"bfloat16/float32": 1}
    _within(got, want, BF16_RTOL)
    _within(got, fd.flash_decode(q, kc.to(torch.bfloat16),
                                 vc.to(torch.bfloat16), lens, **opts),
            BF16_RTOL)
    kr, vr = kc.to(torch.bfloat16).float(), vc.to(torch.bfloat16).float()
    assert torch.equal(fd.flash_decode(q, kr, vr, lens, round_kv=torch.bfloat16,
                                       **opts),
                       fd.flash_decode(q, kr, vr, lens, **opts))
    # Under a float32 q, a cache within 0.2 bf16 ulp of bf16 values: the
    # rounded read gives the bf16 cache's float32 result, the unrounded
    # read does not.
    qf = q.float()
    ulp = torch.ldexp(torch.ones_like(kr), torch.floor(torch.log2(
        kr.abs())).int() - 7)
    kn = torch.where(kr == 0, kr, kr + 0.2 * ulp)
    vn = torch.where(vr == 0, vr, vr - 0.2 * torch.ldexp(
        torch.ones_like(vr), torch.floor(torch.log2(vr.abs())).int() - 7))
    assert torch.equal(kn.to(torch.bfloat16).float(), kr)
    assert torch.equal(vn.to(torch.bfloat16).float(), vr)
    want = fd.flash_decode(qf, kr.to(torch.bfloat16), vr.to(torch.bfloat16),
                           lens, **opts)
    _within(fd.flash_decode(qf, kn, vn, lens, round_kv=torch.bfloat16, **opts), want,
            1e-5)
    moved = fd.flash_decode(qf, kn, vn, lens, **opts).float().cpu()
    assert float((moved - want.float().cpu()).abs().max()) > \
        1e-5 * float(want.abs().max())


def test_bf16_model_over_a_float32_cache_decodes_as_on_the_cpu():
    """A bf16 layer over a float32 cache (the engines' default
    ``cache_dtype``), self and cross: ``attention_decode`` on the card
    (#8 with ``round_kv``, the cache read as stored) within two bf16 ulps
    of the CPU path, which casts the cache to bf16 as the JAX package
    does; the card's cache is the CPU's (the new row's bf16 projections
    may round apart by an ulp)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers

    rng = np.random.default_rng(16)
    for cross in (False, True):
        cfg = layers.AttnConfig(d_model=256, n_heads=8, n_kv_heads=2,
                                head_dim=64, cross=cross,
                                d_cross=128 if cross else None)
        d_kv = 128 if cross else 256
        p = {n: torch.as_tensor((rng.normal(size=sh) * 0.1).astype(
            np.float32)).to(torch.bfloat16) for n, sh in (
            ("wq", (256, 8, 64)), ("wk", (d_kv, 2, 64)),
            ("wv", (d_kv, 2, 64)), ("wo", (8, 64, 256)))}
        cache = layers.init_kv_cache(cfg, 3, 300, dtype=torch.float32)
        cache["k"].normal_(generator=torch.Generator().manual_seed(1))
        cache["v"].normal_(generator=torch.Generator().manual_seed(2))
        x = torch.as_tensor(rng.normal(size=(3, 1, 256)).astype(
            np.float32)).to(torch.bfloat16)
        pos = torch.tensor([0, 170, 299], dtype=torch.int32)
        on_card = {n: t.cuda() for n, t in p.items()}
        card_cache = {n: t.cuda() for n, t in cache.items()}
        want, cpu_cache = layers.attention_decode(p, cfg, x, cache, pos)
        fd.flash_decode.dtypes = {}
        got, card_cache = layers.attention_decode(
            on_card, cfg, x.cuda(), card_cache, pos.cuda())
        assert fd.flash_decode.dtypes == {"bfloat16/float32": 1}
        assert got.dtype == torch.bfloat16
        _within(got, want, BF16_RTOL)
        for n in ("k", "v"):
            _within(card_cache[n], cpu_cache[n], BF16_RTOL)


# ---------------------------------------------------------------------------
# Scale-out: #1 per shard of a device mesh, and launches on another card
# ---------------------------------------------------------------------------


def _serving_layer_operands(n=4, seed=3):
    """#1's operands for a 14x14x512 DCN layer of ``n`` images at the
    serving tile 8 (4 tiles, P = 64), as the batch-fused prepass packs
    them: the per-image schedules and the packed idx/coeff."""
    from repro_torch.core.scheduler import DeviceSchedule
    from repro_torch.runtime.packing import pack_plane_operands

    grid = TileGrid(14, 14, 8, 8)
    t = grid.num_tiles
    coords = torch.stack([_coords(seed + 7 * i, 14, 14, spread=3.0)
                          for i in range(n)])
    out = schedule_group_batch_plain([coords], list(range(n)), grid, 4, 4)
    scheds = [DeviceSchedule(*out.image(k).exec[0]) for k in range(n)]
    idx, coeff = pack_plane_operands(coords, grid, 64)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n * t, 64, 512)).astype(np.float32))
    w = torch.as_tensor((rng.normal(size=(9, 512, 512)) / 68)
                        .astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(512,)).astype(np.float32))
    return (scheds, t, x, idx.reshape(n * t, 64, 9, 4),
            coeff.reshape(n * t, 64, 9, 4), w, b)


def _sharded_vs_single(mesh, sizes, dtype=torch.float32):
    """#1 over ``mesh`` with ``sizes`` images a shard, scattered back to
    (image, tile) rows, and the single call's rows on cuda:0; x, w and b
    in ``dtype``."""
    from repro_torch.kernels.dcn_fused import dcn_fused_batch_sharded
    from repro_torch.runtime.packing import pack_batch_schedules
    from repro_torch.runtime.shard import (plan_batch_shards,
                                           scatter_shard_rows,
                                           shard_batch_schedules, stack_rows)

    scheds, t, x, idx, coeff, w, b = _serving_layer_operands(sum(sizes))
    n = sum(sizes)
    dev = torch.device("cuda", 0)
    x, idx, coeff, w, b = (a.to(dev) for a in (x, idx, coeff, w, b))
    x, w, b = (a.to(dtype) for a in (x, w, b))
    bd = pack_batch_schedules(scheds, t, t, dev)
    y0 = dcn_fused_batch(x, bd.row_id, bd.dep_glb, bd.dep_cnt, idx, coeff,
                         w, b, t_in=t)
    target = torch.where(bd.oid >= 0, bd.row_id,
                         torch.full_like(bd.row_id, n * t)).long()
    want = torch.zeros((n * t + 1, 64, 512), dtype=dtype, device=dev)
    want[target] = y0
    plan = plan_batch_shards(n, len(sizes), sizes)
    sh = shard_batch_schedules(scheds, t, t, plan, dev)
    n0 = dcn_fused_batch_sharded.launches
    y = dcn_fused_batch_sharded(
        stack_rows(x, plan, t), sh.row_id, sh.dep_glb, sh.dep_cnt,
        stack_rows(idx, plan, t), stack_rows(coeff, plan, t), w, b,
        mesh=mesh, t_in=t, sizes=plan.sizes)
    assert dcn_fused_batch_sharded.launches - n0 == sum(s > 0 for s in sizes)
    got = scatter_shard_rows(y, sh, plan, t)
    torch.cuda.synchronize()
    return got, want[:-1]


@pytest.mark.parametrize("sizes", [[2, 1, 0, 1], [1, 1, 1, 1], [4, 0, 0, 0]])
def test_sharded_batch_kernel_equals_unsharded(sizes):
    """#1 once per non-empty shard of DeviceMesh.on("cuda:0", data=4),
    its split pinned to the single call's: bitwise the single call."""
    from repro_torch.launch.mesh import DeviceMesh

    got, want = _sharded_vs_single(DeviceMesh.on("cuda:0", data=4), sizes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sizes", [[2, 1, 0, 1], [1, 1, 1, 1], [4, 0, 0, 0]])
def test_sharded_batch_kernel_equals_unsharded_in_bf16(sizes):
    """The bf16 body sharded over DeviceMesh.on("cuda:0", data=4): each
    shard's cluster split pinned to the single call's, so the result is
    bitwise the single call's."""
    from repro_torch.launch.mesh import DeviceMesh

    got, want = _sharded_vs_single(DeviceMesh.on("cuda:0", data=4), sizes,
                                   torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_kernels_launch_on_their_operands_device():
    """With cuda:0 current, #1, the group launch (warp body and block
    body, whose shared-memory attribute is set per device) and #8 on
    cuda:1 match their plain versions; #1 sharded over two cards is
    bitwise the single call. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.launch.mesh import make_host_mesh

    one = torch.device("cuda", 1)
    with torch.cuda.device(0):
        ops = _batch_operands(8, 4, 4, 64, 512, 512, 4)
        want = dcn_fused_batch_plain(*ops, t_in=4)
        got = dcn_fused_batch(*(a.to(one) for a in ops), t_in=4)
        assert got.device == one
        assert float((got.cpu() - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
        for name in ("serving shape", "196 tiles chain"):
            layers, grid, images, m, in_smem = _group_case(name)
            k_pad = 1 << (grid.num_tiles - 1).bit_length()
            ref = schedule_group_batch_plain(layers, images, grid, m, k_pad)
            out = schedule_group_batch(
                [lay.to(one) if torch.is_tensor(lay) else lay
                 for lay in layers], images, grid, m, k_pad, device=one)
            for k in range(len(images)):
                for a, b in zip(out.image(k, own=True).tensors(),
                                ref.image(k).tensors()):
                    assert torch.equal(a.cpu(), b), name
        dops = _decode_operands(7, 4, 512, 16, 8, 128, [1, 512, 170, 300])
        want = flash_decode_plain(*dops, scale=128 ** -0.5)
        got = flash_decode(*(t.to(one) for t in dops)).cpu()
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
        got, want = _sharded_vs_single(
            make_host_mesh(data=min(4, torch.cuda.device_count())),
            [1] * min(4, torch.cuda.device_count()))
        assert torch.equal(got, want)


def _guarded_calls(dev):
    """(wrapper, float operands, call) for #1, #4-#8 on tiny operands on
    ``dev``; the grad guard runs before any shape check or launch."""
    from repro_torch.kernels import dcn_bli, dcn_fused
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g).to(dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    idx = torch.zeros((2, 2, 1, 4), dtype=torch.int32, device=dev)
    conv = dict(coeff=f(2, 2, 1, 4), w=f(1, 16, 4), b=f(4))
    return [
        (dcn_fused.dcn_fused_batch, dict(x_tiles=f(2, 4, 16), **conv),
         lambda o: dcn_fused.dcn_fused_batch(
             o["x_tiles"], i32(0, 1), i32([0], [1]), i32(1, 1), idx,
             o["coeff"], o["w"], o["b"], t_in=2)),
        (dcn_fused.dcn_fused_schedule, dict(x_tiles=f(2, 4, 16), **conv),
         lambda o: dcn_fused.dcn_fused_schedule(
             o["x_tiles"], i32([0], [1]), i32(1, 1), idx, o["coeff"],
             o["w"], o["b"])),
        (dcn_fused.dcn_fused_tile, dict(x_tile=f(4, 16), coeff=f(2, 1, 4),
                                        w=conv["w"], b=conv["b"]),
         lambda o: dcn_fused.dcn_fused_tile(o["x_tile"], idx[0], o["coeff"],
                                            o["w"], o["b"])),
        (dcn_bli.bli_tile_matmul, dict(x_tile=f(4, 16), coeff=f(2, 4)),
         lambda o: dcn_bli.bli_tile_matmul(
             o["x_tile"], torch.zeros((2, 4), dtype=torch.int32, device=dev),
             o["coeff"])),
        (fa.flash_attention, dict(q=f(1, 4, 2, 16), k=f(1, 4, 2, 16),
                                  v=f(1, 4, 2, 16)),
         lambda o: fa.flash_attention(o["q"], o["k"], o["v"])),
        (fd.flash_decode, dict(q=f(1, 2, 16), k_cache=f(1, 64, 2, 16),
                               v_cache=f(1, 64, 2, 16)),
         lambda o: fd.flash_decode(o["q"], o["k_cache"], o["v_cache"],
                                   i32(3))),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_wrappers_refuse_grad_on_the_card(case):
    """#1, #4-#8 refuse a CUDA operand that requires grad while grad
    mode is on, as their plain versions do on the CPU, and launch
    nothing."""
    fn, ops, call = _guarded_calls(torch.device("cuda"))[case]
    for k in ops:
        bad = dict(ops, **{k: ops[k].clone().requires_grad_(True)})
        n = fn.launches
        with pytest.raises(ValueError, match=f"{k} requires grad"):
            call(bad)
        assert fn.launches == n


def test_fused_dcn_train_step_on_the_card():
    """Two AdamW steps of a small VGG19-2 DCN-II classifier with params
    and optimizer state on the card: the fused (checkpointed) step gives
    the unfused step's loss and gradients within 1e-5 norm-wise, losses
    are finite, and every parameter with a gradient moves. The gradients
    are compared with torch's deterministic kernels, as ``chip_smoke.py``
    phase 8 compares them: the default atomic backward differs from
    itself by about that much, so only the fusion may differ here."""
    from repro_torch._tree import tree_leaves, value_and_grad
    from repro_torch.core.deform import randomize_offset_conv
    from repro_torch.data import DataConfig, image_batch
    from repro_torch.launch.train import dcn_loss, dcn_train_step
    from repro_torch.models.dcn_models import DcnNetConfig, init_dcn_net
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = DcnNetConfig("vgg19", 2, "dcn2", img_size=32, width_mult=0.125,
                       num_classes=4)
    dev = torch.device("cuda")
    params = init_dcn_net(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(1)
    params["convs"] = [randomize_offset_conv(p, gen, 1.0 / p.w.shape[2])
                       if hasattr(p, "w_off") else p
                       for p in params["convs"]]
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    opt = init_opt_state(params, ocfg)
    assert all(t.device.type == "cuda"
               for t in tree_leaves({"p": params, "o": opt}))
    b = image_batch(DataConfig(seed=2, global_batch=4), 0, img=32, classes=4)
    x = torch.as_tensor(b["images"], device=dev)
    y = torch.as_tensor(b["labels"], device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (lf, gf), (lu, gu) = (value_and_grad(
            lambda p: dcn_loss(p, cfg, x, y, fused=fused), params)
            for fused in (True, False))
    finally:
        torch.use_deterministic_algorithms(False)
    assert abs(float(lf) - float(lu)) <= 1e-5 * abs(float(lu))
    for a, w in zip(tree_leaves(gf), tree_leaves(gu)):
        assert float((a - w).norm()) <= 1e-5 * max(float(w.norm()), 1e-30)
    before = [t.clone() for t in tree_leaves(params)]
    for _ in range(2):
        params, opt, loss = dcn_train_step(params, opt, x, y, cfg, ocfg)
        assert torch.isfinite(loss)
    for t0, t1, g in zip(before, tree_leaves(params), tree_leaves(gu)):
        if g.abs().max() > 0:
            assert not torch.equal(t0, t1)
    assert int(opt["step"]) == 2


def test_granite_smoke_serves_through_the_flash_kernels(monkeypatch):
    """granite-moe smoke (MoE blocks, 2 query heads per kv head, D 16) on
    the card: ``lm_prefill(use_flash=True)`` launches #7 once a layer and
    a ``DecodeEngine`` run #8 once a layer and step, and both equal the
    same model on the CPU (the plain versions) within 1e-4 * max|ref|,
    prefill logits and every decode step's logits."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine, Request

    cfg = dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m", smoke=True),
        use_flash=True)
    params = lm.init_lm(cfg, 0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(50)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 37))
                           .astype(np.int32))

    def close(got, want):
        got = got.cpu()
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())

    flash_attention.launches = 0
    got = lm.lm_prefill(on_card, cfg, {"tokens": toks.cuda()})
    assert flash_attention.launches == cfg.n_layers
    close(got, lm.lm_prefill(params, cfg, {"tokens": toks}))

    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (5, 2, 9)]
    step_logits = {}
    orig = lm.lm_decode_step

    def recording(p, c, cache, token, pos, ctx=None):
        logits, cache = orig(p, c, cache, token, pos, ctx)
        step_logits.setdefault(logits.device.type, []).append(logits.cpu())
        return logits, cache

    monkeypatch.setattr(lm, "lm_decode_step", recording)
    outs = {}
    for p, dev in ((params, "cpu"), (on_card, "cuda")):
        eng = DecodeEngine(p, cfg, batch=2, max_len=24, device=dev)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        flash_decode.launches = 0
        outs[dev] = {r.rid: r.out for r in eng.run()}
        if dev == "cuda":
            assert flash_decode.launches == cfg.n_layers * eng.steps > 0
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 3
    assert len(step_logits["cuda"]) == len(step_logits["cpu"])
    for got, want in zip(step_logits["cuda"], step_logits["cpu"]):
        close(got, want)


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode"])
def test_flash_kernels_at_jambas_group_of_four(kernel):
    """jamba's attention layer: 32 query heads over 8 kv heads (4 a kv
    head), head dim 128. #7 at (2, 256, 32/8, 128) causal and #8 on a
    512-slot cache at ragged lengths, each within 1e-4 * max|ref| of its
    plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(60)
    if kernel == "flash_attention":
        q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
                   for s in ((2, 256, 32, 128), (2, 256, 8, 128),
                             (2, 256, 8, 128)))
        want = fa.flash_attention_plain(q, k, v, scale=128 ** -0.5)
        got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda()).cpu()
    else:
        ops = _decode_operands(61, 4, 512, 32, 8, 128, [1, 512, 170, 65])
        want = fd.flash_decode_plain(*ops, scale=128 ** -0.5)
        got = fd.flash_decode(*(t.cuda() for t in ops)).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_recurrent_smoke_serves_on_the_card_through_a_reused_slot(arch):
    """The recurrent smoke configs on the card: a one-slot
    ``DecodeEngine`` serves three requests one after another through its
    one slot, and each gets the greedy tokens a fresh engine gives it
    alone and the same engine gives on the CPU. jamba's attention layer
    runs #8 once a step; xlstm runs no kernel."""
    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine, Request

    cfg = configs.get_config(arch, smoke=True)
    params = lm.init_lm(cfg, 0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(62)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (5, 2, 7)]
    n_attn = sum(s.kind == "attn" for s in cfg.pattern) * cfg.n_repeats

    def serve(p, dev, reqs):
        eng = DecodeEngine(p, cfg, batch=1, max_len=24, device=dev)
        for rid, prompt in reqs:
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        flash_decode.launches = 0
        out = {r.rid: r.out for r in eng.run()}
        if dev == "cuda":
            assert flash_decode.launches == n_attn * eng.steps
        return out

    reused = serve(on_card, "cuda", list(enumerate(prompts)))
    fresh = {}
    for rid, prompt in enumerate(prompts):
        fresh.update(serve(on_card, "cuda", [(rid, prompt)]))
    assert reused == fresh and len(fresh) == 3
    assert serve(params, "cpu", list(enumerate(prompts))) == reused


def test_llama_vision_smoke_serves_on_the_card_with_its_image():
    """llama-3.2-vision smoke on the card with float32 image states:
    ``lm_prefill(use_flash=True)`` launches #7 once a layer (the cross
    layer non-causally) within 1e-4 * max|ref| of the CPU, and a
    ``DecodeEngine`` whose cross cache ``build_cross_cache`` filled runs
    #8 once a layer and step, the cross layer included, and gives the
    CPU engine's greedy tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine, Request

    cfg = dataclasses.replace(
        configs.get_config("llama-3.2-vision-11b", smoke=True),
        use_flash=True)
    params = lm.init_lm(cfg, 0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(64)
    states = torch.as_tensor(rng.normal(
        size=(2, cfg.n_cross_tokens, cfg.d_cross)).astype(np.float32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 37))
                           .astype(np.int32))
    flash_attention.launches = 0
    got = lm.lm_prefill(on_card, cfg, {"tokens": toks.cuda(),
                                       "cross_states": states.cuda()}).cpu()
    assert flash_attention.launches == cfg.n_layers
    want = lm.lm_prefill(params, cfg, {"tokens": toks,
                                       "cross_states": states})
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (5, 2, 9)]
    outs = {}
    for p, dev in ((params, "cpu"), (on_card, "cuda")):
        eng = DecodeEngine(p, cfg, batch=2, max_len=24, device=dev)
        eng.cache = lm.build_cross_cache(p, cfg, eng.cache, states.to(dev))
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        flash_decode.launches = 0
        outs[dev] = {r.rid: r.out for r in eng.run()}
        if dev == "cuda":
            assert flash_decode.launches == cfg.n_layers * eng.steps > 0
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 3


# -- the mesh's model axis on one card ------------------------------------------

def test_flash_kernels_on_rank_slices_of_a_model_mesh():
    """#7 and #8 on each rank's heads of DeviceMesh.on("cuda:0", data=2,
    model=2) (row i's batch rows, rank r's query heads and the kv heads
    they read, as the tensor-parallel forms hand them) against their plain
    versions within 1e-4 * max|ref|."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.layers import kv_heads_of

    mesh = DeviceMesh.on("cuda:0", data=2, model=2)
    rng = np.random.default_rng(70)
    b, s, hq, hkv, d = 4, 300, 16, 8, 128
    q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32))
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    dq, lens = q[:, -1], torch.as_tensor([300, 1, 170, 64], dtype=torch.int32)
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        for r in range(2):
            dev = mesh.device(i, r)
            lo, hi = kv_heads_of(hq, hkv, 2, r)
            heads = slice(r * hq // 2, (r + 1) * hq // 2)
            qs, ks, vs = (t[rows][:, :, h].contiguous() for t, h in (
                (q, heads), (k, slice(lo, hi)), (v, slice(lo, hi))))
            got = flash_attention(qs.to(dev), ks.to(dev), vs.to(dev)).cpu()
            want = flash_attention_plain(qs, ks, vs, scale=d ** -0.5)
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())
            dqs = dq[rows][:, heads].contiguous()
            got = flash_decode(dqs.to(dev), ks.to(dev), vs.to(dev),
                               lens[rows].to(dev)).cpu()
            want = flash_decode_plain(dqs, ks, vs, lens[rows],
                                      scale=d ** -0.5)
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())


def test_moe_over_a_model_mesh_on_the_card():
    """``moe_apply(mesh=)`` over DeviceMesh.on("cuda:0", data=2, model=4)
    in both weight modes: within 1e-4 * max|ref| of the unsharded call on
    the card where nothing drops, and of the same call over a CPU mesh at
    a capacity factor that drops."""
    import dataclasses

    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import moe
    from repro_torch.models.params import Maker, make_generator

    for mode in ("fsdp", "tp_f"):
        cfg = moe.MoeConfig(d_model=64, d_ff=64, n_experts=8, top_k=2,
                            n_shared=1, ep=4, weight_mode=mode,
                            capacity_factor=1.25)
        p = moe.init_moe(Maker(make_generator(3, "cpu")), cfg)
        p["router"] = p["router"] * 8.0
        x = torch.randn((4, 64, 64), generator=torch.Generator()
                        .manual_seed(4))
        on_card = {k: ({n: t.cuda() for n, t in v.items()}
                       if isinstance(v, dict) else v.cuda())
                   for k, v in p.items()}

        def close(got, want):
            got = got.cpu()
            assert torch.isfinite(got).all()
            assert float((got - want.cpu()).abs().max()) <= \
                1e-4 * float(want.abs().max())

        card_mesh = DeviceMesh.on("cuda:0", data=2, model=4)
        got, _ = moe.moe_apply(on_card, cfg, x.cuda(), mesh=card_mesh)
        want, _ = moe.moe_apply(p, cfg, x,
                                mesh=DeviceMesh.on("cpu", data=2, model=4))
        close(got, want)
        free = dataclasses.replace(cfg, capacity_factor=16.0)
        got, _ = moe.moe_apply(on_card, free, x.cuda(), mesh=card_mesh)
        close(got, moe.moe_apply(on_card, free, x.cuda())[0])


def test_tensor_parallel_steps_launch_once_a_rank_and_layer():
    """qwen3 smoke through ``build_step`` over DeviceMesh.on("cuda:0",
    data=2, model=2) with ``use_flash``: a prefill launches #7 once a
    layer, data row and rank, a decode step #8 likewise, each on the
    rank's own cache tensor (by data pointer), and the logits equal the
    unsharded path on the card within 1e-4 * max|ref|."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import layers, lm
    from repro_torch.models.params import ShardedTree

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b", smoke=True),
                              use_flash=True)
    mesh = DeviceMesh.on("cuda:0", data=2, model=2)
    params = lm.init_lm(cfg, 0, device="cuda")
    b, s, max_len = 4, 20, 32
    pre = build_step(cfg, ShapeCell("p", "prefill", s, b), mesh,
                     param_dtype=torch.float32)
    dec = build_step(cfg, ShapeCell("d", "decode", max_len, b), mesh,
                     param_dtype=torch.float32)
    placed = ShardedTree.place(params, pre.param_shardings, mesh)
    toks = torch.as_tensor(np.random.default_rng(71).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32), device="cuda")

    def close(got, want):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())

    flash_attention.launches = 0
    got = pre.fn(placed, {"tokens": toks})
    assert flash_attention.launches == cfg.n_layers * 4
    close(got, lm.lm_prefill(params, cfg, {"tokens": toks}))

    cache = lm.init_cache(cfg, b, max_len, dtype=torch.float32,
                          device="cuda", mesh=mesh)
    ref = lm.init_cache(cfg, b, max_len, dtype=torch.float32, device="cuda")
    own = {t.data_ptr() for row in cache.shards for sh in row
           for name in ("k", "v")
           for t in torch.unbind(sh["stack"]["b0"]["mix"][name], 0)}
    seen, sharded = [], [False]
    orig = layers.flash_decode

    def spy(q, kc, vc, *a, **k):
        if sharded[0]:
            seen.extend([kc.data_ptr(), vc.data_ptr()])
        return orig(q, kc, vc, *a, **k)

    layers.flash_decode = spy
    try:
        pos = torch.tensor([0, 5, 2, 9], device="cuda")
        for step in range(3):
            flash_decode.launches = 0
            sharded[0] = True
            got, cache = dec.fn(placed, cache, toks[:, step:step + 1], pos)
            sharded[0] = False
            assert flash_decode.launches == cfg.n_layers * 4
            want, ref = lm.lm_decode_step(params, cfg, ref,
                                          toks[:, step:step + 1], pos)
            close(got, want)
            pos = pos + 1
    finally:
        layers.flash_decode = orig
    assert seen and set(seen) <= own


# ---------------------------------------------------------------------------
# float16: #1 / #4 / #5 / #6 / #7 / #8 on float16 operands
# ---------------------------------------------------------------------------

# Two float16 ulps at the largest output: both sides compute in float32
# and round the output once (#7 also rounds P to float16 for P V).
F16_RTOL = 2.0 ** -9
F16 = torch.float16


def _f16_fused_case(which, shape):
    """``_bf16_fused_case`` with x, w and b rounded to float16."""
    fn, plain, ops, kw, c = _bf16_fused_case(which, shape)
    return fn, plain, [a.float().to(F16) if a.dtype == torch.bfloat16
                       else a for a in ops], kw, c


@pytest.mark.parametrize("case", range(len(BF16_FUSED_CASES)))
def test_fused_kernels_in_fp16(case):
    """#1, #4 and #5 on float16 x, w and b (float32 coefficients) through
    the split-C body: within two float16 ulps of the plain version at
    n_split = 1, the default and the chunk count, one float16 launch each
    (the float32 body's grid), a bitwise rerun, a dep_cnt = 0 row that is
    exactly b."""
    from repro_torch.kernels import dcn_fused as kf

    fn, plain, ops, kw, c = _f16_fused_case(*BF16_FUSED_CASES[case])
    want = plain(*ops, **kw)
    assert want.dtype == F16
    args = [a.cuda() for a in ops]
    fn.dtypes = {}
    splits = list(dict.fromkeys((1, None, math.ceil(c / kf.SPLIT_BC))))
    outs = {n: fn(*args, **kw, n_split=n) for n in splits}
    assert fn.dtypes == {"float16": len(splits)}
    assert len(fn.last_grid) == 4              # the split-C body's grid
    for got in outs.values():
        assert got.dtype == F16
        _within(got, want, F16_RTOL)
    assert torch.equal(fn(*args, **kw), outs[None])
    if BF16_FUSED_CASES[case][0] != "tile":
        for got in outs.values():
            assert torch.equal(got[-1], args[-1].expand_as(got[-1]))


@pytest.mark.parametrize("which", ["batch", "schedule", "tile"])
def test_fp16_fused_kernels_off_16_bytes_and_mixed(which):
    """float16 x and w 2 bytes past a 16-byte boundary (the value-by-value
    copies) give the plain version's result; float16 x under float32 w
    and b widens to the float32 kernel and rounds once."""
    shape = {"batch": (2, 4, 64, 60, 124, 4),
             "schedule": (3, 5, 64, 90, 250, 4),
             "tile": (2, 120, 64, 66, 190)}[which]
    fn, plain, ops, kw, _ = _f16_fused_case(which, shape)
    want = plain(*ops, **kw)
    args = [a.cuda() for a in ops]
    for i in (0, len(args) - 2):
        buf = torch.empty(args[i].numel() + 1, dtype=F16, device="cuda")
        moved = buf[1:].view(args[i].shape)
        moved.copy_(args[i])
        assert moved.data_ptr() % 16 == 2
        args[i] = moved
    fn.dtypes = {}
    got = fn(*args, **kw)
    assert got.dtype == F16 and fn.dtypes == {"float16": 1}
    _within(got, want, F16_RTOL)
    mixed = [a.float() if i >= len(ops) - 2 else a
             for i, a in enumerate(ops)]
    fn.dtypes = {}
    got = fn(*(a.cuda() for a in mixed), **kw)
    assert got.dtype == F16 and fn.dtypes == {"float32": 1}
    _within(got, plain(*mixed, **kw), F16_RTOL)


@pytest.mark.parametrize("shape", BLI_GPU_CASES)
def test_bli_kernel_in_fp16(shape):
    """#6 on float16 planes: within one float16 ulp of the plain version
    (four float32 terms rounded once), a bitwise rerun."""
    from repro_torch.kernels.dcn_bli import bli_tile_matmul, bli_tile_plain

    n, s, p, c, spill = shape
    x, idx, cf = _bli_case(n, s, p, c, spill, F16)
    ops = (x.cuda(), idx.cuda(), cf.cuda())
    got = bli_tile_matmul(*ops, block_p=p, block_c=c)
    assert got.dtype == F16
    _within(got, bli_tile_plain(x, idx, cf), 2.0 ** -10)
    assert torch.equal(bli_tile_matmul(*ops, block_p=p, block_c=c), got)


@pytest.mark.parametrize("case", range(len(FLASH_BF16_CASES)))
def test_flash_attention_fp16_kernel(case):
    """#7 on float16 operands through the 16-bit kernel: within two
    float16 ulps of the plain version, one launch of the ``16bit`` body, a
    bitwise rerun."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, hq, hkv, d, opts = FLASH_BF16_CASES[case]
    rng = np.random.default_rng(170 + case)
    q, k, v = (_bf16_normal(rng, *s).float().to(F16).cuda()
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **opts)
    fa.flash_attention.dtypes, fa.flash_attention.bodies = {}, {}
    got = fa.flash_attention(q, k, v, **opts)
    assert got.dtype == F16 and fa.flash_attention.bodies == {"16bit": 1}
    assert fa.flash_attention.dtypes == {"float16": 1}
    _within(got, want, F16_RTOL)
    assert torch.equal(fa.flash_attention(q, k, v, **opts), got)


@pytest.mark.parametrize("opts", [{}, dict(window=100), dict(softcap=30.0),
                                  dict(window=40, softcap=50.0)])
@pytest.mark.parametrize("q_dtype", [torch.float32, F16])
def test_flash_decode_over_a_fp16_cache(q_dtype, opts):
    """#8 reading a float16 cache as stored through the split body, under
    a float32 q (1e-4 * max|ref|: the widening is exact) and a float16 q
    (two float16 ulps), at ragged lengths and 1 / default / 64 splits; a
    sequence with no visible key gives 0; a rerun is bitwise equal."""
    from repro_torch.kernels import flash_decode as fd

    b, s, hq, hkv, d = len(RAGGED_LENGTHS), 512, 16, 8, 128
    q, kc, vc, lens = _decode_operands(21, b, s, hq, hkv, d, RAGGED_LENGTHS)
    q, kc, vc = q.to(q_dtype), kc.to(F16), vc.to(F16)
    want = fd.flash_decode_plain(q, kc, vc, lens, scale=d ** -0.5, **opts)
    args = [t.cuda() for t in (q, kc, vc, lens)]
    rtol = 1e-4 if q_dtype == torch.float32 else F16_RTOL
    fd.flash_decode.bodies = {}
    outs = {n: fd.flash_decode(*args, num_splits=n, **opts)
            for n in (1, None, 64)}
    assert fd.flash_decode.bodies == {"split": 3}
    for got in outs.values():
        assert got.dtype == q_dtype
        _within(got, want, rtol)
    for i, n in enumerate(RAGGED_LENGTHS):
        if n <= 0:
            assert not outs[None][i].any()
    assert torch.equal(fd.flash_decode(*args, **opts), outs[None])


def test_fp16_cache_under_a_bf16_cache_body_and_rounding():
    """A float16 q over a bf16 cache runs the cluster body on the widened
    q (one rounding of the output); ``round_kv=float16`` over a float32
    cache (a float16 model's cast) gives the float16 cache's result within
    two float16 ulps."""
    from repro_torch.kernels import flash_decode as fd

    q, kc, vc, lens = (t.cuda() for t in _decode_operands(
        23, 4, 512, 16, 8, 128, [1, 100, 512, 300]))
    qh = q.to(F16)
    fd.flash_decode.bodies = {}
    got = fd.flash_decode(qh, kc.to(torch.bfloat16), vc.to(torch.bfloat16),
                          lens)
    assert got.dtype == F16 and fd.flash_decode.bodies == {"cluster": 1}
    _within(got, fd.flash_decode_plain(qh, kc.to(torch.bfloat16),
                                       vc.to(torch.bfloat16), lens,
                                       scale=128 ** -0.5), F16_RTOL)
    got = fd.flash_decode(qh, kc, vc, lens, round_kv=F16)
    assert fd.flash_decode.bodies == {"cluster": 1, "split": 1}
    _within(got, fd.flash_decode(qh, kc.to(F16), vc.to(F16), lens),
            F16_RTOL)


# ---------------------------------------------------------------------------
# The general bodies of #7 and #8 (csrc/attention_any.cu)
# ---------------------------------------------------------------------------

ANY_DTYPES = {torch.float32: 1e-4, torch.bfloat16: BF16_RTOL,
              F16: F16_RTOL}
# (B, Sq, Skv, Hq, Hkv, D, options) of #7 at head dims the fast bodies do
# not take (72 they do: its body is printed, not forced).
ANY_FLASH = [(1, 70, 70, 4, 2, 6, {}),
             (1, 90, 90, 4, 2, 72, dict(window=20)),
             (1, 100, 130, 4, 1, 160, dict(softcap=30.0)),
             (2, 65, 65, 8, 2, 256, dict(window=33, softcap=50.0)),
             (1, 77, 40, 4, 4, 320, dict(causal=False))]


def _off16(t):
    """A copy of ``t`` whose first value sits one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    moved = buf[1:].view(t.shape)
    moved.copy_(t)
    return moved


@pytest.mark.parametrize("dtype", list(ANY_DTYPES))
@pytest.mark.parametrize("case", range(len(ANY_FLASH)))
def test_flash_attention_general_body(case, dtype):
    """#7 at head dims past the fast bodies (and 72) in each type: the
    plain version's result; the body ``attention_body`` names, launched
    once; an operand off a 16-byte boundary takes the general body at
    every head dim."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, hq, hkv, d, opts = ANY_FLASH[case]
    rng = np.random.default_rng(300 + case)
    q, k, v = (_bf16_normal(rng, *s).float().to(dtype).cuda()
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **opts)
    for args, aligned in (((q, k, v), True),
                          ((_off16(q), k, _off16(v)), False)):
        fa.flash_attention.bodies = {}
        got = fa.flash_attention(*args, **opts)
        body = fa.attention_body(d, dtype, aligned)
        assert fa.flash_attention.bodies == {body: 1}
        assert got.dtype == dtype
        _within(got, want, ANY_DTYPES[dtype])
    assert body == "general"


@pytest.mark.parametrize("dtype", list(ANY_DTYPES))
def test_flash_attention_fast_body_past_65535_rows(dtype):
    """#7 over B x Hq = 65,536 rows at a few query rows: the fast body of
    the type (its flat grid holds the rows), the plain version's
    result."""
    from repro_torch.kernels import flash_attention as fa

    b, s, hq, hkv, d = 8192, 3, 8, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = (_bf16_normal(rng, *sh).float().to(dtype).cuda()
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5)
    fa.flash_attention.bodies = {}
    got = fa.flash_attention(q, k, v)
    assert fa.flash_attention.bodies == {fa.attention_body(d, dtype): 1}
    assert fa.attention_body(d, dtype) != "general"
    _within(got, want, ANY_DTYPES[dtype])


# (B, S, Hq, Hkv, D, lengths, options) of #8 past the fast bodies.
ANY_DECODE = [(3, 300, 8, 2, 6, [0, 1, 300], {}),
              (2, 257, 4, 1, 100, [257, 64], dict(window=50)),
              (2, 200, 4, 2, 320, [200, 77], dict(softcap=30.0)),
              (2, 300, 16, 1, 64, [300, 129], {}),
              (2, 300, 71, 1, 64, [300, 5], dict(window=100))]


@pytest.mark.parametrize("dtype", list(ANY_DTYPES))
@pytest.mark.parametrize("case", range(len(ANY_DECODE)))
def test_flash_decode_general_body(case, dtype):
    """#8 at head dims, groups and alignments past the fast bodies, cache
    and q in each type: the plain version's result through the body
    ``decode_body`` names (``general``), launched once; a sequence with
    no visible key gives 0."""
    from repro_torch.kernels import flash_decode as fd

    b, s, hq, hkv, d, lengths, opts = ANY_DECODE[case]
    q, kc, vc, lens = _decode_operands(40 + case, b, s, hq, hkv, d, lengths)
    q, kc, vc = (t.to(dtype).cuda() for t in (q, kc, vc))
    lens = lens.cuda()
    want = fd.flash_decode_plain(q, kc, vc, lens, scale=d ** -0.5, **opts)
    for args, aligned in (((q, kc, vc), True),
                          ((_off16(q), _off16(kc), vc), False)):
        fd.flash_decode.bodies = {}
        got = fd.flash_decode(*args, lens, **opts)
        body = fd.decode_body(d, hq // hkv, dtype, aligned, b * hkv)
        assert fd.flash_decode.bodies == {body: 1}
        assert got.dtype == dtype
        _within(got, want, ANY_DTYPES[dtype])
        for i, n in enumerate(lengths):
            if n <= 0:
                assert not got[i].any()
    assert fd.decode_body(d, hq // hkv, dtype, False, b * hkv) == "general"


def test_flash_decode_general_body_past_65535_pairs():
    """A bf16 cache of B * Hkv = 65,536 (the cluster body's grid holds
    65,535) at a few rows: the general body, the plain version's result."""
    from repro_torch.kernels import flash_decode as fd

    b, s, hq, hkv, d = 8192, 4, 8, 8, 16
    rng = np.random.default_rng(5)
    q, kc, vc = (_bf16_normal(rng, *sh).cuda()
                 for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    lens = torch.as_tensor(rng.integers(0, s + 1, size=b).astype(np.int32))
    want = fd.flash_decode_plain(q, kc, vc, lens.cuda(), scale=d ** -0.5)
    fd.flash_decode.bodies = {}
    got = fd.flash_decode(q, kc, vc, lens.cuda())
    assert fd.flash_decode.bodies == {"general": 1}
    _within(got, want, BF16_RTOL)


# The general bodies on the tensor cores: a float32 q over a 16-bit cache,
# round_kv across the 16-bit types, a group of 71 at several split counts,
# wide head dims whose causal / window ranges skip whole key tiles, and
# operands off 16- and 4-byte boundaries (each copy route of the plan).
# Limits by output type: ATTN_RTOL, two bf16 ulps, one float16 ulp.
GENERAL_RTOL = {torch.float32: 1e-4, torch.bfloat16: BF16_RTOL,
                F16: 2.0 ** -10}


def _shifted(t, values):
    """A copy of ``t`` whose first value sits ``values`` values past an
    allocation's (aligned) start."""
    buf = torch.empty(t.numel() + values, dtype=t.dtype, device=t.device)
    moved = buf[values:].view(t.shape)
    moved.copy_(t)
    return moved


@pytest.mark.parametrize("cache", [torch.bfloat16, F16])
@pytest.mark.parametrize("hq,hkv,d", [(16, 1, 64), (4, 2, 6)])
def test_flash_decode_general_float32_q_over_16bit_cache(cache, hq, hkv, d):
    """A float32 q over a bf16 or float16 cache (group 16; head dim 6) on
    the general body: the float32 result on the widened cache, within
    1e-4 of the plain version, one general launch."""
    from repro_torch.kernels import flash_decode as fd

    q, kc, vc, lens = _decode_operands(60 + d, 3, 300, hq, hkv, d,
                                       [300, 77, 0])
    kc, vc = kc.to(cache), vc.to(cache)
    want = fd.flash_decode_plain(q, kc, vc, lens, scale=d ** -0.5)
    fd.flash_decode.bodies = {}
    got = fd.flash_decode(q.cuda(), kc.cuda(), vc.cuda(), lens.cuda())
    assert fd.flash_decode.bodies == {"general": 1}
    assert got.dtype == torch.float32
    _within(got, want, 1e-4)
    assert not got[2].any()


@pytest.mark.parametrize("q_kind", ["float32", "rounded"])
@pytest.mark.parametrize("cache,rk", [(torch.bfloat16, F16),
                                      (F16, torch.bfloat16)])
def test_flash_decode_general_round_kv_across_16bit_types(cache, rk, q_kind):
    """``round_kv`` from one 16-bit cache type to the other (a bf16 cache
    under a float16 model, and the reverse): each K and V value rounded
    where read, the plain version's result under a float32 q (1e-4) and a
    q of the rounded type (its limit)."""
    from repro_torch.kernels import flash_decode as fd

    q, kc, vc, lens = _decode_operands(64, 2, 257, 8, 2, 128, [257, 100])
    kc, vc = kc.to(cache), vc.to(cache)
    q = q if q_kind == "float32" else q.to(rk)
    want = fd.flash_decode_plain(q, kc, vc, lens, scale=128 ** -0.5,
                                 round_kv=rk)
    fd.flash_decode.bodies = {}
    got = fd.flash_decode(q.cuda(), kc.cuda(), vc.cuda(), lens.cuda(),
                          round_kv=rk)
    assert fd.flash_decode.bodies == {"general": 1}
    assert got.dtype == q.dtype
    _within(got, want, 1e-4 if q_kind == "float32" else GENERAL_RTOL[rk])


@pytest.mark.parametrize("dtype", list(GENERAL_RTOL))
def test_flash_decode_general_group_71_split_counts(dtype):
    """Falcon-7B's 71 query heads over one kv head: lengths 0, 1, 63, 64,
    65 and past S at 1, 7 and the default split count each match the plain
    version, one general launch each; no visible key gives 0."""
    from repro_torch.kernels import flash_decode as fd

    lengths = [0, 1, 63, 64, 65, 230]
    q, kc, vc, lens = _decode_operands(65, len(lengths), 200, 71, 1, 64,
                                       lengths)
    q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
    want = fd.flash_decode_plain(q, kc, vc, lens, scale=64 ** -0.5)
    args = [t.cuda() for t in (q, kc, vc, lens)]
    for n in (1, 7, None):
        fd.flash_decode.bodies = {}
        got = fd.flash_decode(*args, num_splits=n)
        assert fd.flash_decode.bodies == {"general": 1}
        _within(got, want, GENERAL_RTOL[dtype])
        assert not got[0].any()


# (B, Sq, Skv, Hq, Hkv, D, options): head dims past the fast bodies whose
# query tiles see only some key tiles (a window, Sq past Skv, causal).
GENERAL_WIDE = [(1, 300, 300, 4, 2, 256, dict(window=40)),
                (1, 260, 200, 2, 1, 320, dict(window=70)),
                (1, 150, 150, 2, 2, 520, {}),
                (2, 129, 129, 2, 1, 256, dict(softcap=30.0))]


@pytest.mark.parametrize("dtype", list(GENERAL_RTOL))
@pytest.mark.parametrize("case", range(len(GENERAL_WIDE)))
def test_flash_attention_general_wide_heads_skip_tiles(case, dtype):
    """#7 at head dims 256, 320 and 520 where each query tile's causal /
    window range skips whole key tiles, rows with no key included: the
    plain version's result, one general launch."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, hq, hkv, d, opts = GENERAL_WIDE[case]
    rng = np.random.default_rng(500 + case)
    q, k, v = (_bf16_normal(rng, *s).float().to(dtype).cuda()
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **opts)
    fa.flash_attention.bodies = {}
    got = fa.flash_attention(q, k, v, **opts)
    assert fa.flash_attention.bodies == {"general": 1}
    _within(got, want, GENERAL_RTOL[dtype])


@pytest.mark.parametrize("which", ["all off 16 B", "q", "k", "v"])
@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_general_body_copy_routes(kernel, which):
    """bf16 operands at head dim 128 (a fast body's shape): all three 8
    bytes past a 16-byte boundary (4-byte copies), or one alone at an odd
    bf16 offset (value-by-value loads) beside aligned ones (TMA boxes),
    take the general body and give the plain version's result."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    bf = torch.bfloat16
    if kernel == "flash":
        rng = np.random.default_rng(71)
        ops = [_bf16_normal(rng, *s).cuda() for s in
               ((1, 150, 8, 128), (1, 150, 2, 128), (1, 150, 2, 128))]
        want = fa.flash_attention_plain(*ops, scale=128 ** -0.5)
        fn = fa.flash_attention
    else:
        q, kc, vc, lens = _decode_operands(72, 3, 300, 8, 2, 128,
                                           [300, 130, 1])
        ops = [t.to(bf).cuda() for t in (q, kc, vc)]
        lens = lens.cuda()
        want = fd.flash_decode_plain(*ops, lens, scale=128 ** -0.5)
        fn = fd.flash_decode
    if which == "all off 16 B":
        ops = [_shifted(t, 4) for t in ops]
    else:
        i = "qkv".index(which)
        ops[i] = _shifted(ops[i], 1)
    fn.bodies = {}
    got = fn(*ops) if kernel == "flash" else fn(*ops, lens)
    assert fn.bodies == {"general": 1}
    _within(got, want, BF16_RTOL)


@pytest.mark.parametrize("mode,rows", [(0, 2048), (1, 71), (1, 2)])
def test_general_plan_smem_matches_the_kernel_layout(mode, rows):
    """The plan's shared-memory bytes (``general_layout``, in Python) equal
    the kernel's own ``layout`` for every head dim 1..1024 and each mix of
    types, so a plan that fits ``SMEM_LIMIT`` is one the launch accepts."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    lib = _build.load()
    bf = torch.bfloat16
    for qd, kd, rk in [(torch.float32, torch.float32, None), (F16, F16, None),
                       (bf, bf, None), (torch.float32, bf, None),
                       (bf, torch.float32, bf), (F16, bf, F16)]:
        for d in range(1, 1025):
            p = fa.general_plan(mode, d, rows, 4, qd, kd, round_kv=rk)
            got = lib.attention_any_smem_bytes(
                d, p["rf"], p["cw"], p["bk"], p["stages"], fa.dtype_code(qd),
                fa.dtype_code(kd), 0 if rk is None else fa.dtype_code(rk))
            assert got == p["smem_bytes"], (d, qd, kd, rk, p)


@pytest.mark.parametrize("dtype", list(GENERAL_RTOL))
@pytest.mark.parametrize("d", [1280, 1536, 2048])
def test_general_route_wide_head_dims(d, dtype):
    """#7 (a window that skips whole key tiles) and #8 (group 2, lengths 0
    and past S) at head dims 1280, 1536 and 2048 in each type, and #8 with
    a float32 q over a bf16 cache: the general route takes the tensor-core
    body where ``general_plan`` fits it and the wide path past the shared
    memory, one general launch each, within the plain version's limit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(d)
    q, k, v = (_bf16_normal(rng, *s).float().to(dtype).cuda()
               for s in ((1, 100, 2, d), (1, 130, 1, d), (1, 130, 1, d)))
    want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, window=50)
    fa.flash_attention.bodies = {}
    got = fa.flash_attention(q, k, v, window=50)
    assert fa.flash_attention.bodies == {"general": 1}
    _within(got, want, GENERAL_RTOL[dtype])
    qd, kc, vc, lens = _decode_operands(d, 3, 150, 4, 2, d, [150, 0, 200])
    for q_type, cache in ((dtype, dtype), (torch.float32, torch.bfloat16)):
        ops = (qd.to(q_type), kc.to(cache), vc.to(cache))
        want = fd.flash_decode_plain(*ops, lens, scale=d ** -0.5)
        fd.flash_decode.bodies = {}
        got = fd.flash_decode(*(t.cuda() for t in ops), lens.cuda())
        assert fd.flash_decode.bodies == {"general": 1}
        _within(got, want, GENERAL_RTOL[q_type])
        assert not got[1].any()
