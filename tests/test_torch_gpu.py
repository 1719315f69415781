"""The port's CUDA kernels against their plain torch versions, on the
card. Every test carries the ``gpu`` marker and skips without a CUDA
device (a CUDA kernel has no CPU mode). This file imports no JAX, so it
runs on a machine that has only the port:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from repro_torch.core.tiles import TileGrid, tdt_standard_conv
from repro_torch.kernels.dcn_fused import (dcn_fused_batch,
                                           dcn_fused_batch_plain)
from repro_torch.kernels.dcn_schedule import (greedy_plain,
                                              greedy_schedule_arrays,
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


@pytest.mark.parametrize("shape", [(1, 20, 16, 8), (2, 196, 1792, 512),
                                   (1, 9, 8, 6)])
def test_bli_kernel(shape):
    from repro_torch.kernels.dcn_bli import bli_tile_matmul, bli_tile_plain

    n, s, p, c = shape
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(n, s, c)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, s + 2, size=(n, p, 4))
                          .astype(np.int32))
    cf = torch.as_tensor(rng.uniform(size=(n, p, 4)).astype(np.float32))
    want = bli_tile_plain(x, idx, cf)
    got = bli_tile_matmul(x.cuda(), idx.cuda(), cf.cuda(), block_p=p,
                          block_c=c).cpu()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
