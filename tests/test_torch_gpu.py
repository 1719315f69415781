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
