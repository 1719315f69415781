"""The port's deform reference, TDT, packing and cache against the JAX
package on identical numpy inputs (float functions within 1e-5; integer
tables, digests and schedules exactly)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import deform as jd
from repro.core import scheduler as js
from repro.core import tiles as jt
from repro.runtime import cache as jc
from repro.runtime import packing as jp
from repro_torch.core import deform as td
from repro_torch.core import scheduler as ts
from repro_torch.core import tiles as tt
from repro_torch.runtime import cache as tc
from repro_torch.runtime import packing as tpk

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _params(seed, c_in, c_out, variant="dcn2", off_scale=0.5):
    L = td.offset_channels(3, variant)
    return (_rand(seed, 3, 3, c_in, L, scale=off_scale),
            _rand(seed + 1, L, scale=0.1),
            _rand(seed + 2, 3, 3, c_in, c_out, scale=0.3),
            _rand(seed + 3, c_out))


def _jp(arrs):
    return jd.DeformableConvParams(*(jnp.asarray(a) for a in arrs))


def _tp(arrs):
    return td.DeformableConvParams(*(torch.as_tensor(a) for a in arrs))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d(padding):
    x, w, b = _rand(0, 2, 9, 7, 5), _rand(1, 3, 3, 5, 4), _rand(2, 4)
    want = jd.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     padding=padding)
    got = td.conv2d(torch.as_tensor(x), torch.as_tensor(w),
                    torch.as_tensor(b), padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant,md", [("dcn1", None), ("dcn2", None),
                                        ("dcn2", 0.75)])
def test_offsets_to_coords(variant, md):
    L = td.offset_channels(3, variant)
    off = _rand(3, 2, 6, 5, L, scale=3.0)
    want = jd.offsets_to_coords(jnp.asarray(off), 3, variant, md)
    got = td.offsets_to_coords(torch.as_tensor(off), 3, variant, md)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bli_coefficients_and_sample():
    co = np.abs(_rand(4, 2, 6, 6, 9, 2, scale=3.0)).clip(0, 5)
    f_j, c_j = jd.bli_coefficients(jnp.asarray(co))
    f_t, c_t = td.bli_coefficients(torch.as_tensor(co))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
    x = _rand(5, 2, 6, 6, 3)
    want = jd.bilinear_sample(jnp.asarray(x), jnp.asarray(co))
    got = td.bilinear_sample(torch.as_tensor(x), torch.as_tensor(co))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant,shape,md", [
    ("dcn2", (2, 8, 8, 4, 6), None),
    ("dcn1", (1, 7, 9, 3, 5), None),
    ("dcn2", (1, 13, 13, 4, 4), 1.5),
])
def test_deformable_conv2d(variant, shape, md):
    n, h, w, c, o = shape
    arrs = _params(7, c, o, variant)
    x = _rand(8, n, h, w, c)
    want, wc = jd.deformable_conv2d(jnp.asarray(x), _jp(arrs), 3, variant,
                                    md, return_coords=True)
    got, gc = td.deformable_conv2d(torch.as_tensor(x), _tp(arrs), 3,
                                   variant, md, return_coords=True)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_and_randomize_use_the_generator():
    g = torch.Generator().manual_seed(0)
    p = td.init_deformable_conv(g, 4, 6)
    assert not p.w_off.any() and p.w.shape == (3, 3, 4, 6)
    q = td.randomize_offset_conv(p, torch.Generator().manual_seed(1), 0.5)
    r = td.randomize_offset_conv(p, torch.Generator().manual_seed(1), 0.5)
    assert torch.equal(q.w_off, r.w_off) and q.w_off.abs().sum() > 0


def _coords(seed, h, w, spread=2.0):
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                    -1)[:, :, None, :]
    c = base + rng.normal(scale=spread, size=(h, w, 9, 2))
    return np.clip(c, 0, [h - 1, w - 1]).astype(np.float32)


@pytest.mark.parametrize("h,w,th,tw", [(16, 16, 4, 4), (13, 13, 4, 4),
                                       (10, 14, 3, 4)])
def test_tdt_and_digest(h, w, th, tw):
    co = _coords(h + w, h, w)
    jg, tg = jt.TileGrid(h, w, th, tw), tt.TileGrid(h, w, th, tw)
    want = np.asarray(jt.tdt_from_coords(jnp.asarray(co), jg, jg))
    got = tt.tdt_from_coords(torch.as_tensor(co), tg, tg).numpy()
    np.testing.assert_array_equal(got, want)
    assert tc.coords_digest(torch.as_tensor(co), tg) == \
        jc.coords_digest(co, jg)
    assert tc.conv_digest(3, tg) == jc.conv_digest(3, jg)
    assert tc.chain_digest(["a", "b"], tg) == jc.chain_digest(["a", "b"], jg)
    np.testing.assert_array_equal(tt.tdt_standard_conv(tg, tg, 3),
                                  jt.tdt_standard_conv(jg, jg, 3))


def test_compose_chain_device_and_schedules():
    rng = np.random.default_rng(9)
    layers = [rng.random((9, 9)) < 0.3 for _ in range(3)]
    want = jt.compose_tdt_chain(layers)
    np.testing.assert_array_equal(tt.compose_tdt_chain(layers), want)
    got = tt.compose_tdt_chain_device([torch.as_tensor(b) for b in layers])
    np.testing.assert_array_equal(got.numpy(), want)
    for m in (2, 9):
        a, b = ts.schedule_tiles(want, m), js.schedule_tiles(want, m)
        assert (a.oid, a.iid, a.reuse_overlap) == \
            (b.oid, b.iid, b.reuse_overlap)
    a, b = ts.sequential_schedule(want), js.sequential_schedule(want)
    assert (a.oid, a.iid) == (b.oid, b.iid)


@pytest.mark.parametrize("h,tile,p_pad", [(12, 4, 16), (13, 4, 16),
                                          (10, 3, 16)])
def test_pack_plane_operands(h, tile, p_pad):
    co = np.stack([_coords(h + i, h, h) for i in range(2)])
    jg, tg = jt.TileGrid(h, h, tile, tile), tt.TileGrid(h, h, tile, tile)
    wi, wc = jax.vmap(lambda c: jp.pack_plane_operands(c, jg, p_pad))(
        jnp.asarray(co))
    gi, gc = tpk.pack_plane_operands(torch.as_tensor(co), tg, p_pad)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)
    x = _rand(1, h, h, 5)
    tiles = tpk.plane_to_tiles(torch.as_tensor(x), tg)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jp.plane_to_tiles(jnp.asarray(x), jg)))
    np.testing.assert_array_equal(
        tpk.tiles_to_plane(tiles, tg, h, h).numpy(), x)


def test_pack_batch_schedules():
    rng = np.random.default_rng(2)
    b = [rng.random((9, 9)) < 0.4 for _ in range(2)]
    b[1][:] = False
    b[1][0, 3] = True            # a one-step schedule: ragged padding
    j_scheds = [js.DeviceSchedule.from_host(js.schedule_tiles(x, 4), 9)
                for x in b]
    t_scheds = [ts.DeviceSchedule.from_host(ts.schedule_tiles(x, 4), 9)
                for x in b]
    want = jp.pack_batch_schedules(j_scheds, 9, 9)
    got = tpk.pack_batch_schedules(t_scheds, 9, 9, "cpu")
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
