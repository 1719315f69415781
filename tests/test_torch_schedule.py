"""``schedule_group_batch`` (one launch per fused group: TDTs, composite,
Algorithm 1 and the dispatch tables) against the JAX package, on the CPU
where the wrapper runs its plain version.

The same numpy inputs go through the JAX path per image —
``tdt_from_coords_device`` (interpret mode) per DCN layer, the standard
conv's constant table, ``compose_tdt_chain``, ``greedy_schedule_arrays``
(interpret mode), ``dispatch_arrays_from_klass`` and
``tdt_dispatch_arrays`` gathered by the schedule for the chain's last
layer — and through one ``schedule_group_batch`` call for the listed
images. Held bit-exact: every output is integer work.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.tiles import TileGrid as JGrid
from repro.core.tiles import compose_tdt_chain as j_compose
from repro.core.tiles import tdt_standard_conv as j_conv_tdt
from repro.kernels import dcn_schedule as j_sched
from repro_torch.core.scheduler import pow2_pad
from repro_torch.core.tiles import TileGrid
from repro_torch.kernels.dcn_schedule import (_Layout, _pack_rows,
                                              schedule_group_batch,
                                              schedule_group_batch_plain)


def _coords(rng, n, h, w, kk=9, spread=2.0):
    base = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                    -1)[None, :, :, None, :]
    c = base + rng.normal(scale=spread, size=(n, h, w, kk, 2))
    return np.clip(c, -1.5, [h + 0.5, w + 0.5]).astype(np.float32)


def _tables(rng, n, t):
    """Given tables with rows that have no dependency, so the schedule
    ends in a padded suffix."""
    b = rng.random((n, t, t)) < 0.3
    b[:, ::3] = False
    return b


# name -> (plane h, w, tile th, tw, layer specs, batch, listed images, m):
# a spec is "dcn" (coordinates), "dcn1" (a 1x1 deformable layer), an int
# (a standard conv's kernel size) or "table" (a given TDT per image).
CASES = {
    "serving shape": (14, 14, 8, 8, ["dcn"], 4, [0, 1, 2, 3], 4),
    "ragged conv+dcn m1": (13, 13, 4, 4, [3, "dcn"], 2, [0, 1], 1),
    "ragged conv+dcn m3": (13, 13, 4, 4, [3, "dcn"], 2, [1, 0], 3),
    "ragged conv+dcn m>=n_in": (13, 13, 4, 4, [3, "dcn"], 2, [0, 1], 16),
    "two dcn m1": (13, 13, 4, 4, ["dcn", "dcn"], 3, [0, 2], 1),
    "two dcn m3, skips images": (13, 13, 4, 4, ["dcn", "dcn"], 3, [2, 0], 3),
    "two dcn m>=n_in": (13, 13, 4, 4, ["dcn", "dcn"], 2, [1], 40),
    "conv dcn dcn conv": (13, 11, 4, 4, [3, "dcn", "dcn", 3], 2, [0, 1], 5),
    "1x1 dcn after conv": (12, 10, 4, 3, [3, "dcn1"], 2, [1], 3),
    "padded suffix": (12, 12, 4, 4, ["table"], 3, [1, 2], 3),
    "table after conv": (12, 12, 4, 4, [3, "table"], 2, [0, 1], 2),
    "conv only": (16, 16, 4, 4, [3, 3], 2, [0, 1], 4),
}


def _inputs(name):
    h, w, th, tw, specs, n, images, m = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    t = -(-h // th) * -(-w // tw)
    layers = []
    for spec in specs:
        if spec == "dcn":
            layers.append(_coords(rng, n, h, w))
        elif spec == "dcn1":
            layers.append(_coords(rng, n, h, w, kk=1))
        elif spec == "table":
            layers.append(_tables(rng, n, t))
        else:
            layers.append(spec)
    return layers, (h, w, th, tw), images, m, pow2_pad(t)


def _jax_reference(layers, grid_hw, images, m, k_pad):
    """Per image: the JAX kernels and glue, as numpy."""
    jg = JGrid(*grid_hw)
    t = jg.num_tiles
    last = len(layers) - 1
    out = []
    for i in images:
        b_layers = []
        for layer in layers:
            if isinstance(layer, int):
                b_layers.append(np.asarray(j_conv_tdt(jg, jg, layer)))
            elif layer.dtype == np.bool_:
                b_layers.append(layer[i])
            else:
                b_layers.append(np.asarray(j_sched.tdt_from_coords_device(
                    jnp.asarray(layer[i]), jg, jg, interpret=True)))
        comp = j_compose(b_layers)
        oid_seq, klass, ovl = j_sched.greedy_schedule_arrays(
            jnp.asarray(comp), m, interpret=True)
        oid, dep, cnt = (np.asarray(a) for a in
                         j_sched.dispatch_arrays_from_klass(oid_seq, klass,
                                                            k_pad))
        execs = []
        for j, (layer, b) in enumerate(zip(layers, b_layers)):
            if isinstance(layer, int):
                execs.append(None)
                continue
            dep_j, cnt_j = (np.asarray(a) for a in
                            j_sched.tdt_dispatch_arrays(jnp.asarray(b),
                                                        k_pad))
            if j == last:
                sel = np.maximum(oid, 0)
                dep_j, cnt_j = dep_j[sel], np.where(oid >= 0, cnt_j[sel], 0)
            execs.append((dep_j, cnt_j))
        out.append(dict(tdt=b_layers, oid=oid, dep=dep, cnt=cnt,
                        ovl=np.asarray(ovl).reshape(-1), exec=execs,
                        t=t))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_group_batch_bit_exact_vs_jax(name):
    layers, grid_hw, images, m, k_pad = _inputs(name)
    want = _jax_reference(layers, grid_hw, images, m, k_pad)
    got = schedule_group_batch(
        [lay if isinstance(lay, int) else torch.as_tensor(lay)
         for lay in layers], images, TileGrid(*grid_hw), m, k_pad,
        device="cpu")
    assert got.buf.shape[0] == len(images)
    for k, w in enumerate(want):
        im = got.image(k)
        t = w["t"]
        for b_got, b_want in zip(im.tdt, w["tdt"]):
            assert b_got.dtype == torch.bool and b_got.shape == (t, t)
            np.testing.assert_array_equal(b_got.numpy(), b_want)
        for a, b in ((im.oid, w["oid"]), (im.dep_tbl, w["dep"]),
                     (im.dep_cnt, w["cnt"]), (im.overlap, w["ovl"])):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(im.ar.numpy(), np.arange(t))
        np.testing.assert_array_equal(im.zero.numpy(), np.zeros(t))
        for j, (e_got, e_want) in enumerate(zip(im.exec, w["exec"])):
            assert (e_got is None) == (e_want is None)
            if e_got is None:
                continue
            is_last = j == len(layers) - 1
            assert e_got[0] is (im.oid if is_last else im.ar)
            np.testing.assert_array_equal(e_got[1].numpy(), e_want[0])
            np.testing.assert_array_equal(e_got[2].numpy(), e_want[1])


def test_padded_suffix_is_reached():
    """The "padded suffix" case really ends in oid = -1 rows."""
    layers, grid_hw, images, m, k_pad = _inputs("padded suffix")
    got = schedule_group_batch([torch.as_tensor(layers[0])], images,
                               TileGrid(*grid_hw), m, k_pad)
    for k in range(len(images)):
        oid = got.image(k).oid
        assert (oid == -1).any() and (got.image(k).dep_cnt[oid < 0] == 0).all()


def test_own_copy_and_layout():
    """``image(k, own=True)`` holds its own storage, equal to the view;
    the layout's words are a multiple of 4 and cover every region."""
    layers, grid_hw, images, m, k_pad = _inputs("two dcn m3, skips images")
    tl = [torch.as_tensor(lay) for lay in layers]
    got = schedule_group_batch(tl, images, TileGrid(*grid_hw), m, k_pad)
    for k in range(len(images)):
        view, own = got.image(k), got.image(k, own=True)
        assert own.oid.untyped_storage().nbytes() == got.layout.words * 4
        for a, b in zip(view.tensors(), own.tensors()):
            assert torch.equal(a, b)
    lay = _Layout.of([0, 1, 2], 16, 16)
    assert lay.words % 4 == 0
    assert lay.exec_off[1] is None and lay.tdt_off[2] is None
    assert lay.tdt_off[0] + 16 * 16 // 4 <= lay.words


def test_plain_is_the_cpu_path_and_validates():
    layers, grid_hw, images, m, k_pad = _inputs("serving shape")
    grid = TileGrid(*grid_hw)
    tl = [torch.as_tensor(layers[0])]
    a = schedule_group_batch(tl, images, grid, m, k_pad)
    b = schedule_group_batch_plain(tl, images, grid, m, k_pad)
    assert torch.equal(a.buf, b.buf)
    assert schedule_group_batch.launches == 0     # no kernel on the CPU
    with pytest.raises(ValueError, match="k_pad"):
        schedule_group_batch(tl, images, grid, m, 2)
    with pytest.raises(ValueError, match="capacity"):
        schedule_group_batch(tl, images, grid, 0, k_pad)
    with pytest.raises(ValueError, match="coordinates"):
        schedule_group_batch([tl[0][:, :7]], images, grid, m, k_pad)
    with pytest.raises(ValueError, match="1..8"):
        schedule_group_batch([3] * 9, [0], grid, m, k_pad, device="cpu")
    with pytest.raises(ValueError, match="device"):
        schedule_group_batch([3], [0], grid, m, k_pad)


@pytest.mark.parametrize("n_in", [5, 32, 33, 100])
def test_pack_rows(n_in):
    b = np.random.default_rng(n_in).random((7, n_in)) < 0.4
    words = _pack_rows(b).view(np.uint32)
    assert words.shape == (7, -(-n_in // 32))
    for r in range(7):
        for t in range(n_in):
            assert bool((words[r, t // 32] >> (t % 32)) & 1) == b[r, t]


def _small_net():
    from repro_torch.core.deform import randomize_offset_conv
    from repro_torch.models.dcn_models import DcnNetConfig, init_dcn_net
    from repro_torch.runtime.graph import build_graph

    cfg = DcnNetConfig("vgg19", n_deform=2, variant="dcn2", img_size=16,
                       width_mult=0.125, num_classes=4)
    params = init_dcn_net(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    convs = [randomize_offset_conv(p, gen, 2.0 / p.w.shape[2])
             if hasattr(p, "w_off") else p for p in params["convs"]]
    return convs, build_graph(cfg)


def test_batch_prepass_resolves_misses_like_get_or_build():
    """The device prepass lists a group's misses for one call; a repeated
    image in the batch counts as the hit a sequential ``get_or_build``
    would see, so its cache counters, trace records and outputs equal the
    host backend's."""
    from repro_torch.runtime.cache import ScheduleCache
    from repro_torch.runtime.fused_exec import GraphConfig, run_graph

    convs, graph = _small_net()
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(3, 16, 16, 3)).astype(np.float32))
    x = torch.cat([x, x[1:2]])                 # image 3 repeats image 1
    runs = {}
    for backend in ("host", "device"):
        cache = ScheduleCache()
        y, tr = run_graph(convs, graph, x, config=GraphConfig(
            tile=4, schedule_backend=backend), schedule_cache=cache,
            return_trace=True)
        runs[backend] = (y, tr, (cache.hits, cache.misses, cache.image_hits,
                                 cache.image_lookups, len(cache)))
    (y_h, tr_h, c_h), (y_d, tr_d, c_d) = runs["host"], runs["device"]
    assert c_d == c_h and c_d[0] > 0
    assert torch.equal(y_d, y_h)
    rec = [[dataclasses.astuple(r) for r in g.records] for g in tr_d.groups]
    assert rec == [[dataclasses.astuple(r) for r in g.records]
                   for g in tr_h.groups]


def test_batch_digests_from_one_host_copy():
    """Digests of one host copy of a batch equal the per-image tensor
    digests (the strings the JAX package pins)."""
    from repro_torch.runtime.cache import coords_digest

    co = torch.as_tensor(_coords(np.random.default_rng(2), 3, 13, 13))
    grid = TileGrid(13, 13, 4, 4)
    host = co.numpy()
    assert [coords_digest(host[i], grid) for i in range(3)] == \
        [coords_digest(co[i], grid) for i in range(3)]
