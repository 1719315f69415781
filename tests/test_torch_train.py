"""The port's training slice against the JAX package, on the CPU: the DCN
trainer, the optimizer, the data pipeline, checkpoints, the kernel
wrappers' grad guard and the serving engine's timeline.

Inputs are made with numpy from fixed seeds and fed to both packages;
parameters and optimizer state come from the JAX initialisers and cross
through ``repro_torch.convert``. Tolerances:

* ``offsets_to_coords`` gradients equal to ``jax.grad``'s (the clamp
  passes 1, 1/2 at a tie with a bound, or 0: no rounding; DCN-I within
  1e-6 * max|ref|, its K*K taps' terms summed in another order);
* ``fused_deformable_conv2d`` output and gradients within 1e-4 * max|ref|
  of JAX, and equal to the port's unfused function;
* the VGG19-3 smoke network's loss within relative 1e-5 and each
  gradient leaf within 1e-4 * max|ref| (16 layers of float32 sums in
  another order);
* one AdamW update within 1e-6 (float32 elementwise arithmetic; bfloat16
  moments within one bfloat16 rounding);
* three training steps: losses within relative 1e-4, parameters within
  ``2 * lr * steps`` absolute — Adam moves every weight by about lr a
  step whatever its gradient's size, so a gradient at rounding level may
  flip a step's sign between the packages;
* data batches bit-equal; checkpoints restored bit-equal across packages.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as j_ckpt
from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.core import deform as j_deform
from repro.models import dcn_models as j_dcn
from repro.obs import Tracer as JTracer
from repro.runtime import GraphConfig as JGraphConfig
from repro.serving import DcnServingEngine as JEngine
from repro.testing import FaultInjector as JInjector
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch import data
from repro_torch import optim
from repro_torch._tree import (flatten_with_names, tree_leaves, tree_map,
                               value_and_grad)
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import deform
from repro_torch.core.fusion import plan_fusion
from repro_torch.core.simulator import simulate_strategies
from repro_torch.kernels import dcn_bli, dcn_fused, flash_attention, \
    flash_decode
from repro_torch.launch import train
from repro_torch.models import dcn_models
from repro_torch.obs import Tracer
from repro_torch.runtime import GraphConfig
from repro_torch.serving import DcnServingEngine
from repro_torch.testing import FaultInjector


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _offsets(rng, n, h, w, kk, variant, kind, md):
    L = 2 if variant == "dcn1" else 2 * kk * kk
    if kind == "zero":
        return np.zeros((n, h, w, L), np.float32)
    off = (rng.normal(size=(n, h, w, L)) * 2.0).astype(np.float32)
    if md is not None:     # some offsets exactly on the displacement bound
        off.reshape(-1)[::7] = md
        off.reshape(-1)[3::11] = -md
    return off


# -- the coordinate clamp's gradient ------------------------------------------

@pytest.mark.parametrize("md", [None, 1.0])
@pytest.mark.parametrize("kind", ["zero", "random"])
@pytest.mark.parametrize("variant", ["dcn1", "dcn2"])
def test_offsets_to_coords_gradient_equals_jax(variant, kind, md):
    rng = np.random.default_rng(1)
    kk = 5 if variant == "dcn2" else 3
    off = _offsets(rng, 2, 5, 6, kk, variant, kind, md)
    cot = rng.normal(size=(2, 5, 6, kk * kk, 2)).astype(np.float32)
    want = jax.grad(lambda o: jnp.sum(j_deform.offsets_to_coords(
        o, kk, variant, md) * cot))(jnp.asarray(off))
    t = torch.as_tensor(off).requires_grad_(True)
    coords = deform.offsets_to_coords(t, kk, variant, md)
    (coords * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_array_equal(
        coords.detach().numpy(),
        np.asarray(j_deform.offsets_to_coords(jnp.asarray(off), kk, variant,
                                              md)))
    want = np.asarray(want)
    if variant == "dcn2":
        np.testing.assert_array_equal(t.grad.numpy(), want)
    else:   # DCN-I sums the K*K taps' terms, in another order than XLA
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# -- the stage-fused deformable conv ------------------------------------------

def _dcn_layer(seed, c_in, c_out, variant):
    key = jax.random.PRNGKey(seed)
    p = j_deform.init_deformable_conv(key, c_in, c_out, 3, variant)
    return j_deform.randomize_offset_conv(p, jax.random.fold_in(key, 1),
                                          1.0 / c_in)


@pytest.mark.parametrize("md", [None, 1.5])
@pytest.mark.parametrize("variant", ["dcn1", "dcn2"])
def test_fused_deformable_conv2d_matches_jax_and_unfused(variant, md):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 6, 4)).astype(np.float32)
    jp = _dcn_layer(3, 4, 5, variant)
    cot = rng.normal(size=(2, 7, 6, 5)).astype(np.float32)

    def jloss(x, p):
        y = j_deform.fused_deformable_conv2d(x, p, 3, variant, md)
        return jnp.sum(y * cot), y
    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jp)
    want = [jg[0], *jg[1]]

    got = {}
    for fused in (True, False):
        fn = deform.fused_deformable_conv2d if fused else \
            deform.deformable_conv2d
        leaves = [torch.as_tensor(x)] + [torch.as_tensor(np.array(a))
                                         for a in jp]
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        y = fn(leaves[0], deform.DeformableConvParams(*leaves[1:]), 3,
               variant, md)
        (y * torch.as_tensor(cot)).sum().backward()
        got[fused] = [y.detach()] + [t.grad for t in leaves]
    assert _max_rel(got[True][0], jy) <= 1e-4
    for name, g, w in zip(("x", *jp._fields), got[True][1:], want):
        assert _max_rel(g, w) <= 1e-4, name
    for a, b in zip(got[True], got[False]):
        assert torch.equal(a, b)


# -- the network's loss and gradients -----------------------------------------

def _vgg_case(random_offsets: bool):
    jcfg = j_configs.get_dcn_config("vgg19", 3, smoke=True)
    key = jax.random.PRNGKey(4)
    jp = j_dcn.init_dcn_net(key, jcfg)
    if random_offsets:
        jp["convs"] = [
            j_deform.randomize_offset_conv(p, jax.random.fold_in(key, 50 + i),
                                           1.0 / p.w.shape[2])
            if isinstance(p, j_deform.DeformableConvParams) else p
            for i, p in enumerate(jp["convs"])]
    return jcfg, jp, configs.get_dcn_config("vgg19", 3, smoke=True)


@functools.lru_cache(maxsize=None)
def _jax_dcn_value_and_grad(jcfg):
    """The JAX example's loss and its gradient, compiled once a config."""
    def loss_fn(p, images, labels):
        logits = j_dcn.dcn_net_apply(p, jcfg, images)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None], 1)[:, 0]
        return jnp.mean(lse - gold)
    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("random_offsets", [False, True])
def test_dcn_net_loss_and_gradients_match_jax(random_offsets):
    jcfg, jp, cfg = _vgg_case(random_offsets)
    b = data.image_batch(data.DataConfig(seed=3, global_batch=2), 0,
                         img=cfg.img_size, classes=cfg.num_classes)
    jl, jg = _jax_dcn_value_and_grad(jcfg)(
        jp, jnp.asarray(b["images"]), jnp.asarray(b["labels"]))
    tp = params_from_jax(_np(jp), device="cpu")
    tl, tg = value_and_grad(lambda p: train.dcn_loss(
        p, cfg, torch.as_tensor(b["images"]), torch.as_tensor(b["labels"])),
        tp)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    names = [n for n, _ in flatten_with_names(tg)]
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, g, w in zip(names, tree_leaves(tg), jax.tree.leaves(jg)):
        if np.abs(np.asarray(w)).max() == 0:
            assert float(g.abs().max()) == 0.0, name
        else:
            assert _max_rel(g, w) <= 1e-4, name


def test_dcn_net_fused_equals_unfused():
    _, jp, cfg = _vgg_case(True)
    tp = params_from_jax(_np(jp), device="cpu")
    b = data.image_batch(data.DataConfig(seed=4, global_batch=2), 0,
                         img=cfg.img_size, classes=cfg.num_classes)
    x, y = torch.as_tensor(b["images"]), torch.as_tensor(b["labels"])
    out = [value_and_grad(lambda p: train.dcn_loss(p, cfg, x, y,
                                                   fused=fused), tp)
           for fused in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b_ in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b_)


# -- the optimizer ------------------------------------------------------------

def _opt_tree(rng):
    """A DCN-shaped tree (NamedTuple, dicts, 1-D and 4-D leaves)."""
    p = j_deform.DeformableConvParams(
        *(rng.normal(size=s).astype(np.float32)
          for s in ((3, 3, 2, 18), (18,), (3, 3, 2, 4), (4,))))
    return {"convs": [p, {"w": rng.normal(size=(3, 3, 4, 4)).astype(
        np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}],
        "fc": {"w": rng.normal(size=(4, 3)).astype(np.float32),
               "b": rng.normal(size=(3,)).astype(np.float32)}}


def test_cosine_lr_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(j_optim.cosine_lr(j_optim.AdamWConfig(**cfg),
                                       jnp.int32(step)))
        got = float(optim.cosine_lr(optim.AdamWConfig(**cfg),
                                    torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3), step


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _opt_tree(np.random.default_rng(5))
    jg, jn = j_optim.clip_by_global_norm(g, max_norm)
    tg, tn = optim.clip_by_global_norm(params_from_jax(g, device="cpu"),
                                       max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert abs(float(optim.global_norm(tg))
               - float(j_optim.global_norm(jg))) <= 1e-6 * float(jn)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("step", [0, 7, 150])
def test_adamw_update_matches_jax(step, clip, state):
    rng = np.random.default_rng(6 + step)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    kw = dict(lr=1e-2, warmup_steps=10, total_steps=100, clip_norm=clip)
    jcfg = j_optim.AdamWConfig(
        **kw, state_dtype=jnp.bfloat16 if state == "bf16" else jnp.float32)
    tcfg = optim.AdamWConfig(
        **kw, state_dtype=torch.bfloat16 if state == "bf16"
        else torch.float32)
    jstate = j_optim.init_opt_state(params, jcfg)
    jstate = {"step": jnp.int32(step),
              "m": jax.tree.map(lambda p: jnp.asarray(
                  rng.normal(size=p.shape) * 0.1, jcfg.state_dtype), params),
              "v": jax.tree.map(lambda p: jnp.asarray(
                  rng.uniform(size=p.shape) * 0.01, jcfg.state_dtype),
                  params)}
    jp, js, jm = j_optim.adamw_update(params, grads, jstate, jcfg)
    tparams = params_from_jax(params, device="cpu")
    tstate = opt_state_from_jax(_np(jstate), device="cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    assert tree_leaves(tstate["m"])[0].dtype == tcfg.state_dtype
    tp, ts, tm = optim.adamw_update(tparams, params_from_jax(grads, "cpu"),
                                    tstate, tcfg)
    assert tp is tparams and ts is tstate          # written in place
    assert int(ts["step"]) == int(js["step"]) == step + 1
    for k in ("lr", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * float(jm[k]), k
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    ulp = 2.0 ** -8 if state == "bf16" else 1e-6
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(ts[part]), jax.tree.leaves(js[part])):
            assert a.dtype == tcfg.state_dtype
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(a.float().numpy(), b, rtol=ulp,
                                       atol=1e-7)


def test_decay_applies_to_matrices_only():
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = tree_map(torch.zeros_like, p)
    cfg = optim.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    new, _, _ = optim.adamw_update(p, g, optim.init_opt_state(p, cfg), cfg)
    assert torch.all(new["w"] < 1) and torch.equal(new["b"], p["b"])


def test_quantize_roundtrip_matches_jax():
    x = np.random.default_rng(7).normal(size=(5, 9)).astype(np.float32)
    jq, js = j_optim.quantize(jnp.asarray(x))
    tq, ts = optim.quantize(torch.as_tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        optim.dequantize(tq, ts).numpy(),
        np.asarray(j_optim.dequantize(jq, js)))
    err = optim.init_error_state({"a": torch.ones(2, 3)})
    assert err["a"].dtype == torch.float32 and not err["a"].any()


# -- three DCN training steps -------------------------------------------------

def test_three_dcn_train_steps_match_jax():
    jcfg, jp, cfg = _vgg_case(False)
    steps, lr = 3, 3e-3
    ocfg = dict(lr=lr, warmup_steps=1, total_steps=steps, weight_decay=0.01)
    jocfg, tocfg = j_optim.AdamWConfig(**ocfg), optim.AdamWConfig(**ocfg)
    vg = _jax_dcn_value_and_grad(jcfg)
    update = jax.jit(lambda p, g, o: j_optim.adamw_update(p, g, o, jocfg))

    def jstep(p, o, images, labels):
        loss, g = vg(p, images, labels)
        p, o, _ = update(p, g, o)
        return p, o, loss

    jo = j_optim.init_opt_state(jp, jocfg)
    tp = params_from_jax(_np(jp), device="cpu")
    to = opt_state_from_jax(_np(jo), device="cpu")
    dcfg = data.DataConfig(seed=8, global_batch=2)
    for s in range(steps):
        b = data.image_batch(dcfg, s, img=cfg.img_size,
                             classes=cfg.num_classes)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(b["images"]),
                           jnp.asarray(b["labels"]))
        tp, to, tl = train.dcn_train_step(
            tp, to, torch.as_tensor(b["images"]),
            torch.as_tensor(b["labels"]), cfg, tocfg)
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), s
    assert int(to["step"]) == steps
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2 * lr * steps


def test_dcn_train_loop_learns_on_the_cpu(tmp_path):
    cfg = dcn_models.DcnNetConfig("vgg19", 1, "dcn2", img_size=8,
                                  width_mult=0.125, num_classes=2)
    _, opt, losses = train.dcn_train_loop(
        cfg, steps=4, batch=4, lr=1e-2, ckpt_dir=str(tmp_path),
        ckpt_every=2, verbose=False, device="cpu")
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert ckpt.completed_steps(str(tmp_path)) == [2, 4]
    assert int(opt["step"]) == 4


@pytest.mark.parametrize("backend", ["pallas", "pipeline", "graph"])
def test_kernel_backends_refuse_a_gradient(backend):
    cfg = dcn_models.DcnNetConfig("vgg19", 1, img_size=8, width_mult=0.125,
                                  num_classes=2)
    params = dcn_models.init_dcn_net(0, cfg, device="cpu")
    x = torch.randn(1, 8, 8, 3)
    with torch.no_grad():
        dcn_models.dcn_net_apply(params, cfg, x, backend=backend)
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(lambda p: dcn_models.dcn_net_apply(
            p, cfg, x, backend=backend).sum(), params)
    with pytest.raises(ValueError, match="forward-only"):
        dcn_models.dcn_net_apply(params, cfg, x.requires_grad_(True),
                                 backend=backend)


# -- the grad guard of the float kernels --------------------------------------

def _wrapper_calls():
    """(name, wrapper, float operands, int operands, call) for #1, #4-#8
    on tiny valid operands."""
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    w, b = f(1, 2, 3), f(3)
    idx = torch.zeros((2, 2, 1, 4), dtype=torch.int32)
    coeff = f(2, 2, 1, 4)
    return [
        ("dcn_fused_batch", dict(x_tiles=f(2, 4, 2), coeff=coeff, w=w, b=b),
         lambda o: dcn_fused.dcn_fused_batch(
             o["x_tiles"], i32(0, 1), i32([0], [1]), i32(1, 1), idx,
             o["coeff"], o["w"], o["b"], t_in=2)),
        ("dcn_fused_schedule", dict(x_tiles=f(2, 4, 2), coeff=coeff, w=w,
                                    b=b),
         lambda o: dcn_fused.dcn_fused_schedule(
             o["x_tiles"], i32([0], [1]), i32(1, 1), idx, o["coeff"],
             o["w"], o["b"])),
        ("dcn_fused_tile", dict(x_tile=f(4, 2), coeff=f(2, 1, 4), w=w, b=b),
         lambda o: dcn_fused.dcn_fused_tile(
             o["x_tile"], idx[0], o["coeff"], o["w"], o["b"])),
        ("bli_tile_matmul", dict(x_tile=f(4, 2), coeff=f(2, 4)),
         lambda o: dcn_bli.bli_tile_matmul(
             o["x_tile"], torch.zeros((2, 4), dtype=torch.int32),
             o["coeff"])),
        ("flash_attention", dict(q=f(1, 4, 2, 8), k=f(1, 4, 2, 8),
                                 v=f(1, 4, 2, 8)),
         lambda o: flash_attention.flash_attention(o["q"], o["k"], o["v"])),
        ("flash_decode", dict(q=f(1, 2, 8), k_cache=f(1, 4, 2, 8),
                              v_cache=f(1, 4, 2, 8)),
         lambda o: flash_decode.flash_decode(o["q"], o["k_cache"],
                                             o["v_cache"], i32(3))),
    ]


@pytest.mark.parametrize("case", range(6))
def test_float_kernel_wrappers_refuse_operands_that_require_grad(case):
    name, ops, call = _wrapper_calls()[case]
    want = call(ops)
    for k in ops:
        bad = dict(ops, **{k: ops[k].clone().requires_grad_(True)})
        with pytest.raises(ValueError, match=f"{k} requires grad"):
            call(bad)
        with torch.no_grad():
            assert torch.equal(call(bad), want), name
    assert not want.requires_grad


def test_lm_flash_path_refuses_a_gradient():
    import dataclasses
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b", smoke=True),
                              use_flash=True)
    p = lm.init_lm(cfg, 0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 9))}
    with pytest.raises(ValueError, match="requires grad"):
        value_and_grad(lambda q: lm.lm_loss(q, cfg, batch), p)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(seed=3, vocab=50, seq=9, global_batch=4, n_codebooks=4),
    dict(global_batch=8, n_hosts=2, host_id=1, cross_tokens=3,
         cross_dim=5)])
def test_batches_equal_jax(kw):
    jc, tc = j_data.DataConfig(**kw), data.DataConfig(**kw)
    assert data.host_slice(tc) == j_data.host_slice(jc)
    for step in (0, 5):
        want, got = j_data.token_batch(jc, step), data.token_batch(tc, step)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        want = j_data.image_batch(jc, step, img=12, classes=5)
        got = data.image_batch(tc, step, img=12, classes=5)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_iterator_yields_steps_in_order():
    it = data.PrefetchIterator(lambda s: s * s, start_step=3, prefetch=2)
    try:
        assert [next(it) for _ in range(4)] == [(3, 9), (4, 16), (5, 25),
                                                (6, 36)]
    finally:
        it.close()


# -- checkpoints --------------------------------------------------------------

def _ckpt_trees(state_dtype=jnp.float32):
    """A DCN-shaped params tree and AdamW state in both packages."""
    rng = np.random.default_rng(10)
    jp = _opt_tree(rng)
    jo = {"step": np.int32(7),
          "m": jax.tree.map(lambda p: np.asarray(
              jnp.asarray(rng.normal(size=p.shape), state_dtype)), jp),
          "v": jax.tree.map(lambda p: np.asarray(
              jnp.asarray(rng.uniform(size=p.shape), state_dtype)), jp)}
    jtree = {"params": jp, "opt": jo}
    ttree = {"params": params_from_jax(jp, device="cpu"),
             "opt": opt_state_from_jax(jo, device="cpu")}
    return jtree, ttree


def _assert_trees_equal(ttree, jtree):
    tl, jl = tree_leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32))


def test_checkpoints_cross_between_the_packages(tmp_path):
    jtree, ttree = _ckpt_trees()
    j_ckpt.save(str(tmp_path / "jax"), 3, jtree)
    ckpt.save(str(tmp_path / "port"), 3, ttree)
    manifests = [json.load(open(tmp_path / d / "step_00000003" /
                                "manifest.json")) for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    zeros = tree_map(torch.zeros_like, ttree)
    _assert_trees_equal(ckpt.restore(str(tmp_path / "jax"), 3, zeros,
                                     device="cpu"), jtree)
    back = j_ckpt.restore(str(tmp_path / "port"), 3,
                          jax.tree.map(jnp.zeros_like, jtree))
    _assert_trees_equal(ttree, back)


def test_bf16_state_roundtrips(tmp_path):
    _, ttree = _ckpt_trees(jnp.bfloat16)
    assert tree_leaves(ttree["opt"]["m"])[0].dtype == torch.bfloat16
    ckpt.save(str(tmp_path), 1, ttree)
    back = ckpt.restore(str(tmp_path), 1, ttree, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_n_and_torn_writes_stay_invisible(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "s": torch.tensor(1)}
    for s in range(1, 6):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.completed_steps(d) == [4, 5]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))      # killed writer
    os.makedirs(os.path.join(d, "step_00000008"))          # no manifest
    assert ckpt.latest_step(d) == 5
    assert ckpt.completed_steps(str(tmp_path / "none")) == []
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, 5, {"w": tree["w"]}, device="cpu")


def test_async_checkpointer_snapshots_before_an_inplace_update(tmp_path):
    d = str(tmp_path)
    w = torch.zeros(3)
    ac = ckpt.AsyncCheckpointer(d, keep=3)
    ac.save(1, {"w": w})
    w.add_(1.0)                      # the trainer updates in place at once
    ac.save(2, {"w": w})
    ac.wait()
    assert ckpt.completed_steps(d) == [1, 2]
    for s, v in ((1, 0.0), (2, 1.0)):
        got = ckpt.restore(d, s, {"w": w}, device="cpu")["w"]
        assert torch.equal(got, torch.full((3,), v))
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "f"))
    os.makedirs(tmp_path / "f")
    (tmp_path / "f" / "step_00000001.tmp").write_text("a file, not a dir")
    bad.save(1, {"w": w})
    with pytest.raises(Exception):
        bad.wait()


def test_resume_equals_an_unbroken_train_loop(tmp_path):
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    shape = configs.ShapeCell("t", "train", 8, 2)
    kw = dict(opt_cfg=optim.AdamWConfig(lr=1e-2, warmup_steps=1,
                                        total_steps=4),
              ckpt_every=2, verbose=False, device="cpu")
    _, _, whole = train.train_loop(cfg, shape, steps=4, **kw)
    d = str(tmp_path)
    _, _, first = train.train_loop(cfg, shape, steps=2, ckpt_dir=d, **kw)
    assert ckpt.completed_steps(d) == [2]
    p, o, rest = train.train_loop(cfg, shape, steps=4, ckpt_dir=d, **kw)
    assert first + rest == whole
    assert int(o["step"]) == 4 and ckpt.completed_steps(d) == [2, 4]


# -- the paper helpers --------------------------------------------------------

@pytest.mark.parametrize("n_deform", [3, 8, -1])
@pytest.mark.parametrize("name", ["vgg19", "segnet"])
def test_paper_plans_over_layer_shapes_equal_jax(name, n_deform):
    """``get_dcn_config`` and ``layer_shapes`` equal JAX's, and so do
    ``plan_fusion`` over each layer (the paper's 384 KB on-chip budget)
    and ``simulate_strategies`` over each distinct layer shape, fed one
    measured TDT of that plane (4 x 4 tiles)."""
    from repro.core import fusion as j_fusion
    from repro.core import simulator as j_sim
    from repro.core import tiles as j_tiles
    from repro_torch.core.tiles import (make_square_grid,
                                        per_pixel_input_tiles,
                                        tdt_from_coords)

    jcfg = j_configs.get_dcn_config(name, n_deform)
    cfg = configs.get_dcn_config(name, n_deform)
    assert cfg.__dict__ == jcfg.__dict__
    assert configs.get_dcn_config(name, n_deform, smoke=True).__dict__ == \
        j_configs.get_dcn_config(name, n_deform, smoke=True).__dict__
    shapes, jshapes = dcn_models.layer_shapes(cfg), j_dcn.layer_shapes(jcfg)
    assert [s.__dict__ for s in shapes] == [s.__dict__ for s in jshapes]
    budget = (128 + 256) * 1024
    for s, js in zip(shapes, jshapes):
        assert repr(plan_fusion(s, budget)) == \
            repr(j_fusion.plan_fusion(js, budget))
    shapes = dcn_models.layer_shapes(
        configs.get_dcn_config(name, n_deform, smoke=True))
    g = torch.Generator().manual_seed(9)
    for s in {(s.h, s.c_in, s.c_out): s for s in shapes}.values():
        off = torch.randn((1, s.h, s.w, 18), generator=g) * 2.0
        coords = deform.offsets_to_coords(off, 3, "dcn2")[0]
        jgrid = j_tiles.make_square_grid(s.h, s.w, 4)
        grid = make_square_grid(s.h, s.w, 4)
        b = tdt_from_coords(coords, grid, grid).numpy()
        pp = per_pixel_input_tiles(coords, grid).numpy()
        for fused in (True, False):
            kw = dict(channels=s.c_in, c_out=s.c_out, kernel_size=3,
                      buffer_bytes=128 * 1024, dtype_bytes=s.dtype_bytes,
                      fused=fused)
            got = simulate_strategies(b, pp, in_grid=grid, **kw)
            want = j_sim.simulate_strategies(b, pp, in_grid=jgrid, **kw)
            assert repr(got) == repr(want)


# -- the serving engine's timeline --------------------------------------------

ENGINE_CFG = dict(name="vgg19", n_deform=2, img_size=16, width_mult=0.125,
                  num_classes=4)
PLAN = dict(kinds=("dispatch",), rate=1.0, max_fires=1, seed=3)


@pytest.fixture(scope="module")
def engine_case():
    key = jax.random.PRNGKey(2)
    jcfg = j_dcn.DcnNetConfig(**ENGINE_CFG)
    jp = j_dcn.init_dcn_net(key, jcfg)
    jp["convs"] = [
        j_deform.randomize_offset_conv(p, jax.random.fold_in(key, 100 + i),
                                       2.0 / p.w.shape[2])
        if isinstance(p, j_deform.DeformableConvParams) else p
        for i, p in enumerate(jp["convs"])]
    xs = np.random.default_rng(5).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    return jp, params_from_jax(_np(jp), device="cpu"), xs


def _step_through(eng, xs):
    """``last_step_faulted`` after each step until the queue is empty (a
    step empties every slot it serves)."""
    for x in xs:
        eng.submit(x)
    faulted = []
    while eng.queue_depth and len(faulted) < 50:
        eng.step()
        faulted.append(eng.last_step_faulted)
    return faulted


@pytest.mark.parametrize("traced", [True, False])
def test_engine_timeline_and_faulted_steps_match_jax(engine_case, traced):
    jp, tp, xs = engine_case
    kw = dict(tile=4, dispatch="batch_fused", schedule_backend="host")
    jt, tt = JTracer(enabled=traced), Tracer(enabled=traced)
    jeng = JEngine(jp, j_dcn.DcnNetConfig(**ENGINE_CFG), slots=2,
                   graph=JGraphConfig(**kw), faults=JInjector(**PLAN),
                   tracer=jt)
    teng = DcnServingEngine(tp, dcn_models.DcnNetConfig(**ENGINE_CFG),
                            slots=2, device="cpu", graph=GraphConfig(**kw),
                            faults=FaultInjector(**PLAN), tracer=tt)
    assert teng.last_step_faulted is False
    jf, tf = _step_through(jeng, xs), _step_through(teng, xs)
    assert tf == jf and any(tf) and not all(tf)
    if not traced:
        assert teng.timeline == [] == jeng.timeline
        return
    assert len(teng.timeline) == len(jeng.timeline) == teng.steps
    for t, j in zip(teng.timeline, jeng.timeline):
        assert set(t) == set(j)
        for k in ("step", "width", "dispatches", "dram_bytes", "failures",
                  "degraded", "image_hits", "schedule_backend"):
            assert t[k] == j[k], k
        assert t["wall_s"] > 0
        assert [s["name"] for s in t["dispatch_spans"]] == \
            [s["name"] for s in j["dispatch_spans"]]
