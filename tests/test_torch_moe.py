"""The port's MoE and MLA blocks, multi-token prediction and the two
configurations that use them, against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages;
parameters are seeded numpy leaves of the JAX init trees and cross through
``repro_torch.convert.lm_params_from_jax``. Tolerances:

* ``_route``: expert ids equal (ties in index order, as ``lax.top_k``),
  gates and the aux loss within 1e-6 (one float32 softmax or sigmoid and
  a normalisation);
* ``moe_apply`` within 1e-5 * max|ref| (float32 products over d_model
  and d_ff summed in another order), against the JAX local path at
  ``ep=1`` and, at ``ep>1``, against the JAX ranks composed on the CPU
  (the function ``moe_apply`` computes over a (data=1, model=ep) mesh);
* ``mla_train`` / ``mla_decode`` outputs within 1e-5 * max|ref|, the
  latent cache within 1e-5;
* ``lm_loss`` metrics within relative 1e-5, gradients within 1e-4
  norm-wise per leaf (two layers of float32 matmuls, norms, softmaxes
  and the routed combine, summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro import optim as j_optim
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.models.params import Maker as JMaker
from repro.models.params import abstract_params as j_abstract_params
from repro.models.params import param_count as j_param_count
from repro_torch import configs, optim
from repro_torch._tree import flatten_with_names, tree_leaves, \
    value_and_grad
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers, lm, moe
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.params import abstract_params, param_count

def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _numpy_params(shapes, seed, scale=0.1):
    """Seeded numpy leaves for a JAX ``Maker("shapes")`` tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: _normal(rng, *s) * np.float32(scale),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _close_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _moe_params(jcfg, seed):
    jp = _numpy_params(j_moe.init_moe(JMaker("shapes"), jcfg), seed,
                       scale=0.5)
    if "e_bias" in jp:                    # a bias that moves the choice
        jp["e_bias"] = _normal(np.random.default_rng(seed + 1),
                               jcfg.n_experts_padded) * np.float32(0.3)
    return jp, lm_params_from_jax(jp, device="cpu"), \
        moe.MoeConfig(**dataclasses.asdict(jcfg))


# -- the router ----------------------------------------------------------------

@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_matches_jax(router):
    jcfg = j_moe.MoeConfig(d_model=32, d_ff=16, n_experts=5, top_k=2, ep=2,
                           router=router, routed_scale=2.5)
    assert jcfg.n_experts_padded == 6
    jp, tp, cfg = _moe_params(jcfg, 1)
    x = _normal(np.random.default_rng(2), 40, jcfg.d_model)
    jg, je, ja = jax.jit(j_moe._route, static_argnums=1)(jp, jcfg,
                                                         jnp.asarray(x))
    tg, te, ta = moe._route(tp, cfg, torch.as_tensor(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (te < jcfg.n_experts).all()            # padding never chosen
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_top_k_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, idx = moe._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    assert vals.tolist() == np.asarray(jv).tolist()


# -- the MoE block -------------------------------------------------------------

MOE_CASES = {
    "no_drops": dict(capacity_factor=8.0),
    "drops": dict(capacity_factor=0.1),
    "shared": dict(n_shared=1, capacity_factor=0.5),
    "sigmoid_routed_scale": dict(router="sigmoid", routed_scale=2.5,
                                 n_shared=1, capacity_factor=1.25),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_the_jax_local_path(case):
    jcfg = j_moe.MoeConfig(d_model=32, d_ff=16, n_experts=6, top_k=2,
                           **MOE_CASES[case])
    jp, tp, cfg = _moe_params(jcfg, 3 + sorted(MOE_CASES).index(case))
    x = _normal(np.random.default_rng(4), 2, 24, jcfg.d_model)
    want, jaux = jax.jit(j_moe.moe_apply, static_argnums=1)(
        jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(tp, cfg, torch.as_tensor(x))
    _close_rel(got, want, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    if case == "drops":     # every pair of some token dropped: a zero row
        assert moe.capacity(cfg, 48) == 8 < 48 * 2 / 6
        rows = np.abs(np.asarray(want)).reshape(48, -1).max(-1)
        assert (rows == 0).any()
        np.testing.assert_array_equal(
            got.reshape(48, -1).abs().amax(-1).numpy() == 0, rows == 0)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("ep", [2, 4])
def test_moe_apply_at_ep_equals_the_jax_ranks_composed(ep, router):
    """The sum over ranks r of JAX ``_moe_core`` on rank r's slice of the
    expert weights, plus the shared expert once: the function the JAX
    package computes over a (data=1, model=ep) mesh."""
    jcfg = j_moe.MoeConfig(d_model=32, d_ff=16, n_experts=5, top_k=2, ep=ep,
                           router=router, n_shared=1, capacity_factor=0.5)
    jp, tp, cfg = _moe_params(jcfg, 10 + ep)
    x_np = _normal(np.random.default_rng(ep), 2, 24, jcfg.d_model)
    x = jnp.asarray(x_np)
    routed_cfg = dataclasses.replace(jcfg, n_shared=0)
    e_loc = jcfg.e_loc
    want = 0.0
    for r in range(ep):
        p_r = {k: (v[r * e_loc:(r + 1) * e_loc]
                   if k in ("w_gate", "w_up", "w_down") else v)
               for k, v in jp.items() if k != "shared"}
        part, jaux = j_moe._moe_core(p_r, routed_cfg, x, rank=r,
                                     wgather=lambda w, ax: w,
                                     psum=lambda y: y)
        want = want + part.astype(jnp.float32)
    sh = jp["shared"]
    want = want + jnp.einsum(
        "bsf,fd->bsd", jax.nn.silu(x @ sh["w_gate"]) * (x @ sh["w_up"]),
        sh["w_down"])
    got, aux = moe.moe_apply(tp, cfg, torch.as_tensor(x_np))
    _close_rel(got, want, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # Over a (1, ep) mesh the ranks run one by one: the same function.
    mesh = DeviceMesh.on("cpu", data=1, model=ep)
    got_m, aux_m = moe.moe_apply(tp, cfg, torch.as_tensor(x_np), mesh=mesh)
    _close_rel(got_m, want, 1e-5)
    assert abs(float(aux_m) - float(jaux)) <= 1e-6
    with pytest.raises(ValueError, match="ep"):
        moe.moe_apply(tp, cfg, torch.as_tensor(x_np),
                      mesh=DeviceMesh.on("cpu", data=1, model=ep + 1))


# -- MLA -----------------------------------------------------------------------

MLA = j_layers.MlaConfig(d_model=64, n_heads=4, q_lora_rank=32,
                         kv_lora_rank=16, d_nope=16, d_rope=8, d_v=16)


def _mla_params(seed):
    jp = _numpy_params(j_layers.init_mla(JMaker("shapes"), MLA), seed)
    return jp, lm_params_from_jax(jp, device="cpu"), \
        layers.MlaConfig(**dataclasses.asdict(MLA))


@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_mla_train_matches_jax(impl):
    jp, tp, cfg = _mla_params(20)
    x = _normal(np.random.default_rng(21), 2, 19, MLA.d_model)
    want = jax.jit(j_layers.mla_train, static_argnums=1,
                   static_argnames=("impl", "chunk"))(
        jp, MLA, jnp.asarray(x), impl=impl, chunk=8)
    got = layers.mla_train(tp, cfg, torch.as_tensor(x), impl=impl, chunk=8)
    _close_rel(got, want, 1e-5)


def test_mla_decode_matches_jax():
    jp, tp, cfg = _mla_params(22)
    rng = np.random.default_rng(23)
    b, smax = 3, 16
    ckv = _normal(rng, b, smax, MLA.kv_lora_rank + MLA.d_rope)
    jcache = {"ckv": jnp.asarray(ckv)}
    cache = {"ckv": torch.as_tensor(ckv.copy())}
    pos = np.array([0, 5, 9], np.int32)     # ragged; 9 + 11 > smax - 1
    step = jax.jit(j_layers.mla_decode, static_argnums=1)
    for _ in range(12):
        x = _normal(rng, b, 1, MLA.d_model)
        want, jcache = step(jp, MLA, jnp.asarray(x), jcache, jnp.asarray(pos))
        got, out_cache = layers.mla_decode(tp, cfg, torch.as_tensor(x), cache,
                                           torch.as_tensor(pos))
        assert out_cache is cache                     # written in place
        _close_rel(got, want, 1e-5)
        np.testing.assert_allclose(cache["ckv"].numpy(),
                                   np.asarray(jcache["ckv"]), rtol=1e-5,
                                   atol=1e-5)
        pos = pos + 1


# -- the models ------------------------------------------------------------------

def _model(arch, seed):
    jcfg = j_configs.get_config(arch, smoke=True)
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), seed)
    return jcfg, jp, configs.get_config(arch, smoke=True), \
        lm_params_from_jax(jp, device="cpu")


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def test_deepseek_loss_with_aux_and_mtp_matches_jax():
    jcfg, jp, cfg, tp = _model("deepseek-v3-671b", seed=30)
    assert jcfg.mtp and jcfg.moe.router == "sigmoid"
    toks = _tokens(np.random.default_rng(31), cfg, 2, 13)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t: j_lm.lm_loss(p, jcfg, {"tokens": t}), has_aux=True))(
            jp, jnp.asarray(toks))
    (tl, tm), tg = value_and_grad(
        lambda p: lm.lm_loss(p, cfg, {"tokens": torch.as_tensor(toks)}), tp)
    assert list(tm) == ["ce", "aux", "mtp", "loss"] and set(jm) == set(tm)
    for k in tm:
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-5 * abs(float(jm[k])), k
    assert float(tm["aux"]) > 0 and float(tm["mtp"]) > 0
    names = [n for n, _ in flatten_with_names(tg)]
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert any("['mtp']" in n for n in names)
    for name, g, w in zip(names, tree_leaves(tg), jax.tree.leaves(jg)):
        w = np.asarray(w, np.float64)
        diff = np.linalg.norm(g.numpy().astype(np.float64) - w)
        assert diff <= 1e-4 * max(np.linalg.norm(w), 1e-12), name


def test_granite_train_step_matches_jax():
    jcfg, jp, cfg, tp = _model("granite-moe-3b-a800m", seed=32)
    lr = 1e-2
    kw = dict(lr=lr, warmup_steps=1, total_steps=2)
    jocfg, tocfg = j_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    toks = _tokens(np.random.default_rng(33), cfg, 2, 13)

    @jax.jit
    def jstep(p, o, t):
        (_, m), g = jax.value_and_grad(
            lambda q: j_lm.lm_loss(q, jcfg, {"tokens": t}), has_aux=True)(p)
        p, o, om = j_optim.adamw_update(p, g, o, jocfg)
        return p, {**m, **om}

    jo = j_optim.init_opt_state(jp, jocfg)
    to = opt_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    jp2, jm = jstep(jp, jo, jnp.asarray(toks))
    tp2, to2, tm = build_train_step(cfg, tocfg)(tp, to, {"tokens": toks})
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    assert int(to2["step"]) == 1
    for a, w in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        assert np.abs(a.numpy() - np.asarray(w)).max() <= 2 * lr


@pytest.mark.parametrize("arch", configs.SUPPORTED_ARCHS)
def test_param_count_on_meta_equals_jax(arch):
    cfg = configs.get_config(arch)
    tree = abstract_params(lambda mk: lm.make_lm(mk, cfg))
    assert all(t.device.type == "meta" for t in tree_leaves(tree))
    want = j_param_count(j_abstract_params(
        lambda mk: j_lm.init_lm(mk, j_configs.get_config(arch))))
    assert param_count(tree) == want
    assert param_count(lm.init_lm(cfg, device="meta")) == want


def test_full_configs_count_what_the_chip_run_states():
    """The counts ``chip_smoke.py`` phase 10 prints: granite whole (40
    experts padded to 48), deepseek whole and cut to one dense and one
    MoE layer (with the MTP block ``init_lm`` builds)."""
    g = configs.get_config("granite-moe-3b-a800m")
    d = configs.get_config("deepseek-v3-671b")
    cut = dataclasses.replace(d, prefix=d.prefix[:1], n_repeats=1)

    def count(cfg):
        return param_count(lm.init_lm(cfg, device="meta"))
    assert g.moe.n_experts_padded == 48
    assert count(g) == 3_903_166_464
    assert count(d) == 671_712_677_376
    assert count(cut) == 14_630_393_088
    assert moe.capacity(g.moe, 4) == 8 and moe.capacity(g.moe, 8192) == 1706
