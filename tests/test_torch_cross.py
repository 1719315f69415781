"""The port's cross-attention layers, ``build_cross_cache`` and the
llama-3.2-vision configuration, against the JAX package on the CPU.

Parameters are seeded numpy leaves of the JAX init trees and cross through
``repro_torch.convert.lm_params_from_jax``; token ids and float32 image
states are made with numpy from fixed seeds and fed to both packages (the
port's kernels take float32 only, so no test feeds bf16 states).
Tolerances:

* one cross layer (``attention_train`` with and without the flash path,
  ``attention_decode``) and ``build_cross_cache`` leaf by leaf: within
  1e-5 * max|ref| (float32 sums over a few hundred terms in another
  order);
* the llama smoke model's ``lm_prefill``, 8 ``lm_decode_step``s over a
  filled cross cache and ``lm_loss``: within 1e-4 * max|ref| (five layers
  of float32 matmuls, norms and softmaxes), gradients within 1e-4
  norm-wise per leaf;
* served greedy tokens equal to the JAX engine's.
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
from repro.models.params import Maker as JMaker
from repro.models.params import abstract_params as j_abstract_params
from repro.models.params import param_count as j_param_count
from repro.serving import DecodeEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs, optim
from repro_torch._tree import flatten_with_names, tree_leaves, \
    value_and_grad
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.launch import serve
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers, lm, transformer
from repro_torch.models.params import abstract_params, leaves, param_count
from repro_torch.serving import DecodeEngine, Request

ARCH = "llama-3.2-vision-11b"
FULL_PARAMS = 9_775_157_248


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


# -- one cross layer ----------------------------------------------------------

def _cross_cfg(qk_norm=False, d_cross=32):
    return j_layers.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2,
                               head_dim=16, qk_norm=qk_norm, cross=True,
                               d_cross=d_cross)


def _attn(jcfg, seed):
    jp = _numpy_params(j_layers.init_attention(JMaker("shapes"), jcfg), seed,
                       scale=0.3)
    return jp, lm_params_from_jax(jp, device="cpu"), \
        layers.AttnConfig(**dataclasses.asdict(jcfg))


# (Sq, Skv): queries below and above the ragged key counts 17 and 37.
TRAIN_CASES = [(9, 17), (29, 17), (29, 37), (45, 37)]


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("sq,skv", TRAIN_CASES)
def test_cross_attention_train_matches_jax(sq, skv, use_flash, qk_norm):
    """Non-causal attention over the states: the port's #7 plain version
    (``use_flash``) against JAX's Pallas kernel in interpret mode, and
    the ``_sdpa`` paths against each other."""
    jcfg = _cross_cfg(qk_norm)
    jp, tp, cfg = _attn(jcfg, 3 + sq)
    rng = np.random.default_rng(4 + skv)
    x = _normal(rng, 2, sq, jcfg.d_model)
    kv = _normal(rng, 2, skv, jcfg.d_cross)
    want = jax.jit(lambda p, a, s: j_layers.attention_train(
        p, jcfg, a, kv_src=s, use_flash=use_flash))(
            jp, jnp.asarray(x), jnp.asarray(kv))
    got = layers.attention_train(tp, cfg, torch.as_tensor(x),
                                 kv_src=torch.as_tensor(kv),
                                 use_flash=use_flash)
    _close_rel(got, want, 1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_decode_matches_jax(qk_norm):
    """One query over a filled 17-row cross cache at three positions; the
    cache comes back the same object, unwritten."""
    jcfg = _cross_cfg(qk_norm)
    jp, tp, cfg = _attn(jcfg, 5)
    rng = np.random.default_rng(6)
    b, rows = 3, 17
    ck, cv = (_normal(rng, b, rows, jcfg.n_kv_heads, jcfg.head_dim)
              for _ in range(2))
    x = _normal(rng, b, 1, jcfg.d_model)
    pos = np.array([0, 7, 40], np.int32)
    want, jcache = jax.jit(j_layers.attention_decode, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(pos))
    cache = {"k": torch.as_tensor(ck.copy()), "v": torch.as_tensor(cv.copy())}
    got, out_cache = layers.attention_decode(
        tp, cfg, torch.as_tensor(x), cache, torch.as_tensor(pos))
    assert out_cache is cache
    _close_rel(got, want, 1e-5)
    for name, a in (("k", ck), ("v", cv)):
        assert np.array_equal(cache[name].numpy(), a)
        assert np.array_equal(np.asarray(jcache[name]), a)


# -- the llama smoke model ----------------------------------------------------

def _model(seed, **changes):
    jcfg = dataclasses.replace(j_configs.get_config(ARCH, smoke=True),
                               **changes)
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), seed)
    cfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), **changes)
    return jcfg, jp, cfg, lm_params_from_jax(jp, device="cpu")


def _states(cfg, seed, b):
    return _normal(np.random.default_rng(seed), b, cfg.n_cross_tokens,
                   cfg.d_cross)


def _tokens(seed, cfg, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def test_config_places_the_cross_layers():
    cfg = configs.get_config(ARCH)
    specs = cfg.prefix + cfg.pattern * cfg.n_repeats
    assert [i for i, s in enumerate(specs) if s.cross] == \
        list(range(3, 40, 5))
    assert (cfg.n_layers, cfg.d_cross, cfg.n_cross_tokens) == (40, 4096, 1601)
    assert cfg.attn_cfg(cfg.pattern[3]).cross
    assert not cfg.attn_cfg(cfg.pattern[0]).cross


def test_param_leaves_carry_across_in_jax_order():
    """The cross layers' ``wk`` / ``wv`` take ``d_cross`` rows; the port's
    tree flattens in the JAX leaf order with the JAX shapes."""
    jcfg, jp, cfg, tp = _model(1)
    names = [n for n, _ in flatten_with_names(tp)]
    paths, jl = zip(*jax.tree_util.tree_flatten_with_path(jp)[0])
    assert names == [jax.tree_util.keystr(p) for p in paths]
    assert [tuple(t.shape) for t in tree_leaves(tp)] == [a.shape for a in jl]
    stack = tp["layers"]["stack"]
    assert tuple(stack["b3"]["attn"]["wk"].shape) == (1, 32, 2, 16)
    assert tuple(stack["b0"]["attn"]["wk"].shape) == (1, 64, 2, 16)
    own = lm.init_lm(cfg, 0, device="cpu")
    assert [n for n, _ in flatten_with_names(own)] == names


def test_full_param_count_on_meta():
    cfg = configs.get_config(ARCH)
    n = param_count(abstract_params(lambda mk: lm.make_lm(mk, cfg)))
    jn = j_param_count(j_abstract_params(
        lambda mk: j_lm.init_lm(mk, j_configs.get_config(ARCH))))
    assert n == jn == FULL_PARAMS
    assert param_count(lm.init_lm(cfg, device="meta")) == FULL_PARAMS


def test_full_width_meta_init_has_the_jax_shapes():
    want = jax.tree.leaves(
        j_lm.init_lm(JMaker("shapes"), j_configs.get_config(ARCH)),
        is_leaf=lambda x: isinstance(x, tuple))
    got = lm.init_lm(configs.get_config(ARCH), device="meta")
    assert all(t.device.type == "meta" for t in leaves(got))
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(s) for s in want]


def test_build_cross_cache_matches_jax_leaf_by_leaf():
    jcfg, jp, cfg, tp = _model(2)
    b, max_len = 2, 12
    st = _states(cfg, 7, b)
    jcache = j_lm.build_cross_cache(
        jp, jcfg, j_lm.init_cache(None, jcfg, b, max_len, jnp.float32),
        jnp.asarray(st))
    cache = lm.init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu")
    ids = [id(t) for t in tree_leaves(cache)]
    out = lm.build_cross_cache(tp, cfg, cache, torch.as_tensor(st))
    assert out is cache and [id(t) for t in tree_leaves(cache)] == ids
    assert tuple(cache["stack"]["b3"]["mix"]["k"].shape) == (1, b, 17, 2, 16)
    assert tuple(cache["stack"]["b0"]["mix"]["k"].shape) == \
        (1, b, max_len, 2, 16)
    jl = jax.tree.leaves(jcache)
    assert len(jl) == len(tree_leaves(cache))
    for t, a in zip(tree_leaves(cache), jl):
        a = np.asarray(a)
        assert t.shape == a.shape
        if a.any():
            _close_rel(t, a, 1e-5)
        else:
            assert not t.any()
    assert cache["stack"]["b3"]["mix"]["v"].abs().max() > 0


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_with_states_matches_jax(use_flash):
    jcfg, jp, cfg, tp = _model(3, use_flash=use_flash)
    toks, st = _tokens(8, cfg, 2, 11), _states(cfg, 9, 2)
    want = jax.jit(lambda p, t, s: j_lm.lm_prefill(
        p, jcfg, {"tokens": t, "cross_states": s}))(
            jp, jnp.asarray(toks), jnp.asarray(st))
    got = lm.lm_prefill(tp, cfg, {"tokens": torch.as_tensor(toks),
                                  "cross_states": torch.as_tensor(st)})
    _close_rel(got, want, 1e-4)


def test_decode_over_the_cross_cache_matches_jax():
    """8 ``lm_decode_step``s at ragged positions after
    ``build_cross_cache``: logits every step and the caches after, leaf
    by leaf; the last step also equals the prefill's last position."""
    jcfg, jp, cfg, tp = _model(4)
    b, max_len, n = 2, 16, 8
    st = _states(cfg, 10, b)
    jcache = j_lm.build_cross_cache(
        jp, jcfg, j_lm.init_cache(None, jcfg, b, max_len, jnp.float32),
        jnp.asarray(st))
    cache = lm.build_cross_cache(
        tp, cfg, lm.init_cache(cfg, b, max_len, dtype=torch.float32,
                               device="cpu"), torch.as_tensor(st))
    step = jax.jit(lambda p, c, t, q: j_lm.lm_decode_step(p, jcfg, c, t, q))
    toks = _tokens(11, cfg, b, n)
    for i in range(n):
        tok, pos = toks[:, i:i + 1], np.full((b,), i, np.int32)
        want, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        got, cache = lm.lm_decode_step(tp, cfg, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        _close_rel(got, want, 1e-4)
    for t, a in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _close_rel(t, a, 1e-4)
    pre = lm.lm_prefill(tp, cfg, {"tokens": torch.as_tensor(toks),
                                  "cross_states": torch.as_tensor(st)})
    _close_rel(got, pre, 1e-4)


def test_loss_and_gradients_with_states_match_jax():
    jcfg, jp, cfg, tp = _model(5)
    toks, st = _tokens(12, cfg, 2, 13), _states(cfg, 13, 2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t, s: j_lm.lm_loss(p, jcfg, {"tokens": t,
                                               "cross_states": s}),
        has_aux=True))(jp, jnp.asarray(toks), jnp.asarray(st))
    (tl, tm), tg = value_and_grad(lambda p: lm.lm_loss(
        p, cfg, {"tokens": torch.as_tensor(toks),
                 "cross_states": torch.as_tensor(st)}), tp)
    for k in ("ce", "loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    for (name, g), w in zip(flatten_with_names(tg), jax.tree.leaves(jg)):
        w = np.asarray(w, np.float64)
        assert np.isfinite(g.numpy()).all(), name
        diff = np.linalg.norm(g.numpy().astype(np.float64) - w)
        assert diff <= 1e-4 * max(np.linalg.norm(w), 1e-12), name
    cross_wk = tg["layers"]["stack"]["b3"]["attn"]["wk"]
    assert float(cross_wk.abs().max()) > 0


def test_remat_recomputes_with_the_same_states():
    """The remat policies bind the image states into each checkpointed
    layer: ``none``, ``full`` and ``dots`` give the same loss and
    gradients, bit for bit."""
    _, _, cfg, tp = _model(13)
    batch = {"tokens": torch.as_tensor(_tokens(28, cfg, 2, 9)),
             "cross_states": torch.as_tensor(_states(cfg, 29, 2))}
    out = {r: value_and_grad(lambda p: lm.lm_loss(
        p, dataclasses.replace(cfg, remat=r), batch), tp)
        for r in ("none", "full", "dots")}
    (loss, _), grads = out["none"]
    for r in ("full", "dots"):
        (l2, _), g2 = out[r]
        assert torch.equal(l2, loss), r
        for a, w in zip(tree_leaves(g2), tree_leaves(grads)):
            assert torch.equal(a, w), r


def test_build_train_step_matches_jax_loss():
    """One step of the port's ``build_train_step`` on a batch with image
    states gives the JAX step's metrics."""
    jcfg, jp, cfg, tp = _model(6)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=2)
    jocfg, tocfg = j_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    batch = {"tokens": _tokens(14, cfg, 2, 13),
             "cross_states": _states(cfg, 15, 2)}

    @jax.jit
    def jstep(p, o, bt):
        (_, m), g = jax.value_and_grad(
            lambda q: j_lm.lm_loss(q, jcfg, bt), has_aux=True)(p)
        _, _, om = j_optim.adamw_update(p, g, o, jocfg)
        return {**m, **om}

    jo = j_optim.init_opt_state(jp, jocfg)
    to = opt_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, tm = build_train_step(cfg, tocfg)(tp, to, batch)
    for k in ("loss", "ce", "lr", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k


def _fill(eng, params, cfg, st):
    eng.cache = lm.build_cross_cache(params, cfg, eng.cache,
                                     torch.as_tensor(st))


def test_engine_with_filled_cross_cache_matches_jax():
    """Greedy tokens of the port's engine with its cross cache filled are
    the JAX engine's with ``cache`` set the same way; 5 requests over 2
    slots, so slots are reused and keep their image."""
    jcfg, jp, cfg, tp = _model(7)
    st = _states(cfg, 16, 2)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in (3, 1, 5, 2, 4)]
    jeng = JEngine(jp, jcfg, batch=2, max_len=16)
    jeng.cache = j_lm.build_cross_cache(jp, jcfg, jeng.cache, jnp.asarray(st))
    eng = DecodeEngine(tp, cfg, batch=2, max_len=16, device="cpu")
    _fill(eng, tp, cfg, st)
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new=4 + rid % 3))
        eng.submit(Request(rid=rid, prompt=p, max_new=4 + rid % 3))
    want = {r.rid: r.out for r in jeng.run()}
    assert {r.rid: r.out for r in eng.run()} == want and len(want) == 5


def test_image_conditions_the_served_tokens():
    """The same request served in a slot under another image, or with the
    cross cache left at zero (as the serve command does), is decoded from
    other logits."""
    _, _, cfg, tp = _model(8)
    outs = []
    for st in (_states(cfg, 18, 1), _states(cfg, 19, 1), None):
        eng = DecodeEngine(tp, cfg, batch=1, max_len=16, device="cpu")
        if st is not None:
            _fill(eng, tp, cfg, st)
        logits = []
        orig = eng._sample
        eng._sample = lambda lg, t: logits.append(lg.clone()) or orig(lg, t)
        eng.submit(Request(rid=0, prompt=[5, 9, 2], max_new=3))
        eng.run()
        outs.append(torch.stack(logits))
    for other in outs[1:]:
        assert float((outs[0] - other).abs().max()) > \
            1e-3 * float(outs[0].abs().max())


def test_reused_slot_keeps_its_image():
    """Admission resets the recurrent rows only: a slot's cross K/V stay
    as ``build_cross_cache`` wrote them after ``reset_cache_rows`` and
    after the slot has served requests."""
    _, _, cfg, tp = _model(9)
    eng = DecodeEngine(tp, cfg, batch=2, max_len=16, device="cpu")
    _fill(eng, tp, cfg, _states(cfg, 20, 2))
    cross = {n: t.clone() for n, t in
             eng.cache["stack"]["b3"]["mix"].items()}
    transformer.reset_cache_rows(cfg, eng.cache, [0, 1])
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=[rid + 1, 3], max_new=3))
    eng.run()
    for n, t in cross.items():
        assert torch.equal(eng.cache["stack"]["b3"]["mix"][n], t), n


def test_cross_block_without_states_raises():
    """The port refuses a cross block with no states in every train-form
    path. JAX's ``attention_train`` takes ``kv_src = x`` then, which at
    ``d_cross == d_model`` (the full config's 4096) runs as bidirectional
    self-attention: position 0's output moves with the last token."""
    jcfg = _cross_cfg(d_cross=64)
    jp, tp, cfg = _attn(jcfg, 21)
    x = _normal(np.random.default_rng(22), 1, 6, 64)
    x2 = x.copy()
    x2[:, -1] += 1.0
    j_train = jax.jit(lambda p, a: j_layers.attention_train(p, jcfg, a))
    j_out = [np.asarray(j_train(jp, jnp.asarray(a))) for a in (x, x2)]
    assert np.abs(j_out[0][:, 0] - j_out[1][:, 0]).max() > 1e-3
    for use_flash in (False, True):
        with pytest.raises(ValueError, match="encoder states"):
            layers.attention_train(tp, cfg, torch.as_tensor(x),
                                   use_flash=use_flash)

    jcfg, jp, cfg, tp = _model(10, d_cross=64)
    toks = _tokens(23, cfg, 1, 7)
    jax.jit(lambda p, t: j_lm.lm_prefill(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))                                  # runs in JAX
    with pytest.raises(ValueError, match="encoder states"):
        lm.lm_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)})
    with pytest.raises(ValueError, match="encoder states"):
        lm.lm_loss(tp, cfg, {"tokens": torch.as_tensor(toks)})


def test_serve_command_says_the_cross_cache_is_zero(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "zero cross cache" in out
    assert "llama-vision-smoke on cpu: 3 requests, 6 tokens" in out


# -- the reference's side -----------------------------------------------------

def test_jax_engine_decodes_against_a_zero_cross_cache():
    """The JAX ``DecodeEngine`` builds its cache with ``init_cache`` and
    never fills the cross layers' K/V: over that zero cache a cross layer
    adds nothing, and decode leaves the prefill with the image by far
    more than rounding; filled by ``build_cross_cache`` it gives the
    prefill's logits. The port's engine starts the same way; a caller
    fills ``eng.cache`` in both packages."""
    jcfg, jp, cfg, tp = _model(11)
    b, n = 2, 8
    toks, st = _tokens(24, cfg, b, n), _states(cfg, 25, b)
    jeng = JEngine(jp, jcfg, batch=b, max_len=n)
    eng = DecodeEngine(tp, cfg, batch=b, max_len=n, device="cpu")
    for j, t in zip(jax.tree.leaves(jeng.cache["stack"]["b3"]),
                    tree_leaves(eng.cache["stack"]["b3"])):
        assert not np.asarray(j).any() and not t.any()
    ref = np.asarray(j_lm.lm_prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks),
                   "cross_states": jnp.asarray(st)}))

    step = jax.jit(lambda p, c, t, q: j_lm.lm_decode_step(p, jcfg, c, t, q))

    def decode(cache):
        for i in range(n):
            lg, cache = step(jp, cache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.full((b,), i, jnp.int32))
        return np.asarray(lg)

    scale = np.abs(ref).max()
    assert np.abs(decode(jeng.cache) - ref).max() > 1e-2 * scale
    filled = j_lm.build_cross_cache(jp, jcfg, jeng.cache, jnp.asarray(st))
    assert np.abs(decode(filled) - ref).max() <= 1e-4 * scale


def test_build_cross_cache_skips_k_norm_as_jax_does():
    """A ``qk_norm`` cross model: ``_qkv`` normalises a cross layer's k,
    ``build_cross_cache`` does not, so its decode leaves its prefill in
    JAX. The port mirrors both functions: the same cache and the same
    decode logits as JAX, and the same gap to the prefill."""
    jcfg, jp, cfg, tp = _model(12, qk_norm=True)
    assert "k_norm" in jp["layers"]["stack"]["b3"]["attn"]
    b, n = 2, 6
    toks, st = _tokens(26, cfg, b, n), _states(cfg, 27, b)
    jcache = j_lm.build_cross_cache(
        jp, jcfg, j_lm.init_cache(None, jcfg, b, n, jnp.float32),
        jnp.asarray(st))
    cache = lm.build_cross_cache(
        tp, cfg, lm.init_cache(cfg, b, n, dtype=torch.float32,
                               device="cpu"), torch.as_tensor(st))
    for t, a in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        assert np.array_equal(t.numpy() != 0, np.asarray(a) != 0)
    step = jax.jit(lambda p, c, t, q: j_lm.lm_decode_step(p, jcfg, c, t, q))
    for i in range(n):
        tok, pos = toks[:, i:i + 1], np.full((b,), i, np.int32)
        want, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        got, cache = lm.lm_decode_step(tp, cfg, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
    _close_rel(got, want, 1e-4)
    pre = np.asarray(j_lm.lm_prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks),
                   "cross_states": jnp.asarray(st)}))
    gap = np.abs(np.asarray(want) - pre).max()
    assert gap > 1e-3 * np.abs(pre).max()
    assert abs(float(np.abs(got.numpy() - pre).max()) - gap) <= 1e-4 * gap


def test_train_command_feeds_image_states(capsys):
    """``launch.train`` draws ``cross_states`` for llama from the data
    pipeline, as the JAX trainer does, and trains on them."""
    from repro_torch.launch import train

    losses = train.main(["--arch", ARCH, "--steps", "2", "--seq", "8",
                         "--batch", "2", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: first loss" in capsys.readouterr().out
