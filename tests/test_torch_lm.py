"""The port's LM serving slice against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages;
parameters come from the JAX ``init_lm`` and cross through
``repro_torch.convert.lm_params_from_jax``. Tolerances:

* the plain flash-attention (#7) and flash-decode (#8) versions against
  the JAX Pallas kernels in interpret mode, and ``attention_train`` /
  ``attention_decode`` against the JAX functions: 1e-5 (float32 sums in
  another order over at most a few hundred terms);
* ``lm_prefill`` and ``lm_decode_step`` logits within 1e-4 * max|ref|
  (two or three layers of float32 matmuls, norms, softmaxes and MoE
  combines), decode caches (GQA K/V, MLA latents) within 1e-5;
* greedy ``DecodeEngine`` tokens equal to the JAX engine's.

The CUDA kernels themselves are held against the plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models.params import Maker as JMaker
from repro.serving import DecodeEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import (MAX_KERNEL_HEAD_DIM,
                                                 flash_attention,
                                                 tile_config)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import layers, lm
from repro_torch.models.params import leaves
from repro_torch.launch import serve
from repro_torch.serving import DecodeEngine, DrainTimeout, Request

ARCHS = ("qwen3-1.7b", "smollm-360m", "stablelm-1.6b", "gemma2-27b",
         "musicgen-medium", "granite-moe-3b-a800m", "deepseek-v3-671b")


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# -- kernel #7: flash attention ---------------------------------------------

FLASH_CASES = {
    "mha": dict(b=2, sq=32, skv=32, hq=4, hkv=4, d=16),
    "gqa": dict(b=2, sq=32, skv=48, hq=8, hkv=2, d=16),
    "ragged_padded": dict(b=1, sq=21, skv=50, hq=4, hkv=2, d=32),
    "sq1": dict(b=2, sq=1, skv=40, hq=4, hkv=2, d=16),
    "window": dict(b=1, sq=40, skv=40, hq=4, hkv=2, d=16, window=7),
    "softcap": dict(b=1, sq=40, skv=40, hq=4, hkv=2, d=16, softcap=5.0),
    "window_softcap": dict(b=1, sq=40, skv=40, hq=4, hkv=2, d=16, window=9,
                           softcap=3.0),
    "non_causal": dict(b=1, sq=24, skv=40, hq=4, hkv=4, d=16, causal=False),
    "d144": dict(b=1, sq=24, skv=24, hq=4, hkv=2, d=144, window=5,
                 softcap=50.0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_plain_matches_jax(case):
    c = dict(FLASH_CASES[case])
    b, sq, skv, hq, hkv, d = (c.pop(k) for k in
                              ("b", "sq", "skv", "hq", "hkv", "d"))
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    q, k, v = (_normal(rng, b, sq, hq, d), _normal(rng, b, skv, hkv, d),
               _normal(rng, b, skv, hkv, d))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, block_q=16, block_k=16, **c)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), **c)
    assert got.shape == (b, sq, hq, d)
    _close(got, want, 1e-5)


# -- kernel #8: flash decode ------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"window": 20}, {"softcap": 4.0},
                                    {"window": 33, "softcap": 30.0}])
def test_flash_decode_plain_matches_jax(kwargs):
    b, s, hq, hkv, d = 3, 96, 6, 2, 16
    rng = np.random.default_rng(5 + len(kwargs))
    q, kc, vc = (_normal(rng, b, hq, d), _normal(rng, b, s, hkv, d),
                 _normal(rng, b, s, hkv, d))
    lengths = np.array([1, 96, 57], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), interpret=True, block_k=32,
                    **kwargs)
    got = flash_decode(torch.as_tensor(q), torch.as_tensor(kc),
                       torch.as_tensor(vc), torch.as_tensor(lengths),
                       **kwargs)
    _close(got, want, 1e-5)


def test_flash_decode_plain_matches_jax_past_the_cache():
    """A length past S counts as S. The JAX kernel agrees wherever its
    ``block_k`` divides S (it pads no keys then); the port does not copy
    the padded keys it attends otherwise."""
    b, s, hq, hkv, d = 3, 40, 4, 2, 16
    rng = np.random.default_rng(9)
    q, kc, vc = (_normal(rng, b, hq, d), _normal(rng, b, s, hkv, d),
                 _normal(rng, b, s, hkv, d))
    lengths = np.array([60, 41, 25], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), interpret=True, block_k=20)
    got = flash_decode(torch.as_tensor(q), torch.as_tensor(kc),
                       torch.as_tensor(vc), torch.as_tensor(lengths))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("d", range(4, MAX_KERNEL_HEAD_DIM + 1, 4))
def test_flash_tile_config_fits_shared_memory(d):
    """The CUDA kernel's tiles for every head dim it takes fit a block's
    232,448 bytes of shared memory, with two warpgroups a block up to
    D = 128."""
    t = tile_config(d)
    assert t["dp"] % 16 == 0 and d <= t["dp"] < d + 16
    dp, bq, bk = t["dp"], t["block_q"], t["block_k"]
    assert t["smem_bytes"] == 4 * (2 * bq * dp + 4 * bk * dp
                                   + 2 * bk * (dp + 4)) + 8
    assert t["smem_bytes"] <= 232_448
    assert bq == (128 if d <= 128 else 64)
    assert t["threads"] == 2 * bq


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="float32"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="group"):
        flash_attention(torch.zeros(1, 4, 3, 16), q, q)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q[:, 0], q, q, torch.zeros(1, dtype=torch.int64))
    for d in (6, MAX_KERNEL_HEAD_DIM + 4):
        with pytest.raises(ValueError, match="head_dim"):
            tile_config(d)


# -- attention entry points ---------------------------------------------------

ATTN_CFGS = {
    "qwen3": j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2,
                                 head_dim=8, qk_norm=True, rope_theta=1e6),
    "stablelm": j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4,
                                    head_dim=8, rope_fraction=0.25),
    "gemma2": j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2,
                                  head_dim=16, window=5, attn_softcap=50.0),
    "chunked": j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2,
                                   head_dim=8, impl="chunked", chunk=8),
}


def _numpy_params(shapes, seed):
    """Random numpy leaves for a JAX ``Maker("shapes")`` tree (faster than
    the JAX initialiser, and the same for both packages)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: _normal(rng, *s) * np.float32(0.1), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def _attn_params(jcfg, seed):
    jp = _numpy_params(j_layers.init_attention(JMaker("shapes"), jcfg), seed)
    port_cfg = layers.AttnConfig(**dataclasses.asdict(jcfg))
    return jp, lm_params_from_jax(jp, device="cpu"), port_cfg


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_train_matches_jax(name, use_flash):
    jcfg = ATTN_CFGS[name]
    jp, tp, cfg = _attn_params(jcfg, 3)
    x = _normal(np.random.default_rng(4), 2, 19, jcfg.d_model)
    want = jax.jit(j_layers.attention_train, static_argnums=1,
                   static_argnames="use_flash")(jp, jcfg, jnp.asarray(x),
                                                use_flash=use_flash)
    got = layers.attention_train(tp, cfg, torch.as_tensor(x),
                                 use_flash=use_flash)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_decode_matches_jax(name):
    jcfg = ATTN_CFGS[name]
    jp, tp, cfg = _attn_params(jcfg, 5)
    rng = np.random.default_rng(6)
    b, smax = 3, 12
    ck, cv = (_normal(rng, b, smax, jcfg.n_kv_heads, jcfg.head_dim)
              for _ in range(2))
    x = _normal(rng, b, 1, jcfg.d_model)
    pos = np.array([0, 7, 15], np.int32)   # 15 > smax - 1: clamped write
    want, jcache = jax.jit(j_layers.attention_decode, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(pos))
    cache = {"k": torch.as_tensor(ck.copy()), "v": torch.as_tensor(cv.copy())}
    got, out_cache = layers.attention_decode(
        tp, cfg, torch.as_tensor(x), cache, torch.as_tensor(pos))
    assert out_cache is cache                         # written in place
    _close(got, want, 1e-5)
    _close(cache["k"], jcache["k"], 1e-5)
    _close(cache["v"], jcache["v"], 1e-5)


# -- the model ----------------------------------------------------------------

def _model(arch, seed=0):
    jcfg = j_configs.get_config(arch, smoke=True)
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), seed)
    return jcfg, jp, configs.get_config(arch, smoke=True), \
        lm_params_from_jax(jp, device="cpu")


def _tokens(rng, cfg, *lead):
    shape = lead + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    return rng.integers(0, cfg.vocab, size=shape).astype(np.int32)


def _close_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch, seed=ARCHS.index(arch))
    rng = np.random.default_rng(10 + ARCHS.index(arch))
    toks = _tokens(rng, cfg, 2, 11)
    for use_flash in (False, True):
        jcfg_f = dataclasses.replace(jcfg, use_flash=use_flash)
        want = jax.jit(lambda p, t: j_lm.lm_prefill(p, jcfg_f, {"tokens": t}))(
            jp, jnp.asarray(toks))
        got = lm.lm_prefill(tp, dataclasses.replace(cfg, use_flash=use_flash),
                            {"tokens": torch.as_tensor(toks)})
        _close_rel(got, want, 1e-4)

    b, max_len = 2, 16
    jcache = j_lm.init_cache(None, jcfg, b, max_len, jnp.float32)
    cache = lm.init_cache(cfg, b, max_len, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, c, t, q: j_lm.lm_decode_step(p, jcfg, c, t, q))
    pos = np.array([0, 3], np.int32)               # ragged slots
    for _ in range(12):
        tok = _tokens(rng, cfg, b, 1)
        want, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        got, cache = lm.lm_decode_step(tp, cfg, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        _close_rel(got, want, 1e-4)
        pos = pos + 1
    jl = jax.tree.leaves(jcache)
    tl = list(leaves(cache))
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        _close(t, a, 1e-5)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-360m",
                                  "musicgen-medium", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_decode_engine_greedy_tokens_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch, seed=40)
    rng = np.random.default_rng(41)
    prompts = [_tokens(rng, cfg, n).tolist() for n in (3, 1, 5, 2, 4)]
    jeng = JEngine(jp, jcfg, batch=2, max_len=12)
    eng = DecodeEngine(tp, cfg, batch=2, max_len=12, device="cpu")
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=4 + rid % 3))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4 + rid % 3))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert got == want and len(got) == 5
    assert eng.steps > 0


def _shape_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shape_tree(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shape_tree(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape) if hasattr(tree, "shape")
            else tuple(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_meta_init_has_the_jax_shapes(arch):
    want = j_lm.init_lm(JMaker("shapes"), j_configs.get_config(arch))
    got = lm.init_lm(configs.get_config(arch), device="meta")
    assert all(t.device.type == "meta" for t in leaves(got))
    assert _shape_tree(got) == _shape_tree(want)


def test_registry_covers_the_jax_arch_ids():
    assert configs.ARCHS == j_configs.ARCHS == configs.SUPPORTED_ARCHS
    for arch in configs.SUPPORTED_ARCHS:
        for smoke in (False, True):
            jc = dataclasses.asdict(j_configs.get_config(arch, smoke=smoke))
            assert dataclasses.asdict(configs.get_config(arch, smoke=smoke)) \
                == jc


def test_decode_engine_sampling_and_edges():
    """Sampling draws from the engine's own generator (same seed, same
    tokens); a greedy slot beside sampled ones keeps its greedy tokens;
    an empty prompt is refused; a drain that runs out of steps names the
    requests still in flight."""
    _, _, cfg, tp = _model("qwen3-1.7b", seed=50)

    def serve_all(temps, seed=0):
        eng = DecodeEngine(tp, cfg, batch=3, max_len=16, device="cpu",
                           rng_seed=seed)
        for rid, t in enumerate(temps):
            eng.submit(Request(rid=rid, prompt=[rid + 1, 7], max_new=6,
                               temperature=t))
        return {r.rid: r.out for r in eng.run()}

    mixed = serve_all([0.0, 1.5, 1.5])
    assert mixed == serve_all([0.0, 1.5, 1.5])
    assert mixed[0] == serve_all([0.0, 0.0, 0.0])[0]
    assert all(0 <= t < cfg.vocab for out in mixed.values() for t in out)
    eng = DecodeEngine(tp, cfg, batch=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=0, prompt=[]))
    eng.submit(Request(rid=1, prompt=[1, 2, 3], max_new=4))
    eng.submit(Request(rid=2, prompt=[4], max_new=4))
    with pytest.raises(DrainTimeout) as err:
        eng.run(max_steps=2)
    assert err.value.pending_rids == [1, 2]


def test_serve_command_runs_on_the_cpu(capsys):
    for arch, name in (("stablelm-1.6b", "stablelm-smoke"),
                       ("granite-moe-3b-a800m", "granite-smoke")):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                    "--max-new", "2", "--batch", "2"])
        out = capsys.readouterr().out
        assert "3 requests, 6 tokens" in out and name in out
