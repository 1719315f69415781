"""float16 through the port's LM path against the JAX package, on the CPU.

The JAX attention kernels widen any float type to float32 and return the
query's type, and ``init_lm`` / ``init_cache`` / ``DecodeEngine`` take any
dtype, so a JAX user serves Qwen3 in float16. Values are made with numpy
from fixed seeds and rounded to float16 for both packages; parameters are
seeded numpy leaves of the JAX init trees crossing through
``lm_params_from_jax``. Tolerances, against max|ref|:

* the plain #7 and #8 against the JAX kernels in interpret mode: one
  float16 ulp at the largest output (2**-10), both sides computing in
  float32 and rounding once; #8 with a float32 q over a float16 cache
  within 1e-5 (float32 sums in another order: the widening is exact);
* the Qwen3 smoke model in float16 (prefill through the ``_sdpa`` path
  and #7's plain version, 8 decode steps over a float16 cache) within
  ``MODEL_RTOL``, and the greedy tokens of a float16 ``DecodeEngine``
  equal to the JAX engine's;
* a float16 layer over a float32 cache: the port's decode path rounds the
  cache to float16 where #8 reads it (``round_kv``), as JAX casts it;
* float16 leaves through ``lm_params_from_jax`` and a checkpoint round
  trip, bit for bit.

Every JAX model reference runs under ``tests.test_torch_bf16._exact_jit``:
XLA rounds to float16 after each op as written, as the port's eager ops
do. The CUDA kernels' float16 forms are held against these plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 18).
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
from repro_torch.checkpoint import store
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import layers, lm
from repro_torch.serving import DecodeEngine, Request
from tests.test_torch_bf16 import _exact_jit, _jax, _normal, _numpy_params
from tests.test_torch_fp16 import F16, F16_ULP, _hold

# A whole float16 smoke model against JAX's: the layers' one-ulp flips
# (a value within an ulp of a rounding boundary rounds the other way in
# the other framework) grow through the layers; the bf16 bound (3e-2,
# tests/test_torch_bf16.py) scaled by bf16's ulp over float16's (8).
MODEL_RTOL = 3e-2 / 8


@pytest.mark.parametrize("case", [
    dict(b=2, sq=32, skv=32, hq=8, hkv=2, d=16),
    dict(b=1, sq=21, skv=50, hq=4, hkv=2, d=32, window=7, softcap=5.0),
    dict(b=1, sq=24, skv=40, hq=4, hkv=4, d=16, causal=False),
    dict(b=1, sq=24, skv=24, hq=4, hkv=2, d=144, window=5, softcap=50.0)])
def test_flash_attention_plain_matches_jax_in_fp16(case):
    c = dict(case)
    b, sq, skv, hq, hkv, d = (c.pop(k) for k in
                              ("b", "sq", "skv", "hq", "hkv", "d"))
    rng = np.random.default_rng(sq + d)
    q, k, v = (_normal(rng, b, sq, hq, d, dtype=np.float16),
               _normal(rng, b, skv, hkv, d, dtype=np.float16),
               _normal(rng, b, skv, hkv, d, dtype=np.float16))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, block_q=16, block_k=16, **c)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), **c)
    _hold(got, want)


@pytest.mark.parametrize("opts", [{}, {"window": 20, "softcap": 4.0}])
@pytest.mark.parametrize("q_dtype,tol", [(np.float16, F16_ULP),
                                         (np.float32, 1e-5)])
def test_flash_decode_plain_matches_jax_over_a_fp16_cache(opts, q_dtype,
                                                          tol):
    b, s, hq, hkv, d = 3, 96, 8, 2, 16
    rng = np.random.default_rng(7 + len(opts))
    q = _normal(rng, b, hq, d, dtype=q_dtype)
    kc, vc = (_normal(rng, b, s, hkv, d, dtype=np.float16)
              for _ in range(2))
    lengths = np.array([1, 96, 57], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), interpret=True, block_k=32, **opts)
    got = flash_decode(*(torch.as_tensor(a) for a in (q, kc, vc, lengths)),
                       **opts)
    _hold(got, want, tol)


# ---------------------------------------------------------------------------
# The Qwen3 smoke model in float16
# ---------------------------------------------------------------------------


def _qwen3(seed):
    jcfg = j_configs.get_config("qwen3-1.7b", smoke=True)
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), seed,
                       np.float16)
    return jcfg, _jax(jp), configs.get_config("qwen3-1.7b", smoke=True), \
        lm_params_from_jax(jp, device="cpu")


def test_qwen3_fp16_prefill_and_decode_match_jax():
    jcfg, jp, cfg, tp = _qwen3(seed=34)
    assert tp["embed"].dtype == F16
    rng = np.random.default_rng(35)
    b, max_len = 2, 16
    toks = rng.integers(0, cfg.vocab, size=(b, 11)).astype(np.int32)
    for use_flash in (False, True):
        jcfg_f = dataclasses.replace(jcfg, use_flash=use_flash)
        want = _exact_jit(lambda p, bt: j_lm.lm_prefill(p, jcfg_f, bt))(
            jp, {"tokens": jnp.asarray(toks)})
        got = lm.lm_prefill(tp, dataclasses.replace(cfg, use_flash=use_flash),
                            {"tokens": torch.as_tensor(toks)})
        _hold(got, want, MODEL_RTOL)
    jcache = j_lm.init_cache(None, jcfg, b, max_len, jnp.float16)
    cache = lm.init_cache(cfg, b, max_len, dtype=F16, device="cpu")
    step = _exact_jit(lambda p, c, t, q: j_lm.lm_decode_step(p, jcfg, c, t,
                                                              q))
    pos = np.array([0, 3], np.int32)
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
        want, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        got, cache = lm.lm_decode_step(tp, cfg, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        _hold(got, want, MODEL_RTOL)
        pos = pos + 1
    assert cache["stack"]["b0"]["mix"]["k"].dtype == F16


def test_qwen3_fp16_engine_greedy_tokens_match_jax():
    """5 requests over 2 slots of a float16 model with a float16 cache:
    the port's greedy tokens are the JAX engine's."""
    jcfg, jp, cfg, tp = _qwen3(seed=36)
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in (3, 1, 5, 2, 4)]
    jeng = JEngine(jp, jcfg, batch=2, max_len=12, cache_dtype=jnp.float16)
    eng = DecodeEngine(tp, cfg, batch=2, max_len=12, cache_dtype=F16,
                       device="cpu")
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=4 + rid % 3))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4 + rid % 3))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert got == want and len(got) == 5


# ---------------------------------------------------------------------------
# A float16 layer over a float32 cache
# ---------------------------------------------------------------------------

ATTN = j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                           qk_norm=True, rope_theta=1e6)


def test_fp16_layer_over_a_float32_cache_rounds_as_jax_casts():
    """A float16 model's decode over a float32 cache: JAX casts the cache
    to float16 before the attention, the port rounds it to float16 where
    #8 reads it (``_rounds_cache``: float16). The plain #8 with
    ``round_kv=float16`` equals #8 over the cast cache bitwise; the layer
    equals JAX's within one float16 ulp of max|ref| a few times over (the
    projections round at each op)."""
    jp = _numpy_params(j_layers.init_attention(JMaker("shapes"), ATTN), 8,
                       np.float16, scale=0.3)
    cfg = layers.AttnConfig(**dataclasses.asdict(ATTN))
    tp = lm_params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(9)
    b, smax = 3, 12
    ck, cv = (_normal(rng, b, smax, ATTN.n_kv_heads, ATTN.head_dim) * 3
              for _ in range(2))
    x = _normal(rng, b, 1, ATTN.d_model, dtype=np.float16)
    pos = np.array([0, 7, 11], np.int32)
    want, _ = _exact_jit(lambda *a: j_layers.attention_decode(
        a[0], ATTN, *a[1:]))(_jax(jp), jnp.asarray(x),
                             {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                             jnp.asarray(pos))
    cache = {"k": torch.as_tensor(ck.copy()), "v": torch.as_tensor(cv.copy())}
    got, _ = layers.attention_decode(tp, cfg, torch.as_tensor(x), cache,
                                     torch.as_tensor(pos))
    _hold(got, want, 4 * F16_ULP)
    assert layers._rounds_cache(torch.as_tensor(x), cache["k"]) == F16
    q = torch.as_tensor(_normal(rng, b, 4, 8, dtype=np.float16))
    lens = torch.tensor([1, 8, 12], dtype=torch.int32)
    assert torch.equal(
        flash_decode(q, cache["k"], cache["v"], lens, round_kv=F16),
        flash_decode(q, cache["k"].to(F16), cache["v"].to(F16), lens))


# ---------------------------------------------------------------------------
# float16 leaves across the packages and through a checkpoint
# ---------------------------------------------------------------------------


def test_fp16_leaves_through_convert_and_a_checkpoint(tmp_path):
    """JAX float16 leaves arrive as torch float16 with their bits; a
    checkpoint of them restores float16 leaves bit for bit."""
    jcfg = j_configs.get_config("qwen3-1.7b", smoke=True)
    jp = jax.tree.map(np.asarray, _jax(_numpy_params(
        j_lm.init_lm(JMaker("shapes"), jcfg), 38, np.float16)))
    tp = lm_params_from_jax(jp, device="cpu")
    j_leaves = jax.tree.leaves(jp)
    t_leaves = jax.tree.leaves(tp)
    assert len(j_leaves) == len(t_leaves)
    for a, t in zip(j_leaves, t_leaves):
        assert t.dtype == F16 and np.array_equal(
            t.numpy().view(np.uint16), a.view(np.uint16))
    store.save(str(tmp_path), 3, {"params": tp})
    back = store.restore(str(tmp_path), 3, {"params": tp},
                         device="cpu")["params"]
    for t, r in zip(t_leaves, jax.tree.leaves(back)):
        assert r.dtype == F16 and torch.equal(r, t)
