"""The port's bf16 LM serving path against the JAX package, on the CPU.

Values are made with numpy from fixed seeds, rounded to bf16 (numpy's
``ml_dtypes`` bfloat16) and fed to both packages; parameters are seeded
numpy leaves of the JAX init trees, rounded to bf16, crossing through
``repro_torch.convert.lm_params_from_jax``. JAX runs the Pallas kernels in
interpret mode. Tolerances, each against max|ref|:

* the plain flash attention (#7) and flash decode (#8): output dtype
  equal to the JAX kernel's; a bf16 output within one bf16 ulp of
  max|ref| (both sides compute in float32 and round once, so only a
  rounding tie broken the other way differs), a float32 output within
  1e-5 (float32 sums in another order);
* one bf16 attention layer (``attention_train`` through #7's plain
  version, ``attention_decode`` over a bf16 cache): within 2**-6 — the
  projections, norms and rotary embedding round to bf16 at each op, and a
  bf16 value that lands within an ulp of a rounding boundary may round the
  other way in the other framework: a few ulps of the output;
* eight attention-family smoke models (``lm_prefill`` and 8
  ``lm_decode_step``s over a bf16 cache, bf16 params): within 3e-2, JAX's
  own bf16 bound for #7 (``tests/test_kernels.py::test_bf16``). Whole
  models amplify those one-ulp flips layer by layer.

Every JAX reference is compiled with ``xla_allow_excess_precision`` off
(:func:`_exact_jit`), so that XLA rounds to bf16 after each op as written,
as the port's eager ops do: by default its fusions skip those roundings,
and over a top-k router a skipped rounding can move a token to another
expert (deepseek's smoke model moves its decode logits by 13 % of
max|logits| so at one step);
* the recurrent blocks (Mamba, mLSTM, sLSTM) alone in bf16, train and
  one decode step: within 2**-5. The whole recurrent smoke models are
  held in float32 only (``tests/test_torch_recurrent.py``): at random
  weights their bf16 runs are chaotic (JAX's own bf16 run lies 2-63 %
  from its float32 run on the same bf16 weights), so a whole-model bound
  would say nothing;
* served greedy tokens equal to the JAX engine's: qwen3 with float32
  params over a bf16 cache, qwen3 with bf16 params, llama-3.2-vision
  with bf16 params over a filled bf16 cross cache.

The CUDA kernels' bf16 forms are held against these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 13).
"""

import dataclasses
import math

import ml_dtypes
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
from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro.models.params import Maker as JMaker
from repro.serving import DecodeEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import (MAX_KERNEL_HEAD_DIM,
                                                 flash_attention,
                                                 tile_config)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import layers, lm, ssm, xlstm
from repro_torch.serving import DecodeEngine, Request

BF16 = ml_dtypes.bfloat16
ARCHS = ("qwen3-1.7b", "gemma2-27b", "smollm-360m", "stablelm-1.6b",
         "musicgen-medium", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "llama-3.2-vision-11b")
MODEL_RTOL = 3e-2
LAYER_RTOL = 2.0 ** -6
BLOCK_RTOL = 2.0 ** -5


def _normal(rng, *shape, dtype=np.float32):
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _t(a):
    """A numpy array (float32, bf16 or int) as a CPU tensor of its type."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.as_tensor(a.copy())


def _np(x):
    """A tensor or JAX array as a float32 numpy array, with its dtype name."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy(), str(x.dtype).removeprefix("torch.")
    return np.asarray(x, np.float32), str(x.dtype)


def _ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _hold(got, want, tol=None, *, ulps=None):
    """``got`` (torch) within ``tol`` * max|want| of ``want`` (JAX), or
    within ``ulps`` bf16 ulps of max|want|; equal dtypes, finite."""
    g, gd = _np(got)
    w, wd = _np(want)
    assert gd == wd and g.shape == w.shape and np.isfinite(g).all()
    scale = float(np.abs(w).max())
    limit = ulps * _ulp(scale) if ulps is not None else tol * scale
    err = float(np.abs(g - w).max())
    assert err <= limit, (err, limit)


def _numpy_params(shapes, seed, dtype=BF16, scale=0.1):
    """Seeded numpy leaves (rounded to ``dtype``) for a JAX
    ``Maker("shapes")`` tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (_normal(rng, *s) * np.float32(scale)).astype(dtype),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _exact_jit(fn, *static):
    """``fn`` under ``jax.jit`` (``static`` its static argument numbers),
    compiled per call signature with XLA's excess precision off: each bf16
    op rounds as written."""
    jitted = jax.jit(fn, static_argnums=static)
    compiled = {}

    def call(*args):
        key = tuple(a if i in static else jax.tree.structure(a)
                    for i, a in enumerate(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*(a for i, a in enumerate(args)
                               if i not in static))

    return call


# -- kernel #7: flash attention -------------------------------------------

FLASH_CASES = {
    "causal_gqa": dict(b=2, sq=32, skv=32, hq=8, hkv=2, d=16),
    "ragged_causal": dict(b=1, sq=21, skv=50, hq=4, hkv=2, d=32),
    "non_causal_sq_lt_skv": dict(b=1, sq=24, skv=40, hq=4, hkv=4, d=16,
                                 causal=False),
    "non_causal_sq_gt_skv": dict(b=1, sq=40, skv=17, hq=4, hkv=1, d=16,
                                 causal=False),
    "window": dict(b=1, sq=40, skv=40, hq=4, hkv=2, d=16, window=7),
    "softcap": dict(b=1, sq=40, skv=40, hq=4, hkv=2, d=16, softcap=5.0),
    "d144_window_softcap": dict(b=1, sq=24, skv=24, hq=4, hkv=2, d=144,
                                window=5, softcap=50.0),
}
# (q dtype, k / v dtype): all bf16, and the two mixed forms.
MIXES = {"bf16": (BF16, BF16), "f32_q_bf16_kv": (np.float32, BF16),
         "bf16_q_f32_kv": (BF16, np.float32)}
# Every case in bf16; the mixed forms (a cross layer fed states of the
# other dtype, a float32 model over a bf16 cache) on a causal GQA and a
# non-causal case.
FLASH_RUNS = [(case, "bf16") for case in sorted(FLASH_CASES)] + [
    (case, mix) for case in ("causal_gqa", "non_causal_sq_lt_skv")
    for mix in ("f32_q_bf16_kv", "bf16_q_f32_kv")]
DECODE_OPTS = [{}, {"window": 20}, {"softcap": 4.0},
               {"window": 33, "softcap": 30.0}]
DECODE_RUNS = [(i, "bf16") for i in range(len(DECODE_OPTS))] + [
    (i, mix) for i in (0, 3) for mix in ("f32_q_bf16_kv", "bf16_q_f32_kv")]


def _ulps(q_dtype):
    """The bound of a kernel's output in the dtype of q."""
    return dict(ulps=1) if q_dtype == BF16 else dict(tol=1e-5)


@pytest.mark.parametrize("case,mix", FLASH_RUNS)
def test_flash_attention_plain_matches_jax(case, mix):
    c = dict(FLASH_CASES[case])
    b, sq, skv, hq, hkv, d = (c.pop(k) for k in
                              ("b", "sq", "skv", "hq", "hkv", "d"))
    qd, kd = MIXES[mix]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    q, k, v = (_normal(rng, b, sq, hq, d, dtype=qd),
               _normal(rng, b, skv, hkv, d, dtype=kd),
               _normal(rng, b, skv, hkv, d, dtype=kd))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, block_q=16, block_k=16, **c)
    got = flash_attention(_t(q), _t(k), _t(v), **c)
    _hold(got, want, **_ulps(qd))


@pytest.mark.parametrize("d", range(8, MAX_KERNEL_HEAD_DIM + 1, 8))
def test_flash_tile_config_bf16_fits_shared_memory(d):
    """The bf16 kernel's tiles for every head dim it takes (multiples of
    8 up to 144): 128 query rows over 64-key tiles in two consumer
    warpgroups and a producer warp, and its shared memory (the alignment
    slack, q, K and V rings of 4 tiles, the rings' and q's mbarriers)
    fits a block's 232,448 bytes."""
    t = tile_config(d, torch.bfloat16)
    dp = t["dp"]
    assert dp % 16 == 0 and d <= dp < d + 16
    assert (t["block_q"], t["block_k"], t["threads"], t["stages"]) == (
        128, 64, 288, 4)
    assert t["smem_bytes"] == 1024 + 2 * 128 * dp + 4 * 4 * 64 * dp \
        + 8 * (4 * 4 + 1) <= 232_448
    for bad in (d - 4, MAX_KERNEL_HEAD_DIM + 8):
        if bad > 0:
            with pytest.raises(ValueError, match="multiple of 8"):
                tile_config(bad, torch.bfloat16)


@pytest.mark.parametrize("d", range(8, MAX_KERNEL_HEAD_DIM + 1, 8))
def test_flash_tile_config_bf16_swizzle_divides_row(d):
    """Every head dim gets a swizzle (128, 64 or 32 B) whose row of
    swizzle / 2 values (the TMA box's width) divides its padded row: the
    widest that does, so D 64 / 128 land in 128 B panels, 32 / 96 in 64 B
    ones and the rest (80, 112, 144, ...) in 32 B ones. Each panel and
    each ring stage is 1,024-byte aligned for the swizzle atoms."""
    t = tile_config(d, torch.bfloat16)
    dp, panel = t["dp"], t["swizzle"] // 2
    assert t["swizzle"] in (32, 64, 128)
    assert dp % panel == 0
    assert panel == 64 or dp % (2 * panel)          # the widest that fits
    assert t["smem_bytes"] <= 232_448
    for rows in (t["block_q"], t["block_k"]):
        assert (rows * 2 * panel) % 1024 == 0       # one panel's bytes
        assert (rows * 2 * dp) % 1024 == 0          # one tile's bytes


# -- kernel #8: flash decode ------------------------------------------------

@pytest.mark.parametrize("opts,mix", DECODE_RUNS)
def test_flash_decode_plain_matches_jax(opts, mix):
    kwargs = DECODE_OPTS[opts]
    b, s, hq, hkv, d = 3, 96, 8, 2, 16
    qd, kd = MIXES[mix]
    rng = np.random.default_rng(5 + len(kwargs))
    q, kc, vc = (_normal(rng, b, hq, d, dtype=qd),
                 _normal(rng, b, s, hkv, d, dtype=kd),
                 _normal(rng, b, s, hkv, d, dtype=kd))
    lengths = np.array([1, 96, 57], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), interpret=True, block_k=32,
                    **kwargs)
    got = flash_decode(_t(q), _t(kc), _t(vc), _t(lengths), **kwargs)
    _hold(got, want, **_ulps(qd))


# -- one bf16 attention layer ---------------------------------------------------

ATTN_CFGS = {
    "qwen3": j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2,
                                 head_dim=8, qk_norm=True, rope_theta=1e6),
    "gemma2": j_layers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2,
                                  head_dim=16, window=5, attn_softcap=50.0),
}


def _attn(name, seed):
    jcfg = ATTN_CFGS[name]
    jp = _numpy_params(j_layers.init_attention(JMaker("shapes"), jcfg), seed,
                       scale=0.3)
    return jcfg, jp, layers.AttnConfig(**dataclasses.asdict(jcfg)), \
        lm_params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_train_through_flash_in_bf16(name):
    """``attention_train(use_flash=True)`` keeps bf16 activations: #7's
    output comes back in q's dtype, as the JAX kernel's does."""
    jcfg, jp, cfg, tp = _attn(name, 3)
    x = _normal(np.random.default_rng(4), 2, 19, jcfg.d_model, dtype=BF16)
    want = _exact_jit(lambda p, x: j_layers.attention_train(
        p, jcfg, x, use_flash=True))(_jax(jp), jnp.asarray(x))
    got = layers.attention_train(tp, cfg, _t(x), use_flash=True)
    _hold(got, want, LAYER_RTOL)


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_decode_over_a_bf16_cache(name):
    jcfg, jp, cfg, tp = _attn(name, 5)
    rng = np.random.default_rng(6)
    b, smax = 3, 12
    ck, cv = (_normal(rng, b, smax, jcfg.n_kv_heads, jcfg.head_dim,
                      dtype=BF16) for _ in range(2))
    x = _normal(rng, b, 1, jcfg.d_model, dtype=BF16)
    pos = np.array([0, 7, 11], np.int32)
    want, jcache = _exact_jit(lambda *a: j_layers.attention_decode(
        a[0], jcfg, *a[1:]))(_jax(jp), jnp.asarray(x),
                             {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                             jnp.asarray(pos))
    cache = {"k": _t(ck), "v": _t(cv)}
    got, _ = layers.attention_decode(tp, cfg, _t(x), cache, _t(pos))
    _hold(got, want, LAYER_RTOL)
    for name_ in ("k", "v"):
        _hold(cache[name_], jcache[name_], LAYER_RTOL)


# -- the attention-family smoke models in bf16 -------------------------------

def _model(arch, seed, dtype=BF16):
    jcfg = j_configs.get_config(arch, smoke=True)
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), seed, dtype)
    return jcfg, _jax(jp), configs.get_config(arch, smoke=True), \
        lm_params_from_jax(jp, device="cpu")


def _tokens(rng, cfg, *lead):
    shape = lead + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    return rng.integers(0, cfg.vocab, size=shape).astype(np.int32)


def _states(rng, cfg, b):
    return _normal(rng, b, cfg.n_cross_tokens, cfg.d_cross, dtype=BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch, seed=ARCHS.index(arch))
    rng = np.random.default_rng(20 + ARCHS.index(arch))
    b, max_len = 2, 16
    toks = _tokens(rng, cfg, b, 11)
    jbatch, batch = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.n_cross_tokens:
        st = _states(rng, cfg, b)
        jbatch["cross_states"], batch["cross_states"] = jnp.asarray(st), \
            _t(st)
    for use_flash in (False, True):
        jcfg_f = dataclasses.replace(jcfg, use_flash=use_flash)
        want = _exact_jit(lambda p, bt: j_lm.lm_prefill(p, jcfg_f, bt))(
            jp, jbatch)
        got = lm.lm_prefill(tp, dataclasses.replace(cfg, use_flash=use_flash),
                            batch)
        _hold(got, want, MODEL_RTOL)

    jcache = j_lm.init_cache(None, jcfg, b, max_len, jnp.bfloat16)
    cache = lm.init_cache(cfg, b, max_len, dtype=torch.bfloat16, device="cpu")
    if cfg.n_cross_tokens:
        jcache = j_lm.build_cross_cache(jp, jcfg, jcache,
                                        jbatch["cross_states"])
        cache = lm.build_cross_cache(tp, cfg, cache, batch["cross_states"])
    step = _exact_jit(lambda p, c, t, q: j_lm.lm_decode_step(p, jcfg, c, t,
                                                              q))
    pos = np.array([0, 3], np.int32)               # ragged slots
    for _ in range(8):
        tok = _tokens(rng, cfg, b, 1)
        want, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        got, cache = lm.lm_decode_step(tp, cfg, cache, _t(tok), _t(pos))
        _hold(got, want, MODEL_RTOL)
        pos = pos + 1


# -- the recurrent blocks, each alone in bf16 ----------------------------------

MAMBA = j_ssm.MambaConfig(d_model=32, chunk_size=8)
XLSTM = j_xlstm.XlstmConfig(d_model=32, n_heads=2, chunk_size=8)
# (JAX init, JAX config, port config, JAX train, port train, JAX decode,
#  port decode, JAX cache, port cache)
BLOCKS = {
    "mamba": (j_ssm.init_mamba, MAMBA,
              ssm.MambaConfig(**dataclasses.asdict(MAMBA)), j_ssm.mamba_train,
              ssm.mamba_train, j_ssm.mamba_decode, ssm.mamba_decode,
              lambda c, b: j_ssm.init_mamba_cache(None, c, b,
                                                  dtype=jnp.bfloat16),
              lambda c, b: ssm.init_mamba_cache(c, b, dtype=torch.bfloat16)),
    "mlstm": (j_xlstm.init_mlstm, XLSTM,
              xlstm.XlstmConfig(**dataclasses.asdict(XLSTM)),
              j_xlstm.mlstm_train, xlstm.mlstm_train, j_xlstm.mlstm_decode,
              xlstm.mlstm_decode,
              lambda c, b: j_xlstm.init_mlstm_cache(None, c, b),
              xlstm.init_mlstm_cache),
    "slstm": (j_xlstm.init_slstm, XLSTM,
              xlstm.XlstmConfig(**dataclasses.asdict(XLSTM)),
              j_xlstm.slstm_train, xlstm.slstm_train, j_xlstm.slstm_decode,
              xlstm.slstm_decode,
              lambda c, b: j_xlstm.init_slstm_cache(None, c, b),
              xlstm.init_slstm_cache),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_recurrent_block_in_bf16_matches_jax(kind):
    """Train over 13 steps (a chunk and a tail) and 3 decode steps from
    the initial cache, bf16 params and inputs; the output keeps x's
    dtype."""
    j_init, jcfg, cfg, j_train, train, j_dec, dec, j_cache, cache_fn = \
        BLOCKS[kind]
    jp = _numpy_params(j_init(JMaker("shapes"), jcfg), 1, scale=0.3)
    tp = lm_params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 13, jcfg.d_model, dtype=BF16)
    want = _exact_jit(j_train, 1)(_jax(jp), jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = train(tp, cfg, _t(x))
    _hold(got, want, BLOCK_RTOL)
    b = 3
    jc, tc = j_cache(jcfg, b), cache_fn(cfg, b)
    step = _exact_jit(j_dec, 1)
    for _ in range(3):
        xs = _normal(rng, b, 1, jcfg.d_model, dtype=BF16)
        want, jc = step(_jax(jp), jcfg, jnp.asarray(xs), jc)
        got, tc = dec(tp, cfg, _t(xs), tc)
        _hold(got, want, BLOCK_RTOL)
        for name in jc:
            _hold(tc[name], jc[name], BLOCK_RTOL)


# -- the engine ----------------------------------------------------------------

ENGINES = {
    "qwen3_f32_params_bf16_cache": ("qwen3-1.7b", np.float32),
    "qwen3_bf16_params": ("qwen3-1.7b", BF16),
    "llama_bf16_cross_cache": ("llama-3.2-vision-11b", BF16),
}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_bf16_engine_greedy_tokens_match_jax(case):
    """5 requests over 2 slots of a ``cache_dtype=bfloat16`` engine: the
    port's greedy tokens are the JAX engine's; the llama engines decode
    over the same bf16 image K/V."""
    arch, dtype = ENGINES[case]
    jcfg, jp, cfg, tp = _model(arch, seed=40, dtype=dtype)
    rng = np.random.default_rng(41)
    prompts = [_tokens(rng, cfg, n).tolist() for n in (3, 1, 5, 2, 4)]
    jeng = JEngine(jp, jcfg, batch=2, max_len=12, cache_dtype=jnp.bfloat16)
    eng = DecodeEngine(tp, cfg, batch=2, max_len=12,
                       cache_dtype=torch.bfloat16, device="cpu")
    if cfg.n_cross_tokens:
        st = _states(rng, cfg, 2).astype(dtype)
        jeng.cache = j_lm.build_cross_cache(jp, jcfg, jeng.cache,
                                            jnp.asarray(st))
        eng.cache = lm.build_cross_cache(tp, cfg, eng.cache, _t(st))
        assert eng.cache["stack"]["b3"]["mix"]["k"].dtype == torch.bfloat16
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=4 + rid % 3))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4 + rid % 3))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert got == want and len(got) == 5
