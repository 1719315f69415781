"""#7 and #8 at every head dim, group and alignment the JAX kernels take.

The JAX flash-attention and decode kernels take any head dim, any number
of query heads over a kv head and any operand; public models reach past
the port's fast bodies (Gemma-7B and Gemma-2-9B: head dim 256; Falcon-7B:
71 query heads over one kv head). On a card those shapes run the general
body ``csrc/attention_any.cu``; on the CPU every body's plain version is
the same function, held here against the JAX kernels in interpret mode
(inputs from numpy seeds): a float32 output within 1e-5 of max|ref| (sums
in another order), a 16-bit one within one ulp of its type at max|ref|
(both sides round a float32 result once). Also an ``AttnConfig`` layer at
head dim 256 over one kv head through both packages, and the pure body
choosers ``attention_body`` / ``decode_body``, one case per shape class,
and the general body's launch plan ``general_plan`` (every head dim up to
1024 within the shared memory, every one up to 4096 with a plan, the wide
path past the shared memory, #8's splits covering each sequence's visible
keys once, the grid within 2^31 - 1 blocks, the copy widths).
The general bodies themselves are held against these plain versions on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 18d).
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.models import layers as j_layers
from repro.models.params import Maker as JMaker
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import layers
from tests.test_torch_bf16 import _exact_jit, _jax, _normal, _numpy_params
from tests.test_torch_bf16 import _t

DTYPES = {"float32": (np.float32, 1e-5),
          "bfloat16": (ml_dtypes.bfloat16, 2.0 ** -7),
          "float16": (np.float16, 2.0 ** -10)}


def _hold(got, want, tol):
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.abs(g - w).max() <= tol * np.abs(w).max()


# -- #7 --------------------------------------------------------------------

FLASH = [
    (6, "float32", {}),
    (160, "bfloat16", dict(window=9)),
    (256, "float16", dict(softcap=20.0)),
    (320, "float32", dict(causal=False)),
    (320, "float16", dict(window=5, softcap=30.0)),
]


@pytest.mark.parametrize("d,dtype,opts", FLASH)
def test_flash_attention_plain_matches_jax_at_any_head_dim(d, dtype, opts):
    npd, tol = DTYPES[dtype]
    b, sq, skv, hq, hkv = 1, 19, 27, 4, 2
    rng = np.random.default_rng(d)
    q, k, v = (_normal(rng, b, sq, hq, d, dtype=npd),
               _normal(rng, b, skv, hkv, d, dtype=npd),
               _normal(rng, b, skv, hkv, d, dtype=npd))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, block_q=16, block_k=16, **opts)
    _hold(fa.flash_attention(_t(q), _t(k), _t(v), **opts), want, tol)


# -- #8 --------------------------------------------------------------------

DECODE = [
    (6, 2, 1, "float32", {}),
    (160, 4, 2, "float16", dict(window=11)),
    (256, 2, 1, "bfloat16", {}),
    (320, 4, 1, "float16", dict(softcap=25.0)),
    (64, 16, 1, "float32", dict(window=20)),      # group 16
    (64, 71, 1, "float16", {}),                   # Falcon-7B's 71 / 1
]


@pytest.mark.parametrize("d,hq,hkv,dtype,opts", DECODE)
def test_flash_decode_plain_matches_jax_at_any_shape(d, hq, hkv, dtype,
                                                     opts):
    npd, tol = DTYPES[dtype]
    b, s = 2, 40
    rng = np.random.default_rng(d + hq)
    q = _normal(rng, b, hq, d, dtype=npd)
    kc, vc = (_normal(rng, b, s, hkv, d, dtype=npd) for _ in range(2))
    lengths = np.array([40, 13], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), interpret=True, block_k=16,
                    **opts)
    got = fd.flash_decode(_t(q), _t(kc), _t(vc), _t(lengths), **opts)
    _hold(got, want, tol)


# -- a layer at head dim 256 over one kv head --------------------------------

WIDE = j_layers.AttnConfig(d_model=48, n_heads=4, n_kv_heads=1,
                           head_dim=256, qk_norm=True, rope_theta=1e4)


def test_head_dim_256_layer_over_one_kv_head_matches_jax():
    """Prefill through #7's plain version and one decode step over a
    float32 cache, both packages on the same weights, within 1e-5."""
    jp = _numpy_params(j_layers.init_attention(JMaker("shapes"), WIDE), 11,
                       np.float32, scale=0.2)
    cfg = layers.AttnConfig(**dataclasses.asdict(WIDE))
    tp = lm_params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(12)
    x = _normal(rng, 2, 9, WIDE.d_model)
    want = _exact_jit(lambda p, x: j_layers.attention_train(
        p, WIDE, x, use_flash=True))(_jax(jp), jnp.asarray(x))
    _hold(layers.attention_train(tp, cfg, _t(x), use_flash=True), want,
          1e-5)
    ck, cv = (_normal(rng, 2, 10, 1, 256) for _ in range(2))
    xs = _normal(rng, 2, 1, WIDE.d_model)
    pos = np.array([3, 9], np.int32)
    want, _ = _exact_jit(lambda *a: j_layers.attention_decode(
        a[0], WIDE, *a[1:]))(_jax(jp), jnp.asarray(xs),
                             {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                             jnp.asarray(pos))
    got, _ = layers.attention_decode(tp, cfg, _t(xs),
                                     {"k": _t(ck), "v": _t(cv)}, _t(pos))
    _hold(got, want, 1e-5)


# -- the body choosers ---------------------------------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("args,body", [
    ((128, F32), "tf32"),                  # the float32 kernel
    ((144, BF16), "16bit"),                # the 16-bit kernel, bf16
    ((64, F16), "16bit"),                  # and float16
    ((6, F32), "general"),                 # not whole 16-byte words
    ((100, F16), "general"),               # a 16-bit row of 200 bytes
    ((160, F32), "general"),               # past the fast bodies' 144
    ((128, F16, False), "general"),        # an operand off 16 bytes
    ((152, BF16, True), "general"),        # past 144 in 16 bits
    ((136, F16, True), "16bit"),           # the largest but one, aligned
])
def test_attention_body(args, body):
    assert fa.attention_body(*args) == body


@pytest.mark.parametrize("args,body", [
    ((128, 2, F32), "split"),              # a float32 cache
    ((100, 2, F32), "split"),              # whole float32 words
    ((128, 2, F16), "split"),              # a float16 cache, same body
    ((128, 2, BF16), "cluster"),           # a bf16 cache
    ((256, 8, BF16), "cluster"),
    ((100, 2, F16), "general"),            # a 16-bit row of 200 bytes
    ((6, 1, F32), "general"),
    ((320, 2, F32), "general"),            # past 256
    ((64, 16, F32), "general"),            # a group past 8
    ((64, 71, F16), "general"),            # Falcon-7B's 71 / 1
    ((128, 2, F16, False), "general"),     # an operand off 16 bytes
    ((128, 2, BF16, True, 65536), "general"),  # B * Hkv past a grid dim
    ((128, 2, F32, True, 65536), "split"),     # the split body's is 2^31
    ((128, 2, F32, True, 1, BF16), "split"),   # round_kv on the split body
    ((128, 2, F16, True, 1, BF16), "general"),  # rounding a float16 cache
    ((128, 2, BF16, True, 1, F16), "general"),  # rounding a bf16 cache
])
def test_decode_body(args, body):
    assert fd.decode_body(*args) == body


def test_bodies_are_chosen_before_any_launch():
    """On the CPU no body launches: the plain version runs at every shape,
    and neither wrapper counts a launch or a body."""
    for fn in (fa.flash_attention, fd.flash_decode):
        fn.launches, fn.bodies = 0, {}
    q = torch.zeros(1, 3, 71, 320, dtype=F16)
    kv = torch.zeros(1, 3, 1, 320, dtype=F16)
    assert fa.flash_attention(q, kv, kv).dtype == F16
    assert fd.flash_decode(q[:, 0].contiguous(), kv, kv,
                           torch.tensor([2], dtype=torch.int32)).dtype == F16
    for fn in (fa.flash_attention, fd.flash_decode):
        assert fn.launches == 0 and fn.bodies == {}


# -- the general body's launch plan (csrc/attention_any.cu) -------------------

PLAN_TYPES = [(F32, F32, None), (BF16, BF16, None), (F16, F16, None),
              (F32, BF16, None), (F16, F32, F16), (BF16, F16, BF16)]


@pytest.mark.parametrize("q_dtype,kv_dtype,rk", PLAN_TYPES)
@pytest.mark.parametrize("mode,rows", [(0, 2048), (0, 3), (1, 71), (1, 2)])
def test_general_plan_fits_every_head_dim(mode, rows, q_dtype, kv_dtype, rk):
    """Every head dim 1..1024 plans within SMEM_LIMIT and the block's
    warps, its column warps cover the padded head dim, its row tiles cover
    the rows, and the 16-bit path is taken exactly where q and the caches
    share a 16-bit type and nothing is rounded."""
    half = q_dtype == kv_dtype and kv_dtype != F32 and rk is None
    for d in range(1, 1025):
        p = fa.general_plan(mode, d, rows, 4, q_dtype, kv_dtype, round_kv=rk)
        assert p["smem_bytes"] <= fa.SMEM_LIMIT, (d, p)
        assert p["threads"] == 32 * p["rf"] * p["cw"] <= 32 * fa.GENERAL_WARPS
        assert p["cw"] * p["col_w"] >= p["dp"] >= d
        assert p["col_w"] <= fa.GENERAL_COLS and p["col_w"] % 16 == 0
        assert fa.GENERAL_STAGES <= p["stages"] <= fa.GENERAL_MAX_STAGES
        assert p["bk"] in ((64, 32, 16) if half else (64, 32, 16, 8))
        assert p["block_rows"] * p["row_tiles"] >= rows
        assert p["path"] == ("16bit" if half else "tf32")


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_general_plan_chunks_large_groups(dtype):
    """#8 takes at most ``GENERAL_DECODE_FRAGS`` row fragments a block:
    Falcon-7B's 71 heads over one kv head are three chunks of 32 heads, each
    fragment's keys and columns over two warps; a group of 16 stays one
    fragment over four warps."""
    p = fa.general_plan(1, 64, 71, 4, dtype, dtype, splits=30)
    assert (p["rf"], p["cw"], p["cs"], p["row_tiles"]) == (2, 2, 2, 3)
    assert p["blocks"] == 4 * 3 * 30
    p = fa.general_plan(1, 128, 16, 4, dtype, dtype, splits=8)
    assert (p["rf"], p["cw"], p["row_tiles"]) == (1, 4, 1)


# The first head dim whose tensor-core tiles pass the shared memory, by
# (q, caches, round_kv): over float32 (or rounded float32) caches, q and
# the caches of one 16-bit type, another q over 16-bit caches.
WIDE_FROM = {(F32, F32, None): 1185, (BF16, BF16, None): 1409,
             (F16, F16, None): 1409, (F32, BF16, None): 1793,
             (F16, F32, F16): 1185, (BF16, F16, BF16): 1793}


@pytest.mark.parametrize("q_dtype,kv_dtype,rk", PLAN_TYPES)
@pytest.mark.parametrize("mode,rows", [(0, 2048), (1, 71)])
def test_general_plan_gives_every_head_dim_a_plan(mode, rows, q_dtype,
                                                  kv_dtype, rk):
    """Every head dim 1..4096 has a plan: the tensor-core body's below
    ``WIDE_FROM``, the wide path's (``csrc/attention_wide.cu``) from it on,
    32 (#7) or 8 (#8) rows a block, one block a 128-column slice of the
    output, not split."""
    first = WIDE_FROM[q_dtype, kv_dtype, rk]
    for d in range(first - 64, 4097):
        p = fa.general_plan(mode, d, rows, 4, q_dtype, kv_dtype, round_kv=rk,
                            splits=8)
        if d < first:
            assert p["path"] != "wide" and p["smem_bytes"] <= fa.SMEM_LIMIT
            continue
        assert p["path"] == "wide", (d, p)
        assert p["col_slices"] * fa.WIDE_COLS >= d > (p["col_slices"] - 1) \
            * fa.WIDE_COLS
        assert p["block_rows"] == (32 if mode == 0 else 8)
        assert p["block_rows"] * p["row_tiles"] >= rows
        assert p["splits"] == 1 and p["blocks"] == 4 * p["row_tiles"]


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("d", [1280, 1536, 2048])
def test_general_plan_wide_head_dims(d, dtype):
    """D 1280, 1536 and 2048 in each type: float32 takes the wide path at
    all three, 16-bit operands at 1536 and 2048 and the tensor-core body at
    1280; a grid past 2^31 - 1 blocks is refused on either path."""
    p = fa.general_plan(0, d, 300, 2, dtype, dtype)
    assert p["path"] == ("wide" if d >= WIDE_FROM[dtype, dtype, None]
                         else "16bit")
    with pytest.raises(ValueError, match="2\\^31"):
        fa.general_plan(0, d, 2**30, 2**12, dtype, dtype)


def test_split_rule_is_one_header():
    """The CUDA split rule lives once, in ``csrc/kv_split.cuh``, which the
    split body and the general body include, and its constants are
    ``split_ranges``' (``KEY_TILE``, ``_MIN_SPLIT_KEYS``)."""
    import re
    from pathlib import Path

    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    header = (csrc / "kv_split.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", header))
    assert int(consts["TK"]) == fd.KEY_TILE
    assert int(consts["MIN_KEYS"]) == fd._MIN_SPLIT_KEYS
    for name in ("flash_decode.cu", "attention_any.cu"):
        src = (csrc / name).read_text()
        assert '#include "kv_split.cuh"' in src
        assert "Split split_of(" not in src and "kv_split::split_of(" in src


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("num_splits", [1, 7, None])
def test_general_splits_cover_visible_keys_once(window, num_splits):
    """#8's splits (``split_ranges``, the rule of ``csrc/kv_split.cuh``
    that the split and general bodies share) cover each sequence's visible
    keys exactly once and in order, at most ``splits`` of them, none for a
    sequence with no visible key."""
    lengths, s_len = [0, 1, 63, 64, 65, 969, 1947, 2048, 2100], 2048
    splits = num_splits or fd.default_splits(len(lengths), 1, s_len)
    target = (None if num_splits else fd._BLOCKS_PER_SM * fd.H100_SMS)
    ranges = fd.split_ranges(lengths, s_len, splits, 1, window,
                             target=target)
    for length, rs in zip(lengths, ranges):
        lo = max(0, length - window) if window else 0
        keys = [k for a, e in rs for k in range(a, e)]
        assert keys == list(range(lo, min(length, s_len)))
        assert len(rs) <= splits and all(a < e for a, e in rs)


@pytest.mark.parametrize("s_len,g,d", [(16, 1, 16), (4096, 8, 128),
                                       (32768, 71, 64)])
def test_general_grid_within_int32_at_65536_pairs(s_len, g, d):
    """B x Hkv = 65,536 (8192 x 8, past the cluster body's 65,535 rows) at
    the default split limit: the grid's x dimension holds every (pair,
    group chunk, split) block within 2^31 - 1; a grid past it is refused
    before any launch."""
    b, hkv = 8192, 8
    splits = fd.default_splits(b, hkv, s_len)
    p = fa.general_plan(1, d, g, b * hkv, BF16, BF16, splits=splits)
    assert p["blocks"] == b * hkv * p["row_tiles"] * splits <= 2**31 - 1
    assert fa.general_plan(0, d, 4096, b * hkv, F16, F16)["blocks"] <= \
        2**31 - 1
    with pytest.raises(ValueError, match="2\\^31"):
        fa.general_plan(1, d, g, b * hkv, BF16, BF16, splits=2**15)


@pytest.mark.parametrize("ptr,d,size,width", [
    (0, 128, 2, 16),      # 16-byte rows from an aligned base: TMA boxes
    (8, 128, 2, 4),       # 8 bytes past a 16-byte boundary
    (2, 128, 2, 2),       # a bf16 view at an odd offset: value by value
    (0, 100, 2, 4),       # 200-byte rows
    (0, 6, 4, 4),         # 24-byte float32 rows
    (0, 7, 2, 2),         # 14-byte rows
])
def test_copy_width(ptr, d, size, width):
    assert fa.copy_width(ptr, d, size) == width
