"""The mesh's "model" axis for LM serving, against the JAX package, on
the CPU.

The port drives a (data, model) mesh from one process; a mesh that
lists the CPU several times (``DeviceMesh.on("cpu", data=, model=)``)
is the counterpart of JAX's forced host devices, so every sharded path
runs here. Held:

* (a) ``sharding_rules`` equal to JAX's for every arch id, kind and
  ``long_ctx``, on ``full()`` and ``smoke()``, FSDP detection included;
* (b) the spec trees of the params and of ``input_axes`` equal to JAX's
  ``tree_specs`` leaf by leaf (a JAX ``PartitionSpec`` read as a tuple)
  on stub meshes (1, 1), (2, 2), (4, 2), (8, 1), (1, 16), and the
  resolver's two rules;
* (c) ``moe_apply(mesh=)`` against the JAX ``shard_map`` run in a
  subprocess with 8 forced host devices (both weight modes, meshes
  (4, 2) and (2, 4), capacity factors 1.25 — experts drop — and 8.0):
  ``out`` within 2e-4 and ``aux`` within 1e-5;
* (d) ``build_step`` prefill and decode over (2, 2) and (1, 2) meshes
  within 1e-4 * max|ref| of the port's unsharded path and of the JAX
  ``build_step`` on a (1, 1) mesh, params carried by
  ``convert.lm_params_from_jax``; (e) the same with the embed FSDP-split
  through ``rules_override``;
* (d') the same for the families whose MLA, Mamba, mLSTM / sLSTM and
  cross layers split over "model" (deepseek-v3 also over (1, 4); llama
  with its cross cache filled by ``build_cross_cache`` on the placed
  params), xlstm's decode at 1e-3 (ill-conditioned); the gathered cache
  within 1e-5 of the unsharded one; and no ``ShardedTree.whole`` call
  reaching a mixer, each rank computing with 1/m of every split
  dimension;
* (f) ``DecodeEngine(mesh=)`` greedy tokens equal to the JAX engine's;
* (g) both ``_torch`` examples on the CPU; (h) the errors.

MoE configs over a model axis of m need ``ep == m`` (the JAX shapes fail
otherwise), and the JAX (1, 1) reference needs ``ep == 1``: the granite
cases give the smoke config 4 experts, so that both pad to the same
expert count, and a capacity factor of 8, so that no expert drops and
the two capacities (counted from a row's tokens, or from all) agree.
"""

import dataclasses
import os
import runpy
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.launch import sharding as j_sharding
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.launch.steps import build_step as j_build_step
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.models.params import LogicalAxes as JLogicalAxes
from repro.models.params import Maker as JMaker
from repro.models.params import abstract_params as j_abstract_params
from repro.models.params import param_axes as j_param_axes
from repro.models.params import tree_specs as j_tree_specs
from repro.serving import DecodeEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs, optim
from repro_torch.configs import base
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import sharding
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models import lm, moe
from repro_torch.models.params import (LogicalAxes, ShardedTree,
                                       abstract_params, leaves, param_axes,
                                       resolve_spec, tree_specs)
from repro_torch.serving import DecodeEngine, Request

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = configs.ARCHS
MESHES = [(1, 1), (2, 2), (4, 2), (8, 1), (1, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny shapes: more only add
    start-up overhead (5x at the MoE dispatch's ``index_add``) and contend
    with the other test workers. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub(d, m):
    # resolve_spec reads only mesh.shape.
    return types.SimpleNamespace(shape={"data": d, "model": m})


def _plain(tree):
    """A JAX tree with ``PartitionSpec`` / ``LogicalAxes`` leaves as
    tuples (and the port's ``LogicalAxes`` likewise)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, (JLogicalAxes, LogicalAxes)):
        return tuple(tree.axes)
    return tree


def _close_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


# -- (a) the rule tables -------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_equal_jax(arch, smoke):
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = j_configs.get_config(arch, smoke=smoke)
    rules = sharding.sharding_rules(cfg)          # FSDP detected
    assert rules == j_sharding.sharding_rules(jcfg)
    fsdp = rules["embed"] is not None
    for kind in ("train", "prefill", "decode"):
        for long_ctx in (False, True):
            assert sharding.sharding_rules(
                cfg, kind=kind, long_ctx=long_ctx, fsdp=fsdp) == \
                j_sharding.sharding_rules(jcfg, kind=kind,
                                          long_ctx=long_ctx, fsdp=fsdp)


def test_fsdp_detection_and_kv_rule():
    big = sharding.sharding_rules(configs.get_config("gemma2-27b"))
    small = sharding.sharding_rules(configs.get_config("qwen3-1.7b"))
    assert big["embed"] == ("pod", "data") and small["embed"] is None
    r = sharding.sharding_rules(configs.get_config("qwen3-1.7b"),
                                kind="decode")
    assert r["kv_seq"] == "model"
    r = sharding.sharding_rules(configs.get_config("jamba-v0.1-52b"),
                                kind="decode", long_ctx=True)
    assert r["kv_seq"] == ("data", "model")


# -- (b) spec trees -------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_jax(arch, smoke):
    cfg = configs.get_config(arch, smoke=smoke)
    jcfg = j_configs.get_config(arch, smoke=smoke)
    axes = param_axes(lambda mk: lm.make_lm(mk, cfg))
    jaxes = j_param_axes(lambda mk: j_lm.init_lm(mk, jcfg))
    assert _plain(axes) == _plain(jaxes)
    ab = abstract_params(lambda mk: lm.make_lm(mk, cfg))
    jab = j_abstract_params(lambda mk: j_lm.init_lm(mk, jcfg))
    shapes = (j_configs.SMOKE_SHAPES if smoke else j_configs.SHAPES).values()
    fsdp = sharding.sharding_rules(cfg)["embed"] is not None
    for shape in shapes:
        if not j_base.cell_supported(jcfg, shape)[0]:
            continue
        pshape = ShapeCell(*dataclasses.astuple(shape))
        long_ctx = shape.name == "long_500k"
        rules = sharding.sharding_rules(cfg, kind=shape.kind,
                                        long_ctx=long_ctx, fsdp=fsdp)
        in_axes = base.input_axes(cfg, pshape)
        j_in_axes = j_base.input_axes(jcfg, shape)
        assert _plain(in_axes) == _plain(j_in_axes)
        in_ab = base.input_specs(cfg, pshape)
        j_in_ab = j_base.input_specs(jcfg, shape)
        for d, m in MESHES:
            mesh = _stub(d, m)
            assert _plain(tree_specs(axes, ab, rules, mesh)) == \
                _plain(j_tree_specs(jaxes, jab, rules, mesh)), (d, m)
            assert _plain(sharding.batch_specs(mesh, rules, in_axes,
                                               in_ab)) == \
                _plain(j_sharding.batch_specs(jcfg, mesh, rules, j_in_axes,
                                              j_in_ab)), (shape.name, d, m)


def test_resolver_drops_nondivisible_and_never_reuses_an_axis():
    mesh = _stub(2, 2)
    assert resolve_spec(LogicalAxes(("heads",)), (15,), {"heads": "model"},
                        mesh) == (None,)
    assert resolve_spec(LogicalAxes(("heads",)), (16,), {"heads": "model"},
                        mesh) == ("model",)
    assert resolve_spec(LogicalAxes(("embed", "mlp")), (8, 8),
                        {"embed": "model", "mlp": "model"}, mesh) == \
        ("model", None)


def test_sharded_tree_places_gathers_and_splits_fsdp():
    mesh = DeviceMesh.on("cpu", data=2, model=2)
    t = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    st = ShardedTree.place({"a": t, "b": [t[0]]},
                           {"a": ("data", "model", None), "b": [(None, None)]},
                           mesh)
    assert torch.equal(st.shards[1][1]["a"], t[2:, 4:])
    assert st.shards[1][1]["b"][0].data_ptr() == t.data_ptr()  # a view
    assert torch.equal(st.local(0, 1)["a"], t[:, 4:])   # "data" gathered
    assert torch.equal(st.whole(1)["a"], t)
    joint = ShardedTree.place({"a": t}, {"a": (None, ("data", "model"),
                                               None)}, mesh)
    assert torch.equal(joint.shards[1][0]["a"], t[:, 4:6])
    assert torch.equal(joint.whole(0)["a"], t)
    assert torch.equal(joint.local(1, 0)["a"], t)


# -- (c) expert parallelism against the JAX shard_map --------------------------

MOE_CASES = [(mode, mesh, cf) for mode in ("fsdp", "tp_f")
             for mesh in ((4, 2), (2, 4)) for cf in (1.25, 8.0)]


def _moe_cfg(mode, m, cf):
    return dict(d_model=16, d_ff=32, n_experts=8, top_k=2, n_shared=1,
                router="softmax" if mode == "fsdp" else "sigmoid",
                capacity_factor=cf, ep=m, weight_mode=mode)


@pytest.fixture(scope="module")
def jax_sharded_moe(tmp_path_factory):
    """Every MOE_CASES run of the JAX ``moe_apply(mesh=)`` in one
    subprocess with 8 forced host devices; inputs and outputs through
    npz files."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 16)).astype(np.float32)
    params = {}
    for mode in ("fsdp", "tp_f"):
        jcfg = j_moe.MoeConfig(**_moe_cfg(mode, 2, 1.0))
        shapes = j_moe.init_moe(JMaker("shapes"), jcfg)
        params[mode] = jax.tree.map(
            lambda s: (rng.normal(size=s) * 0.3).astype(np.float32), shapes,
            is_leaf=lambda v: isinstance(v, tuple))
        params[mode]["router"] *= np.float32(8.0)   # skewed: experts drop
    path = tmp_path_factory.mktemp("moe")
    flat = {"x": x}
    for mode, p in params.items():
        for name, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            flat[f"{mode}|{jax.tree_util.keystr(name)}"] = leaf
    np.savez(path / "in.npz", **flat)
    script = textwrap.dedent(f"""
        import json, numpy as np, jax, jax.numpy as jnp
        from repro.launch.mesh import make_host_mesh
        from repro.models.moe import MoeConfig, moe_apply
        cases = {MOE_CASES!r}
        inp = np.load(r"{path / 'in.npz'}")
        out = {{}}
        def tree(mode):
            p = {{}}
            for key in inp.files:
                if key.startswith(mode + "|"):
                    names = key.split("|", 1)[1][2:-2].split("']['")
                    node = p
                    for n in names[:-1]:
                        node = node.setdefault(n, {{}})
                    node[names[-1]] = jnp.asarray(inp[key])
            return p
        for mode, (d, m), cf in cases:
            cfg = MoeConfig(**{{**{_moe_cfg('MODE', 0, 0)!r},
                               "router": "softmax" if mode == "fsdp"
                               else "sigmoid", "capacity_factor": cf,
                               "ep": m, "weight_mode": mode}})
            mesh = make_host_mesh(d, m)
            y, aux = jax.jit(lambda p, x: moe_apply(p, cfg, x, mesh=mesh))(
                tree(mode), jnp.asarray(inp["x"]))
            out[f"{{mode}}-{{d}}x{{m}}-{{cf}}-y"] = np.asarray(y)
            out[f"{{mode}}-{{d}}x{{m}}-{{cf}}-aux"] = np.asarray(aux)
        np.savez(r"{path / 'out.npz'}", **out)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return x, params, dict(np.load(path / "out.npz"))


@pytest.mark.parametrize("mode,dm,cf", MOE_CASES)
def test_moe_mesh_equals_jax_shard_map(jax_sharded_moe, mode, dm, cf):
    x, params, out = jax_sharded_moe
    d, m = dm
    cfg = moe.MoeConfig(**_moe_cfg(mode, m, cf))
    tp = lm_params_from_jax(params[mode], device="cpu")
    mesh = DeviceMesh.on("cpu", data=d, model=m)
    got, aux = moe.moe_apply(tp, cfg, torch.as_tensor(x), mesh=mesh)
    key = f"{mode}-{d}x{m}-{cf}"
    np.testing.assert_allclose(got.numpy(), out[key + "-y"], rtol=2e-4,
                               atol=2e-4)
    assert abs(float(aux) - float(out[key + "-aux"])) <= 1e-5
    local, _ = moe.moe_apply(tp, cfg, torch.as_tensor(x))
    gap = float((local - got).abs().max())
    if mode == "fsdp" and cf == 1.25:
        # Capacity counted from a row's tokens: other drops than one
        # device's, which counts it from all of them.
        assert gap > 1e-2
    else:
        assert gap <= 2e-4 * float(got.abs().max())


# -- (d, e) build_step over the mesh ---------------------------------------------

def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s) * 0.1).astype(np.float32), shapes,
        is_leaf=lambda v: isinstance(v, tuple))


def _lm_case(arch, m, seed):
    """(jax cfg, port cfg over model size m, numpy params, port params)."""
    jcfg = j_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    if cfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=4, capacity_factor=8.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=4, capacity_factor=8.0, ep=m))
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), seed)
    return jcfg, cfg, jp, lm_params_from_jax(jp, device="cpu")


def _tokens(rng, cfg, *lead):
    shape = lead + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    return rng.integers(0, cfg.vocab, size=shape).astype(np.int32)


B, S, MAX_LEN, STEPS = 4, 9, 16, 4


def _jax_reference(jcfg, jp, toks, steps, cross=None):
    """The JAX build_step on a (1, 1) mesh: prefill logits, and the
    logits of ``steps`` decode steps from a zero cache (its cross layers'
    K/V filled from ``cross``, the image states, for a cross model)."""
    mesh = j_make_host_mesh(1, 1)
    pre = j_build_step(jcfg, j_base.ShapeCell("p", "prefill", S, B), mesh,
                       param_dtype=jnp.float32)
    dec = j_build_step(jcfg, j_base.ShapeCell("d", "decode", MAX_LEN, B),
                       mesh, param_dtype=jnp.float32, donate=False)
    batch = {"tokens": jnp.asarray(toks)}
    if cross is not None:
        batch["cross_states"] = jnp.asarray(cross)
    with mesh:
        want_p = np.asarray(pre.fn(jp, batch))
        cache = j_lm.init_cache(None, jcfg, B, MAX_LEN, jnp.float32)
        if cross is not None:
            cache = j_lm.build_cross_cache(jp, jcfg, cache,
                                           jnp.asarray(cross))
        pos = jnp.asarray([0, 3, 1, 2], jnp.int32)
        want_d = []
        for t in range(steps):
            logits, cache = dec.fn(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                                   pos)
            want_d.append(np.asarray(logits))
            pos = pos + 1
    return want_p, want_d


def _port_run(cfg, tp, toks, mesh, rules=None, placed_cache=True,
              cross=None, cache_scaled=False):
    """The port's build_step over ``mesh`` and its unsharded path, same
    inputs -> (sharded, unsharded) prefill logits and decode logits; a
    cross model reads the image states ``cross`` (the placed cache's
    cross K/V filled by ``build_cross_cache`` from the placed params).
    The gathered cache is held within 1e-5 of the unsharded one; with
    ``cache_scaled`` within 1e-4 of each leaf's largest value."""
    pre = build_step(cfg, ShapeCell("p", "prefill", S, B), mesh,
                     param_dtype=torch.float32, rules_override=rules)
    dec = build_step(cfg, ShapeCell("d", "decode", MAX_LEN, B), mesh,
                     param_dtype=torch.float32, rules_override=rules)
    placed = ShardedTree.place(tp, pre.param_shardings, mesh)
    t = torch.as_tensor(toks)
    batch = {"tokens": t}
    if cross is not None:
        batch["cross_states"] = torch.as_tensor(cross)
    got_p = pre.fn(placed, batch)
    ref_p = lm.lm_prefill(tp, cfg, batch)
    cache = lm.init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                          device="cpu", mesh=mesh) if placed_cache else \
        lm.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    ref_cache = lm.init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                              device="cpu")
    if cross is not None:
        cache = lm.build_cross_cache(placed, cfg, cache,
                                     batch["cross_states"])
        ref_cache = lm.build_cross_cache(tp, cfg, ref_cache,
                                         batch["cross_states"])
    pos = torch.tensor([0, 3, 1, 2])
    got_d, ref_d = [], []
    for s in range(STEPS):
        logits, cache = dec.fn(placed, cache, t[:, s:s + 1], pos)
        got_d.append(logits)
        logits, ref_cache = lm.lm_decode_step(tp, cfg, ref_cache,
                                              t[:, s:s + 1], pos)
        ref_d.append(logits)
        pos = pos + 1
    for a, b in zip(leaves(cache.gather()), leaves(ref_cache)):
        atol = 1e-4 * float(b.abs().max()) if cache_scaled else 1e-5
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)
    return (got_p, got_d), (ref_p, ref_d)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b",
                                  "granite-moe-3b-a800m"])
def test_build_step_over_the_mesh_matches(arch):
    rng = np.random.default_rng(5)
    jcfg, _, jp, _ = _lm_case(arch, 1, seed=ARCHS.index(arch))
    toks = _tokens(rng, jcfg, B, S)
    want_p, want_d = _jax_reference(jcfg, jp, toks, STEPS)
    for d, m in [(2, 2), (1, 2)]:
        _, cfg, _, tp = _lm_case(arch, m, seed=ARCHS.index(arch))
        (got_p, got_d), (ref_p, ref_d) = _port_run(
            cfg, tp, toks, DeviceMesh.on("cpu", data=d, model=m))
        _close_rel(got_p, ref_p, 1e-4)
        _close_rel(got_p, want_p, 1e-4)
        for g, r, w in zip(got_d, ref_d, want_d):
            _close_rel(g, r, 1e-4)
            _close_rel(g, w, 1e-4)


# The families whose mixers split over "model" besides self-attention
# (MLA; Mamba; mLSTM and sLSTM; cross-attention), with their meshes:
# deepseek's smoke config has 4 heads, so (1, 4) splits them too. xlstm's
# 2 heads stay whole over (1, 4) while its up / w_if / down / w split:
# rank 0 computes every head from the other ranks' column blocks and row
# partials. Over (2, 1) jamba's leaves are held whole by its one rank.
SPLIT_FAMILIES = {"deepseek-v3-671b": [(2, 2), (1, 2), (1, 4)],
                  "jamba-v0.1-52b": [(2, 2), (1, 2), (2, 1)],
                  "xlstm-1.3b": [(2, 2), (1, 2), (1, 4)],
                  "llama-3.2-vision-11b": [(2, 2), (1, 2)]}
# xlstm's decode is ill-conditioned: float32 sums in another order move
# its logits by more than 1e-5 of max|logits|
# (test_torch_recurrent.py::test_xlstm_smoke_decode_is_ill_conditioned),
# so its decode is held at 1e-3, as that file holds it; all else at 1e-4.
# The same reordering (the split w_if's, down's and norm's partial sums)
# moves its recurrent states, which reach ~3.5 here, by up to ~1e-5 of
# each leaf's largest value in 4 steps: its caches are held at 1e-4 of
# each leaf's largest value, every other family's at 1e-5.
DECODE_RTOL = {"xlstm-1.3b": 1e-3}
CACHE_SCALED = {"xlstm-1.3b"}


def _states(rng, cfg):
    return rng.normal(size=(B, cfg.n_cross_tokens, cfg.d_cross)).astype(
        np.float32) if cfg.d_cross else None


@pytest.mark.parametrize("arch", list(SPLIT_FAMILIES))
def test_split_mixers_over_the_mesh_match_jax(arch):
    """MLA, Mamba, mLSTM, sLSTM and cross-attention split over "model" in
    ``build_step`` prefill and decode: within 1e-4 * max|ref| of the
    port's unsharded path and of JAX's (1, 1) ``build_step`` (xlstm's
    decode 1e-3, ``DECODE_RTOL``); the gathered ``ShardedCache`` (MLA's
    latent copied per rank, Mamba's state by channel, the xLSTM states by
    head, cross K/V by kv head) within 1e-5 of the unsharded cache
    (xlstm's within 1e-4 of each leaf's largest value, ``CACHE_SCALED``)."""
    rng = np.random.default_rng(9)
    seed = ARCHS.index(arch)
    jcfg, _, jp, _ = _lm_case(arch, 1, seed=seed)
    toks = _tokens(rng, jcfg, B, S)
    cross = _states(rng, jcfg)
    want_p, want_d = _jax_reference(jcfg, jp, toks, STEPS, cross)
    rtol = DECODE_RTOL.get(arch, 1e-4)
    for d, m in SPLIT_FAMILIES[arch]:
        _, cfg, _, tp = _lm_case(arch, m, seed=seed)
        (got_p, got_d), (ref_p, ref_d) = _port_run(
            cfg, tp, toks, DeviceMesh.on("cpu", data=d, model=m),
            cross=cross, cache_scaled=arch in CACHE_SCALED)
        _close_rel(got_p, ref_p, 1e-4)
        _close_rel(got_p, want_p, 1e-4)
        for g, r, w in zip(got_d, ref_d, want_d):
            _close_rel(g, r, rtol)
            _close_rel(g, w, rtol)


def _blocks(layers):
    """The blocks of a layer tree: the prefix list's, then the stacked
    pattern blocks (each with a layer dimension first)."""
    return [(b, 0) for b in layers.get("prefix", [])] + \
        [(b, 1) for b in layers.get("stack", {}).values()]


def _mixer_leaf_shapes(tp):
    """Every mixer leaf's shape without the layer dimension, by (the
    mixer's leaf names, the leaf's name)."""
    blocks = _blocks(tp["layers"])
    if "mtp" in tp:
        blocks.append((tp["mtp"]["block"], 0))
    out = {}
    for b, lead in blocks:
        for key in ("attn", "mix"):
            for name, t in b.get(key, {}).items():
                if isinstance(t, torch.Tensor):
                    out[frozenset(b[key]), name] = tuple(t.shape[lead:])
    return out


def test_split_mixers_are_never_gathered_whole(monkeypatch):
    """Over (2, 2), through prefill, decode and a train step of each split
    family: no ``ShardedTree.whole`` call reaches an "attn" or "mix"
    subtree (a block's mixer, or a tree holding one), every mixer runs
    its split form (``_rank_list``), and each rank computes with leaves
    that hold 1/m of every dimension their spec splits over "model"."""
    from repro_torch.models import transformer

    mixer_keys = set()
    for arch in SPLIT_FAMILIES:
        cfg = configs.get_config(arch, smoke=True)
        axes = param_axes(lambda mk: lm.make_lm(mk, cfg))
        mixer_keys |= {frozenset(b[k]) for b, _ in _blocks(axes["layers"])
                       for k in ("attn", "mix") if k in b}
    wholes, ranked = [], []
    orig_whole, orig_ranks = ShardedTree.whole, transformer._rank_list

    def whole(self, *a, **k):
        wholes.append(self.specs)
        return orig_whole(self, *a, **k)

    def rank_list(p, i):
        out = orig_ranks(p, i)
        if frozenset(p.specs) in mixer_keys:        # not a dense MLP's
            ranked.append((p.specs, [q for q, _ in out]))
        return out

    monkeypatch.setattr(ShardedTree, "whole", whole)
    monkeypatch.setattr(transformer, "_rank_list", rank_list)
    mesh = DeviceMesh.on("cpu", data=2, model=2)
    rng = np.random.default_rng(3)
    for arch in SPLIT_FAMILIES:
        _, cfg, _, tp = _lm_case(arch, 2, seed=ARCHS.index(arch))
        shapes = _mixer_leaf_shapes(tp)
        batch = {"tokens": torch.as_tensor(_tokens(rng, cfg, B, S + 1))}
        cross = _states(rng, cfg)
        if cross is not None:
            batch["cross_states"] = torch.as_tensor(cross)
        wholes.clear()
        ranked.clear()
        _port_run(cfg, tp, batch["tokens"][:, :S].numpy(), mesh,
                  cross=cross, cache_scaled=arch in CACHE_SCALED)
        b = build_step(cfg, ShapeCell("t", "train", S, B), mesh,
                       param_dtype=torch.float32)
        placed = ShardedTree.place(tp, b.param_shardings, mesh)
        b.fn(placed, optim.init_opt_state(placed, optim.AdamWConfig()),
             batch)
        for specs in wholes:
            if isinstance(specs, dict):
                assert "attn" not in specs and "mix" not in specs, arch
                assert frozenset(specs) not in mixer_keys, (arch, specs)
        kinds = {frozenset(specs) for specs, _ in ranked}
        want = {frozenset(b[k]) for b, _ in _blocks(tp["layers"])
                for k in ("attn", "mix") if k in b}
        assert want <= kinds, arch            # every mixer kind split
        split = 0
        for specs, trees in ranked:
            for r, q in enumerate(trees):
                for name, spec in specs.items():
                    if not isinstance(spec, tuple) or "model" not in spec:
                        continue
                    t = q[name]
                    full = shapes[frozenset(specs), name]
                    for k, e in enumerate(spec):
                        if e == "model":
                            assert 2 * t.shape[k] == full[k], (arch, name)
                            split += 1
        assert split > 0, arch


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium",
                                  "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "llama-3.2-vision-11b"])
def test_build_step_over_the_mesh_matches_the_unsharded_port(arch):
    """The other families over (2, 2): MLA, Mamba, xLSTM and cross layers
    split over the model ranks (``test_split_mixers_over_the_mesh_match_
    jax`` holds them to JAX), smollm's 3 heads stay whole, musicgen's 4
    codebooks go through the vocab-parallel embed and logits; within
    1e-4 * max|ref| of the port's unsharded path, the cross cache filled
    from whole params and placed on the first step."""
    rng = np.random.default_rng(7)
    _, cfg, _, tp = _lm_case(arch, 2, seed=ARCHS.index(arch))
    toks = _tokens(rng, cfg, B, S)
    cross = None
    if cfg.d_cross:
        cross = torch.as_tensor(rng.normal(size=(
            B, cfg.n_cross_tokens, cfg.d_cross)).astype(np.float32))
    mesh = DeviceMesh.on("cpu", data=2, model=2)
    batch = {"tokens": torch.as_tensor(toks)}
    if cross is not None:
        batch["cross_states"] = cross
    pre = build_step(cfg, ShapeCell("p", "prefill", S, B), mesh,
                     param_dtype=torch.float32)
    _close_rel(pre.fn(tp, batch), lm.lm_prefill(tp, cfg, batch), 1e-4)
    dec = build_step(cfg, ShapeCell("d", "decode", MAX_LEN, B), mesh,
                     param_dtype=torch.float32)
    cache = lm.init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                          device="cpu")
    ref = lm.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    if cross is not None:
        cache = lm.build_cross_cache(tp, cfg, cache, cross)
        ref = lm.build_cross_cache(tp, cfg, ref, cross)
    pos = torch.tensor([0, 3, 1, 2])
    t = torch.as_tensor(toks)
    for s in range(2):
        got, cache = dec.fn(tp, cache, t[:, s:s + 1], pos)
        want, ref = lm.lm_decode_step(tp, cfg, ref, t[:, s:s + 1], pos)
        _close_rel(got, want, 1e-4)
        pos = pos + 1
    for a, b in zip(leaves(cache.gather()), leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_build_step_with_the_embed_fsdp_split():
    arch = "qwen3-1.7b"
    rng = np.random.default_rng(6)
    jcfg, cfg, jp, tp = _lm_case(arch, 2, seed=11)
    toks = _tokens(rng, jcfg, B, S)
    want_p, want_d = _jax_reference(jcfg, jp, toks, STEPS)
    for kind in ("prefill", "decode"):
        rules = sharding.sharding_rules(cfg, kind=kind, fsdp=True)
        specs, _ = sharding.param_tree_specs(cfg, DeviceMesh.on(
            "cpu", data=2, model=2), rules)
        assert specs["embed"] == (None, "model", "data")
        assert specs["layers"]["stack"]["b0"]["mlp"]["w_up"] == \
            (None, "data", "model")
    rules = sharding.sharding_rules(cfg, fsdp=True)
    (got_p, got_d), (ref_p, ref_d) = _port_run(
        cfg, tp, toks, DeviceMesh.on("cpu", data=2, model=2), rules=rules,
        placed_cache=False)
    _close_rel(got_p, ref_p, 1e-4)
    _close_rel(got_p, want_p, 1e-4)
    for g, r, w in zip(got_d, ref_d, want_d):
        _close_rel(g, r, 1e-4)
        _close_rel(g, w, 1e-4)


def test_build_step_kinds_and_abstract_args():
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    mesh = DeviceMesh.on("cpu", data=2, model=2)
    b = build_step(cfg, ShapeCell("d", "decode", MAX_LEN, B), mesh)
    assert b.rules == sharding.sharding_rules(cfg, kind="decode")
    assert b.param_shardings["embed"] == (None, "model", None)
    params = lm.init_lm(cfg, 0, device="cpu")
    cache = lm.init_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                          device="cpu", mesh=mesh)
    kept = build_step(cfg, ShapeCell("d", "decode", MAX_LEN, B), mesh,
                      donate=False)
    tok, pos = torch.zeros((B, 1), dtype=torch.int32), torch.zeros(B)
    _, new = kept.fn(params, cache, tok, pos.long())
    assert new is not cache
    assert all(float(t.abs().max()) == 0 for t in leaves(cache.gather()))
    _, same = b.fn(params, cache, tok, pos.long())
    assert same is cache                            # donated: in place
    assert any(float(t.abs().max()) > 0 for t in leaves(cache.gather()))
    train_b = build_step(cfg, ShapeCell("t", "train", 8, 2), mesh)
    assert train_b.opt_shardings == {"step": (),
                                     "m": train_b.param_shardings,
                                     "v": train_b.param_shardings}
    one = build_step(cfg, ShapeCell("t", "train", 8, 2),
                     DeviceMesh.on("cpu"))
    assert callable(one.fn) and one.param_shardings is not None


# -- (f) DecodeEngine(mesh=) -----------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_decode_engine_on_a_mesh_gives_jax_greedy_tokens(arch):
    jcfg = j_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep=2))
    if cfg.moe.n_experts % 2:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=4))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=4))
    jp = _numpy_params(j_lm.init_lm(JMaker("shapes"), jcfg), 40)
    tp = lm_params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(41)
    prompts = [_tokens(rng, cfg, n).tolist() for n in (3, 1, 5, 2, 4)]
    jeng = JEngine(jp, jcfg, batch=2, max_len=12,
                   mesh=j_make_host_mesh(1, 1))
    eng = DecodeEngine(tp, cfg, batch=2, max_len=12, device="cpu",
                       mesh=DeviceMesh.on("cpu", data=2, model=2))
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=4 + rid % 3))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4 + rid % 3))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert got == want and len(got) == 5


# -- (g) examples, (h) errors ---------------------------------------------------

@pytest.mark.parametrize("example,argv", [
    ("quickstart_torch.py", ["--device", "cpu"]),
    ("serve_lm_torch.py", ["--arch", "granite-moe-3b-a800m", "--requests",
                           "3", "--device", "cpu"])])
def test_examples_run_on_the_cpu(example, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [example] + argv)
    runpy.run_path(os.path.join(_ROOT, "examples", example),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert ("network DRAM" in out) if example.startswith("quick") \
        else ("3 requests" in out)


def test_mesh_errors():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 2:
        with pytest.raises(ValueError, match="DeviceMesh.on"):
            make_host_mesh(1, 2)
    mesh = DeviceMesh.on("cpu", data=2, model=2)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.device(1, 1) == torch.device("cpu")
    assert DeviceMesh.on("cpu", data=2) == DeviceMesh.on("cpu", 2, 1)
    cfg = configs.get_config("granite-moe-3b-a800m", smoke=True)   # ep 1
    params = lm.init_lm(cfg, 0, device="cpu")
    eng = DecodeEngine(params, cfg, batch=2, max_len=8, device="cpu",
                       mesh=mesh)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    with pytest.raises(ValueError, match="ep"):
        eng.run()
    p_moe = params["layers"]["stack"]["b0"]["moe"]
    with pytest.raises(ValueError, match="ep"):
        moe.moe_apply({k: v[0] for k, v in p_moe.items()}, cfg.moe,
                      torch.zeros((2, 1, cfg.d_model)), mesh=mesh)


def test_decode_engine_rejects_a_mesh_off_its_device():
    cpu, meta = torch.device("cpu"), torch.device("meta")
    flat = DeviceMesh((cpu, cpu))                  # one rank a data row
    assert flat.shape == {"data": 2, "model": 1}
    assert flat.devices == (cpu, cpu) and flat == DeviceMesh.on(cpu, 2)
    grid = DeviceMesh(((cpu, meta), (cpu, cpu)))
    assert grid.devices == (cpu, cpu) and grid.device(0, 1) == meta
    with pytest.raises(ValueError, match="equal length"):
        DeviceMesh(((cpu, cpu), (cpu,)))
    cfg = configs.get_config("granite-moe-3b-a800m", smoke=True)
    params = lm.init_lm(cfg, 0, device="cpu")
    for mesh in (grid, DeviceMesh.on(meta)):
        with pytest.raises(ValueError, match="rank \\(0, 0\\)"):
            DecodeEngine(params, cfg, batch=2, max_len=8, device="cpu",
                         mesh=mesh)
