"""LM training over the (data, model) mesh, against the JAX package, on
the CPU.

``build_step(kind="train")`` over ``DeviceMesh.on("cpu", data=, model=)``
(the counterpart of JAX's forced host devices) against the JAX
``build_step`` and the port's unsharded step, from the same numpy
parameters (``convert.lm_params_from_jax``) and tokens. Held:

* (a) qwen3 smoke over (4, 2) and (2, 2) against the JAX step on a (1, 1)
  mesh: the loss within 1e-4 (``tests/test_distributed.py``'s bound),
  every gradient leaf (taken before the update) within 1e-4 * max|ref|,
  ``grad_norm`` within 1e-4 relative, and the params after 3 steps within
  ``2 * lr * steps`` (Adam moves a weight by about lr a step whatever its
  gradient's size, so a gradient at rounding level may flip a step's sign);
* (b) the same for qwen3 under ``sharding_rules(fsdp=True)``, and for
  granite-moe smoke over (2, 2) (4 experts, ``ep`` 2, capacity factor 8:
  nothing drops). The MoE load-balancing term of a mesh is the mean of
  the data rows' terms (the JAX ``pmean``), not the term of the whole
  batch, so granite's whole loss is held against the JAX step on a
  (2, 2) mesh (a subprocess with 8 forced host devices), its ``ce`` and
  its gradients without the term (``aux_weight=0``) against the JAX
  (1, 1) step and the port's unsharded one; every expert slice's
  gradient equals the unsharded one's block within 1e-4 * max|ref|;
  deepseek-v3 smoke (MTP, MLA; ``aux_weight=0``), musicgen smoke (4
  codebooks), llama-3.2-vision smoke (``cross_states`` split into rows),
  jamba smoke (``aux_weight=0``) and xlstm smoke over (2, 2) against the
  port's unsharded gradient and ``build_train_step`` (loss and terms
  within 1e-4, gradients within 1e-4 * max|ref|); deepseek, jamba,
  xlstm and llama, whose MLA, Mamba, mLSTM / sLSTM and cross layers
  split over "model", over (2, 2) against JAX's (1, 1) gradient of the
  same loss (xlstm's gradients, ill-conditioned, at 1e-3: ``GRAD_RTOL``);
* (c) after a step on (2, 2) every held slice still views the placed
  tree's storage and the gathered params equal the unsharded step's
  (within the Adam bound above); the placed AdamW update of a gradient
  equals the whole tree's update of that gradient gathered, within 1e-6
  (params, m and v: an update applied once more through an aliased slice
  would move a weight by about lr = 1e-2 again);
* (d) the three remat policies give the same gradients over (2, 2), bit
  for bit;
* (e) the 8 -> 4 resume of ``tests/test_distributed.py``: smollm smoke, 2
  steps on (8, 1), ``save``, ``restore`` placed on (4, 1), one more step;
  the 3 losses within 1e-4 of JAX's unsharded 3-step run; and
  ``train_loop`` over a mesh resumed from its checkpoint;
* (f) ``compressed_psum_tree`` over 8 rows against the JAX function
  under ``shard_map``: decoded mean and new errors within 1e-6, the mean
  within 0.05 of the exact one;
* (g) ``python -m repro_torch.launch.train --device cpu --data-parallel 2
  --model-parallel 2`` runs; ``make_host_mesh(2, 2)`` without four cards
  raises.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro import optim as j_optim
from repro.configs import base as j_base
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.launch.steps import build_step as j_build_step
from repro.models import lm as j_lm
from repro.models.params import Maker as JMaker
from repro_torch import checkpoint as ckpt
from repro_torch import configs, optim
from repro_torch._tree import flatten_with_names, tree_leaves, tree_map, \
    value_and_grad
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import sharding, train
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
from repro_torch.launch.steps import (build_step, build_train_step,
                                      value_and_grad_placed)
from repro_torch.models import lm
from repro_torch.models.params import (ShardedTree, _block, _narrow,
                                       map_tree)
from repro_torch.optim import compressed_psum_tree

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS, LR = 8, 12, 3, 1e-2
OPT = dict(lr=LR, warmup_steps=1, total_steps=STEPS)
GRANITE = "granite-moe-3b-a800m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny shapes (more only contend with
    the other test workers); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(arch, m=1, **replace):
    """(jax cfg, port cfg over model size m, numpy params, port params);
    a MoE config gets 4 experts and capacity factor 8 (nothing drops)."""
    jcfg = dataclasses.replace(j_configs.get_config(arch, smoke=True),
                               **replace)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **replace)
    if cfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=4, capacity_factor=8.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=4, capacity_factor=8.0, ep=m))
    rng = np.random.default_rng(configs.ARCHS.index(arch))
    jp = jax.tree.map(
        lambda s: (rng.normal(size=s) * 0.1).astype(np.float32),
        j_lm.init_lm(JMaker("shapes"), jcfg),
        is_leaf=lambda v: isinstance(v, tuple))
    return jcfg, cfg, jp, lm_params_from_jax(jp, device="cpu")


def _batches(cfg, n=STEPS, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(b, S + 1)).astype(np.int32)
            for _ in range(n)]


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_run(jcfg, jp, toks):
    """The JAX step on a (1, 1) mesh: step-0 gradients, then ``STEPS``
    steps -> (grads, [metrics], params)."""
    mesh = j_make_host_mesh(1, 1)
    ocfg = j_optim.AdamWConfig(**OPT)
    b = j_build_step(jcfg, j_base.ShapeCell("t", "train", S, B), mesh,
                     opt_cfg=ocfg, param_dtype=jnp.float32, donate=False)
    with mesh:
        _, grads = jax.jit(jax.value_and_grad(
            lambda p, t: j_lm.lm_loss(p, jcfg, {"tokens": t}),
            has_aux=True))(jp, jnp.asarray(toks[0]))
        p, o, metrics = jp, j_optim.init_opt_state(jp, ocfg), []
        for t in toks:
            p, o, m = b.fn(p, o, {"tokens": jnp.asarray(t)})
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.leaves(grads), metrics, jax.tree.leaves(p)


def _port_run(cfg, tp, toks, mesh, rules=None):
    """The port's step over ``mesh`` from a copy of ``tp`` -> (step-0
    gradient bundle (placed), [metrics], whole params after the steps,
    the placed params)."""
    b = build_step(cfg, ShapeCell("t", "train", S, B), mesh,
                   opt_cfg=optim.AdamWConfig(**OPT),
                   param_dtype=torch.float32, rules_override=rules)
    params = ShardedTree.place(tree_map(torch.clone, tp),
                               b.param_shardings, mesh)
    _, grads = value_and_grad_placed(
        lambda p: lm.lm_loss(p, cfg, {"tokens": torch.as_tensor(toks[0])},
                             {"mesh": mesh}), params)
    opt = optim.init_opt_state(params, optim.AdamWConfig(**OPT))
    metrics = []
    for t in toks:
        params, opt, m = b.fn(params, opt, {"tokens": t})
        metrics.append({k: float(v) for k, v in m.items()})
    assert isinstance(params, ShardedTree)
    assert int(opt["step"]) == len(toks)
    return grads, metrics, params.whole(0), params


def _hold(got, want, names=None):
    """Port (grads, metrics, params) against a reference's."""
    g, m, p = got
    wg, wm, wp = want
    g = tree_leaves(g.whole(0)) if isinstance(g, ShardedTree) else g
    p = tree_leaves(p) if isinstance(p, dict) else p
    assert len(g) == len(wg) and len(p) == len(wp)
    for k, (a, w) in enumerate(zip(g, wg)):
        assert _max_rel(a, w) <= 1e-4, names[k] if names else k
    for s, (a, w) in enumerate(zip(m, wm)):
        assert abs(a["loss"] - w["loss"]) <= 1e-4, (s, a, w)
        assert abs(a["grad_norm"] - w["grad_norm"]) <= \
            1e-4 * abs(w["grad_norm"]), (s, a, w)
    for a, w in zip(p, wp):
        assert np.abs(np.asarray(a) - np.asarray(w)).max() <= \
            2 * LR * STEPS


# -- (a) qwen3 against the JAX step -------------------------------------------

@pytest.fixture(scope="module")
def qwen_case():
    jcfg, cfg, jp, tp = _case("qwen3-1.7b")
    toks = _batches(cfg)
    return cfg, tp, toks, _jax_run(jcfg, jp, toks)


@pytest.mark.parametrize("dm", [(4, 2), (2, 2)])
def test_train_step_over_the_mesh_matches_jax(qwen_case, dm):
    cfg, tp, toks, want = qwen_case
    got = _port_run(cfg, tp, toks, DeviceMesh.on("cpu", *dm))
    names = [n for n, _ in flatten_with_names(tp)]
    _hold(got[:3], want, names)


# -- (b) embed FSDP, and granite's experts ---------------------------------------

def test_train_step_with_the_embed_fsdp_split(qwen_case):
    cfg, tp, toks, want = qwen_case
    mesh = DeviceMesh.on("cpu", 2, 2)
    rules = sharding.sharding_rules(cfg, fsdp=True)
    got = _port_run(cfg, tp, toks, mesh, rules)
    assert got[3].specs["embed"] == (None, "model", "data")
    _hold(got[:3], want)
    step = build_train_step(cfg, optim.AdamWConfig(**OPT))
    p, o = tree_map(torch.clone, tp), optim.init_opt_state(
        tp, optim.AdamWConfig(**OPT))
    for t, gm in zip(toks, got[1]):
        p, o, m = step(p, o, {"tokens": t})
        assert abs(float(m["loss"]) - gm["loss"]) <= 1e-4
    for a, w in zip(tree_leaves(got[2]), tree_leaves(p)):
        assert np.abs(a.numpy() - w.numpy()).max() <= 2 * LR * STEPS


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    """In a subprocess with 8 forced host devices: the JAX step of
    granite smoke on a (2, 2) mesh (step-0 gradients, 3 steps' metrics,
    the params after them) and ``compressed_psum_tree`` over 8 data rows
    under ``shard_map``. Inputs and outputs through npz files."""
    _, _, jp, _ = _case(GRANITE, 2)
    rng = np.random.default_rng(17)
    toks = _batches(configs.get_config(GRANITE, smoke=True), seed=3)
    g8 = rng.normal(size=(8, 64)).astype(np.float32)
    path = tmp_path_factory.mktemp("jax_mesh")
    np.savez(path / "in.npz", g8=g8, toks=np.stack(toks),
             **{f"p{i}": a for i, a in enumerate(jax.tree.leaves(jp))})
    script = textwrap.dedent(f"""
        import dataclasses, numpy as np, jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro import configs
        from repro.compat import shard_map
        from repro.configs.base import ShapeCell
        from repro.launch.mesh import make_host_mesh
        from repro.launch.steps import build_step
        from repro.models import lm
        from repro.models.params import Maker
        from repro.optim import (AdamWConfig, compressed_psum_tree,
                                 init_opt_state)
        inp = np.load(r"{path / 'in.npz'}")
        out = {{}}
        cfg = configs.get_config("{GRANITE}", smoke=True)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=4, capacity_factor=8.0, ep=2))
        shapes = lm.init_lm(Maker("shapes"), cfg)
        n = len(jax.tree.leaves(shapes, is_leaf=lambda v: isinstance(
            v, tuple)))
        treedef = jax.tree.structure(shapes, is_leaf=lambda v: isinstance(
            v, tuple))
        params = treedef.unflatten([jnp.asarray(inp[f"p{{i}}"])
                                    for i in range(n)])
        mesh = make_host_mesh(2, 2)
        opt = AdamWConfig(**{OPT!r})
        b = build_step(cfg, ShapeCell("t", "train", {S}, {B}), mesh,
                       opt_cfg=opt, param_dtype=jnp.float32, donate=False)
        ctx = {{"mesh": mesh, "act_pspec": P("data", None, None)}}
        toks = inp["toks"]
        with mesh:
            (_, m0), g = jax.jit(jax.value_and_grad(
                lambda p, t: lm.lm_loss(p, cfg, {{"tokens": t}}, ctx),
                has_aux=True))(params, jnp.asarray(toks[0]))
            p, o = params, init_opt_state(params, opt)
            for s in range(len(toks)):
                p, o, m = b.fn(p, o, {{"tokens": jnp.asarray(toks[s])}})
                for k, v in m.items():
                    out[f"m{{s}}_{{k}}"] = np.asarray(v)
        for i, a in enumerate(jax.tree.leaves(g)):
            out[f"g{{i}}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(p)):
            out[f"q{{i}}"] = np.asarray(a)

        def body(x):
            summed, err = compressed_psum_tree(
                {{"w": x[0]}}, {{"w": jnp.zeros_like(x[0])}}, ("data",))
            return summed["w"], err["w"][None]
        mesh8 = make_host_mesh(8, 1)
        dec, err = jax.jit(shard_map(body, mesh=mesh8,
                                     in_specs=P("data", None),
                                     out_specs=(P(), P("data", None))))(
            jnp.asarray(inp["g8"]))
        out["decoded"], out["err"] = np.asarray(dec), np.asarray(err)
        np.savez(r"{path / 'out.npz'}", **out)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = dict(np.load(path / "out.npz"))
    n = len(jax.tree.leaves(jp))
    metrics = [{k: float(out[f"m{s}_{k}"]) for k in ("loss", "ce", "aux",
                                                    "grad_norm")}
               for s in range(STEPS)]
    return (toks, g8, ([out[f"g{i}"] for i in range(n)], metrics,
                       [out[f"q{i}"] for i in range(n)]),
            out["decoded"], out["err"])


def test_granite_over_the_mesh_matches_jax_on_the_same_mesh(jax_mesh_runs):
    """The whole loss, the MoE term as each data row's averaged, against
    the JAX step on a (2, 2) mesh."""
    toks, _, want, _, _ = jax_mesh_runs
    _, cfg, _, tp = _case(GRANITE, 2)
    got = _port_run(cfg, tp, toks, DeviceMesh.on("cpu", 2, 2))
    for a, w in zip(got[1], want[1]):
        assert abs(a["aux"] - w["aux"]) <= 1e-5
        assert abs(a["ce"] - w["ce"]) <= 1e-4
    _hold(got[:3], want, [n for n, _ in flatten_with_names(tp)])


def test_granite_without_the_aux_term_matches_jax_and_the_port():
    """Without the MoE term (which a mesh averages over its rows, and
    which reaches every earlier layer's experts through the later
    routers), the (2, 2) step's loss, gradients and updates equal the JAX
    (1, 1) step's, and every expert slice's gradient (FSDP over "data",
    experts over "model": each device its own block, gathered by
    ``ShardedTree.local``, never a cached replica) equals its block of
    the port's unsharded gradient. With the term, ``ce`` equals the
    unsharded ``ce``."""
    jcfg, cfg, jp, tp = _case(GRANITE, 2, aux_weight=0.0)
    toks = _batches(cfg, seed=3)
    mesh = DeviceMesh.on("cpu", 2, 2)
    got = _port_run(cfg, tp, toks, mesh)
    _hold(got[:3], _jax_run(jcfg, jp, toks))
    batch = {"tokens": torch.as_tensor(toks[0])}
    _, ref = value_and_grad(lambda p: lm.lm_loss(p, cfg, batch), tp)
    moe = got[0]["layers"]["stack"]["b0"]["moe"]
    whole = ref["layers"]["stack"]["b0"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        spec = moe.specs[name]
        assert "model" in spec and "data" in spec, (name, spec)
        for i in range(2):
            for r in range(2):
                blk = _block(spec, whole[name].shape, mesh.shape, i, r)
                want = _narrow(whole[name], blk)
                held = moe.shards[i][r][name]
                assert held.shape == want.shape
                assert float((held - want).abs().max()) <= \
                    1e-4 * float(whole[name].abs().max()), (name, i, r)

    _, cfg, _, tp = _case(GRANITE, 2)
    (_, m_ref), _ = value_and_grad(lambda p: lm.lm_loss(p, cfg, batch), tp)
    b = build_step(cfg, ShapeCell("t", "train", S, B), mesh,
                   param_dtype=torch.float32)
    (_, m), _ = value_and_grad_placed(
        lambda p: lm.lm_loss(p, cfg, batch, {"mesh": mesh}),
        ShardedTree.place(tp, b.param_shardings, mesh))
    assert abs(float(m["ce"]) - float(m_ref["ce"])) <= 1e-4


# The MoE families train at aux_weight=0 against a one-device reference:
# a mesh averages the load-balancing term over its rows (the JAX pmean).
MOE_ARCHS = ("deepseek-v3-671b", "jamba-v0.1-52b")
# xlstm's gradients are ill-conditioned: nudging every float32 weight of
# its smoke model by at most one ulp moves the port's own unsharded
# gradient of b_if (every position's gate gradients summed, nearly
# cancelling) by 2.4e-4 of max|ref|, where the split over (2, 2) moves it
# by 1.6e-4; float32 sums in another order move its decode logits the
# same way (test_torch_recurrent.py). So its gradients are held at 1e-3
# of max|ref| over the mesh; all else at 1e-4.
GRAD_RTOL = {"xlstm-1.3b": 1e-3}


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "musicgen-medium",
                                  "llama-3.2-vision-11b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_mtp_codebooks_and_cross_states_train_over_the_mesh(arch):
    """deepseek-v3's MTP block (and MLA), musicgen's 4 codebooks,
    llama-3.2-vision's ``cross_states`` split into rows, jamba's Mamba and
    xlstm's mLSTM / sLSTM layers split over the ranks, over (2, 2): the
    loss and its terms within 1e-4 and every gradient leaf within 1e-4 *
    max|ref| of the port's unsharded gradient, and one ``build_step``
    step's loss, ``grad_norm`` and params against ``build_train_step``'s
    on the same params (``test_split_mixers_train_over_the_mesh_match_jax``
    and each family's own test file hold them to JAX). The MoE term,
    which a mesh averages over its rows, is left out (``aux_weight=0``)
    for deepseek and jamba."""
    replace = {"aux_weight": 0.0} if arch in MOE_ARCHS else {}
    _, cfg, _, tp = _case(arch, 2, **replace)
    rng = np.random.default_rng(5)
    lead = (4, S + 1) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    batch = {"tokens": rng.integers(0, cfg.vocab, size=lead).astype(
        np.int32)}
    if cfg.d_cross:
        batch["cross_states"] = rng.normal(size=(
            4, cfg.n_cross_tokens, cfg.d_cross)).astype(np.float32)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    mesh = DeviceMesh.on("cpu", 2, 2)
    ocfg = optim.AdamWConfig(**OPT)
    b = build_step(cfg, ShapeCell("t", "train", S, 4), mesh, opt_cfg=ocfg,
                   param_dtype=torch.float32)
    placed = ShardedTree.place(tree_map(torch.clone, tp), b.param_shardings,
                               mesh)
    (_, m), g = value_and_grad_placed(
        lambda p: lm.lm_loss(p, cfg, tb, {"mesh": mesh}), placed)
    (_, m_ref), ref = value_and_grad(lambda p: lm.lm_loss(p, cfg, tb), tp)
    terms = ("ce", "loss") + (("mtp",) if cfg.mtp else ())
    for k in terms:
        assert abs(float(m[k]) - float(m_ref[k])) <= 1e-4, (k, m, m_ref)
    names = [n for n, _ in flatten_with_names(tp)]
    rtol = GRAD_RTOL.get(arch, 1e-4)
    for n, a, w in zip(names, tree_leaves(g.whole(0)), tree_leaves(ref)):
        assert _max_rel(a, w) <= rtol, n

    new, _, sm = b.fn(placed, optim.init_opt_state(placed, ocfg), batch)
    want, _, wm = build_train_step(cfg, ocfg)(
        tree_map(torch.clone, tp), optim.init_opt_state(tp, ocfg), batch)
    assert abs(float(sm["loss"]) - float(wm["loss"])) <= 1e-4
    assert abs(float(sm["grad_norm"]) - float(wm["grad_norm"])) <= \
        1e-4 * abs(float(wm["grad_norm"]))
    for a, w in zip(tree_leaves(new.whole(0)), tree_leaves(want)):
        assert float((a - w).abs().max()) <= 2 * LR


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "llama-3.2-vision-11b"])
def test_split_mixers_train_over_the_mesh_match_jax(arch):
    """Training with MLA (deepseek, its MTP block too), Mamba (jamba),
    mLSTM and sLSTM (xlstm) and cross-attention (llama) split over
    "model", over (2, 2): the loss and its terms within 1e-4 and every
    gradient leaf within 1e-4 * max|ref| (xlstm's 1e-3, ``GRAD_RTOL``) of
    JAX's (1, 1) gradient of the same loss, the gradient the JAX step
    applies. A replicated leaf every
    rank reads (MLA's ``wq_a``, sLSTM's ``b``, the norms' scales) gets one
    part a rank, summed once (``value_and_grad_placed``). The MoE
    families at ``aux_weight=0`` (``MOE_ARCHS``)."""
    replace = {"aux_weight": 0.0} if arch in MOE_ARCHS else {}
    jcfg, cfg, jp, tp = _case(arch, 2, **replace)
    rng = np.random.default_rng(21)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(4, S + 1)).astype(
        np.int32)}
    if cfg.d_cross:
        batch["cross_states"] = rng.normal(size=(
            4, cfg.n_cross_tokens, cfg.d_cross)).astype(np.float32)
    with j_make_host_mesh(1, 1):
        (_, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: j_lm.lm_loss(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = DeviceMesh.on("cpu", 2, 2)
    b = build_step(cfg, ShapeCell("t", "train", S, 4), mesh,
                   param_dtype=torch.float32)
    placed = ShardedTree.place(tp, b.param_shardings, mesh)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (_, m), g = value_and_grad_placed(
        lambda p: lm.lm_loss(p, cfg, tb, {"mesh": mesh}), placed)
    for k in ("ce", "loss") + (("mtp",) if cfg.mtp else ()):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4, (k, m, jm)
    names = [n for n, _ in flatten_with_names(tp)]
    got = tree_leaves(g.whole(0))
    assert len(got) == len(jax.tree.leaves(jg))
    rtol = GRAD_RTOL.get(arch, 1e-4)
    for n, a, w in zip(names, got, jax.tree.leaves(jg)):
        assert _max_rel(a, w) <= rtol, n


# -- (c) the aliasing pin, (d) remat ---------------------------------------------

def test_a_step_writes_each_slice_once_into_the_placed_storage():
    _, cfg, _, tp = _case("qwen3-1.7b")
    toks = _batches(cfg, n=1, b=4)
    ocfg = optim.AdamWConfig(**OPT)
    want = tree_map(torch.clone, tp)
    want, _, wm = build_train_step(cfg, ocfg)(
        want, optim.init_opt_state(want, ocfg), {"tokens": toks[0]})

    mesh = DeviceMesh.on("cpu", 2, 2)
    b = build_step(cfg, ShapeCell("t", "train", S, 4), mesh, opt_cfg=ocfg,
                   param_dtype=torch.float32)
    whole = tree_map(torch.clone, tp)
    placed = ShardedTree.place(whole, b.param_shardings, mesh)
    ptrs = [[t.untyped_storage().data_ptr() for t in dev]
            for dev in placed.flat_leaves()]
    bases = []
    map_tree(lambda _, t: bases.append(t.untyped_storage().data_ptr()),
             placed.specs, whole)
    opt = optim.init_opt_state(placed, ocfg)
    assert opt["m"].shards[0][0]["embed"] is opt["m"].shards[1][0]["embed"]
    got, opt, m = b.fn(placed, opt, {"tokens": toks[0]})
    assert got is placed
    assert abs(float(m["loss"]) - float(wm["loss"])) <= 1e-5
    for dev, before in zip(placed.flat_leaves(), ptrs):
        now = [t.untyped_storage().data_ptr() for t in dev]
        assert now == before == bases
    for a, w, x in zip(tree_leaves(placed.whole(0)), tree_leaves(want),
                       tree_leaves(whole)):
        assert torch.equal(a, x)             # the slices are the whole tree
        assert float((a - w).abs().max()) <= 2 * LR

    # Each slice's update lands once: the placed update of a gradient
    # equals the whole tree's update of the same gradient gathered.
    placed = ShardedTree.place(tree_map(torch.clone, tp), b.param_shardings,
                               mesh)
    _, grads = value_and_grad_placed(lambda p: lm.lm_loss(
        p, cfg, {"tokens": torch.as_tensor(toks[0])}), placed)
    opt = optim.init_opt_state(placed, ocfg)
    optim.adamw_update(placed, grads, opt, ocfg)
    ref = tree_map(torch.clone, tp)
    ref_opt = optim.init_opt_state(ref, ocfg)
    optim.adamw_update(ref, grads.whole(0), ref_opt, ocfg)
    for got, want in ((placed, ref), (opt["m"], ref_opt["m"]),
                      (opt["v"], ref_opt["v"])):
        for a, w in zip(tree_leaves(got.whole(0)), tree_leaves(want)):
            assert float((a - w).abs().max()) <= 1e-6


def test_donate_false_leaves_the_callers_trees_unchanged():
    """``build_step(donate=False)`` (the JAX trainer's setting) steps a
    copy, one tensor a distinct slice; the default writes in place."""
    _, cfg, _, tp = _case("qwen3-1.7b")
    mesh = DeviceMesh.on("cpu", 2, 2)
    ocfg = optim.AdamWConfig(**OPT)
    batch = {"tokens": _batches(cfg, n=1, b=4)[0]}
    kept = build_step(cfg, ShapeCell("t", "train", S, 4), mesh,
                      opt_cfg=ocfg, param_dtype=torch.float32, donate=False)
    whole = tree_map(torch.clone, tp)
    opt = optim.init_opt_state(whole, ocfg)
    new, new_opt, _ = kept.fn(whole, opt, batch)
    assert all(torch.equal(a, w) for a, w in zip(tree_leaves(whole),
                                                 tree_leaves(tp)))
    assert int(opt["step"]) == 0 and int(new_opt["step"]) == 1
    held = new.flat_leaves()
    assert held[0][0] is held[2][0]     # embed: (0, 0) and (1, 0) share
    assert not torch.equal(new.whole(0)["embed"], tp["embed"])
    donated = build_step(cfg, ShapeCell("t", "train", S, 4), mesh,
                         opt_cfg=ocfg, param_dtype=torch.float32)
    donated.fn(whole, opt, batch)
    assert torch.equal(whole["embed"], new.whole(0)["embed"])
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b"])
def test_remat_policies_give_the_same_gradients_over_the_mesh(arch):
    _, cfg, _, tp = _case(arch)
    mesh = DeviceMesh.on("cpu", 2, 2)
    b = build_step(cfg, ShapeCell("t", "train", S, 4), mesh,
                   param_dtype=torch.float32)
    placed = ShardedTree.place(tp, b.param_shardings, mesh)
    batch = {"tokens": torch.as_tensor(_batches(cfg, n=1, b=4)[0])}
    out = {}
    for remat in ("none", "full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=remat)
        (loss, _), g = value_and_grad_placed(
            lambda p: lm.lm_loss(p, rcfg, batch, {"mesh": mesh}), placed)
        out[remat] = (loss, [t for dev in g.flat_leaves() for t in dev])
    loss, grads = out["none"]
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], loss), remat
        for a, w in zip(out[remat][1], grads):
            assert torch.equal(a, w), remat


# -- (e) the 8 -> 4 resume --------------------------------------------------------

def test_resume_from_8_to_4_rows_matches_jax(tmp_path):
    jcfg, cfg, jp, tp = _case("smollm-360m")
    toks = _batches(cfg, seed=9)
    _, want, _ = _jax_run(jcfg, jp, toks)
    shape = ShapeCell("t", "train", S, B)
    ocfg = optim.AdamWConfig(**OPT)
    mesh8 = DeviceMesh.on("cpu", 8, 1)
    b8 = build_step(cfg, shape, mesh8, opt_cfg=ocfg,
                    param_dtype=torch.float32)
    params = ShardedTree.place(tp, b8.param_shardings, mesh8)
    opt = optim.init_opt_state(params, ocfg)
    losses = []
    for t in toks[:2]:
        params, opt, m = b8.fn(params, opt, {"tokens": t})
        losses.append(float(m["loss"]))
    ckpt.save(str(tmp_path), 2, {"params": params, "opt": opt})

    mesh4 = DeviceMesh.on("cpu", 4, 1)
    b4 = build_step(cfg, shape, mesh4, opt_cfg=ocfg,
                    param_dtype=torch.float32)
    pspecs = b4.param_shardings
    state = ckpt.restore(str(tmp_path), 2, {"params": tp, "opt": opt},
                         device="cpu",
                         shardings={"params": (pspecs, mesh4),
                                    "opt": {"m": (pspecs, mesh4),
                                            "v": (pspecs, mesh4)}})
    assert state["params"].mesh is mesh4
    assert b4.opt_shardings == {"step": (), "m": pspecs, "v": pspecs}
    assert int(state["opt"]["step"]) == 2
    _, _, m = b4.fn(state["params"], state["opt"], {"tokens": toks[2]})
    losses.append(float(m["loss"]))
    for got, w in zip(losses, want):
        assert abs(got - w["loss"]) <= 1e-4, (losses, want)


def test_train_loop_over_a_mesh_resumes_from_its_checkpoint(tmp_path):
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    shape = ShapeCell("t", "train", 8, 4)
    kw = dict(opt_cfg=optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=3),
              ckpt_every=2, verbose=False)
    mesh = DeviceMesh.on("cpu", 2, 2)
    _, _, whole = train.train_loop(cfg, shape, mesh, steps=3, **kw)
    train.train_loop(cfg, shape, mesh, steps=2, ckpt_dir=str(tmp_path),
                     **kw)
    params, _, rest = train.train_loop(
        cfg, shape, DeviceMesh.on("cpu", 4, 1), steps=3,
        ckpt_dir=str(tmp_path), **kw)
    assert isinstance(params, ShardedTree)
    assert abs(rest[0] - whole[2]) <= 1e-5, (rest, whole)


# -- (f) the compressed all-reduce ------------------------------------------------

def test_compressed_psum_tree_matches_jax(jax_mesh_runs):
    _, g8, _, dec, err = jax_mesh_runs
    grads = [{"w": torch.as_tensor(g)} for g in g8]
    zeros = [{"w": torch.zeros(64)} for _ in g8]
    out, new_err = compressed_psum_tree(grads, zeros)
    for row, e, want_e in zip(out, new_err, err):
        np.testing.assert_allclose(row["w"].numpy(), dec, rtol=0, atol=1e-6)
        np.testing.assert_allclose(e["w"].numpy(), want_e, rtol=0,
                                   atol=1e-6)
    assert np.abs(out[0]["w"].numpy() - g8.mean(0)).max() <= 0.05
    # Error feedback: a second round carries the residual.
    out2, _ = compressed_psum_tree(grads, new_err)
    assert not torch.equal(out2[0]["w"], out[0]["w"])


# -- (g) the command line ----------------------------------------------------------

def test_train_command_runs_over_a_cpu_mesh(capsys):
    losses = train.main(["--arch", "qwen3-1.7b", "--device", "cpu",
                         "--data-parallel", "2", "--model-parallel", "2",
                         "--steps", "3", "--seq", "8", "--batch", "4"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "done: first loss" in capsys.readouterr().out
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="needs 4 devices"):
            make_host_mesh(2, 2)
