"""The port's LM training against the JAX package, on the CPU.

Parameters come from seeded numpy leaves of the JAX ``init_lm`` tree and
cross through ``repro_torch.convert.lm_params_from_jax``; batches are the
data pipeline's ``token_batch``. Tolerances:

* ``lm_loss`` within relative 1e-5 and each gradient leaf within
  1e-4 * max|ref| of ``jax.value_and_grad`` (two layers of float32
  matmuls, norms and softmaxes, summed in another order), for the five
  dense configs' ``smoke()``;
* three ``build_train_step`` steps: losses within relative 1e-4 and
  parameters within ``2 * lr * steps`` absolute (Adam moves a weight by
  about lr a step whatever its gradient's size, so a gradient at rounding
  level may flip a step's sign between the packages);
* the three remat policies give the same loss and gradients, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro import optim as j_optim
from repro.data import DataConfig as JDataConfig
from repro.data import token_batch as j_token_batch
from repro.models import lm as j_lm
from repro.models.params import Maker as JMaker
from repro_torch import configs, optim
from repro_torch._tree import flatten_with_names, tree_leaves, \
    value_and_grad
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.data import DataConfig, token_batch
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm

ARCHS = ("qwen3-1.7b", "smollm-360m", "stablelm-1.6b", "gemma2-27b",
         "musicgen-medium")


def _model(arch, seed=0):
    jcfg = j_configs.get_config(arch, smoke=True)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(
        lambda s: (rng.normal(size=s) * 0.1).astype(np.float32),
        j_lm.init_lm(JMaker("shapes"), jcfg),
        is_leaf=lambda x: isinstance(x, tuple))
    return jcfg, jp, configs.get_config(arch, smoke=True), \
        lm_params_from_jax(jp, device="cpu")


def _batch(cfg, seed, step=0):
    kw = dict(seed=seed, vocab=cfg.vocab, seq=12, global_batch=2,
              n_codebooks=cfg.n_codebooks)
    b = token_batch(DataConfig(**kw), step)
    np.testing.assert_array_equal(
        b["tokens"], j_token_batch(JDataConfig(**kw), step)["tokens"])
    return b


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch, seed=ARCHS.index(arch))
    b = _batch(cfg, seed=20 + ARCHS.index(arch))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t: j_lm.lm_loss(p, jcfg, {"tokens": t}), has_aux=True))(
            jp, jnp.asarray(b["tokens"]))
    (tl, tm), tg = value_and_grad(
        lambda p: lm.lm_loss(p, cfg, {"tokens": torch.as_tensor(
            b["tokens"])}), tp)
    assert set(tm) == set(jm) == {"ce", "aux", "loss"}
    for k in tm:
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-5 * max(abs(float(jm[k])), 1e-6), k
    assert float(tm["aux"]) == 0.0
    names = [n for n, _ in flatten_with_names(tg)]
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, g, w in zip(names, tree_leaves(tg), jax.tree.leaves(jg)):
        assert _max_rel(g, w) <= 1e-4, name


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-medium"])
def test_three_train_steps_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch, seed=7)
    steps, lr = 3, 1e-2
    kw = dict(lr=lr, warmup_steps=1, total_steps=steps)
    jocfg, tocfg = j_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)

    @jax.jit
    def jstep(p, o, t):
        (_, m), g = jax.value_and_grad(
            lambda q: j_lm.lm_loss(q, jcfg, {"tokens": t}), has_aux=True)(p)
        p, o, om = j_optim.adamw_update(p, g, o, jocfg)
        return p, o, {**m, **om}

    jo = j_optim.init_opt_state(jp, jocfg)
    to = opt_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    step = build_train_step(cfg, tocfg)
    for s in range(steps):
        b = _batch(cfg, seed=30, step=s)
        jp, jo, jm = jstep(jp, jo, jnp.asarray(b["tokens"]))
        tp, to, tm = step(tp, to, b)
        for k in ("loss", "ce", "lr", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-4 * abs(float(jm[k])), (s, k)
    assert int(to["step"]) == int(jo["step"]) == steps
    for a, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert np.abs(a.numpy() - np.asarray(w)).max() <= 2 * lr * steps


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b",
                                  "musicgen-medium"])
def test_remat_policies_give_the_same_gradients(arch):
    _, _, cfg, tp = _model(arch, seed=3)
    b = {"tokens": torch.as_tensor(_batch(cfg, seed=4)["tokens"])}
    out = {}
    for remat in ("none", "full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(lambda p: lm.lm_loss(p, rcfg, b), tp)
    (loss, _), grads = out["none"]
    for remat in ("full", "dots"):
        (l2, _), g2 = out[remat]
        assert torch.equal(l2, loss), remat
        for a, w in zip(tree_leaves(g2), tree_leaves(grads)):
            assert torch.equal(a, w), remat


def test_remat_policies_recompute_what_they_should(monkeypatch):
    """``"full"`` reruns the forward matmuls in the backward pass;
    ``"dots"`` runs under the policy that keeps every matmul output."""
    from torch.profiler import profile
    from repro_torch.models import transformer
    _, _, cfg, tp = _model("qwen3-1.7b", seed=3)
    b = {"tokens": torch.as_tensor(_batch(cfg, seed=4)["tokens"])}

    def grads(remat):
        return value_and_grad(lambda p: lm.lm_loss(
            p, dataclasses.replace(cfg, remat=remat), b), tp)

    mm = {}
    for remat in ("none", "full"):
        with profile() as prof:
            grads(remat)
        mm[remat] = sum(e.count for e in prof.key_averages()
                        if e.key in ("aten::mm", "aten::bmm"))
    assert mm["full"] > mm["none"]
    decisions, policy = [], transformer._save_dots

    def spy(ctx, op, *args, **kwargs):
        decisions.append((op, policy(ctx, op, *args, **kwargs)))
        return decisions[-1][1]
    monkeypatch.setattr(transformer, "_save_dots", spy)
    grads("dots")
    saved = {op for op, d in decisions
             if d == transformer.CheckpointPolicy.MUST_SAVE}
    assert saved == set(transformer._DOTS)
    assert any(d != transformer.CheckpointPolicy.MUST_SAVE
               for _, d in decisions)


def test_unknown_remat_policy_raises():
    _, _, cfg, tp = _model("qwen3-1.7b")
    b = {"tokens": torch.zeros((1, 5), dtype=torch.int32)}
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(lambda p: lm.lm_loss(
            p, dataclasses.replace(cfg, remat="some"), b), tp)


def test_prefill_unchanged_by_remat():
    _, _, cfg, tp = _model("qwen3-1.7b")
    toks = {"tokens": torch.as_tensor(_batch(cfg, seed=5)["tokens"])}
    want = lm.lm_prefill(tp, cfg, toks)
    got = lm.lm_prefill(tp, dataclasses.replace(cfg, remat="dots"), toks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("spec", [dict(kind="mamba"), dict(kind="mlstm"),
                                  dict(kind="slstm"), dict(cross=True)])
def test_unported_blocks_keep_raising(spec):
    """No block kind is left unported. Each kind once refused here builds
    a step that trains, on a smoke config that carries its sub-config; a
    cross-attention block trains on a batch with image states and raises
    ``ValueError`` on a batch without them."""
    from repro_torch.models.transformer import BlockSpec
    arch = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b",
            "slstm": "xlstm-1.3b"}.get(spec.get("kind"),
                                        "llama-3.2-vision-11b")
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              pattern=(BlockSpec(**spec),))
    params = lm.init_lm(cfg, 0, device="cpu")
    batch = {"tokens": np.arange(18, dtype=np.int32).reshape(2, 9)}
    step = build_train_step(cfg)
    opt = optim.init_opt_state(params, optim.AdamWConfig())
    if spec.get("cross"):
        with pytest.raises(ValueError, match="encoder states"):
            step(params, opt, batch)
        batch["cross_states"] = np.ones((2, cfg.n_cross_tokens, cfg.d_cross),
                                        np.float32)
    _, _, m = step(params, opt, batch)
    assert np.isfinite(float(m["loss"]))


def test_train_command_runs_on_the_cpu(tmp_path, capsys):
    losses = train.main(["--arch", "qwen3-1.7b", "--steps", "3", "--seq",
                         "8", "--batch", "2", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "done: first loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--arch", "qwen3-1.7b", "--data-parallel", "2",
                    "--device", "cpu"])
