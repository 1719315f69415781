"""Block assembly and the layer stack.

A model is ``prefix`` blocks (deepseek-v3's leading dense MLA layers)
followed by ``n_repeats`` copies of a ``pattern`` super-block (gemma-2's
period 2: [local, global]). Pattern parameters are stacked along a leading
layer dimension under ``"stack"/"b{j}"``, as in the JAX package, and the
JAX ``lax.scan`` over that dimension is a Python loop over the layer index
``r`` here. The decode cache mirrors the parameter tree and is updated in
place.

Blocks mix with GQA attention (``kind="attn"``) or MLA (``"mla"``), and
end in a dense MLP, a MoE MLP (``mlp="moe"``, whose load-balancing term
is summed into the stack's ``aux``) or none. The other block kinds
(Mamba, mLSTM / sLSTM) and cross-attention raise ``NotImplementedError``
(ROADMAP.md §1).

``remat`` applies to training (grad mode on) per layer or per pattern
super-block, as in the JAX package: ``"full"`` recomputes everything in
the backward pass (``torch.utils.checkpoint`` with only the inputs kept),
``"dots"`` keeps the matmul outputs (``aten.mm`` / ``aten.bmm``) and
recomputes the rest, ``"none"`` keeps all activations. All three give the
same gradients. Inference ignores it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.layers import (AttnConfig, MlaConfig, MlpConfig,
                                       attention_decode, attention_train,
                                       init_attention, init_kv_cache,
                                       init_mla, init_mla_cache, init_mlp,
                                       make_norm, mla_decode, mla_train, mlp)
from repro_torch.models.moe import MoeConfig, init_moe, moe_apply
from repro_torch.models.params import Maker, stacked

_ROADMAP_ITEM = ("ROADMAP.md §1: Mamba + jamba, xLSTM, cross-attention + "
                 "llama-3.2-vision")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"          # attn | mla | mamba | mlstm | slstm
    mlp: str = "dense"          # dense | moe | none
    window: int | None = None   # sliding-window attention
    cross: bool = False         # cross-attention (kv from encoder states)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ``ModelConfig`` field for field. The Mamba and
    xLSTM sub-configs are opaque here (not ported yet)."""

    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[BlockSpec, ...]
    n_repeats: int
    prefix: tuple[BlockSpec, ...] = ()
    norm: str = "rms"                    # rms | layer
    mlp_kind: str = "swiglu"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    qk_scale: float | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sandwich_norm: bool = False          # gemma-2 post-norms
    emb_scale: bool = False              # gemma: x *= sqrt(d)
    logits_scale: float | None = None    # granite
    moe: MoeConfig | None = None
    mla: MlaConfig | None = None
    mamba: Any = None
    xlstm_cfg: Any = None
    n_codebooks: int = 1                 # musicgen: 4
    d_cross: int | None = None           # llama-vision encoder width
    n_cross_tokens: int = 0
    mtp: bool = False                    # deepseek multi-token prediction
    mtp_weight: float = 0.3
    aux_weight: float = 0.01
    tie_embeddings: bool = False
    remat: str = "none"                  # none | full | dots
    scan_layers: bool = True
    sub_quadratic: bool = False          # long_500k-capable decode
    use_flash: bool = False              # flash kernel on the prefill path
    attn_impl: str = "ref"               # "ref" | "chunked" (online softmax)
    attn_chunk: int = 2048

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + self.n_repeats * len(self.pattern)

    def attn_cfg(self, spec: BlockSpec) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, rope_fraction=self.rope_fraction,
            qk_norm=self.qk_norm, window=spec.window,
            attn_softcap=self.attn_softcap, cross=spec.cross,
            d_cross=self.d_cross, qk_scale=self.qk_scale,
            impl=self.attn_impl, chunk=self.attn_chunk)


def _check_spec(cfg: ModelConfig, spec: BlockSpec) -> None:
    if spec.kind not in ("attn", "mla") or spec.cross:
        raise NotImplementedError(
            f"{cfg.name}: block {spec} is not ported yet ({_ROADMAP_ITEM})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block the port does not run."""
    for spec in cfg.prefix + cfg.pattern:
        _check_spec(cfg, spec)


def _mlp_cfg(cfg: ModelConfig) -> MlpConfig:
    return MlpConfig(cfg.d_model, cfg.d_ff, cfg.mlp_kind)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def init_block(mk: Maker, cfg: ModelConfig, spec: BlockSpec):
    _check_spec(cfg, spec)
    init_norm, _ = make_norm(cfg.norm)
    p: dict[str, Any] = {"norm1": init_norm(mk, cfg.d_model)}
    if spec.kind == "attn":
        p["attn"] = init_attention(mk, cfg.attn_cfg(spec))
    else:
        p["attn"] = init_mla(mk, cfg.mla)
    if cfg.sandwich_norm:
        p["post1"] = init_norm(mk, cfg.d_model)
    if spec.mlp in ("dense", "moe"):
        p["norm2"] = init_norm(mk, cfg.d_model)
        if spec.mlp == "dense":
            p["mlp"] = init_mlp(mk, _mlp_cfg(cfg))
        else:
            p["moe"] = init_moe(mk, cfg.moe)
        if cfg.sandwich_norm:
            p["post2"] = init_norm(mk, cfg.d_model)
    return p


def _mlp_residual(p, cfg: ModelConfig, spec: BlockSpec, x):
    """The block's MLP half -> (x, aux); aux is the MoE load-balancing
    term, a float32 zero for the other MLPs."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp not in ("dense", "moe"):
        return x, aux
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm2"], x)
    if spec.mlp == "dense":
        y = mlp(p["mlp"], _mlp_cfg(cfg), h)
    else:
        y, aux = moe_apply(p["moe"], cfg.moe, h)
    if cfg.sandwich_norm:
        y = norm(p["post2"], y)
    return x + y, aux


def _mix_train(p, cfg: ModelConfig, spec: BlockSpec, h):
    if spec.kind == "attn":
        return attention_train(p["attn"], cfg.attn_cfg(spec), h,
                               use_flash=cfg.use_flash)
    return mla_train(p["attn"], cfg.mla, h, impl=cfg.attn_impl,
                     chunk=cfg.attn_chunk)


def block_train(p, cfg: ModelConfig, spec: BlockSpec, x):
    """Full-sequence forward of one block -> (x, aux)."""
    _, norm = make_norm(cfg.norm)
    y = _mix_train(p, cfg, spec, norm(p["norm1"], x))
    if cfg.sandwich_norm:
        y = norm(p["post1"], y)
    return _mlp_residual(p, cfg, spec, x + y)


def block_decode(p, cfg: ModelConfig, spec: BlockSpec, x, cache, pos):
    """Single-token step; ``cache`` is updated in place. -> (x, cache)."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    if spec.kind == "attn":
        y, _ = attention_decode(p["attn"], cfg.attn_cfg(spec), h,
                                cache["mix"], pos)
    else:
        y, _ = mla_decode(p["attn"], cfg.mla, h, cache["mix"], pos)
    if cfg.sandwich_norm:
        y = norm(p["post1"], y)
    x, _ = _mlp_residual(p, cfg, spec, x + y)
    return x, cache


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, *, dtype=torch.bfloat16, device="cpu",
                     lead=()):
    _check_spec(cfg, spec)
    kw = dict(dtype=dtype, device=device, lead=lead)
    if spec.kind == "attn":
        return {"mix": init_kv_cache(cfg.attn_cfg(spec), batch, max_len,
                                     **kw)}
    return {"mix": init_mla_cache(cfg.mla, batch, max_len, **kw)}


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def init_layers(mk: Maker, cfg: ModelConfig):
    check_supported(cfg)
    p: dict[str, Any] = {}
    if cfg.prefix:
        p["prefix"] = [init_block(mk, cfg, s) for s in cfg.prefix]
    if cfg.n_repeats:
        p["stack"] = {
            f"b{j}": stacked(cfg.n_repeats,
                             lambda m, _s=s: init_block(m, cfg, _s), mk)
            for j, s in enumerate(cfg.pattern)}
    return p


def layer_slices(tree) -> list:
    """Every layer of a stacked tree, as views, so writes reach the
    stack. One ``unbind`` a leaf: its backward stacks the layers'
    gradients once, where a slice a layer would add a zero-filled
    stack-sized gradient per layer."""
    if isinstance(tree, dict):
        per = {k: layer_slices(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][r] for k in tree} for r in range(n)]
    return list(torch.unbind(tree, 0))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn(x)`` under the activation-checkpoint policy ``cfg.remat``."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {} if cfg.remat == "full" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_dots))
    return lambda x: checkpoint(fn, x, use_reentrant=False, **kw)


def apply_layers_train(p, cfg: ModelConfig, x):
    """Full-sequence forward of every layer -> (x, aux): ``aux`` sums the
    MoE blocks' load-balancing terms (float32), as in the JAX package."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prefix):
        x, a = _remat(cfg, functools.partial(block_train, p["prefix"][i],
                                             cfg, spec))(x)
        aux = aux + a

    stack = [layer_slices(p["stack"][f"b{j}"])
             for j in range(len(cfg.pattern))] if cfg.n_repeats else []

    def superblock(x, r):
        a_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, spec in enumerate(cfg.pattern):
            x, a = block_train(stack[j][r], cfg, spec, x)
            a_tot = a_tot + a
        return x, a_tot

    auxs = []
    for r in range(cfg.n_repeats):
        x, a = _remat(cfg, functools.partial(superblock, r=r))(x)
        auxs.append(a)
    if auxs:
        aux = aux + torch.stack(auxs).sum()
    return x, aux


def apply_layers_decode(p, cfg: ModelConfig, x, cache, pos):
    """One token through every layer; ``cache`` is updated in place."""
    for i, spec in enumerate(cfg.prefix):
        x, _ = block_decode(p["prefix"][i], cfg, spec, x,
                            cache["prefix"][i], pos)
    layers = [(layer_slices(p["stack"][f"b{j}"]),
               layer_slices(cache["stack"][f"b{j}"]))
              for j in range(len(cfg.pattern))] if cfg.n_repeats else []
    for r in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.pattern):
            x, _ = block_decode(layers[j][0][r], cfg, spec, x,
                                layers[j][1][r], pos)
    return x, cache


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device="cpu"):
    check_supported(cfg)
    kw = dict(dtype=dtype, device=device)
    cache: dict[str, Any] = {}
    if cfg.prefix:
        cache["prefix"] = [init_block_cache(cfg, s, batch, max_len, **kw)
                           for s in cfg.prefix]
    if cfg.n_repeats:
        cache["stack"] = {
            f"b{j}": init_block_cache(cfg, s, batch, max_len,
                                      lead=(cfg.n_repeats,), **kw)
            for j, s in enumerate(cfg.pattern)}
    return cache
