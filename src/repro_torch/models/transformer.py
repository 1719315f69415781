"""Block assembly and the layer stack.

A model is ``prefix`` blocks (deepseek-v3's leading dense MLA layers)
followed by ``n_repeats`` copies of a ``pattern`` super-block (gemma-2's
period 2: [local, global]). Pattern parameters are stacked along a leading
layer dimension under ``"stack"/"b{j}"``, as in the JAX package, and the
JAX ``lax.scan`` over that dimension is a Python loop over the layer index
``r`` here. The decode cache mirrors the parameter tree and is updated in
place.

Blocks mix with GQA attention (``kind="attn"``), MLA (``"mla"``), Mamba
(``"mamba"``) or xLSTM (``"mlstm"`` / ``"slstm"``), and end in a dense MLP,
a MoE MLP (``mlp="moe"``, whose load-balancing term is summed into the
stack's ``aux``) or none. A cross-attention block (``cross=True``) reads
the encoder states passed as ``cross_states=`` in the train / prefill
path, and in decode a static cache of ``n_cross_tokens`` rows holding
their K/V (``lm.build_cross_cache``).

The recurrent kinds keep O(1) state a slot instead of a KV cache, and
their decode ignores ``pos``. :func:`reset_cache_rows` writes a slot's
recurrent rows back to their initial values (``recurrent_init``), which a
serving engine does when it admits a request into a used slot; attention
and MLA caches are left alone, as ``pos`` masks them, and so are the
cross-attention caches, whose image belongs to the slot.

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

from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import (AttnConfig, MlaConfig, MlpConfig,
                                       attention_decode, attention_train,
                                       init_attention, init_kv_cache,
                                       init_mla, init_mla_cache, init_mlp,
                                       make_norm, mla_decode, mla_train, mlp)
from repro_torch.models.moe import MoeConfig, init_moe, moe_apply
from repro_torch.models.params import Maker, stacked

@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"          # attn | mla | mamba | mlstm | slstm
    mlp: str = "dense"          # dense | moe | none
    window: int | None = None   # sliding-window attention
    cross: bool = False         # cross-attention (kv from encoder states)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ``ModelConfig`` field for field."""

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
    mamba: ssm.MambaConfig | None = None
    xlstm_cfg: xlstm.XlstmConfig | None = None
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


_KINDS = ("attn", "mla", "mamba", "mlstm", "slstm")


def _check_spec(spec: BlockSpec) -> None:
    if spec.kind not in _KINDS:
        raise ValueError(spec.kind)


def _mlp_cfg(cfg: ModelConfig) -> MlpConfig:
    return MlpConfig(cfg.d_model, cfg.d_ff, cfg.mlp_kind)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def init_block(mk: Maker, cfg: ModelConfig, spec: BlockSpec):
    _check_spec(spec)
    init_norm, _ = make_norm(cfg.norm)
    p: dict[str, Any] = {"norm1": init_norm(mk, cfg.d_model)}
    if spec.kind == "attn":
        p["attn"] = init_attention(mk, cfg.attn_cfg(spec))
    elif spec.kind == "mla":
        p["attn"] = init_mla(mk, cfg.mla)
    elif spec.kind == "mamba":
        p["mix"] = ssm.init_mamba(mk, cfg.mamba)
    elif spec.kind == "mlstm":
        p["mix"] = xlstm.init_mlstm(mk, cfg.xlstm_cfg)
    else:
        p["mix"] = xlstm.init_slstm(mk, cfg.xlstm_cfg)
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


def _mix_train(p, cfg: ModelConfig, spec: BlockSpec, h, cross_states):
    if spec.kind == "attn":
        return attention_train(p["attn"], cfg.attn_cfg(spec), h,
                               kv_src=cross_states if spec.cross else None,
                               use_flash=cfg.use_flash)
    if spec.kind == "mla":
        return mla_train(p["attn"], cfg.mla, h, impl=cfg.attn_impl,
                         chunk=cfg.attn_chunk)
    if spec.kind == "mamba":
        return ssm.mamba_train(p["mix"], cfg.mamba, h)
    if spec.kind == "mlstm":
        return xlstm.mlstm_train(p["mix"], cfg.xlstm_cfg, h)
    return xlstm.slstm_train(p["mix"], cfg.xlstm_cfg, h)


def block_train(p, cfg: ModelConfig, spec: BlockSpec, x, *,
                cross_states=None):
    """Full-sequence forward of one block -> (x, aux). A cross block
    attends over ``cross_states`` (B, S_kv, d_cross) and raises
    ``ValueError`` without them."""
    _, norm = make_norm(cfg.norm)
    y = _mix_train(p, cfg, spec, norm(p["norm1"], x), cross_states)
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
    elif spec.kind == "mla":
        y, _ = mla_decode(p["attn"], cfg.mla, h, cache["mix"], pos)
    elif spec.kind == "mamba":
        y, _ = ssm.mamba_decode(p["mix"], cfg.mamba, h, cache["mix"])
    elif spec.kind == "mlstm":
        y, _ = xlstm.mlstm_decode(p["mix"], cfg.xlstm_cfg, h, cache["mix"])
    else:
        y, _ = xlstm.slstm_decode(p["mix"], cfg.xlstm_cfg, h, cache["mix"])
    if cfg.sandwich_norm:
        y = norm(p["post1"], y)
    x, _ = _mlp_residual(p, cfg, spec, x + y)
    return x, cache


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, *, dtype=torch.bfloat16, device="cpu",
                     lead=()):
    """The block's decode cache. ``dtype`` holds the attention, MLA and
    Mamba caches; the xLSTM caches are always float32, as in the JAX
    package. A cross block's cache has ``max(n_cross_tokens, 1)`` rows,
    whatever ``max_len``."""
    _check_spec(spec)
    kw = dict(dtype=dtype, device=device, lead=lead)
    if spec.kind == "attn":
        rows = max(cfg.n_cross_tokens, 1) if spec.cross else max_len
        mix = init_kv_cache(cfg.attn_cfg(spec), batch, rows, **kw)
    elif spec.kind == "mla":
        mix = init_mla_cache(cfg.mla, batch, max_len, **kw)
    elif spec.kind == "mamba":
        mix = ssm.init_mamba_cache(cfg.mamba, batch, **kw)
    elif spec.kind == "mlstm":
        mix = xlstm.init_mlstm_cache(cfg.xlstm_cfg, batch, device=device,
                                     lead=lead)
    else:
        mix = xlstm.init_slstm_cache(cfg.xlstm_cfg, batch, device=device,
                                     lead=lead)
    return {"mix": mix}


def recurrent_init(spec: BlockSpec) -> dict[str, float] | None:
    """The initial value of each leaf of a recurrent block's ``"mix"``
    cache (the values its ``init_*_cache`` builds from); None for the
    attention and MLA kinds, whose rows ``pos`` masks."""
    return {"mamba": ssm.CACHE_INIT, "mlstm": xlstm.MLSTM_CACHE_INIT,
            "slstm": xlstm.SLSTM_CACHE_INIT}.get(spec.kind)


def reset_cache_rows(cfg: ModelConfig, cache, rows) -> None:
    """Write the initial values into the batch rows ``rows`` of every
    recurrent cache leaf, in place (a stacked leaf's row ``i`` is
    ``leaf[:, i]``)."""
    rows = torch.as_tensor(rows, dtype=torch.long)
    blocks = [(spec, c, False) for spec, c in zip(cfg.prefix,
                                                   cache.get("prefix", []))]
    if cfg.n_repeats:
        blocks += [(spec, cache["stack"][f"b{j}"], True)
                   for j, spec in enumerate(cfg.pattern)]
    for spec, c, lead in blocks:
        for name, value in (recurrent_init(spec) or {}).items():
            leaf = c["mix"][name]
            leaf.index_fill_(int(lead), rows.to(leaf.device), value)


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def init_layers(mk: Maker, cfg: ModelConfig):
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
    """``fn(x)`` under the activation-checkpoint policy ``cfg.remat``;
    ``fn`` binds every other input (the layer index, the cross states), so
    that a recomputation sees the same ones."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {} if cfg.remat == "full" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_dots))
    return lambda x: checkpoint(fn, x, use_reentrant=False, **kw)


def apply_layers_train(p, cfg: ModelConfig, x, *, cross_states=None):
    """Full-sequence forward of every layer -> (x, aux): ``aux`` sums the
    MoE blocks' load-balancing terms (float32), as in the JAX package.
    The cross blocks attend over ``cross_states``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prefix):
        x, a = _remat(cfg, functools.partial(
            block_train, p["prefix"][i], cfg, spec,
            cross_states=cross_states))(x)
        aux = aux + a

    stack = [layer_slices(p["stack"][f"b{j}"])
             for j in range(len(cfg.pattern))] if cfg.n_repeats else []

    def superblock(x, r, cross_states):
        a_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, spec in enumerate(cfg.pattern):
            x, a = block_train(stack[j][r], cfg, spec, x,
                               cross_states=cross_states)
            a_tot = a_tot + a
        return x, a_tot

    auxs = []
    for r in range(cfg.n_repeats):
        x, a = _remat(cfg, functools.partial(
            superblock, r=r, cross_states=cross_states))(x)
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
