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

Over a mesh, ``ctx`` (the JAX package's dict) carries ``"mesh"``, a
``launch.mesh.DeviceMesh``: the MoE blocks run expert-parallel over it
(``moe_apply(mesh=)``). Params placed on the mesh (a ``ShardedTree``,
``launch.steps.build_step``) run the layer stack tensor-parallel from one
controller: the batch splits over the data rows (:func:`maybe_constrain`,
row i on ``mesh.device(i, 0)``). Every mixer whose specs split any of its
leaves over "model" runs over the model ranks, each rank computing with
its own slices (self- and cross-attention ``layers.attention_*_tp``, MLA
``layers.mla_*_tp``, Mamba ``ssm.mamba_tp``, mLSTM / sLSTM
``xlstm.mlstm_tp`` / ``xlstm.slstm_tp``); the dense MLP splits where its
columns do (``layers.mlp_tp``). Decode reads a :class:`ShardedCache` whose rank r of
row i holds the part of each block's cache its units need. A mixer none
of whose leaves a spec splits (smollm's 3 heads over 2 ranks) runs whole
on its row's rank 0. Only leaves no spec splits over "model" are read
whole (:func:`_held`: the norms, a dense MLP whose columns stay whole).

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
                                       attention_decode, attention_decode_tp,
                                       attention_train, attention_train_tp,
                                       init_attention, init_kv_cache,
                                       init_mla, init_mla_cache, init_mlp,
                                       kv_heads_of, make_norm, mla_decode,
                                       mla_decode_tp, mla_train,
                                       mla_train_tp, mlp, mlp_tp)
from repro_torch.models.moe import (MoeConfig, _batch_rows, init_moe,
                                    moe_apply, moe_sharded)
from repro_torch.models.params import (LogicalAxes, Maker, ShardedTree,
                                       map_tree, stacked)

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


def _held(p, key: str, i: int):
    """``p[key]`` as data row ``i`` runs an unsplit function on it: for a
    block placed on a mesh (a ``ShardedTree``), whole on the row's
    device. The blocks' norms and a dense MLP whose columns no spec
    splits read it; the mixers never do (:func:`_mixer_params`)."""
    return p[key].whole(i) if isinstance(p, ShardedTree) else p[key]


def _split(p, key: str, name: str) -> bool:
    """Whether ``p`` is placed on a mesh with leaf ``name`` of ``p[key]``
    split over "model" in its first dimension after d_model (query heads,
    MLP columns)."""
    return isinstance(p, ShardedTree) and p[key].specs[name][1] == "model"


def _rank_list(p: ShardedTree, i: int):
    return [(p.local(i, r), p.mesh.device(i, r))
            for r in range(p.mesh.shape["model"])]


def _on_model(spec) -> bool:
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


# Per mixer kind: its subtree, and the leaf whose split over "model"
# splits the mixer's units (query heads, or Mamba's inner channels) and
# with them its decode cache.
_UNIT_LEAF = {"attn": ("attn", "wq"), "mla": ("attn", "wq_b"),
              "mamba": ("mix", "conv_w"), "mlstm": ("mix", "wq"),
              "slstm": ("mix", "r")}


def _mixer_split(p, spec: BlockSpec) -> bool:
    """Whether ``p`` is a block placed on a mesh whose specs split any
    leaf of its mixer over "model": the mixer then runs over the model
    ranks (its ``*_tp`` form), each computing with its own slices."""
    if not isinstance(p, ShardedTree):
        return False
    return any(_on_model(s)
               for s in p[_UNIT_LEAF[spec.kind][0]].spec_leaves())


def _mixer_params(p, spec: BlockSpec, i: int):
    """Row i's params of the block's mixer: a (slice, device) a model rank
    where :func:`_mixer_split`, else the tree its rank 0 computes with
    (every leaf replicated over "model", an FSDP-split one gathered)."""
    key = _UNIT_LEAF[spec.kind][0]
    if _mixer_split(p, spec):
        return _rank_list(p[key], i)
    return p[key].local(i, 0) if isinstance(p, ShardedTree) else p[key]


def _mlp_residual(p, cfg: ModelConfig, spec: BlockSpec, xs, mesh=None):
    """The block's MLP half over the batch rows ``xs`` -> (rows, aux); aux
    is the MoE load-balancing term, a float32 zero for the other MLPs.
    ``mesh`` reaches ``moe_apply``; a placed block runs its MoE over its
    own mesh and its dense MLP tensor-parallel where the specs split the
    columns."""
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    if spec.mlp not in ("dense", "moe"):
        return xs, aux
    _, norm = make_norm(cfg.norm)
    hs = [norm(_held(p, "norm2", i), x) for i, x in enumerate(xs)]
    if spec.mlp == "moe" and isinstance(p, ShardedTree):
        ys, aux = moe_sharded(p["moe"], cfg.moe, hs, p.mesh)
    elif spec.mlp == "moe":
        y, aux = moe_apply(p["moe"], cfg.moe, hs[0], mesh=mesh)
        ys = [y]
    elif _split(p, "mlp", "w_up"):
        ys = [mlp_tp(_rank_list(p["mlp"], i), _mlp_cfg(cfg), h)
              for i, h in enumerate(hs)]
    else:
        ys = [mlp(_held(p, "mlp", i), _mlp_cfg(cfg), h)
              for i, h in enumerate(hs)]
    if cfg.sandwich_norm:
        ys = [norm(_held(p, "post2", i), y) for i, y in enumerate(ys)]
    return [x + y for x, y in zip(xs, ys)], aux


def _mesh(ctx):
    return (ctx or {}).get("mesh")


# The recurrent kinds' split forms (train, or decode given the caches).
_RECURRENT_TP = {"mamba": ssm.mamba_tp, "mlstm": xlstm.mlstm_tp,
                 "slstm": xlstm.slstm_tp}


def _recurrent_cfg(cfg: ModelConfig, spec: BlockSpec):
    return cfg.mamba if spec.kind == "mamba" else cfg.xlstm_cfg


def _mix_train(p, cfg: ModelConfig, spec: BlockSpec, h, cross_states,
               i: int = 0):
    q = _mixer_params(p, spec, i)
    kv = cross_states if spec.cross else None
    if _mixer_split(p, spec):
        if spec.kind == "attn":
            return attention_train_tp(q, cfg.attn_cfg(spec), h, kv_src=kv,
                                      use_flash=cfg.use_flash)
        if spec.kind == "mla":
            return mla_train_tp(q, cfg.mla, h, impl=cfg.attn_impl,
                                chunk=cfg.attn_chunk)
        return _RECURRENT_TP[spec.kind](q, _recurrent_cfg(cfg, spec), h)
    if spec.kind == "attn":
        return attention_train(q, cfg.attn_cfg(spec), h, kv_src=kv,
                               use_flash=cfg.use_flash)
    if spec.kind == "mla":
        return mla_train(q, cfg.mla, h, impl=cfg.attn_impl,
                         chunk=cfg.attn_chunk)
    if spec.kind == "mamba":
        return ssm.mamba_train(q, cfg.mamba, h)
    if spec.kind == "mlstm":
        return xlstm.mlstm_train(q, cfg.xlstm_cfg, h)
    return xlstm.slstm_train(q, cfg.xlstm_cfg, h)


def _mix_decode(p, cfg: ModelConfig, spec: BlockSpec, h, cache, pos,
                i: int = 0):
    """The mixer's decode output; ``cache`` is the block's cache, or for a
    placed block row i's list of rank caches (a rank that holds none of
    the block's cache has None leaves)."""
    q = _mixer_params(p, spec, i)
    if _mixer_split(p, spec):
        caches = [c["mix"] for c in cache]
        ranks = [(w, dev, c) for (w, dev), c in zip(q, caches)]
        if spec.kind == "attn":
            return attention_decode_tp(ranks, cfg.attn_cfg(spec), h, pos)
        if spec.kind == "mla":
            return mla_decode_tp(ranks, cfg.mla, h, pos)
        return _RECURRENT_TP[spec.kind](q, _recurrent_cfg(cfg, spec), h,
                                        caches)
    if isinstance(p, ShardedTree):
        cache = cache[0]                 # held by the row's rank 0
    if spec.kind == "attn":
        y, _ = attention_decode(q, cfg.attn_cfg(spec), h, cache["mix"], pos)
    elif spec.kind == "mla":
        y, _ = mla_decode(q, cfg.mla, h, cache["mix"], pos)
    elif spec.kind == "mamba":
        y, _ = ssm.mamba_decode(q, cfg.mamba, h, cache["mix"])
    elif spec.kind == "mlstm":
        y, _ = xlstm.mlstm_decode(q, cfg.xlstm_cfg, h, cache["mix"])
    else:
        y, _ = xlstm.slstm_decode(q, cfg.xlstm_cfg, h, cache["mix"])
    return y


def _block(p, cfg: ModelConfig, spec: BlockSpec, xs, mix, mesh):
    """One block over the batch rows ``xs`` -> (rows, aux); ``mix(i, h)``
    is row i's mixer output."""
    _, norm = make_norm(cfg.norm)
    out = []
    for i, x in enumerate(xs):
        y = mix(i, norm(_held(p, "norm1", i), x))
        if cfg.sandwich_norm:
            y = norm(_held(p, "post1", i), y)
        out.append(x + y)
    return _mlp_residual(p, cfg, spec, out, mesh)


def block_train(p, cfg: ModelConfig, spec: BlockSpec, x, *,
                cross_states=None, ctx=None):
    """Full-sequence forward of one block -> (x, aux). A cross block
    attends over ``cross_states`` (B, S_kv, d_cross) and raises
    ``ValueError`` without them. With ``p`` placed on a mesh (a
    ``ShardedTree``), ``x`` and ``cross_states`` are lists of batch rows
    (:func:`maybe_constrain`), and so is the x returned."""
    placed = isinstance(p, ShardedTree)
    xs, cross = (x, cross_states) if placed else ([x], [cross_states])
    xs, aux = _block(p, cfg, spec, xs, lambda i, h: _mix_train(
        p, cfg, spec, h, cross[i] if cross else None, i), _mesh(ctx))
    return (xs if placed else xs[0]), aux


def block_decode(p, cfg: ModelConfig, spec: BlockSpec, x, cache, pos,
                 ctx=None):
    """Single-token step; ``cache`` is updated in place. -> (x, cache).
    With ``p`` placed on a mesh, ``x`` and ``pos`` are lists of batch rows
    and ``cache`` lists, for each row, its ranks' caches of the block
    (:class:`ShardedCache`)."""
    placed = isinstance(p, ShardedTree)
    xs, ps, cs = (x, pos, cache) if placed else ([x], [pos], [cache])
    xs, _ = _block(p, cfg, spec, xs, lambda i, h: _mix_decode(
        p, cfg, spec, h, cs[i], ps[i], i), _mesh(ctx))
    return (xs if placed else xs[0]), cache


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
    if isinstance(tree, ShardedTree):
        return tree.layers()
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


def _device_of(x) -> torch.device:
    return (x[0] if isinstance(x, list) else x).device


def apply_layers_train(p, cfg: ModelConfig, x, *, cross_states=None,
                       ctx=None):
    """Full-sequence forward of every layer -> (x, aux): ``aux`` sums the
    MoE blocks' load-balancing terms (float32), as in the JAX package.
    The cross blocks attend over ``cross_states``. With ``p`` placed on a
    mesh (a ``ShardedTree``), ``x`` and ``cross_states`` are lists of
    batch rows (:func:`maybe_constrain`) and so is the x returned."""
    aux = torch.zeros((), dtype=torch.float32, device=_device_of(x))
    for i, spec in enumerate(cfg.prefix):
        x, a = _remat(cfg, functools.partial(
            block_train, p["prefix"][i], cfg, spec,
            cross_states=cross_states, ctx=ctx))(x)
        aux = aux + a

    stack = [layer_slices(p["stack"][f"b{j}"])
             for j in range(len(cfg.pattern))] if cfg.n_repeats else []

    def superblock(x, r, cross_states):
        a_tot = torch.zeros((), dtype=torch.float32, device=_device_of(x))
        for j, spec in enumerate(cfg.pattern):
            x, a = block_train(stack[j][r], cfg, spec, x,
                               cross_states=cross_states, ctx=ctx)
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


def apply_layers_decode(p, cfg: ModelConfig, x, cache, pos, ctx=None):
    """One token through every layer; ``cache`` is updated in place. With
    ``p`` placed on a mesh, ``x`` and ``pos`` are lists of batch rows and
    ``cache`` a :class:`ShardedCache`."""
    if isinstance(p, ShardedTree):
        if not isinstance(cache, ShardedCache):
            raise ValueError("params placed on a mesh decode against a "
                             "ShardedCache (lm.init_cache(mesh=))")
        if len(x) != len(cache.rows):
            raise ValueError("the cache's batch rows do not match the "
                             "token batch")
        if cache.split != cache_split(p, cfg):
            raise ValueError("the cache's split over \"model\" does not "
                             "match the params' placement")
    for i, spec in enumerate(cfg.prefix):
        x, _ = block_decode(p["prefix"][i], cfg, spec, x,
                            _block_cache(cache, ("prefix", i)), pos, ctx)
    layers = [(layer_slices(p["stack"][f"b{j}"]),
               _block_cache(cache, ("stack", f"b{j}"), cfg.n_repeats))
              for j in range(len(cfg.pattern))] if cfg.n_repeats else []
    for r in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.pattern):
            x, _ = block_decode(layers[j][0][r], cfg, spec, x,
                                layers[j][1][r], pos, ctx)
    return x, cache


def _block_cache(cache, path, n_layers: int | None = None):
    """The cache of the block at ``path`` (with ``n_layers``, the list of
    a stacked block's layers, as views); of a :class:`ShardedCache`, each
    data row's list of rank caches."""
    if not isinstance(cache, ShardedCache):
        c = _at(cache, path)
        return c if n_layers is None else layer_slices(c)
    if n_layers is None:
        return [[_at(s, path) for s in row] for row in cache.shards]
    return [[[map_tree(lambda t: None if t is None else t[r], _at(s, path))
              for s in row] for row in cache.shards]
            for r in range(n_layers)]


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


_CACHE_AXES = {
    "attn": {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
             "v": ("batch", "kv_seq", "kv_heads", "head_dim")},
    "mla": {"ckv": ("batch", "kv_seq", None)},
    "mamba": {"conv": ("batch", None, "mlp"), "ssm": ("batch", "mlp", None)},
    "mlstm": {"c": ("batch", "heads", None, None), "n": ("batch", "heads", None),
              "m": ("batch", "heads")},
    "slstm": {k: ("batch", None) for k in ("c", "n", "h", "m")},
}


def _cache_blocks(cfg: ModelConfig):
    """(path, spec, lead) of every block's cache: ``lead`` is 1 for a
    stacked one (its leading dimension the layer)."""
    out = [(("prefix", i), s, 0) for i, s in enumerate(cfg.prefix)]
    if cfg.n_repeats:
        out += [(("stack", f"b{j}"), s, 1) for j, s in enumerate(cfg.pattern)]
    return out


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def cache_axes(cfg: ModelConfig):
    """The decode cache's tree of :class:`LogicalAxes` (a stacked leaf's
    with "layers" first), as the JAX ``init_cache`` in axes mode."""
    cache: dict[str, Any] = {}
    if cfg.prefix:
        cache["prefix"] = []
    if cfg.n_repeats:
        cache["stack"] = {}
    for (where, key), spec, lead in _cache_blocks(cfg):
        mix = {k: LogicalAxes(("layers",) * lead + ax)
               for k, ax in _CACHE_AXES[spec.kind].items()}
        if where == "prefix":
            cache["prefix"].append({"mix": mix})
        else:
            cache["stack"][key] = {"mix": mix}
    return cache


# ---------------------------------------------------------------------------
# The layer stack over a mesh (params placed by build_step)
# ---------------------------------------------------------------------------

def maybe_constrain(x, ctx):
    """x's batch split over the data rows of ``ctx["mesh"]`` (the JAX
    package's activation sharding constraint): a list of row tensors, row
    i on ``mesh.device(i, 0)``; the whole batch on row 0 when the rows do
    not divide it; ``[x]`` without a mesh."""
    mesh = _mesh(ctx)
    if mesh is None:
        return [x]
    rows = _batch_rows(x.shape[0], mesh.shape["data"])
    return [x[b0:b1].to(mesh.device(i, 0))
            for i, (b0, b1) in enumerate(rows)]


def cache_split(layers: ShardedTree, cfg: ModelConfig) -> tuple:
    """Per block of the decode cache (``_cache_blocks`` order), whether the
    specs of the placed layer stack ``layers`` split the block's units
    over "model" (its query heads, or Mamba's inner channels): its cache
    then splits with them (:func:`shard_cache`)."""
    out = []
    for (where, key), spec, lead in _cache_blocks(cfg):
        sub, leaf = _UNIT_LEAF[spec.kind]
        out.append(_on_model(layers[where][key][sub].specs[leaf]))
    return tuple(out)


def default_cache_split(cfg: ModelConfig, model: int) -> tuple:
    """:func:`cache_split` of params placed by the default sharding rules
    over a model axis of ``model`` ranks: a block's units split where
    ``model`` divides their count."""
    def units(spec):
        if spec.kind == "attn":
            return cfg.n_heads
        if spec.kind == "mla":
            return cfg.mla.n_heads
        if spec.kind == "mamba":
            return cfg.mamba.d_inner
        return cfg.xlstm_cfg.n_heads
    return tuple(units(spec) % model == 0
                 for _, spec, _ in _cache_blocks(cfg))


def _cache_cut(cfg: ModelConfig, spec: BlockSpec, name: str, model: int,
               rank: int):
    """Where a split block's cache leaf ``name`` is cut for ``rank``: (the
    dimension after the batch's, lo, hi), or None for a whole copy."""
    if spec.kind == "attn":       # self or cross K / V: (B, S, Hkv, D)
        return (2, *kv_heads_of(cfg.n_heads, cfg.n_kv_heads, model, rank))
    if spec.kind == "mla":        # the row's whole latent on every rank
        return None
    if spec.kind == "mamba":      # conv (B, K-1, I), ssm (B, I, N)
        i = cfg.mamba.d_inner // model
        return (2 if name == "conv" else 1, rank * i, (rank + 1) * i)
    x = cfg.xlstm_cfg
    if spec.kind == "mlstm":      # c / n / m: heads first
        h = x.n_heads // model
        return (1, rank * h, (rank + 1) * h)
    w = x.d_model // model        # sLSTM (B, D): its heads' channels
    return (1, rank * w, (rank + 1) * w)


@dataclasses.dataclass
class ShardedCache:
    """The decode cache over a mesh: ``shards[i][r]`` is the cache tree of
    rank r of data row i, on ``mesh.device(i, r)``. Row i holds batch rows
    ``rows[i]``. ``split`` has a flag a block (:func:`cache_split`): a
    split block's cache is cut along the units its rank computes, in
    contiguous tensors of their own (the decode kernel reads a K / V as
    it is): a self- or cross-attention layer's K / V by the kv heads its
    query heads read (``layers.kv_heads_of``), Mamba's conv window and
    ssm state by channel, mLSTM's (C, n, m) by head, sLSTM's (c, n, h, m)
    by its heads' channels, and MLA's latent not at all: every rank of
    the row keeps its own copy of the whole latent. An unsplit block's
    leaves are held by rank 0 of the row only (None at the other ranks).
    ``index`` gives each held leaf's place in the whole cache (None for a
    latent copy past rank 0), which :meth:`gather` assembles."""

    mesh: object
    rows: list
    split: tuple
    shards: list
    index: list
    like: Any

    def gather(self):
        """The whole cache on ``mesh.device(0, 0)``."""
        dev = self.mesh.device(0, 0)
        flat_s = [s for row in self.shards for s in row]
        flat_i = [s for row in self.index for s in row]

        def build(like, *held):
            out = torch.empty(like.shape, dtype=like.dtype, device=dev)
            n = len(flat_s)
            for t, idx in zip(held[:n], held[n:]):
                if idx is not None:
                    out[idx] = t.to(dev)
            return out

        return map_tree(build, self.like, *flat_s, *flat_i)


def shard_cache(cfg: ModelConfig, cache, mesh, split) -> ShardedCache:
    """``cache`` (whole, any device) copied onto ``mesh`` as a
    :class:`ShardedCache`; ``split``: per cache block, whether the
    params' specs split its units over "model" (:func:`cache_split`)."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    split = tuple(split)
    path, _, lead = _cache_blocks(cfg)[0]
    batch = next(iter(_at(cache, path)["mix"].values())).shape[lead]
    rows = _batch_rows(batch, d)
    like = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), cache)
    shards = [[map_tree(lambda t: None, cache) for _ in range(m)]
              for _ in rows]
    index = [[map_tree(lambda t: None, cache) for _ in range(m)]
             for _ in rows]
    for (path, spec, lead), cut in zip(_cache_blocks(cfg), split):
        for name, t in _at(cache, path)["mix"].items():
            for i, (b0, b1) in enumerate(rows):
                for r in range(m if cut else 1):
                    idx = [slice(None)] * t.dim()
                    idx[lead] = slice(b0, b1)
                    at = _cache_cut(cfg, spec, name, m, r) if cut else None
                    if at is not None:
                        idx[lead + at[0]] = slice(at[1], at[2])
                    idx = tuple(idx)
                    part = t[idx]
                    own = torch.empty(part.shape, dtype=part.dtype,
                                      device=mesh.device(i, r))
                    _at(shards[i][r], path)["mix"][name] = own.copy_(part)
                    _at(index[i][r], path)["mix"][name] = \
                        idx if at is not None or r == 0 else None
    return ShardedCache(mesh, rows, split, shards, index, like)


def cross_caches(layers, cfg: ModelConfig, cache):
    """(layer params, layer cache, spec, split) of every cross-attention
    layer, a stacked one's as views. For a :class:`ShardedCache` the layer
    cache lists each data row's rank caches, and ``split`` is its block's
    flag; False for a whole cache."""
    blocks = _cache_blocks(cfg)
    flags = cache.split if isinstance(cache, ShardedCache) else \
        (False,) * len(blocks)
    for ((where, key), spec, lead), split in zip(blocks, flags):
        if not spec.cross:
            continue
        p = layers[where][key]
        if lead:
            yield from ((lp, lc, spec, split) for lp, lc in zip(
                layer_slices(p), _block_cache(cache, (where, key),
                                              cfg.n_repeats)))
        else:
            yield p, _block_cache(cache, (where, key)), spec, split
