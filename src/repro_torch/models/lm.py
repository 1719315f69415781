"""Language model: embeddings, layer stack, heads, the training loss,
prefill and the decode step.

Entry points:

  init_lm(cfg, seed, device=)                 params (``device="meta"``:
                                              shapes only)
  make_lm(mk, cfg)                            the same tree from any Maker
  lm_loss(params, cfg, batch, ctx)            -> (loss, metrics)
  lm_prefill(params, cfg, batch, ctx)         last-position logits
  init_cache(cfg, batch, max_len, ...)        the decode cache
  build_cross_cache(params, cfg, cache, states) the cross layers' K/V
  lm_decode_step(params, cfg, cache, token, pos, ctx) -> (logits, cache)

``ctx`` is the JAX package's dict: ``{"mesh": DeviceMesh}`` runs the MoE
blocks expert-parallel over the mesh. Params placed on a mesh (a
``ShardedTree``, ``launch.steps.build_step``) run tensor-parallel
(``models.transformer``): the batch splits over the data rows, the
embedding and the logits are vocab-parallel where the specs split the
vocabulary (a rank looks up only its rows, masking the tokens outside
them, and the lookups are summed; each rank's logits slice is gathered),
an FSDP-split d_model is gathered onto the row's device at its use, and
the logits are assembled on ``mesh.device(0, 0)``. Decode then reads a
``transformer.ShardedCache`` (``init_cache(mesh=)``). ``lm_loss`` of
placed params takes each data row's cross-entropy on the row's device
and averages them by token count on ``mesh.device(0, 0)``; its gradient
with respect to every held slice is ``launch.steps.value_and_grad_placed``.

Multi-codebook tokens (musicgen), tied embeddings, ``emb_scale``,
``logits_scale`` and the final soft-cap follow the JAX package. The tied
logits product (d_model x vocab) is a ``torch.matmul``, as the JAX package
leaves it to XLA. The loss adds the MoE auxiliary term and deepseek-v3's
depth-1 multi-token prediction (MTP) as the JAX package does; serving
never runs the MTP block, but ``init_lm`` builds it. The decode cache
holds a KV cache for each attention layer, a latent cache for each MLA
layer and O(1) recurrent state for each Mamba, mLSTM and sLSTM layer
(``transformer.init_block_cache``); ``lm_decode_step`` updates all of
them in place. A cross-attention model (llama-3.2-vision) reads image
states: ``lm_loss`` and ``lm_prefill`` take them as
``batch["cross_states"]`` (B, n_cross_tokens, d_cross), and decode reads
the cross layers' K/V of them, which ``build_cross_cache`` writes into the
cache once and no step changes.

A bf16 model: ``init_lm(cfg, seed, dtype=torch.bfloat16)`` builds bf16
params (as the JAX package's ``Maker("init", key, jnp.bfloat16)``), and
every activation then flows in bf16 as the JAX package's do (norms, rotary
embeddings, softmaxes and the MoE combine in float32, cast back); feed
bf16 ``cross_states`` to a bf16 model. The decode cache's dtype is
``init_cache(dtype=)`` (bf16 by default, as in the JAX package), free of
the params' dtype. On a card the flash kernels take float32 or bf16
operands and return the query's dtype: a bf16 prefill runs #7 on bf16
operands, and decode hands #8 each cache as it is stored. Logits come back
float32.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models.layers import cross_kv, make_norm
from repro_torch.models.params import Maker, ShardedTree, make_generator
from repro_torch.models.transformer import (BlockSpec, ModelConfig,
                                            ShardedCache,
                                            apply_layers_decode,
                                            apply_layers_train, block_train,
                                            cross_caches,
                                            default_cache_split, init_block,
                                            init_layer_caches, init_layers,
                                            maybe_constrain, shard_cache)


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
            dtype=torch.float32):
    """Random params of ``cfg`` from ``seed`` on ``device``."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
    return make_lm(Maker(make_generator(seed, dev), device=dev, dtype=dtype),
                   cfg)


def _mtp_spec(cfg: ModelConfig) -> BlockSpec:
    return BlockSpec(kind="mla" if cfg.mla else "attn", mlp="dense")


def make_lm(mk: Maker, cfg: ModelConfig):
    """The LM's parameter tree, each leaf from ``mk`` (the JAX package's
    ``init_lm(mk, cfg)``)."""
    init_norm, _ = make_norm(cfg.norm)
    p: dict[str, Any] = {
        "embed": mk((cfg.n_codebooks, cfg.vocab, cfg.d_model),
                    (None, "vocab", "embed"), init="normal", scale=0.02),
        "layers": init_layers(mk, cfg),
        "final_norm": init_norm(mk, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["head"] = mk((cfg.n_codebooks, cfg.d_model, cfg.vocab),
                       (None, "embed", "vocab"), init="fan_in")
    if cfg.mtp:
        p["mtp"] = {
            "proj": mk((2 * cfg.d_model, cfg.d_model), ("embed", None),
                       init="fan_in"),
            "norm_h": init_norm(mk, cfg.d_model),
            "norm_e": init_norm(mk, cfg.d_model),
            "block": init_block(mk, cfg, _mtp_spec(cfg)),
        }
    return p


def _rows(p, t):
    """``t`` split into the data rows of the mesh ``p`` is placed on
    (``transformer.maybe_constrain``); ``t`` itself for params that are
    not placed, or None."""
    if t is None or not isinstance(p, ShardedTree):
        return t
    return maybe_constrain(t, {"mesh": p.mesh})


def _embed(p, cfg: ModelConfig, tokens):
    """tokens: (B, S) int or (B, S, n_cb) -> (B, S, D); of params placed
    on a mesh, the list of its data rows' embeddings."""
    if isinstance(p, ShardedTree):
        return [_embed_row(p, cfg, t, i)
                for i, t in enumerate(_rows(p, tokens))]
    table = p["embed"]
    tokens = tokens.long()
    if cfg.n_codebooks == 1:
        if tokens.dim() == 3:
            tokens = tokens[..., 0]
        x = table[0][tokens]
    else:
        x = sum(table[c][tokens[..., c]] for c in range(cfg.n_codebooks))
    if cfg.emb_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _embed_row(p: ShardedTree, cfg: ModelConfig, tokens, i: int):
    """Row i's embedding, vocab-parallel where the spec splits the
    vocabulary: rank r looks up the tokens in its rows and zeroes the
    others, and the lookups are summed onto the row's device."""
    emb = p["embed"]
    m = emb.mesh.shape["model"]
    split = emb.specs[1] == "model"
    tokens = tokens.long()
    if cfg.n_codebooks == 1 and tokens.dim() == 3:
        tokens = tokens[..., 0]
    out = None
    for r in range(m if split else 1):
        table = emb.local(i, r)                      # (n_cb, V_r, D)
        vr = table.shape[1]
        t = tokens.to(table.device) - r * vr
        valid = (t >= 0) & (t < vr)
        t = t.clamp(0, vr - 1)
        if cfg.n_codebooks == 1:
            x = table[0][t] * valid[..., None]
        else:
            x = sum(table[c][t[..., c]] * valid[..., c, None]
                    for c in range(cfg.n_codebooks))
        x = x.to(tokens.device)
        out = x if out is None else out + x
    if cfg.emb_scale:
        out = out * math.sqrt(cfg.d_model)
    return out


def _finish_logits(cfg: ModelConfig, logits):
    logits = logits.float()
    if cfg.logits_scale is not None:
        logits = logits / cfg.logits_scale
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _rowwise(p, f, leaf, *xs):
    """f(leaf, *xs); of params placed on a mesh, the xs list the data
    rows, and row i reads its own copy of ``leaf`` (``whole(i)``)."""
    if isinstance(p, ShardedTree):
        return [f(leaf.whole(i), *r) for i, r in enumerate(zip(*xs))]
    return f(leaf, *xs)


def _as_rows(x) -> list:
    """A list of data rows: ``x`` itself, or ``[x]`` for one tensor."""
    return x if isinstance(x, list) else [x]


def _logits(p, cfg: ModelConfig, x):
    """x: (..., D) -> (..., n_cb, V) fp32. Of params placed on a mesh, x
    lists the data rows and so does the result, each row's logits on the
    row's device, vocab-parallel where the spec splits the vocabulary:
    each rank's slice is gathered there."""
    tied = cfg.tie_embeddings
    if not isinstance(p, ShardedTree):
        if tied:
            heads = [p["embed"][c].t() for c in range(cfg.n_codebooks)]
        else:
            heads = [p["head"][c] for c in range(cfg.n_codebooks)]
        return _finish_logits(cfg, torch.stack(
            [torch.matmul(x, w.to(x.dtype)) for w in heads], dim=-2))
    w = p["embed"] if tied else p["head"]
    mesh = w.mesh
    split = w.specs[1 if tied else 2] == "model"
    rows = []
    for i, xi in enumerate(x):
        parts = []
        for r in range(mesh.shape["model"] if split else 1):
            t = w.local(i, r)
            xr = xi.to(t.device)
            heads = [t[c].t() if tied else t[c]
                     for c in range(cfg.n_codebooks)]
            parts.append(torch.stack([torch.matmul(xr, h.to(xr.dtype))
                                      for h in heads], dim=-2).to(xi.device))
        rows.append(_finish_logits(cfg, torch.cat(parts, dim=-1)))
    return rows


def _xent(logits, labels):
    """logits (..., V) fp32, labels (...) int -> mean cross-entropy."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return torch.mean(lse - gold)


def _xent_rows(logits: list, labels: list):
    """The mean cross-entropy over every data row's positions, on the
    first row's device: each row's mean weighted by its share of the
    labels, so that a split of the batch gives the whole batch's mean
    (and one row its own mean)."""
    n = sum(lab.numel() for lab in labels)
    out = logits[0].device
    terms = [_xent(lg, lab).to(out) * (lab.numel() / n)
             for lg, lab in zip(logits, labels)]
    return sum(terms[1:], terms[0])


def lm_loss(p, cfg: ModelConfig, batch, ctx=None):
    """batch: {"tokens": (B, S+1[, n_cb]) int, optional "cross_states"
    (B, S_kv, d_cross): data, not a parameter}. -> (loss, {"ce", "aux",
    ["mtp",] "loss"}): next-token cross-entropy averaged over all positions
    (and codebooks), plus ``aux_weight`` times the MoE blocks' auxiliary
    term (MoE configs) and ``mtp_weight`` times the MTP loss (``cfg.mtp``:
    the trunk state at position i with the embedding of token i+1
    predicts token i+2). ``ctx`` as in ``lm_prefill``. ``p`` placed on a
    mesh runs over it: each data row's cross-entropy on the row's
    device, averaged by token count on ``mesh.device(0, 0)``; the MoE
    ``aux`` is the rows' mean (the JAX ``pmean``)."""
    tokens, cross = batch["tokens"], _rows(p, batch.get("cross_states"))
    inputs = tokens[:, :-1]
    labels = _as_rows(_rows(p, tokens[:, 1:]))
    x, aux = apply_layers_train(p["layers"], cfg, _embed(p, cfg, inputs),
                                cross_states=cross, ctx=ctx)
    _, norm = make_norm(cfg.norm)
    fin = p["final_norm"]
    logits = _as_rows(_logits(p, cfg, _rowwise(p, norm, fin, x)))
    if cfg.n_codebooks == 1:                         # (B_i, S, n_cb, V)
        loss = _xent_rows([lg[..., 0, :] for lg in logits],
                          [lab if lab.dim() == 2 else lab[..., 0]
                           for lab in labels])
    else:
        loss = _xent_rows(logits, labels)            # labels (B_i, S, n_cb)
    aux = aux.to(loss.device)
    metrics = {"ce": loss, "aux": aux}
    if cfg.moe is not None:
        loss = loss + cfg.aux_weight * aux

    if cfg.mtp:
        mtp = p["mtp"]
        h_in = _rowwise(p, lambda w, r: norm(w, r[:, :-1]), mtp["norm_h"],
                        x)                                  # (B, S-1, D)
        e_in = _rowwise(p, norm, mtp["norm_e"],
                        _embed(p, cfg, inputs[:, 1:]))
        h = _rowwise(p, lambda w, a, b: torch.matmul(torch.cat([a, b], -1),
                                                     w.to(a.dtype)),
                     mtp["proj"], h_in, e_in)
        h, _ = block_train(mtp["block"], cfg, _mtp_spec(cfg), h,
                           cross_states=cross, ctx=ctx)
        mtp_logits = _as_rows(_logits(p, cfg, _rowwise(p, norm, fin, h)))
        mtp_loss = _xent_rows([lg[..., 0, :] for lg in mtp_logits],
                              [lab[:, 1:] if lab.dim() == 2 else
                               lab[:, 1:, 0] for lab in labels])
        metrics["mtp"] = mtp_loss
        loss = loss + cfg.mtp_weight * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def _next_logits(p, cfg: ModelConfig, x):
    """The logits (B, n_cb, V) of x's last position after the final norm;
    of params placed on a mesh, the data rows' assembled on
    ``mesh.device(0, 0)``."""
    _, norm = make_norm(cfg.norm)
    logits = _logits(p, cfg, _rowwise(p, lambda w, r: norm(w, r[:, -1]),
                                      p["final_norm"], x))
    if not isinstance(p, ShardedTree):
        return logits
    out = p.mesh.device(0, 0)
    return torch.cat([r.to(out) for r in logits], 0)


@torch.no_grad()
def lm_prefill(p, cfg: ModelConfig, batch, ctx=None):
    """Forward the full prompt ``batch["tokens"]`` (B, S[, n_cb]) and return
    the last position's logits (B, n_cb, V); a cross-attention model reads
    ``batch["cross_states"]``. With ``cfg.use_flash`` every attention layer
    runs the flash kernel (a cross layer non-causally). Prefill is
    inference: it runs under ``torch.no_grad()``, so ``cfg.remat`` and the
    recurrent blocks' chunk checkpoints (training only) keep no
    activations here. ``p`` placed on a mesh runs tensor-parallel (module
    docstring)."""
    x = _embed(p, cfg, batch["tokens"])
    x, _ = apply_layers_train(p["layers"], cfg, x, ctx=ctx,
                              cross_states=_rows(p, batch.get(
                                  "cross_states")))
    return _next_logits(p, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", mesh=None):
    """The decode cache on ``device``; with a ``mesh``, a
    ``ShardedCache`` over it, each block split over "model" as the
    default sharding rules split its units (``default_cache_split``:
    where the model size divides them)."""
    if mesh is None:
        return init_layer_caches(cfg, batch, max_len, dtype=dtype,
                                 device=resolve_device(device))
    whole = init_layer_caches(cfg, batch, max_len, dtype=dtype,
                              device=mesh.device(0, 0))
    return shard_cache(cfg, whole, mesh,
                       default_cache_split(cfg, mesh.shape["model"]))


@torch.no_grad()
def build_cross_cache(p, cfg: ModelConfig, cache, cross_states):
    """Write each cross layer's K/V of ``cross_states`` (B, n_cross_tokens,
    d_cross) into ``cache`` in place (cast to the cache's dtype; a stacked
    layer through its ``layer_slices`` view) and return the cache. Row i
    of the states is batch slot i's image; no decode step writes these
    caches. As the JAX function, it applies no ``k_norm``.

    With params placed on a mesh and a ``ShardedCache``, each rank of a
    data row fills its own cross K/V (the kv heads its query heads read,
    where the layer splits) from its own ``wk`` / ``wv`` slice and the
    row's states."""
    sharded = isinstance(cache, ShardedCache)
    if sharded != isinstance(p, ShardedTree):
        raise ValueError("build_cross_cache takes whole params with a whole "
                         "cache, or params placed on a mesh with a "
                         "ShardedCache")
    for lp, lc, spec, split in cross_caches(p["layers"], cfg, cache):
        acfg = cfg.attn_cfg(spec)
        if not sharded:
            for name, kv in zip("kv", cross_kv(lp["attn"], acfg,
                                               cross_states)):
                lc["mix"][name].copy_(kv)
            continue
        m = cache.mesh.shape["model"] if split else 1
        for i, (b0, b1) in enumerate(cache.rows):
            for r in range(m):               # an unsplit layer: rank 0's
                c = lc[i][r]["mix"]
                kvs = cross_kv(lp["attn"].local(i, r), acfg,
                               cross_states[b0:b1].to(c["k"].device), r, m)
                for name, kv in zip("kv", kvs):
                    c[name].copy_(kv)
    return cache


def lm_decode_step(p, cfg: ModelConfig, cache, token, pos, ctx=None):
    """One decode step; ``cache`` is updated in place.

    token: (B, 1) or (B, 1, n_cb) int; pos: (B,) int current position.
    -> (logits (B, n_cb, V) fp32, cache). ``p`` placed on a mesh runs
    tensor-parallel against the ``ShardedCache`` ``cache``."""
    x = _embed(p, cfg, token)
    x, cache = apply_layers_decode(p["layers"], cfg, x, cache,
                                   _rows(p, pos), ctx)
    return _next_logits(p, cfg, x), cache
