"""Language model: embeddings, layer stack, heads, the training loss,
prefill and the decode step.

Entry points:

  init_lm(cfg, seed, device=)                 params (``device="meta"``:
                                              shapes only)
  make_lm(mk, cfg)                            the same tree from any Maker
  lm_loss(params, cfg, batch)                 -> (loss, metrics)
  lm_prefill(params, cfg, batch)              last-position logits
  init_cache(cfg, batch, max_len, ...)        the decode cache
  build_cross_cache(params, cfg, cache, states) the cross layers' K/V
  lm_decode_step(params, cfg, cache, token, pos) -> (logits, cache)

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
from repro_torch.models.layers import make_norm
from repro_torch.models.params import Maker, make_generator
from repro_torch.models.transformer import (BlockSpec, ModelConfig,
                                            apply_layers_decode,
                                            apply_layers_train, block_train,
                                            init_block, init_layer_caches,
                                            init_layers, layer_slices)


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


def _embed(p, cfg: ModelConfig, tokens):
    """tokens: (B, S) int or (B, S, n_cb) -> (B, S, D)."""
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


def _logits(p, cfg: ModelConfig, x):
    """x: (..., D) -> (..., n_cb, V) fp32."""
    if cfg.tie_embeddings:
        heads = [p["embed"][c].t() for c in range(cfg.n_codebooks)]
    else:
        heads = [p["head"][c] for c in range(cfg.n_codebooks)]
    logits = torch.stack([torch.matmul(x, w.to(x.dtype)) for w in heads],
                         dim=-2).float()
    if cfg.logits_scale is not None:
        logits = logits / cfg.logits_scale
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _xent(logits, labels):
    """logits (..., V) fp32, labels (...) int -> mean cross-entropy."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return torch.mean(lse - gold)


def lm_loss(p, cfg: ModelConfig, batch):
    """batch: {"tokens": (B, S+1[, n_cb]) int, optional "cross_states"
    (B, S_kv, d_cross): data, not a parameter}. -> (loss, {"ce", "aux",
    ["mtp",] "loss"}): next-token cross-entropy averaged over all positions
    (and codebooks), plus ``aux_weight`` times the MoE blocks' auxiliary
    term (MoE configs) and ``mtp_weight`` times the MTP loss (``cfg.mtp``:
    the trunk state at position i with the embedding of token i+1
    predicts token i+2)."""
    tokens, cross = batch["tokens"], batch.get("cross_states")
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x, aux = apply_layers_train(p["layers"], cfg, _embed(p, cfg, inputs),
                                cross_states=cross)
    _, norm = make_norm(cfg.norm)
    logits = _logits(p, cfg, norm(p["final_norm"], x))   # (B, S, n_cb, V)
    if cfg.n_codebooks == 1:
        lab = labels if labels.dim() == 2 else labels[..., 0]
        loss = _xent(logits[..., 0, :], lab)
    else:
        loss = _xent(logits, labels)                     # labels (B,S,n_cb)
    metrics = {"ce": loss, "aux": aux}
    if cfg.moe is not None:
        loss = loss + cfg.aux_weight * aux

    if cfg.mtp:
        mtp = p["mtp"]
        h_in = norm(mtp["norm_h"], x[:, :-1])                # (B, S-1, D)
        e_in = norm(mtp["norm_e"], _embed(p, cfg, inputs[:, 1:]))
        h = torch.matmul(torch.cat([h_in, e_in], -1),
                         mtp["proj"].to(x.dtype))
        h, _ = block_train(mtp["block"], cfg, _mtp_spec(cfg), h,
                           cross_states=cross)
        mtp_logits = _logits(p, cfg, norm(p["final_norm"], h))
        lab2 = labels[:, 1:] if labels.dim() == 2 else labels[:, 1:, 0]
        mtp_loss = _xent(mtp_logits[..., 0, :], lab2)
        metrics["mtp"] = mtp_loss
        loss = loss + cfg.mtp_weight * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def lm_prefill(p, cfg: ModelConfig, batch):
    """Forward the full prompt ``batch["tokens"]`` (B, S[, n_cb]) and return
    the last position's logits (B, n_cb, V); a cross-attention model reads
    ``batch["cross_states"]``. With ``cfg.use_flash`` every attention layer
    runs the flash kernel (a cross layer non-causally). Prefill is
    inference: it runs under ``torch.no_grad()``, so ``cfg.remat`` and the
    recurrent blocks' chunk checkpoints (training only) keep no
    activations here."""
    x = _embed(p, cfg, batch["tokens"])
    x, _ = apply_layers_train(p["layers"], cfg, x,
                              cross_states=batch.get("cross_states"))
    _, norm = make_norm(cfg.norm)
    x = norm(p["final_norm"], x[:, -1])
    return _logits(p, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda"):
    return init_layer_caches(cfg, batch, max_len, dtype=dtype,
                             device=resolve_device(device))


@torch.no_grad()
def build_cross_cache(p, cfg: ModelConfig, cache, cross_states):
    """Write each cross layer's K/V of ``cross_states`` (B, n_cross_tokens,
    d_cross) into ``cache`` in place (cast to the cache's dtype; a stacked
    layer through its ``layer_slices`` view) and return the cache. Row i
    of the states is batch slot i's image; no decode step writes these
    caches. As the JAX function, it applies no ``k_norm``."""
    def fill(layer_p, layer_c):
        ap = layer_p["attn"]
        for name, w in (("k", ap["wk"]), ("v", ap["wv"])):
            kv = torch.einsum("bsd,dhk->bshk", cross_states,
                              w.to(cross_states.dtype))
            layer_c["mix"][name].copy_(kv)

    layers = p["layers"]
    for i, spec in enumerate(cfg.prefix):
        if spec.cross:
            fill(layers["prefix"][i], cache["prefix"][i])
    for j, spec in enumerate(cfg.pattern if cfg.n_repeats else ()):
        if spec.cross:
            for lp, lc in zip(layer_slices(layers["stack"][f"b{j}"]),
                              layer_slices(cache["stack"][f"b{j}"])):
                fill(lp, lc)
    return cache


def lm_decode_step(p, cfg: ModelConfig, cache, token, pos):
    """One decode step; ``cache`` is updated in place.

    token: (B, 1) or (B, 1, n_cb) int; pos: (B,) int current position.
    -> (logits (B, n_cb, V) fp32, cache)
    """
    x = _embed(p, cfg, token)
    x, cache = apply_layers_decode(p["layers"], cfg, x, cache, pos)
    _, norm = make_norm(cfg.norm)
    x = norm(p["final_norm"], x[:, -1])
    return _logits(p, cfg, x), cache
