"""granite-moe-3b-a800m [moe] — 32L, d_model 1536, 24H (GQA kv=8),
40 experts top-8 with d_ff 512, vocab 49155
[hf:ibm-granite/granite-3.0-*-base family].

Tied embeddings and logit scaling per the Granite-3.0 recipe. 40 experts
are padded to 48 for the 16-way EP axis (the router masks the padding;
one device runs all 48 — repro_torch.models.moe).
"""

from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155,
        pattern=(BlockSpec(mlp="moe"),), n_repeats=32,
        moe=MoeConfig(d_model=1536, d_ff=512, n_experts=40, top_k=8, ep=16),
        tie_embeddings=True, logits_scale=6.0, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=128,
        pattern=(BlockSpec(mlp="moe"),), n_repeats=2,
        moe=MoeConfig(d_model=64, d_ff=32, n_experts=5, top_k=2),
        tie_embeddings=True, logits_scale=6.0)
