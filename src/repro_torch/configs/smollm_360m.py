"""smollm-360m [dense] — 32L, d_model 960, 15H (GQA kv=5), d_ff 2560,
vocab 49152 [hf:HuggingFaceTB/SmolLM family]. Llama-arch small; tied
embeddings. 15 heads do not divide the 16-way model axis — the sharding
resolver degrades head sharding to replication (params.resolve_spec), and
this config is served data-parallel-only by design.
"""

from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab=49152,
        pattern=(BlockSpec(),), n_repeats=32,
        tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=128, vocab=128,
        pattern=(BlockSpec(),), n_repeats=2,
        tie_embeddings=True)
