"""qwen3-1.7b [dense] — 28L, d_model 2048, 16H (GQA kv=8), d_ff 6144,
vocab 151936 [hf:Qwen/Qwen3 family]. qk-norm on every attention layer."""

from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab=151936,
        pattern=(BlockSpec(),), n_repeats=28,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128,
        pattern=(BlockSpec(),), n_repeats=2,
        qk_norm=True, tie_embeddings=True)
