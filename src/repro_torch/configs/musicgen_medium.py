"""musicgen-medium [audio] — 48L, d_model 1536, 24H (MHA), d_ff 6144,
vocab 2048 per codebook [arXiv:2306.05284].

Decoder-only over EnCodec tokens: 4 parallel codebooks with summed input
embeddings and 4 output heads (the delay-pattern interleaving is a data-
pipeline concern; the frontend is a stub providing token frames).
LayerNorm + GELU per the published config.
"""

from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048,
        pattern=(BlockSpec(),), n_repeats=48,
        norm="layer", mlp_kind="gelu",
        n_codebooks=4, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64,
        pattern=(BlockSpec(),), n_repeats=2,
        norm="layer", mlp_kind="gelu", n_codebooks=4)
