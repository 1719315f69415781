"""stablelm-1.6b [dense] — 24L, d_model 2048, 32H (MHA kv=32), d_ff 5632,
vocab 100352 [hf:stabilityai/stablelm-2-1_6b].

LayerNorm + 25% partial rotary embeddings per the StableLM-2 recipe.
"""

from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=5632, vocab=100352,
        pattern=(BlockSpec(),), n_repeats=24,
        norm="layer", rope_fraction=0.25, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128,
        pattern=(BlockSpec(),), n_repeats=2,
        norm="layer", rope_fraction=0.25)
