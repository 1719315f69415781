"""llama-3.2-vision-11b [vlm] — 40L, d_model 4096, 32H (GQA kv=8),
d_ff 14336, vocab 128256 [hf:meta-llama/Llama-3.2-11B-Vision].

Cross-attention image layers every 5th layer (position 3 of each period-5
group, matching the published layer ids 3, 8, 13, ...). The modality
frontend is a stub: the model consumes precomputed patch embeddings
(B, 1601, d_cross) through its cross-attention layers, which take their
K/V from those states and apply no rotary embedding. 9,775,157,248
params (39.1 GB in float32, untied embeddings): one 80 GB card holds the
text model whole.
"""

from repro_torch.models.transformer import BlockSpec, ModelConfig

_PATTERN = (BlockSpec(), BlockSpec(), BlockSpec(),
            BlockSpec(cross=True), BlockSpec())


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256,
        pattern=_PATTERN, n_repeats=8,
        rope_theta=500000.0,
        d_cross=4096, n_cross_tokens=1601,
        remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128,
        pattern=_PATTERN, n_repeats=1,
        d_cross=32, n_cross_tokens=17)
