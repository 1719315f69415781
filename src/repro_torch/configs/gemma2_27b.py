"""gemma2-27b [dense] — 46L, d_model 4608, 32H (GQA kv=16), d_ff 36864,
vocab 256000 [arXiv:2408.00118].

Local(4096-window)/global alternating attention, attn-logit softcap 50,
final-logit softcap 30, sandwich (pre+post) norms, GeGLU, sqrt(d) input
embedding scaling. head_dim = d_model/n_heads = 144 per the assigned spec.
"""

from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        d_model=4608, n_heads=32, n_kv_heads=16, head_dim=144,
        d_ff=36864, vocab=256000,
        pattern=(BlockSpec(window=4096), BlockSpec()), n_repeats=23,
        mlp_kind="geglu", sandwich_norm=True, emb_scale=True,
        attn_softcap=50.0, final_softcap=30.0,
        tie_embeddings=True, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=128,
        pattern=(BlockSpec(window=8), BlockSpec()), n_repeats=1,
        mlp_kind="geglu", sandwich_norm=True, emb_scale=True,
        attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True)
