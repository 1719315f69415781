"""deepseek-v3-671b [moe] — 61L, d_model 7168, 128 heads, vocab 129280
[arXiv:2412.19437].

MLA (q_lora 1536 / kv_lora 512, 128-d nope + 64-d rope per head), 3 dense
prefix layers (d_ff 18432) + 58 MoE layers with 1 shared + 256 routed
experts (d_ff 2048), top-8 sigmoid aux-loss-free router with
routed_scaling_factor 2.5, and depth-1 MTP. The JAX package shards the
expert weights over a mesh; one device holds all 256
(repro_torch.models.moe).
"""

from repro_torch.models.layers import MlaConfig
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=18432, vocab=129280,
        prefix=(BlockSpec(kind="mla"),) * 3,
        pattern=(BlockSpec(kind="mla", mlp="moe"),), n_repeats=58,
        mla=MlaConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, d_nope=128, d_rope=64, d_v=128),
        moe=MoeConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                      n_shared=1, router="sigmoid", routed_scale=2.5,
                      ep=16),
        mtp=True, rope_theta=10000.0, remat="dots")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128,
        prefix=(BlockSpec(kind="mla"),),
        pattern=(BlockSpec(kind="mla", mlp="moe"),), n_repeats=2,
        mla=MlaConfig(d_model=64, n_heads=4, q_lora_rank=32,
                      kv_lora_rank=16, d_nope=16, d_rope=8, d_v=16),
        moe=MoeConfig(d_model=64, d_ff=32, n_experts=8, top_k=2,
                      n_shared=1, router="sigmoid"),
        mtp=True)
