"""jamba-v0.1-52b [hybrid] — 32L, d_model 4096, 32H (GQA kv=8),
d_ff 14336, vocab 65536, MoE 16 experts top-2 [arXiv:2403.19887].

Mamba:attention at 7:1 (attention at position 4 of each period-8 group),
MoE on every second layer (odd positions). Sub-quadratic decode: 28 mamba
layers carry O(1) state; only 4 attention layers keep a KV cache. 51.6 B
params in all (206 GB in float32), so one 80 GB card holds one period
(``n_repeats=1``, 13.3 B params), not the model.
"""

from repro_torch.models.moe import MoeConfig
from repro_torch.models.ssm import MambaConfig
from repro_torch.models.transformer import BlockSpec, ModelConfig


def _pattern():
    out = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        out.append(BlockSpec(kind=kind, mlp=mlp))
    return tuple(out)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        pattern=_pattern(), n_repeats=4,
        moe=MoeConfig(d_model=4096, d_ff=14336, n_experts=16, top_k=2,
                      ep=16),
        mamba=MambaConfig(d_model=4096, expand=2, d_state=16, d_conv=4,
                          chunk_size=256),
        remat="dots", sub_quadratic=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128,
        pattern=_pattern(), n_repeats=1,
        moe=MoeConfig(d_model=64, d_ff=32, n_experts=4, top_k=2),
        mamba=MambaConfig(d_model=64, chunk_size=8),
        sub_quadratic=True)
