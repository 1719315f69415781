"""xlstm-1.3b [ssm] — 48 blocks, d_model 2048, 4 heads, vocab 50304.

sLSTM + mLSTM blocks at 1:7 (one sLSTM per 8-block group), per
[arXiv:2405.04517]. No separate FFN (d_ff = 0): the mLSTM block carries a
2x up-projection internally. Sub-quadratic: O(1) recurrent decode state ->
runs the long_500k cell.
"""

from repro_torch.models.transformer import BlockSpec, ModelConfig
from repro_torch.models.xlstm import XlstmConfig

_PATTERN = tuple([BlockSpec(kind="mlstm", mlp="none")] * 7
                 + [BlockSpec(kind="slstm", mlp="none")])


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
        d_ff=0, vocab=50304,
        pattern=_PATTERN, n_repeats=6,
        xlstm_cfg=XlstmConfig(d_model=2048, n_heads=4, proj_factor=2.0,
                              chunk_size=64),
        tie_embeddings=True, remat="dots", sub_quadratic=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=0, vocab=128,
        pattern=_PATTERN, n_repeats=1,
        xlstm_cfg=XlstmConfig(d_model=64, n_heads=2, proj_factor=2.0,
                              chunk_size=8),
        tie_embeddings=True, sub_quadratic=True)
