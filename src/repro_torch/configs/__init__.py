"""Config registry: ``--arch <id>`` resolution for the assigned
architectures (the same ids as the JAX package), plus the paper's own
VGG19/SegNet deformable networks (``get_dcn_config``).

The port runs every one of them: the dense-attention archs, the MoE /
MLA ones (granite-moe, deepseek-v3), the recurrent ones (jamba's Mamba
layers, xlstm's mLSTM / sLSTM) and llama-3.2-vision, whose cross-attention
layers read precomputed image states (``batch["cross_states"]``).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, SMOKE_SHAPES, ShapeCell,
                                      cell_supported)
from repro_torch.models.dcn_models import DcnNetConfig

_ARCH_MODULES = {
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
}

ARCHS = tuple(_ARCH_MODULES)
SUPPORTED_ARCHS = ARCHS


def get_config(arch: str, smoke: bool = False):
    """Resolve an --arch id to its ModelConfig."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.smoke() if smoke else mod.full()


# The paper's own networks (Table III), selectable like any other arch.
def get_dcn_config(name: str, n_deform: int, variant: str = "dcn2",
                   smoke: bool = False) -> DcnNetConfig:
    if smoke:
        return DcnNetConfig(name=name, n_deform=n_deform, variant=variant,
                            img_size=32, width_mult=0.125, num_classes=10)
    return DcnNetConfig(name=name, n_deform=n_deform, variant=variant,
                        img_size=224, num_classes=1000)


__all__ = ["ARCHS", "SHAPES", "SMOKE_SHAPES", "SUPPORTED_ARCHS", "ShapeCell",
           "cell_supported", "get_config", "get_dcn_config"]
