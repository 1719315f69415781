"""int8 quantization with a per-tensor scale, and the error-feedback
state of the compressed data-parallel all-reduce.

``quantize``/``dequantize`` are the reference int8 fixed-point ops of the
paper's 8-bit PE evaluation (Table I) and the payload codec of the
compressed gradient all-reduce. That all-reduce itself
(``compressed_psum_tree`` in the JAX package) needs a cross-replica sum
and comes with data-parallel training (ROADMAP.md §1).
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 values, fp32 scale). Symmetric per-tensor."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
