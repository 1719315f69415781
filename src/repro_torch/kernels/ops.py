"""Public wrappers around the BLI and fused kernels.

They handle layout (coords -> flat 4-neighbour indices + Eq. 5
coefficients), padding to the kernels' pixel blocks, and batching (the
JAX package's ``vmap`` over images is a leading batch dimension of the
kernel's grid here: one launch per call), so callers see plain NHWC
tensors. The numerics oracle is ``core.deform``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.deform import (DeformableConvParams, bli_coefficients,
                                     conv2d, offsets_to_coords)
from repro_torch.kernels.dcn_bli import bli_tile_matmul
from repro_torch.kernels.dcn_fused import dcn_fused_tile


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def coords_to_idx_coeff(coords: torch.Tensor, h: int, w: int):
    """(..., 2) float coords -> flat 4-neighbour idx int32 + coeffs
    float32, each (..., 4), in the order (r0,c0) (r0,c1) (r1,c0) (r1,c1)
    of Eq. 5 (eta, theta, mu, gamma)."""
    floor_rc, coeffs = bli_coefficients(coords)
    r0 = floor_rc[..., 0].clamp(0, h - 1)
    c0 = floor_rc[..., 1].clamp(0, w - 1)
    r1 = (r0 + 1).clamp(0, h - 1)
    c1 = (c0 + 1).clamp(0, w - 1)
    idx = torch.stack([r0 * w + c0, r0 * w + c1, r1 * w + c0, r1 * w + c1],
                      dim=-1).to(torch.int32)
    return idx, coeffs.float()


def bli_pallas(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Stage 2 (Eq. 2) through the BLI kernel.

    x: (N, H, W, C) float32, bfloat16 or float16; coords: (N, H, W, KK,
    2) -> (N, H, W, KK, C) in x's dtype (the coefficients stay float32).
    """
    n, h, w, c = x.shape
    kk = coords.shape[3]
    idx, coeff = coords_to_idx_coeff(coords, h, w)
    p = h * w * kk
    p_pad = round_up(p, 128)
    c_pad = round_up(c, 128)
    x_flat = x.reshape(n, h * w, c)
    if c_pad != c:
        x_flat = F.pad(x_flat, (0, c_pad - c))
    idx_f = F.pad(idx.reshape(n, p, 4), (0, 0, 0, p_pad - p))
    coeff_f = F.pad(coeff.reshape(n, p, 4), (0, 0, 0, p_pad - p))
    out = bli_tile_matmul(x_flat.contiguous(), idx_f.contiguous(),
                          coeff_f.contiguous())           # (N, P_pad, C_pad)
    return out[:, :p, :c].reshape(n, h, w, kk, c)


def deformable_conv2d_pallas(x: torch.Tensor, params: DeformableConvParams,
                             *, kernel_size: int = 3, variant: str = "dcn2",
                             max_displacement: float | None = None
                             ) -> torch.Tensor:
    """Full deformable conv: library stage-1 conv + the fused kernel for
    stages 2+3, the whole plane as one tile (S = H*W) per image and all
    images in one launch."""
    n, h, w, c = x.shape
    o = params.w.shape[-1]
    kk = kernel_size * kernel_size
    offsets = conv2d(x, params.w_off, params.b_off)                  # Eq. 1
    coords = offsets_to_coords(offsets.float(), kernel_size, variant,
                               max_displacement)
    idx, coeff = coords_to_idx_coeff(coords, h, w)       # (N,H,W,KK,4)
    p = h * w
    p_pad = round_up(p, 128)
    idx_f = F.pad(idx.reshape(n, p, kk, 4), (0, 0, 0, 0, 0, p_pad - p))
    coeff_f = F.pad(coeff.reshape(n, p, kk, 4), (0, 0, 0, 0, 0, p_pad - p))
    out = dcn_fused_tile(x.reshape(n, p, c).contiguous(),
                         idx_f.contiguous(), coeff_f.contiguous(),
                         params.w.reshape(kk, c, o).contiguous(),
                         params.b.contiguous())          # (N, P_pad, O)
    return out[:, :p].reshape(n, h, w, o)
