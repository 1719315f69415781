"""Unified deformable-convolution model (paper §II-B, Eq. 1-3), in torch.

The port's algorithmic reference: the CUDA kernels in
``repro_torch.kernels`` compute stages 2+3 and are held against these
functions on the card. Layouts follow the JAX package at the public
functions: NHWC activations, HWIO weights, coordinates as (row, col).

  stage 1  offset convolution  -> non-integer sampling coordinates  (Eq. 1)
  stage 2  bilinear interpolation (BLI) at those coordinates        (Eq. 2)
  stage 3  standard convolution over the deformed features          (Eq. 3)

DCN-I has one (alpha, beta) pair per plane position (offsets (N,H,W,2));
DCN-II one pair per tap per position (offsets (N,H,W,2*K*K)).
Out-of-range coordinates are clamped to the valid feature extent; an
optional ``max_displacement`` clamps the offset magnitude.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class DeformableConvParams(NamedTuple):
    """Parameters of one deformable convolution (stages 1+3)."""

    w_off: torch.Tensor  # (K, K, C_in, L)  offset-conv weights   (Eq. 1)
    b_off: torch.Tensor  # (L,)             offset-conv bias
    w: torch.Tensor      # (K, K, C_in, C_out) main conv weights  (Eq. 3)
    b: torch.Tensor      # (C_out,)         main conv bias


def offset_channels(kernel_size: int, variant: str) -> int:
    """Number of offset channels L produced by stage 1."""
    if variant == "dcn1":
        return 2
    if variant == "dcn2":
        return 2 * kernel_size * kernel_size
    raise ValueError(f"unknown DCN variant: {variant!r}")


def init_deformable_conv(generator: torch.Generator, c_in: int, c_out: int,
                         kernel_size: int = 3, variant: str = "dcn2",
                         dtype=torch.float32,
                         device="cpu") -> DeformableConvParams:
    """Zero offset conv (start from the regular grid) and He-initialised
    main conv. Numbers are drawn on the CPU from ``generator`` and then
    moved, so a seed gives the same weights on every device."""
    kk = kernel_size
    L = offset_channels(kk, variant)
    fan_in = kk * kk * c_in
    w_off = torch.zeros((kk, kk, c_in, L), dtype=dtype)
    b_off = torch.zeros((L,), dtype=dtype)
    w = (torch.randn((kk, kk, c_in, c_out), generator=generator,
                     dtype=torch.float32) * math.sqrt(2.0 / fan_in))
    b = torch.zeros((c_out,), dtype=dtype)
    return DeformableConvParams(*(t.to(device=device, dtype=dtype)
                                  for t in (w_off, b_off, w, b)))


def randomize_offset_conv(params: DeformableConvParams,
                          generator: torch.Generator,
                          scale: float) -> DeformableConvParams:
    """Replace the offset-conv weights with Gaussian noise of the given
    scale — how tests and the smoke run make irregular sampling."""
    w_off = torch.randn(tuple(params.w_off.shape), generator=generator,
                        dtype=torch.float32) * scale
    return params._replace(w_off=w_off.to(device=params.w_off.device,
                                          dtype=params.w_off.dtype))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Standard NHWC conv with HWIO weights (stages 1 and 3 building
    block). ``padding`` is "SAME" or "VALID", as in the JAX package."""
    if padding == "SAME":
        kh, kw = w.shape[0], w.shape[1]
        if stride != 1:
            raise ValueError("SAME padding is implemented for stride 1")
        pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
        xn = F.pad(x.permute(0, 3, 1, 2), pad)
    elif padding == "VALID":
        xn = x.permute(0, 3, 1, 2)
    else:
        raise ValueError(f"unknown padding: {padding!r}")
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), None, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype).contiguous()


def base_tap_grid(kernel_size: int, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """Relative (row, col) positions of the K*K regular taps, centred."""
    r = (kernel_size - 1) / 2.0
    d = torch.arange(kernel_size, dtype=dtype, device=device) - r
    rr, cc = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([rr, cc], dim=-1).reshape(-1, 2)      # (K*K, 2)


def offsets_to_coords(offsets: torch.Tensor, kernel_size: int, variant: str,
                      max_displacement: float | None = None) -> torch.Tensor:
    """Stage-1 offsets (N, H, W, L) -> absolute sampling coordinates
    (N, H, W, K*K, 2) float, (row, col), clamped in-range."""
    n, h, w, L = offsets.shape
    kk2 = kernel_size * kernel_size
    if L != offset_channels(kernel_size, variant):
        raise ValueError(f"{L} offset channels do not match {variant!r}")
    dtype, dev = offsets.dtype, offsets.device
    rows = torch.arange(h, dtype=dtype, device=dev)[:, None, None]
    cols = torch.arange(w, dtype=dtype, device=dev)[None, :, None]
    centre = torch.cat([rows.expand(h, w, 1), cols.expand(h, w, 1)], dim=-1)
    taps = base_tap_grid(kernel_size, dtype, dev)
    if variant == "dcn1":
        off = offsets[..., None, :]                          # (N,H,W,1,2)
    else:
        off = offsets.reshape(n, h, w, kk2, 2)               # (N,H,W,KK,2)
    if max_displacement is not None:
        off = off.clamp(-max_displacement, max_displacement)
    coords = centre[None, :, :, None, :] + taps[None, None, None] + off
    hi = torch.tensor([h - 1, w - 1], dtype=dtype, device=dev)
    return torch.minimum(coords.clamp_min(0.0), hi)


def bli_coefficients(coords: torch.Tensor):
    """Paper Eq. 5. coords (..., 2) -> (floor_rc int32 (..., 2),
    coeffs (..., 4)) with neighbour order (r0,c0) (r0,c1) (r1,c0) (r1,c1)
    = (eta, theta, mu, gamma); da = col fraction, db = row fraction."""
    floor_rc = torch.floor(coords)
    frac = coords - floor_rc
    db = frac[..., 0]
    da = frac[..., 1]
    eta = (1.0 - da) * (1.0 - db)
    theta = da * (1.0 - db)
    mu = (1.0 - da) * db
    gamma = da * db
    coeffs = torch.stack([eta, theta, mu, gamma], dim=-1)
    return floor_rc.to(torch.int32), coeffs


def bilinear_sample(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Stage 2 (Eq. 2): x (N, H, W, C), coords (N, H, W, KK, 2) ->
    deformed features (N, H, W, KK, C)."""
    n, h, w, c = x.shape
    floor_rc, coeffs = bli_coefficients(coords)
    r0 = floor_rc[..., 0].clamp(0, h - 1).long()
    c0 = floor_rc[..., 1].clamp(0, w - 1).long()
    r1 = (r0 + 1).clamp(0, h - 1)
    c1 = (c0 + 1).clamp(0, w - 1)
    x_flat = x.reshape(n, h * w, c)

    def gather(ri, ci):
        flat = (ri * w + ci).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(x_flat, 1, flat).reshape(ri.shape + (c,))

    coeffs = coeffs.to(x.dtype)
    return (gather(r0, c0) * coeffs[..., 0:1]
            + gather(r0, c1) * coeffs[..., 1:2]
            + gather(r1, c0) * coeffs[..., 2:3]
            + gather(r1, c1) * coeffs[..., 3:4])


def deformable_conv2d(x: torch.Tensor, params: DeformableConvParams,
                      kernel_size: int = 3, variant: str = "dcn2",
                      max_displacement: float | None = None,
                      return_coords: bool = False):
    """Full deformable convolution, Eq. 1-3: x (N,H,W,C_in) ->
    (N,H,W,C_out). The port's numerical oracle."""
    offsets = conv2d(x, params.w_off, params.b_off)              # Eq. 1
    coords = offsets_to_coords(offsets.float(), kernel_size, variant,
                               max_displacement)
    deformed = bilinear_sample(x, coords)                        # Eq. 2
    kk2 = kernel_size * kernel_size
    w = params.w.reshape(kk2, x.shape[-1], params.w.shape[-1])
    y = torch.einsum("nhwkc,kco->nhwo", deformed.float(), w.float())
    y = (y + params.b.float()).to(x.dtype)
    if return_coords:
        return y, coords
    return y
