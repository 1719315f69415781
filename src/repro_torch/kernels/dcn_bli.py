"""Standalone bilinear interpolation (paper Eq. 2, §IV-B).

The paper maps each bilinear interpolation to a 4-wide dot product on a
cluster of 4 PEs; the TPU kernel forms a 4-hot interpolation matrix and
runs the tile through the MXU. :func:`bli_tile_matmul` computes the same
function with the CUDA kernel in ``csrc/dcn_bli.cu``, a gather of the four
neighbour rows and their weighted sum:

    out (P, C) = sum_j coeff[:, j] * x_tile[idx[:, j], :]

where an index outside ``[0, S)`` contributes zero (it matches no column
of the TPU's 4-hot row). For a CPU tensor the wrapper runs
:func:`bli_tile_plain`; for a CUDA tensor it launches the kernel or
raises, and counts the launch in ``bli_tile_matmul.launches``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.dcn_fused import _check_operands, _stream


def bli_tile_plain(x_tile, idx, coeff) -> torch.Tensor:
    """Plain torch version of the BLI kernel (masked 4-term gather)."""
    *lead, s, c = x_tile.shape
    p = idx.shape[-2]
    n = math.prod(lead)
    xf = x_tile.reshape(n, s, c).float()
    ix = idx.reshape(n, p, 4).long()
    cf = coeff.reshape(n, p, 4).float() * ((ix >= 0) & (ix < s))
    rows = torch.arange(n, device=xf.device)[:, None]
    src = ix.clamp(0, max(s - 1, 0))
    out = cf[..., 0:1] * xf[rows, src[..., 0]]
    for j in range(1, 4):
        out = out + cf[..., j:j + 1] * xf[rows, src[..., j]]
    return out.to(x_tile.dtype).reshape(*lead, p, c)


def bli_tile_matmul(x_tile, idx, coeff, *, block_p: int = 128,
                    block_c: int = 128) -> torch.Tensor:
    """Deformed features (..., P, C) from x_tile (..., S, C) f32 and idx
    int32 / coeff f32 (..., P, 4). Leading dimensions are a batch of
    independent tiles (JAX's ``vmap`` over images), one launch for all.
    ``block_p``/``block_c`` keep the TPU kernel's contract: P and C must
    tile by ``min(block, size)``."""
    dev = _check_operands(dict(x_tile=x_tile, coeff=coeff), dict(idx=idx))
    *lead, s, c = x_tile.shape
    if (idx.dim() != x_tile.dim() or idx.shape[-1] != 4
            or list(idx.shape[:-2]) != lead or coeff.shape != idx.shape):
        raise ValueError(f"idx/coeff {tuple(idx.shape)} must be (..., P, 4) "
                         f"matching x_tile {tuple(x_tile.shape)}")
    p = idx.shape[-2]
    bp, bc = min(block_p, p), min(block_c, c)
    if bp < 1 or bc < 1 or p % bp or c % bc:
        raise ValueError(
            f"P={p} and C={c} must tile by ({bp},{bc}); pad upstream")
    if dev.type == "cpu":
        return bli_tile_plain(x_tile, idx, coeff)
    from repro_torch.kernels import _build

    lib = _build.load()
    out = torch.empty((*lead, p, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    n = math.prod(lead)
    err = lib.bli_gather_launch(x_tile.data_ptr(), idx.data_ptr(),
                                coeff.data_ptr(), out.data_ptr(), n, p, s,
                                c, _stream(x_tile))
    _build.check(err, "bli_gather_launch")
    bli_tile_matmul.launches += 1
    return out


bli_tile_matmul.launches = 0


def bli_gather_reference(x_tile, idx, coeff) -> torch.Tensor:
    """Unmasked gather formulation over the same (S, C) tile — the
    JAX package's baseline for the BLI kernel; indices must be in range."""
    cf = coeff.float()
    out = torch.zeros((idx.shape[0], x_tile.shape[1]), dtype=torch.float32,
                      device=x_tile.device)
    for j in range(4):
        out = out + x_tile[idx[:, j].long()].float() * cf[:, j:j + 1]
    return out.to(x_tile.dtype)
