"""Standalone bilinear interpolation (paper Eq. 2, §IV-B).

The paper maps each bilinear interpolation to a 4-wide dot product on a
cluster of 4 PEs; the TPU kernel forms a 4-hot interpolation matrix and
runs the tile through the MXU. :func:`bli_tile_matmul` computes the same
function with the CUDA kernel in ``csrc/dcn_bli.cu``, a gather of the four
neighbour rows and their weighted sum:

    out (P, C) = sum_j coeff[:, j] * x_tile[idx[:, j], :]

where an index outside ``[0, S)`` contributes zero (it matches no column
of the TPU's 4-hot row). x is float32, bfloat16 or float16; the sum is
taken in float32 and rounded once to x's type. For a CPU tensor the wrapper runs
:func:`bli_tile_plain`; for a CUDA tensor it launches the kernel as
:func:`bli_plan` lays it out, or raises, and counts the launch in
``bli_tile_matmul.launches``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.dcn_fused import (H100_SMS, _check_operands, _stream,
                                          dtype_code)

# x dtypes the kernel takes (the JAX kernel widens any float type).
BLI_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def bli_tile_plain(x_tile, idx, coeff) -> torch.Tensor:
    """Plain torch version of the BLI kernel (masked 4-term gather, summed
    in float32 in j order, rounded once to x's dtype)."""
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


# ---------------------------------------------------------------------------
# Launch shape of csrc/dcn_bli.cu
# ---------------------------------------------------------------------------

# Bytes of the channel slice a block owns (8 words of 16 bytes: 32 float32
# or 64 bfloat16 / float16 channels), and the blocks an SM holds in the one wave the
# grid is sized to.
BLI_SLICE_BYTES = 128
BLI_BLOCKS_PER_SM = 4


class BliPlan(NamedTuple):
    """One launch of the BLI kernel. ``vec``: lanes move 16-byte words
    (else one element); ``lw``: words of a block's channel slice;
    ``rows``: output rows of a block; ``grid``: (row chunks, channel
    slices, images)."""
    vec: bool
    lw: int
    rows: int
    grid: tuple[int, int, int]


def bli_plan(n: int, p: int, s: int, c: int, elem: int, *,
             aligned: bool = True, sm_count: int = H100_SMS) -> BliPlan:
    """Launch shape for ``n`` planes of (S, C) elements of ``elem`` bytes
    to (P, C): channel slices of :data:`BLI_SLICE_BYTES` (a power of two
    of words that divides the row; words are 16 bytes where the rows are
    and ``aligned`` says the pointers are, else one element), and row
    chunks of whole warp steps for one wave of :data:`BLI_BLOCKS_PER_SM`
    blocks an SM on ``sm_count`` SMs."""
    vec = aligned and (c * elem) % 16 == 0
    word = 16 if vec else elem
    cw = c * elem // 16 if vec else c
    lw = 1
    while (lw * 2 <= min(32, BLI_SLICE_BYTES // word)
           and cw % (lw * 2) == 0):
        lw *= 2
    slices, rps = cw // lw, 32 // lw
    chunks = max(1, round(BLI_BLOCKS_PER_SM * sm_count / max(1, n * slices)))
    chunks = min(chunks, max(1, math.ceil(p / rps)))
    rows = math.ceil(math.ceil(p / chunks) / rps) * rps
    return BliPlan(vec, lw, rows, (math.ceil(p / rows), slices, n))


def bli_tile_matmul(x_tile, idx, coeff, *, block_p: int = 128,
                    block_c: int = 128) -> torch.Tensor:
    """Deformed features (..., P, C) in x's dtype from x_tile (..., S, C)
    float32, bfloat16 or float16 and idx int32 / coeff float32 (..., P, 4).
    Leading dimensions are a batch of independent tiles (JAX's ``vmap``
    over images), one launch for all. ``block_p``/``block_c`` keep the
    TPU kernel's contract: P and C must tile by ``min(block, size)``.
    The plan of the last launch is in ``bli_tile_matmul.last_plan``."""
    dev = _check_operands(dict(x_tile=x_tile, coeff=coeff), dict(idx=idx),
                          BLI_DTYPES)
    if coeff.dtype != torch.float32:
        raise ValueError(f"coeff must be float32, got {coeff.dtype}")
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
    out = torch.empty((*lead, p, c), dtype=x_tile.dtype, device=dev)
    if out.numel() == 0:
        return out
    n = math.prod(lead)
    if n > 65535:
        raise ValueError(f"{n} tiles exceed the kernel's 65535 grid images")
    if idx.data_ptr() % 16 or coeff.data_ptr() % 16:
        raise ValueError("idx and coeff must start on 16-byte boundaries")
    plan = bli_plan(n, p, s, c, x_tile.element_size(),
                    aligned=x_tile.data_ptr() % 16 == 0,
                    sm_count=torch.cuda.get_device_properties(
                        dev).multi_processor_count)
    with torch.cuda.device(dev):
        err = lib.bli_gather_launch(
            x_tile.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
            out.data_ptr(), n, p, s, c, dtype_code(x_tile.dtype),
            int(plan.vec), plan.lw, plan.rows, plan.grid[0],
            _stream(x_tile))
    _build.check(err, "bli_gather_launch")
    bli_tile_matmul.launches += 1
    bli_tile_matmul.last_plan = plan
    return out


bli_tile_matmul.launches = 0
bli_tile_matmul.last_plan = None


def parity_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
    """Split (H, W, C) into 4 parity planes (the paper's 4 buffer banks).

    Plane (pr, pc) holds x[pr::2, pc::2]: the four BLI neighbours of a
    coordinate land in four different (plane, offset) slots, the
    conflict-free property of the paper's Fig. 7. Views, as JAX's slices
    are values: no copy."""
    return x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]


def bli_gather_reference(x_tile, idx, coeff) -> torch.Tensor:
    """Unmasked gather formulation over the same (S, C) tile — the
    JAX package's baseline for the BLI kernel; indices must be in range."""
    cf = coeff.float()
    out = torch.zeros((idx.shape[0], x_tile.shape[1]), dtype=torch.float32,
                      device=x_tile.device)
    for j in range(4):
        out = out + x_tile[idx[:, j].long()].float() * cf[:, j:j + 1]
    return out.to(x_tile.dtype)
