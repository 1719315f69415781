"""Fused BLI(+)conv kernels (paper §IV-D fusion).

The deformed-feature tensor is K*K times the input feature map; the
paper's fusion keeps it on chip. Three entry points, one CUDA body
(``csrc/dcn_fused_common.cuh``) with three addressing modes: per output
row, gather the deformed patch chunk by chunk in shared memory and
contract it with the main-conv weights, so the intermediate never
reaches device memory.

* :func:`dcn_fused_batch` — the concatenated Algorithm-1 schedules of a
  whole batch in ONE launch (``batch_fused``; ``csrc/dcn_fused_batch.cu``),
  plane-global addresses localised against each row's dep tiles;
* :func:`dcn_fused_schedule` — one image's schedule in one launch
  (``batched`` and the serving engine's degraded step;
  ``csrc/dcn_fused_schedule.cu``), slot-local addresses ``k*tp + offset``;
* :func:`dcn_fused_tile` — one output tile with its packed halo resident
  (``per_tile`` and ``ops.deformable_conv2d_pallas``; same source),
  addresses into ``[0, S)``, a leading batch dimension as grid rows.

For a CPU tensor each wrapper runs its plain torch version, which repeats
the TPU kernel's dataflow (batch and schedule: per dep slot, localise the
addresses, 4-hot gather, accumulate the patch in float32; tile: the 4-hot
rows against ``iota(S)`` as a masked gather; then the contraction with
``w``); for a CUDA tensor it launches the kernel or raises. Each wrapper counts its launches
in a plain-integer ``launches`` attribute.
"""

from __future__ import annotations

import math

import torch

from repro_torch.obs import get_tracer


def dcn_fused_batch_plain(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w,
                          b, *, t_in: int) -> torch.Tensor:
    """Plain torch version of the batch-fused kernel -> (G, P, C_out)."""
    nt_in, tp, c = x_tiles.shape
    g = row_id.shape[0]
    _, p, kk, _ = idx.shape
    o = w.shape[-1]
    k_pad = dep_glb.shape[1]
    dev = x_tiles.device
    rows = row_id.long()
    ix = idx[rows].long()                                  # (G, P, KK, 4)
    cf = coeff[rows].float()
    acc = torch.zeros((g, p, kk, c), dtype=torch.float32, device=dev)
    gi = torch.arange(g, device=dev)
    for k in range(k_pad):
        dep = dep_glb[:, k].long()                         # (G,)
        local = ix - ((dep % t_in) * tp)[:, None, None, None]
        live = ((local >= 0) & (local < tp)
                & (k < dep_cnt.long())[:, None, None, None])
        tile = x_tiles[dep].float()                        # (G, tp, C)
        src = local.clamp(0, tp - 1).reshape(g, -1)        # (G, P*KK*4)
        vals = tile[gi[:, None], src].reshape(g, p, kk, 4, c)
        acc += ((cf * live)[..., None] * vals).sum(dim=3)
    out = acc.reshape(g, p, kk * c) @ w.float().reshape(kk * c, o)
    return (out + b.float()).to(x_tiles.dtype)


def _check_operands(floats: dict, ints: dict) -> torch.device:
    """Common operand checks: one device, contiguous, float32 / int32."""
    dev = next(iter(floats.values())).device
    for name, t in {**floats, **ints}.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (bf16 is not ported "
                             f"yet), got {t.dtype}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_conv(idx, coeff, w, b, c: int) -> None:
    kk = idx.shape[-2]
    if idx.shape[-1] != 4 or coeff.shape != idx.shape:
        raise ValueError("idx and coeff must both be (..., P, KK, 4)")
    if w.dim() != 3 or tuple(w.shape[:2]) != (kk, c):
        raise ValueError(f"w must be (KK={kk}, C={c}, O), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[2],):
        raise ValueError("b must be (O,)")


def _check_block(p: int, block_p: int) -> None:
    bp = min(block_p, p)
    if bp < 1 or p % bp:
        raise ValueError(f"P={p} must tile by {bp}; pad upstream")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dcn_fused_batch(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                    *, t_in: int) -> torch.Tensor:
    """Fused Eq. 2+3 over a whole batch's schedules -> (G, P, C_out).

    x_tiles (N*T_in, tp, C) f32 — every image's input tiles;
    row_id (G,) i32 — idx/coeff row ``img*T_out + out_tile`` per grid row;
    dep_glb (G, k_pad) i32 — global dep tiles ``img*T_in + dep`` in load
    order; dep_cnt (G,) i32 — true dep count (0 = padding row, output b);
    idx/coeff (N*T_out, P, KK, 4) — plane-global addresses
    ``tile*tp + offset`` and BLI coefficients; w (KK, C, O); b (O,).
    """
    dev = _check_operands(dict(x_tiles=x_tiles, coeff=coeff, w=w, b=b),
                          dict(row_id=row_id, dep_glb=dep_glb,
                               dep_cnt=dep_cnt, idx=idx))
    nt_in, tp, c = x_tiles.shape
    g = row_id.shape[0]
    if nt_in % t_in:
        raise ValueError(f"x_tiles rows {nt_in} not a multiple of "
                         f"t_in={t_in}")
    if (dep_glb.dim() != 2 or dep_glb.shape[0] != g
            or tuple(dep_cnt.shape) != (g,)):
        raise ValueError("dep_glb must be (G, k_pad) and dep_cnt (G,)")
    if idx.dim() != 4:
        raise ValueError("idx and coeff must both be (rows, P, KK, 4)")
    _check_conv(idx, coeff, w, b, c)
    p, o = idx.shape[1], w.shape[2]
    with get_tracer().span("dispatch.batch_fused", grid_rows=int(g),
                           c_out=int(o)):
        if dev.type == "cpu":
            return dcn_fused_batch_plain(x_tiles, row_id, dep_glb, dep_cnt,
                                         idx, coeff, w, b, t_in=t_in)
        from repro_torch.kernels import _build

        lib = _build.load()
        out = torch.empty((g, p, o), dtype=torch.float32, device=dev)
        if g == 0:
            return out
        err = lib.dcn_fused_batch_launch(
            x_tiles.data_ptr(), row_id.data_ptr(), dep_glb.data_ptr(),
            dep_cnt.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
            w.data_ptr(), b.data_ptr(), out.data_ptr(), g,
            dep_glb.shape[1], t_in, tp, p, idx.shape[2], c, o,
            _stream(x_tiles))
        _build.check(err, "dcn_fused_batch_launch")
        dcn_fused_batch.launches += 1
        return out


dcn_fused_batch.launches = 0


# ---------------------------------------------------------------------------
# One image's schedule in one launch (kernel #4, TPU `_sched_kernel`)
# ---------------------------------------------------------------------------


def dcn_fused_schedule_plain(x_tiles, dep_tbl, dep_cnt, idx, coeff, w,
                             b) -> torch.Tensor:
    """Plain torch version of the schedule kernel -> (T, P, C_out): per
    dep slot k < dep_cnt, the addresses in ``[k*tp, (k+1)*tp)`` gather
    from tile ``dep_tbl[:, k]``; everything else contributes zero."""
    t_in, tp, c = x_tiles.shape
    t, p, kk, _ = idx.shape
    o = w.shape[-1]
    dev = x_tiles.device
    ix = idx.long()
    cf = coeff.float()
    acc = torch.zeros((t, p, kk, c), dtype=torch.float32, device=dev)
    ti = torch.arange(t, device=dev)
    for k in range(dep_tbl.shape[1]):
        dep = dep_tbl[:, k].long()                         # (T,)
        local = ix - k * tp
        row_live = (k < dep_cnt.long()) & (dep >= 0) & (dep < t_in)
        live = (local >= 0) & (local < tp) & row_live[:, None, None, None]
        tile = x_tiles[dep.clamp(0, t_in - 1)].float()     # (T, tp, C)
        src = local.clamp(0, tp - 1).reshape(t, -1)
        vals = tile[ti[:, None], src].reshape(t, p, kk, 4, c)
        acc += ((cf * live)[..., None] * vals).sum(dim=3)
    out = acc.reshape(t, p, kk * c) @ w.float().reshape(kk * c, o)
    return (out + b.float()).to(x_tiles.dtype)


def dcn_fused_schedule(x_tiles, dep_tbl, dep_cnt, idx, coeff, w, b, *,
                       block_p: int = 128) -> torch.Tensor:
    """Fused Eq. 2+3 over one image's whole tile schedule -> (T, P, C_out).

    x_tiles (T_in, tp, C) f32 — every input tile of the plane;
    dep_tbl (T, k_pad) i32 — per scheduled tile its deps in load order;
    dep_cnt (T,) i32 — true dep count (0 = bias only); idx/coeff (T, P,
    KK, 4) — slot-local addresses ``k*tp + offset`` and BLI coefficients;
    w (KK, C, O); b (O,). Row t is scheduled tile t's output; the caller
    scatters rows by its schedule order. ``block_p`` keeps the TPU
    kernel's pixel-block contract: P must tile by ``min(block_p, P)``.
    """
    dev = _check_operands(dict(x_tiles=x_tiles, coeff=coeff, w=w, b=b),
                          dict(dep_tbl=dep_tbl, dep_cnt=dep_cnt, idx=idx))
    t_in, tp, c = x_tiles.shape
    if idx.dim() != 4:
        raise ValueError("idx and coeff must both be (T, P, KK, 4)")
    t, p = idx.shape[:2]
    if (dep_tbl.dim() != 2 or dep_tbl.shape[0] != t
            or tuple(dep_cnt.shape) != (t,)):
        raise ValueError("dep_tbl must be (T, k_pad) and dep_cnt (T,)")
    _check_conv(idx, coeff, w, b, c)
    _check_block(p, block_p)
    o = w.shape[2]
    if t == 0:             # empty schedule: nothing to launch
        return torch.zeros((0, p, o), dtype=x_tiles.dtype, device=dev)
    with get_tracer().span("dispatch.batched", tiles=int(t), c_out=int(o)):
        if dev.type == "cpu":
            return dcn_fused_schedule_plain(x_tiles, dep_tbl, dep_cnt, idx,
                                            coeff, w, b)
        from repro_torch.kernels import _build

        lib = _build.load()
        out = torch.empty((t, p, o), dtype=torch.float32, device=dev)
        err = lib.dcn_fused_schedule_launch(
            x_tiles.data_ptr(), dep_tbl.data_ptr(), dep_cnt.data_ptr(),
            idx.data_ptr(), coeff.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), t, dep_tbl.shape[1], t_in, tp, p, idx.shape[2],
            c, o, _stream(x_tiles))
        _build.check(err, "dcn_fused_schedule_launch")
        dcn_fused_schedule.launches += 1
        return out


dcn_fused_schedule.launches = 0


# ---------------------------------------------------------------------------
# One output tile with its halo resident (kernel #5, TPU `_fused_kernel`)
# ---------------------------------------------------------------------------


def dcn_fused_tile_plain(x_tile, idx, coeff, w, b) -> torch.Tensor:
    """Plain torch version of the tile kernel: the TPU's 4-hot rows
    against ``iota(S)`` as a masked gather (an index outside ``[0, S)``
    contributes zero), then the contraction with ``w``."""
    *lead, s, c = x_tile.shape
    p, kk = idx.shape[-3], idx.shape[-2]
    o = w.shape[-1]
    n = math.prod(lead)
    xf = x_tile.reshape(n, s, c).float()
    ix = idx.reshape(n, p * kk * 4).long()
    live = (ix >= 0) & (ix < s)
    vals = xf[torch.arange(n, device=xf.device)[:, None],
              ix.clamp(0, max(s - 1, 0))]                  # (n, PKK4, C)
    cf = coeff.reshape(n, p * kk * 4).float() * live
    patch = (cf[..., None] * vals).reshape(n, p, kk, 4, c).sum(dim=3)
    out = patch.reshape(n, p, kk * c) @ w.float().reshape(kk * c, o)
    return (out + b.float()).to(x_tile.dtype).reshape(*lead, p, o)


def dcn_fused_tile(x_tile, idx, coeff, w, b, *,
                   block_p: int = 128) -> torch.Tensor:
    """Fused Eq. 2+3 on one tile -> (..., P, C_out).

    x_tile (..., S, C) f32 — the packed halo buffer; idx/coeff (..., P, KK,
    4) — addresses into ``[0, S)`` and BLI coefficients; w (KK, C, O);
    b (O,). Leading dimensions are a batch of independent tiles (JAX's
    ``vmap`` over images), all in one launch.
    """
    dev = _check_operands(dict(x_tile=x_tile, coeff=coeff, w=w, b=b),
                          dict(idx=idx))
    *lead, s, c = x_tile.shape
    if idx.dim() != x_tile.dim() + 1 or list(idx.shape[:-3]) != lead:
        raise ValueError(f"idx {tuple(idx.shape)} does not match x_tile "
                         f"{tuple(x_tile.shape)}: expected (..., P, KK, 4)")
    _check_conv(idx, coeff, w, b, c)
    p = idx.shape[-3]
    _check_block(p, block_p)
    o = w.shape[2]
    n = math.prod(lead)
    with get_tracer().span("dispatch.per_tile", pixels=int(p),
                           c_out=int(o)):
        if dev.type == "cpu":
            return dcn_fused_tile_plain(x_tile, idx, coeff, w, b)
        from repro_torch.kernels import _build

        lib = _build.load()
        out = torch.empty((*lead, p, o), dtype=torch.float32, device=dev)
        if n == 0 or p == 0:
            return out
        err = lib.dcn_fused_tile_launch(
            x_tile.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
            w.data_ptr(), b.data_ptr(), out.data_ptr(), n, s, p,
            idx.shape[-2], c, o, _stream(x_tile))
        _build.check(err, "dcn_fused_tile_launch")
        dcn_fused_tile.launches += 1
        return out


dcn_fused_tile.launches = 0
