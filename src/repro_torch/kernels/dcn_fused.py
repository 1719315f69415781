"""Batch-fused BLI(+)conv (paper §IV-D fusion) over a whole batch.

The deformed-feature tensor is K*K times the input feature map; the
paper's fusion keeps it on chip. :func:`dcn_fused_batch` runs the
concatenated Algorithm-1 schedules of every image of a batch in ONE
launch of the CUDA kernel in ``csrc/dcn_fused_batch.cu``: per grid row
(one scheduled output tile of one image) it gathers the deformed patch
chunk by chunk in shared memory and contracts it with the main-conv
weights, so the intermediate never reaches device memory.

For a CPU tensor the wrapper runs :func:`dcn_fused_batch_plain`, which
repeats the TPU kernel's dataflow in torch: per dep slot, localise the
plane-global addresses against the slot's tile, apply the 4-hot(coeff)
gather, accumulate the patch in float32, then contract it with ``w``.
"""

from __future__ import annotations

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


def _check_operands(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                    t_in: int) -> None:
    dev = x_tiles.device
    named = dict(x_tiles=x_tiles, row_id=row_id, dep_glb=dep_glb,
                 dep_cnt=dep_cnt, idx=idx, coeff=coeff, w=w, b=b)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x_tiles on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("x_tiles", "coeff", "w", "b"):
        if named[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (bf16 is not ported "
                             f"yet), got {named[name].dtype}")
    for name in ("row_id", "dep_glb", "dep_cnt", "idx"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{named[name].dtype}")
    nt_in, tp, c = x_tiles.shape
    g = row_id.shape[0]
    kk = idx.shape[2]
    if nt_in % t_in:
        raise ValueError(f"x_tiles rows {nt_in} not a multiple of "
                         f"t_in={t_in}")
    if (dep_glb.dim() != 2 or dep_glb.shape[0] != g
            or tuple(dep_cnt.shape) != (g,)):
        raise ValueError("dep_glb must be (G, k_pad) and dep_cnt (G,)")
    if idx.dim() != 4 or idx.shape[3] != 4 or coeff.shape != idx.shape:
        raise ValueError("idx and coeff must both be (rows, P, KK, 4)")
    if w.dim() != 3 or tuple(w.shape[:2]) != (kk, c):
        raise ValueError(f"w must be (KK={kk}, C={c}, O), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[2],):
        raise ValueError("b must be (O,)")


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
    _check_operands(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                    t_in)
    g, p, o = row_id.shape[0], idx.shape[1], w.shape[2]
    with get_tracer().span("dispatch.batch_fused", grid_rows=int(g),
                           c_out=int(o)):
        if x_tiles.device.type == "cpu":
            return dcn_fused_batch_plain(x_tiles, row_id, dep_glb, dep_cnt,
                                         idx, coeff, w, b, t_in=t_in)
        if x_tiles.device.type != "cuda":
            raise ValueError(f"unsupported device {x_tiles.device}")
        from repro_torch.kernels import _build

        lib = _build.load()
        out = torch.empty((g, p, o), dtype=torch.float32,
                          device=x_tiles.device)
        if g == 0:
            return out
        _, tp, c = x_tiles.shape
        err = lib.dcn_fused_batch_launch(
            x_tiles.data_ptr(), row_id.data_ptr(), dep_glb.data_ptr(),
            dep_cnt.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
            w.data_ptr(), b.data_ptr(), out.data_ptr(), g,
            dep_glb.shape[1], t_in, tp, p, idx.shape[2], c, o,
            torch.cuda.current_stream(x_tiles.device).cuda_stream)
        _build.check(err, "dcn_fused_batch_launch")
        dcn_fused_batch.launches += 1
        return out


dcn_fused_batch.launches = 0
