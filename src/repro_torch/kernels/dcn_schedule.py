"""On-device tile scheduling (paper §IV-B/C): TDT and Algorithm-1 kernels.

On the paper's ASIC the tile scheduler is a hardware block next to the
NNA: it builds the Tile Dependency Table from the stage-1 offsets and runs
Algorithm 1's greedy max-overlap selection. Here both steps are CUDA
kernels (``csrc/dcn_schedule.cu``):

  * :func:`tdt_from_coords_device` — one TDT row per output tile;
  * :func:`greedy_schedule_arrays` — Algorithm 1 in one persistent block.

Each wrapper launches its kernel for a CUDA tensor and counts the launch
in its plain-integer ``launches`` attribute; for a CPU tensor it runs the
plain torch version beside it, which repeats the kernel's arithmetic.
Both are bit-exact against the
host reference (``core.tiles.tdt_from_coords`` and
``core.scheduler.schedule_tiles``).

The FIFO state trick: with load-only insertion and FIFO eviction, a tile
is resident iff its last-load sequence number is among the ``m`` most
recent loads, i.e. ``seq[t] > loads_total - m``. Within a step the
loaded-class tiles are all hits and the seq/last-class tiles all loads,
so a step's update is a rank assignment by prefix sum.

The glue that turns the greedy kernel's class rows into dispatch tables
(:func:`dispatch_arrays_from_klass`, :func:`tdt_dispatch_arrays`) is plain
torch on the tables' device; its stable argsorts recover the load order.
"""

from __future__ import annotations

import torch

from repro_torch.core.tiles import TileGrid

# Sentinel "never loaded" sequence number: always evicted under
# ``seq > loads_total - m`` for any reachable loads_total/m.
_NEVER_LOADED = -(1 << 30)
_MAX_IDS = (1 << 21) - 1   # the greedy kernel packs three 21-bit counts


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# TDT: sampling coordinates -> tile dependency table
# ---------------------------------------------------------------------------


def _tdt_tile_coords(coords: torch.Tensor, out_grid: TileGrid
                     ) -> torch.Tensor:
    """(T_out, tp*KK, 2) coordinates per output tile, ragged edges
    replicate-padded (a padded slot repeats the last row/column pixel)."""
    h, w, kk, _ = coords.shape
    th, tw, rows, cols = out_grid.th, out_grid.tw, out_grid.rows, \
        out_grid.cols
    dev = coords.device
    r_idx = torch.arange(rows * th, device=dev).clamp_max(h - 1)
    c_idx = torch.arange(cols * tw, device=dev).clamp_max(w - 1)
    ct = coords.float()[r_idx][:, c_idx]
    return (ct.reshape(rows, th, cols, tw, kk, 2).permute(0, 2, 1, 3, 4, 5)
            .reshape(rows * cols, th * tw * kk, 2))


def tdt_plain(coords: torch.Tensor, in_grid: TileGrid,
              out_grid: TileGrid) -> torch.Tensor:
    """Plain torch version of the TDT kernel: per output tile, floor and
    clip its coordinates, decode the 4 neighbours, OR-reduce the row."""
    rc = _tdt_tile_coords(coords, out_grid)                # (T, tpkk, 2)
    r0 = torch.floor(rc[..., 0]).long().clamp(0, in_grid.h - 1)
    c0 = torch.floor(rc[..., 1]).long().clamp(0, in_grid.w - 1)
    r1 = (r0 + 1).clamp(0, in_grid.h - 1)
    c1 = (c0 + 1).clamp(0, in_grid.w - 1)
    t_out = rc.shape[0]
    out = torch.zeros((t_out, in_grid.num_tiles), dtype=torch.bool,
                      device=coords.device)
    rows = torch.arange(t_out, device=coords.device)[:, None]
    for rr, cc in ((r0, c0), (r0, c1), (r1, c0), (r1, c1)):
        tid = (rr // in_grid.th) * in_grid.cols + cc // in_grid.tw
        out[rows.expand_as(tid), tid] = True
    return out


def tdt_from_coords_device(coords: torch.Tensor, in_grid: TileGrid,
                           out_grid: TileGrid) -> torch.Tensor:
    """TDT of one image on the tensor's device: coords (H, W, KK, 2)
    float32 -> (T_out, T_in) bool. CUDA tensors launch the kernel."""
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (H, W, KK, 2), got "
                         f"{tuple(coords.shape)}")
    if coords.device.type == "cpu":
        return tdt_plain(coords, in_grid, out_grid)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError("coords must be contiguous float32")
    from repro_torch.kernels import _build

    lib = _build.load()
    h, w, kk, _ = coords.shape
    t_out, n_in = out_grid.num_tiles, in_grid.num_tiles
    out = torch.empty((t_out, n_in), dtype=torch.bool, device=coords.device)
    if t_out == 0 or n_in == 0:
        return out
    err = lib.tdt_from_coords_launch(
        coords.data_ptr(), out.data_ptr(), h, w, kk, out_grid.th,
        out_grid.tw, out_grid.cols, t_out, in_grid.h, in_grid.w,
        in_grid.th, in_grid.tw, in_grid.cols, n_in, _stream())
    _build.check(err, "tdt_from_coords_launch")
    tdt_from_coords_device.launches += 1
    return out


tdt_from_coords_device.launches = 0


# ---------------------------------------------------------------------------
# Algorithm 1: greedy max-overlap selection
# ---------------------------------------------------------------------------


def greedy_plain(b: torch.Tensor, m: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the greedy kernel: the same step loop, the
    same state (executed mask, FIFO last-load sequence numbers,
    loads_total, curr), and the same first-max argmax."""
    b = (b != 0)
    n_out, n_in = b.shape
    dev = b.device
    bi = b.to(torch.int32)
    oid = torch.full((n_out, 1), -1, dtype=torch.int32, device=dev)
    klass = torch.full((n_out, n_in), 3, dtype=torch.int32, device=dev)
    ovl = torch.zeros((n_out, 1), dtype=torch.int32, device=dev)
    executed = torch.zeros((n_out,), dtype=torch.bool, device=dev)
    seqs = torch.full((n_in,), _NEVER_LOADED, dtype=torch.int64, device=dev)
    dep_cnt = bi.sum(dim=1)
    loads_total, curr = 0, 0
    for i in range(n_out):
        first = i == 0
        currdep = (torch.zeros(n_in, dtype=torch.bool, device=dev)
                   if first else b[curr])
        score = dep_cnt if first else (bi & currdep.to(torch.int32)).sum(1)
        valid = (dep_cnt > 0) & ~executed
        masked = torch.where(valid, score, torch.full_like(score, -1))
        nxt = int(torch.argmax(masked))     # first maximum, like the host
        if not (first or bool(valid.any())):
            break                           # the rest is padding
        nxtdep = b[nxt]
        loaded = (seqs > loads_total - m) & nxtdep
        lastv = currdep & nxtdep & ~loaded
        seqv = nxtdep & ~loaded & ~lastv
        rank_seq = torch.cumsum(seqv.to(torch.int64), 0)
        rank_last = torch.cumsum(lastv.to(torch.int64), 0)
        n_seq = int(seqv.sum())
        n_last = int(lastv.sum())
        seqs = torch.where(
            seqv, loads_total + rank_seq,
            torch.where(lastv, loads_total + n_seq + rank_last, seqs))
        klass[i] = torch.where(
            loaded, 0, torch.where(seqv, 1, torch.where(lastv, 2, 3))
        ).to(torch.int32)
        oid[i, 0] = nxt
        ovl[i, 0] = int((currdep & nxtdep).sum())
        executed[nxt] = True
        loads_total += n_seq + n_last
        curr = nxt
    return oid, klass, ovl


def greedy_schedule_arrays(b: torch.Tensor, m: int
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Algorithm 1 over a TDT on the tensor's device.

    Returns oid_seq (n_out, 1) int32 (scheduled tile per step, -1 padding
    once every dependent tile is done), klass (n_out, n_in) int32 (per
    step, each input's priority class: 0 loaded / 1 seq / 2 last / 3 not
    a dependency) and ovl (n_out, 1) int32 (reuse overlap per step).
    """
    if b.dim() != 2:
        raise ValueError(f"TDT must be 2-D, got {tuple(b.shape)}")
    if m < 1:
        raise ValueError("buffer capacity must be >= 1 tile")
    if b.device.type == "cpu":
        return greedy_plain(b, m)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    from repro_torch.kernels import _build

    lib = _build.load()
    n_out, n_in = b.shape
    if n_in > _MAX_IDS or n_out > _MAX_IDS:
        raise ValueError(f"TDT {tuple(b.shape)} exceeds the greedy kernel's "
                         f"{_MAX_IDS} tile ids")
    dev = b.device
    oid = torch.empty((n_out, 1), dtype=torch.int32, device=dev)
    klass = torch.empty((n_out, n_in), dtype=torch.int32, device=dev)
    ovl = torch.empty((n_out, 1), dtype=torch.int32, device=dev)
    if n_out == 0:
        return oid, klass, ovl
    bu8 = (b != 0).contiguous()             # bool storage is 0/1 bytes
    in_smem = lib.greedy_schedule_smem_bytes(n_out, n_in, 1) > 0
    scratch = None
    if not in_smem:
        if lib.greedy_schedule_smem_bytes(n_out, n_in, 0) < 0:
            raise ValueError(f"TDT {tuple(b.shape)}: the greedy kernel's "
                             f"state does not fit in shared memory")
        words = (n_in + 31) // 32
        scratch = torch.empty((n_out * words,), dtype=torch.int32,
                              device=dev)
    err = lib.greedy_schedule_launch(
        bu8.data_ptr(), oid.data_ptr(), klass.data_ptr(), ovl.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_out, n_in,
        int(m), int(in_smem), _stream())
    _build.check(err, "greedy_schedule_launch")
    greedy_schedule_arrays.launches += 1
    return oid, klass, ovl


greedy_schedule_arrays.launches = 0


# ---------------------------------------------------------------------------
# Glue: class rows / TDT rows -> dense dispatch tables (plain torch)
# ---------------------------------------------------------------------------


def _pad_slots(order: torch.Tensor, cnt: torch.Tensor,
               k_pad: int) -> torch.Tensor:
    n_out, n_in = order.shape
    if k_pad < n_in:
        order = order[:, :k_pad]            # only valid if max cnt <= k_pad
    elif k_pad > n_in:
        order = torch.nn.functional.pad(order, (0, k_pad - n_in))
    slot = torch.arange(k_pad, device=order.device)[None, :]
    return torch.where(slot < cnt[:, None], order,
                       torch.zeros_like(order)).to(torch.int32)


def dispatch_arrays_from_klass(oid_seq: torch.Tensor, klass: torch.Tensor,
                               k_pad: int):
    """Greedy class rows -> (oid (n_out,), dep_tbl (n_out, k_pad), dep_cnt
    (n_out,)) int32 on the same device. The load order is class 0 ids
    ascending, then class 1, then class 2 — one STABLE argsort over the
    class row, exactly ``input_tile_scheduling``'s order."""
    oid = oid_seq.reshape(-1).to(torch.int32)
    order = torch.argsort(klass.to(torch.int32), dim=1, stable=True)
    cnt = (klass < 3).sum(dim=1).to(torch.int32)
    return oid, _pad_slots(order, cnt, k_pad), cnt


def tdt_dispatch_arrays(b: torch.Tensor, k_pad: int):
    """Dense dispatch rows straight from a TDT (no scheduling): per output
    tile its dependent input tiles in ascending id order, plus counts.
    Used for interior fused-group layers, whose grid order is plane
    order."""
    bi = (b != 0).to(torch.int32)
    order = torch.argsort(1 - bi, dim=1, stable=True)      # deps first, asc
    cnt = bi.sum(dim=1).to(torch.int32)
    return _pad_slots(order, cnt, k_pad), cnt
