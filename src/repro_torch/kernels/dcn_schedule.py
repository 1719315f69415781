"""On-device tile scheduling (paper §IV-B/C): TDT and Algorithm-1 kernels.

On the paper's ASIC the tile scheduler is a hardware block next to the
NNA: it builds the Tile Dependency Table from the stage-1 offsets and runs
Algorithm 1's greedy max-overlap selection. Here both steps are one CUDA
kernel (``csrc/dcn_schedule.cu``) behind three wrappers:

  * :func:`schedule_group_batch` — for a list of images of one fused
    group, in ONE launch: each layer's TDT, the chain's composite,
    Algorithm 1 on it, and the dispatch tables the batch-fused executor
    consumes (the load-ordered schedule and each DCN layer's rows);
  * :func:`tdt_from_coords_device` — one TDT (a batch of one, TDT only);
  * :func:`greedy_schedule_arrays` — Algorithm 1 over a given table (a
    batch of one), with its per-step class rows.

Each wrapper launches the kernel for CUDA tensors and counts the launch
in its plain-integer ``launches`` attribute; for CPU tensors it runs the
plain torch version beside it, which repeats the kernel's arithmetic, and
any other device raises. All are bit-exact against the host reference
(``core.tiles.tdt_from_coords`` and ``core.scheduler.schedule_tiles``).

The FIFO state trick: with load-only insertion and FIFO eviction, a tile
is resident iff its last-load sequence number is among the ``m`` most
recent loads, i.e. ``seq[t] > loads_total - m``. Within a step the
loaded-class tiles are all hits and the seq/last-class tiles all loads,
so a step's update is a rank assignment by prefix sum.

The glue that turns class rows into dispatch tables
(:func:`dispatch_arrays_from_klass`, :func:`tdt_dispatch_arrays`) is plain
torch for the per-image callers; the batch-fused path gets its tables
from :func:`schedule_group_batch` directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.tiles import (TileGrid, compose_tdt_chain_device,
                                    tdt_standard_conv)

# Sentinel "never loaded" sequence number: always evicted under
# ``seq > loads_total - m`` for any reachable loads_total/m.
_NEVER_LOADED = -(1 << 30)
_MAX_LAYERS = 8               # layers of one chain in one launch
_SMALL = 32                   # tables up to this many tiles: one warp
_BLOCK_MAX = 4096             # tiles the block body composes and schedules
_COORDS, _ROWS, _TABLE = 0, 1, 2


# ---------------------------------------------------------------------------
# Plain versions
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
    """Plain torch version of the TDT: per output tile, floor and clip its
    coordinates, decode the 4 neighbours, OR-reduce the row."""
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


def greedy_plain(b: torch.Tensor, m: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of Algorithm 1: the same step loop, the same
    state (executed mask, FIFO last-load sequence numbers, loads_total,
    curr), and the same first-max argmax."""
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


# ---------------------------------------------------------------------------
# The kernel's arguments and launch
# ---------------------------------------------------------------------------

_P8 = ctypes.c_void_p * _MAX_LAYERS


class _Args(ctypes.Structure):
    """``SchedArgs`` of ``csrc/dcn_schedule.cu``, field for field."""

    _fields_ = [
        ("src", _P8), ("tdt", _P8), ("exec_dep", _P8), ("exec_cnt", _P8),
        ("src_stride", ctypes.c_longlong * _MAX_LAYERS),
        ("images", ctypes.c_void_p), ("oid", ctypes.c_void_p),
        ("dep", ctypes.c_void_p), ("cnt", ctypes.c_void_p),
        ("ovl", ctypes.c_void_p), ("klass", ctypes.c_void_p),
        ("ar", ctypes.c_void_p), ("zero", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("out_stride", ctypes.c_longlong),
        ("scratch_words", ctypes.c_longlong),
        ("kind", ctypes.c_int * _MAX_LAYERS),
        ("kk", ctypes.c_int * _MAX_LAYERS),
    ] + [(n, ctypes.c_int) for n in (
        "n_layers", "n_images", "H", "W", "out_th", "out_tw", "out_cols",
        "n_out", "in_h", "in_w", "in_th", "in_tw", "in_cols", "n_in", "m",
        "k_pad", "greedy", "last_gather", "small", "imgs_per_block",
        "tables_in_smem")]


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load()
    if lib.schedule_args_size() != ctypes.sizeof(_Args):
        raise _build.KernelError(
            f"SchedArgs is {lib.schedule_args_size()} bytes in C, "
            f"{ctypes.sizeof(_Args)} in Python")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Call:
    """One prepared launch: its arguments and the tensors they point
    into. :meth:`launch` enqueues the kernel on the current stream (no
    count, no allocation), so a caller can time the bare launch."""

    def __init__(self, args: _Args, device: torch.device, keep: list):
        self.args, self.device, self.keep = args, device, keep

    def launch(self) -> None:
        from repro_torch.kernels import _build

        with torch.cuda.device(self.device):
            err = _lib().schedule_group_launch(
                ctypes.addressof(self.args),
                torch.cuda.current_stream(self.device).cuda_stream)
        _build.check(err, "schedule_group_launch")


def _ptr(t: torch.Tensor | None, words: int = 0) -> int | None:
    """Address of ``t`` plus ``words`` 32-bit words (None for no tensor)."""
    return None if t is None else t.data_ptr() + 4 * words


def _new_args(n_out: int, n_in: int, m: int = 1, k_pad: int = 0
              ) -> _Args:
    a = _Args()
    a.n_out, a.n_in, a.m, a.k_pad, a.last_gather = n_out, n_in, m, k_pad, -1
    a.out_th = a.out_tw = a.out_cols = a.in_th = a.in_tw = a.in_cols = 1
    a.H = a.W = a.in_h = a.in_w = 1
    return a


def _set_grids(a: _Args, h: int, w: int, in_grid: TileGrid,
               out_grid: TileGrid) -> None:
    a.H, a.W = h, w
    a.out_th, a.out_tw, a.out_cols = out_grid.th, out_grid.tw, out_grid.cols
    a.in_h, a.in_w = in_grid.h, in_grid.w
    a.in_th, a.in_tw, a.in_cols = in_grid.th, in_grid.tw, in_grid.cols


def _place(a: _Args, n_images: int, device: torch.device, keep: list,
           tables_in_smem: bool | None) -> None:
    """Pick the body (one warp per image for tables of <= 32 tiles, one
    block per image above) and, for the block body, where the bit tables
    live."""
    n_out, n_in = a.n_out, a.n_in
    if n_out <= _SMALL and n_in <= _SMALL:
        a.small = 1
        sms = _sm_count(device.index if device.index is not None
                        else torch.cuda.current_device())
        p = 1             # images share a block only past one wave
        while p < 32 and -(-n_images // p) > sms:
            p *= 2
        a.imgs_per_block = p
        return
    if (a.n_layers > 1 or a.greedy) and max(n_in, n_out) > _BLOCK_MAX:
        raise ValueError(f"TDT ({n_out}, {n_in}) exceeds the schedule "
                         f"kernel's {_BLOCK_MAX} tiles")
    lib = _lib()
    chain = int(any(a.kind[j] != _ROWS for j in range(a.n_layers - 1)))
    if lib.schedule_group_smem_bytes(n_out, n_in, chain, 0) < 0:
        raise ValueError(f"TDT ({n_out}, {n_in}): the schedule kernel's "
                         f"state does not fit in shared memory")
    fits = lib.schedule_group_smem_bytes(n_out, n_in, chain, 1) > 0
    in_smem = fits if tables_in_smem is None else bool(tables_in_smem)
    if in_smem and not fits:
        raise ValueError(f"TDT ({n_out}, {n_in}): the bit tables do not fit "
                         f"in shared memory")
    if not in_smem:
        a.scratch_words = lib.schedule_group_scratch_words(n_out, n_in, chain)
        scratch = torch.empty((n_images * a.scratch_words,),
                              dtype=torch.int32, device=device)
        keep.append(scratch)
        a.scratch = scratch.data_ptr()
    a.tables_in_smem = int(in_smem)


# ---------------------------------------------------------------------------
# TDT: sampling coordinates -> tile dependency table
# ---------------------------------------------------------------------------


def plan_tdt(coords: torch.Tensor, in_grid: TileGrid, out_grid: TileGrid,
             out: torch.Tensor) -> _Call:
    """The TDT-only launch of one image into ``out`` (T_out, T_in) bool."""
    h, w, kk, _ = coords.shape
    a = _new_args(out_grid.num_tiles, in_grid.num_tiles)
    _set_grids(a, h, w, in_grid, out_grid)
    a.n_layers, a.n_images = 1, 1
    a.kind[0], a.kk[0], a.src[0], a.tdt[0] = (_COORDS, kk, coords.data_ptr(),
                                              out.data_ptr())
    keep = [coords, out]
    _place(a, 1, coords.device, keep, None)
    return _Call(a, coords.device, keep)


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
    if (coords.dtype != torch.float32 or not coords.is_contiguous()
            or coords.data_ptr() % 8):
        raise ValueError("coords must be contiguous float32 at an 8-byte "
                         "boundary (the kernel reads (row, col) pairs)")
    t_out, n_in = out_grid.num_tiles, in_grid.num_tiles
    out = torch.empty((t_out, n_in), dtype=torch.bool, device=coords.device)
    if t_out == 0 or n_in == 0:
        return out
    plan_tdt(coords, in_grid, out_grid, out).launch()
    tdt_from_coords_device.launches += 1
    return out


tdt_from_coords_device.launches = 0


# ---------------------------------------------------------------------------
# Algorithm 1: greedy max-overlap selection over a given table
# ---------------------------------------------------------------------------


def plan_greedy(b: torch.Tensor, m: int, oid: torch.Tensor,
                klass: torch.Tensor, ovl: torch.Tensor,
                tables_in_smem: bool | None = None) -> _Call:
    """The greedy-only launch over ``b`` (n_out, n_in) bool, contiguous,
    into preallocated ``oid``, ``klass`` and ``ovl``."""
    n_out, n_in = b.shape
    a = _new_args(n_out, n_in, m)
    a.n_layers, a.n_images, a.greedy = 1, 1, 1
    a.kind[0], a.src[0] = _TABLE, b.data_ptr()
    a.oid, a.klass, a.ovl = oid.data_ptr(), klass.data_ptr(), ovl.data_ptr()
    keep = [b, oid, klass, ovl]
    _place(a, 1, b.device, keep, tables_in_smem)
    return _Call(a, b.device, keep)


def greedy_schedule_arrays(b: torch.Tensor, m: int, *,
                           tables_in_smem: bool | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Algorithm 1 over a TDT on the tensor's device.

    Returns oid_seq (n_out, 1) int32 (scheduled tile per step, -1 padding
    once every dependent tile is done), klass (n_out, n_in) int32 (per
    step, each input's priority class: 0 loaded / 1 seq / 2 last / 3 not
    a dependency) and ovl (n_out, 1) int32 (reuse overlap per step).
    ``tables_in_smem`` (CUDA only) forces the table into shared memory
    or global scratch; by default it goes where it fits.
    """
    if b.dim() != 2:
        raise ValueError(f"TDT must be 2-D, got {tuple(b.shape)}")
    if m < 1:
        raise ValueError("buffer capacity must be >= 1 tile")
    if b.device.type == "cpu":
        return greedy_plain(b, m)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    n_out, n_in = b.shape
    dev = b.device
    oid = torch.empty((n_out, 1), dtype=torch.int32, device=dev)
    klass = torch.empty((n_out, n_in), dtype=torch.int32, device=dev)
    ovl = torch.empty((n_out, 1), dtype=torch.int32, device=dev)
    if n_out == 0 or n_in == 0:
        # No dependency anywhere: step 0 takes tile 0, the rest is padding.
        oid.fill_(-1)
        oid[:1] = 0
        ovl.zero_()
        return oid, klass, ovl
    if b.dtype != torch.bool or not b.is_contiguous():
        b = (b != 0).contiguous()           # bool storage is 0/1 bytes
    plan_greedy(b, int(m), oid, klass, ovl, tables_in_smem).launch()
    greedy_schedule_arrays.launches += 1
    return oid, klass, ovl


greedy_schedule_arrays.launches = 0


# ---------------------------------------------------------------------------
# One fused group, a list of images, one launch
# ---------------------------------------------------------------------------


def _pack_rows(b: np.ndarray) -> np.ndarray:
    """(n_out, n_in) bool -> (n_out, ceil(n_in / 32)) int32 bit rows, id
    32 w + j at bit j of word w."""
    n_out, n_in = b.shape
    words = -(-n_in // 32)
    padded = np.zeros((n_out, words * 32), np.uint64)
    padded[:, :n_in] = b
    packed = (padded.reshape(n_out, words, 32)
              << np.arange(32, dtype=np.uint64)).sum(-1)
    return packed.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=64)
def _conv_tables(grid: TileGrid, kernel_size: int, device: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A standard conv's constant TDT on ``device``: the bool table and
    its bit rows, uploaded once."""
    b = tdt_standard_conv(grid, grid, kernel_size)
    return (torch.as_tensor(b, device=device),
            torch.as_tensor(_pack_rows(b), device=device))


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Word offsets of one image's outputs in its int32 segment."""

    t: int
    k_pad: int
    exec_off: tuple          # per layer: (dep, cnt) offsets, or None
    tdt_off: tuple           # per layer: TDT byte-region offset, or None
    words: int

    OID, CNT, OVL, ZERO, AR, DEP = (0, 1, 2, 3, 4, 5)   # x t words

    @classmethod
    def of(cls, kinds: list[int], t: int, k_pad: int) -> "_Layout":
        off = 5 * t + t * k_pad
        exec_off, tdt_off = [], []
        for kind in kinds:
            if kind == _ROWS:
                exec_off.append(None)
            else:
                exec_off.append((off, off + t * k_pad))
                off += t * k_pad + t
        for kind in kinds:
            tdt_off.append(off if kind == _COORDS else None)
            off += -(-t * t // 4) if kind == _COORDS else 0
        return cls(t, k_pad, tuple(exec_off), tuple(tdt_off),
                   -(-off // 4) * 4)


class ImageSchedule(NamedTuple):
    """One image's schedule bundle, views into its segment.

    tdt: per layer its (T, T) bool TDT; ``oid``/``dep_tbl``/``dep_cnt``/
    ``overlap``: the composite Algorithm-1 schedule (``DeviceSchedule``
    order); ``exec``: per layer (oid, dep, cnt, overlap) dispatch rows —
    a conv layer's None, an interior layer's in plane order (oid = ``ar``),
    the chain's last layer's gathered by the schedule."""

    tdt: list
    oid: torch.Tensor
    dep_tbl: torch.Tensor
    dep_cnt: torch.Tensor
    overlap: torch.Tensor
    ar: torch.Tensor
    zero: torch.Tensor
    exec: list

    def tensors(self) -> list[torch.Tensor]:
        """Every output of the image (for comparisons)."""
        out = [*self.tdt, self.oid, self.dep_tbl, self.dep_cnt,
               self.overlap, self.ar, self.zero]
        for e in self.exec:
            if e is not None:
                out += [e[1], e[2]]
        return out


@dataclasses.dataclass
class GroupSchedules:
    """The outputs of one :func:`schedule_group_batch` call: row k of
    ``buf`` (int32) is the k-th listed image's segment."""

    buf: torch.Tensor
    layout: _Layout
    tables: list             # per layer: None (a DCN layer's TDT is in
    #                          buf), a conv's shared (T, T) table, or the
    #                          given (N, T, T) tables
    images: list[int]
    last_gather: int

    def image(self, k: int, own: bool = False) -> ImageSchedule:
        """Image k's bundle; ``own`` copies its segment first, so that the
        bundle does not keep the whole call's storage alive."""
        lay, t, kp = self.layout, self.layout.t, self.layout.k_pad
        seg = self.buf[k].clone() if own else self.buf[k]

        def at(slot: int, n: int = 1) -> torch.Tensor:
            return seg[slot * t:slot * t + n * t]

        oid = at(lay.OID)
        ar, zero = at(lay.AR), at(lay.ZERO)
        tdt, execs = [], []
        for j, tbl in enumerate(self.tables):
            if lay.tdt_off[j] is not None:
                o = lay.tdt_off[j]
                tdt.append(seg[o:o + -(-t * t // 4)].view(torch.uint8)
                           [:t * t].view(t, t).view(torch.bool))
            elif tbl.dim() == 3:
                tb = tbl[self.images[k]]
                tdt.append(tb.clone() if own else tb)
            else:
                tdt.append(tbl)
            if lay.exec_off[j] is None:
                execs.append(None)
                continue
            d, c = lay.exec_off[j]
            execs.append((oid if j == self.last_gather else ar,
                          seg[d:d + t * kp].view(t, kp), seg[c:c + t], zero))
        return ImageSchedule(tdt, oid, at(lay.DEP, kp).view(t, kp),
                             at(lay.CNT), at(lay.OVL), ar, zero, execs)


def _group_spec(layers: Sequence, grid: TileGrid, device
                ) -> tuple[list[int], torch.device]:
    """Each layer's kind, and the device of the call."""
    if not 1 <= len(layers) <= _MAX_LAYERS:
        raise ValueError(f"a chain of 1..{_MAX_LAYERS} layers, got "
                         f"{len(layers)}")
    t = grid.num_tiles
    kinds, devs = [], set()
    for layer in layers:
        if isinstance(layer, (int, np.integer)):
            kinds.append(_ROWS)
            continue
        if not torch.is_tensor(layer):
            raise ValueError(f"a layer is coordinates, a table or a conv "
                             f"kernel size, got {type(layer).__name__}")
        devs.add(layer.device)
        if layer.dim() == 5:
            if (tuple(layer.shape[1:3]) != (grid.h, grid.w)
                    or layer.shape[-1] != 2
                    or layer.dtype != torch.float32
                    or not layer.is_contiguous()):
                raise ValueError(f"coordinates must be contiguous float32 "
                                 f"(N, {grid.h}, {grid.w}, KK, 2), got "
                                 f"{layer.dtype} {tuple(layer.shape)}")
            kinds.append(_COORDS)
        elif layer.dim() == 3 and layer.dtype == torch.bool:
            if tuple(layer.shape[1:]) != (t, t) or not layer.is_contiguous():
                raise ValueError(f"a given table must be contiguous "
                                 f"(N, {t}, {t}) bool, got "
                                 f"{tuple(layer.shape)}")
            kinds.append(_TABLE)
        else:
            raise ValueError(f"a layer tensor is (N, H, W, KK, 2) float32 "
                             f"or (N, T, T) bool, got {layer.dtype} "
                             f"{tuple(layer.shape)}")
    if device is not None:
        devs.add(torch.device(device))
    devs = {torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs}
    if len(devs) != 1:
        raise ValueError(f"one device per call, got {sorted(map(str, devs))}")
    return kinds, devs.pop()


def _group_tables(layers, kinds, grid, device) -> list:
    return [_conv_tables(grid, int(lay), str(device))[0] if k == _ROWS
            else (lay if k == _TABLE else None)
            for lay, k in zip(layers, kinds)]


def schedule_group_batch(layers: Sequence, images: Sequence[int],
                         grid: TileGrid, m: int, k_pad: int, *,
                         device=None, tables_in_smem: bool | None = None
                         ) -> GroupSchedules:
    """TDTs, composite and Algorithm-1 schedule of one fused group for the
    listed images of a batch, in ONE launch on CUDA.

    ``layers`` is the chain in execution order, each a DCN layer's
    sampling coordinates (N, H, W, KK, 2) float32, a standard conv's
    kernel size, or a given TDT per image (N, T, T) bool; every layer
    maps ``grid`` onto itself (T tiles). ``images`` lists the batch
    indices to schedule. ``k_pad`` (>= T) pads the dependency rows; ``m``
    is the input buffer's capacity in tiles. ``device`` is needed only
    when no layer is a tensor. ``tables_in_smem`` (CUDA only) forces the
    block body's bit tables into shared memory or global scratch.

    Per image the outputs are what the batch-fused prepass caches: each
    layer's TDT, the composite schedule in dispatch form (oid, the
    load-ordered dependency table, counts, overlaps) and each non-conv
    layer's dispatch rows — in plane order, or gathered by the schedule
    for the chain's last layer."""
    kinds, dev = _group_spec(layers, grid, device)
    images = [int(i) for i in images]
    if m < 1:
        raise ValueError("buffer capacity must be >= 1 tile")
    t = grid.num_tiles
    if k_pad < t:
        raise ValueError(f"k_pad={k_pad} below the {t} tiles of a row")
    if dev.type == "cpu":
        return schedule_group_batch_plain(layers, images, grid, m, k_pad,
                                          device=dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(torch.is_tensor(lay) and lay.data_ptr() % 8 for lay in layers):
        raise ValueError("layer tensors must start at an 8-byte boundary "
                         "(the kernel reads (row, col) pairs)")
    n_batch = max((lay.shape[0] for lay in layers if torch.is_tensor(lay)),
                  default=None)
    if n_batch is not None and any(not 0 <= i < n_batch for i in images):
        raise ValueError(f"image indices {images} outside a batch of "
                         f"{n_batch}")
    layout = _Layout.of(kinds, t, k_pad)
    out = GroupSchedules(
        torch.empty((len(images), layout.words), dtype=torch.int32,
                    device=dev),
        layout, _group_tables(layers, kinds, grid, dev), images,
        len(layers) - 1 if kinds[-1] != _ROWS else -1)
    if images:
        plan_group(layers, out, grid, m, tables_in_smem).launch()
        schedule_group_batch.launches += 1
    return out


schedule_group_batch.launches = 0


def plan_group(layers: Sequence, out: GroupSchedules, grid: TileGrid,
               m: int, tables_in_smem: bool | None = None) -> _Call:
    """The group launch that fills ``out`` (see
    :func:`schedule_group_batch`)."""
    lay, buf, t = out.layout, out.buf, out.layout.t
    dev = buf.device
    kinds, _ = _group_spec(layers, grid, dev)
    a = _new_args(t, t, m, lay.k_pad)
    _set_grids(a, grid.h, grid.w, grid, grid)
    a.n_layers, a.n_images = len(layers), len(out.images)
    a.greedy, a.last_gather = 1, out.last_gather
    keep: list = [buf]
    for j, (layer, kind) in enumerate(zip(layers, kinds)):
        a.kind[j] = kind
        if kind == _ROWS:
            rows = _conv_tables(grid, int(layer), str(dev))[1]
            keep.append(rows)
            a.src[j] = rows.data_ptr()
            continue
        keep.append(layer)
        a.src[j] = layer.data_ptr()
        a.src_stride[j] = layer[0].numel()
        d, c = lay.exec_off[j]
        a.exec_dep[j], a.exec_cnt[j] = _ptr(buf, d), _ptr(buf, c)
        if kind == _COORDS:
            a.kk[j] = layer.shape[3]
            a.tdt[j] = _ptr(buf, lay.tdt_off[j])
    a.oid, a.cnt, a.ovl = (_ptr(buf, s * t) for s in
                           (lay.OID, lay.CNT, lay.OVL))
    a.zero, a.ar, a.dep = (_ptr(buf, s * t) for s in
                           (lay.ZERO, lay.AR, lay.DEP))
    a.out_stride = lay.words
    if out.images != list(range(len(out.images))):
        # The identity list needs no upload: the kernel then takes the
        # k-th listed image as batch image k.
        idx = torch.tensor(out.images, dtype=torch.int32).pin_memory()
        idx = idx.to(dev, non_blocking=True)
        keep.append(idx)
        a.images = idx.data_ptr()
    _place(a, len(out.images), dev, keep, tables_in_smem)
    return _Call(a, dev, keep)


def schedule_group_batch_plain(layers: Sequence, images: Sequence[int],
                               grid: TileGrid, m: int, k_pad: int, *,
                               device=None) -> GroupSchedules:
    """Plain torch version of :func:`schedule_group_batch`: per image
    :func:`tdt_plain` per DCN layer, the composite
    (``compose_tdt_chain_device``), :func:`greedy_plain`, and the glue
    (:func:`dispatch_arrays_from_klass`, :func:`tdt_dispatch_arrays`, the
    gather by the schedule), written into the same layout."""
    kinds, dev = _group_spec(layers, grid, device)
    images = [int(i) for i in images]
    t = grid.num_tiles
    layout = _Layout.of(kinds, t, k_pad)
    out = GroupSchedules(
        torch.zeros((len(images), layout.words), dtype=torch.int32,
                    device=dev),
        layout, _group_tables(layers, kinds, grid, dev), images,
        len(layers) - 1 if kinds[-1] != _ROWS else -1)
    for k, i in enumerate(images):
        b_layers = [tdt_plain(lay[i], grid, grid) if kind == _COORDS
                    else (lay[i] if kind == _TABLE else tbl)
                    for lay, kind, tbl in zip(layers, kinds, out.tables)]
        oid_seq, klass, ovl = greedy_plain(
            compose_tdt_chain_device(b_layers), m)
        oid, dep, cnt = dispatch_arrays_from_klass(oid_seq, klass, k_pad)
        v = out.image(k)
        for dst, src in ((v.oid, oid), (v.dep_tbl, dep), (v.dep_cnt, cnt),
                         (v.overlap, ovl.reshape(-1))):
            dst.copy_(src)
        v.ar.copy_(torch.arange(t, dtype=torch.int32, device=dev))
        for j, (b, kind) in enumerate(zip(b_layers, kinds)):
            if kind == _COORDS:
                v.tdt[j].copy_(b)
            if v.exec[j] is None:
                continue
            dep_j, cnt_j = tdt_dispatch_arrays(b, k_pad)
            if j == out.last_gather:
                sel = oid.clamp_min(0).long()
                dep_j = dep_j[sel]
                cnt_j = torch.where(oid >= 0, cnt_j[sel],
                                    torch.zeros_like(cnt_j[sel]))
            v.exec[j][1].copy_(dep_j)
            v.exec[j][2].copy_(cnt_j)
    return out
