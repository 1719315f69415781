"""Fused BLI(+)conv kernels (paper §IV-D fusion).

The deformed-feature tensor is K*K times the input feature map; the
paper's fusion keeps it on chip. Three entry points: per output row,
gather the deformed patch chunk by chunk in shared memory and contract it
with the main-conv weights, so the intermediate never reaches device
memory. In float32 all three run the split-C tensor-core body of
``csrc/dcn_fused_split.cuh``, whose C reduction is cut into
:func:`fused_splits` slices (a second pass adds them) so that a call of a
few rows still fills the card; float16 x, w and b run the same body with
float16 loads and stores (a float16 value widens to float32 exactly, so
the 3xTF32 products keep float32 accuracy, and the output is rounded once
to float16); on bf16 x, w and b they run the Hopper body of
``csrc/dcn_fused_bf16.cuh``, whose slices are the blocks of a thread block
cluster and merge on chip (:func:`fused_splits` with ``dtype``,
:func:`fused_grid_bf16`). The bf16 body splits the float32 patch into
three bf16 pieces, which is exact only in bf16's (float32's) exponent
range; float16 pieces would underflow and overflow, so float16 calls do
not take it.

* :func:`dcn_fused_batch` — the concatenated Algorithm-1 schedules of a
  whole batch in ONE launch (``batch_fused``; ``csrc/dcn_fused_batch.cu``),
  plane-global addresses localised against each row's dep tiles;
* :func:`dcn_fused_schedule` — one image's schedule in one call
  (``batched`` and the serving engine's degraded step;
  ``csrc/dcn_fused_schedule.cu``), slot-local addresses ``k*tp + offset``;
* :func:`dcn_fused_tile` — one output tile with its packed halo resident
  (``per_tile`` and ``ops.deformable_conv2d_pallas``; same source),
  addresses into ``[0, S)``, a leading batch dimension as grid rows.

:func:`dcn_fused_batch_sharded` is no kernel of its own: it runs
:func:`dcn_fused_batch` once per shard of a batch, each on its shard's
device of a :class:`~repro_torch.launch.mesh.DeviceMesh` (the TPU
package's ``shard_map`` of the batch kernel).

As the TPU kernels, each takes x, w and b in float32, bf16 or float16 and
the BLI coefficients in float32, widens to float32 inside (the deformed
patch stays float32), and returns x's dtype, the float32 sum plus b
rounded once. A call whose x, w and b do not share one type (the TPU
kernel takes that too) is widened to float32 in the wrapper, exactly,
runs the float32 kernel and is rounded once to x's dtype.

For a CPU tensor each wrapper runs its plain torch version, which repeats
the TPU kernel's dataflow (batch and schedule: per dep slot, localise the
addresses, 4-hot gather, accumulate the patch in float32; tile: the 4-hot
rows against ``iota(S)`` as a masked gather; then the contraction with
``w``); for a CUDA tensor it launches the kernel or raises. Each wrapper
counts its calls that launched in a plain-integer ``launches`` attribute
(a float32 split-C call launches its combine pass too), tallies them by
the type the kernel ran in (``"float32"``, ``"bfloat16"`` or
``"float16"``) in ``dtypes``, and records the grid of its last launch in ``last_grid``
(:func:`fused_grid`, or :func:`fused_grid_bf16` for a bf16 call) and its
``n_split`` in ``last_split``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch._device import is_fake_meta
from repro_torch.obs import get_tracer


def dcn_fused_batch_plain(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w,
                          b, *, t_in: int) -> torch.Tensor:
    """Plain torch version of the batch-fused kernel -> (G, P, C_out).

    Each grid row is contracted with ``w`` on its own, so a row's result
    does not depend on the other rows of the call: the sharded run, which
    calls this per shard, gives the single-device result bitwise (one
    matrix product over all rows would not — a BLAS picks its kernel,
    and so its summation order, by the row count)."""
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
    w2 = w.float().reshape(kk * c, o)
    out = torch.stack([a.reshape(p, kk * c) @ w2 for a in acc]) if g else \
        acc.new_zeros((0, p, o))
    return (out + b.float()).to(x_tiles.dtype)


def _check_operands(floats: dict, ints: dict,
                    dtypes: tuple = (torch.float32,),
                    fake: bool = False) -> torch.device:
    """Common operand checks: one device, contiguous, each float operand
    of one of ``dtypes`` (float32 unless the kernel takes more), int32,
    and no float operand that requires grad while grad mode is on: no
    kernel has a backward (in the JAX package neither), and a result
    written through a raw pointer would silently cut the graph. With
    ``fake``, the dry run's fake tensors on a ``meta`` device pass too
    (``_device.is_fake_meta``)."""
    first = next(iter(floats.values()))
    dev = first.device
    if torch.is_grad_enabled():
        for name, t in floats.items():
            if t.requires_grad:
                raise ValueError(
                    f"{name} requires grad: the kernel has no backward; "
                    f"train through the dense path, or call it under "
                    f"torch.no_grad() with detached operands")
    for name, t in {**floats, **ints}.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        if t.dtype not in dtypes:
            names = [str(d).removeprefix("torch.") for d in dtypes]
            names = " or ".join(filter(None, (", ".join(names[:-1]),
                                              names[-1])))
            raise ValueError(f"{name} must be {names}, got {t.dtype}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if dev.type not in ("cpu", "cuda") and not (fake and is_fake_meta(first)):
        raise ValueError(f"unsupported device {dev}")
    return dev


# Types of x, w and b that #1, #4 and #5 take (the coefficients are float32).
FUSED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The C entry points' code for an operand type.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype) -> int:
    """The type code the C entry points take: 0 float32, 1 bfloat16, 2
    float16."""
    return DTYPE_CODES[dtype]


def _check_fused(floats: dict, ints: dict) -> torch.device:
    """:func:`_check_operands` for #1, #4 and #5: x, w and b float32,
    bf16 or float16, the coefficients float32, as the packers give
    them."""
    dev = _check_operands(floats, ints, FUSED_DTYPES)
    if floats["coeff"].dtype != torch.float32:
        raise ValueError(f"coeff must be float32, got "
                         f"{floats['coeff'].dtype}")
    return dev


def _kernel_operands(x, w, b):
    """x, w and b as the CUDA body takes them: as they are where they
    share one type; else (a mixed call) widened to float32, exactly; the
    caller rounds the result once to x's dtype."""
    if x.dtype == w.dtype == b.dtype:
        return x, w, b
    return x.float(), w.float(), b.float()


def _count(fn, dtype: torch.dtype) -> None:
    """One launch of ``fn``'s kernel in ``dtype``."""
    fn.launches += 1
    key = str(dtype).removeprefix("torch.")
    fn.dtypes[key] = fn.dtypes.get(key, 0) + 1


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


# ---------------------------------------------------------------------------
# Launch shape of the split-C body (#1, #4 and #5)
# ---------------------------------------------------------------------------

# Tile of csrc/dcn_fused_split.cuh (BP, BO, BC there): a block owns 64
# output pixels x 128 output channels of one row and walks its slice of
# the C reduction in chunks of 16 input channels.
SPLIT_BP, SPLIT_BO, SPLIT_BC = 64, 128, 16
# SMs of an H100 SXM, for callers without a card (tests, planning).
H100_SMS = 132


def fused_splits(rows: int, p: int, o: int, c: int,
                 sm_count: int = H100_SMS,
                 dtype: torch.dtype = torch.float32,
                 clusters: dict | None = None) -> int:
    """Slices of the C reduction for one split-C call: 1 when the
    (row, pixel block, output-channel block) grid already fills one wave
    of two blocks on each of ``sm_count`` SMs; else the most slices that
    still fit that wave, each of the same whole number of
    ``SPLIT_BC``-channel chunks, never more slices than chunks. (A wave
    and a bit more runs as two: on an H100, #1's 320 blocks took 0.157 ms
    where 256 took 0.124.)

    For the bf16 body (``dtype`` bfloat16) the slices of a (unit pair,
    channel block) are the blocks of :func:`fused_cluster`'s clusters,
    each an even share of the stages (:func:`bf16_slices`): the most
    slices, at most the ``BF16_BC``-channel chunk count, whose clusters
    all run at once; ``clusters`` maps a cluster size to the clusters of
    that size the card runs at once (:func:`card_clusters`; by default
    ``H100_CLUSTERS`` at 132 SMs, else :func:`cluster_model`)."""
    if dtype == torch.bfloat16:
        if clusters is None:
            clusters = (H100_CLUSTERS if sm_count == H100_SMS
                        else cluster_model(sm_count))
        return _bf16_splits(rows, p, o, c, clusters)
    base = rows * math.ceil(p / SPLIT_BP) * math.ceil(o / SPLIT_BO)
    chunks = max(1, math.ceil(c / SPLIT_BC))
    if base == 0 or base >= 2 * sm_count:
        return 1
    want = min(chunks, 2 * sm_count // base)
    return math.ceil(chunks / math.ceil(chunks / want))


def split_channels(c: int, n_split: int) -> tuple[int, int]:
    """``(n_split, channels per slice)`` for a requested ``n_split``:
    slices of whole chunks, none empty (so at most the chunk count)."""
    chunks = max(1, math.ceil(c / SPLIT_BC))
    if not 1 <= n_split <= chunks:
        raise ValueError(f"n_split {n_split} must be in [1, {chunks}] for "
                         f"C={c} ({SPLIT_BC}-channel chunks)")
    per = math.ceil(chunks / n_split)
    return math.ceil(chunks / per), per * SPLIT_BC


def bf16_slices(c: int, kk: int, n_split: int) -> list[tuple[int, int]]:
    """The bf16 body's cut of a call's stages (``kk`` taps x ceil(C /
    BF16_BC) chunks, tap fastest) into ``n_split`` slices, at most the
    chunk count: slice x is stages [x S / n, (x + 1) S / n), whole stages,
    each at least one chunk's taps (none empty)."""
    chunks = max(1, math.ceil(c / BF16_BC))
    if not 1 <= n_split <= chunks:
        raise ValueError(f"n_split {n_split} must be in [1, {chunks}] for "
                         f"C={c} ({BF16_BC}-channel chunks)")
    stages = kk * chunks
    return [(x * stages // n_split, (x + 1) * stages // n_split)
            for x in range(n_split)]


def fused_grid(rows: int, p: int, o: int, n_split: int
               ) -> tuple[int, int, int, int]:
    """(rows, pixel blocks, output-channel blocks, n_split): the blocks of
    the first pass of a split-C call are their product."""
    return (rows, math.ceil(p / SPLIT_BP), math.ceil(o / SPLIT_BO), n_split)


# Tile of csrc/dcn_fused_bf16.cuh: a block owns 128 output channels of two
# units of 64 output pixels (a row's pixel block each; units pair in
# order) and walks its slice of C in 32-channel chunks. The n_split slices
# of a (unit pair, channel block) run as thread block clusters of at most
# MAX_CLUSTER blocks (the portable limit), one block a slice: one cluster
# merges its slices on chip; past MAX_CLUSTER slices, ceil(n_split / 8)
# clusters merge theirs and the last to finish adds the clusters' sums
# from a float32 workspace.
BF16_BP, BF16_BO, BF16_BC = 64, 128, 32
MAX_CLUSTER = 8
# Clusters of k blocks of the bf16 body (one block an SM) that an H100
# 80GB HBM3 runs at once, k = 1..8 (cudaOccupancyMaxActiveClusters, as
# `card_clusters` asks the card): whole clusters fit a GPC, so fewer than
# 132 // k.
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def cluster_model(sm_count: int) -> dict:
    """Clusters of k blocks that ``sm_count`` SMs run at once at one block
    an SM, ignoring how SMs group into GPCs: ``sm_count // k``."""
    return {k: sm_count // k for k in range(1, MAX_CLUSTER + 1)}


def fused_cluster(n_split: int) -> tuple[int, int]:
    """(blocks of a cluster, clusters a tile) for ``n_split`` slices of
    the bf16 body (``cluster_of`` and ``groups_of`` in the CUDA source):
    ceil(n_split / MAX_CLUSTER) clusters of the fewest blocks that hold
    the slices (a last cluster's blocks past the last slice add zeros)."""
    groups = math.ceil(n_split / MAX_CLUSTER)
    return math.ceil(n_split / groups), groups


def fused_grid_bf16(rows: int, p: int, o: int, n_split: int
                    ) -> tuple[int, int, int]:
    """The bf16 body's grid (cluster * clusters a tile, output-channel
    blocks, unit pairs): clusters of (cluster, 1, 1) blocks, one launch."""
    cluster, groups = fused_cluster(n_split)
    units = rows * math.ceil(p / BF16_BP)
    return (cluster * groups, math.ceil(o / BF16_BO), math.ceil(units / 2))


def _bf16_splits(rows: int, p: int, o: int, c: int, clusters: dict) -> int:
    base = math.ceil(rows * math.ceil(p / BF16_BP) / 2) * math.ceil(
        o / BF16_BO)
    chunks = max(1, math.ceil(c / BF16_BC))
    best = 1
    for k in range(2, chunks + 1):
        cluster, groups = fused_cluster(k)
        if clusters.get(cluster, 0) >= base * groups:
            best = k
    return best


_CARD_CLUSTERS: dict = {}
_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counts on ``device``, zero: the bf16 body's
    last cluster of a tile sets its count back to zero, so one buffer a
    card serves every call (launched in stream order)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def card_clusters(device: torch.device) -> dict:
    """Clusters of k blocks of the bf16 body that the card ``device`` runs
    at once, k = 1..``MAX_CLUSTER`` (``cudaOccupancyMaxActiveClusters``),
    asked once a card."""
    from repro_torch.kernels import _build

    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _CARD_CLUSTERS:
        lib = _build.load()
        got = {}
        with torch.cuda.device(idx):
            for k in range(1, MAX_CLUSTER + 1):
                n = ctypes.c_int(0)
                _build.check(lib.dcn_fused_bf16_max_clusters(
                    k, ctypes.byref(n)), "dcn_fused_bf16_max_clusters")
                got[k] = n.value
        _CARD_CLUSTERS[idx] = got
    return _CARD_CLUSTERS[idx]


def _card_splits(rows: int, p: int, o: int, c: int, dtype: torch.dtype,
                 device: torch.device) -> int:
    """:func:`fused_splits` on the card ``device``: its SM count, and for
    the bf16 body its cluster capacity."""
    if dtype == torch.bfloat16:
        return fused_splits(rows, p, o, c, dtype=dtype,
                            clusters=card_clusters(device))
    return fused_splits(rows, p, o, c, torch.cuda.get_device_properties(
        device).multi_processor_count)


def _launch_split(fn, entry: str, out: torch.Tensor, rows: int,
                  pointers: tuple, ints: tuple, n_split: int | None,
                  c: int) -> None:
    """A split-C call into ``out`` (rows, ..., P, O), whose dtype is the
    operands' (x, w, b): C entry point ``entry`` takes ``pointers``, the
    workspace, the tickets, ``out``, ``ints``, ``n_split``, the channels
    per slice (split-C body), the operands' :func:`dtype_code` and the
    stream; float32 and float16 calls run the split-C body, bf16 ones the
    Hopper body.
    Picks ``n_split`` by :func:`fused_splits` unless given; allocates the
    split-C body's float32 workspace, or the bf16 body's clusters' sums past
    one cluster a tile (one cluster merges its slices on chip) and its
    tickets; launches, checks, records the grid on ``fn.last_grid`` and
    counts the launch on ``fn``."""
    from repro_torch.kernels import _build

    lib = _build.load()
    p, o = out.shape[-2], out.shape[-1]
    bf16 = out.dtype == torch.bfloat16
    if n_split is None:
        n_split = _card_splits(rows, p, o, c, out.dtype, out.device)
    tickets = None
    if not bf16:
        n_split, c_split = split_channels(c, n_split)
        ws = (torch.empty((n_split, rows, p, o), dtype=torch.float32,
                          device=out.device) if n_split > 1 else out)
        grid = fused_grid(rows, p, o, n_split)
    else:
        bf16_slices(c, 1, n_split)  # checks n_split
        c_split = 0                 # the body cuts the stages itself
        grid = fused_grid_bf16(rows, p, o, n_split)
        groups = fused_cluster(n_split)[1]
        # float32 sums [groups][pairs][O-blocks][2 BF16_BP][BF16_BO] past
        # one cluster a tile; a count a (pair, O-block, rank).
        ws = (torch.empty(groups * grid[1] * grid[2] * 2 * BF16_BP * BF16_BO,
                          dtype=torch.float32, device=out.device)
              if groups > 1 else out)
        tickets = _tickets(out.device,
                           grid[0] // groups * grid[1] * grid[2]).data_ptr()
    # The C side sizes and launches on the current device: make it the
    # operands' own.
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(*pointers, ws.data_ptr(), tickets,
                                  out.data_ptr(), *ints, n_split, c_split,
                                  dtype_code(out.dtype), _stream(out))
    _build.check(err, entry)
    fn.last_grid, fn.last_split = grid, n_split
    _count(fn, out.dtype)


def _check_batch(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                 t_in: int) -> torch.device:
    dev = _check_fused(dict(x_tiles=x_tiles, coeff=coeff, w=w, b=b),
                       dict(row_id=row_id, dep_glb=dep_glb, dep_cnt=dep_cnt,
                            idx=idx))
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
    return dev


def _batch_call(dev, x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                t_in: int, n_split: int | None) -> torch.Tensor:
    """#1 on checked operands: the plain version on the CPU, else one
    launch on ``dev`` (counted on :func:`dcn_fused_batch`)."""
    if dev.type == "cpu":
        return dcn_fused_batch_plain(x_tiles, row_id, dep_glb, dep_cnt, idx,
                                     coeff, w, b, t_in=t_in)
    nt_in, tp, c = x_tiles.shape
    g, p, o = row_id.shape[0], idx.shape[1], w.shape[2]
    if g == 0 or p == 0:
        return torch.empty((g, p, o), dtype=x_tiles.dtype, device=dev)
    xk, wk, bk = _kernel_operands(x_tiles, w, b)
    out = torch.empty((g, p, o), dtype=xk.dtype, device=dev)
    _launch_split(
        dcn_fused_batch, "dcn_fused_batch_launch", out, g,
        (xk.data_ptr(), row_id.data_ptr(), dep_glb.data_ptr(),
         dep_cnt.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
         wk.data_ptr(), bk.data_ptr()),
        (g, dep_glb.shape[1], nt_in, t_in, tp, p, idx.shape[2], c, o),
        n_split, c)
    return out.to(x_tiles.dtype)


def dcn_fused_batch(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                    *, t_in: int, n_split: int | None = None
                    ) -> torch.Tensor:
    """Fused Eq. 2+3 over a whole batch's schedules -> (G, P, C_out).

    x_tiles (N*T_in, tp, C) f32, bf16 or f16 — every image's input tiles;
    row_id (G,) i32 — idx/coeff row ``img*T_out + out_tile`` per grid row;
    dep_glb (G, k_pad) i32 — global dep tiles ``img*T_in + dep`` in load
    order; dep_cnt (G,) i32 — true dep count (0 = padding row, output b);
    idx/coeff (N*T_out, P, KK, 4) — plane-global addresses
    ``tile*tp + offset`` and BLI coefficients (f32); w (KK, C, O); b
    (O,). The result is in x's dtype (module doc). ``n_split`` as for
    :func:`dcn_fused_schedule`.
    """
    dev = _check_batch(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, w, b,
                       t_in)
    with get_tracer().span("dispatch.batch_fused",
                           grid_rows=int(row_id.shape[0]),
                           c_out=int(w.shape[2])):
        return _batch_call(dev, x_tiles, row_id, dep_glb, dep_cnt, idx,
                           coeff, w, b, t_in, n_split)


dcn_fused_batch.launches = 0
dcn_fused_batch.dtypes = {}
dcn_fused_batch.last_grid = None
dcn_fused_batch.last_split = None


# ---------------------------------------------------------------------------
# The batch grid per device shard (the TPU package's `shard_map` of #1)
# ---------------------------------------------------------------------------


def _shard_extents(rows: int, sizes) -> list[int]:
    """Real leading rows of each shard's slab of ``rows`` (n_max *
    rows_per_image): ``sizes[s]`` images' rows."""
    n_max = max(sizes)
    if n_max == 0:
        return [0] * len(sizes)
    if rows % n_max:
        raise ValueError(f"slab of {rows} rows does not hold {n_max} "
                         f"images evenly")
    return [k * (rows // n_max) for k in sizes]


def _sharded_operands(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff, mesh,
                      sizes) -> int:
    d = mesh.shape["data"]
    for name, arr in (("x_tiles", x_tiles), ("row_id", row_id),
                      ("dep_glb", dep_glb), ("dep_cnt", dep_cnt),
                      ("idx", idx), ("coeff", coeff)):
        if arr.shape[0] != d:
            raise ValueError(
                f"{name} leading dim {arr.shape[0]} != mesh 'data' axis "
                f"size {d}")
    if len(sizes) != d or min(sizes) < 0:
        raise ValueError(f"sizes {list(sizes)} must give one image count "
                         f">= 0 per shard of {d}")
    return d


def dcn_fused_batch_sharded_plain(x_tiles, row_id, dep_glb, dep_cnt, idx,
                                  coeff, w, b, *, t_in: int
                                  ) -> torch.Tensor:
    """Plain torch version of :func:`dcn_fused_batch_sharded`:
    :func:`dcn_fused_batch_plain` over each shard's whole slab, on the
    operands' device -> (D, G_loc, P, C_out)."""
    return torch.stack([
        dcn_fused_batch_plain(x_tiles[s], row_id[s], dep_glb[s], dep_cnt[s],
                              idx[s], coeff[s], w, b, t_in=t_in)
        for s in range(x_tiles.shape[0])])


def dcn_fused_batch_sharded(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff,
                            w, b, *, mesh, t_in: int, sizes
                            ) -> torch.Tensor:
    """Fused Eq. 2+3 over per-device shards of a batch's schedules ->
    (D, G_loc, P, C_out) on ``x_tiles``' device; shard ``s`` runs #1 on
    ``mesh.devices[s]``.

    Every operand but the weights carries a leading shard axis of size
    D = ``mesh.shape["data"]``, as :func:`runtime.shard.stack_rows` and
    :func:`runtime.shard.shard_batch_schedules` lay it out: x_tiles (D,
    N_loc*T_in, tp, C), row_id / dep_cnt (D, G_loc), dep_glb (D, G_loc,
    k_pad), idx / coeff (D, N_loc*T_out, P, KK, 4), all shard-local ids.
    ``w`` and ``b`` lie on the caller's device and are copied to each
    other device once per mesh (``mesh.replica``).

    ``sizes`` (images per shard, ``ShardPlan.sizes``) trims each slab to
    its real images: shard ``s`` copies and launches only its first
    ``sizes[s]`` images' rows, and a shard of no image launches nothing.
    The rows it leaves are cross-shard padding (``dep_cnt = 0``), whose
    output is ``b`` as the kernel writes it. All shards' launches are
    issued before any result is copied back.

    On CUDA every shard takes the split the single-device call over the
    same rows would take, ``fused_splits(sum of real rows, ...)`` in the
    type the kernel runs in, so each row sums its C slices in the same
    order as the unsharded run: the result is bitwise the single-device
    one.
    """
    d = _sharded_operands(x_tiles, row_id, dep_glb, dep_cnt, idx, coeff,
                          mesh, sizes)
    if x_tiles.dim() != 4 or row_id.dim() != 2 or idx.dim() != 5:
        raise ValueError("x_tiles must be (D, N*T_in, tp, C), row_id "
                         "(D, G) and idx/coeff (D, rows, P, KK, 4)")
    home = x_tiles.device
    g_loc, p, o = row_id.shape[1], idx.shape[2], w.shape[2]
    rows = _shard_extents(g_loc, sizes)
    xs = _shard_extents(x_tiles.shape[1], sizes)
    ixs = _shard_extents(idx.shape[1], sizes)
    n_split = None
    if home.type == "cuda" and sum(rows) and p:
        c = x_tiles.shape[3]
        dev0 = mesh.devices[next(s for s in range(d) if rows[s])]
        kdtype = (x_tiles.dtype if x_tiles.dtype == w.dtype == b.dtype
                  else torch.float32)
        n_split = _card_splits(sum(rows), p, o, c, kdtype, dev0)
    with get_tracer().span("dispatch.batch_fused_sharded", shards=int(d),
                           grid_rows=int(d * g_loc), c_out=int(o)):
        done = []
        for s, dev in enumerate(mesh.devices):
            if not rows[s]:
                continue
            ops = [t.to(dev, non_blocking=True) for t in (
                x_tiles[s, :xs[s]], row_id[s, :rows[s]],
                dep_glb[s, :rows[s]], dep_cnt[s, :rows[s]],
                idx[s, :ixs[s]], coeff[s, :ixs[s]])]
            wd, bd = mesh.replica(w, dev), mesh.replica(b, dev)
            sdev = _check_batch(*ops, wd, bd, t_in)
            done.append((s, _batch_call(sdev, *ops, wd, bd, t_in, n_split)))
            if sdev.type == "cuda" and p:    # _batch_call launched #1
                dcn_fused_batch_sharded.launches += 1
        out = b.to(x_tiles.dtype).expand(d, g_loc, p, o).clone()
        for s, y in done:
            out[s, :rows[s]] = y.to(home, non_blocking=True)
        return out


dcn_fused_batch_sharded.launches = 0


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
                       block_p: int = 128,
                       n_split: int | None = None) -> torch.Tensor:
    """Fused Eq. 2+3 over one image's whole tile schedule -> (T, P, C_out).

    x_tiles (T_in, tp, C) f32, bf16 or f16 — every input tile of the plane;
    dep_tbl (T, k_pad) i32 — per scheduled tile its deps in load order;
    dep_cnt (T,) i32 — true dep count (0 = bias only); idx/coeff (T, P,
    KK, 4) — slot-local addresses ``k*tp + offset`` and BLI coefficients
    (f32); w (KK, C, O); b (O,); the result in x's dtype (module doc).
    Row t is scheduled tile t's output; the caller
    scatters rows by its schedule order. ``block_p`` keeps the TPU
    kernel's pixel-block contract: P must tile by ``min(block_p, P)``.
    ``n_split`` (CUDA only) overrides :func:`fused_splits`; the result
    does not depend on it beyond float32 summation order.
    """
    dev = _check_fused(dict(x_tiles=x_tiles, coeff=coeff, w=w, b=b),
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
        xk, wk, bk = _kernel_operands(x_tiles, w, b)
        out = torch.empty((t, p, o), dtype=xk.dtype, device=dev)
        _launch_split(
            dcn_fused_schedule, "dcn_fused_schedule_launch", out, t,
            (xk.data_ptr(), dep_tbl.data_ptr(), dep_cnt.data_ptr(),
             idx.data_ptr(), coeff.data_ptr(), wk.data_ptr(), bk.data_ptr()),
            (t, dep_tbl.shape[1], t_in, tp, p, idx.shape[2], c, o), n_split,
            c)
        return out.to(x_tiles.dtype)


dcn_fused_schedule.launches = 0
dcn_fused_schedule.dtypes = {}
dcn_fused_schedule.last_grid = None
dcn_fused_schedule.last_split = None


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


def dcn_fused_tile(x_tile, idx, coeff, w, b, *, block_p: int = 128,
                   n_split: int | None = None) -> torch.Tensor:
    """Fused Eq. 2+3 on one tile -> (..., P, C_out).

    x_tile (..., S, C) f32, bf16 or f16 — the packed halo buffer; idx/coeff
    (..., P, KK, 4) — addresses into ``[0, S)`` and BLI coefficients (f32);
    w (KK, C, O); b (O,); the result in x's dtype (module doc). Leading
    dimensions are a batch of independent tiles (JAX's
    ``vmap`` over images), all in one launch. ``n_split`` as for
    :func:`dcn_fused_schedule`.
    """
    dev = _check_fused(dict(x_tile=x_tile, coeff=coeff, w=w, b=b),
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
        if n == 0 or p == 0:
            return torch.empty((*lead, p, o), dtype=x_tile.dtype, device=dev)
        xk, wk, bk = _kernel_operands(x_tile, w, b)
        out = torch.empty((*lead, p, o), dtype=xk.dtype, device=dev)
        _launch_split(
            dcn_fused_tile, "dcn_fused_tile_launch", out, n,
            (xk.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
             wk.data_ptr(), bk.data_ptr()),
            (n, s, p, idx.shape[-2], c, o), n_split, c)
        return out.to(x_tile.dtype)


dcn_fused_tile.launches = 0
dcn_fused_tile.dtypes = {}
dcn_fused_tile.last_grid = None
dcn_fused_tile.last_split = None
