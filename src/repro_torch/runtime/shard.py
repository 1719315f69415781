"""Batch-dimension sharding of the batch-fused dispatch (scale-out).

The paper scales its accelerator by replicating the tile pipeline behind
one scheduler; the executor analogue shards the batch axis of
``dispatch="batch_fused"`` over the devices of a
:class:`~repro_torch.launch.mesh.DeviceMesh`. This module holds the
host-side plumbing shared by the pipeline and graph executors, as in the
JAX package:

* :class:`ShardPlan` — a contiguous partition of the batch over the
  mesh's "data" axis (serving passes explicit per-replica sizes so slot
  placement and shard placement agree).
* :func:`shard_batch_schedules` — per-shard ``pack_batch_schedules``:
  each shard keeps its OWN ragged padding (``k_pad`` / row count from
  its local images only), then pads to the cross-shard maximum with
  fully elided rows (``dep_cnt=0``, the shard's last dep repeated), so a
  slow replica never inflates another replica's real work.
* :func:`stack_rows` / :func:`unstack_rows` — reshuffle flat per-image
  row blocks into the ``(D, n_max*rows, ...)`` shard-stacked layout the
  sharded kernel call consumes, and back; :func:`scatter_shard_rows`
  puts a sharded dispatch's scheduled rows back in (image, tile) order
  first.

Scheduling, packing and traces are untouched: per-image schedules are
built exactly as on a single device, so executed traces stay equal to
the DRAM simulator whatever the placement.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from repro_torch.runtime.packing import pack_batch_schedules


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A contiguous partition of ``n`` batch images over shards.

    ``spans[s] = (start, stop)`` is shard ``s``'s image range; spans
    cover ``range(n)`` in order and may be empty (a replica with no
    occupied slot launches nothing).
    """

    n: int
    spans: tuple[tuple[int, int], ...]

    @property
    def n_shards(self) -> int:
        return len(self.spans)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(b - a for a, b in self.spans)

    @property
    def n_max(self) -> int:
        """Images on the fullest shard — the uniform slab size."""
        return max(self.sizes) if self.spans else 0


def plan_batch_shards(n: int, n_shards: int,
                      sizes: Sequence[int] | None = None) -> ShardPlan:
    """Partition ``n`` images contiguously over ``n_shards`` shards.

    The default is the near-even split (the first ``n % n_shards`` shards
    take one extra image). ``sizes`` pins an explicit per-shard image
    count (the serving engine's replica-aware placement), which must sum
    to ``n``; zeros are allowed.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if sizes is None:
        base, extra = divmod(n, n_shards)
        sizes = [base + (1 if s < extra else 0) for s in range(n_shards)]
    else:
        sizes = [int(s) for s in sizes]
        if len(sizes) != n_shards:
            raise ValueError(f"sizes has {len(sizes)} entries for "
                             f"{n_shards} shards")
        if any(s < 0 for s in sizes):
            raise ValueError(f"negative shard size in {sizes}")
        if sum(sizes) != n:
            raise ValueError(f"shard sizes {sizes} sum to {sum(sizes)}, "
                             f"expected {n}")
    spans, at = [], 0
    for s in sizes:
        spans.append((at, at + s))
        at += s
    return ShardPlan(n=n, spans=tuple(spans))


def resolve_shard_mesh(mesh, data_parallel: int | None):
    """The effective mesh of a config's ``mesh=`` / ``data_parallel=``
    knobs, or None for the single-device path.

    An explicit ``mesh`` wins; ``data_parallel=D`` builds a mesh over the
    first D CUDA devices at run time (device availability is checked
    there, not at config construction). A data axis of 1 is the
    single-device path."""
    if mesh is None:
        if not data_parallel or int(data_parallel) <= 1:
            return None
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(data=int(data_parallel))
    if dict(mesh.shape).get("data", 1) <= 1:
        return None
    return mesh


class ShardedDispatch(NamedTuple):
    """Per-shard :class:`~repro_torch.runtime.packing.BatchDispatch`
    tensors, stacked to the cross-shard maximum grid size. All ids are
    shard-LOCAL (row and dep bases restart at 0 per shard); ``oid`` is -1
    on padding rows of either origin (ragged image schedules or
    shard-size padding)."""

    row_id: torch.Tensor    # (D, G_loc) int32
    dep_glb: torch.Tensor   # (D, G_loc, k_pad) int32
    dep_cnt: torch.Tensor   # (D, G_loc) int32, 0 on padded slots
    oid: torch.Tensor       # (D, G_loc) int32, -1 on padding


def shard_batch_schedules(scheds, t_in: int, t_out: int, plan: ShardPlan,
                          device) -> ShardedDispatch:
    """Concatenate each shard's image schedules on their own, on
    ``device``, then pad to the uniform slab. The per-shard packs keep
    their own ragged ``k_pad``; cross-shard padding rows carry
    ``dep_cnt = 0`` and repeat the shard's last row (edge padding, the
    JAX package's ``mode="edge"``), so uniformity costs no real work."""
    if len(scheds) != plan.n:
        raise ValueError(f"{len(scheds)} schedules for a plan of "
                         f"{plan.n} images")
    packs = [pack_batch_schedules(list(scheds[a:b]), t_in, t_out, device)
             if b > a else None
             for a, b in plan.spans]
    n_rows = scheds[0].n_rows if scheds else t_out
    g_max = plan.n_max * n_rows
    k_max = max((p.dep_glb.shape[1] for p in packs if p is not None),
                default=1)
    i32 = dict(dtype=torch.int32, device=device)
    rows, deps, cnts, oids = [], [], [], []
    for p in packs:
        if p is None or p.row_id.shape[0] == 0:
            rows.append(torch.zeros((g_max,), **i32))
            deps.append(torch.zeros((g_max, k_max), **i32))
            cnts.append(torch.zeros((g_max,), **i32))
            oids.append(torch.full((g_max,), -1, **i32))
            continue
        g = p.row_id.shape[0]
        dep = p.dep_glb
        if dep.shape[1] < k_max:
            dep = torch.cat(
                [dep, dep[:, -1:].expand(g, k_max - dep.shape[1])], 1)
        if g < g_max:
            dep = torch.cat([dep, dep[-1:].expand(g_max - g, k_max)])
        pad = (0, g_max - g)
        rows.append(torch.nn.functional.pad(p.row_id, pad))
        deps.append(dep)
        cnts.append(torch.nn.functional.pad(p.dep_cnt, pad))
        oids.append(torch.nn.functional.pad(p.oid, pad, value=-1))
    return ShardedDispatch(
        row_id=torch.stack(rows).to(torch.int32),
        dep_glb=torch.stack(deps).to(torch.int32).contiguous(),
        dep_cnt=torch.stack(cnts).to(torch.int32),
        oid=torch.stack(oids).to(torch.int32))


def stack_rows(flat: torch.Tensor, plan: ShardPlan,
               rows: int) -> torch.Tensor:
    """(n*rows, ...) image-major rows -> (D, n_max*rows, ...) shard slabs,
    zero-padding shards below ``n_max`` images. ``rows`` is the per-image
    row count (tiles per plane, or 1 for whole planes)."""
    slab = plan.n_max * rows
    out = flat.new_zeros((plan.n_shards, slab) + tuple(flat.shape[1:]))
    for s, (a, b) in enumerate(plan.spans):
        out[s, :(b - a) * rows] = flat[a * rows:b * rows]
    return out


def unstack_rows(stacked: torch.Tensor, plan: ShardPlan,
                 rows: int) -> torch.Tensor:
    """Inverse of :func:`stack_rows`: drop the shard padding and restore
    the flat image-major row order."""
    parts = [stacked[s, :(b - a) * rows]
             for s, (a, b) in enumerate(plan.spans) if b > a]
    if not parts:
        return stacked.reshape((0,) + tuple(stacked.shape[2:]))
    return torch.cat(parts)


def scatter_shard_rows(y: torch.Tensor, shard, plan: ShardPlan,
                       rows: int) -> torch.Tensor:
    """Per-shard scatter of a sharded dispatch's rows (D, G_loc, ...) back
    to shard-local (image, tile) order, then unstacked to the true
    batch's flat rows (n*rows, ...). Padding rows of either origin
    (ragged schedules, shard-size fill) land in a dropped dump row."""
    d, slab = plan.n_shards, plan.n_max * rows
    target = torch.where(shard.oid >= 0, shard.row_id,
                         torch.full_like(shard.row_id, slab)).long()
    y_all = y.new_zeros((d, slab + 1) + tuple(y.shape[2:]))
    y_all[torch.arange(d, device=y.device)[:, None], target] = y
    return unstack_rows(y_all[:, :-1], plan, rows)


def allgather_nbytes(t: torch.Tensor) -> int:
    """Byte volume of gathering ``t`` from its shards — the collective
    cost the scale-out trace reports."""
    return int(t.numel()) * int(t.element_size())
