"""Device meshes over ("data", "model"), driven by one controller.

The JAX package places arrays on a ``jax.sharding.Mesh`` with axes
("data", "model") and runs sharded programs from one Python process. The
port keeps that single controller: a :class:`DeviceMesh` is a grid of
devices, one row a data replica and one column a model rank, and the
port issues each shard's work on its own device from the same process,
copying operands there and results back. The batch-sharded DCN executor
reads the data axis only (``devices``: row i's device); the LM path
splits heads, MLP columns, the vocabulary and experts over the model
axis (``launch.sharding``, ``models.moe``). No process group is
involved, so a mesh may list one device several times — the counterpart
of ``--xla_force_host_platform_device_count`` — which lets the whole
sharded path run on one card (or on the CPU in the tests); on such a
mesh no copy between devices happens, and none is measured.

Functions, not module-level constants: importing this module touches no
device.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from repro_torch._device import resolve_device


def _pinned(device) -> torch.device:
    """``device`` resolved (CUDA needs a card) with a CUDA index filled
    in, so that it compares equal to a tensor's ``.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data, model) grid of devices: ``ranks[i][r]`` is the device of
    model rank r in data row i. Built from a flat tuple of devices, it has
    one rank a row: ``DeviceMesh((d0, d1))`` is a (2, 1) mesh. Frozen and
    hashable, so a config that holds one stays a frozen value; two meshes
    over the same grid are equal.

    A mesh also keeps the copies of read-only tensors (a layer's
    weights) that :meth:`replica` made for its devices, so that a caller
    who keeps one mesh copies each weight to each device once."""

    ranks: tuple[tuple[torch.device, ...], ...]
    _replicas: dict = dataclasses.field(default_factory=dict, compare=False,
                                        hash=False, repr=False)

    def __post_init__(self):
        ranks = tuple(tuple(_pinned(d) for d in row)
                      if isinstance(row, (tuple, list)) else (_pinned(row),)
                      for row in self.ranks)
        if not ranks or len({len(row) for row in ranks}) != 1 or \
                not ranks[0]:
            raise ValueError("a mesh needs at least one device, and rows "
                             "of equal length")
        object.__setattr__(self, "ranks", ranks)

    @classmethod
    def on(cls, device, data: int = 1, model: int = 1) -> "DeviceMesh":
        """A (data, model) mesh that lists ``device`` ``data * model``
        times: every shard on one device, the counterpart of JAX's forced
        host devices."""
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                             f"model={model}")
        return cls(((_pinned(device),) * int(model),) * int(data))

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The data axis: row i's device (its rank 0), in shard order."""
        return tuple(row[0] for row in self.ranks)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.ranks), "model": len(self.ranks[0])}

    def device(self, i: int, r: int = 0) -> torch.device:
        """The device of model rank ``r`` in data row ``i``."""
        return self.ranks[i][r]

    def replica(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """``t`` on ``device``: ``t`` itself where it already lies there,
        else a copy made once per (tensor or view of it, device) while the
        tensor is alive and unchanged. A view made anew on every call (a
        reshaped weight) finds its copy by its base tensor, address,
        shape and strides; the version counter, which views share with
        their base, catches an in-place update."""
        if t.device == device:
            return t
        base = t if t._base is None else t._base
        key = (id(base), t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
               device)
        hit = self._replicas.get(key)
        if hit is not None and hit[0]() is base and hit[1] == t._version:
            return hit[2]
        copy = t.to(device, non_blocking=True)
        self._replicas[key] = (weakref.ref(base, lambda _, k=key:
                                           self._replicas.pop(k, None)),
                               t._version, copy)
        return copy


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the first ``data * model`` CUDA
    devices of this host, row-major (device ``i * model + r`` is rank r
    of row i, as JAX's ``make_mesh`` lays out its devices).

    Validates the request against the live device count up front, and
    never repeats a device or falls back to the CPU: a mesh that lists
    one device several times is spelled :meth:`DeviceMesh.on`."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if data * model > have:
        raise ValueError(
            f"make_host_mesh(data={data}, model={model}) needs "
            f"{data * model} devices but only {have} "
            f"{'is' if have == 1 else 'are'} available — run on a host "
            f"with more CUDA devices, list one device {data * model} times "
            f"with DeviceMesh.on(device, data={data}, model={model}), or "
            f"shrink the mesh")
    grid = tuple(tuple(torch.device("cuda", i * model + r)
                       for r in range(model)) for i in range(data))
    return DeviceMesh(grid)


def mesh_chips(mesh: DeviceMesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n
