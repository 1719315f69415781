"""Device meshes for batch-axis scale-out, driven by one controller.

The JAX package shards the batch over a ``jax.sharding.Mesh`` with axes
("data", "model") and runs the shards through ``shard_map`` from one
Python process. The port keeps that single controller: a
:class:`DeviceMesh` lists the devices of its "data" axis, and the
executor issues each shard's kernel launch on its own device from the
same process, copying operands there and results back. No process group
is involved, so a mesh may list one device several times — the
counterpart of ``--xla_force_host_platform_device_count`` — which lets
the whole sharded path run on one card (or on the CPU in the tests).

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
    """The devices of a mesh's "data" axis, in shard order (the "model"
    axis is 1). Frozen and hashable, so a config that holds one stays a
    frozen value; two meshes over the same devices are equal.

    A mesh also keeps the copies of read-only tensors (a layer's
    weights) that :meth:`replica` made for its devices, so that a caller
    who keeps one mesh copies each weight to each device once."""

    devices: tuple[torch.device, ...]
    _replicas: dict = dataclasses.field(default_factory=dict, compare=False,
                                        hash=False, repr=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(_pinned(d) for d in self.devices))

    @classmethod
    def on(cls, device, data: int) -> "DeviceMesh":
        """A mesh that lists ``device`` ``data`` times: ``data`` shards
        on one device, the counterpart of JAX's forced host devices."""
        if data < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={data}")
        return cls((_pinned(device),) * int(data))

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": 1}

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
    """A ``(data, model)`` mesh over the first ``data`` CUDA devices of
    this host — the scale-out executor path (``data_parallel=``).

    Validates the request against the live device count up front, and
    never repeats a device or falls back to the CPU: a mesh that lists
    one device several times is spelled :meth:`DeviceMesh.on`. The
    "model" axis (tensor parallelism) is not ported; it must be 1."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if data * model > have:
        raise ValueError(
            f"make_host_mesh(data={data}, model={model}) needs "
            f"{data * model} devices but only {have} "
            f"{'is' if have == 1 else 'are'} available — run on a host "
            f"with more CUDA devices, list one device {data} times with "
            f"DeviceMesh.on(device, data={data}), or shrink the mesh")
    if model != 1:
        raise NotImplementedError(
            f"make_host_mesh(model={model}): the model axis (tensor "
            f"parallelism) is not ported; only data-axis meshes are")
    return DeviceMesh(tuple(torch.device("cuda", i) for i in range(data)))


def mesh_chips(mesh: DeviceMesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n
