"""Per-chip FLOPs, HBM traffic, copies between devices and memory of one
step, counted from the aten ops it issues: the port's counterpart of the
JAX package's ``launch/hlo_analysis.py``.

The JAX dry run compiles a step for the production mesh and reads each
chip's numbers off the post-SPMD HLO. The port has no compiled program:
one controller issues every rank's work eagerly. So the dry run runs the
card's program itself, once, on fake tensors (``FakeTensorMode``) placed
on a mesh of ``meta:i`` devices (``launch.mesh.make_production_mesh``):
nothing is allocated or computed, but every aten op is issued with the
shapes, dtypes and devices it has on the card. :func:`analyze_step` runs
``fn(*args)`` under a ``TorchDispatchMode`` that charges each op to the
device its output lies on:

* ``flops``: the matmul and convolution FLOPs of
  ``torch.utils.flop_counter``'s registry (an op outside it is
  decomposed first, as ``FlopCounterMode`` does). A hand-written
  kernel's launch (#7, #8), which its wrapper reports instead of running
  it (:func:`kernel_launch`), counts the FLOPs of its plain version on
  the same operands;
* ``traffic_bytes`` / ``traffic_by_kind``: one HBM round trip per eager
  op, its tensor inputs read once and its outputs written once, by aten
  op name; a view or another op whose output aliases its input counts
  nothing, nor does an allocation (``empty``). A kernel launch counts its
  operands once and its output once, as kind ``flash_attention`` /
  ``flash_decode``;
* ``attn_traffic_bytes``: the traffic of ops whose output is an attention
  score matrix, by ``hlo_analysis.py``'s structural rule (the two
  trailing dims both sequence or chunk lengths, at least 2^20 values);
* ``collective_bytes`` / ``collectives``: the bytes of every copy between
  two devices of the mesh, charged to the receiving device, by the port
  function that issued it (the innermost frame in the package, with
  " (backward)" where autograd issued it): one controller moves tensors
  by copies, not by JAX's five collective kinds;
* ``memory``: ``argument_bytes``, the distinct storages of the tensors in
  ``args``; ``output_bytes``, those of the result; ``temp_bytes``, the
  peak of the storages the step allocated and held at once, the result's
  left out, each freed when its last tensor goes; ``peak_bytes``, the
  same peak with the result's in (what a caching allocator's peak rises
  by over the step).

Every number is per device: the top-level value is the largest device's
(per kind for the dicts), and ``per_device`` lists each device's, in the
mesh's row-major order, with the chips it stands for (``chips``; a mesh
past 128 chips lists a device for several, ``launch.mesh.meta_mesh``,
and the top-level values leave such a device out). An op whose output
lies on no device of the mesh is counted in ``off_mesh_ops``.
"""

from __future__ import annotations

import collections
import math
import os
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ALLOCATING = frozenset(p.__name__ for p in (
    torch.ops.aten.empty, torch.ops.aten.empty_strided,
    torch.ops.aten.empty_like, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided))
_ACTIVE: list = []          # the analyses running, innermost last


def _tensors(obj) -> list:
    """The tensors in nested dicts, lists and tuples, and in placed trees
    and caches (``ShardedTree`` / ``ShardedCache``, by their shards)."""
    out, stack = [], [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "shards"):
            stack.append(x.shards)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_score_shaped(shape, score_dims) -> bool:
    """``hlo_analysis.py``'s ``_is_score_shaped`` for one tensor: the two
    trailing dims both in ``score_dims`` and at least 2^20 values."""
    return (len(shape) >= 2 and shape[-1] in score_dims
            and shape[-2] in score_dims and math.prod(shape) >= 1 << 20)


class _Tally:
    def __init__(self):
        self.flops = 0
        self.traffic = 0
        self.attn = 0
        self.by_kind = collections.Counter()
        self.colls: dict = {}
        self.launches = collections.Counter()
        self.kernel_flops = collections.Counter()
        self.args = 0
        self.outputs = 0
        self.temp = 0
        self.peak = 0


class OpAnalysis(TorchDispatchMode):
    """The dispatch mode :func:`analyze_step` runs a step under."""

    def __init__(self, mesh=None, score_dims=None):
        super().__init__()
        flat = [d for row in mesh.ranks for d in row] if mesh else []
        self.chips = collections.Counter(flat)
        self.devices = list(self.chips) if mesh is not None else None
        self.score_dims = set(score_dims or ())
        self.tally: dict = collections.defaultdict(_Tally)
        self.off_mesh = 0
        self.ops = 0
        self._aliasing: dict = {}
        self._arg_keys: set = set()
        # Storages the step allocated: per key, [tensors alive, serial].
        self._live: dict = {}
        self._seen: dict = {}         # id(tensor) -> storage key
        self._events: list = []       # (device, serial, +/- bytes)
        self._serial = 0
        self._open = True

    # -- bookkeeping ---------------------------------------------------------
    def _on_mesh(self, dev) -> bool:
        return self.devices is None or dev in self.devices

    def note_args(self, args) -> None:
        held = {}
        for t in _tensors(args):
            st = t.untyped_storage()
            self._arg_keys.add(st._cdata)
            if self._on_mesh(t.device):
                held[st._cdata] = (t.device, st.nbytes())
        for dev, n in held.values():
            self.tally[dev].args += n

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until its last tensor goes."""
        if id(t) in self._seen:               # an in-place op's result
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._arg_keys:
            return
        live = self._live.get(key)
        if live is None:
            self._serial += 1
            live = self._live[key] = [0, self._serial, t.device, st.nbytes()]
            self._events.append((t.device, self._serial, live[3]))
        live[0] += 1
        self._seen[id(t)] = key
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        if not self._open:
            return
        self._seen.pop(tid, None)
        live = self._live[key]
        live[0] -= 1
        if live[0] == 0:
            del self._live[key]
            self._events.append((live[2], live[1], -live[3]))

    def _aliases(self, func) -> bool:
        """Whether every output of ``func`` aliases an input read-only (a
        view, ``alias``): such an op moves no bytes."""
        hit = self._aliasing.get(func)
        if hit is None:
            rets = func._schema.returns
            hit = self._aliasing[func] = func.is_view or (bool(rets) and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets))
        return hit

    @staticmethod
    def _issuer() -> str:
        """The port function that issued the running op: the innermost
        frame in the package, with " (backward)" under autograd."""
        f = sys._getframe(2)
        label = "?"
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(_PKG) and path != __file__:
                mod = os.path.relpath(path, _PKG)[:-3].replace(os.sep, ".")
                label = f"{mod}.{f.f_code.co_qualname.split('.<locals>')[0]}"
                break
            f = f.f_back
        if torch._C._current_autograd_node() is not None:
            label += " (backward)"
        return label

    # -- the dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            # As FlopCounterMode: an op outside the registry is decomposed
            # first, so both count the same products.
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out
        dev = outs[0].device
        if not self._on_mesh(dev):
            self.off_mesh += 1
            return out
        self.ops += 1
        for t in outs:
            self._track(t)
        tally = self.tally[dev]
        ins = _tensors((args, kwargs))
        moved = sum(_nbytes(t) for t in ins
                    if t.device != dev and t.device.type == dev.type
                    and self._on_mesh(t.device))
        if moved:
            c = tally.colls.setdefault(self._issuer(), [0, 0])
            c[0] += 1
            c[1] += moved
        count = flop_registry.get(packet)
        if count is not None:
            tally.flops += count(*args, **kwargs, out_val=out)
        if packet.__name__ in _ALLOCATING or self._aliases(func):
            return out
        nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        tally.traffic += nb
        tally.by_kind[packet.__name__] += nb
        if self.score_dims and any(_is_score_shaped(t.shape, self.score_dims)
                                   for t in outs):
            tally.attn += nb
        return out

    def kernel(self, name: str, operands, out, flops: int) -> None:
        if not self._on_mesh(out.device):
            self.off_mesh += 1
            return
        tally = self.tally[out.device]
        tally.launches[name] += 1
        tally.kernel_flops[name] += flops
        tally.flops += flops
        nb = sum(_nbytes(t) for t in operands) + _nbytes(out)
        tally.traffic += nb
        tally.by_kind[name] += nb

    # -- the result ----------------------------------------------------------
    def result(self, out) -> dict:
        self._open = False
        held = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            if self._on_mesh(t.device):
                held[st._cdata] = (t.device, st.nbytes())
        for dev, n in held.values():
            self.tally[dev].outputs += n
        kept = {self._live[k][1] for k in held if k in self._live}
        live, live_all = collections.Counter(), collections.Counter()
        for dev, serial, delta in self._events:
            tally = self.tally[dev]
            live_all[dev] += delta
            tally.peak = max(tally.peak, live_all[dev])
            if serial not in kept:
                live[dev] += delta
                tally.temp = max(tally.temp, live[dev])
        devices = self.devices if self.devices is not None else sorted(
            self.tally, key=lambda d: (d.type, d.index or 0))
        rows = [dict(self._device_row(self.tally[d]),
                     chips=self.chips.get(d, 1)) for d in devices]
        names = sorted({n for d in devices for n in self.tally[d].launches})
        # A device that stands for several chips reports no number.
        own = [k for k, r in enumerate(rows) if r["chips"] == 1] or \
            range(len(rows))
        top = lambda key: max((rows[k][key] for k in own), default=0)
        kinds = collections.Counter()
        colls: dict = {}
        for d in (devices[k] for k in own):
            for kind, nb in self.tally[d].by_kind.items():
                kinds[kind] = max(kinds[kind], nb)
            for who, (n, nb) in self.tally[d].colls.items():
                c = colls.setdefault(who, {"count": 0, "bytes": 0})
                c["count"], c["bytes"] = max(c["count"], n), max(c["bytes"],
                                                                 nb)
        return {
            "flops": top("flops"),
            "traffic_bytes": top("traffic_bytes"),
            "attn_traffic_bytes": top("attn_traffic_bytes"),
            "traffic_by_kind": dict(kinds.most_common()),
            "collective_bytes": top("collective_bytes"),
            "collectives": dict(sorted(colls.items(),
                                       key=lambda kv: -kv[1]["bytes"])),
            "memory": {k: max((rows[j]["memory"][k] for j in own),
                              default=0)
                       for k in ("argument_bytes", "output_bytes",
                                 "temp_bytes", "peak_bytes")},
            "kernels": {n: {"launches": [self.tally[d].launches[n]
                                         for d in devices],
                            "flops": [self.tally[d].kernel_flops[n]
                                      for d in devices]}
                        for n in names},
            "ops": self.ops,
            "off_mesh_ops": self.off_mesh,
            "devices": [str(d) for d in devices],
            "per_device": rows,
        }

    @staticmethod
    def _device_row(t: _Tally) -> dict:
        return {"flops": t.flops, "traffic_bytes": t.traffic,
                "attn_traffic_bytes": t.attn,
                "collective_bytes": sum(nb for _, nb in t.colls.values()),
                "memory": {"argument_bytes": t.args,
                           "output_bytes": t.outputs,
                           "temp_bytes": t.temp, "peak_bytes": t.peak}}


def kernel_launch(name: str, operands, out, flops: int) -> None:
    """A hand-written kernel's launch on fake tensors, reported by its
    wrapper to the running analysis (none: nothing is recorded)."""
    if _ACTIVE:
        _ACTIVE[-1].kernel(name, operands, out, flops)


def analyze_step(fn, *args, mesh=None, score_dims=None) -> dict:
    """``fn(*args)`` run once under the analysis; see the module doc.
    ``args`` hold fake tensors (``StepBundle.args_abstract``), and ``fn``
    runs inside their ``FakeTensorMode``. ``mesh`` (a
    ``launch.mesh.DeviceMesh``) gives the devices and their order; without
    it, every device an op wrote to, in index order."""
    fake = next((t.fake_mode for t in _tensors(args)
                 if isinstance(t, FakeTensor)), None)
    if fake is None:
        raise ValueError("analyze_step runs fn on fake tensors: build the "
                         "arguments inside a FakeTensorMode "
                         "(StepBundle.args_abstract)")
    analysis = OpAnalysis(mesh, score_dims)
    analysis.note_args(args)
    _ACTIVE.append(analysis)
    try:
        with fake, analysis:
            out = fn(*args)
    finally:
        _ACTIVE.pop()
    return analysis.result(out)
