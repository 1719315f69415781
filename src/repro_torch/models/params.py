"""Parameter construction for the LM models.

Every init function is written once against a :class:`Maker`, a factory
called as ``mk(shape, axes, init=..., scale=...)`` for each leaf, with the
JAX package's four init rules: ``normal`` (scale 0.02 unless given),
``fan_in`` (normal times ``scale / sqrt(prod(shape[:-1]))``), ``zeros`` and
``ones``. Draws come from an explicit ``torch.Generator``, so the numbers
differ from ``jax.random``: compare the two packages through
``repro_torch.convert.lm_params_from_jax``. ``device="meta"`` builds the
tree without memory (shapes only; :func:`abstract_params`).

A Maker made with ``axes=True`` returns each leaf's :class:`LogicalAxes`
in place of a tensor (:func:`param_axes`). :func:`resolve_spec` maps them
to mesh axes under a rule table (``launch.sharding.sharding_rules``), as
the JAX package's does: a spec is a tuple with, per dimension, a mesh-axis
name, a tuple of names or None (the JAX ``PartitionSpec``), and a mesh
axis that does not divide its dimension or is already used is dropped.
:class:`ShardedTree` is a tree placed on a ``launch.mesh.DeviceMesh`` by
such specs: device (i, r) of the mesh holds, of every leaf, its slice for
data row i and model rank r.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class LogicalAxes:
    """Names the logical sharding axis of each tensor dimension."""

    axes: tuple[str | None, ...]

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)


class Maker:
    """Leaf factory on ``device`` in ``dtype``; ``lead`` is prepended to
    every shape (the layer stack of :func:`stacked`). With ``axes=True``
    it returns each leaf's :class:`LogicalAxes` instead, a stacked leaf's
    with ``"layers"`` first."""

    def __init__(self, generator: torch.Generator | None = None, *,
                 device="cpu", dtype=torch.float32,
                 lead: tuple[int, ...] = (), axes: bool = False):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.lead = tuple(lead)
        self.axes = axes

    def __call__(self, shape: tuple[int, ...], axes: tuple[str | None, ...],
                 init: str = "normal", scale: float | None = None):
        assert len(shape) == len(axes), (shape, axes)
        if self.axes:
            return LogicalAxes(("layers",) * len(self.lead) + tuple(axes))
        full = self.lead + tuple(shape)
        kw = dict(dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(full, **kw)
        if init == "ones":
            return torch.ones(full, **kw)
        if init == "normal":
            s = scale if scale is not None else 0.02
        elif init == "fan_in":
            fan = math.prod(shape[:-1])
            s = (scale if scale is not None else 1.0) / math.sqrt(max(fan, 1))
        else:
            raise ValueError(f"unknown init {init!r}")
        if self.device.type == "meta":
            return torch.empty(full, **kw)
        return torch.randn(full, generator=self.generator, **kw).mul_(s)


def make_generator(seed: int, device) -> torch.Generator | None:
    """A generator seeded with ``seed`` on ``device`` (None on "meta")."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def stacked(n: int, fn: Callable, mk: Maker):
    """``n`` stacked copies of ``fn``'s params: each leaf gains a leading
    dimension of size ``n`` (the layer loop indexes it)."""
    return fn(Maker(mk.generator, device=mk.device, dtype=mk.dtype,
                    lead=mk.lead + (n,), axes=mk.axes))


def leaves(tree):
    """The tensors of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        for key in tree:
            yield from leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from leaves(item)
    else:
        yield tree


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def abstract_params(fn: Callable, dtype=torch.float32):
    """``fn(mk)``'s tree on ``device="meta"``: shapes and dtypes, no
    memory (the JAX package's ``ShapeDtypeStruct`` tree)."""
    return fn(Maker(device="meta", dtype=dtype))


def param_count(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def param_axes(fn: Callable):
    """``fn(mk)``'s tree of :class:`LogicalAxes`, one a leaf."""
    return fn(Maker(axes=True))


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and the matching
    leaves of ``rest``); anything else is a leaf: a tensor, a
    :class:`LogicalAxes`, a spec tuple, None."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[j] for r in rest))
                for j, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Logical axes -> mesh axes, and trees placed on a mesh
# ---------------------------------------------------------------------------

def _leaf_list(tree) -> list:
    """The leaves of a :func:`map_tree` tree (a spec tuple is a leaf)."""
    out: list = []
    map_tree(out.append, tree)
    return out


def _unflat(like, flat: list):
    """A tree of ``like``'s structure holding ``flat`` in order."""
    it = iter(flat)
    return map_tree(lambda _: next(it), like)


def resolve_spec(axes: LogicalAxes, shape: tuple[int, ...], rules: dict,
                 mesh) -> tuple:
    """LogicalAxes -> spec under ``rules``: per dimension the mesh axis
    (or tuple of axes) its logical axis maps to, or None. A mesh axis
    missing from ``mesh.shape``, already used by an earlier dimension, or
    whose size does not divide the dimension leaves it replicated."""
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, axes.axes):
        target = rules.get(name) if name else None
        if target is None:
            out.append(None)
            continue
        tgt = (target,) if isinstance(target, str) else tuple(target)
        tgt = tuple(t for t in tgt if t in mesh.shape and t not in used)
        size = math.prod(mesh.shape[t] for t in tgt) if tgt else 1
        if not tgt or dim % size != 0:
            out.append(None)
            continue
        used.update(tgt)
        out.append(tgt[0] if len(tgt) == 1 else tgt)
    return tuple(out)


def tree_specs(axes_tree, abstract_tree, rules, mesh):
    """An axes tree zipped with a tree of tensors (``meta`` ones will do)
    -> the tree of their specs."""
    return map_tree(lambda a, t: resolve_spec(a, tuple(t.shape), rules,
                                              mesh),
                    axes_tree, abstract_tree)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(spec, shape, mesh_shape, i: int, r: int):
    """Per dimension, the (start, size) that device (i, r) holds."""
    coord = {"data": i, "model": r}
    out = []
    for dim, entry in zip(shape, spec):
        n, k = 1, 0
        for a in _names(entry):
            n *= mesh_shape[a]
            k = k * mesh_shape[a] + coord[a]
        out.append((k * (dim // n), dim // n))
    return out


def _narrow(t, block):
    for dim, (start, size) in enumerate(block):
        if size != t.shape[dim]:
            t = t.narrow(dim, start, size)
    return t


@dataclasses.dataclass
class ShardedTree:
    """A tree placed on a (data, model) mesh by a spec a leaf: device
    (i, r), ``mesh.device(i, r)``, holds ``shards[i][r]``, the tree of the
    leaves' slices for data row i and model rank r. A leaf a spec does
    not split is held whole by every device; on a mesh that lists one
    device several times every slice is a view of the tree placed, so
    placing copies nothing there.

    Indexing (``tree["layers"]``) and :meth:`layers` give placed subtrees;
    :meth:`local` is what rank (i, r) computes with, :meth:`whole` what
    its data row runs an unsplit function on."""

    mesh: object
    specs: object
    shards: list

    @classmethod
    def place(cls, tree, specs, mesh) -> "ShardedTree":
        d, m = mesh.shape["data"], mesh.shape["model"]

        def put(t, spec, i, r):
            block = _block(spec, t.shape, mesh.shape, i, r)
            return _narrow(t, block).to(mesh.device(i, r))

        return cls(mesh, specs, [[map_tree(lambda t, s: put(t, s, i, r),
                                           tree, specs)
                                  for r in range(m)] for i in range(d)])

    def __getitem__(self, key) -> "ShardedTree":
        return ShardedTree(self.mesh, self.specs[key],
                           [[s[key] for s in row] for row in self.shards])

    def __contains__(self, key) -> bool:
        return key in self.specs

    def layers(self) -> list["ShardedTree"]:
        """Every layer of a stacked subtree (its leading "layers"
        dimension, which no rule splits), as views: one ``unbind`` a held
        leaf, whose backward stacks the layers' gradients once (a slice a
        layer would add a zero-filled stack-sized gradient per layer)."""
        specs = map_tree(lambda s: s[1:], self.specs)
        n = next(leaves(self.shards[0][0])).shape[0]
        per = [[map_tree(lambda t: torch.unbind(t, 0), s) for s in row]
               for row in self.shards]
        return [ShardedTree(self.mesh, specs,
                            [[map_tree(lambda u: u[index], s) for s in row]
                             for row in per])
                for index in range(n)]

    def local(self, i: int, r: int):
        """Rank (i, r)'s tree: every dimension the "model" axis splits as
        its own slice, every dimension split over "data" (FSDP) gathered
        onto its device from the other rows' slices — a copy made at use,
        freed with the tree."""
        dev = self.mesh.device(i, r)
        m = self.mesh.shape["model"]

        def get(spec, *held):
            dims = [k for k, e in enumerate(spec) if "data" in _names(e)]
            if not dims:
                return held[i * m + r]
            (k,) = dims                      # an axis splits one dimension
            if spec[k] == "data":
                parts = held[r::m]
                if len(parts) == 1:          # one data row: nothing to gather
                    return parts[0].to(dev)
                return torch.cat([t.to(dev) for t in parts], dim=k)
            # (data, model) on one dimension: no other dimension is split
            # over "model", so the rank computes with the leaf whole.
            return self._assemble(spec, held, dev)

        return map_tree(get, self.specs, *self._flat())

    def whole(self, i: int = 0, device=None):
        """Every leaf whole on data row i's device, ``mesh.device(i,
        0)``, or on ``device``: a leaf no spec splits as row i's rank 0
        holds it (moved to ``device``), others gathered from every
        device's slice."""
        dev = self.mesh.device(i, 0) if device is None else device
        m = self.mesh.shape["model"]

        def get(spec, *held):
            if not any(spec):
                return held[i * m].to(dev)
            return self._assemble(spec, held, dev)

        return map_tree(get, self.specs, *self._flat())

    def map(self, fn) -> "ShardedTree":
        """``fn`` over every held slice, placed as this tree."""
        return ShardedTree(self.mesh, self.specs,
                           [[map_tree(fn, s) for s in row]
                            for row in self.shards])

    def groups(self, spec) -> list[list[int]]:
        """The devices, by flat index ``i * model + r``, that hold each
        distinct slice of a leaf of ``spec``, one list a slice, its first
        device the slice's home: a leaf not split over "data" is held by
        every data row, one not split over "model" by every rank of a
        row."""
        axes = {a for e in spec for a in _names(e)}
        m = self.mesh.shape["model"]
        out: dict = {}
        for k in range(len(self._flat())):
            i, r = divmod(k, m)
            key = (i if "data" in axes else 0, r if "model" in axes else 0)
            out.setdefault(key, []).append(k)
        return list(out.values())

    def flat_leaves(self) -> list[list]:
        """Every device's leaves, in (i, r) order, each in the order of
        :meth:`spec_leaves`."""
        out = []
        for s in self._flat():
            held: list = []
            map_tree(lambda _, t: held.append(t), self.specs, s)
            out.append(held)
        return out

    def spec_leaves(self) -> list:
        """The leaves' specs in :func:`map_tree` order (dict keys as the
        spec tree inserted them)."""
        return _leaf_list(self.specs)

    def slices(self) -> list[list[list]]:
        """Per leaf, per distinct slice, the tensors that hold it, its
        home's first (:meth:`groups`)."""
        held = self.flat_leaves()
        return [[[held[k][j] for k in ks] for ks in self.groups(spec)]
                for j, spec in enumerate(self.spec_leaves())]

    def per_slice(self, fn) -> "ShardedTree":
        """A tree placed as this one whose every distinct slice is
        ``fn(j, ks)`` (leaf j, its holders' flat indices, home first),
        made once on the home device and held by every holder: the same
        tensor on a device the mesh lists several times, a copy on
        another device."""
        n_dev = len(self._flat())
        out = [[None] * len(self.spec_leaves()) for _ in range(n_dev)]
        for j, spec in enumerate(self.spec_leaves()):
            for ks in self.groups(spec):
                value = fn(j, ks)
                for k in ks:
                    i, r = divmod(k, self.mesh.shape["model"])
                    out[k][j] = value.to(self.mesh.device(i, r))
        m = self.mesh.shape["model"]
        rows = [[_unflat(self.specs, out[i * m + r]) for r in range(m)]
                for i in range(self.mesh.shape["data"])]
        return ShardedTree(self.mesh, self.specs, rows)

    def zeros(self, dtype) -> "ShardedTree":
        """Zeros of ``dtype`` placed as this tree, one tensor a distinct
        slice (the AdamW moments)."""
        held = self.flat_leaves()
        return self.per_slice(lambda j, ks: torch.zeros(
            held[ks[0]][j].shape, dtype=dtype, device=held[ks[0]][j].device))

    def _flat(self) -> list:
        """Every device's tree, in (i, r) order."""
        return [s for row in self.shards for s in row]

    def _assemble(self, spec, held, dev):
        """A leaf whole on ``dev`` from every device's slice."""
        m = self.mesh.shape["model"]
        shape = [sz * math.prod(self.mesh.shape[a] for a in _names(e))
                 for sz, e in zip(held[0].shape, spec)]
        out = torch.empty(shape, dtype=held[0].dtype, device=dev)
        for n, t in enumerate(held):
            blk = _block(spec, shape, self.mesh.shape, n // m, n % m)
            _narrow(out, blk).copy_(t)
        return out
