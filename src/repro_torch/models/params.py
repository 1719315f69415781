"""Parameter construction for the LM models.

Every init function is written once against a :class:`Maker`, a factory
called as ``mk(shape, axes, init=..., scale=...)`` for each leaf, with the
JAX package's four init rules: ``normal`` (scale 0.02 unless given),
``fan_in`` (normal times ``scale / sqrt(prod(shape[:-1]))``), ``zeros`` and
``ones``. Draws come from an explicit ``torch.Generator``, so the numbers
differ from ``jax.random``: compare the two packages through
``repro_torch.convert.lm_params_from_jax``. ``device="meta"`` builds the
tree without memory (shapes only; :func:`abstract_params`). The logical ``axes`` are kept in the
signature for the sharding helpers of the scale-out work and are not used
yet.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


class Maker:
    """Leaf factory on ``device`` in ``dtype``; ``lead`` is prepended to
    every shape (the layer stack of :func:`stacked`)."""

    def __init__(self, generator: torch.Generator | None = None, *,
                 device="cpu", dtype=torch.float32,
                 lead: tuple[int, ...] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.lead = tuple(lead)

    def __call__(self, shape: tuple[int, ...], axes: tuple[str | None, ...],
                 init: str = "normal", scale: float | None = None):
        assert len(shape) == len(axes), (shape, axes)
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
                    lead=mk.lead + (n,)))


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
