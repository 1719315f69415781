"""Device resolution shared by the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for CUDA
on a machine without a usable card raises: nothing quietly moves to the
CPU, so a run that reports GPU numbers really ran on the GPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain versions")
    return dev


def is_fake_meta(t) -> bool:
    """True for a ``FakeTensor`` on a ``meta`` device: the stand-in that
    the dry run (``launch.dryrun``) runs the card's program on. No real
    tensor is one, so no real call takes a path meant for it."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor) and t.device.type == "meta"


def takes_kernel(t) -> bool:
    """Whether a kernel site takes its hand-written kernel's branch for
    ``t``: a CUDA tensor, and the dry run's fake tensor, whose call the
    wrapper reports to the analysis instead of launching; a CPU tensor
    takes the plain version."""
    return t.device.type == "cuda" or is_fake_meta(t)


def storage_key(t: torch.Tensor) -> tuple[int, int]:
    """(storage identity, element offset) of ``t``: where its memory
    starts, as a key that views of one storage share while it is alive.
    A fake tensor has no data pointer to key by (every ``meta`` storage
    reads 0), so the key is the storage's own identity."""
    return t.untyped_storage()._cdata, t.storage_offset()
