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
