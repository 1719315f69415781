"""Carry parameters of the JAX package's DCN models across to the port.

The JAX package's ``init_dcn_net`` returns a tree of ``DeformableConvParams``
(attributes ``w_off``, ``b_off``, ``w``, ``b``) and ``{"w", "b"}`` dicts.
The caller converts its leaves to numpy (``jax.tree.map(np.asarray,
params)``) and passes the tree here; this module never imports JAX. The
layouts (HWIO weights) are the same on both sides, so the port computes
the same function on the converted parameters.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.deform import DeformableConvParams


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True)).to(dev).contiguous()


def params_from_jax(tree: dict[str, Any], device="cuda") -> dict[str, Any]:
    """JAX-package DCN params with numpy leaves -> the port's params on
    ``device``."""
    dev = resolve_device(device)
    out: dict[str, Any] = {}
    for name, value in tree.items():
        if name == "convs":
            convs = []
            for p in value:
                if hasattr(p, "w_off"):
                    convs.append(DeformableConvParams(
                        _tensor(p.w_off, dev), _tensor(p.b_off, dev),
                        _tensor(p.w, dev), _tensor(p.b, dev)))
                else:
                    convs.append({"w": _tensor(p["w"], dev),
                                  "b": _tensor(p["b"], dev)})
            out[name] = convs
        else:
            out[name] = {k: _tensor(v, dev) for k, v in value.items()}
    return out
