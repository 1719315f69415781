"""Carry parameters of the JAX package's models across to the port.

The JAX package's ``init_dcn_net`` returns a tree of ``DeformableConvParams``
(attributes ``w_off``, ``b_off``, ``w``, ``b``) and ``{"w", "b"}`` dicts.
The caller converts its leaves to numpy (``jax.tree.map(np.asarray,
params)``) and passes the tree here; this module never imports JAX. The
layouts (HWIO weights) are the same on both sides, so the port computes
the same function on the converted parameters. :func:`lm_params_from_jax`
does the same for the JAX package's ``init_lm`` tree (nested dicts and
lists, the layer stack as leading-dimension leaves under
``"stack"/"b{j}"``; MoE ``router`` / ``e_bias`` / ``shared`` leaves, MLA
leaves and the ``"mtp"`` subtree alike), whose layout the port keeps, and
:func:`opt_state_from_jax` for the JAX ``init_opt_state`` / ``adamw_update``
state ``{"step", "m", "v"}`` of either model. bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) arrive as torch bfloat16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.deform import DeformableConvParams


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(dev).contiguous()
    return torch.as_tensor(a).to(dev).contiguous()


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


def _tree_to_torch(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, dev) for v in tree]
    return _tensor(tree, dev)


def lm_params_from_jax(tree: dict[str, Any], device="cuda") -> dict[str, Any]:
    """JAX-package LM params (``init_lm``) with numpy leaves -> the port's
    params on ``device``; both then compute the same function."""
    return _tree_to_torch(tree, resolve_device(device))


def opt_state_from_jax(state: dict[str, Any], device="cuda") -> dict:
    """The JAX package's AdamW state with numpy leaves -> the port's
    (``step`` an int32 scalar tensor; ``m`` and ``v`` in the params'
    structure, DCN or LM) on ``device``."""
    dev = resolve_device(device)
    moments = params_from_jax if "convs" in state["m"] \
        else lm_params_from_jax
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "m": moments(state["m"], dev), "v": moments(state["v"], dev)}
