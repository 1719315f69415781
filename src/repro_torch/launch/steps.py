"""The LM train step on one device.

``build_train_step`` is the trainer's step: the loss and its gradient by
autograd (the JAX package's ``jax.value_and_grad``), then ``adamw_update``.
The JAX ``build_step`` also places every array by a sharding rule table;
those rules (``launch/sharding.py``) are not ported yet (ROADMAP.md §1), so
this step runs on the device its params lie on.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch._tree import tree_leaves, value_and_grad
from repro_torch.models import lm
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update


def build_train_step(cfg: ModelConfig,
                     opt_cfg: AdamWConfig | None = None) -> Callable:
    """-> ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``batch`` is ``{"tokens": (B, S+1[, n_cb])}``, with ``"cross_states"``
    (B, S_kv, d_cross) for a cross-attention model (numpy or tensors;
    moved to the params' device). ``metrics`` holds ``ce``, ``aux``,
    ``loss``, ``lr`` and ``grad_norm`` as scalar tensors. The update is written
    into ``params`` and ``opt_state`` (the JAX step's donated buffers),
    which come back as the same trees."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        (_, metrics), grads = value_and_grad(
            lambda p: lm.lm_loss(p, cfg, batch), params)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {
            **{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step
