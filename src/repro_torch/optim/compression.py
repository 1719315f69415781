"""int8 quantization with a per-tensor scale, and the compressed
data-parallel all-reduce with error feedback.

``quantize``/``dequantize`` are the reference int8 fixed-point ops of the
paper's 8-bit PE evaluation (Table I) and the payload codec of the
compressed gradient all-reduce. :func:`compressed_psum_tree` is that
all-reduce (the JAX package's, which runs inside ``shard_map`` over the
data-parallel axes): here one controller holds every data row's
gradient tree and runs the collective's steps itself — the shared scale
is the max of the rows' scales (the JAX ``pmax``), the int8 payloads are
summed in int32 on one device (the ``psum``), and the decoded mean goes
back to every row. As in the JAX package, the train step does not call
it; it is a library function.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 values, fp32 scale). Symmetric per-tensor."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_tree(grads: list, err: list):
    """The data-parallel mean of row gradient trees through int8 payloads.

    ``grads[i]`` and ``err[i]`` are data row i's gradient and error trees
    (on the row's device). Per leaf: ``gf = grad + err``; every row
    quantizes against the same scale, the max of the rows' own
    (``max|gf| / 127``), so that the int sum is unbiased; the int8 values
    are summed in int32 on row 0's device and decoded to the mean
    (``sum * scale / rows``). -> (the decoded tree on every row's device,
    in the gradients' dtype; each row's new error ``gf - q * scale``),
    two lists of trees."""
    n = len(grads)
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in err]
    dev0 = flat_g[0][0].device
    out_g = [[] for _ in range(n)]
    out_e = [[] for _ in range(n)]
    for j in range(len(flat_g[0])):
        gf = [flat_g[i][j].float() + flat_e[i][j] for i in range(n)]
        scale = torch.stack([
            (torch.clamp(g.abs().max(), min=1e-12) / 127.0).to(dev0)
            for g in gf]).max()
        summed = None
        for i, g in enumerate(gf):
            s = scale.to(g.device)
            q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
            out_e[i].append(g - dequantize(q, s))
            q = q.to(dev0).to(torch.int32)
            summed = q if summed is None else summed + q
        decoded = summed.float() * scale / n
        for i in range(n):
            out_g[i].append(decoded.to(flat_g[i][j].device,
                                       flat_g[i][j].dtype))
    return ([tree_unflatten(grads[i], out_g[i]) for i in range(n)],
            [tree_unflatten(err[i], out_e[i]) for i in range(n)])
