"""Trees of tensors in the JAX package's flatten order, and their
gradients.

A tree is nested dicts, lists, tuples and NamedTuples (the DCN
``DeformableConvParams``) with tensors, arrays or scalars as leaves; None
is an empty subtree. Leaves come out in ``jax.tree_util`` order — dict keys
sorted, lists and tuples in order, NamedTuple fields in field order — and
:func:`flatten_with_names` names each with ``jax.tree_util.keystr``'s
text (``['params']['convs'][0].w_off``), so a checkpoint written by either
package lists its leaves in the same order under the same names.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key text, child) pairs of an inner node; None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr name, leaf)] in flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids
            for item in flatten_with_names(child, prefix + key)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_names(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flatten
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def value_and_grad(fn: Callable, params):
    """``fn(params)`` and the gradient of its value (the first element
    when it returns a tuple, as ``has_aux``) with respect to every leaf of
    ``params``, as a tree of ``params``' structure. The leaves are taken
    detached, so ``params`` themselves never require grad; the value
    comes back detached."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    out = fn(tree_unflatten(params, leaves))
    value = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    out = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                   else t, out)
    return out, tree_unflatten(params, [
        torch.zeros_like(t) if g is None else g
        for t, g in zip(leaves, grads)])
