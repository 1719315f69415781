"""Fault-tolerant checkpointing: atomic, keep-N, async.

The JAX package's on-disk format, so either package restores the other's
checkpoints: ``<dir>/step_<n:08d>/`` holds one ``leaf_<i:05d>.npy`` per
tree leaf, in the JAX flatten order (``repro_torch._tree``), and a
``manifest.json`` with each leaf's ``keystr`` name, file, shape and dtype.
Writes go to ``step_<n>.tmp`` and are renamed only after the manifest is
fsync'd, so a killed writer never leaves a torn checkpoint visible:
``restore`` reads the newest *complete* step. Arrays are written whole, so
a restore may target another device than the writer's.

bfloat16 leaves are stored as their 16-bit patterns (``uint16``; numpy has
no bfloat16) under the manifest dtype ``bfloat16``.

``AsyncCheckpointer`` copies the tree to the host synchronously — the
trainer updates its tensors in place right after — and writes the files
on a background thread, so the loop waits for the copy, not the disk.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import (flatten_with_names, tree_leaves, tree_map,
                               tree_unflatten)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return np.array(leaf, copy=True)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, keep: int | None = 3) -> str:
    """Atomic checkpoint write. Returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(flatten_with_names(tree)):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": _dtype_name(leaf, arr)})
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    if keep is not None:
        for old in sorted(completed_steps(ckpt_dir))[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                          ignore_errors=True)
    return final


def completed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = completed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":     # 16-bit patterns, ours or JAX's
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def restore(ckpt_dir: str, step: int, like_tree, device="cuda"):
    """The checkpoint of ``step`` in the structure and dtypes of
    ``like_tree`` (its leaves are read for shape and dtype only), every
    leaf on ``device``."""
    dev = resolve_device(device)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = tree_leaves(like_tree)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree {len(flat_like)}")
    leaves = []
    for rec, like in zip(manifest["leaves"], flat_like):
        t = _load(os.path.join(final, rec["file"]), rec["dtype"])
        if list(t.shape) != list(like.shape):
            raise ValueError(f"{rec['name']}: checkpoint shape "
                             f"{list(t.shape)}, tree {list(like.shape)}")
        leaves.append(t.to(device=dev, dtype=like.dtype))
    return tree_unflatten(like_tree, leaves)


class AsyncCheckpointer:
    """Host-snapshot now, write later. One in-flight write at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree):
        self.wait()
        host_tree = tree_map(
            lambda l: (l.detach().to("cpu", copy=True)
                       if isinstance(l, torch.Tensor)
                       else np.array(l, copy=True)), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, keep=self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
