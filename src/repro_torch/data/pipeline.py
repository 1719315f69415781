"""Synthetic data pipeline: deterministic, host-sharded, prefetched.

At 1000+-node scale every host generates only its own shard of the global
batch (``host_slice``), keyed by (seed, step, host) so restarts resume the
exact stream with no coordination. A background thread keeps ``prefetch``
batches ahead of the training loop.

Token streams are Zipf-distributed over the vocab (more realistic gradient
sparsity for embedding/MoE paths than uniform); image batches for the
DCN nets are mixtures of Gabor-ish blobs so deformable offsets see real
spatial structure.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq: int = 128
    global_batch: int = 8
    n_codebooks: int = 1
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    cross_tokens: int = 0
    cross_dim: int = 0


def host_slice(cfg: DataConfig) -> tuple[int, int]:
    per = cfg.global_batch // cfg.n_hosts
    return cfg.host_id * per, per


def token_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Deterministic batch for (seed, step, host)."""
    start, per = host_slice(cfg)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    shape = ((per, cfg.seq + 1, cfg.n_codebooks) if cfg.n_codebooks > 1
             else (per, cfg.seq + 1))
    z = rng.zipf(cfg.zipf_a, size=shape)
    tokens = np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)
    out = {"tokens": tokens}
    if cfg.cross_tokens:
        out["cross_states"] = rng.standard_normal(
            (per, cfg.cross_tokens, cfg.cross_dim)).astype(np.float32)
    return out


def image_batch(cfg: DataConfig, step: int, img: int = 32,
                channels: int = 3, classes: int = 10):
    start, per = host_slice(cfg)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id, 7]))
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32) / img
    x = np.zeros((per, img, img, channels), np.float32)
    labels = rng.integers(0, classes, size=(per,))
    for i in range(per):
        for _ in range(3):  # blob mixture; label modulates frequency
            cy, cx = rng.uniform(0.2, 0.8, 2)
            f = 2.0 + labels[i] + rng.uniform(0, 2)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) * 24.0)
            wave = np.sin(2 * np.pi * f * (xx * rng.uniform(-1, 1)
                                           + yy * rng.uniform(-1, 1)))
            x[i] += (blob * wave)[..., None] * rng.standard_normal(channels)
    # label-dependent radial pattern: a learnable but non-trivial signal
    for i in range(per):
        r = np.sqrt((yy - 0.5) ** 2 + (xx - 0.5) ** 2)
        x[i, :, :, 0] += 0.8 * np.cos(2 * np.pi * (labels[i] + 1) * r)
    x += 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    return {"images": x, "labels": labels.astype(np.int32)}


class PrefetchIterator:
    """Background-thread prefetch over a ``step -> batch`` function."""

    def __init__(self, fn, start_step: int = 0, prefetch: int = 2):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
