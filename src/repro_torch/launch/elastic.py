"""Elastic scaling and failure-handling policy of the trainer (a copy of
the JAX package's ``launch.elastic``, which imports nothing).

  * **Checkpoint/restart** — atomic keep-N checkpoints
    (``repro_torch.checkpoint``) plus a preemption hook: on SIGTERM the
    trainer finishes the in-flight step, writes a checkpoint, and exits 42
    (the launcher treats 42 as "clean preemption, reschedule").
  * **Elastic re-mesh** — checkpoints are topology-free (whole arrays), so
    a restart may target a different mesh; ``plan_remesh`` picks the
    largest usable (data, model) grid for the surviving chip count. The
    port trains on one device so far (ROADMAP.md §1).
  * **Straggler mitigation** — synchronous steps cannot drop a slow worker
    mid-step, so mitigation is between steps: the trainer tracks a rolling
    step-time EWMA; when a step exceeds ``straggler_factor`` x EWMA more
    than ``patience`` times, it recommends a re-mesh excluding the slow
    host (the launcher decides replacement).
"""

from __future__ import annotations

import dataclasses
import signal


@dataclasses.dataclass
class ElasticConfig:
    straggler_factor: float = 2.0
    patience: int = 3
    ewma_alpha: float = 0.1
    min_model_parallel: int = 1


class PreemptionGuard:
    """SIGTERM -> finish step, checkpoint, exit(42)."""

    def __init__(self):
        self.requested = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # not in main thread (tests)
            pass

    def _handler(self, signum, frame):
        self.requested = True


class StragglerDetector:
    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self.ewma: float | None = None
        self.strikes = 0

    def observe(self, step_time_s: float) -> bool:
        """Returns True when a re-mesh is recommended."""
        if self.ewma is None:
            self.ewma = step_time_s
            return False
        slow = step_time_s > self.cfg.straggler_factor * self.ewma
        self.strikes = self.strikes + 1 if slow else 0
        self.ewma = ((1 - self.cfg.ewma_alpha) * self.ewma
                     + self.cfg.ewma_alpha * step_time_s)
        return self.strikes >= self.cfg.patience


def plan_remesh(n_chips: int, model_parallel: int,
                cfg: ElasticConfig | None = None) -> tuple[int, int]:
    """Largest (data, model) grid for the surviving chip count.

    Keeps model_parallel if it divides the chip count; otherwise halves it
    until it fits (param shards must still be gatherable, which the
    topology-free checkpoints guarantee).
    """
    cfg = cfg or ElasticConfig()
    mp = model_parallel
    while mp > cfg.min_model_parallel and n_chips % mp:
        mp //= 2
    mp = max(mp, cfg.min_model_parallel)
    data = max(n_chips // mp, 1)
    return data, mp
