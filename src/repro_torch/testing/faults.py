"""Deterministic, seedable fault injection for the DCN serving stack.

The serving engine's resilience layer needs faults that are
*repeatable* — a chaos gate or a regression test is useless if the
failure pattern shifts run to run — so every injection decision here is
a pure function of ``(seed, kind, call-or-step index)`` via a sha256
draw, never of wall time or a shared global RNG. The draws are the JAX
package's, so one plan fires at the same calls in both packages. The
injector is threaded through ``PipelineConfig.faults`` /
``GraphConfig.faults`` and consulted by the
executors at four sites, plus one bench-side corruption helper:

======================  ====================================================
kind                    where it fires
======================  ====================================================
``prepass``             per-image schedule build (TDT + Algorithm-1) in
                        both executors — raises :class:`FaultError`
                        tagged with the image index.
``dispatch``            kernel-dispatch entry of the batched /
                        batch-fused exec paths — raises
                        :class:`FaultError` (image picked
                        deterministically when only the batch width is
                        known).
``worker_stall``        start of a staged prepass in ``run_staged`` —
                        sleeps ``stall_s`` on the staging worker, which
                        a ``watchdog_s`` deadline converts into a
                        failover to synchronous prepass.
``cache_miss``          schedule-cache key construction — salts the key
                        with a unique token, forcing a rebuild (a
                        miss *storm* at rate 1.0).
``nan_image``           not an executor site: :meth:`FaultInjector.corrupt`
                        NaN-poisons an input image *before* submit, so
                        the engine's finite-input validation is what
                        gets exercised.
======================  ====================================================

Two firing modes (``FaultPlan.mode``):

* ``"call"`` (default) — every site consultation draws independently at
  ``rate``. With ``rate=1.0`` (+ ``max_fires``) this gives tests exact
  control: "the first dispatch faults, nothing else does".
* ``"step"`` — the serving engine calls :meth:`begin_step` before each
  step; each kind *arms* for that step with probability ``rate`` and
  fires on one deterministically-picked consultation. This keeps the
  chaos bench's faulted-step fraction ~``1-(1-rate)^kinds`` instead of
  compounding per consultation (a 5-layer prepass would otherwise fault
  almost every step at rate 0.1). ``nan_image`` decisions happen outside
  steps and always draw per call.

The runtime never imports this module — executors duck-type
``cfg.faults`` (``check`` / ``stall`` / ``miss_salt`` are the whole
protocol), so production configs carry ``faults=None`` and pay one
``is not None`` test per site.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np

ALL_FAULT_KINDS = ("prepass", "dispatch", "worker_stall", "cache_miss",
                   "nan_image")


class FaultError(RuntimeError):
    """An injected fault. ``image`` (when tagged) is the index of the
    offending image *within the faulting batch*, which is what the
    serving engine's evict-and-retry isolation consumes."""

    def __init__(self, kind: str, image: int | None = None):
        self.kind = kind
        self.image = image
        at = f" (image {image})" if image is not None else ""
        super().__init__(f"injected {kind} fault{at}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The (immutable, hashable) description of an injection campaign."""

    kinds: tuple[str, ...] = ALL_FAULT_KINDS
    rate: float = 0.1            # firing probability per call / per step
    seed: int = 0
    stall_s: float = 0.25        # worker_stall sleep (keep finite: the
    #                              abandoned worker thread must exit)
    tag_image: bool = True       # attach the image index to FaultError —
    #                              False exercises the degrade path (the
    #                              engine cannot evict an unknown slot)
    max_fires: int | None = None  # total fires across all kinds
    mode: str = "call"           # "call" | "step" (see module docstring)

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.mode not in ("call", "step"):
            raise ValueError(f"unknown fault mode: {self.mode!r}")
        unknown = set(self.kinds) - set(ALL_FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")


class FaultInjector:
    """Thread-safe deterministic injector over a :class:`FaultPlan`.

    Construct either from a plan or directly from plan kwargs::

        FaultInjector(kinds=("dispatch",), rate=1.0, max_fires=1)

    ``fired`` (per-kind fire counts) is the test/bench observability
    surface.
    """

    def __init__(self, plan: FaultPlan | None = None, **kw):
        if plan is not None and kw:
            raise ValueError("pass a FaultPlan or kwargs, not both")
        self.plan = plan if plan is not None else FaultPlan(**kw)
        self._lock = threading.RLock()
        self.fired: dict[str, int] = {k: 0 for k in self.plan.kinds}
        self._calls: dict[str, int] = {}        # per-call mode counters
        self._step: int | None = None           # step-mode: current step
        self._armed: dict[str, int] = {}        # kind -> firing call idx
        self._step_calls: dict[str, int] = {}
        self._prev_calls: dict[str, int] = {}
        self._total_fired = 0

    # -- deterministic draws ------------------------------------------------

    def _hash01(self, *parts) -> float:
        h = hashlib.sha256(
            repr((self.plan.seed,) + parts).encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def begin_step(self) -> None:
        """Step-scoped arming (serving engine hook). No-op in per-call
        mode so tests driving the engine keep exact per-call control."""
        if self.plan.mode != "step":
            return
        with self._lock:
            self._step = 0 if self._step is None else self._step + 1
            self._prev_calls = dict(self._step_calls)
            self._step_calls = {}
            self._armed = {}
            for k in self.plan.kinds:
                if k == "nan_image":
                    continue
                if self._hash01("arm", k, self._step) < self.plan.rate:
                    # Fire on one consultation of this kind; the previous
                    # step's call count stands in for this step's (the
                    # site count per step is stable in steady state).
                    span = max(1, self._prev_calls.get(k, 1))
                    self._armed[k] = int(
                        self._hash01("at", k, self._step) * span)

    def _fire(self, kind: str) -> bool:
        with self._lock:
            if kind not in self.plan.kinds:
                return False
            if (self.plan.max_fires is not None
                    and self._total_fired >= self.plan.max_fires):
                return False
            per_call = (self.plan.mode == "call" or kind == "nan_image"
                        or self._step is None)
            if per_call:
                n = self._calls.get(kind, 0)
                self._calls[kind] = n + 1
                fire = self._hash01("call", kind, n) < self.plan.rate
            else:
                n = self._step_calls.get(kind, 0)
                self._step_calls[kind] = n + 1
                fire = self._armed.get(kind) == n
                if fire:
                    del self._armed[kind]
            if fire:
                self.fired[kind] = self.fired.get(kind, 0) + 1
                self._total_fired += 1
            return fire

    # -- executor sites -----------------------------------------------------

    def check(self, kind: str, image: int | None = None,
              images: int | None = None) -> None:
        """Raise :class:`FaultError` if this consultation fires.

        ``image`` names the offending image when the site knows it
        (per-image prepass); ``images`` gives the batch width when it
        does not (whole-batch dispatch) and the injector picks one
        deterministically. ``tag_image=False`` strips the index either
        way."""
        if not self._fire(kind):
            return
        img = image
        if img is None and images:
            img = int(self._hash01("img", kind, self._total_fired)
                      * images)
        if not self.plan.tag_image:
            img = None
        raise FaultError(kind, image=img)

    def stall(self, kind: str = "worker_stall") -> None:
        """Sleep ``stall_s`` if firing — a slow/stuck staging worker."""
        if self._fire(kind):
            time.sleep(self.plan.stall_s)

    def miss_salt(self, kind: str = "cache_miss"):
        """A unique cache-key salt when firing (forces a miss), else
        None. Each fire salts differently so a storm never self-heals
        by colliding with its own junk entries."""
        if self._fire(kind):
            with self._lock:
                return ("fault-miss", self._total_fired)
        return None

    # -- bench-side helper --------------------------------------------------

    def corrupt(self, x: np.ndarray, kind: str = "nan_image") -> np.ndarray:
        """NaN-poison one deterministic pixel of a copy of ``x`` when
        firing, else return ``x`` unchanged. Used *before* submit — the
        engine's finite-input validation is the isolation under test."""
        if not self._fire(kind):
            return x
        x = np.array(x, copy=True)
        flat = x.reshape(-1)
        flat[int(self._hash01("pix", kind, self._total_fired)
                 * flat.size)] = np.nan
        return x

    @property
    def total_fired(self) -> int:
        with self._lock:
            return self._total_fired
