"""Typed serving failures: request-scoped errors + drain timeout.

The contract of :class:`~repro_torch.serving.engine.DcnServingEngine` is
that a failing request *completes with an error status* — its handle's
``error`` field is set, ``result()`` raises it, and the request appears
exactly once in the step/drain return.
These types make every failure mode distinguishable at the call site:

``RequestFailedError``
    The request's images could not be served (executor exception, queue
    shedding). ``cause`` carries the original
    exception when there is one.
``DeadlineExceededError``
    The request's ``deadline_s`` passed before (admission) or during
    (mid-flight) serving. A subclass of ``RequestFailedError`` so generic
    handlers catch both.
``QueueFullError``
    Raised *at submit* under the ``reject`` backpressure policy (the
    request was never accepted — no handle exists), and used as the
    ``cause`` of shed victims under ``shed-oldest``.
``DrainTimeout``
    ``drain(max_steps)`` exhausted its step budget
    with requests still in flight. Carries the stuck rids and whatever
    finished before the timeout, so callers never silently lose
    requests.
"""

from __future__ import annotations


class RequestFailedError(RuntimeError):
    """A serving request resolved with an error status."""

    def __init__(self, rid: int, cause: BaseException | None = None,
                 message: str = ""):
        self.rid = rid
        self.cause = cause
        msg = message or f"request {rid} failed"
        if cause is not None:
            msg += f": {type(cause).__name__}: {cause}"
        super().__init__(msg)
        if cause is not None:
            self.__cause__ = cause


class DeadlineExceededError(RequestFailedError):
    """The request's deadline passed before its results were ready."""

    def __init__(self, rid: int, deadline: float | None = None):
        super().__init__(
            rid, message=f"request {rid} missed its deadline")
        self.deadline = deadline


class QueueFullError(RuntimeError):
    """The bounded submit queue is at capacity (policy ``reject``), or —
    as the ``cause`` of a shed request's ``RequestFailedError`` — the
    request was evicted to make room (policy ``shed-oldest``)."""


class DrainTimeout(RuntimeError):
    """``drain``/``run`` exhausted ``max_steps`` with work in flight."""

    def __init__(self, pending_rids, finished=None):
        self.pending_rids = list(pending_rids)
        self.finished = list(finished or [])
        super().__init__(
            "drain exhausted max_steps with requests still in flight: "
            f"rids {self.pending_rids}")
