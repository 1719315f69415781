"""Continuous-batching DCN serving."""

from repro_torch.serving.engine import DcnRequest, DcnServingEngine
from repro_torch.serving.errors import (DeadlineExceededError, DrainTimeout,
                                        QueueFullError, RequestFailedError)

__all__ = ["DcnRequest", "DcnServingEngine", "DeadlineExceededError",
           "DrainTimeout", "QueueFullError", "RequestFailedError"]
