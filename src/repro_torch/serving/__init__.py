"""Continuous-batching serving: LM decoding and DCN vision."""

from repro_torch.serving.engine import (DcnRequest, DcnServingEngine,
                                        DecodeEngine, Request)
from repro_torch.serving.errors import (DeadlineExceededError, DrainTimeout,
                                        QueueFullError, RequestFailedError)

__all__ = ["DcnRequest", "DcnServingEngine", "DecodeEngine", "Request",
           "DeadlineExceededError", "DrainTimeout", "QueueFullError",
           "RequestFailedError"]
