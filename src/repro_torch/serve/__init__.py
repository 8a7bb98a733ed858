"""Serving engine of the port."""
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.serve.reference import PerSlotEngine
from repro_torch.serve.scheduler import (AdmissionRejected, ChunkScheduler,
                                         DeadlineExceeded, RequestHandle,
                                         TokenRing)

__all__ = ["AdmissionRejected", "ChunkScheduler", "DeadlineExceeded",
           "PerSlotEngine", "Request", "RequestHandle", "ServeConfig",
           "ServeEngine", "TokenRing"]
