"""Serving layer of the port: the batched engine, its scheduler, the
per-slot baseline and the multi-replica fleet (router, transport, replica
pool with fail-stop migration and autoscaling). The protected head's
entries are :mod:`repro_torch.ft.heads`'s own functions, re-exported."""
from repro_torch.ft.heads import (ft_logits, ft_logits_decode,
                                  ft_logits_prefill, quantize_head)
from repro_torch.serve.engine import (Request, ServeConfig, ServeEngine,
                                      geometric_buckets, resolve_buckets)
from repro_torch.serve.fleet import (DEAD, DRAINING, HEALTHY, STARTING, Fleet,
                                     FleetConfig, Replica, ScalingPolicy)
from repro_torch.serve.reference import PerSlotEngine
from repro_torch.serve.router import FleetRecord, Router
from repro_torch.serve.scheduler import (AdmissionRejected, ChunkScheduler,
                                         DeadlineExceeded, RequestHandle,
                                         TokenRing)
from repro_torch.serve.transport import (InProcessTransport, ReplicaDead,
                                         ReplicaTransport)

__all__ = ["AdmissionRejected", "ChunkScheduler", "DEAD", "DRAINING",
           "DeadlineExceeded", "Fleet", "FleetConfig", "FleetRecord",
           "HEALTHY", "InProcessTransport", "PerSlotEngine", "Replica",
           "ReplicaDead", "ReplicaTransport", "Request", "RequestHandle",
           "Router", "STARTING", "ScalingPolicy", "ServeConfig",
           "ServeEngine", "TokenRing", "ft_logits", "ft_logits_decode",
           "ft_logits_prefill", "geometric_buckets", "quantize_head",
           "resolve_buckets"]
