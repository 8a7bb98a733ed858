"""Admission policy of the serving engine (the part of
:mod:`repro.serve.scheduler` that admission uses): earliest-deadline-first
ordering of the wait queue, the wait-queue bound, and shedding of queued
requests whose deadline has passed. Pure host-side policy: it reorders
host lists and never touches tensors, so it cannot move any request's
integer grid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class AdmissionRejected(RuntimeError):
    """Raised by ``submit()`` when the wait queue is at ``max_queue``."""

    def __init__(self, rid, depth: int, max_queue: int):
        self.rid, self.depth, self.max_queue = rid, depth, max_queue
        super().__init__(f"request rid={rid} rejected: wait queue at "
                         f"max_queue={max_queue} (depth {depth})")


@dataclasses.dataclass
class ChunkScheduler:
    max_queue: int = 0  # wait-queue bound; 0 = unbounded
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")

    def check_admission(self, rid, queue_depth: int) -> None:
        """Raise :class:`AdmissionRejected` when the wait queue is full."""
        if self.max_queue and queue_depth >= self.max_queue:
            raise AdmissionRejected(rid, queue_depth, self.max_queue)

    @staticmethod
    def _key(req, j: int):
        """EDF key: absolute deadline (+inf without one), FIFO tie-break."""
        dl = req.deadline_ms
        return (float("inf"), j) if dl is None else (req.t_submit + dl / 1e3, j)

    def order_queue(self, queue: list) -> list:
        """Queued requests in EDF order (stable); a new list."""
        keyed = sorted(((self._key(r, j), r) for j, r in enumerate(queue)),
                       key=lambda kr: kr[0])
        return [r for _, r in keyed]

    def shed_expired(self, queue: list,
                     now: Optional[float] = None) -> tuple:
        """Split the wait queue into (kept, shed): queued requests whose
        absolute deadline has passed are shed before any prefill."""
        now = self.clock() if now is None else now
        kept, shed = [], []
        for req in queue:
            dl = req.deadline_ms
            (shed if dl is not None and now > req.t_submit + dl / 1e3
             else kept).append(req)
        return kept, shed
