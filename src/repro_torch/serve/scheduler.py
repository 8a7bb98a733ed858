"""Scheduling layer of the serving engine (port of
:mod:`repro.serve.scheduler`): deadline-aware chunk scheduling, loud
admission control, and the per-request frontend (token iterator, cancel,
deadline).

The engine itself stays a synchronous step machine (one batched decode
per :meth:`~repro_torch.serve.ServeEngine.step`, fixed shapes). This
module holds the policy around it:

  * :class:`ChunkScheduler` picks which queued requests form the next
    admission batch and which in-flight admission batch advances its next
    prefill chunk, earliest-deadline-first (EDF; deadline-less requests
    rank last, FIFO among themselves), and which rows a token-packed
    prefill step takes (:meth:`ChunkScheduler.pack_rows`). At most
    ``max_prefill_per_step`` chunks run per engine step before the decode
    call, so decode is never starved.
  * admission control: ``max_queue > 0`` bounds the wait queue, and past
    it :meth:`ChunkScheduler.check_admission` raises
    :class:`AdmissionRejected`. Queued requests whose deadline expires
    before admission are shed (:meth:`ChunkScheduler.shed_expired`);
    iterating their handle raises :class:`DeadlineExceeded`.
  * :class:`RequestHandle` is what ``submit()`` returns: a per-request
    token iterator over a fixed-capacity :class:`TokenRing` that the
    engine pushes into as tokens land. Iterating drives ``engine.step()``
    when the ring is empty; ``cancel()`` works in every request state.

Nothing here touches tensors: scheduling only reorders host lists, so it
cannot move any request's integer grid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional


class AdmissionRejected(RuntimeError):
    """Raised by ``submit()`` when the wait queue is at ``max_queue``; it
    carries the observed depth so a caller can back off."""

    def __init__(self, rid, depth: int, max_queue: int):
        self.rid, self.depth, self.max_queue = rid, depth, max_queue
        super().__init__(f"request rid={rid} rejected: wait queue at "
                         f"max_queue={max_queue} (depth {depth})")


class DeadlineExceeded(RuntimeError):
    """Raised when iterating a handle whose request was shed because its
    ``deadline_ms`` expired before admission."""

    def __init__(self, rid, deadline_ms: float):
        self.rid, self.deadline_ms = rid, deadline_ms
        super().__init__(f"request rid={rid} shed: deadline_ms={deadline_ms} "
                         f"expired before admission")


class TokenRing:
    """Fixed-capacity ring of int tokens between the engine (producer) and
    a request handle's iterator (consumer). The capacity is ``max_new``
    (at least 1): the engine emits at most that many tokens per request,
    so a push past it is a fault and raises."""

    __slots__ = ("_buf", "_head", "_size")

    def __init__(self, capacity: int):
        self._buf = [0] * max(int(capacity), 1)
        self._head = 0  # next pop index
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def push(self, tok: int) -> None:
        if self._size >= len(self._buf):
            raise OverflowError("token ring full: the engine emitted past "
                                "max_new, which step() must prevent")
        self._buf[(self._head + self._size) % len(self._buf)] = int(tok)
        self._size += 1

    def pop(self) -> int:
        if not self._size:
            raise IndexError("pop from empty token ring")
        tok = self._buf[self._head]
        self._head = (self._head + 1) % len(self._buf)
        self._size -= 1
        return tok


def _live(p: dict) -> list:
    """Indices of an admission batch's rows whose request is not
    cancelled."""
    return [i for i, (_, r) in enumerate(p["reqs"]) if r is not None]


@dataclasses.dataclass
class ChunkScheduler:
    max_prefill_per_step: int = 1  # chunk budget before each decode call
    max_queue: int = 0  # wait-queue bound; 0 = unbounded
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.max_prefill_per_step < 1:
            raise ValueError(f"max_prefill_per_step must be >= 1, got "
                             f"{self.max_prefill_per_step}")
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

    def _batch_key(self, j: int, p: dict, remaining: int) -> tuple:
        """Order of in-flight admission batches: all-cancelled batches
        first (they drain without compute), then earliest deadline, then
        shortest remaining prefill, then FIFO."""
        reqs = [p["reqs"][i][1] for i in _live(p)]
        if not reqs:
            return (float("-inf"), 0, j)
        return (min(self._key(r, j)[0] for r in reqs), remaining, j)

    def pick_batch(self, batches: list) -> Optional[dict]:
        """Which in-flight admission batch advances its next chunk: EDF,
        then shortest remaining prefill (its bucket minus its offset), so
        a short batch admitted into freed slots lands after a couple of
        chunks instead of queuing behind a long batch's whole tail."""
        if not batches:
            return None
        return min(enumerate(batches), key=lambda jp: self._batch_key(
            jp[0], jp[1], jp[1]["bucket"] - jp[1]["pos0"]))[1]

    def pack_rows(self, batches: list, budget_rows: int) -> list:
        """Rows of the next token-packed prefill step: up to
        ``budget_rows`` ``(batch, row index)`` pairs from all in-flight
        admission batches, in :meth:`pick_batch`'s order with the
        remaining prefill counted in true prompt tokens. Rows advance to
        their true prompt length (bucket padding is never packed), each
        live row appears at most once, and cancelled rows are skipped."""
        def remaining(p):
            return max((int(p["lengths_np"][i]) - int(p["rowpos"][i])
                        for i in _live(p)), default=0)

        rows = []
        for j, p in sorted(enumerate(batches), key=lambda jp: self._batch_key(
                jp[0], jp[1], remaining(jp[1]))):
            for i in _live(p):
                if int(p["rowpos"][i]) >= int(p["lengths_np"][i]):
                    continue  # the row's prefill is complete
                rows.append((p, i))
                if len(rows) >= budget_rows:
                    return rows
        return rows

    def shed_expired(self, queue: list,
                     now: Optional[float] = None) -> tuple:
        """Split the wait queue into (kept, shed): queued requests whose
        absolute deadline has passed are shed before any prefill. Requests
        already admitted are never shed."""
        now = self.clock() if now is None else now
        kept, shed = [], []
        for req in queue:
            dl = req.deadline_ms
            (shed if dl is not None and now > req.t_submit + dl / 1e3
             else kept).append(req)
        return kept, shed


class RequestHandle:
    """Frontend of one submitted request: iterate to stream its tokens,
    ``cancel()`` to abandon it, ``result()`` to drain it. When the ring is
    empty and the request unfinished, the iterator drives
    ``engine.step()``, which advances every active slot."""

    __slots__ = ("engine", "req", "ring")

    def __init__(self, engine, req, ring: TokenRing):
        self.engine, self.req, self.ring = engine, req, ring

    @property
    def rid(self):
        return self.req.rid

    @property
    def status(self) -> str:
        """queued | prefill | decoding | done | cancelled | shed"""
        return self.req.status

    @property
    def done(self) -> bool:
        return self.req.status in ("done", "cancelled", "shed")

    def tokens(self) -> Iterator[int]:
        """Stream the request's tokens as they land. Raises
        :class:`DeadlineExceeded` if the request was (or gets) shed."""
        while True:
            if len(self.ring):
                yield self.ring.pop()
                continue
            if self.req.status == "shed":
                raise DeadlineExceeded(self.req.rid, self.req.deadline_ms)
            if self.done:
                return
            self.engine.step()

    def __iter__(self) -> Iterator[int]:
        return self.tokens()

    def result(self):
        """Drain to completion; returns the finished request (``.out``
        holds every generated token, streamed ones included)."""
        for _ in self.tokens():
            pass
        return self.req

    def cancel(self) -> None:
        """Abandon the request in whatever state it is in (see
        :meth:`~repro_torch.serve.ServeEngine.cancel`)."""
        self.engine.cancel(self.req)
