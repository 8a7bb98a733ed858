"""Front end of the multi-replica serving fleet (port of
:mod:`repro.serve.router`): one request queue above N replica engines,
with fail-stop migration.

The router owns ADMISSION for the whole fleet: ``max_queue``, EDF order
and deadline shedding live here (each replica's
:class:`~repro_torch.serve.scheduler.ChunkScheduler` still orders the
prefill chunks inside its engine). It also owns the only state recovery
ever needs: a per-request census of what was dispatched where and which
tokens have streamed back.

Request flow
------------
``submit()`` registers a :class:`FleetRecord` and returns the usual
:class:`~repro_torch.serve.scheduler.RequestHandle`, over a ROUTER-level
:class:`~repro_torch.serve.scheduler.TokenRing`. Dispatch picks the
least-loaded HEALTHY replica and submits a SHADOW request to its engine;
after each fleet step the router drains the shadow's ring into the
router-level ring. A caller's handle never references a replica, so
iterating it keeps yielding tokens across a replica's fail-stop without
observing the migration.

Fail-stop migration
-------------------
A dead replica's engine state (KV cache, slots, admission batches) is
gone. The router re-dispatches every affected request from its census:

  * **queued / mid-prefill** requests (no token streamed yet) replay: the
    prompt re-enters the router queue and prefills on a healthy replica
    through the normal batched admission;
  * **decoding** requests resume from their generated PREFIX: the shadow
    prompt becomes ``prompt + tokens so far`` and ``max_new`` shrinks by
    the prefix length, so recovery costs one batched prefill of the
    context, whatever the number of decode steps the dead replica had
    done. Greedy decode is deterministic and the engine gives a position
    the same bits whether it prefills or decodes it, so the continuation
    equals the no-failure run's tokens exactly (tested);
  * when the prefix has outgrown the largest prefill bucket, the request
    is **recomputed**: the original prompt replays with the full
    ``max_new``, and the first ``len(prefix)`` regenerated tokens are
    dropped at drain time, so the caller's stream never repeats a token.

Migrated requests keep their original ``t_submit``, so EDF puts them at
the front of their deadline class, and they are never deadline-shed:
their admission already happened, and shedding them would turn a replica
failure into a visible deadline miss.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.serve.engine import Request, ServeConfig, resolve_buckets
from repro_torch.serve.scheduler import (ChunkScheduler, RequestHandle,
                                         TokenRing)
from repro_torch.serve.transport import ReplicaDead


@dataclasses.dataclass
class FleetRecord:
    """The router's census entry for one request, holding everything
    migration needs and nothing a dead replica holds: the caller's
    request, the router-level ring its handle pops, every token emitted so
    far (the migration prefix) and the current shadow dispatch."""

    req: Request
    ring: TokenRing
    toks: list = dataclasses.field(default_factory=list)
    replica: Optional[int] = None  # replica id; None = in the router queue
    shadow: Optional[Request] = None  # the engine-level request
    eh: Optional[RequestHandle] = None  # engine handle (token source)
    skip: int = 0  # regenerated tokens to drop (recompute path)
    migrations: int = 0
    dispatched: bool = False  # ever admitted to a replica (never shed then)


class Router:
    """Fleet front end: request queue, dispatch, token drain, migration.

    The fleet calls the phases in order each step: :meth:`shed`,
    :meth:`dispatch`, the replica steps, :meth:`drain`; :meth:`migrate`
    runs whenever a replica is declared dead. ``fleet`` provides
    ``step()`` and ``cancel()`` (the :class:`RequestHandle` contract) and
    ``transport_of(replica id)``."""

    def __init__(self, fleet, scfg: ServeConfig):
        self.fleet = fleet
        self.scfg = scfg
        self.clock = scfg.clock or time.monotonic
        # the fleet's one gatekeeper: the replicas' own queues are unbounded
        self.sched = ChunkScheduler(max_queue=scfg.max_queue,
                                    clock=self.clock)
        self.buckets = resolve_buckets(scfg)
        self.queue: List[Request] = []
        self.records: dict[int, FleetRecord] = {}  # id(req) -> record
        self.metrics = {"queue_depth_peak": 0, "rejected": 0, "shed": 0,
                        "cancelled": 0, "migrated": 0, "resume_prefix": 0,
                        "resume_recompute": 0, "replayed": 0}

    # -- admission ------------------------------------------------------------

    def submit(self, req: Request) -> RequestHandle:
        """Register a request with the fleet. The engine's capacity rules
        are enforced HERE (the request may land on any replica, one
        spawned later included); saturation raises
        :class:`~repro_torch.serve.scheduler.AdmissionRejected`."""
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"request rid={req.rid} prompt length {len(req.prompt)} > "
                f"largest prefill bucket {self.buckets[-1]}")
        need = len(req.prompt) + req.max_new
        if need > self.scfg.max_seq:
            raise ValueError(
                f"request rid={req.rid} needs {need} positions (prompt "
                f"{len(req.prompt)} + max_new {req.max_new}) > max_seq="
                f"{self.scfg.max_seq}")
        try:
            self.sched.check_admission(req.rid, len(self.queue))
        except RuntimeError:
            self.metrics["rejected"] += 1
            raise
        req.status = "queued"
        req.t_submit = self.clock()
        rec = FleetRecord(req=req, ring=TokenRing(req.max_new))
        self.records[id(req)] = rec
        self.queue.append(req)
        self.metrics["queue_depth_peak"] = max(
            self.metrics["queue_depth_peak"], len(self.queue))
        return RequestHandle(self.fleet, req, rec.ring)

    def shed(self) -> None:
        """Shed the queued requests past their deadline that were never
        dispatched; migrated requests are exempt."""
        if not any(r.deadline_ms is not None and
                   not self.records[id(r)].dispatched for r in self.queue):
            return
        fresh = [r for r in self.queue
                 if not self.records[id(r)].dispatched]
        _, shed = self.sched.shed_expired(fresh)
        if not shed:
            return
        gone = {id(r) for r in shed}
        self.queue = [r for r in self.queue if id(r) not in gone]
        now = self.clock()
        for req in shed:
            req.status = "shed"
            req.out = np.zeros(0, np.int32)
            req.t_done = now
            del self.records[id(req)]
            self.metrics["shed"] += 1

    # -- dispatch -------------------------------------------------------------

    def load(self, replica_id: int) -> int:
        """Live records assigned to a replica: the dispatch balance key and
        its bound (at most ``max_batch``, its slot pool, so that neither
        the migration blast radius nor the router queue, the scaling
        signal, is hidden inside a replica)."""
        return sum(1 for rec in self.records.values()
                   if rec.replica == replica_id)

    def dispatch(self, healthy: list) -> None:
        """Assign queued requests, in EDF order, to the least-loaded
        healthy replicas up to each one's slot pool. ``healthy`` holds
        objects with ``rid`` and ``transport`` (the fleet's replicas)."""
        if not self.queue or not healthy:
            return
        loads = {rep.rid: self.load(rep.rid) for rep in healthy}
        by_rid = {rep.rid: rep for rep in healthy}
        remaining = []
        for req in self.sched.order_queue(self.queue):
            rid = min((r for r in loads if loads[r] < self.scfg.max_batch),
                      key=lambda r: (loads[r], r), default=None)
            if rid is None:
                remaining.append(req)
                continue
            if self._dispatch_one(self.records[id(req)], by_rid[rid]):
                loads[rid] += 1
            else:
                remaining.append(req)
        self.queue = remaining

    def _dispatch_one(self, rec: FleetRecord, rep) -> bool:
        """Submit one record's shadow request to a replica; False (the
        record stays queued) if the replica died under us."""
        req = rec.req
        k = len(rec.toks)
        if k == 0:
            prompt, max_new, skip = req.prompt, req.max_new, 0
            if rec.migrations:
                self.metrics["replayed"] += 1
        elif len(req.prompt) + k <= self.buckets[-1]:
            # prefix resume: prefill the generated prefix as context and
            # decode on from where the dead replica stopped
            prompt = np.concatenate(
                [req.prompt, np.asarray(rec.toks, np.int32)])
            max_new, skip = req.max_new - k, 0
            self.metrics["resume_prefix"] += 1
        else:
            # the prefix outgrew the buckets: replay the original prompt
            # and drop the k regenerated tokens at drain time (greedy
            # decode gives the same k tokens the caller already has)
            prompt, max_new, skip = req.prompt, req.max_new, k
            self.metrics["resume_recompute"] += 1
        shadow = Request(rid=req.rid, prompt=np.asarray(prompt, np.int32),
                         max_new=max_new, eos_token=req.eos_token)
        try:
            rec.eh = rep.transport.submit(shadow)
        except ReplicaDead:
            return False
        rec.shadow, rec.replica = shadow, rep.rid
        rec.skip, rec.dispatched = skip, True
        req.status = "prefill"
        return True

    # -- token drain ----------------------------------------------------------

    def drain(self) -> None:
        """Move every shadow's new tokens into the router-level rings,
        mirror the engine's status onto the caller's request, and finish
        completed requests."""
        now = self.clock()
        for rec in list(self.records.values()):
            if rec.eh is None:
                continue
            req = rec.req
            while len(rec.eh.ring):
                tok = rec.eh.ring.pop()
                if rec.skip:
                    rec.skip -= 1
                    continue
                rec.toks.append(tok)
                rec.ring.push(tok)
                if req.t_first is None:
                    req.t_first = now
                req.tok_times.append(now)
            st = rec.shadow.status
            if st == "done":
                self._finalize(rec, now)
            elif st == "decoding":
                req.status = "decoding"
            # queued or prefilling shadows stay "prefill" to the caller:
            # the request IS admitted fleet-side

    def _finalize(self, rec: FleetRecord, now: float) -> None:
        req = rec.req
        req.out = np.asarray(rec.toks[: req.max_new], np.int32)
        req.status = "done"
        req.t_done = now
        del self.records[id(req)]

    # -- migration ------------------------------------------------------------

    def migrate(self, replica_id: int) -> None:
        """Re-dispatch every request of a dead replica from the census.
        Streamed tokens are kept; the resume path (prefix or recompute) is
        chosen per request at its next dispatch. The caller's handle keeps
        its ring."""
        for rec in list(self.records.values()):
            if rec.replica != replica_id:
                continue
            rec.replica = rec.shadow = rec.eh = None
            rec.skip = 0
            rec.migrations += 1
            req = rec.req
            if len(rec.toks) >= req.max_new or (
                    req.eos_token is not None and rec.toks
                    and rec.toks[-1] == req.eos_token):
                # fully generated, not yet finalized (the death raced the
                # drain): nothing left to recover
                self._finalize(rec, self.clock())
            else:
                req.status = "queued"
                self.queue.append(req)
            self.metrics["migrated"] += 1

    # -- cancellation / lifecycle ---------------------------------------------

    def cancel(self, req: Request) -> None:
        """Fleet-wide cancel in any state: a router-queued request leaves
        the queue; a dispatched shadow is cancelled on its replica (on a
        dead one there is nothing left to cancel)."""
        rec = self.records.get(id(req))
        if rec is None or req.status in ("done", "cancelled", "shed"):
            return
        if rec.replica is None:
            self.queue = [r for r in self.queue if r is not req]
        else:
            tr = self.fleet.transport_of(rec.replica)
            if tr is not None:
                try:
                    tr.cancel(rec.shadow)
                except ReplicaDead:
                    pass
        req.status = "cancelled"
        req.out = np.asarray(rec.toks, np.int32)
        req.t_done = self.clock()
        del self.records[id(req)]
        self.metrics["cancelled"] += 1

    def assigned(self, replica_id: int) -> int:
        """Live records on a replica (the drain-progress probe)."""
        return self.load(replica_id)

    def idle(self) -> bool:
        return not self.queue and not self.records
