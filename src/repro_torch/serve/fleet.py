"""Multi-replica serving fleet (port of :mod:`repro.serve.fleet`): replica
pool, heartbeats, fail-stop migration and queue-depth autoscaling.

This is numerical entanglement's property one level up: inside a replica
each :class:`~repro_torch.serve.ServeEngine` rolls a fail-stopped stream
group forward; the :class:`Fleet` rolls a fail-stopped whole REPLICA
forward, losing a machine and keeping every request, at a recovery cost
independent of the work the dead replica had done (one batched prefill of
each request's generated prefix; see :mod:`repro_torch.serve.router`).

  * :class:`Replica`: one engine behind a
    :class:`~repro_torch.serve.transport.ReplicaTransport`, with the
    lifecycle STARTING -> HEALTHY -> DRAINING -> DEAD. A STARTING replica
    takes no traffic until its first heartbeat; a DRAINING one finishes
    what it holds and retires; DEAD is terminal (a graceful retirement or
    a fail-stop, told apart by ``failed``).
  * :class:`Fleet`: the pool and the step loop. One :meth:`Fleet.step` =
    heartbeats -> shed -> dispatch -> one engine step per live replica ->
    token drain -> retire idle drainers -> autoscale. Everything runs on
    the injectable ``ServeConfig.clock`` and step counts, so a 4-replica
    fleet with a mid-decode kill is a deterministic one-process test.
  * :class:`ScalingPolicy`: spawns a replica when the router queue outruns
    the healthy pool, and drains one when the queue is empty and every
    replica's utilization (packed prompt tokens against the token budget,
    or slot occupancy) is below a floor.

Every replica after the first reuses the first one's
:meth:`~repro_torch.serve.ServeEngine.warm_state` (protected-site census,
compiled plans, quantized weights and head), so a spawn costs an engine's
cache, not a startup: ``plans.misses`` stays 0 and no weight is quantized
again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.serve.engine import Request, ServeConfig
from repro_torch.serve.router import Router
from repro_torch.serve.scheduler import RequestHandle
from repro_torch.serve.transport import (InProcessTransport, ReplicaDead,
                                         ReplicaTransport)

STARTING, HEALTHY, DRAINING, DEAD = "starting", "healthy", "draining", "dead"


@dataclasses.dataclass
class Replica:
    """One pool member: a transport and its lifecycle state. The fleet is
    its only writer; the router reads ``rid`` and ``transport``."""

    rid: int
    transport: ReplicaTransport
    state: str = STARTING
    failed: bool = False  # DEAD by fail-stop (not a graceful retirement)
    active: int = 0  # slots active at the last step (occupancy)
    packed_seen: int = 0  # packed_tokens at the last scaling decision
    steps_seen: int = 0  # fleet steps this replica ran since then

    @property
    def live(self) -> bool:
        return self.state in (STARTING, HEALTHY, DRAINING)

    def utilization(self, scfg: ServeConfig, packed_now: int) -> float:
        """Share of the serving capacity used since the last scaling
        decision: packed prompt tokens against the per-step token budget
        under token packing, slot occupancy otherwise."""
        if self.steps_seen <= 0:
            return 1.0  # no observation yet: never a drain signal
        if scfg.token_budget > 0:
            return ((packed_now - self.packed_seen)
                    / (self.steps_seen * scfg.token_budget))
        return self.active / max(scfg.max_batch, 1)


@dataclasses.dataclass
class ScalingPolicy:
    """Queue-depth / utilization autoscaling. ``decide`` reads the router
    queue and the replicas' utilizations and returns +1 (spawn), -1 (drain
    one) or 0; the fleet applies it within [min_replicas,
    max_replicas]."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_depth: int = 4  # queued requests PER HEALTHY replica
    scale_down_util: float = 0.25  # drain when every replica is below it
    decide_every: int = 8  # fleet steps between decisions

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < min_replicas "
                f"({self.min_replicas})")
        if self.decide_every < 1:
            raise ValueError(
                f"decide_every must be >= 1, got {self.decide_every}")

    def decide(self, queue_depth: int, healthy: int,
               utils: List[float]) -> int:
        if healthy < self.min_replicas:
            return 1
        if (queue_depth > self.scale_up_depth * max(healthy, 1)
                and healthy < self.max_replicas):
            return 1
        if (healthy > self.min_replicas and queue_depth == 0 and utils
                and max(utils) < self.scale_down_util):
            return -1
        return 0


@dataclasses.dataclass
class FleetConfig:
    """Fleet knobs, apart from the ``ServeConfig`` every replica shares
    (less the router-owned admission fields). ``device`` is where the
    replicas' engines run (None: CUDA, as every entry point)."""

    replicas: int = 1  # initial pool size
    heartbeat_every: int = 1  # fleet steps between health probes
    policy: Optional[ScalingPolicy] = None  # None = fixed-size pool
    transport_factory: Callable[..., ReplicaTransport] = InProcessTransport
    device: object = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.heartbeat_every < 1:
            raise ValueError(
                f"heartbeat_every must be >= 1, got {self.heartbeat_every}")


class Fleet:
    """N replicas behind the single engine's surface: ``submit() ->
    RequestHandle``, ``step()``, ``cancel()``, ``idle()``,
    ``run_to_completion()``; it stands in for a :class:`ServeEngine` for
    every caller, :class:`RequestHandle` included (iterating a handle
    drives ``Fleet.step``)."""

    def __init__(self, cfg, scfg: ServeConfig, params,
                 fcfg: Optional[FleetConfig] = None):
        self.cfg, self.params = cfg, params
        self.fcfg = fcfg or FleetConfig()
        self.scfg = scfg
        # replicas never shed or reject: admission control lives in the
        # router, the fleet's one gatekeeper
        self.rep_scfg = dataclasses.replace(scfg, max_queue=0)
        self.router = Router(self, scfg)
        self.replicas: Dict[int, Replica] = {}
        self._next_rid = 0
        self._warm: Optional[dict] = None
        self.steps = 0
        self.metrics = {"spawned": 0, "retired": 0, "failed": 0,
                        "scale_ups": 0, "scale_downs": 0}
        for _ in range(self.fcfg.replicas):
            self._spawn()

    # -- pool management ------------------------------------------------------

    def _spawn(self) -> Replica:
        """Add a replica. The first pays the engine's whole startup
        (census, plan compilation, weight quantization) and publishes its
        warm state; every later one reuses it."""
        rid = self._next_rid
        self._next_rid += 1
        tr = self.fcfg.transport_factory(
            self.cfg, self.rep_scfg, self.params, replica_id=rid,
            warm=self._warm, device=self.fcfg.device)
        if self._warm is None:
            self._warm = tr.warm_state()
        rep = Replica(rid=rid, transport=tr)
        self.replicas[rid] = rep
        self.metrics["spawned"] += 1
        return rep

    def _fail(self, rep: Replica) -> None:
        """Declare a replica fail-stopped (terminal) and migrate every
        request the router had assigned to it."""
        if rep.state == DEAD:
            return
        rep.state, rep.failed = DEAD, True
        self.metrics["failed"] += 1
        self.router.migrate(rep.rid)

    def kill_replica(self, rid: int) -> None:
        """Inject a fail-stop: the transport drops all the replica's state,
        and the next heartbeat (the same step) detects it and migrates.
        Killing the last live replica is allowed: requests wait in the
        router queue until a spawn revives the pool, as in a real outage."""
        self.replicas[rid].transport.kill()

    def transport_of(self, rid: int) -> Optional[ReplicaTransport]:
        rep = self.replicas.get(rid)
        return rep.transport if rep is not None and rep.live else None

    def _healthy(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.state == HEALTHY]

    # -- step loop ------------------------------------------------------------

    def _heartbeats(self) -> None:
        for rep in self.replicas.values():
            if not rep.live:
                continue
            try:
                ok = rep.transport.heartbeat()
            except ReplicaDead:
                ok = False
            if not ok:
                self._fail(rep)
            elif rep.state == STARTING:
                rep.state = HEALTHY  # the first good probe promotes

    def step(self, failed_group: Optional[int] = None) -> int:
        """One fleet step: health, admission, one engine step per live
        replica, token drain, retirement, scaling. Returns the active slots
        over the live replicas. ``failed_group`` goes to every replica:
        the in-engine stream-group fail-stop and the replica fail-stop
        compose."""
        self.steps += 1
        if (self.steps - 1) % self.fcfg.heartbeat_every == 0:
            self._heartbeats()
        self.router.shed()
        self.router.dispatch(self._healthy())
        active_total = 0
        for rep in list(self.replicas.values()):
            if not rep.live:
                continue
            try:
                rep.active = rep.transport.step(failed_group=failed_group)
            except ReplicaDead:
                self._fail(rep)
                continue
            rep.steps_seen += 1
            active_total += rep.active
        self.router.drain()
        self._retire_drained()
        if self.fcfg.policy is not None and (
                self.steps % self.fcfg.policy.decide_every == 0):
            self._autoscale()
        return active_total

    def _retire_drained(self) -> None:
        for rep in self.replicas.values():
            if rep.state != DRAINING:
                continue
            try:
                done = (self.router.assigned(rep.rid) == 0
                        and rep.transport.idle())
            except ReplicaDead:
                continue  # the heartbeat will fail it
            if done:
                rep.state = DEAD
                self.metrics["retired"] += 1

    def _autoscale(self) -> None:
        pol = self.fcfg.policy
        healthy = self._healthy()
        utils = []
        for rep in healthy:
            try:
                packed = rep.transport.metrics().get("packed_tokens", 0)
            except ReplicaDead:
                continue
            utils.append(rep.utilization(self.rep_scfg, packed))
            rep.packed_seen, rep.steps_seen = packed, 0
        d = pol.decide(len(self.router.queue), len(healthy), utils)
        if d > 0 and len(healthy) < pol.max_replicas:
            self._spawn()
            self.metrics["scale_ups"] += 1
        elif d < 0 and len(healthy) > pol.min_replicas:
            # drain the least-loaded healthy replica: it takes no new work
            # and retires once its requests finish
            rep = min(healthy, key=lambda r: (self.router.load(r.rid), r.rid))
            rep.state = DRAINING
            self.metrics["scale_downs"] += 1

    # -- the engine's surface -------------------------------------------------

    def submit(self, req: Request) -> RequestHandle:
        return self.router.submit(req)

    def cancel(self, req: Request) -> None:
        self.router.cancel(req)

    def idle(self) -> bool:
        return self.router.idle()

    def run_to_completion(self, max_steps: int = 10_000,
                          failed_group: Optional[int] = None) -> int:
        """Step until every request the router tracks has finished; returns
        the steps taken. Raises if the fleet cannot drain (every replica
        dead and no scaling policy, say)."""
        for n in range(max_steps):
            if self.idle():
                return n
            self.step(failed_group=failed_group)
        if not self.idle():
            raise RuntimeError(
                f"fleet did not drain within {max_steps} steps "
                f"({len(self.router.records)} live records, "
                f"{len(self.router.queue)} queued, "
                f"{len(self._healthy())} healthy replicas)")
        return max_steps

    def fleet_metrics(self) -> dict:
        """The fleet's counters, the router's (``router_*``) and each
        replica's state and engine metrics."""
        out = dict(self.metrics)
        out.update({f"router_{k}": v for k, v in self.router.metrics.items()})
        per = {}
        for rid, rep in self.replicas.items():
            entry = {"state": rep.state, "failed": rep.failed}
            if rep.live:
                try:
                    entry["engine"] = rep.transport.metrics()
                except ReplicaDead:
                    pass
            per[rid] = entry
        out["replicas"] = per
        return out
