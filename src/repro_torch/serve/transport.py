"""Replica transport of the multi-replica serving fleet (port of
:mod:`repro.serve.transport`).

The router and the fleet never touch a
:class:`~repro_torch.serve.ServeEngine` directly: every interaction goes
through a :class:`ReplicaTransport`, so the same routing, migration and
scaling logic drives in-process replicas (:class:`InProcessTransport`,
four engines in one process for a 4-replica fleet) and, later, replicas
behind an RPC boundary.

Fail-stop is the paper's: a killed replica loses ALL its state.
:meth:`InProcessTransport.kill` drops the engine, and every later call
raises :class:`ReplicaDead`. Recovery therefore reads nothing back from
the dead replica; the router's own census of what it dispatched and which
tokens streamed back is its only input, which is what makes the recovery
cost independent of the work the replica had done.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.engine import ServeEngine


class ReplicaDead(RuntimeError):
    """Raised by every call on a fail-stopped replica. The fleet treats it
    like a missed heartbeat: the replica is marked DEAD and its in-flight
    requests migrate."""

    def __init__(self, replica_id, op: str = "call"):
        self.replica_id, self.op = replica_id, op
        super().__init__(
            f"replica {replica_id} is dead (fail-stop): {op} refused")


class ReplicaTransport:
    """The seam between the router and one replica's engine.

    An implementation keeps two contracts:

      * **fail-stop, not fail-slow**: after :meth:`kill` (or a real crash)
        every method raises :class:`ReplicaDead`; no call returns stale
        data from a dead replica;
      * **the engine's streaming**: :meth:`submit` returns the engine's
        :class:`~repro_torch.serve.scheduler.RequestHandle`, whose ring
        the router drains after each step, in the engine's emission order.
    """

    replica_id: int = -1

    def submit(self, req):
        """Dispatch a (shadow) request to the replica's engine; returns the
        engine's handle, whose ring the router drains."""
        raise NotImplementedError

    def cancel(self, req):
        raise NotImplementedError

    def step(self, failed_group: Optional[int] = None) -> int:
        """Advance the replica's engine one step; returns its active
        slots."""
        raise NotImplementedError

    def heartbeat(self) -> bool:
        """Health probe: True = alive; False or :class:`ReplicaDead` fails
        the replica."""
        raise NotImplementedError

    def idle(self) -> bool:
        raise NotImplementedError

    def metrics(self) -> dict:
        raise NotImplementedError

    def kill(self):
        """Inject a fail-stop: all replica state is lost, and every later
        call raises :class:`ReplicaDead`."""
        raise NotImplementedError

    def warm_state(self) -> Optional[dict]:
        """Startup products (census, compiled plans, quantized weights and
        head) that a sibling replica of identical config reuses instead of
        redoing the startup work; None when they cannot be shared (across
        a process boundary)."""
        return None


class InProcessTransport(ReplicaTransport):
    """A replica as an in-process :class:`ServeEngine` on ``device``: a
    whole fleet lives in one process, and :meth:`kill` simulates the loss
    of a machine by dropping the engine and poisoning the seam.

    ``warm`` is a sibling engine's :meth:`ServeEngine.warm_state`: a
    spawned replica of identical config reuses its census, compiled plans
    and quantized weights (the fleet's scale-up path)."""

    def __init__(self, cfg, scfg, params, *, replica_id: int = 0,
                 warm: Optional[dict] = None, device=None):
        self.replica_id = replica_id
        self._dead = False
        self.engine: Optional[ServeEngine] = ServeEngine(
            cfg, scfg, params, device=device, warm=warm)

    def _live(self, op: str) -> ServeEngine:
        if self._dead or self.engine is None:
            raise ReplicaDead(self.replica_id, op)
        return self.engine

    def submit(self, req):
        return self._live("submit").submit(req)

    def cancel(self, req):
        self._live("cancel").cancel(req)

    def step(self, failed_group: Optional[int] = None) -> int:
        return self._live("step").step(failed_group=failed_group)

    def heartbeat(self) -> bool:
        self._live("heartbeat")
        return True

    def idle(self) -> bool:
        return self._live("idle").idle()

    def metrics(self) -> dict:
        return dict(self._live("metrics").metrics)

    def warm_state(self) -> Optional[dict]:
        return self._live("warm_state").warm_state()

    def kill(self):
        # fail-stop: the engine (cache, slots, in-flight admission batches)
        # is gone; recovery must work from the router's census alone
        self._dead = True
        self.engine = None
