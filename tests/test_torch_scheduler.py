"""The port's scheduling layer (``repro_torch.serve.scheduler``) against the
reference's (``repro.serve.scheduler``), on the same inputs: the token
ring's capacity rules, the request handle's streaming / result / cancel /
shed behaviour over a stub engine, and the scheduler's orders —
``order_queue``, ``pick_batch`` and ``pack_rows`` over seeded random
in-flight batches with deadlines, offsets and cancelled rows, and
``shed_expired`` on an injected clock. Every order must be the
reference's, element for element. (The reference's fleet-migration cases
of ``test_scheduler_edges.py`` wait for the port's fleet.)
"""
import numpy as np
import pytest

from repro.serve import scheduler as J
from repro.serve.engine import Request as JRequest
from repro_torch.serve import scheduler as P
from repro_torch.serve.engine import Request as PRequest

IMPLS = [pytest.param((J, JRequest), id="reference"),
         pytest.param((P, PRequest), id="port")]


def _ops(mod, capacity, script):
    """Run ``script`` (``('push', tok)`` / ``('pop',)`` / ``('len',)``)
    on a ring; returns every result, an exception as its type name."""
    ring, out = mod.TokenRing(capacity), []
    for op in script:
        try:
            out.append(getattr(ring, "__len__" if op[0] == "len"
                               else op[0])(*op[1:]))
        except (OverflowError, IndexError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("capacity,script", [
    (3, [("push", 1), ("push", 2), ("push", 3), ("push", 4), ("pop",),
         ("push", 4), ("pop",), ("pop",), ("pop",), ("len",)]),
    (2, [("pop",)] + [op for t in range(7)
                      for op in (("push", t), ("pop",))] + [("len",)]),
    (0, [("push", 42), ("push", 43), ("pop",), ("pop",)]),
])
def test_token_ring_matches_reference(capacity, script):
    """Overflow past capacity is loud, pop from empty is loud, the head
    wraps FIFO, and a zero capacity is clamped to one: the same results
    and the same exceptions as the reference's ring."""
    want = _ops(J, capacity, script)
    assert _ops(P, capacity, script) == want
    assert "OverflowError" in want or "IndexError" in want


class _StubEngine:
    """Emits ``plan[step]`` into the ring each step (None: nothing), then
    sets the request's final status."""

    def __init__(self, req, ring, plan, final):
        self.req, self.ring, self.plan, self.final = req, ring, plan, final
        self.steps = 0
        self.cancelled = []

    def step(self):
        tok = self.plan[self.steps] if self.steps < len(self.plan) else None
        self.steps += 1
        if tok is not None:
            self.ring.push(tok)
        if self.steps >= len(self.plan):
            self.req.status = self.final

    def cancel(self, req):
        self.cancelled.append(req.rid)
        req.status = "cancelled"


def _handle(mod, req_cls, plan, final, deadline_ms=None):
    req = req_cls(rid=7, prompt=np.zeros(3, np.int32), max_new=len(plan),
                  deadline_ms=deadline_ms)
    req.status = "queued"
    ring = mod.TokenRing(len(plan))
    eng = _StubEngine(req, ring, plan, final)
    return mod.RequestHandle(eng, req, ring), eng


@pytest.mark.parametrize("impl", IMPLS)
def test_handle_streams_and_drives_the_engine(impl):
    """Iterating a handle pops its ring and steps the engine only while
    the ring is empty; the stream, the step count and the states match
    the reference's handle."""
    mod, req_cls = impl
    plan = [5, None, 6, 7, None, 8]
    h, eng = _handle(mod, req_cls, plan, "done")
    jh, jeng = _handle(J, JRequest, plan, "done")
    assert (h.rid, h.status, h.done) == (jh.rid, jh.status, jh.done)
    assert list(h) == list(jh) == [5, 6, 7, 8]
    assert eng.steps == jeng.steps and h.done and h.status == "done"
    h2, _ = _handle(mod, req_cls, [1, 2], "done")
    assert h2.result() is h2.req and h2.done
    h3, eng3 = _handle(mod, req_cls, [1, 2], "done")
    h3.cancel()
    assert eng3.cancelled == [7] and h3.status == "cancelled" and h3.done
    assert list(h3) == []


@pytest.mark.parametrize("impl", IMPLS)
def test_shed_handle_raises_deadline_exceeded(impl):
    """A handle whose request was shed yields what its ring holds, then
    raises DeadlineExceeded naming the request."""
    mod, req_cls = impl
    h, _ = _handle(mod, req_cls, [3, None], "shed", deadline_ms=5.0)
    got = []
    with pytest.raises(mod.DeadlineExceeded, match="rid=7") as e:
        for t in h:
            got.append(t)
    assert got == [3] and e.value.deadline_ms == 5.0


def _req_pair(rid, deadline_ms, t_submit):
    out = []
    for cls in (JRequest, PRequest):
        r = cls(rid=rid, prompt=np.zeros(4, np.int32),
                deadline_ms=deadline_ms)
        r.t_submit = t_submit
        out.append(r)
    return out


def test_shed_expired_virtual_clock_boundaries():
    """Shedding is strictly after t_submit + deadline on the injected
    clock, deadline-less requests are never shed, and the kept keep their
    order: the same split as the reference's at every instant."""
    now = [0.0]
    sched = {"ref": J.ChunkScheduler(clock=lambda: now[0]),
             "port": P.ChunkScheduler(clock=lambda: now[0])}
    pairs = [_req_pair(0, 100.0, 0.0), _req_pair(1, None, 0.0),
             _req_pair(2, 50.0, 0.0), _req_pair(3, 50.0, 0.01)]
    for t, shed_want in ((0.0, []), (0.05, []), (0.0501, [2]),
                         (0.0601, [2, 3]), (10.0, [0, 2, 3])):
        now[0] = t
        got = {}
        for k, idx in (("ref", 0), ("port", 1)):
            kept, shed = sched[k].shed_expired([p[idx] for p in pairs])
            got[k] = ([r.rid for r in kept], [r.rid for r in shed])
        assert got["port"] == got["ref"]
        assert got["port"][1] == shed_want


def _random_world(seed):
    """Seeded in-flight admission batches in both packages' request
    types: random deadlines (some None), submit times, buckets, chunk
    offsets, true lengths, row offsets and cancelled rows."""
    rng = np.random.default_rng(seed)
    worlds = ([], [])
    queues = ([], [])
    rid = 0
    for _ in range(int(rng.integers(1, 6))):
        Bp = int(rng.integers(1, 5))
        bucket = int(rng.choice([8, 16, 32]))
        lengths = rng.integers(1, bucket + 1, size=Bp)
        rowpos = np.minimum(rng.integers(0, bucket + 1, size=Bp) // 8 * 8,
                            lengths)
        pos0 = int(rng.integers(0, bucket // 8)) * 8
        rows = ([], [])
        for i in range(Bp):
            dl = None if rng.random() < 0.4 else float(rng.integers(1, 50))
            pair = _req_pair(rid, dl, float(rng.integers(0, 3)) / 100)
            cancelled = rng.random() < 0.2
            for k in range(2):
                rows[k].append((i, None if cancelled else pair[k]))
            rid += 1
        for k in range(2):
            worlds[k].append({"reqs": rows[k], "bucket": bucket,
                              "pos0": pos0, "lengths_np": lengths.copy(),
                              "rowpos": rowpos.copy()})
    for _ in range(int(rng.integers(0, 8))):
        dl = None if rng.random() < 0.5 else float(rng.integers(1, 50))
        pair = _req_pair(rid, dl, float(rng.integers(0, 3)) / 100)
        for k in range(2):
            queues[k].append(pair[k])
        rid += 1
    return worlds, queues


def _row_ids(world, rows):
    return [(world.index(p), i) for p, i in rows]


@pytest.mark.parametrize("seed", range(6))
def test_orders_match_reference(seed):
    """order_queue (EDF, FIFO ties), pick_batch (EDF, then shortest
    remaining prefill, all-cancelled batches first) and pack_rows (the
    same order at token granularity, cancelled and complete rows skipped,
    at most the budget) give the reference's order on the same inputs."""
    (jw, pw), (jq, pq) = _random_world(seed)
    js, ps = J.ChunkScheduler(max_prefill_per_step=2), \
        P.ChunkScheduler(max_prefill_per_step=2)
    assert [r.rid for r in ps.order_queue(pq)] == \
        [r.rid for r in js.order_queue(jq)]
    assert pw.index(ps.pick_batch(pw)) == jw.index(js.pick_batch(jw))
    assert ps.pick_batch([]) is js.pick_batch([]) is None
    for budget in (1, 2, 3, 8):
        got = _row_ids(pw, ps.pack_rows(pw, budget))
        assert got == _row_ids(jw, js.pack_rows(jw, budget))
        assert len(got) <= budget
        assert len(set(got)) == len(got)


@pytest.mark.parametrize("impl", IMPLS)
def test_scheduler_rejects_bad_settings_and_full_queues(impl):
    """max_prefill_per_step < 1 and max_queue < 0 raise; at max_queue the
    admission check raises AdmissionRejected carrying rid and depth."""
    mod, _ = impl
    with pytest.raises(ValueError, match="max_prefill_per_step"):
        mod.ChunkScheduler(max_prefill_per_step=0)
    with pytest.raises(ValueError, match="max_queue"):
        mod.ChunkScheduler(max_queue=-1)
    s = mod.ChunkScheduler(max_queue=2)
    s.check_admission(0, 1)
    with pytest.raises(mod.AdmissionRejected, match="max_queue=2") as e:
        s.check_admission(5, 2)
    assert (e.value.rid, e.value.depth) == (5, 2)
