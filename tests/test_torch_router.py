"""The port's router, fleet and scaling policy held against the
reference's (``repro.serve.router``, ``repro.serve.fleet``) on the same
inputs, with no engine on either side.

Both packages drive the same scripted stand-in for a replica's engine
(:class:`_StubReplica`, behind the transport seam), on a virtual clock.
After every phase or fleet step the test records the router's queue
order, each record's replica, resume skip, streamed tokens and migration
count, the router's and the fleet's counters, each replica's lifecycle
state and what each caller's request holds; the port's record must equal
the reference's at every point. So a port that dispatches, migrates,
sheds, cancels or scales differently from the reference fails here even
where it would still hand back the right tokens.

The stand-in's tokens are a function of the context (prompt and tokens so
far), as greedy decode is, so every completed request is also checked
against that function's no-failure output.
"""
import types

import numpy as np
import pytest

import repro.serve as ref_serve
import repro_torch.serve as port_serve

PKGS = {"reference": ref_serve, "port": port_serve}
CHUNK = 8  # prompt tokens the stand-in prefills per step
VOCAB = 97


def _next_token(ctx) -> int:
    return int((31 * int(np.sum(ctx, dtype=np.int64)) + 7 * len(ctx))
               % VOCAB)


def _greedy(prompt, max_new, eos=None) -> list:
    """The no-failure output of the stand-in's deterministic 'model'."""
    toks = []
    while len(toks) < max_new and not (toks and toks[-1] == eos):
        toks.append(_next_token(np.concatenate([prompt, toks])))
    return toks


def _prompt(rid, n):
    return np.random.default_rng(100 + rid).integers(
        0, VOCAB, n).astype(np.int32)


class _StubReplica:
    """A scripted replica behind the transport seam. A shadow request
    spends one step queued in the engine and ``ceil(len(prompt) / CHUNK)``
    steps prefilling (its first token comes with the last of them), then
    emits one token per step; it turns "done" on the step AFTER its last
    token, so a replica's death can race the router's drain. Killed, it
    refuses every call with the package's ``ReplicaDead``."""

    def __init__(self, pkg, scfg, replica_id, warm):
        self.pkg, self.scfg = pkg, scfg
        self.replica_id, self.warm = replica_id, warm
        self.dead = False
        self.live = []  # [shadow, handle, prefill steps left, tokens]
        self.packed = 0
        self.steps = 0

    def _check(self, op):
        if self.dead:
            raise self.pkg.ReplicaDead(self.replica_id, op)

    def submit(self, req):
        self._check("submit")
        req.status = "queued"
        h = types.SimpleNamespace(req=req,
                                  ring=self.pkg.TokenRing(req.max_new))
        self.live.append([req, h, -(-len(req.prompt) // CHUNK), []])
        return h

    def cancel(self, req):
        self._check("cancel")
        req.status = "cancelled"

    def step(self, failed_group=None):
        self._check("step")
        self.steps += 1
        for ent in self.live:
            req, h, _, toks = ent
            if req.status == "queued":
                req.status = "prefill"
                continue
            if req.status == "prefill":
                ent[2] -= 1
                if ent[2] > 0:
                    continue
                self.packed += len(req.prompt)
                req.status = "decoding"
            if req.status != "decoding":
                continue
            if len(toks) >= req.max_new or (
                    toks and req.eos_token is not None
                    and toks[-1] == req.eos_token):
                req.status = "done"
                continue
            tok = _next_token(np.concatenate([req.prompt, toks]))
            toks.append(tok)
            h.ring.push(tok)
        self.live = [e for e in self.live
                     if e[0].status not in ("done", "cancelled")]
        return len(self.live)

    def heartbeat(self):
        self._check("heartbeat")
        return True

    def idle(self):
        self._check("idle")
        return not self.live

    def metrics(self):
        self._check("metrics")
        return {"packed_tokens": self.packed, "steps": self.steps}

    def warm_state(self):
        self._check("warm_state")
        return {"from_replica": self.replica_id}

    def kill(self):
        self.dead = True
        self.live = []


def _router_snap(router, reqs) -> dict:
    recs = sorted(
        (rec.req.rid, rec.replica, rec.skip, tuple(rec.toks),
         rec.migrations, rec.dispatched,
         None if rec.shadow is None else
         (len(rec.shadow.prompt), rec.shadow.max_new))
        for rec in router.records.values())
    callers = [(r.rid, r.status,
                None if r.out is None else np.asarray(r.out).tolist(),
                r.t_submit, r.t_first, r.t_done, list(r.tok_times))
               for r in reqs]
    return {"queue": [r.rid for r in router.queue], "records": recs,
            "metrics": dict(router.metrics), "callers": callers}


def _check_outputs(reqs):
    """Completed requests hold the no-failure output; cancelled ones a
    prefix of it."""
    for r in reqs:
        want = _greedy(r.prompt, r.max_new, r.eos_token)
        if r.status == "done":
            assert np.asarray(r.out).tolist() == want, r.rid
        elif r.status == "cancelled":
            got = np.asarray(r.out).tolist()
            assert got == want[:len(got)], r.rid


def _same_trace(traces):
    ref, port = traces["reference"], traces["port"]
    assert [lbl for lbl, _ in port] == [lbl for lbl, _ in ref]
    for (lbl, want), (_, got) in zip(ref, port):
        assert got == want, f"port diverges from the reference at {lbl}"


# -- the router alone, phase by phase -----------------------------------------

# rid: (prompt length, max_new, deadline_ms)
_WAVE = {0: (5, 6, None), 1: (15, 6, None), 2: (12, 6, None),
         3: (3, 2, None), 4: (16, 6, None), 5: (7, 6, 500.0),
         6: (9, 6, None), 7: (4, 6, 5.0), 8: (15, 6, None),
         9: (6, 6, None), 10: (10, 6, None), 11: (8, 6, None)}


def _drive_router(pkg):
    t = [0.0]
    scfg = pkg.ServeConfig(max_batch=3, max_seq=40, prefill_buckets=(8, 16),
                           prefill_chunk=CHUNK, max_queue=11,
                           clock=lambda: t[0])
    fleet = types.SimpleNamespace(tr={})
    fleet.transport_of = fleet.tr.get
    router = pkg.Router(fleet, scfg)
    reqs, trace = [], []

    def snap(label):
        trace.append((label, _router_snap(router, reqs)))

    def submit(rid, n, max_new, deadline_ms=None, eos=None):
        t[0] += 1e-3
        req = pkg.Request(rid=rid, prompt=_prompt(rid, n), max_new=max_new,
                          deadline_ms=deadline_ms, eos_token=eos)
        try:
            router.submit(req)
        except Exception as e:  # noqa: BLE001 - the class is compared
            return type(e).__name__
        reqs.append(req)
        return "ok"

    def spawn(i):
        fleet.tr[i] = _StubReplica(pkg, scfg, i, None)

    def reps(*ids):
        return [types.SimpleNamespace(rid=i, transport=fleet.tr[i])
                for i in ids]

    def engine_step(*ids):
        for i in ids:
            fleet.tr[i].step()

    # admission: 11 fit, the 12th meets max_queue, two break a bound
    eos9 = _greedy(_prompt(9, 6), 6)[3]
    got = [submit(rid, n, mn, dl, eos9 if rid == 9 else None)
           for rid, (n, mn, dl) in _WAVE.items()]
    got += [submit(20, 17, 4), submit(21, 16, 30)]
    trace.append(("submit outcomes", got))
    snap("submit")
    t[0] += 0.02
    router.shed()  # rid 7's 5 ms deadline has lapsed
    snap("shed")
    for i in range(3):
        spawn(i)
    router.dispatch(reps(0, 1, 2))
    snap("dispatch")
    for s in range(4):
        engine_step(0, 1, 2)
        if s != 1:  # one drain skipped: the next one pops two tokens
            router.drain()
            router.dispatch(reps(0, 1, 2))
        snap(f"step {s}")
    # kill replica 1 while it holds decoding, prefilling and queued work
    fleet.tr[1].kill()
    router.migrate(1)
    snap("migrate 1")
    spawn(3)
    router.dispatch(reps(0, 1, 2, 3))  # replica 1 is dead: nothing lands
    snap("dispatch to a dead replica")
    router.cancel(router.queue[0])  # router-queued
    on0 = sorted(rec.req.rid for rec in router.records.values()
                 if rec.replica == 0)
    router.cancel(next(r for r in reqs if r.rid == on0[0]))  # dispatched
    router.cancel(next(r for r in reqs if r.status == "done"))  # no-op
    snap("cancel")
    t[0] += 1.0
    got = submit(30, 5, 4, deadline_ms=1.0)
    t[0] += 0.01
    router.shed()  # the new request goes; the migrated ones stay
    snap(f"shed after migration ({got})")
    live = [0, 2, 3]
    for s in range(60):
        if router.idle():
            break
        if s == 2:
            # a second death: cancel on the dead replica, then migrate
            fleet.tr[2].kill()
            on2 = sorted(rec.req.rid for rec in router.records.values()
                         if rec.replica == 2)
            router.cancel(next(r for r in reqs if r.rid == on2[-1]))
            router.migrate(2)
            live = [0, 3]
        router.dispatch(reps(*live))
        engine_step(*live)
        router.drain()
        snap(f"run {s}")
    assert router.idle()
    return trace, reqs, router


def test_router_matches_reference_phase_by_phase():
    traces = {}
    for name, pkg in PKGS.items():
        traces[name], reqs, router = _drive_router(pkg)
        _check_outputs(reqs)
    _same_trace(traces)
    m = router.metrics  # the script reached every path it means to
    assert m["rejected"] == 1 and m["shed"] == 2 and m["cancelled"] >= 3
    assert m["replayed"] >= 1 and m["resume_prefix"] >= 1
    assert m["resume_recompute"] >= 1


# -- the whole fleet, step by step ---------------------------------------------


def _fleet_snap(fleet, reqs) -> dict:
    out = _router_snap(fleet.router, reqs)
    out["steps"] = fleet.steps
    out["fleet"] = dict(fleet.metrics)
    out["replicas"] = {
        rid: (rep.state, rep.failed, rep.active, rep.packed_seen,
              rep.steps_seen, rep.transport.warm)
        for rid, rep in fleet.replicas.items()}
    fm = fleet.fleet_metrics()
    out["fleet_metrics"] = {k: v for k, v in fm.items() if k != "replicas"}
    out["per_replica"] = fm["replicas"]
    return out


# name: (fleet config, serve config, requests, kill {step: replica},
#        cancel {step: "queued" | "decoding"}, idle steps after the wave)
_SCENARIOS = {
    "kill-mid-decode": (dict(replicas=4), dict(max_batch=3),
                        15, {5: 1}, {}, 0),
    "kill-last-replica-autoscale": (
        dict(replicas=1, policy=dict(max_replicas=2, decide_every=1)),
        dict(max_batch=4), 6, {3: 0}, {}, 0),
    "scale-up-then-drain": (
        dict(replicas=1, policy=dict(max_replicas=3, scale_up_depth=1,
                                     decide_every=2, scale_down_util=0.5)),
        dict(max_batch=2, token_budget=16), 12, {}, {}, 12),
    "idle-pool-drains-lowest-id": (
        dict(replicas=3, policy=dict(max_replicas=3, decide_every=2,
                                     scale_down_util=0.3)),
        dict(max_batch=2), 4, {}, {}, 8),
    "heartbeat-gap-cancel-shed": (
        dict(replicas=3, heartbeat_every=3), dict(max_batch=2, max_queue=9),
        10, {4: 1}, {1: "queued", 5: "decoding"}, 0),
}


def _drive_fleet(pkg, scenario):
    fkw, skw, n_req, kills, cancels, tail = _SCENARIOS[scenario]
    t = [0.0]
    scfg = pkg.ServeConfig(max_seq=48, prefill_buckets=(8, 16),
                           prefill_chunk=CHUNK, clock=lambda: t[0], **skw)
    fkw = dict(fkw)
    if "policy" in fkw:
        fkw["policy"] = pkg.ScalingPolicy(**fkw["policy"])

    def factory(cfg, rep_scfg, params, *, replica_id, warm, **_):
        return _StubReplica(pkg, rep_scfg, replica_id, warm)

    fleet = pkg.Fleet(None, scfg, None,
                      pkg.FleetConfig(transport_factory=factory, **fkw))
    reqs, trace = [], []
    for rid in range(n_req):
        t[0] += 1e-3
        n = 3 + (rid * 5) % 14
        dl = 2.0 if scenario.startswith("heartbeat") and rid % 4 == 3 \
            else None
        req = pkg.Request(rid=rid, prompt=_prompt(rid, n),
                          max_new=2 + 3 * (rid % 3),
                          deadline_ms=dl)
        try:
            fleet.submit(req)
        except Exception as e:  # noqa: BLE001 - the class is compared
            trace.append((f"submit {rid}", type(e).__name__))
            continue
        reqs.append(req)
    t[0] += 0.005  # the 2 ms deadlines lapse before the first step
    trace.append(("submitted", _fleet_snap(fleet, reqs)))
    idle_steps = 0
    for s in range(200):
        if s in kills:
            fleet.kill_replica(kills[s])
        if s in cancels:
            want = cancels[s]
            pick = [r for r in reqs if r.status == ("queued" if want ==
                    "queued" else "decoding")]
            if pick:
                fleet.cancel(pick[0])
        t[0] += 1e-3
        fleet.step()
        trace.append((f"step {s}", _fleet_snap(fleet, reqs)))
        if fleet.idle():
            idle_steps += 1
            if idle_steps > tail:
                break
    assert fleet.idle()
    return trace, reqs, fleet


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_fleet_matches_reference_step_by_step(scenario):
    traces = {}
    for name, pkg in PKGS.items():
        traces[name], reqs, fleet = _drive_fleet(pkg, scenario)
        _check_outputs(reqs)
    _same_trace(traces)
    fm = fleet.fleet_metrics()  # what each scenario is there to reach
    warm = {rid: rep.transport.warm for rid, rep in fleet.replicas.items()}
    assert warm[0] is None and all(
        w == {"from_replica": 0} for rid, w in warm.items() if rid)
    if scenario == "kill-mid-decode":
        assert fm["failed"] == 1 and fm["router_resume_prefix"] >= 1
        assert fm["router_resume_recompute"] >= 1
    elif scenario == "kill-last-replica-autoscale":
        assert fm["failed"] == 1 and fm["scale_ups"] >= 1
    elif scenario == "scale-up-then-drain":
        assert fm["scale_ups"] >= 1 and fm["scale_downs"] >= 1
        assert fm["retired"] >= 1
    elif scenario == "idle-pool-drains-lowest-id":
        assert fm["retired"] == 2
    else:
        assert fm["failed"] == 1 and fm["router_shed"] >= 1
        assert fm["router_cancelled"] == 2


# -- the scaling policy and the configs' bounds --------------------------------


def test_scaling_policy_matches_reference_over_a_grid():
    utils_of = {"none": lambda h: [], "idle": lambda h: [0.1] * h,
                "mixed": lambda h: [0.1] * max(h - 1, 0) + [0.9],
                "busy": lambda h: [1.0] * h, "edge": lambda h: [0.25] * h}
    n = 0
    for lo, hi, depth, util in [(1, 4, 4, 0.25), (2, 3, 1, 0.5),
                                (1, 1, 2, 0.25), (3, 6, 3, 0.0)]:
        pols = {k: p.ScalingPolicy(min_replicas=lo, max_replicas=hi,
                                   scale_up_depth=depth,
                                   scale_down_util=util)
                for k, p in PKGS.items()}
        for healthy in range(0, 8):
            for depth_q in (0, 1, 2, 3, 4, 5, 8, 9, 12, 13, 17, 40):
                for kind, uf in utils_of.items():
                    args = (depth_q, healthy, uf(healthy))
                    want = pols["reference"].decide(*args)
                    assert pols["port"].decide(*args) == want, (
                        lo, hi, depth, util, kind, args)
                    n += 1
    assert n == 4 * 8 * 12 * 5


@pytest.mark.parametrize("cls,kw", [
    ("ScalingPolicy", dict(min_replicas=0)),
    ("ScalingPolicy", dict(min_replicas=3, max_replicas=2)),
    ("ScalingPolicy", dict(decide_every=0)),
    ("FleetConfig", dict(replicas=0)),
    ("FleetConfig", dict(heartbeat_every=0)),
])
def test_fleet_bounds_refused_as_the_reference_refuses(cls, kw):
    msgs = {}
    for name, pkg in PKGS.items():
        with pytest.raises(ValueError) as e:
            getattr(pkg, cls)(**kw)
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]
