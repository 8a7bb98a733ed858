"""The port's multi-replica fleet (``repro_torch.serve.fleet``, ``router``,
``transport``): counterparts of every test in ``tests/test_fleet.py`` and
of the fleet cases of ``tests/test_scheduler_edges.py``, on llama3.2-1b
smoke params on the CPU.

The oracle is the port's own no-failure single-engine run, as the
reference's tests use the reference's (the single engine is held against
the JAX engine in ``test_torch_serve.py``), so no JAX engine runs here.

The headline guarantee: kill a replica mid-decode and every request
finishes with the no-failure run's exact tokens. A decoding request
resumes by PREFILLING ``prompt + generated prefix`` where the no-failure
run DECODED those positions, so the guarantee rests on the engine giving
a position the same bits on both paths;
``test_prefill_and_decode_give_a_position_the_same_bits`` pins that on the
CPU, and ``tests/test_torch_cuda.py`` on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.ft import quantize
from repro_torch.models import get_model
from repro_torch.serve import (DEAD, DRAINING, HEALTHY, STARTING,
                               DeadlineExceeded, Fleet, FleetConfig,
                               ReplicaDead, Request, ScalingPolicy,
                               ServeConfig, ServeEngine)

RNG = np.random.default_rng(23)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama3.2-1b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 max_seq=48, device=CPU)
    return cfg, params


def _prompts(vocab, lengths):
    return [RNG.integers(0, vocab, size=n).astype(np.int32)
            for n in lengths]


def _scfg(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 48)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("prefill_chunk", 8)
    return ServeConfig(**kw)


def _fleet(cfg, scfg, params, **kw):
    return Fleet(cfg, scfg, params, FleetConfig(device=CPU, **kw))


def _reference(cfg, scfg, params, prompts, max_new):
    """The no-failure single-engine run: the bit-identity oracle."""
    eng = ServeEngine(cfg, scfg, params, device=CPU)
    hs = [eng.submit(Request(rid=i, prompt=p, max_new=max_new))
          for i, p in enumerate(prompts)]
    eng.run_to_completion(max_steps=500)
    return [np.asarray(h.req.out).copy() for h in hs]


# -- acceptance: kill mid-decode, bit-identical completion --------------------


@pytest.mark.parametrize("ft_mode,ft_scope", [
    ("none", "head"), ("entangle", "head"), ("entangle", "all")])
def test_kill_mid_decode_completes_bit_identical(setup, ft_mode, ft_scope):
    """4 replicas, one killed mid-decode: every request finishes with the
    no-failure run's exact tokens, and the survivors' (shared) plans never
    miss."""
    cfg, params = setup
    scfg = _scfg(ft_mode=ft_mode, ft_scope=ft_scope,
                 token_budget=16 if ft_mode == "none" else 0)
    # short prompts prefix-resume; the 15-token ones outgrow the 16 bucket
    # once a prefix is appended and recompute
    prompts = _prompts(cfg.vocab_size, (4, 9, 12, 5, 15, 3, 15, 6))
    ref = _reference(cfg, scfg, params, prompts, max_new=10)

    fleet = _fleet(cfg, scfg, params, replicas=4)
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=10))
          for i, p in enumerate(prompts)]
    for _ in range(6):
        fleet.step()
    assert any(h.status == "decoding" for h in hs), "kill must land mid-decode"
    fleet.kill_replica(2)
    fleet.run_to_completion(max_steps=500)

    m = fleet.fleet_metrics()
    assert m["failed"] == 1 and m["router_migrated"] >= 1
    assert fleet.replicas[2].state == DEAD and fleet.replicas[2].failed
    for h, want in zip(hs, ref):
        assert h.status == "done"
        np.testing.assert_array_equal(np.asarray(h.req.out), want)
    for rep in fleet.replicas.values():
        if rep.live and rep.transport.engine.plans is not None:
            assert rep.transport.engine.plans.misses == 0


def test_both_resume_paths_exercised_and_exact(setup):
    """One request down each decoding recovery path: prefix resume
    (prompt + prefix fits the largest bucket) and recompute with the
    prefix dropped (it does not); both streams equal the oracle."""
    cfg, params = setup
    scfg = _scfg()
    prompts = _prompts(cfg.vocab_size, (4, 15))  # 4+k <= 16; 15+k > 16
    ref = _reference(cfg, scfg, params, prompts, max_new=12)

    fleet = _fleet(cfg, scfg, params, replicas=3)
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=12))
          for i, p in enumerate(prompts)]
    for _ in range(7):  # both decode a few steps (k >= 2) before the kill
        fleet.step()
    assert all(h.status == "decoding" for h in hs)
    # the two requests sit on distinct replicas; kill each holder (letting
    # the first migration land in between), the third replica survives
    holder0 = fleet.router.records[id(hs[0].req)].replica
    fleet.kill_replica(holder0)
    fleet.step()
    holder1 = fleet.router.records[id(hs[1].req)].replica
    if holder1 != holder0:
        fleet.kill_replica(holder1)
    fleet.run_to_completion(max_steps=500)
    m = fleet.fleet_metrics()
    assert m["router_resume_prefix"] >= 1, "short prompt must prefix-resume"
    assert m["router_resume_recompute"] >= 1, "long prompt must recompute"
    for h, want in zip(hs, ref):
        assert h.status == "done"
        np.testing.assert_array_equal(np.asarray(h.req.out), want)


def test_handle_iterator_survives_migration(setup):
    """An iterator opened BEFORE the kill streams on across it: the whole
    no-failure sequence, no repeated token, no exception."""
    cfg, params = setup
    scfg = _scfg()
    prompts = _prompts(cfg.vocab_size, (5, 7, 9))
    ref = _reference(cfg, scfg, params, prompts, max_new=10)

    fleet = _fleet(cfg, scfg, params, replicas=2)
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=10))
          for i, p in enumerate(prompts)]
    streams = [[] for _ in hs]
    its = [h.tokens() for h in hs]
    for _ in range(3):
        for toks, it in zip(streams, its):
            toks.append(next(it))
    fleet.kill_replica(0)
    for toks, it in zip(streams, its):
        toks.extend(it)  # drain through the SAME iterator
    for toks, want in zip(streams, ref):
        np.testing.assert_array_equal(np.asarray(toks, np.int32), want)


def test_queued_and_mid_prefill_requests_replay(setup):
    """Requests the dead replica had not started decoding (router-queued
    or mid-prefill) replay through normal admission on the survivors:
    the same tokens, counted as replays, not resumes."""
    cfg, params = setup
    scfg = _scfg(prefill_chunk=4, max_prefill_per_step=1)
    # long prompts prefill over several steps; more requests than fleet
    # slots, so some stay router-queued at the kill
    prompts = _prompts(cfg.vocab_size, (16,) * 6)
    ref = _reference(cfg, scfg, params, prompts, max_new=6)

    fleet = _fleet(cfg, scfg, params, replicas=2)
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=6))
          for i, p in enumerate(prompts)]
    fleet.step()  # dispatch and the first prefill chunk only
    assert any(h.status == "prefill" for h in hs)
    assert not any(h.status == "decoding" for h in hs)
    fleet.kill_replica(1)
    fleet.run_to_completion(max_steps=500)
    m = fleet.fleet_metrics()
    assert m["router_migrated"] >= 1
    assert m["router_resume_prefix"] == 0 and m["router_resume_recompute"] == 0
    assert m["router_replayed"] >= 1
    for h, want in zip(hs, ref):
        assert h.status == "done"
        np.testing.assert_array_equal(np.asarray(h.req.out), want)


# -- warm scale-up ------------------------------------------------------------


def test_spawn_shares_warm_state_no_requantize(setup):
    """Every replica after the first reuses the first one's census,
    compiled plans and quantized weights: a spawn quantizes no weight and
    shares the SAME CompiledPlans object (one misses counter)."""
    cfg, params = setup
    scfg = _scfg(ft_mode="entangle", ft_scope="all")
    fleet = _fleet(cfg, scfg, params, replicas=1)
    e0 = fleet.replicas[0].transport.engine
    assert e0.plans is not None

    wq0 = quantize.TRACE_STATS["weight_quantize_calls"]
    rep1 = fleet._spawn()
    assert quantize.TRACE_STATS["weight_quantize_calls"] == wq0, \
        "spawn re-quantized protected weights"
    e1 = rep1.transport.engine
    assert e1.plans is e0.plans
    assert e1.ft_params is e0.ft_params
    assert e1.protected_census is e0.protected_census
    assert e1.head_q is e0.head_q
    assert e1.plans.misses == 0

    # ...and the spawned replica serves: a wave across both
    prompts = _prompts(cfg.vocab_size, (5, 6, 7, 8))
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=4))
          for i, p in enumerate(prompts)]
    fleet.run_to_completion(max_steps=300)
    assert all(h.status == "done" for h in hs)
    assert e0.plans.misses == 0
    assert fleet.router.metrics["queue_depth_peak"] == 4


def test_warm_state_rejects_config_mismatch(setup):
    """A warm state from a differently configured engine is refused:
    serving another program set's plans would be unsafe at the kernel."""
    cfg, params = setup
    eng = ServeEngine(cfg, _scfg(), params, device=CPU)
    other = dataclasses.replace(_scfg(), max_batch=8)
    with pytest.raises(ValueError, match="differently configured"):
        ServeEngine(cfg, other, params, device=CPU, warm=eng.warm_state())


# -- lifecycle ----------------------------------------------------------------


def test_replica_lifecycle_and_drain_retirement(setup):
    """STARTING promotes on the first heartbeat; a DRAINING replica takes
    no new work, finishes what it holds and retires DEAD with
    ``failed=False`` (graceful, unlike a fail-stop)."""
    cfg, params = setup
    fleet = _fleet(cfg, _scfg(), params, replicas=2)
    assert all(r.state == STARTING for r in fleet.replicas.values())
    h0 = fleet.submit(Request(rid=0, prompt=_prompts(cfg.vocab_size, (6,))[0],
                              max_new=6))
    fleet.step()
    assert all(r.state == HEALTHY for r in fleet.replicas.values())

    holder = fleet.router.records[id(h0.req)].replica
    fleet.replicas[holder].state = DRAINING
    h1 = fleet.submit(Request(rid=1, prompt=_prompts(cfg.vocab_size, (6,))[0],
                              max_new=6))
    fleet.step()
    assert fleet.router.records[id(h1.req)].replica != holder, \
        "DRAINING replica accepted new work"
    fleet.run_to_completion(max_steps=300)
    assert h0.status == "done" and h1.status == "done"
    assert fleet.replicas[holder].state == DEAD
    assert not fleet.replicas[holder].failed
    assert fleet.fleet_metrics()["retired"] == 1


def test_dead_transport_refuses_everything(setup):
    cfg, params = setup
    fleet = _fleet(cfg, _scfg(), params, replicas=1)
    tr = fleet.replicas[0].transport
    tr.kill()
    assert tr.engine is None  # the replica's state is gone
    for op in (lambda: tr.step(), lambda: tr.heartbeat(), lambda: tr.idle(),
               lambda: tr.metrics(), lambda: tr.warm_state(),
               lambda: tr.cancel(Request(rid=9, prompt=np.zeros(4, np.int32))),
               lambda: tr.submit(Request(rid=9, prompt=np.zeros(4, np.int32)))):
        with pytest.raises(ReplicaDead):
            op()


def test_kill_last_replica_recovers_via_autoscaling(setup):
    """Killing the only live replica is a full outage: requests wait in
    the router queue until the scaling policy revives the pool, then
    complete with the no-failure tokens."""
    cfg, params = setup
    scfg = _scfg()
    prompts = _prompts(cfg.vocab_size, (5, 9))
    ref = _reference(cfg, scfg, params, prompts, max_new=6)
    pol = ScalingPolicy(min_replicas=1, max_replicas=2, scale_up_depth=99,
                        decide_every=1)
    fleet = _fleet(cfg, scfg, params, replicas=1, policy=pol)
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=6))
          for i, p in enumerate(prompts)]
    for _ in range(3):
        fleet.step()
    fleet.kill_replica(0)
    fleet.run_to_completion(max_steps=300)
    m = fleet.fleet_metrics()
    assert m["failed"] == 1 and m["spawned"] >= 2
    for h, want in zip(hs, ref):
        assert h.status == "done"
        np.testing.assert_array_equal(np.asarray(h.req.out), want)


# -- autoscaling --------------------------------------------------------------


def test_scaling_policy_decisions():
    pol = ScalingPolicy(min_replicas=1, max_replicas=4, scale_up_depth=4,
                        scale_down_util=0.25)
    assert pol.decide(queue_depth=0, healthy=0, utils=[]) == 1  # below min
    assert pol.decide(queue_depth=9, healthy=2, utils=[1.0, 1.0]) == 1
    assert pol.decide(queue_depth=8, healthy=2, utils=[1.0, 1.0]) == 0
    assert pol.decide(queue_depth=0, healthy=2, utils=[0.1, 0.2]) == -1
    assert pol.decide(queue_depth=0, healthy=2, utils=[0.1, 0.9]) == 0
    assert pol.decide(queue_depth=0, healthy=1, utils=[0.0]) == 0  # at min
    assert pol.decide(queue_depth=99, healthy=4, utils=[1.0] * 4) == 0  # max
    with pytest.raises(ValueError, match="min_replicas"):
        ScalingPolicy(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        ScalingPolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="decide_every"):
        ScalingPolicy(decide_every=0)
    with pytest.raises(ValueError, match="replicas"):
        FleetConfig(replicas=0)
    with pytest.raises(ValueError, match="heartbeat_every"):
        FleetConfig(heartbeat_every=0)


def test_fleet_scales_up_then_drains_idle_replica(setup):
    """A deep queue spawns a (warm) replica; once the burst drains and
    utilization collapses, the policy drains one back toward the
    minimum."""
    cfg, params = setup
    scfg = _scfg(token_budget=16)
    pol = ScalingPolicy(min_replicas=1, max_replicas=2, scale_up_depth=2,
                        scale_down_util=0.25, decide_every=2)
    fleet = _fleet(cfg, scfg, params, replicas=1, policy=pol)
    prompts = _prompts(cfg.vocab_size, (8,) * 10)
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=6))
          for i, p in enumerate(prompts)]
    fleet.run_to_completion(max_steps=500)
    m = fleet.fleet_metrics()
    assert m["scale_ups"] >= 1
    assert all(h.status == "done" for h in hs)
    for _ in range(3 * pol.decide_every):  # idle: low utilization drains
        fleet.step()
    m = fleet.fleet_metrics()
    assert m["scale_downs"] >= 1
    assert len([r for r in fleet.replicas.values()
                if r.state in (HEALTHY, DRAINING)]) >= pol.min_replicas


# -- request handles across a migration (test_scheduler_edges.py) -------------


def test_handle_status_transitions_during_migration(setup):
    """The caller's status walks queued -> decoding -> done even when the
    serving replica dies mid-decode: migration bounces the request
    through 'queued', never through a terminal state."""
    cfg, params = setup
    fleet = _fleet(cfg, _scfg(), params, replicas=2)
    prompt = RNG.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    h = fleet.submit(Request(rid=0, prompt=prompt, max_new=8))
    assert h.status == "queued" and not h.done
    seen = {h.status}
    while h.status != "decoding":
        fleet.step()
        seen.add(h.status)
    holder = fleet.router.records[id(h.req)].replica
    fleet.kill_replica(holder)
    fleet.step()  # the heartbeat detects; the request re-enters the queue
    assert h.status in ("queued", "prefill", "decoding")
    assert not h.done, "migration must never fake a terminal state"
    fleet.run_to_completion(max_steps=300)
    seen.add(h.status)
    assert h.status == "done" and h.done
    assert {"queued", "decoding", "done"} <= seen
    assert len(np.asarray(h.req.out)) == 8


def test_cancel_while_request_is_mid_migration(setup):
    """A cancel between the replica's death and the re-dispatch finalizes
    the request as 'cancelled' with the streamed prefix as its output, and
    it is never dispatched again."""
    cfg, params = setup
    fleet = _fleet(cfg, _scfg(), params, replicas=2)
    prompt = RNG.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    h = fleet.submit(Request(rid=0, prompt=prompt, max_new=8))
    while h.status != "decoding":
        fleet.step()
    rec = fleet.router.records[id(h.req)]
    holder = rec.replica
    fleet.replicas[holder].transport.kill()
    fleet.router.migrate(holder)  # as the heartbeat would
    assert h.status == "queued" and rec.replica is None
    streamed = len(rec.toks)
    h.cancel()
    assert h.status == "cancelled" and h.done
    assert len(np.asarray(h.req.out)) == streamed
    fleet.run_to_completion(max_steps=50)
    assert fleet.fleet_metrics()["router_replayed"] == 0, \
        "cancelled request was re-dispatched after migration"
    assert len(list(h.tokens())) == streamed


def test_cancel_every_pre_terminal_state_via_fleet(setup):
    cfg, params = setup
    fleet = _fleet(cfg, _scfg(prefill_chunk=4), params, replicas=1)

    def mk(rid):
        return Request(rid=rid, max_new=6, prompt=RNG.integers(
            0, cfg.vocab_size, 14).astype(np.int32))

    h_q = fleet.submit(mk(0))  # queued: cancel before any step
    h_q.cancel()
    assert h_q.status == "cancelled" and not fleet.router.queue
    h_p = fleet.submit(mk(1))  # mid-prefill (bucket 16 / chunk 4)
    fleet.step()
    assert h_p.status == "prefill"
    h_p.cancel()
    assert h_p.status == "cancelled"
    h_d = fleet.submit(mk(2))  # decoding
    while h_d.status != "decoding":
        fleet.step()
    h_d.cancel()
    assert h_d.status == "cancelled"
    fleet.run_to_completion(max_steps=100)
    assert fleet.fleet_metrics()["router_cancelled"] == 3
    h_q.cancel()  # terminal states are cancel no-ops
    assert h_q.status == "cancelled"


def test_fleet_sheds_expired_but_exempts_migrated(setup):
    """Router-level shedding on a virtual clock: a queued request past its
    deadline is shed (DeadlineExceeded on iteration), but a MIGRATED one,
    equally late, is exempt."""
    cfg, params = setup
    vclock = [0.0]
    fleet = _fleet(cfg, _scfg(clock=lambda: vclock[0]), params, replicas=2)
    prompt = RNG.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    h_mig = fleet.submit(Request(rid=0, prompt=prompt, max_new=8,
                                 deadline_ms=100.0))
    while h_mig.status != "decoding":
        fleet.step()
    holder = fleet.router.records[id(h_mig.req)].replica
    fleet.kill_replica(holder)
    vclock[0] += 10.0  # far past every deadline
    h_new = fleet.submit(Request(rid=1, prompt=prompt, max_new=4,
                                 deadline_ms=1.0))
    h_new.req.t_submit = 0.0  # submitted at t=0, now 10 s late
    fleet.run_to_completion(max_steps=300)
    assert h_new.status == "shed"
    with pytest.raises(DeadlineExceeded):
        list(h_new.tokens())
    assert h_mig.status == "done", "migrated request must not be shed"
    assert len(np.asarray(h_mig.req.out)) == 8
    m = fleet.fleet_metrics()
    assert m["router_shed"] == 1 and m["router_migrated"] == 1


def test_router_admission_bounds(setup):
    """The engine's capacity rules hold fleet-wide at submit: a prompt
    past the largest bucket and a request past max_seq are refused, and
    max_queue rejects loudly."""
    from repro_torch.serve import AdmissionRejected

    cfg, params = setup
    fleet = _fleet(cfg, _scfg(max_queue=1), params, replicas=1)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        fleet.submit(Request(rid=0, prompt=np.zeros(17, np.int32)))
    with pytest.raises(ValueError, match="max_seq"):
        fleet.submit(Request(rid=1, prompt=np.zeros(8, np.int32),
                             max_new=41))
    fleet.submit(Request(rid=2, prompt=np.zeros(8, np.int32), max_new=2))
    with pytest.raises(AdmissionRejected):
        fleet.submit(Request(rid=3, prompt=np.zeros(8, np.int32)))
    assert fleet.router.metrics["rejected"] == 1
    fleet.run_to_completion(max_steps=50)


# -- the property the resume rests on ----------------------------------------


class _Rec(ServeEngine):
    """Keeps row 0's final hidden state and logits of every head call."""

    def _head_logits(self, h, mask, failed_group, ft_fn):
        logits = super()._head_logits(h, mask, failed_group, ft_fn)
        self.log.append((h[0].clone(), logits[0].clone()))
        return logits


@pytest.mark.parametrize("kw", [
    dict(), dict(ft_mode="entangle", ft_scope="all"),
    dict(prefill_chunk=0), dict(token_budget=16)],
    ids=["none", "entangle-all", "whole-bucket", "packed"])
def test_prefill_and_decode_give_a_position_the_same_bits(setup, kw):
    """The position after ``prompt + k`` generated tokens gets the same
    final hidden state and logits, bit for bit, when the engine decodes it
    (the no-failure run) and when it prefills ``prompt + prefix`` (a
    prefix resume), in each admission mode."""
    cfg, params = setup
    scfg = _scfg(**kw)
    prompt = _prompts(cfg.vocab_size, (5,))[0]

    def run(p, max_new):
        eng = _Rec(cfg, scfg, params, device=CPU)
        eng.log = []
        h = eng.submit(Request(rid=0, prompt=p, max_new=max_new))
        eng.run_to_completion()
        return np.asarray(h.req.out), eng.log

    out, log = run(prompt, 10)
    for k in (1, 4, 9):
        tail, log_k = run(np.concatenate([prompt, out[:k]]), 10 - k)
        for a, b in zip(log[k], log_k[0]):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
        np.testing.assert_array_equal(tail, out[k:])
