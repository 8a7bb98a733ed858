"""The serving engine and the fleet on the port's recurrent families,
falcon-mamba-7b (Mamba-1) and recurrentgemma-2b (RG-LRU + rolling-window
MQA, window 16), at their smoke configs on the reference's params bridged
over: the counterparts of the reference's engine tests for these archs
(``tests/test_serve_engine.py``, ``test_serve_refill.py``,
``test_serve_packed.py``, ``test_prefill_pipeline.py``,
``test_fleet.py``).

The oracle is the port's own engine (its model is held against JAX in
``test_torch_recurrent.py``), so no JAX engine runs here. The wave has
ragged prompts in buckets 8, 16 and 32, one longer than the window (its
prefill wraps the rolling buffer) and some whose decode runs past it.

* The paper's property: a fail-stop of any one group on every step gives
  the healthy tokens bit for bit, at every ``ft_scope`` (the scope x
  failed-group matrix) and in every admission mode.
* The reference's equalities: chunked, boundary and packed admission ==
  whole bucket, batched == per-slot, a recycled slot == a fresh engine
  (a stale conv tail or state h would corrupt it), and a position gets
  the same bits from prefill and from decode (which the fleet's prefix
  resume needs): the fleet killed mid-decode ends with the healthy single
  engine's tokens.
* The census covers every protected site of the new blocks, and the
  compiled plans never miss.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import get_model as jget_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.ft.plans import prepare_params
from repro_torch.serve import (Fleet, FleetConfig, PerSlotEngine, Request,
                               ServeConfig, ServeEngine)

MAMBA, RG = "falcon-mamba-7b", "recurrentgemma-2b"
ARCHS = (MAMBA, RG)
LENGTHS = [5, 6, 12, 3, 20, 9]
MAX_NEW = [4, 8, 3, 6, 9, 5]
BASE = dict(max_batch=4, max_seq=48, prefill_buckets=(8, 16, 32))
MODES = {"whole": {}, "chunked": dict(prefill_chunk=8),
         "boundary": dict(prefill_chunk=8, refill=False),
         "packed": dict(prefill_chunk=8, token_budget=16)}
SCOPES = ("head", "qkv", "mlp", "out", "all")
# the protected sites each family adds (beside the head and the MLP's)
NEW_SITES = {MAMBA: {"qkv.in", "out.o"},
             RG: {"qkv.gate", "qkv.in", "out.o", "qkv.q", "qkv.k", "qkv.v"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the scans are thousands of tiny ops, which
    thread handoffs only slow down (the more so beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jget_smoke(arch)
    jp = jget_model(cfg).init(jax.random.PRNGKey(0), cfg, max_seq=48)
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(vocab, lengths=LENGTHS, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _scfg(mode="whole", scope="none"):
    ft = dict(ft_mode="none") if scope == "none" else dict(
        ft_mode="entangle", ft_M=4, ft_scope=scope)
    return ServeConfig(**BASE, **MODES[mode], **ft)


def _wave(arch, mode="whole", scope="none", failed_group=None, warm=None,
          max_new=MAX_NEW):
    """Serve the wave; returns (tokens by rid, engine). ``warm``: a healthy
    engine's startup products (its census, plans and int8 weights)."""
    cfg = get_smoke_config(arch)
    eng = ServeEngine(cfg, _scfg(mode, scope), _params(arch), device="cpu",
                      warm=warm)
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=max_new[r]))
    done = eng.run_to_completion(failed_group=failed_group)
    out = {r.rid: np.asarray(r.out) for r in done}
    assert sorted(out) == list(range(len(LENGTHS)))
    for rid, o in out.items():
        assert len(o) == max_new[rid]
    return out, eng


@functools.lru_cache(maxsize=None)
def _healthy(arch, mode, scope):
    return _wave(arch, mode, scope)[0]


def _same(got, want, what):
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{what} rid={rid}")


@pytest.mark.parametrize("scope", SCOPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_scope_failed_group_matrix(arch, scope):
    """Every scope x every failed group: bit-identical to healthy, and no
    plan miss (the reference's test_ft_scope_failstop_bit_identical, at
    most 3 new tokens per request as there; the injected waves run on
    warm replicas of the healthy engine)."""
    short = [min(n, 3) for n in MAX_NEW]
    healthy, eng = _wave(arch, "whole", scope, max_new=short)
    warm = eng.warm_state()
    for fg in range(4):
        injected, eng = _wave(arch, "whole", scope, failed_group=fg,
                              warm=warm, max_new=short)
        _same(injected, healthy, f"{arch} scope={scope} failed_group={fg}")
        if eng.plans is not None:
            assert eng.plans.misses == 0


@pytest.mark.parametrize("mode", ["chunked", "boundary", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_admission_modes_roll_forward_and_agree(arch, mode):
    """Each admission mode at scope all: failed_group=1 gives its healthy
    tokens, and the healthy tokens equal whole-bucket admission's (and at
    ft none too)."""
    healthy = _healthy(arch, mode, "all")
    injected, eng = _wave(arch, mode, "all", failed_group=1)
    assert eng.plans.misses == 0
    _same(injected, healthy, f"{arch} {mode} failed_group=1")
    if mode == "chunked":
        assert eng.metrics["refill_admissions"] > 0
    if mode == "packed":
        assert eng.metrics["packed_batches_peak"] >= 2
    for scope in ("none", "all"):
        _same(_healthy(arch, mode, scope), _healthy(arch, "whole", scope),
              f"{arch} {mode} vs whole, scope {scope}")


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_equals_per_slot(arch):
    """The batched engine's tokens equal the per-slot baseline's (a batch-1
    whole-prompt prefill and batch-1 decode per request), with fewer
    decode calls."""
    per = PerSlotEngine(get_smoke_config(arch), _scfg(), _params(arch),
                        device="cpu")
    for r, p in enumerate(_prompts(per.cfg.vocab_size)):
        per.submit(Request(rid=r, prompt=p, max_new=MAX_NEW[r]))
    ref = {r.rid: np.asarray(r.out) for r in per.run_to_completion()}
    out, eng = _wave(arch)
    _same(out, ref, f"{arch} batched vs per-slot")
    assert eng.decode_calls < per.decode_calls


@pytest.mark.parametrize("arch", ARCHS)
def test_recycled_slot_is_pristine(arch):
    """One slot serves two requests, then the probe: the probe's tokens
    equal a fresh engine's (the recycled row's conv tail, state h and
    rolling buffer were zeroed)."""
    cfg = get_smoke_config(arch)
    scfg = ServeConfig(max_batch=1, max_seq=48, prefill_buckets=(8, 16, 32))
    probe, *others = _prompts(cfg.vocab_size, (7, 20, 11), seed=5)

    def run(prompts):
        eng = ServeEngine(cfg, scfg, _params(arch), device="cpu")
        hs = [eng.submit(Request(rid=i, prompt=p, max_new=6))
              for i, p in enumerate(prompts)]
        eng.run_to_completion()
        return np.asarray(hs[-1].req.out)

    np.testing.assert_array_equal(run(others + [probe]), run([probe]))


@pytest.mark.parametrize("arch", ARCHS)
def test_census_covers_every_new_site(arch):
    """At scope all the startup census of every admission mode names every
    protected site of the family (its plans are held to ``misses == 0``
    by the waves above), and ``prepare_params`` gives each of their
    weights an int8 copy and none to the unprotected projections."""
    cfg = get_smoke_config(arch)
    for mode in MODES:
        eng = ServeEngine(cfg, _scfg(mode, "all"), _params(arch),
                          device="cpu")
        sites = {site for site, _ in eng.protected_census}
        mlp = set() if arch == MAMBA else {"mlp.gate", "mlp.up", "mlp.down"}
        assert NEW_SITES[arch] | mlp <= sites, (mode, sites)
    prepped = prepare_params(_params(arch), scope="all")
    for unit in prepped["stack"]:
        for blk in unit:
            mixer = blk.get("rec", blk.get("attn", blk))
            keys = [k for k in ("in_proj", "out_proj", "in_x", "in_gate",
                                "out", "wq", "wk", "wv", "wo") if k in mixer]
            assert keys
            for k in keys:
                assert mixer[k]["q8"]["w"].dtype == torch.int32
            for k in ("x_proj", "dt_proj", "w_a", "w_i"):  # unprotected
                assert k not in mixer or "q8" not in mixer[k]


@pytest.mark.parametrize("mode", ["whole", "chunked", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_give_a_position_the_same_bits(arch, mode):
    """The position after ``prompt + k`` generated tokens gets the same
    final hidden state and logits, bit for bit, when the engine decodes it
    and when it prefills ``prompt + prefix`` (the fleet's prefix resume);
    the decode runs past the window of 16."""
    cfg = get_smoke_config(arch)
    scfg = _scfg(mode, "all")
    prompt = _prompts(cfg.vocab_size, (9,), seed=3)[0]

    class Rec(ServeEngine):
        def _head_logits(self, h, mask, failed_group, ft_fn):
            logits = super()._head_logits(h, mask, failed_group, ft_fn)
            self.log.append((h[0].clone(), logits[0].clone()))
            return logits

    def run(p, max_new):
        eng = Rec(cfg, scfg, _params(arch), device="cpu")
        eng.log = []
        h = eng.submit(Request(rid=0, prompt=p, max_new=max_new))
        eng.run_to_completion()
        return np.asarray(h.req.out), eng.log

    out, log = run(prompt, 14)
    for k in (1, 9):
        tail, log_k = run(np.concatenate([prompt, out[:k]]), 14 - k)
        for a, b in zip(log[k], log_k[0]):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
        np.testing.assert_array_equal(tail, out[k:])


def test_fleet_kill_mid_decode_completes_bit_identical():
    """falcon-mamba on 4 replicas at entangle / head, replica 2 killed
    mid-decode: every request ends with the healthy single engine's
    tokens."""
    cfg = get_smoke_config(MAMBA)
    scfg = ServeConfig(max_batch=4, max_seq=48, prefill_buckets=(8, 16),
                       prefill_chunk=8, ft_mode="entangle", ft_scope="head")
    prompts = _prompts(cfg.vocab_size, (4, 9, 12, 5, 15, 3, 15, 6), seed=23)
    eng = ServeEngine(cfg, scfg, _params(MAMBA), device="cpu")
    hs = [eng.submit(Request(rid=i, prompt=p, max_new=10))
          for i, p in enumerate(prompts)]
    eng.run_to_completion(max_steps=500)
    want = [np.asarray(h.req.out) for h in hs]

    fleet = Fleet(cfg, scfg, _params(MAMBA), FleetConfig(device="cpu",
                                                         replicas=4))
    hs = [fleet.submit(Request(rid=i, prompt=p, max_new=10))
          for i, p in enumerate(prompts)]
    for _ in range(6):
        fleet.step()
    assert any(h.status == "decoding" for h in hs)
    fleet.kill_replica(2)
    fleet.run_to_completion(max_steps=500)
    m = fleet.fleet_metrics()
    assert m["failed"] == 1 and m["router_migrated"] >= 1
    for h, w in zip(hs, want):
        assert h.status == "done"
        np.testing.assert_array_equal(np.asarray(h.req.out), w)
