"""The rest of the serving engine on the CPU: chunked prefill, mid-flight
refill, boundary admission, token-packed admission, request handles and
cancel, warm replicas and the per-slot baseline, for the llama3.2-1b and
deepseek-v2-lite smoke configs on params bridged from the reference.

The wave is the reference's own refill / packing wave
(``tests/test_serve_refill.py``, ``tests/test_serve_packed.py``): six
ragged prompts in buckets 8 and 16, chunks of 8, staggered ``max_new``,
four slots, so slots free mid-flight, refill plans a batch while another
is mid-chunk, and the packed program co-packs rows of two batches.

* Against the reference: the port's chunked, boundary and packed engines
  and the reference's engine at the same ``ServeConfig`` record every head
  projection (landing heads and decode steps, in program order) with its
  row mask. The port is teacher-forced along the reference's tokens, so
  both run the same schedule (asserted: equal shape census); on every live
  row the logits agree within ``LOGIT_TOL`` of the largest |logit|, and
  the port's own greedy token equals the reference's but at a near-tie in
  BOTH packages (the rule of ``test_torch_serve.py``).
* Inside the port, exact: every ``failed_group`` gives the healthy tokens
  bit for bit in every admission mode at scopes head and all, and the
  admission modes give each other's tokens (the reference's own
  equalities: packed == chunked, refill == boundary, chunked == whole
  bucket, batched == per-slot). Observed on these configs: every pair
  equal bit for bit, so no pair needed the near-tie rule; deepseek's
  packed wave differs at the published expert capacity, by design (see
  ``test_admission_modes_give_the_same_tokens``).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.ft import quantize as tquant
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import entangled_matmul_grouped as emmg
from repro_torch.models import layers as TL
from repro_torch.serve import (DeadlineExceeded, PerSlotEngine, Request,
                               ServeConfig, ServeEngine)
from repro_torch.serve import engine as tengine

LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v2-lite-16b"
LENGTHS = [5, 6, 12, 3, 4, 6]
MAX_NEW = [1, 2, 3, 2, 1, 2]
BASE = dict(max_batch=4, max_seq=48, prefill_buckets=(8, 16))
MODES = {"whole": {}, "chunked": dict(prefill_chunk=8),
         "boundary": dict(prefill_chunk=8, refill=False),
         "packed": dict(prefill_chunk=8, token_budget=16)}
# per arch: the scope the reference comparison runs at (deepseek's router
# stays a float GEMM at 'moe', so routing near-ties of the int8 router,
# which test_torch_serve_moe.py measures, stay out), and its modes
REF_RUNS = {LLAMA: ("all", ("chunked", "boundary", "packed")),
            DEEPSEEK: ("moe", ("chunked", "packed"))}
# as in test_torch_serve.py: bf16 hidden states a few ulps apart may rank
# two logits differently; logits agree within a few percent
NEAR_TIE = 2.0 ** -6
LOGIT_TOL = 2.0 ** -5
# as in test_torch_serve_moe.py: gate probabilities of the k-th and
# (k+1)-th expert closer than this count as tied, and the two packages may
# then route the token differently
ROUTER_TIE = 2.0 ** -9


def _scfg(mode, scope, **kw):
    ft = ({} if scope == "none" else
          dict(ft_mode="entangle", ft_M=4, ft_scope=scope))
    return {**BASE, **MODES[mode], **ft, **kw}


def _prompts(vocab, lengths=LENGTHS):
    rng = np.random.default_rng(31)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


class _JRecording(JServeEngine):
    """The reference engine, keeping every head projection's logits and
    row mask in program order."""

    def _head_logits(self, params, h, mask, head, failed_group, ft_fn):
        logits = super()._head_logits(params, h, mask, head, failed_group,
                                      ft_fn)
        jax.debug.callback(lambda x, m: self.log.append(
            (np.asarray(x), np.asarray(m))), logits, mask, ordered=True)
        return logits


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """The reference's params (bridged) and its recorded runs, built once
    per arch and shared by every case."""
    cfg = get_smoke_config(arch)
    params = jax.jit(functools.partial(get_model(cfg).init, cfg=cfg,
                                       max_seq=48))(jax.random.PRNGKey(0))
    scope, modes = REF_RUNS[arch]
    runs = {}
    for mode in modes:
        eng = _JRecording(cfg, JServeConfig(**_scfg(mode, scope)), params)
        eng.log = []
        for r, p in enumerate(_prompts(cfg.vocab_size)):
            eng.submit(JRequest(rid=r, prompt=p, max_new=MAX_NEW[r]))
        done = eng.run_to_completion(max_steps=500)
        jax.effects_barrier()
        runs[mode] = ({r.rid: np.asarray(r.out) for r in done}, eng.log,
                      eng.census, set(eng.protected_census), dict(eng.metrics))
    return params_from_numpy(jax.tree.map(np.asarray, params),
                             device="cpu"), runs


class _Forced(ServeEngine):
    """Keeps every head projection's logits, mask and the request id of
    each row, takes the reference's token of that projection on every row,
    and collects the ids of requests a token of which met a router near-
    tie (``router_ties``; MoE only)."""

    _rows = None  # request id of each row of the running prefill program

    def _advance_prefill(self, p, failed_group):
        self._rows = [r and r.rid for _, r in p["reqs"]]
        self._rows += [None] * (self.Bp - len(self._rows))
        try:
            super()._advance_prefill(p, failed_group)
        finally:
            self._rows = None

    def _prefill_packed(self, tok, sids, pos0r, lens, n, failed_group):
        slot_rid = {i: r.rid for p in self._inflight for i, r in p["reqs"]
                    if r is not None}
        self._rows = [slot_rid[int(i)] for i in sids[:n]]
        self._rows += [None] * (self.Rp - n)
        try:
            super()._prefill_packed(tok, sids, pos0r, lens, n, failed_group)
        finally:
            self._rows = None

    def _row_rids(self, rows: int) -> list:
        """Request id of each row (token) of the running program."""
        if self._rows is None:  # decode: row i is slot i
            return [s and s["req"].rid for s in self.slots]
        per = rows // len(self._rows)
        return [self._rows[i // per] for i in range(rows)]

    def note_router(self, probs: torch.Tensor, k: int) -> None:
        s = torch.sort(probs, dim=-1, descending=True).values
        tied = (s[:, k - 1] - s[:, k] <= ROUTER_TIE).tolist()
        self.router_ties.update(
            rid for rid, t in zip(self._row_rids(len(tied)), tied)
            if t and rid is not None)

    def _land(self, p, failed_group, src, src_rows):
        self._rows = [r and r.rid for _, r in p["reqs"]]
        self._rows += [None] * (self.Bp - len(self._rows))
        try:
            super()._land(p, failed_group, src, src_rows)
        finally:
            self._rows = None

    def _head_logits(self, h, mask, failed_group, ft_fn):
        logits = super()._head_logits(h, mask, failed_group, ft_fn)
        jl, _ = self.jlog[len(self.log)]
        self.log.append((logits.clone().numpy(), mask.numpy(),
                         self._row_rids(len(jl))))
        forced = torch.full_like(logits, float("-inf"))
        forced[torch.arange(len(jl)), torch.as_tensor(jl.argmax(-1))] = 0.0
        return forced


def _dropless(cfg):
    """The config with a capacity factor no routing can fill: no token is
    dropped from its experts."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1e3))


def _wave(arch, mode, scope, failed_group=None, cls=ServeEngine,
          lengths=LENGTHS, max_new=MAX_NEW, dropless=False, **kw):
    params, _ = _ref(arch)
    cfg = tget_smoke(arch)
    if dropless:
        cfg = _dropless(cfg)
    eng = cls(cfg, ServeConfig(**_scfg(mode, scope, **kw)), params,
              device="cpu")
    for r, p in enumerate(_prompts(cfg.vocab_size, lengths)):
        eng.submit(Request(rid=r, prompt=p, max_new=max_new[r]))
    done = eng.run_to_completion(max_steps=500, failed_group=failed_group)
    return {r.rid: np.asarray(r.out) for r in done}, eng


@functools.lru_cache(maxsize=None)
def _healthy(arch, mode, scope, dropless=False):
    """The healthy wave of ``_wave`` (tokens, engine), served once per
    module and shared by every test that reads it."""
    return _wave(arch, mode, scope, dropless=dropless)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gap(row, tok):
    """How far ``tok``'s logit trails the row's top logit, relative."""
    top = float(row.max())
    return (top - float(row[tok])) / abs(top)


@pytest.mark.parametrize("arch,mode", [(a, m) for a in REF_RUNS
                                       for m in REF_RUNS[a][1]])
def test_engine_matches_reference(arch, mode, monkeypatch):
    """Teacher-forced along the reference's tokens, every live row's
    logits agree within LOGIT_TOL, except (MoE) on a request one token of
    which the port's router saw at a near-tie (ROUTER_TIE), where the two
    packages may route differently: at most 2 such rows per wave, as in
    test_torch_serve_moe.py. Observed: llama within 0.79% everywhere;
    deepseek 3.59% (chunked) and 3.62% (packed) on one row each, of a
    request whose router saw a near-tie, otherwise within 2.52%."""
    scope = REF_RUNS[arch][0]
    _, runs = _ref(arch)
    want, jlog, jcensus, census_keys, jmetrics = runs[mode]
    assert sorted(want) == list(range(len(LENGTHS)))
    cls = type("_F", (_Forced,), {})
    cls.jlog = jlog
    params, _ = _ref(arch)
    cfg = tget_smoke(arch)
    eng = cls(cfg, ServeConfig(**_scfg(mode, scope)), params, device="cpu")
    eng.log, eng.router_ties = [], set()
    top_k = TL._top_k

    def recording(probs, k):
        if probs.device.type == "cpu":  # not the startup census on meta
            eng.note_router(probs, k)
        return top_k(probs, k)

    monkeypatch.setattr(TL, "_top_k", recording)
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW[r]))
    got = {r.rid: np.asarray(r.out)
           for r in eng.run_to_completion(max_steps=500)}
    # teacher-forced: the same schedule, so the same tokens and census
    assert {k: v.tolist() for k, v in got.items()} == \
        {k: v.tolist() for k, v in want.items()}
    assert eng.census == jcensus
    assert set(eng.protected_census) == census_keys
    for key in ("refill_admissions", "landings", "packed_tokens",
                "packed_calls", "packed_batches_peak"):
        assert eng.metrics[key] == jmetrics[key], key
    assert len(eng.log) == len(jlog)
    scale = max(np.abs(jl[jm]).max() for jl, jm in jlog)
    ties, routed = [], []
    for t, ((pl, pm, rids), (jl, jm)) in enumerate(zip(eng.log, jlog)):
        np.testing.assert_array_equal(pm, jm)
        err = np.abs(pl - jl).max(-1) / scale
        for row in np.nonzero(pm & (err > LOGIT_TOL))[0]:
            assert rids[row] in eng.router_ties, (
                f"head call {t} row {row} (request {rids[row]}): logits "
                f"differ by {err[row]:.4f} of the largest |logit| with no "
                f"router near-tie (router ties: {eng.router_ties})")
            routed.append((t, int(row)))
        for row in np.nonzero(pm)[0]:
            own, ref = int(pl[row].argmax()), int(jl[row].argmax())
            if own != ref:
                gp, gj = _gap(pl[row], ref), _gap(jl[row], own)
                assert gp <= NEAR_TIE and gj <= NEAR_TIE, (
                    f"head call {t} row {row}: port {own}, reference {ref}; "
                    f"gaps {gp:.4f} / {gj:.4f}")
                ties.append((t, int(row)))
    assert len(ties) <= 2, ties
    assert len(routed) <= 2, routed
    if scope != "none":
        assert eng.plans.misses == 0


@pytest.mark.parametrize("arch,mode,scope", [
    (LLAMA, m, s) for m in MODES for s in ("head", "all")] + [
    (DEEPSEEK, m, "all") for m in ("chunked", "packed")])
def test_failed_group_rolls_forward_exactly(arch, mode, scope):
    """The paper's property in every admission mode: a fail-stop of any
    one group on every step gives the healthy tokens bit for bit."""
    healthy, eng = _healthy(arch, mode, scope)
    assert sorted(healthy) == list(range(len(LENGTHS)))
    if mode == "chunked":
        assert eng.metrics["refill_admissions"] > 0
    if mode == "packed":
        assert eng.metrics["packed_batches_peak"] >= 2
    for r in range(4):
        injected, eng = _wave(arch, mode, scope, failed_group=r)
        for rid in healthy:
            np.testing.assert_array_equal(
                injected[rid], healthy[rid],
                err_msg=f"{arch} {mode} scope={scope} failed_group={r} "
                        f"rid={rid}")
        if eng.plans is not None:
            assert eng.plans.misses == 0
    # CPU tensors never reach a CUDA kernel
    assert emm.launches_s8 == emm.launches_cuda_core == 0
    assert emmg.launches_s8 == emmg.launches_cuda_core == 0


@pytest.mark.parametrize("arch,scope", [(LLAMA, "none"), (LLAMA, "head"),
                                        (LLAMA, "all"), (DEEPSEEK, "none"),
                                        (DEEPSEEK, "all")])
def test_admission_modes_give_the_same_tokens(arch, scope):
    """The reference's own equalities, inside the port: chunked == whole
    bucket, refill == boundary, packed == chunked, token for token.

    The MoE's expert capacity is a function of a program's token count
    (``layers._moe_capacity``), so a packed [2, 8] program drops other
    tokens than a [4, 8] chunk of the same wave (the reference asserts
    packed == chunked for dense, SSM and hybrid models only). deepseek's
    packed wave is therefore held to the others with a capacity no routing
    fills; at the published capacity factor it gives other tokens."""
    toks = {m: _healthy(arch, m, scope)[0] for m in MODES}
    pairs = [(m, toks[m], toks["whole"]) for m in ("chunked", "boundary")]
    if arch == DEEPSEEK:
        pairs.append(("packed (dropless)",
                      _healthy(arch, "packed", scope, dropless=True)[0],
                      _healthy(arch, "whole", scope, dropless=True)[0]))
    else:
        pairs.append(("packed", toks["packed"], toks["whole"]))
    for name, got, want in pairs:
        for rid in want:
            np.testing.assert_array_equal(
                got[rid], want[rid],
                err_msg=f"{arch} scope={scope} {name} vs whole rid={rid}")


def test_per_slot_engine_matches_batched():
    """The unprotected per-slot baseline (one batch-1 prefill per request,
    one batch-1 decode per slot) gives the batched engine's tokens, with
    more decode calls."""
    cfg = tget_smoke(LLAMA)
    params, _ = _ref(LLAMA)
    per = PerSlotEngine(cfg, ServeConfig(**BASE), params, device="cpu")
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        per.submit(Request(rid=r, prompt=p, max_new=MAX_NEW[r] + 2))
    ref = {r.rid: r.out for r in per.run_to_completion()}
    out, eng = _wave(LLAMA, "whole", "none",
                     max_new=[n + 2 for n in MAX_NEW])
    assert sorted(ref) == sorted(out)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])
    assert eng.decode_calls < per.decode_calls
    with pytest.raises(ValueError, match="unprotected baseline"):
        PerSlotEngine(cfg, ServeConfig(**BASE, ft_mode="entangle"), params,
                      device="cpu")


def test_packed_one_program_shape_no_misses():
    """Whatever the packing mix, one [Rp, Cp] prefill program: one census
    entry, no plan misses, and no new registry entry after a second wave
    of another mix."""
    out, eng = _healthy(LLAMA, "packed", "all")
    assert set(eng.census["prefill"]) == {(2, 8)}
    assert eng.plans.misses == 0
    assert eng.metrics["packed_tokens"] == sum(LENGTHS)
    assert eng.prefill_calls == eng.metrics["packed_calls"] > 0
    n_entries = len(eng.registry.census())
    _, eng2 = _wave(LLAMA, "packed", "all", lengths=[3, 9, 15, 2, 8, 12],
                    max_new=[2, 1, 2, 3, 1, 2])
    assert set(eng2.census["prefill"]) == {(2, 8)}
    assert eng2.plans.misses == 0
    assert len(eng2.registry.census()) == n_entries
    # a budget of one row per step, smaller than every bucket
    one, eng3 = _wave(LLAMA, "packed", "all", token_budget=8)
    assert set(eng3.census["prefill"]) == {(1, 8)}
    for rid in out:
        np.testing.assert_array_equal(one[rid], out[rid])


def test_refill_reuses_the_census_chunk_widths():
    """A refill wave replays the startup census's chunk programs: no plan
    misses and no new registry entries."""
    out, eng = _healthy(LLAMA, "chunked", "all")
    n_entries = len(eng.registry.census())
    assert eng.metrics["refill_admissions"] > 0 and eng.plans.misses == 0
    assert eng._chunk_widths == frozenset({8})
    _, eng2 = _wave(LLAMA, "chunked", "all", lengths=[16, 1, 9, 3, 7, 14])
    assert eng2.plans.misses == 0
    assert len(eng2.registry.census()) == n_entries


def _engine(mode="chunked", **kw):
    cfg = tget_smoke(LLAMA)
    params, _ = _ref(LLAMA)
    return cfg, ServeEngine(cfg, ServeConfig(**dict(
        BASE, prefill_buckets=(8, 16, 32), **MODES[mode], **kw)), params,
        device="cpu")


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_cancel_in_every_state(mode):
    """cancel() queued: the request leaves the queue; mid-prefill: the row
    never lands and its slot frees at once (packed: it packs nothing
    more); decoding: the partial output stays and the slot recycles.
    Terminal states are left as they are."""
    cfg, eng = _engine(mode, max_batch=2)
    p = _prompts(cfg.vocab_size, [5, 30, 6, 5])
    hq = eng.submit(Request(rid=0, prompt=p[0], max_new=4))
    hq.cancel()
    assert hq.status == "cancelled" and not eng.queue and list(hq) == []
    hp = eng.submit(Request(rid=1, prompt=p[1], max_new=4))
    eng.step()  # bucket 32 in chunks of 8: still mid-prefill
    assert hp.status == "prefill" and eng._inflight
    packed_before = eng.metrics["packed_tokens"]
    hp.cancel()
    assert hp.status == "cancelled" and not eng._reserved
    hd = eng.submit(Request(rid=2, prompt=p[2], max_new=5))
    done = eng.run_to_completion(max_steps=100)
    assert [r.rid for r in done] == [2] and len(hd.req.out) == 5
    assert eng.idle() and not eng._reserved
    if mode == "packed":  # the cancelled row packed nothing more
        assert eng.metrics["packed_tokens"] == packed_before + 6
    hx = eng.submit(Request(rid=3, prompt=p[3], max_new=16))
    eng.step()
    eng.step()
    assert hx.status == "decoding"
    hx.cancel()
    assert hx.status == "cancelled" and 1 <= len(hx.req.out) < 16
    assert all(s is None for s in eng.slots)
    assert eng.metrics["cancelled"] == 3
    hx.cancel()
    assert eng.metrics["cancelled"] == 3


def test_handles_stream_shed_and_order_by_deadline():
    """Iterating a handle drives the engine and yields exactly the
    request's tokens; a queued request past its deadline is shed before
    any prefill and its handle raises DeadlineExceeded; one slot admits
    the tightest deadline first."""
    now = [0.0]
    cfg, eng = _engine(max_batch=1, clock=lambda: now[0])
    p = _prompts(cfg.vocab_size, [5, 5, 5, 7])
    busy = eng.submit(Request(rid=0, prompt=p[0], max_new=6,
                              deadline_ms=50.0))
    eng.step()  # admitted: its deadline no longer applies
    hs = eng.submit(Request(rid=1, prompt=p[1], max_new=4,
                            deadline_ms=10.0))
    now[0] = 1.0
    pre = eng.prefill_calls
    eng.step()
    assert hs.status == "shed" and eng.prefill_calls == pre
    assert eng.metrics["shed"] == 1
    with pytest.raises(DeadlineExceeded, match="rid=1"):
        list(hs)
    streamed = list(busy)
    assert busy.done and streamed == busy.req.out.tolist()
    assert len(streamed) == 6 and busy.result() is busy.req
    assert len(busy.req.tok_times) == 6 and busy.req.t_first is not None
    for rid, dl in ((2, None), (3, 1e6), (4, 1e3)):
        eng.submit(Request(rid=rid, prompt=p[2], max_new=1,
                           deadline_ms=dl))
    done = eng.run_to_completion(max_steps=100)
    assert [r.rid for r in done[-3:]] == [4, 3, 2]


def test_recycled_rows_ride_the_landing_copy():
    """A freed slot's cache row is zeroed in the next landing's row copy
    when the landing has it to spare, else in one batched fill before the
    decode: never one fill per finished request."""
    cfg, eng = _engine("whole", max_batch=4)
    p = _prompts(cfg.vocab_size, [5, 6, 4])
    for r in range(2):
        eng.submit(Request(rid=r, prompt=p[r], max_new=2))
    eng.step()  # lands both (one copy), decodes them to max_new: recycled
    assert eng.scatter_calls == 1 and eng.metrics["recycled"] == 2
    eng.submit(Request(rid=2, prompt=p[2], max_new=2))
    eng.step()  # lands on one freed slot; the other is zeroed in its copy
    assert eng.scatter_calls == 2 and eng.metrics["merged_zero_rows"] == 1
    assert eng.metrics["zero_flushes"] == 0
    eng.run_to_completion(max_steps=20)
    assert eng.metrics["zero_flushes"] == 1
    # the last request's slot is zero again once the engine has drained
    # (a free slot's row 0 takes the decode's write of an inactive row)
    assert all(float(t[:, 0].abs().sum()) == 0
               for unit in eng.cache for blk in unit for t in blk.values())


def test_chunked_admission_interleaves_with_decode():
    """While a long prompt prefills chunk by chunk, the active slot
    decodes every step."""
    cfg, eng = _engine(max_batch=2)
    p = _prompts(cfg.vocab_size, [5, 30])
    eng.submit(Request(rid=0, prompt=p[0], max_new=12))
    eng.step()
    assert eng.slots[0] is not None and eng.decode_calls == 1
    eng.submit(Request(rid=1, prompt=p[1], max_new=5))
    for s in range(4):  # bucket 32 in chunks of 8
        before = len(eng.slots[0]["toks"])
        eng.step()
        assert len(eng.slots[0]["toks"]) == before + 1
        landed = any(x is not None and x["req"].rid == 1 for x in eng.slots)
        assert landed == (s == 3)
    assert eng.prefill_calls == 1 + 4


def test_geometry_errors_at_construction():
    cfg = tget_smoke(LLAMA)
    params, _ = _ref(LLAMA)

    def mk(**kw):
        ServeEngine(cfg, ServeConfig(max_batch=4, max_seq=48, **kw), params,
                    device="cpu")

    with pytest.raises(ValueError, match="token_budget"):
        mk(token_budget=-8, prefill_chunk=8)
    with pytest.raises(ValueError, match="prefill_chunk must be >= 0"):
        mk(prefill_chunk=-1)
    with pytest.raises(ValueError, match="prefill_chunk > 0"):
        mk(token_budget=16)
    with pytest.raises(ValueError, match="multiple"):
        mk(token_budget=12, prefill_chunk=8)
    with pytest.raises(ValueError, match="max_batch"):
        mk(token_budget=64, prefill_chunk=8)
    with pytest.raises(ValueError, match="max_prefill_per_step"):
        mk(prefill_chunk=8, max_prefill_per_step=0)


def test_warm_replica_reuses_startup_products(monkeypatch):
    """A replica built from warm_state() shares the census, the compiled
    plans (and their misses counter) and the quantized params, runs no
    census, no plan compile and no weight quantization, and serves the
    same tokens; a replica of another config is refused."""
    cfg = tget_smoke(DEEPSEEK)
    params, _ = _ref(DEEPSEEK)
    scfg = ServeConfig(**_scfg("packed", "all"))
    first = ServeEngine(cfg, scfg, params, device="cpu")
    warm = first.warm_state()

    def refuse(*a, **k):
        raise AssertionError("a warm replica redid startup work")

    for mod, name in ((tquant, "quantize_weight"),
                      (tquant, "quantize_weight_stacked"),
                      (tengine, "quantize_head"), (tengine, "compile_plans"),
                      (tengine, "prepare_params")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(ServeEngine, "_protected_shape_census", refuse)
    clone = ServeEngine(cfg, ServeConfig(**_scfg("packed", "all"),
                                         clock=lambda: 0.0), params,
                        device="cpu", warm=warm)
    assert clone.plans is first.plans and clone.ft_params is first.ft_params
    assert clone.protected_census is first.protected_census
    assert clone.head_q is first.head_q
    monkeypatch.undo()
    a, b = {}, {}
    for eng, out in ((first, a), (clone, b)):
        for r, p in enumerate(_prompts(cfg.vocab_size)):
            eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW[r]))
        out.update({r.rid: r.out.tolist()
                    for r in eng.run_to_completion(max_steps=500)})
    assert a == b and first.plans.misses == 0
    with pytest.raises(ValueError, match="differently configured"):
        ServeEngine(cfg, ServeConfig(**_scfg("chunked", "all")), params,
                    device="cpu", warm=warm)
