"""Admission batches of ``ServeConfig.prefill_batch`` rows on the CPU,
against the reference's engine at the same config.

The wave is tests/test_torch_serve_admission.py's (six ragged prompts in
buckets 8 and 16, four slots), served by llama3.2-1b's smoke config at
scope all with ``prefill_batch`` (``Bp``) 3 and 1, so that an admission
batch has fewer rows than the slot pool, and at 3 a number of rows that
M = 4 does not divide: the landing head and every protected site of a
prefill program pad it to whole groups with zero rows.

Teacher-forced along the reference's tokens, the port runs the same
schedule (equal census, ``(Bp, bucket)`` keys, and equal protected-shape
census), and every live row's logits agree within ``LOGIT_TOL`` under the
near-tie rule of test_torch_serve_admission.py. The exact checks inside
the port are tests/test_torch_prefill_batch_exact.py's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_serve_admission import (LENGTHS, LLAMA, LOGIT_TOL, MAX_NEW,
                                        NEAR_TIE, _Forced, _gap, _JRecording,
                                        _prompts, _scfg)

# (mode, Bp) of the reference runs
REF_RUNS = (("whole", 3), ("chunked", 1))
SCOPE = "all"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's params (bridged) and its recorded runs of REF_RUNS,
    built once."""
    cfg = get_smoke_config(LLAMA)
    params = jax.jit(functools.partial(get_model(cfg).init, cfg=cfg,
                                       max_seq=48))(jax.random.PRNGKey(0))
    runs = {}
    for mode, bp in REF_RUNS:
        eng = _JRecording(cfg, JServeConfig(**_scfg(
            mode, SCOPE, prefill_batch=bp)), params)
        eng.log = []
        for r, p in enumerate(_prompts(cfg.vocab_size)):
            eng.submit(JRequest(rid=r, prompt=p, max_new=MAX_NEW[r]))
        done = eng.run_to_completion(max_steps=500)
        jax.effects_barrier()
        runs[(mode, bp)] = ({r.rid: np.asarray(r.out) for r in done},
                            eng.log, eng.census, set(eng.protected_census),
                            dict(eng.metrics))
    return params_from_numpy(jax.tree.map(np.asarray, params),
                             device="cpu"), runs


@pytest.mark.parametrize("mode,bp", REF_RUNS)
def test_prefill_batch_matches_reference(mode, bp):
    """Teacher-forced along the reference's tokens: the same census (each
    prefill program ``(Bp, bucket)``), protected-shape census and
    admission metrics, and every live row's logits within LOGIT_TOL, the
    port's own greedy token the reference's but at a near-tie in both."""
    params, runs = _ref()
    want, jlog, jcensus, census_keys, jmetrics = runs[(mode, bp)]
    assert sorted(want) == list(range(len(LENGTHS)))
    cls = type("_F", (_Forced,), {})
    cls.jlog = jlog
    eng = cls(tget_smoke(LLAMA), ServeConfig(**_scfg(
        mode, SCOPE, prefill_batch=bp)), params, device="cpu")
    eng.log, eng.router_ties = [], set()
    for r, p in enumerate(_prompts(eng.cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW[r]))
    got = {r.rid: r.out.tolist()
           for r in eng.run_to_completion(max_steps=500)}
    assert got == {k: v.tolist() for k, v in want.items()}
    assert eng.census == jcensus
    assert {k[0] for k in eng.census["prefill"]} == {bp}
    assert set(eng.protected_census) == census_keys
    for key in ("refill_admissions", "landings", "merged_zero_rows"):
        assert eng.metrics[key] == jmetrics[key], key
    assert len(eng.log) == len(jlog)
    scale = max(np.abs(jl[jm]).max() for jl, jm in jlog)
    ties = []
    for t, ((pl, pm, _), (jl, jm)) in enumerate(zip(eng.log, jlog)):
        np.testing.assert_array_equal(pm, jm)
        err = np.abs(pl - jl).max(-1) / scale
        assert (err[pm] <= LOGIT_TOL).all(), (t, err[pm].max())
        for row in np.nonzero(pm)[0]:
            own, ref = int(pl[row].argmax()), int(jl[row].argmax())
            if own != ref:
                assert _gap(pl[row], ref) <= NEAR_TIE
                assert _gap(jl[row], own) <= NEAR_TIE
                ties.append((t, int(row)))
    assert len(ties) <= 2, ties
    assert eng.plans.misses == 0


def test_prefill_batch_out_of_range_is_refused():
    params, _ = _ref()
    cfg = tget_smoke(LLAMA)
    for bp in (5, -1):
        with pytest.raises(ValueError, match=r"must be in \[1, max_batch"):
            ServeEngine(cfg, ServeConfig(max_batch=4, max_seq=48,
                                         prefill_batch=bp), params,
                        device="cpu")
    assert ServeEngine(cfg, ServeConfig(max_batch=4, max_seq=48), params,
                       device="cpu").Bp == 4
