"""Admission batches of ``ServeConfig.prefill_batch`` rows inside the
port, on the CPU: the paper's property and the batch size's invariance.

The wave is tests/test_torch_serve_admission.py's (six ragged prompts in
buckets 8 and 16, four slots), served by llama3.2-1b's smoke config on
seeded params at scope all with ``prefill_batch`` (``Bp``) 1 and 3 (3
rows, which M = 4 does not divide: the landing head and every protected
site of a prefill program pad them to whole groups with zero rows). In
the whole-bucket, chunked and packed modes, every ``failed_group`` gives
the healthy tokens bit for bit, and every ``Bp`` gives the ``Bp =
max_batch`` tokens. The comparison with the reference's engine is
tests/test_torch_prefill_batch.py's.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_serve_admission import (LENGTHS, LLAMA, MAX_NEW, _prompts,
                                        _scfg)

PORT_MODES = ("whole", "chunked", "packed")
BPS = (1, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    cfg = get_smoke_config(LLAMA)
    return get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                               max_seq=48, device="cpu")


def _wave(mode, bp, failed_group=None):
    cfg = get_smoke_config(LLAMA)
    eng = ServeEngine(cfg, ServeConfig(**_scfg(mode, "all",
                                               prefill_batch=bp)),
                      _params(), device="cpu")
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW[r]))
    done = eng.run_to_completion(max_steps=500, failed_group=failed_group)
    return {r.rid: np.asarray(r.out) for r in done}, eng


@functools.lru_cache(maxsize=None)
def _healthy(mode, bp):
    return _wave(mode, bp)


@pytest.mark.parametrize("bp", BPS)
@pytest.mark.parametrize("mode", PORT_MODES)
def test_prefill_batch_rolls_forward_exactly(mode, bp):
    """A fail-stop of any one group on every step gives the healthy tokens
    bit for bit, at a batch of Bp rows (3: padded to whole groups)."""
    healthy, eng = _healthy(mode, bp)
    assert sorted(healthy) == list(range(len(LENGTHS)))
    for r in range(4):
        injected, eng = _wave(mode, bp, failed_group=r)
        for rid in healthy:
            np.testing.assert_array_equal(
                injected[rid], healthy[rid],
                err_msg=f"{mode} Bp={bp} failed_group={r} rid={rid}")
        assert eng.plans.misses == 0


@pytest.mark.parametrize("bp", BPS)
@pytest.mark.parametrize("mode", PORT_MODES)
def test_prefill_batch_gives_the_full_batch_tokens(mode, bp):
    """Every Bp gives the tokens of admission batches of max_batch rows;
    the census keys its prefill programs by Bp (packed: by its one
    ``[Rp, Cp]`` shape)."""
    got, eng = _healthy(mode, bp)
    want, _ = _healthy(mode, 0)
    assert {k: v.tolist() for k, v in got.items()} == \
        {k: v.tolist() for k, v in want.items()}
    keys = set(eng.census["prefill"])
    assert keys == ({(2, 8)} if mode == "packed"
                    else {(bp, 8), (bp, 16)}), keys
    assert eng.Bp == bp
