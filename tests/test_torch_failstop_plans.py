"""The fail-stop engine at other entanglement plans, and the checksum
functions along another stream axis, against the reference on the CPU.

``FTConfig(M, w, headroom_bits)`` picks the plan ``make_plan(M, w,
headroom_bits)`` as the reference's does: int32 temporaries at (4, 16, 0)
and (3, 16, 0) (l = 4 and 5), dual words at (4, 32, 0), (4, 32, 4) (l = 7)
and (8, 32, 0). At each, every op of ``OPS`` under every family and every
failed stream gives the reference's outputs and report bit for bit, and
every recovered run the healthy outputs (:func:`check_plan`). The M = 4
plans run in tests/test_torch_failstop.py, at its shapes (the reference's
eager ops compile once per shape); (4, 32, 0) is its default plan. Inputs
are made from a numpy seed and sized to the plan's output range (eq. 13):
16-bit plans take small streams and kernels. The numpy int64
disentanglement oracle and the container dtype are the reference's too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FTConfig as JFTConfig
from repro.core import OPS as JOPS
from repro.core import attach_checksum as jattach
from repro.core import container_dtype as jcontainer_dtype
from repro.core import disentangle_oracle_np as joracle
from repro.core import make_checksum_stream as jchecksum
from repro.core import recover_from_checksum as jrecover
from repro.core import run_protected as jrun
from repro_torch.core import (GARBAGE, OPS, FTConfig, attach_checksum,
                              container_dtype, disentangle_oracle_np,
                              entangle, make_checksum_stream,
                              recover_from_checksum, run_protected)

MODES = ("none", "entangle", "checksum", "mr")
# (M, w, headroom_bits): two int32-temporary plans, three dual-word plans
PLANS = ((4, 32, 0), (4, 16, 0), (4, 32, 4), (3, 16, 0), (8, 32, 0))
PLAN_IDS = ["M%d-w%d-h%d" % p for p in PLANS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(M, w, rng):
    """Streams of N = 257 samples (ragged) and each op's kernel, at the
    shapes of tests/test_torch_failstop.py, with values inside a w-bit
    plan's output range: 16 bits take words and taps in [-1, 1] (a dot
    product of 257 of them stays within M = 3's 480), 32 bits streams in
    [-50, 50) and taps in [-4, 4)."""
    N = 257
    lo, hi, k = (-1, 2, 1) if w == 16 else (-50, 50, 4)
    c = rng.integers(lo, hi, size=(M, N)).astype(np.int32)
    return c, {
        "scale": np.int32(2), "add": np.int32(-3), "sub": np.int32(2),
        "dot": rng.integers(-k, k + 1, (N,)).astype(np.int32),
        "outer": rng.integers(-k, k + 1, (7,)).astype(np.int32),
        "conv": rng.integers(-k, k + 1, (33,)).astype(np.int32),
        "xcorr": rng.integers(-k, k + 1, (5,)).astype(np.int32),
        "circconv": rng.integers(-k, k + 1, (9,)).astype(np.int32),
        "permute": rng.permutation(N), "identity": None}


def check_plan(plan, mode):
    """Every op and every failed stream (and none) at ``plan`` = (M, w,
    headroom_bits) under family ``mode``: the reference's outputs bit for
    bit and its report; a recovered run gives the healthy outputs,
    ``none`` under a failure the poisoned ones."""
    M, w, h = plan
    cfg, jcfg = FTConfig(mode, M, w, h), JFTConfig(mode, M, w, h)
    assert dataclasses.asdict(cfg.plan()) == dataclasses.asdict(jcfg.plan())
    assert cfg.extra_streams == jcfg.extra_streams
    c, gs = _operands(M, w, np.random.default_rng(sum(plan)))
    for op in sorted(JOPS):
        g = gs[op]
        truth = None
        for failed in [None] + list(range(M + (mode == "checksum"))):
            jo, jr = jrun(op, jnp.asarray(c),
                          None if g is None else jnp.asarray(g), jcfg,
                          failed=failed)
            to, tr = run_protected(
                op, torch.from_numpy(c),
                None if g is None else torch.as_tensor(np.asarray(g)), cfg,
                failed=failed)
            what = f"{op} {mode} failed={failed}"
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo),
                                          err_msg=what)
            assert dataclasses.astuple(tr) == dataclasses.astuple(jr), what
            if failed is None:
                truth = to
            elif mode == "none":
                assert not tr.recovered and (to[failed] == GARBAGE).all()
            else:
                assert tr.recovered and torch.equal(to, truth), what


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("plan", [p for p in PLANS if p[0] != 4],
                         ids=[i for p, i in zip(PLANS, PLAN_IDS)
                              if p[0] != 4])
def test_run_protected_at_plan_matches_reference(plan, mode):
    check_plan(plan, mode)


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_oracle_and_container_match_reference(plan):
    """``disentangle_oracle_np`` on full-range entangled words, every
    failed stream, and ``container_dtype``: the reference's."""
    M, w, h = plan
    p = FTConfig("entangle", M, w, h).plan()
    jp = JFTConfig("entangle", M, w, h).plan()
    assert container_dtype(p) == jcontainer_dtype(jp)
    rng = np.random.default_rng(M + w + h)
    bound = p.max_output_magnitude
    d = rng.integers(-bound, bound + 1, size=(M, 6, 5)).astype(np.int32)
    delta = entangle(torch.from_numpy(d), p).numpy()
    for failed in [None] + list(range(M)):
        bad = delta.copy()
        if failed is not None:
            bad[failed] = GARBAGE
        got = disentangle_oracle_np(bad, p, failed=failed)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, joracle(bad, jp, failed=failed))
        np.testing.assert_array_equal(got, d)


@pytest.mark.parametrize("axis", [1, 2, -1])
def test_checksum_along_axis_matches_reference(axis):
    """The streams along ``axis`` (the reference's ``moveaxis``): the
    checksum stream, the attached M + 1 streams and the recovery of every
    lost stream, full-range words wrapping mod 2**32, bit for bit."""
    M = 4
    shape = [3, 5, 7]
    shape[axis] = M
    rng = np.random.default_rng(7 + axis)
    c = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(
        np.int32)
    tc = torch.from_numpy(c)
    np.testing.assert_array_equal(make_checksum_stream(tc, axis=axis).numpy(),
                                  np.asarray(jchecksum(jnp.asarray(c),
                                                       axis=axis)))
    attached = np.asarray(jattach(jnp.asarray(c), axis=axis))
    np.testing.assert_array_equal(attach_checksum(tc, axis=axis).numpy(),
                                  attached)
    g = np.int32(11)
    outs = attached + g  # op add
    for failed in [None] + list(range(M + 1)):
        bad = np.moveaxis(outs.copy(), axis, 0)
        if failed is not None:
            bad[failed] = GARBAGE
        bad = np.moveaxis(bad, 0, axis)
        want = np.asarray(jrecover(jnp.asarray(bad), JOPS["add"],
                                   jnp.asarray(g), failed, axis=axis))
        got = recover_from_checksum(torch.from_numpy(bad), OPS["add"],
                                    torch.as_tensor(g), failed, axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), c + g)
