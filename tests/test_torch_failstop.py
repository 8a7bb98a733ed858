"""The port's fail-stop engine (``run_protected`` over the LSB op registry,
the checksum-ABFT baseline, modular redundancy) and the stream-conv
configuration against the reference.

Same inputs, made from a numpy seed, go through ``repro.core`` and
``repro_torch.core``; every integer result must be bit-identical, as must
each ``FTReport``: every op of ``OPS`` under every family and every failed
stream (mirrors ``tests/test_ft_engine.py`` and
``tests/test_entangle_property.py``), and the paper's stream conv at its
smoke size. The reference runs eagerly: its calls are small, and a jit per
(op, family, failed stream) would compile hundreds of programs.
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stream_conv as jstream_conv
from repro.core import FTConfig as JFTConfig
from repro.core import OPS as JOPS
from repro.core import attach_checksum as jattach
from repro.core import entangle_kernel_addsub as jaddsub
from repro.core import get_op as jget_op
from repro.core import recover_from_checksum as jrecover
from repro.core import reentangle_stream as jreentangle
from repro.core import run_protected as jrun
from repro.core.plan import make_plan as jmake_plan
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import stream_conv
from repro_torch.core import (GARBAGE, OPS, FTConfig, attach_checksum,
                              entangle_kernel_addsub, get_op,
                              make_checksum_stream, make_plan,
                              recover_from_checksum, reentangle_stream,
                              run_protected)

MODES = ("none", "entangle", "checksum", "mr")
M = 4
N = 257  # ragged


def _operands(rng):
    """Each op's kernel at stream length N (as ``examples/failstop_demo.py``
    picks them), and the inputs."""
    c = rng.integers(-50, 50, size=(M, N)).astype(np.int32)
    return c, {
        "scale": np.int32(9), "add": np.int32(-3), "sub": np.int32(7),
        "dot": rng.integers(-4, 4, (N,)).astype(np.int32),
        "outer": rng.integers(-4, 4, (7,)).astype(np.int32),
        "conv": rng.integers(-10, 10, (33,)).astype(np.int32),
        "xcorr": rng.integers(-10, 10, (5,)).astype(np.int32),
        "circconv": rng.integers(-4, 4, (9,)).astype(np.int32),
        "permute": rng.permutation(N), "identity": None}


def _failures(mode, m):
    return [None] + list(range(m + (mode == "checksum")))


def _ref(op, c, g, mode, m, failed):
    jo, jr = jrun(op, jnp.asarray(c), None if g is None else jnp.asarray(g),
                  JFTConfig(mode=mode, M=m), failed=failed)
    return np.asarray(jo), jr


def _port(op, c, g, mode, m, failed):
    return run_protected(op, torch.from_numpy(c),
                         None if g is None else torch.as_tensor(np.asarray(g)),
                         FTConfig(mode=mode, M=m), failed=failed)


def _both(op, c, g, mode, m, failed):
    return _ref(op, c, g, mode, m, failed) + _port(op, c, g, mode, m, failed)


def test_registry_matches_reference():
    assert sorted(OPS) == sorted(JOPS)
    for name, op in OPS.items():
        assert op.needs_kernel_entangled == JOPS[name].needs_kernel_entangled
    with pytest.raises(KeyError) as got:
        get_op("fft")
    with pytest.raises(KeyError) as want:
        jget_op("fft")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", sorted(JOPS))
def test_run_protected_matches_reference(op, mode):
    """Every op, every family, every failed stream (and none): the same
    outputs bit for bit and the same report; ``none`` under a failure gives
    the poisoned outputs and ``recovered=False``."""
    rng = np.random.default_rng(0)
    c, gs = _operands(rng)
    truth = None
    for failed in _failures(mode, M):
        jo, jr, to, tr = _both(op, c, gs[op], mode, M, failed)
        assert to.dtype == torch.int32 and tuple(to.shape) == jo.shape
        np.testing.assert_array_equal(to.numpy(), jo,
                                      err_msg=f"{op} {mode} failed={failed}")
        assert dataclasses.astuple(tr) == dataclasses.astuple(jr)
        if failed is None:
            truth = to
        elif mode == "none":
            assert not tr.recovered and (to[failed] == GARBAGE).all()
        else:
            assert tr.recovered and torch.equal(to, truth)


def test_full_range_words_wrap_as_the_reference():
    """Full-range int32 streams: every family wraps mod 2**32 as the
    reference (the entangled values overflow by design)."""
    rng = np.random.default_rng(3)
    c = rng.integers(-2**31, 2**31, size=(M, 64), dtype=np.int64).astype(
        np.int32)
    for op, g in (("conv", rng.integers(-2**31, 2**31, size=(9,),
                                        dtype=np.int64).astype(np.int32)),
                  ("dot", rng.integers(-2**31, 2**31, size=(64,),
                                       dtype=np.int64).astype(np.int32)),
                  ("add", np.int32(2**31 - 5))):
        for mode in MODES:
            for failed in (None, 1):
                jo, _, to, _ = _both(op, c, g, mode, M, failed)
                np.testing.assert_array_equal(to.numpy(), jo)


@pytest.mark.parametrize("mode", MODES + ("tmr",))
def test_ftconfig_matches_reference(mode):
    for m in (3, 8):
        cfg, jcfg = FTConfig(mode=mode, M=m), JFTConfig(mode=mode, M=m)
        assert cfg.extra_streams == jcfg.extra_streams
        assert dataclasses.asdict(cfg.plan()) == dataclasses.asdict(
            jcfg.plan())
    with (pytest.raises(ValueError, match="unknown ft mode")
          if mode == "tmr" else contextlib.nullcontext()):
        run_protected("identity", torch.zeros((4, 3), dtype=torch.int32),
                      None, FTConfig(mode=mode))


def test_stream_count_is_checked():
    with pytest.raises(ValueError, match="expected 4 streams"):
        run_protected("scale", torch.zeros((3, 5), dtype=torch.int32), 2,
                      FTConfig(M=4))


@pytest.mark.parametrize("shape", [(50,), (6, 5)], ids=["1d", "2d"])
def test_checksum_attach_and_recover_match_reference(shape):
    """The streams on the leading axis (the reference's default axis 0),
    one or two trailing axes."""
    rng = np.random.default_rng(len(shape))
    c = rng.integers(-2**31, 2**31, size=(M,) + shape, dtype=np.int64
                     ).astype(np.int32)
    tc = torch.from_numpy(c)
    attached = np.asarray(jattach(jnp.asarray(c)))
    np.testing.assert_array_equal(attach_checksum(tc).numpy(), attached)
    np.testing.assert_array_equal(make_checksum_stream(tc).numpy(),
                                  attached[M])
    g = np.int32(11)
    outs = attached + g  # op add
    for failed in [None] + list(range(M + 1)):
        bad = outs.copy()
        if failed is not None:
            bad[failed] = GARBAGE
        want = np.asarray(jrecover(jnp.asarray(bad), JOPS["add"],
                                   jnp.asarray(g), failed))
        got = recover_from_checksum(torch.from_numpy(bad), OPS["add"],
                                    torch.as_tensor(g), failed)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), c + g)


@pytest.mark.parametrize("Mw", [(3, 32), (4, 16), (8, 32)])
def test_kernel_addsub_and_reentangle_match_reference(Mw):
    m, w = Mw
    jp, tp = jmake_plan(m, w), make_plan(m, w)
    rng = np.random.default_rng(m + w)
    g = rng.integers(-2**31, 2**31, size=(17,), dtype=np.int64).astype(
        np.int32)
    np.testing.assert_array_equal(
        entangle_kernel_addsub(torch.from_numpy(g), tp).numpy(),
        np.asarray(jaddsub(jnp.asarray(g), jp)))
    d = rng.integers(-2**31, 2**31, size=(m, 6, 5), dtype=np.int64).astype(
        np.int32)
    for stream in range(-1, m + 1):
        np.testing.assert_array_equal(
            reentangle_stream(torch.from_numpy(d), tp, stream).numpy(),
            np.asarray(jreentangle(jnp.asarray(d), jp, stream)))


def test_stream_conv_config_matches_reference():
    for got, want in ((stream_conv.CONFIG, jstream_conv.CONFIG),
                      (stream_conv.smoke_config(),
                       jstream_conv.smoke_config())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert stream_conv.CONFIG.name not in ARCH_IDS


def _expected(truth, mode, failed):
    """What every family returns: the true outputs, poisoned in the failed
    stream for ``none``."""
    want = truth.copy()
    if mode == "none" and failed is not None:
        want[failed] = GARBAGE
    return want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [3, 8])
def test_smoke_stream_conv_matches_reference(m, mode):
    """The slice end to end at the configuration's smoke size: M streams of
    N_in = 4096 samples convolved with each kernel size, inputs within the
    eq. (13) budget as ``benchmarks/fig2_conv_throughput.py`` sizes them,
    every failed stream; the port equals the reference and recovers the
    failure-intolerant conv exactly.

    The reference runs once per kernel size, with the middle stream
    failed (outputs and report), and must give the exact conv (poisoned in
    that stream for ``none``); so it does under every failure (its own
    tests, and the sweep of ``test_run_protected_matches_reference``). The
    port's outputs for every failed stream are held to that exact conv,
    with the failed stream poisoned for ``none``."""
    cfg = stream_conv.smoke_config()
    assert cfg.w == 32  # FTConfig's word
    plan = make_plan(m, cfg.w)
    lim = min(max(plan.max_output_magnitude
                  // (max(cfg.kernel_sizes) * 4) - 1, 2), 1 << 12)
    rng = np.random.default_rng(m)
    c = rng.integers(-lim, lim, size=(m, cfg.n_in)).astype(np.int32)
    for k in cfg.kernel_sizes:
        g = rng.integers(-4, 4, size=k).astype(np.int32)
        truth = np.stack([np.convolve(row, g.astype(np.int64))
                          for row in c.astype(np.int64)]).astype(np.int32)

        jo, jr, to, tr = _both("conv", c, g, mode, m, m // 2)
        np.testing.assert_array_equal(jo, _expected(truth, mode, m // 2))
        np.testing.assert_array_equal(to.numpy(), jo)
        assert dataclasses.astuple(tr) == dataclasses.astuple(jr)
        for failed in _failures(mode, m):
            to, tr = _port("conv", c, g, mode, m, failed)
            assert to.dtype == torch.int32
            assert to.shape == (m, cfg.n_in + k - 1)
            np.testing.assert_array_equal(
                to.numpy(), _expected(truth, mode, failed),
                err_msg=f"k={k} failed={failed}")
            assert tr == type(tr)(mode, failed,
                                  mode != "none" or failed is None)
