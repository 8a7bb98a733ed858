"""The port's codec and core against the reference, bit for bit.

Inputs come from numpy with a seed and go to both packages: entangle /
disentangle / extract for every failed stream and every plan of
``test_packed_kernels.py`` (int32 and dual-word temporaries), int8 lane
packing over the full int8 range, the planner (paper Table I) and the
llama3.2-1b configs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as jcfg
from repro.core.entangle import disentangle as j_disentangle
from repro.core.entangle import entangle as j_entangle
from repro.core.entangle import extract as j_extract
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import codec as jcodec
from repro_torch.configs import llama3_2_1b as tcfg
from repro_torch.configs import get_config
from repro_torch.core.entangle import disentangle, entangle, extract
from repro_torch.core.plan import make_plan
from repro_torch.kernels import codec

PLANS = [(3, 16, None), (4, 32, None), (3, 32, "dualword"), (8, 32, None)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("M", range(3, 9))
@pytest.mark.parametrize("w", [16, 32])
def test_make_plan_matches_reference(M, w):
    if (M - 1) + 1 > w:
        pytest.skip("infeasible")
    ref, port = jmake_plan(M, w), make_plan(M, w)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for prop in ("output_bits", "temp_bits", "max_output_magnitude",
                 "max_output_magnitude_tight"):
        assert getattr(ref, prop) == getattr(port, prop)


@pytest.mark.parametrize("M,w,temp", PLANS)
def test_codec_bit_exact_every_failed_stream(M, w, temp):
    """entangle, disentangle (every r, poisoned stream r) and extract equal
    the reference on full-range int32 values, where every shift and add
    wraps mod 2**32."""
    jp, tp = jmake_plan(M, w, temp=temp), make_plan(M, w, temp=temp)
    assert jp.temp == tp.temp
    rng = np.random.default_rng(M * 100 + w)
    c = rng.integers(-2**31, 2**31, size=(M, 5, 7), dtype=np.int64).astype(
        np.int32)
    jc, tc = _both(c)
    eps = entangle(tc, tp)
    np.testing.assert_array_equal(np.asarray(j_entangle(jc, jp)),
                                  eps.numpy())
    # entangled outputs of in-range data: disentangle recovers them exactly
    lim = jp.max_output_magnitude
    d = rng.integers(-lim, lim + 1, size=(M, 5, 7)).astype(np.int32)
    delta = entangle(torch.from_numpy(d), tp)
    for r in [None] + list(range(M)):
        bad = delta.clone()
        if r is not None:
            bad[r] = -0x5A5A5A5A
        ref = np.asarray(j_disentangle(jnp.asarray(bad.numpy()), jp,
                                          failed=r))
        out = disentangle(bad, tp, failed=r)
        np.testing.assert_array_equal(ref, out.numpy())
        np.testing.assert_array_equal(out.numpy(), d)
    # arbitrary int32 words (no range contract): still the same bits
    for r in range(M):
        ref = np.asarray(j_disentangle(jc, jp, failed=r))
        np.testing.assert_array_equal(
            ref, disentangle(tc, tp, failed=r).numpy())
        blk = codec.disentangle_block(tc, tp, r)
        np.testing.assert_array_equal(
            np.asarray(jcodec.disentangle_block(jc, jp, r)), blk.numpy())
    np.testing.assert_array_equal(np.asarray(j_extract(jc, jp)),
                                  extract(tc, tp).numpy())
    # a stream axis other than 0
    ca = np.moveaxis(c, 0, 1).copy()
    np.testing.assert_array_equal(
        np.asarray(j_disentangle(jnp.asarray(ca), jp, failed=1, axis=1)),
        disentangle(torch.from_numpy(ca), tp, failed=1, axis=1).numpy())


def test_wrap_and_shift_semantics_outside_int32():
    """int64 -> int32 wraps mod 2**32 and >> on negatives is arithmetic,
    as in numpy/jnp int32."""
    rng = np.random.default_rng(5)
    x = rng.integers(-2**62, 2**62, size=200, dtype=np.int64)
    x[:6] = [2**31, -2**31 - 1, 2**32 + 7, -2**33 - 3, 2**63 - 1, -2**63]
    np.testing.assert_array_equal(codec.wrap_i32(torch.from_numpy(x)).numpy(),
                                  x.astype(np.int32))
    y = x.astype(np.int32)
    for s in (1, 7, 24, 31):
        np.testing.assert_array_equal((torch.from_numpy(y) >> s).numpy(),
                                      np.asarray(jnp.right_shift(y, s)))
        np.testing.assert_array_equal((torch.from_numpy(y) << s).numpy(),
                                      np.asarray(jnp.left_shift(y, s)))


@pytest.mark.parametrize("shape,axis", [((13, 5), 0), ((4, 9), 1),
                                        ((2, 6, 3), 1), ((1,), 0),
                                        ((3, 4, 7), -1)])
def test_pack_int8_matches_reference_full_range(shape, axis):
    """Packed words equal the reference's (interchangeable q8 weights) and
    unpack restores the full int8 range, including the K % 4 != 0 tail."""
    rng = np.random.default_rng(len(shape) * 10 + axis)
    x = rng.integers(-128, 128, size=shape).astype(np.int32)
    n_edge = min(4, x.size)  # the sign-extension edge values
    x.flat[:n_edge] = [-128, 127, -1, 0][:n_edge]
    jp = np.asarray(jcodec.pack_int8(jnp.asarray(x), axis=axis))
    tp = codec.pack_int8(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(jp, tp.numpy())
    n = shape[axis]
    back = codec.unpack_int8(tp, axis=axis, n=n)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jcodec.unpack_int8(jnp.asarray(jp), axis=axis, n=n)),
        back.numpy())


def test_llama_configs_match_reference():
    assert dataclasses.asdict(tcfg.CONFIG) == dataclasses.asdict(jcfg.CONFIG)
    assert (dataclasses.asdict(tcfg.smoke_config())
            == dataclasses.asdict(jcfg.smoke_config()))
    assert tcfg.CONFIG.layer_pattern() == jcfg.CONFIG.layer_pattern()


def test_unported_arch_raises_not_ported():
    """Every arch id is ported now: deepseek-v3-671b's configs equal the
    reference's, and an unknown id still raises a ``KeyError``."""
    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke_config as jget_smoke
    from repro_torch.configs import get_smoke_config

    assert (dataclasses.asdict(get_config("deepseek-v3-671b"))
            == dataclasses.asdict(jget_config("deepseek-v3-671b")))
    assert (dataclasses.asdict(get_smoke_config("deepseek-v3-671b"))
            == dataclasses.asdict(jget_smoke("deepseek-v3-671b")))
    with pytest.raises(KeyError):
        get_config("no-such-arch")
