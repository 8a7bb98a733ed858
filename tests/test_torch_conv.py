"""The port's conv and checksum kernels (plain depthwise causal conv1d, the
fused entangled conv1d, the checksum stream) against the reference.

The plain PyTorch versions (what a CPU tensor runs, and what the CUDA
kernels are held to on the card in ``test_torch_cuda.py``) must be
bit-identical to the jnp oracles of ``repro.kernels.ref`` and to the
reference's Pallas kernels run in interpret mode, as its own CPU tests run
them (``tests/test_kernels.py``, ``tests/test_fused_codec.py``,
``tests/test_packed_kernels.py``): full-range int32 inputs, M = 3..8,
int32 and dual-word plans, every failed stream, packed and unpacked taps,
K_f = 1 and a K_f longer than the reference kernel's time tile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.entangle import disentangle as jdisentangle
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core.entangle import disentangle
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import make_plan
from repro_torch.kernels import checksum as cks
from repro_torch.kernels import conv1d as cv
from repro_torch.kernels import entangled_conv1d as ecv
from repro_torch.kernels import nvcc, ops
from repro_torch.kernels.codec import pack_int8

# (M, w): every M of Table I at w=32 (dual-word temporaries) and the int32
# temporaries of w=16
PLANS = [(M, 32) for M in range(3, 9)] + [(3, 16), (4, 16)]

# The oracles unroll a Python loop over the taps, so they run eagerly (a
# jit of a 600-tap unroll compiles for seconds, and every jit of these
# small graphs for about half a second). Eager JAX dispatches every op of
# the unroll, so the long filter's unfused oracle runs once for all plans:
# its definition, ``stack(conv1d_causal_ref(entangle_ref(x)[m], w))``, as
# one conv of every plan's entangled streams stacked on B. The fused
# oracle, ``entangled_conv1d_fused_ref``, is by definition ``disentangle``
# of the unfused one; it is called once per plan and checked against
# that, and every r is ``disentangle`` of the one unfused result.
LONG = (1, 1, 600, 520)  # B, D, T, K_f > the reference's time tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _full(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(
        np.int32)


@pytest.mark.parametrize("B,D,T,kf", [(2, 3, 37, 4), (1, 1, 700, 1),
                                      (3, 2, 9, 13), (1, 1, 600, 520)])
def test_plain_conv1d_matches_reference(B, D, T, kf):
    """Ragged shapes, K_f = 1 and K_f > the reference's time tile (512),
    full-range int32 words; the op API's CPU path launches nothing."""
    rng = np.random.default_rng(B * T + kf)
    x, w = _full(rng, (B, D, T)), _full(rng, (D, kf))
    want = np.asarray(ref.conv1d_causal_ref(jnp.asarray(x),
                                           jnp.asarray(w)))
    got = cv.conv1d_causal_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    before = cv.launches
    np.testing.assert_array_equal(
        ops.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        want)
    assert cv.launches == before


def test_conv1d_matches_interpret_mode_pallas():
    """The reference's Pallas conv kernel in interpret mode (K_f = 1 is
    promoted there with a zero leading tap)."""
    rng = np.random.default_rng(5)
    x = _full(rng, (2, 3, 40))
    for kf in (1, 3):
        w = _full(rng, (3, kf))
        want = np.asarray(jops.conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                             backend="interpret_cpu"))
        np.testing.assert_array_equal(
            ops.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
            want)


def _long_input(M, w):
    rng = np.random.default_rng(M * 10 + w + 1)
    return _full(rng, (M,) + LONG[:3])


@pytest.fixture(scope="module")
def long_deltas():
    """The unfused oracle at the long filter for every plan, from one conv
    of all plans' entangled streams (same taps for every plan)."""
    w = _full(np.random.default_rng(LONG[3]), LONG[1:2] + LONG[3:])
    eps = [ref.entangle_ref(jnp.asarray(_long_input(M, wd)),
                            jmake_plan(M, wd).l) for M, wd in PLANS]
    out = ref.conv1d_causal_ref(jnp.concatenate(eps, 0).reshape(
        -1, *LONG[1:3]), jnp.asarray(w))
    sizes = np.cumsum([M for M, _ in PLANS])[:-1]
    return w, {p: d.reshape(e.shape) for p, d, e in zip(
        PLANS, jnp.split(out, sizes), eps)}


@pytest.fixture(scope="module", params=PLANS, ids=lambda p: f"M{p[0]}w{p[1]}")
def econv_case(request, long_deltas):
    """One plan's inputs (depthwise shapes with D % 4 != 0, K_f = 3 and 1,
    on int8 taps packed and unpacked and on full-range int32 taps; a filter
    longer than the reference's time tile at D = 1, unpacked) and the
    reference oracle's outputs, unfused and fused for every r."""
    M, w = request.param
    jp, tp = jmake_plan(M, w), make_plan(M, w)
    rng = np.random.default_rng(M * 10 + w)
    cases = []
    for (B, D, T, kf) in [(2, 6, 21, 3), LONG, (1, 5, 9, 1)]:
        if (B, D, T, kf) == LONG:
            x, taps_ref = _long_input(M, w), long_deltas[0]
            variants = [(False, taps_ref, long_deltas[1][request.param])]
        else:
            x = _full(rng, (M, B, D, T))
            w8 = rng.integers(-128, 128, size=(D, kf)).astype(np.int32)
            variants = [(packed, t, ref.entangled_conv1d_ref(
                jnp.asarray(x), jnp.asarray(t), jp.l))
                for packed, t in ((False, _full(rng, (D, kf))), (True, w8))]
        for packed, taps_ref, delta in variants:
            taps = torch.from_numpy(taps_ref)
            if packed:
                taps = pack_int8(taps, axis=0)
            fused = {r: jdisentangle(delta, jp, failed=r) for r in range(M)}
            if not cases:
                r = M // 2
                np.testing.assert_array_equal(
                    np.asarray(ref.entangled_conv1d_fused_ref(
                        jnp.asarray(x), jnp.asarray(taps_ref), jp, r=r)),
                    np.asarray(fused[r]))
            cases.append(dict(
                x=x, taps=taps, packed=packed, delta=np.asarray(delta),
                fused={r: np.asarray(v) for r, v in fused.items()}))
    return tp, cases


def test_plain_entangled_conv1d_matches_reference(econv_case):
    tp, cases = econv_case
    for case in cases:
        x = torch.from_numpy(case["x"])
        got = ecv.entangled_conv1d_plain(x, case["taps"], tp,
                                         packed=case["packed"])
        np.testing.assert_array_equal(got.numpy(), case["delta"])
        for r, want in case["fused"].items():
            got = ops.entangled_conv1d(x, case["taps"], tp, fuse_epilogue=True,
                                       failed=r, packed=case["packed"])
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"r={r}")
        np.testing.assert_array_equal(
            ops.entangled_conv1d(x, case["taps"], tp, fuse_epilogue=True,
                                 packed=case["packed"]).numpy(),
            case["fused"][0])


def test_entangled_conv1d_poison_and_range_contract(econv_case):
    """Disentangling the unfused outputs with stream r overwritten by
    GARBAGE equals the fused result; within the eq. (13) budget the fused
    result is the true per-stream conv, for every r."""
    tp, _ = econv_case
    rng = np.random.default_rng(tp.M)
    kf = 5
    lim = max(tp.max_output_magnitude // (kf * 128) - 1, 1)
    x = torch.from_numpy(rng.integers(-lim, lim + 1, size=(tp.M, 2, 3, 30))
                         .astype(np.int32))
    w8 = torch.from_numpy(rng.integers(-128, 128, size=(3, kf))
                          .astype(np.int32))
    wp = pack_int8(w8, axis=0)
    delta = ops.entangled_conv1d(x, wp, tp, packed=True)
    truth = cv.conv1d_causal_plain(x.reshape(-1, 3, 30), w8).reshape(x.shape)
    for r in range(tp.M):
        bad = delta.clone()
        bad[r] = GARBAGE
        fused = ops.entangled_conv1d(x, wp, tp, fuse_epilogue=True, failed=r,
                                     packed=True)
        np.testing.assert_array_equal(disentangle(bad, tp, failed=r).numpy(),
                                      fused.numpy())
        np.testing.assert_array_equal(fused.numpy(), truth.numpy())


def test_entangled_conv1d_matches_interpret_mode_pallas():
    """One call of the reference's fused Pallas kernel in interpret mode
    (packed taps, a failed stream)."""
    jp, tp = jmake_plan(4, 32), make_plan(4, 32)
    rng = np.random.default_rng(11)
    x = _full(rng, (4, 1, 8, 20))
    wp = pack_int8(torch.from_numpy(
        rng.integers(-128, 128, size=(8, 3)).astype(np.int32)), axis=0)
    want = np.asarray(jops.entangled_conv1d(
        jnp.asarray(x), jnp.asarray(wp.numpy()), jp, fuse_epilogue=True,
        failed=2, packed=True, backend="interpret_cpu"))
    got = ops.entangled_conv1d(torch.from_numpy(x), wp, tp,
                               fuse_epilogue=True, failed=2, packed=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["chain", "chain_final", None, 1.5])
def test_entangled_conv1d_refuses_other_modes(mode):
    """The chain modes are dense-only, as in the reference."""
    tp = make_plan(4, 32)
    x = torch.zeros((4, 1, 2, 8), dtype=torch.int32)
    w = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="fuse_epilogue"):
        ops.entangled_conv1d(x, w, tp, fuse_epilogue=mode)
    with pytest.raises(ValueError, match="fuse_epilogue"):
        jops.entangled_conv1d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                              jmake_plan(4, 32), fuse_epilogue=mode,
                              backend="reference")


@pytest.mark.parametrize("shape", [(3, 1031), (8, 5, 7), (1, 4), (9, 64)])
def test_plain_checksum_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    c = _full(rng, shape)
    want = np.asarray(ref.checksum_ref(jnp.asarray(c)))[0]
    got = ops.checksum(torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cks.checksum_plain(torch.from_numpy(c).reshape(shape[0], -1)).numpy(),
        want.reshape(-1))
    if shape == (3, 1031):  # the Pallas kernel, padded to its blocks
        np.testing.assert_array_equal(
            np.asarray(jops.checksum(jnp.asarray(c), backend="interpret_cpu")),
            want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never runs the plain version: a CPU tensor raises."""
    tp = make_plan(4, 32)
    x = torch.zeros((4, 1, 2, 8), dtype=torch.int32)
    w = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cv.conv1d_causal_cuda(x[0], w)
    with pytest.raises(ValueError, match="CUDA"):
        ecv.entangled_conv1d_cuda(x, w, tp, fuse_epilogue=True, failed=1)
    with pytest.raises(ValueError, match="CUDA"):
        cks.checksum_cuda(x.reshape(4, -1))


def test_conv_build_hash_follows_the_shared_header(tmp_path):
    """``csrc/conv1d.cu`` includes the codec header, and its library name
    hashes that header: an edit to the header rebuilds the conv library (as
    it does the GEMM's and the codec passes')."""
    assert [p.name for p in nvcc.sources(cv.SRC)] == ["conv1d.cu",
                                                       "codec.cuh"]
    assert ecv.build is cv.build and cks.build is not cv.build
    header = cv.SRC.parent / "codec.cuh"
    (tmp_path / "codec.cuh").write_text(header.read_text())
    (tmp_path / "conv1d.cu").write_text(cv.SRC.read_text())
    before = nvcc.digest(tmp_path / "conv1d.cu")
    assert before == nvcc.digest(cv.SRC)
    (tmp_path / "codec.cuh").write_text(header.read_text() + "// edit\n")
    assert nvcc.digest(tmp_path / "conv1d.cu") != before
