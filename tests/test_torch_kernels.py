"""The port's entangled GEMM against the reference's Pallas kernel.

The plain PyTorch version (what a CPU tensor runs) must be bit-identical
to ``repro.kernels.ops.entangled_matmul(backend="interpret_cpu")`` — the
Pallas kernel run the way the reference's own CPU tests run it — and to
the jnp oracles of ``repro.kernels.ref``, for all four ``fuse_epilogue``
modes, packed and unpacked weights, every failed stream and every plan of
``test_packed_kernels.py``, on the ragged B=6, K=13, N=9 shape. The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import make_plan as jmake_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.codec import pack_int8 as jpack_int8
from repro_torch.core.plan import make_plan
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import ops
from repro_torch.kernels.codec import pack_int8

PLANS = [(3, 16, None), (4, 32, None), (3, 32, "dualword"), (8, 32, None)]
MODES = (False, True, "chain", "chain_final")


def _operands(M, seed, B=6, K=13, N=9):
    """Full-range int32 activations and weights (every product wraps), and
    an int8 weight with its packed words."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-2**31, 2**31, size=(M, B, K), dtype=np.int64)
    g = rng.integers(-2**31, 2**31, size=(K, N), dtype=np.int64)
    g8 = rng.integers(-128, 128, size=(K, N)).astype(np.int32)
    gp = np.asarray(jpack_int8(jnp.asarray(g8), axis=0))
    return c.astype(np.int32), g.astype(np.int32), g8, np.array(gp)


@pytest.fixture(scope="module", params=PLANS, ids=lambda p: f"M{p[0]}w{p[1]}")
def case(request):
    """Reference outputs of the interpret-mode Pallas kernel for one plan,
    built once: {(mode, packed, r): int32 array}."""
    M, w, temp = request.param
    jp, tp = jmake_plan(M, w, temp=temp), make_plan(M, w, temp=temp)
    c, g, g8, gp = _operands(M, M * 1000 + w)
    ref = {}
    for packed, gg in ((False, g), (True, gp)):
        for mode in MODES:
            rs = [None] + list(range(M)) if mode in (True, "chain_final") \
                else [None]
            for r in rs:
                ref[(mode, packed, r)] = np.asarray(jops.entangled_matmul(
                    jnp.asarray(c), jnp.asarray(gg), jp, fuse_epilogue=mode,
                    failed=r, packed=packed, backend="interpret_cpu"))
    return dict(jp=jp, tp=tp, c=c, g=g, g8=g8, gp=gp, ref=ref)


def test_plain_matches_interpret_kernel_every_mode(case):
    for (mode, packed, r), want in case["ref"].items():
        got = ops.entangled_matmul(
            torch.from_numpy(case["c"]),
            torch.from_numpy(np.array(case["gp"] if packed else case["g"])),
            case["tp"], fuse_epilogue=mode, failed=r, packed=packed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), want, err_msg=f"mode={mode!r} packed={packed} r={r}")


def test_plain_matches_jnp_oracles(case):
    """Against ``repro.kernels.ref``: the entangled products and the fused
    (disentangled) products for every failed stream."""
    jp, tp = case["jp"], case["tp"]
    c, g8 = case["c"], case["g8"]
    delta = np.asarray(jref.entangled_matmul_ref(jnp.asarray(c),
                                                 jnp.asarray(g8), jp.l))
    got = emm.entangled_matmul_plain(torch.from_numpy(c),
                                     torch.from_numpy(case["gp"]), tp,
                                     packed=True)
    np.testing.assert_array_equal(got.numpy(), delta)
    for r in range(jp.M):
        want = np.asarray(jref.entangled_matmul_fused_ref(
            jnp.asarray(c), jnp.asarray(g8), jp, r=r))
        got = emm.entangled_matmul_plain(
            torch.from_numpy(c), torch.from_numpy(g8), tp,
            fuse_epilogue=True, failed=r)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_exact_at_full_width_depth():
    """The float64 limb product stays exact at the serving depths (K up to
    8192) with full-range int32 operands: check one column against int64
    arithmetic in numpy."""
    rng = np.random.default_rng(3)
    plan = make_plan(4, 32)
    K = 8192
    c = rng.integers(-2**31, 2**31, size=(4, 2, K), dtype=np.int64)
    g = rng.integers(-2**31, 2**31, size=(K, 3), dtype=np.int64)
    got = emm.entangled_matmul_plain(torch.from_numpy(c.astype(np.int32)),
                                     torch.from_numpy(g.astype(np.int32)),
                                     plan, fuse_epilogue="chain")
    want = np.einsum("mbk,kn->mbn", c, g).astype(np.int32)  # wraps mod 2**64
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_dispatch_rejects_bad_calls():
    plan = make_plan(4, 32)
    c = torch.zeros((4, 2, 8), dtype=torch.int32)
    g = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="fuse_epilogue"):
        ops.entangled_matmul(c, g, plan, fuse_epilogue="bogus")
    with pytest.raises(ValueError, match="both operands"):
        ops.entangled_matmul(c.to("meta"), g, plan)
    with pytest.raises(ValueError, match="streams"):
        ops.entangled_matmul(c[:3], g, plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        emm.entangled_matmul_cuda(c, g, plan)
    # the CPU path never counts a kernel launch
    assert emm.launches_s8 == emm.launches_cuda_core == 0
