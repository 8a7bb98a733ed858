"""The s8 tensor-core route of the port's entangled GEMMs, on the CPU.

The plain version repeats the s8 kernel's byte-limb arithmetic for packed
weights (four u8 limbs of eps, each times the int8 weights, recombined
mod 2**32). Here it is held against the reference's jnp oracles
(``repro.kernels.ref`` and ``repro.core.entangle.disentangle``) at the
edge of the limb range: every limb at 255, weights at -128 and the
deepest K of one limb product (65536), and eps near +-2**31; past it,
at K = 65540 and 131073, the port's packed op (which cuts K into slices
of at most 65536) against the reference's packed op. The wrappers'
routing (packed calls to the s8 kernel, unpacked to the CUDA-core kernel)
and the split-K rule that keeps every split within 65536 are checked with
the launch stubbed; the
kernels themselves are held against the plain version on the GPU in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.entangle import disentangle as jdisentangle
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import ref as jref
from repro_torch.core.plan import make_plan
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import entangled_matmul_grouped as emmg
from repro_torch.kernels import ops
from repro_torch.kernels.codec import pack_int8

K_MAX = 65536
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _c(kind, shape, rng):
    """Activations at the edge of the limb range."""
    if kind == "limbs_255":  # 0xFFFFFFFF: every byte limb is 255
        return np.full(shape, -1, dtype=np.int64)
    if kind == "near_pos":
        return I32_MAX - rng.integers(0, 256, size=shape)
    if kind == "near_neg":
        return I32_MIN + rng.integers(0, 256, size=shape)
    return rng.integers(I32_MIN, I32_MAX + 1, size=shape)


def _g(kind, shape, rng):
    """int8 weights: all -128 (the most negative limb sums), or random."""
    if kind == "min":
        return np.full(shape, -128, dtype=np.int64)
    return rng.integers(-128, 128, size=shape)


def _oracle(c, g8, jp, mode, r):
    """The reference's function: the entangled product (modes True/False)
    or the plain product (chain modes), int32 ring arithmetic, then
    extraction in the extracting modes."""
    cj, gj = jnp.asarray(c), jnp.asarray(g8)
    if mode in (True, False):
        delta = jref.entangled_matmul_ref(cj, gj, jp.l)
    else:
        delta = jnp.einsum("mbk,kn->mbn", cj, gj).astype(jnp.int32)
    if mode in (True, "chain_final"):
        delta = jdisentangle(delta, jp, failed=r)
    return np.asarray(delta)


@pytest.mark.parametrize("c_kind,g_kind,mode,r", [
    ("limbs_255", "min", "chain", None),
    ("limbs_255", "min", "chain_final", 2),
    ("near_pos", "min", "chain", None),
    ("near_neg", "min", "chain", None),
    ("near_pos", "rand", "chain_final", 0),
    ("near_neg", "rand", "chain_final", 3),
    ("full", "rand", True, 1),
    ("full", "min", False, None),
])
def test_limb_product_at_the_edge_matches_oracle(c_kind, g_kind, mode, r):
    """K = 65536 on a narrow N: the plain version's limb product (the
    s8 kernel's arithmetic) equals the jnp oracle bit for bit, with every
    limb's sums inside s32."""
    rng = np.random.default_rng(sum(map(ord, f"{c_kind}{g_kind}{mode}")))
    M, B, N = 4, 2, 3
    jp, tp = jmake_plan(M, 32), make_plan(M, 32)
    c = _c(c_kind, (M, B, K_MAX), rng).astype(np.int32)
    g8 = _g(g_kind, (K_MAX, N), rng).astype(np.int32)
    got = emm.entangled_matmul_plain(
        torch.from_numpy(c), pack_int8(torch.from_numpy(g8), axis=0), tp,
        fuse_epilogue=mode, failed=r, packed=True)
    np.testing.assert_array_equal(got.numpy(), _oracle(c, g8, jp, mode, r))


def test_limb_product_grouped_at_the_edge_matches_oracle():
    """The grouped plain version at K = 65536 with every limb at 255 and
    weights at -128 for one expert, random words for the other."""
    rng = np.random.default_rng(11)
    M, E, Cg, N = 3, 2, 1, 2
    jp, tp = jmake_plan(M, 16), make_plan(M, 16)
    c = np.stack([_c("limbs_255", (M, Cg, K_MAX), rng),
                  _c("full", (M, Cg, K_MAX), rng)], axis=1).astype(np.int32)
    g8 = np.stack([_g("min", (K_MAX, N), rng),
                   _g("rand", (K_MAX, N), rng)]).astype(np.int32)
    got = emmg.entangled_matmul_grouped_plain(
        torch.from_numpy(c), pack_int8(torch.from_numpy(g8), axis=1), tp,
        fuse_epilogue=True, failed=1, packed=True)
    want = np.asarray(jref.entangled_matmul_grouped_fused_ref(
        jnp.asarray(c), jnp.asarray(g8), jp, r=1))
    np.testing.assert_array_equal(got.numpy(), want)


# one reference output per (form, K), every mode and failed stream stacked
_DEEP_CASES = [(K, mode) for K in (K_MAX + 4, 2 * K_MAX + 1)
               for mode in (True, False)]


def _deep_operands(form, K):
    """M = 4 full-range activations and int8 weights at depth K (ragged
    when K % 4 != 0): dense c [4, 1, K], g [K, 4]; grouped c [4, 2, 1, K],
    g [2, K, 4]."""
    rng = np.random.default_rng(K)
    lead = (4, 1) if form == "dense" else (4, 2, 1)
    experts = () if form == "dense" else (2,)
    c = rng.integers(I32_MIN, I32_MAX + 1, size=(*lead, K)).astype(np.int32)
    g8 = rng.integers(-128, 128, size=(*experts, K, 4)).astype(np.int32)
    return c, g8


@pytest.mark.parametrize("form", ["dense", "grouped"])
@pytest.mark.parametrize("K,mode", _DEEP_CASES)
def test_plain_past_the_limb_range_matches_reference(form, K, mode):
    """Packed weights deeper than 65536: the port's op (on the CPU, the
    plain version, which cuts K into slices of at most 65536 as the s8
    kernel splits it) equals the reference's packed op bit for bit, for
    every failed stream, ragged K included."""
    from repro.kernels import ops as jops

    c, g8 = _deep_operands(form, K)
    jp, tp = jmake_plan(4, 32), make_plan(4, 32)
    axis = 0 if form == "dense" else 1
    gp = pack_int8(torch.from_numpy(g8), axis=axis)
    jfn = jops.entangled_matmul if form == "dense" \
        else jops.entangled_matmul_grouped
    tfn = ops.entangled_matmul if form == "dense" \
        else ops.entangled_matmul_grouped
    want = None
    for r in [None] + list(range(4)):
        # the reference takes seconds per call at this depth: without
        # extraction its output does not depend on r, and None means 0
        if want is None or (mode and r):
            want = np.asarray(jfn(jnp.asarray(c), jnp.asarray(gp.numpy()),
                                  jp, fuse_epilogue=mode, failed=r,
                                  packed=True, backend="reference"))
        got = tfn(torch.from_numpy(c), gp, tp, fuse_epilogue=mode,
                  failed=r, packed=True)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{form} K={K} r={r}")


@pytest.fixture
def stubbed_launch(monkeypatch):
    """The wrappers on CPU tensors with the operand check and the launch
    stubbed: returns the list of routes launched. Both modules' counters
    are restored afterwards."""
    routes = []

    def launch(c, g, plan, *, E, Cg, K, N, packed, route, **kw):
        routes.append((route, packed))
        return torch.zeros((plan.M, E * Cg, N), dtype=torch.int32)

    monkeypatch.setattr(emm, "check_operands", lambda c, g, dims: None)
    monkeypatch.setattr(emm, "launch", launch)
    for mod in (emm, emmg):
        monkeypatch.setattr(mod, "launches_s8", 0)
        monkeypatch.setattr(mod, "launches_cuda_core", 0)
    return routes


@pytest.mark.parametrize("form", ["dense", "grouped"])
def test_wrappers_route_by_packed(stubbed_launch, form):
    """Packed calls reach the s8 kernel and unpacked ones the CUDA-core
    kernel, each counted on its own route; nothing is chosen by build or
    launch success."""
    plan = make_plan(4, 32)
    lead = (4, 2) if form == "dense" else (4, 3, 2)
    experts = () if form == "dense" else (3,)
    c = torch.zeros((*lead, 10), dtype=torch.int32)
    g = torch.zeros((*experts, 10, 5), dtype=torch.int32)
    gp = torch.zeros((*experts, 3, 5), dtype=torch.int32)
    mod = emm if form == "dense" else emmg
    fn = (emm.entangled_matmul_cuda if form == "dense"
          else emmg.entangled_matmul_grouped_cuda)
    fn(c, gp, plan, fuse_epilogue=True, failed=1, packed=True)
    fn(c, g, plan, fuse_epilogue=True, failed=1, packed=False)
    fn(c, gp, plan, packed=True)
    assert stubbed_launch == [("s8", True), ("cuda_core", False),
                              ("s8", True)]
    assert (mod.launches_s8, mod.launches_cuda_core) == (2, 1)
    # the CUDA-core kernel stays callable on packed weights
    core = (emm.entangled_matmul_cuda_core if form == "dense"
            else emmg.entangled_matmul_grouped_cuda_core)
    core(c, gp, plan, packed=True)
    assert stubbed_launch[-1] == ("cuda_core", True)
    assert (mod.launches_s8, mod.launches_cuda_core) == (2, 2)


@pytest.mark.parametrize("form", ["dense", "grouped"])
def test_s8_route_splits_k_past_the_limb_range(stubbed_launch, form):
    """K > 65536 reaches the s8 kernel (there is no refusal and no
    reroute), and the launcher's split-K rule never hands one split more
    than 65536 of K, whatever the grid and the card: the split each limb
    product stays exact over."""
    plan = make_plan(4, 32)
    K = K_MAX + 1
    lead = (4, 1) if form == "dense" else (4, 2, 1)
    experts = () if form == "dense" else (2,)
    c = torch.zeros((*lead, K), dtype=torch.int32)
    gp = torch.zeros((*experts, -(-K // 4), 2), dtype=torch.int32)
    fn = (emm.entangled_matmul_cuda if form == "dense"
          else emmg.entangled_matmul_grouped_cuda)
    fn(c, gp, plan, packed=True)
    assert stubbed_launch == [("s8", True)]
    mod = emm if form == "dense" else emmg
    assert (mod.launches_s8, mod.launches_cuda_core) == (1, 0)
    for K in (64, K_MAX, K_MAX + 1, K_MAX + 4, 2 * K_MAX + 1, 10**6):
        for n_tiles, sms in ((1, 132), (64, 132), (10**4, 132), (3, 1)):
            splits, chunk = emm._split_k(n_tiles, K, 64, sms, emm.S8_MAX_K)
            assert chunk % 64 == 0 and chunk <= K_MAX
            assert (splits - 1) * chunk < K <= splits * chunk


def test_s8_rows_per_block_fit_the_pair_groups():
    """The s8 kernel's rows per block: one group of 8 (stream, row) pairs
    when the rows fit, else two; never more rows than the expert has."""
    for ns in range(2, 9):
        for Cg in (1, 2, 3, 5, 17, 64):
            bb = emm._s8_rows_per_block(Cg, ns)
            assert 1 <= bb <= Cg and ns * bb <= 16 and (ns + 1) * bb <= 24
            if ns * Cg <= 8:
                assert bb == Cg
