"""The hand-written CUDA kernels (the dense and the grouped entangled
GEMM, the standalone entangle, disentangle and checksum passes, the plain
and the entangled depthwise causal conv1d) against their plain versions, on
the GPU.

Marked ``requires_cuda``: it skips without a CUDA device (the kernels have
no CPU mode). It imports no JAX, so it also runs on a GPU machine that has
only PyTorch (``--noconftest`` skips the suite's JAX cache fixture):

    PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.entangle import disentangle
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import make_plan
from repro_torch.kernels import checksum as kcks
from repro_torch.kernels import conv1d as kconv
from repro_torch.kernels import disentangle as kdis
from repro_torch.kernels import entangle as kent
from repro_torch.kernels import entangled_conv1d as kecv
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import entangled_matmul_grouped as emmg
from repro_torch.kernels.codec import pack_int8

MODES = (False, True, "chain", "chain_final")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _routes(mod, packed):
    """(name, launch function, counter name) of every kernel that takes
    the call: the wrapper (``*_cuda``), which sends packed weights to the
    s8 kernel and unpacked ones to the CUDA-core kernel, and the CUDA-core
    kernel called directly on either form."""
    grouped = mod is emmg
    core = (emmg.entangled_matmul_grouped_cuda_core if grouped
            else emm.entangled_matmul_cuda_core)
    wrapper = (emmg.entangled_matmul_grouped_cuda if grouped
               else emm.entangled_matmul_cuda)
    return [("s8" if packed else "cuda_core", wrapper,
             "launches_s8" if packed else "launches_cuda_core"),
            ("cuda_core direct", core, "launches_cuda_core")]


def _counts(mod):
    return {"launches_s8": mod.launches_s8,
            "launches_cuda_core": mod.launches_cuda_core}


# every stream count, with its int32 (w = 16) and dual-word (w = 32) plan
GPU_PLANS = [(M, w, None) for M in range(3, 9) for w in (16, 32)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,w,temp", GPU_PLANS)
def test_cuda_kernel_matches_plain(cuda_device, M, w, temp):
    """Each kernel == plain version bit for bit for every mode, packing
    and failed stream, on ragged and split-K shapes (N = 257, K = 2049
    among them) with full-range int32 activations: the CUDA-core kernel
    on both weight forms, the s8 kernel on packed weights (through the
    wrapper, which routes by ``packed``). One launch per call, counted on
    its route."""
    plan = make_plan(M, w, temp=temp)
    for (B, K, N) in ((6, 13, 9), (17, 70, 300), (3, 2049, 257),
                      (2, 512, 260)):
        rng = np.random.default_rng(B * K + N)
        c = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(M, B, K), dtype=np.int64).astype(np.int32))
        g = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(K, N), dtype=np.int64).astype(np.int32))
        gp = pack_int8(torch.from_numpy(
            rng.integers(-128, 128, size=(K, N)).astype(np.int32)), axis=0)
        c = c.to(cuda_device)
        for packed, gg in ((False, g), (True, gp)):
            gg = gg.contiguous().to(cuda_device)
            for name, fn, counter in _routes(emm, packed):
                before = _counts(emm)
                for mode in MODES:
                    for r in [None] + list(range(M)):
                        kw = dict(fuse_epilogue=mode, failed=r, packed=packed)
                        got = fn(c, gg, plan, **kw)
                        want = emm.entangled_matmul_plain(c, gg, plan, **kw)
                        torch.testing.assert_close(
                            got, want, rtol=0, atol=0,
                            msg=lambda m: f"{name} {(B, K, N)}: {m}")
                before[counter] += len(MODES) * (M + 1)
                assert _counts(emm) == before


@pytest.mark.requires_cuda
def test_cuda_kernel_rejects_bad_inputs(cuda_device):
    plan = make_plan(4, 32)
    c = torch.zeros((4, 2, 8), dtype=torch.int32, device=cuda_device)
    g = torch.zeros((8, 3), dtype=torch.int32, device=cuda_device)
    gp = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        emm.entangled_matmul_cuda(c.float(), g, plan)
    with pytest.raises(ValueError, match="contiguous"):
        emm.entangled_matmul_cuda(c.transpose(1, 2), g.T.contiguous(), plan)
    with pytest.raises(ValueError, match="depth"):
        emm.entangled_matmul_cuda(c, g, plan, packed=True)
    # the s8 route: dtype, device (any K goes: see the test below)
    with pytest.raises(TypeError):
        emm.entangled_matmul_cuda(c, gp.to(torch.int8), plan, packed=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        emm.entangled_matmul_cuda(c, gp.cpu(), plan, packed=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", [65540, 131073])
def test_cuda_s8_kernel_past_the_limb_range(cuda_device, K):
    """K deeper than one limb product's 65536: the s8 kernel splits K into
    chunks of at most 65536 and equals its plain version bit for bit,
    dense and grouped, both modes, every failed stream, full-range
    activations and one launch per call."""
    plan = make_plan(4, 32)
    rng = np.random.default_rng(K)
    for form in ("dense", "grouped"):
        lead = (4, 1) if form == "dense" else (4, 3, 1)
        experts = () if form == "dense" else (3,)
        c = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(*lead, K), dtype=np.int64).astype(np.int32))
        g8 = torch.from_numpy(rng.integers(
            -128, 128, size=(*experts, K, 4)).astype(np.int32))
        gp = pack_int8(g8, axis=len(experts)).contiguous().to(cuda_device)
        c = c.to(cuda_device)
        mod = emm if form == "dense" else emmg
        fn, plain = ((emm.entangled_matmul_cuda, emm.entangled_matmul_plain)
                     if form == "dense" else
                     (emmg.entangled_matmul_grouped_cuda,
                      emmg.entangled_matmul_grouped_plain))
        before = mod.launches_s8
        for mode in (True, False):
            for r in [None] + list(range(4)):
                kw = dict(fuse_epilogue=mode, failed=r, packed=True)
                torch.testing.assert_close(
                    fn(c, gp, plan, **kw), plain(c, gp, plan, **kw),
                    rtol=0, atol=0, msg=lambda m: f"{form} K={K}: {m}")
        assert mod.launches_s8 == before + 10


def _grouped_operands(rng, M, E, Cg, K, N, dev):
    """Full-range int32 c and g, and packed int8 weights, on ``dev``; the
    rows of every third expert from the second on are zero (an expert no
    token was routed to, between occupied ones)."""
    c = rng.integers(-2**31, 2**31, size=(M, E, Cg, K), dtype=np.int64)
    c[:, 1::3] = 0
    g = rng.integers(-2**31, 2**31, size=(E, K, N), dtype=np.int64)
    g8 = rng.integers(-128, 128, size=(E, K, N)).astype(np.int32)
    return (torch.from_numpy(c.astype(np.int32)).to(dev),
            torch.from_numpy(g.astype(np.int32)).to(dev),
            pack_int8(torch.from_numpy(g8), axis=1).contiguous().to(dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,w,temp", GPU_PLANS)
def test_cuda_grouped_kernel_matches_plain(cuda_device, M, w, temp):
    """Each grouped kernel == plain version bit for bit for both modes,
    packing and every failed stream, on ragged shapes (split-K among them)
    and the deepseek-v2-lite decode shape, with empty experts between
    occupied ones; one launch per call, counted on its route; the poison
    check (the fused kernel with failed=r equals the plain disentangle of
    the unfused output with stream r overwritten by GARBAGE) for every r
    and both kernels."""
    plan = make_plan(M, w, temp=temp)
    shapes = [(3, 5, 13, 9), (2, 17, 70, 300), (4, 1, 2049, 257),
              (64, 2, 2048, 1408)]
    for (E, Cg, K, N) in shapes:
        rng = np.random.default_rng(E * Cg + K + N)
        c, g, gp = _grouped_operands(rng, M, E, Cg, K, N, cuda_device)
        for packed, gg in ((False, g), (True, gp)):
            for name, fn, counter in _routes(emmg, packed):
                before = _counts(emmg)
                for mode in (False, True):
                    for r in ([None] + list(range(M)) if mode else [None]):
                        kw = dict(fuse_epilogue=mode, failed=r, packed=packed)
                        got = fn(c, gg, plan, **kw)
                        want = emmg.entangled_matmul_grouped_plain(
                            c, gg, plan, **kw)
                        torch.testing.assert_close(
                            got, want, rtol=0, atol=0,
                            msg=lambda m: f"{name} {(E, Cg, K, N)}: {m}")
                before[counter] += M + 2
                assert _counts(emmg) == before
        for name, fn, _ in _routes(emmg, True):
            delta = fn(c, gp, plan, packed=True)
            for r in range(M):
                fused = fn(c, gp, plan, fuse_epilogue=True, failed=r,
                           packed=True)
                bad = delta.clone()
                bad[r] = GARBAGE
                torch.testing.assert_close(
                    fused, disentangle(bad, plan, failed=r), rtol=0, atol=0)


@pytest.mark.requires_cuda
def test_cuda_grouped_kernel_rejects_bad_inputs(cuda_device):
    plan = make_plan(4, 32)
    c = torch.zeros((4, 3, 2, 8), dtype=torch.int32, device=cuda_device)
    g = torch.zeros((3, 8, 5), dtype=torch.int32, device=cuda_device)
    gp = torch.zeros((3, 2, 5), dtype=torch.int32, device=cuda_device)
    for mode in ("chain", "chain_final"):
        with pytest.raises(ValueError, match="True or False"):
            emmg.entangled_matmul_grouped_cuda(c, g, plan, fuse_epilogue=mode)
        with pytest.raises(ValueError, match="True or False"):
            emmg.entangled_matmul_grouped_cuda(c, gp, plan,
                                               fuse_epilogue=mode,
                                               packed=True)
    with pytest.raises(ValueError, match="experts"):
        emmg.entangled_matmul_grouped_cuda(c, g[:2].contiguous(), plan)
    with pytest.raises(ValueError, match="depth"):
        emmg.entangled_matmul_grouped_cuda(c, g, plan, packed=True)
    with pytest.raises(ValueError, match="axes"):
        emmg.entangled_matmul_grouped_cuda(c[0], g, plan)
    # the s8 route: dtype, device (any K goes)
    with pytest.raises(TypeError):
        emmg.entangled_matmul_grouped_cuda(c.to(torch.int64), gp, plan,
                                           packed=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        emmg.entangled_matmul_grouped_cuda(c.cpu(), gp, plan, packed=True)


@pytest.mark.requires_cuda
def test_engine_on_the_default_device(cuda_device):
    """Params made on the default device ("cuda") serve in an engine built
    on the default device: both resolve to the current card's index."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    assert resolve_device() == resolve_device("cuda") == torch.device(
        "cuda", torch.cuda.current_device())
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    params = get_model(cfg).init(torch.Generator("cuda").manual_seed(0), cfg,
                                 max_seq=16)
    eng = ServeEngine(cfg, ServeConfig(max_seq=16, ft_mode="entangle",
                                       ft_scope="moe"), params)
    eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new=3))
    assert len(eng.run_to_completion()[0].out) == 3


CODEC_PLANS = [(M, 32) for M in range(3, 9)] + [(3, 16), (4, 16)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,w", CODEC_PLANS)
def test_cuda_entangle_disentangle_match_plain(cuda_device, M, w):
    """The entangle and disentangle passes == their plain versions bit for
    bit on full-range words, ragged N, every r; the poison check (row r
    overwritten by GARBAGE gives the healthy result); one launch per
    call."""
    plan = make_plan(M, w)
    for n in (1, 2, 3, 1023, 1025, 65537):
        rng = np.random.default_rng(M * n + w)
        c = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(M, n), dtype=np.int64).astype(np.int32)
        ).to(cuda_device)
        before = (kent.launches, kdis.launches)
        eps = kent.entangle_cuda(c, plan)
        torch.testing.assert_close(eps, kent.entangle_plain(c, plan),
                                   rtol=0, atol=0)
        for r in range(M):
            got = kdis.disentangle_cuda(eps, plan, r)
            torch.testing.assert_close(got, kdis.disentangle_plain(eps, plan, r),
                                       rtol=0, atol=0)
            bad = eps.clone()
            bad[r] = GARBAGE
            torch.testing.assert_close(kdis.disentangle_cuda(bad, plan, r),
                                       got, rtol=0, atol=0)
        assert (kent.launches, kdis.launches) == (before[0] + 1,
                                                  before[1] + 2 * M)


@pytest.mark.requires_cuda
def test_cuda_codec_passes_reject_bad_inputs(cuda_device):
    plan = make_plan(4, 32)
    c = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    for fn in (lambda x: kent.entangle_cuda(x, plan),
               lambda x: kdis.disentangle_cuda(x, plan, 1)):
        with pytest.raises(TypeError):
            fn(c.float())
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((8, 4), dtype=torch.int32,
                           device=cuda_device).T)
        with pytest.raises(ValueError, match="M=4"):
            fn(c[:3])
        with pytest.raises(ValueError, match="CUDA"):
            fn(c.cpu())


def _full(rng, shape, dev):
    return torch.from_numpy(rng.integers(
        -2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)).to(dev)


# (B, D, T, K_f): ragged depthwise shapes, K_f = 1, and a stream-conv filter
# (D = 1, K_f = 4500, several tap chunks of the CUDA-core route) over a
# short ragged stream; then the s8 route's edges: T one short of its
# 512-output tile at K_f = its 64-output row block, T one past its
# 3072-output tile at K_f one past the row block, K_f one past its 4608-tap
# chunk
CONV_SHAPES = [(3, 5, 37, 1), (2, 7, 1500, 4), (2, 1, 5003, 4500),
               (1, 2, 511, 64), (1, 1, 3073, 65), (1, 1, 2000, 4609)]
CONV_ROUTES = {"s8": "launches_s8", "cuda_core": "launches_cuda_core"}


def _conv_counts(mod, route):
    return mod.launches, getattr(mod, CONV_ROUTES[route])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", list(CONV_ROUTES))
def test_cuda_conv1d_matches_plain(cuda_device, route):
    """The plain conv kernel of each route == its plain version bit for bit
    on full-range words, with full-range taps (all four s8 tap limbs) and
    one-byte taps; one launch per call, counted on its route."""
    for (B, D, T, kf) in CONV_SHAPES:
        rng = np.random.default_rng(B * T + kf)
        x = _full(rng, (B, D, T), cuda_device)
        w8 = torch.from_numpy(rng.integers(-128, 128, size=(D, kf)).astype(
            np.int32)).to(cuda_device)
        for w in (_full(rng, (D, kf), cuda_device), w8):
            total, per = _conv_counts(kconv, route)
            got = kconv.conv1d_causal_cuda(x, w, route=route)
            assert _conv_counts(kconv, route) == (total + 1, per + 1)
            torch.testing.assert_close(got, kconv.conv1d_causal_plain(x, w),
                                       rtol=0, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", list(CONV_ROUTES))
@pytest.mark.parametrize("M,w", CODEC_PLANS)
def test_cuda_entangled_conv1d_matches_plain(cuda_device, M, w, route):
    """The entangled conv kernel of each route == its plain version bit for
    bit, both modes, packed and unpacked (full-range) taps, every failed
    stream, at every shape of CONV_SHAPES; the poison check (the unfused
    outputs with stream r overwritten by GARBAGE disentangle to the fused
    result); one launch per call, counted on its route."""
    plan = make_plan(M, w)
    for (B, D, T, kf) in CONV_SHAPES:
        rng = np.random.default_rng(M * T + kf + w)
        x = _full(rng, (M, B, D, T), cuda_device)
        w8 = torch.from_numpy(rng.integers(-128, 128, size=(D, kf)).astype(
            np.int32))
        for packed, taps in ((False, _full(rng, (D, kf), cuda_device)),
                             (True, pack_int8(w8, axis=0).to(cuda_device))):
            total, per = _conv_counts(kecv, route)
            delta = kecv.entangled_conv1d_cuda(x, taps, plan, packed=packed,
                                               route=route)
            want = kecv.entangled_conv1d_plain(x, taps, plan, packed=packed)
            torch.testing.assert_close(delta, want, rtol=0, atol=0)
            for r in range(M):
                got = kecv.entangled_conv1d_cuda(x, taps, plan,
                                                 fuse_epilogue=True, failed=r,
                                                 packed=packed, route=route)
                torch.testing.assert_close(
                    got, disentangle(want, plan, failed=r), rtol=0, atol=0)
                bad = delta.clone()
                bad[r] = GARBAGE
                torch.testing.assert_close(got, disentangle(bad, plan,
                                                            failed=r),
                                           rtol=0, atol=0)
            assert _conv_counts(kecv, route) == (total + 1 + M, per + 1 + M)
        if kf < 100:  # the plain fused version itself, short filters
            got = kecv.entangled_conv1d_cuda(x, taps, plan, fuse_epilogue=True,
                                             failed=M - 1, packed=True,
                                             route=route)
            torch.testing.assert_close(got, kecv.entangled_conv1d_plain(
                x, taps, plan, fuse_epilogue=True, failed=M - 1, packed=True),
                rtol=0, atol=0)


@pytest.mark.requires_cuda
def test_cuda_conv_route_none_follows_the_rule(cuda_device):
    """route=None launches the route of kconv.route_for, on both convs."""
    plan = make_plan(4, 32)
    for kf in (4, kconv.S8_MIN_KF_PLAIN, kconv.S8_MIN_KF - 1, kconv.S8_MIN_KF,
               4500):
        rng = np.random.default_rng(kf)
        x = _full(rng, (4, 1, 1, 6000), cuda_device)
        w = _full(rng, (1, kf), cuda_device)
        route = kconv.route_for(kf, 6000)
        before = _conv_counts(kconv, route)
        got = kconv.conv1d_causal_cuda(x[0], w)
        assert _conv_counts(kconv, route) == tuple(n + 1 for n in before)
        torch.testing.assert_close(got, kconv.conv1d_causal_plain(x[0], w),
                                   rtol=0, atol=0)
        route = kconv.route_for(kf, 6000, entangled=True)
        before = _conv_counts(kecv, route)
        got = kecv.entangled_conv1d_cuda(x, w, plan, fuse_epilogue=True,
                                         failed=2)
        assert _conv_counts(kecv, route) == tuple(n + 1 for n in before)
        torch.testing.assert_close(got, kecv.entangled_conv1d_plain(
            x, w, plan, fuse_epilogue=True, failed=2), rtol=0, atol=0)


@pytest.mark.requires_cuda
def test_cuda_checksum_matches_plain(cuda_device):
    for (m, n) in ((1, 5), (3, 1031), (8, 65537), (9, 1000003)):
        c = _full(np.random.default_rng(m * n), (m, n), cuda_device)
        before = kcks.launches
        got = kcks.checksum_cuda(c)
        assert kcks.launches == before + 1
        torch.testing.assert_close(got, kcks.checksum_plain(c), rtol=0,
                                   atol=0)


@pytest.mark.requires_cuda
def test_cuda_conv_kernels_reject_bad_inputs(cuda_device):
    plan = make_plan(4, 32)
    x = torch.zeros((4, 2, 3, 16), dtype=torch.int32, device=cuda_device)
    w = torch.zeros((3, 5), dtype=torch.int32, device=cuda_device)
    econv = lambda xx, ww, **kw: kecv.entangled_conv1d_cuda(  # noqa: E731
        xx, ww, plan, **kw)
    for fn, xx in ((kconv.conv1d_causal_cuda, x[0]), (econv, x)):
        with pytest.raises(TypeError):
            fn(xx.float(), w)
        with pytest.raises(ValueError, match="CUDA"):
            fn(xx.cpu(), w)
        with pytest.raises(ValueError, match="contiguous"):
            fn(xx.transpose(-1, -2), w)
        with pytest.raises(ValueError, match="depth"):
            fn(xx, w[:2].contiguous())
        with pytest.raises(ValueError, match="axes"):
            fn(xx[0], w)
    with pytest.raises(ValueError, match="streams"):
        econv(x[:3].contiguous(), w)
    with pytest.raises(ValueError, match="depth"):
        econv(x, w, packed=True)
    with pytest.raises(ValueError, match="fuse_epilogue"):
        econv(x, w, fuse_epilogue="chain")
    with pytest.raises(ValueError, match="route"):
        econv(x, w, route="tensor")
    with pytest.raises(ValueError, match="route"):
        kconv.conv1d_causal_cuda(x[0], w, route="tensor")
    c = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kcks.checksum_cuda(c.float())
    with pytest.raises(ValueError, match="contiguous"):
        kcks.checksum_cuda(c.T)
    with pytest.raises(ValueError, match="CUDA"):
        kcks.checksum_cuda(c.cpu())
    with pytest.raises(ValueError, match="M >= 1"):
        kcks.checksum_cuda(c[0])


@pytest.mark.requires_cuda
def test_bf16_dense_rows_do_not_depend_on_the_call(cuda_device):
    """The unprotected bf16 projections give a row the same bits whatever
    the other rows of the call (the chunked, packed and whole-bucket
    prefills send one prompt's tokens in calls of 64 to 2048 rows), at
    llama3.2-1b's projection shapes, mlp.down's deep K = 8192 included."""
    from repro_torch.models.layers import dense

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
        p = {"w": torch.randn(K, N, generator=gen, device=cuda_device)}
        x = torch.randn(2048, K, generator=gen, device=cuda_device)
        whole = dense(p, x)
        for rows in (8, 64, 128, 256, 300):
            torch.testing.assert_close(dense(p, x[:rows]), whole[:rows],
                                       rtol=0, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N", [128, 512])
def test_cuda_s8_kernel_narrow_projections(cuda_device, N):
    """The s8 route at the new archs' narrow projections: granite-20b's
    MQA k / v (N = 128, half of one 256-column tile) and qwen2-7b's (N =
    512), at K = 6144 / 3584, decode and prefill row counts, every mode
    and failed stream, equal to the plain version bit for bit."""
    plan = make_plan(4, 32)
    K = 6144 if N == 128 else 3584
    rng = np.random.default_rng(N)
    gp = pack_int8(torch.from_numpy(rng.integers(
        -128, 128, size=(K, N)).astype(np.int32)), axis=0)
    gp = gp.contiguous().to(cuda_device)
    for B in (2, 16):
        c = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(4, B, K), dtype=np.int64).astype(
                np.int32)).to(cuda_device)
        before = emm.launches_s8
        for mode in MODES:
            for r in [None] + list(range(4)):
                kw = dict(fuse_epilogue=mode, failed=r, packed=True)
                torch.testing.assert_close(
                    emm.entangled_matmul_cuda(c, gp, plan, **kw),
                    emm.entangled_matmul_plain(c, gp, plan, **kw),
                    rtol=0, atol=0)
        assert emm.launches_s8 == before + len(MODES) * 5


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N", [(2048, 92553), (768, 51865)])
def test_cuda_s8_kernel_odd_width_heads(cuda_device, K, N):
    """The s8 route at the two odd-width heads, internvl2-2b's [2048 x
    92553] and whisper-small's [768 x 51865]: their rows of packed words
    are not 16-byte aligned, so the kernel copies them 4 bytes at a time
    (its ragged path). Decode rows [4, 2, K], activations on the eq.-13
    grid, every mode and failed stream, equal to the plain version bit for
    bit."""
    from repro_torch.ft.quantize import activation_budget

    plan = make_plan(4, 32)
    rng = np.random.default_rng(K)
    gp = pack_int8(torch.from_numpy(rng.integers(
        -127, 128, size=(K, N)).astype(np.int32)), axis=0)
    gp = gp.contiguous().to(cuda_device)
    bud = activation_budget(plan, K)
    c = torch.from_numpy(rng.integers(-bud, bud + 1, size=(4, 2, K)).astype(
        np.int32)).to(cuda_device)
    before = emm.launches_s8
    for mode in MODES:
        for r in [None] + list(range(4)):
            kw = dict(fuse_epilogue=mode, failed=r, packed=True)
            torch.testing.assert_close(
                emm.entangled_matmul_cuda(c, gp, plan, **kw),
                emm.entangled_matmul_plain(c, gp, plan, **kw),
                rtol=0, atol=0)
    assert emm.launches_s8 == before + len(MODES) * 5


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ft", ["none", "all"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-2b"])
def test_prefill_and_decode_give_a_position_the_same_bits_on_the_card(
        cuda_device, arch, ft):
    """The fleet's prefix resume on the card: llama3.2-1b and internvl2-2b
    (its text path, with its odd-width head) at published widths (cut to
    2 layers) give the position after ``prompt + k`` generated tokens the
    same final hidden state and logits, bit for bit, decoded (the
    no-failure run) and prefilled as ``prompt + prefix`` (the resume), for
    a long and a short prompt."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = get_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, max_seq=256,
        device=cuda_device)
    kw = dict(ft_mode="none") if ft == "none" else dict(
        ft_mode="entangle", ft_scope="all")
    scfg = ServeConfig(max_batch=8, max_seq=256, ft_M=4,
                       prefill_buckets=(8, 16, 32, 64, 128), **kw)

    class Rec(ServeEngine):
        def _head_logits(self, h, mask, failed_group, ft_fn):
            logits = super()._head_logits(h, mask, failed_group, ft_fn)
            self.log.append((h[0].clone(), logits[0].clone()))
            return logits

    warm = []

    def run(prompt, max_new):
        eng = Rec(cfg, scfg, params, device=cuda_device,
                  warm=warm[0] if warm else None)
        warm[:] = [eng.warm_state()]
        eng.log = []
        h = eng.submit(Request(rid=0, prompt=prompt, max_new=max_new))
        eng.run_to_completion()
        return np.asarray(h.req.out), eng.log

    rng = np.random.default_rng(1)
    for n in (100, 7):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        out, log = run(prompt, 16)
        for k in (3, 9):
            tail, log_k = run(np.concatenate([prompt, out[:k]]), 16 - k)
            for a, b in zip(log[k], log_k[0]):
                torch.testing.assert_close(b, a, rtol=0, atol=0)
            np.testing.assert_array_equal(tail, out[k:])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("ft", ["none", "all"])
@pytest.mark.parametrize("arch,layers", [("falcon-mamba-7b", 2),
                                         ("recurrentgemma-2b", 3)])
def test_recurrent_prefill_and_decode_give_a_position_the_same_bits_on_the_card(
        cuda_device, arch, layers, ft, mode):
    """The prefix-resume pin for the recurrent families on the card, at
    published widths cut to 2 layers (recurrentgemma to 3, one whole
    (rglru, rglru, local_attn) unit, so that its rolling-window attention
    is in): the position after ``prompt + k`` generated tokens gets the
    same final hidden state and logits, bit for bit, decoded and
    prefilled as ``prompt + prefix``, under whole-bucket and chunked (32)
    admission. The conv, the scan step and the state's reductions are one
    function for both paths; the GEMMs' rows are padded so that a row's
    bits do not depend on the call."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = get_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, max_seq=256,
        device=cuda_device)
    kw = dict(ft_mode="none") if ft == "none" else dict(
        ft_mode="entangle", ft_scope="all")
    if mode == "chunked":
        kw["prefill_chunk"] = 32
    scfg = ServeConfig(max_batch=8, max_seq=256, ft_M=4,
                       prefill_buckets=(8, 16, 32, 64, 128), **kw)

    class Rec(ServeEngine):
        def _head_logits(self, h, mask, failed_group, ft_fn):
            logits = super()._head_logits(h, mask, failed_group, ft_fn)
            self.log.append((h[0].clone(), logits[0].clone()))
            return logits

    warm = []

    def run(prompt, max_new):
        eng = Rec(cfg, scfg, params, device=cuda_device,
                  warm=warm[0] if warm else None)
        warm[:] = [eng.warm_state()]
        eng.log = []
        h = eng.submit(Request(rid=0, prompt=prompt, max_new=max_new))
        eng.run_to_completion()
        return np.asarray(h.req.out), eng.log

    rng = np.random.default_rng(1)
    for n in (100, 7):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        out, log = run(prompt, 16)
        for k in (3, 9):
            tail, log_k = run(np.concatenate([prompt, out[:k]]), 16 - k)
            for a, b in zip(log[k], log_k[0]):
                torch.testing.assert_close(b, a, rtol=0, atol=0)
            np.testing.assert_array_equal(tail, out[k:])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N,dtype", [
    (4096, 16384, "bf16"), (8192, 4096, "bf16"), (8192, 288, "bf16"),
    (256, 8192, "f32"), (2560, 2560, "bf16"), (2560, 7680, "bf16"),
    (7680, 2560, "bf16"), (2560, 256, "bf16")])
def test_recurrent_projection_rows_do_not_depend_on_the_call(cuda_device, K,
                                                             N, dtype):
    """The recurrent families' unprotected projections (falcon-mamba's
    in_proj / out_proj at ft none, x_proj, and dt_proj in float32;
    recurrentgemma's) give a row the same bits in calls of 8 to 2048
    rows: every call runs as GEMMs of GEMM_ROWS rows each."""
    from repro_torch.models.layers import _rows_matmul

    gen = torch.Generator(device=cuda_device).manual_seed(K + N)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    w = torch.randn(K, N, generator=gen, device=cuda_device).to(dt)
    x = torch.randn(2048, K, generator=gen, device=cuda_device).to(dt)
    whole = _rows_matmul(x, w)
    for rows in (8, 32, 256, 300, 1024):
        torch.testing.assert_close(_rows_matmul(x[:rows], w), whole[:rows],
                                   rtol=0, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch,layers", [("deepseek-v2-lite-16b", 2),
                                         ("falcon-mamba-7b", 2),
                                         ("recurrentgemma-2b", 3)])
def test_train_step_of_the_families_on_the_card(cuda_device, arch, layers):
    """One train step's gradient sync at published widths cut to 2 layers
    (deepseek: the dense first layer and one MoE layer; recurrentgemma: 3,
    one whole unit with its local attention), batch 2 x 128 (Mamba's scan
    in checkpointed chunks): the synced gradients of one backward on the
    kernel codec equal the plain codec's and, with any block failed, the
    healthy sync's, bit for bit, and so do the AdamW updates; the codec
    kernels launched."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train.train_step import (TrainConfig, apply_grads,
                                              init_state, loss_and_grads,
                                              sync_grads)
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    tcfg = TrainConfig(max_seq=128, grad_sync="entangle", grad_codec="kernel")
    state = init_state(torch.Generator(device=cuda_device).manual_seed(0),
                       cfg, tcfg, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    loss, grads = loss_and_grads(cfg, state["params"], {"tokens": tokens})
    assert torch.isfinite(loss)
    before = (kent.launches, kdis.launches)
    with torch.no_grad():
        healthy, _ = sync_grads(grads, tcfg)
        assert kent.launches > before[0] and kdis.launches > before[1]
        plain, _ = sync_grads(grads, dataclasses.replace(tcfg,
                                                         grad_codec="plain"))
        for a, b in zip(leaves(healthy), leaves(plain)):
            assert torch.equal(a, b)
        del plain
        for fb in range(tcfg.ft_M):
            synced, diag = sync_grads(grads, tcfg, fb)
            assert diag["ne_failed"] == fb
            for a, b in zip(leaves(healthy), leaves(synced)):
                assert torch.equal(a, b)
    new_h = apply_grads(state, healthy, cfg, tcfg)
    new_f = apply_grads(state, synced, cfg, tcfg)
    for a, b in zip(leaves(new_h), leaves(new_f)):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,window", [("causal", 0), ("window", 300),
                                         ("full", 0)])
def test_flash_backward_matches_materialized_on_the_card(cuda_device, kind,
                                                         window):
    """tests/test_torch_loss.py's check on the card: the blocked
    attention's forward and backward (T = 1030 queries from position 60
    against 1100 keys, the last 10 masked off) against autograd through
    the materialized scores, bfloat16 q / k / v; the outputs within 2e-6
    and the bfloat16 gradients within one bf16 ulp."""
    from repro_torch.models import attention_core as AC

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device)
               .to(torch.bfloat16).requires_grad_()
               for s in ((1, 2, 2, 1030, 16), (1, 2, 1100, 16),
                         (1, 2, 1100, 24)))
    dout = torch.randn((1, 2, 2, 1030, 24), generator=gen,
                       device=cuda_device)
    kw = dict(kind=kind, window=window, kv_len=1090, q_off=60)
    out = AC.attend(q, k, v, **kw)
    g = torch.autograd.grad(out, (q, k, v), dout)
    ok = AC._mask(AC.MaskInfo(kind, 1090, 60, window), 1030, 1100,
                  cuda_device)
    want_out = AC._softmax_block(q, k, v, ok, 1 / 4.0)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    torch.testing.assert_close(out, want_out, rtol=0, atol=2e-6)
    for a, b in zip(g, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T", [40, 128])
def test_mamba_train_and_prefill_give_a_position_the_same_bits_on_the_card(
        cuda_device, T):
    """falcon-mamba-7b's mixer at published widths, one layer: train mode
    (no cache; at T = 128 the scan in checkpointed chunks of 64, under
    autograd through the input) and a fresh prefill give every position
    the same bits; the per-step formula and order are one function. (A
    training forward whose WEIGHTS are under autograd runs each projection
    as one GEMM, which serving never reproduces: tests/test_torch_cuda.py
    pins the serving GEMMs' rows.)"""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as TL
    from repro_torch.models.transformer import layer_views

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=1)
    params = get_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, max_seq=T,
        device=cuda_device)
    p = layer_views(params["stack"][0][0], 1)[0]
    cache = layer_views(TL.init_mamba_cache(cfg, 1, 2, T, cuda_device), 1)[0]
    x = torch.randn((2, T, cfg.d_model), device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(
                        1)).to(torch.bfloat16).requires_grad_()
    got = TL.apply_mamba(p, x, cfg=cfg, cache=None, pos=None, mode="train")
    with torch.no_grad():
        want = TL.apply_mamba(p, x, cfg=cfg, cache=cache, pos=0,
                              mode="prefill")
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    (gx,) = torch.autograd.grad(got.float().sum(), x)
    assert torch.isfinite(gx.float()).all()


@pytest.mark.requires_cuda
def test_v3_smoke_engine_rolls_forward_on_the_card(cuda_device):
    """deepseek-v3's smoke config (low-rank-Q MLA, 8 experts with sigmoid
    gating, the MTP subtree built and never quantized) served at scope all
    with bf16 masters: failed_group=1 on every step gives the healthy
    tokens, and both GEMM kernels launched on their s8 route."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_smoke_config("deepseek-v3-671b")
    params = get_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, 32,
        device=cuda_device, master_dtype=torch.bfloat16)
    scfg = ServeConfig(max_batch=8, max_seq=32, ft_mode="entangle", ft_M=4,
                       ft_scope="all")
    before = (emm.launches_s8, emmg.launches_s8)
    outs = []
    for fg in (None, 1):
        eng = ServeEngine(cfg, scfg, params, device=cuda_device)
        assert "q8" not in str(eng.ft_params["mtp"])
        rng = np.random.default_rng(0)
        for r in range(8):
            eng.submit(Request(rid=r, max_new=6, prompt=rng.integers(
                0, cfg.vocab_size, size=8).astype(np.int32)))
        outs.append({q.rid: np.asarray(q.out)
                     for q in eng.run_to_completion(failed_group=fg)})
        assert eng.plans.misses == 0
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[1][rid], outs[0][rid])
    assert emm.launches_s8 > before[0] and emmg.launches_s8 > before[1]


@pytest.mark.requires_cuda
def test_v3_smoke_train_step_on_the_card(cuda_device):
    """One deepseek-v3 smoke train step (the MTP head and its 0.3-weighted
    loss term, the low-rank Q) on the card: the synced gradients of one
    backward on the kernel codec equal the plain codec's, bit for bit,
    including the MTP leaves, and the codec kernels launched."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              loss_and_grads, sync_grads)
    from repro_torch.tree import leaves_with_path

    cfg = get_smoke_config("deepseek-v3-671b")
    tcfg = TrainConfig(max_seq=64, grad_sync="entangle", grad_codec="kernel")
    state = init_state(torch.Generator(device=cuda_device).manual_seed(0),
                       cfg, tcfg, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    loss, grads = loss_and_grads(cfg, state["params"], {"tokens": tokens})
    assert torch.isfinite(loss)
    before = (kent.launches, kdis.launches)
    with torch.no_grad():
        kern, _ = sync_grads(grads, tcfg)
        assert kent.launches > before[0] and kdis.launches > before[1]
        plain, _ = sync_grads(grads, dataclasses.replace(tcfg,
                                                         grad_codec="plain"))
    paths = [p for p, _ in leaves_with_path(kern)]
    assert any(p.startswith("['mtp']") for p in paths)
    for (p, a), (_, b) in zip(leaves_with_path(kern),
                              leaves_with_path(plain)):
        assert torch.equal(a, b), p


@pytest.mark.requires_cuda
def test_sdc_on_the_card_matches_the_cpu(cuda_device):
    """``sdc.detect`` and ``sdc.localize`` on card tensors (their
    disentangle passes through the CUDA kernel, which launches) equal the
    same calls on the CPU."""
    from repro_torch.core import entangle, sdc

    plan = make_plan(4, 32)
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.integers(-1000, 1000, size=(4, 4096)).astype(
        np.int32))
    delta = entangle(c, plan)
    for j, pos, mag in ((0, 17, 1), (2, 100, 123456789), (3, 4095, 255)):
        bad = delta.clone()
        bad[j, pos] += mag
        before = kdis.launches
        det = sdc.detect(bad.to(cuda_device), plan)
        loc = sdc.localize(bad.to(cuda_device), plan)
        assert kdis.launches - before == 3 * plan.M
        assert det.is_cuda and loc.is_cuda
        assert torch.equal(det.cpu(), sdc.detect(bad, plan))
        assert torch.equal(loc.cpu(), sdc.localize(bad, plan))
        assert bool(det[pos]) and int(det.sum()) == 1
