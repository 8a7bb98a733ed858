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
# (D = 1, K_f = 4500, several tap chunks) over a short ragged stream
CONV_SHAPES = [(3, 5, 37, 1), (2, 7, 1500, 4), (2, 1, 5003, 4500)]


@pytest.mark.requires_cuda
def test_cuda_conv1d_matches_plain(cuda_device):
    """The plain conv kernel == its plain version bit for bit on full-range
    words; one launch per call."""
    for (B, D, T, kf) in CONV_SHAPES:
        rng = np.random.default_rng(B * T + kf)
        x, w = _full(rng, (B, D, T), cuda_device), _full(rng, (D, kf),
                                                         cuda_device)
        before = kconv.launches
        got = kconv.conv1d_causal_cuda(x, w)
        assert kconv.launches == before + 1
        torch.testing.assert_close(got, kconv.conv1d_causal_plain(x, w),
                                   rtol=0, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,w", CODEC_PLANS)
def test_cuda_entangled_conv1d_matches_plain(cuda_device, M, w):
    """The entangled conv kernel == its plain version bit for bit, both
    modes, packed and unpacked taps, every failed stream, K_f = 1, 4 and
    4500; the poison check (the unfused outputs with stream r overwritten
    by GARBAGE disentangle to the fused result); one launch per call."""
    plan = make_plan(M, w)
    for (B, D, T, kf) in CONV_SHAPES:
        rng = np.random.default_rng(M * T + kf + w)
        x = _full(rng, (M, B, D, T), cuda_device)
        w8 = torch.from_numpy(rng.integers(-128, 128, size=(D, kf)).astype(
            np.int32))
        for packed, taps in ((False, _full(rng, (D, kf), cuda_device)),
                             (True, pack_int8(w8, axis=0).to(cuda_device))):
            before = kecv.launches
            delta = kecv.entangled_conv1d_cuda(x, taps, plan, packed=packed)
            want = kecv.entangled_conv1d_plain(x, taps, plan, packed=packed)
            torch.testing.assert_close(delta, want, rtol=0, atol=0)
            for r in range(M):
                got = kecv.entangled_conv1d_cuda(x, taps, plan,
                                                 fuse_epilogue=True, failed=r,
                                                 packed=packed)
                torch.testing.assert_close(
                    got, disentangle(want, plan, failed=r), rtol=0, atol=0)
                bad = delta.clone()
                bad[r] = GARBAGE
                torch.testing.assert_close(got, disentangle(bad, plan,
                                                            failed=r),
                                           rtol=0, atol=0)
            assert kecv.launches == before + 1 + M
        if kf < 100:  # the plain fused version itself, short filters
            got = kecv.entangled_conv1d_cuda(x, taps, plan, fuse_epilogue=True,
                                             failed=M - 1, packed=True)
            torch.testing.assert_close(got, kecv.entangled_conv1d_plain(
                x, taps, plan, fuse_epilogue=True, failed=M - 1, packed=True),
                rtol=0, atol=0)


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
