"""The hand-written CUDA kernel against its plain version, on the GPU.

Marked ``requires_cuda``: it skips without a CUDA device (the kernel has
no CPU mode). It imports no JAX, so it also runs on a GPU machine that has
only PyTorch (``--noconftest`` skips the suite's JAX cache fixture):

    PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.plan import make_plan
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels.codec import pack_int8

PLANS = [(3, 16, None), (4, 32, None), (3, 32, "dualword"), (8, 32, None)]
MODES = (False, True, "chain", "chain_final")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,w,temp", PLANS)
def test_cuda_kernel_matches_plain(cuda_device, M, w, temp):
    """Kernel == plain version bit for bit for every mode, packing and
    failed stream, on ragged and split-K shapes; one launch per call."""
    plan = make_plan(M, w, temp=temp)
    for (B, K, N) in ((6, 13, 9), (17, 70, 300), (3, 2049, 257)):
        rng = np.random.default_rng(B * K + N)
        c = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(M, B, K), dtype=np.int64).astype(np.int32))
        g = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(K, N), dtype=np.int64).astype(np.int32))
        gp = pack_int8(torch.from_numpy(
            rng.integers(-128, 128, size=(K, N)).astype(np.int32)), axis=0)
        c = c.to(cuda_device)
        before = emm.launches
        for packed, gg in ((False, g), (True, gp)):
            gg = gg.contiguous().to(cuda_device)
            for mode in MODES:
                for r in [None] + list(range(M)):
                    kw = dict(fuse_epilogue=mode, failed=r, packed=packed)
                    got = emm.entangled_matmul_cuda(c, gg, plan, **kw)
                    want = emm.entangled_matmul_plain(c, gg, plan, **kw)
                    torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert emm.launches == before + 2 * len(MODES) * (M + 1)


@pytest.mark.requires_cuda
def test_cuda_kernel_rejects_bad_inputs(cuda_device):
    plan = make_plan(4, 32)
    c = torch.zeros((4, 2, 8), dtype=torch.int32, device=cuda_device)
    g = torch.zeros((8, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        emm.entangled_matmul_cuda(c.float(), g, plan)
    with pytest.raises(ValueError, match="contiguous"):
        emm.entangled_matmul_cuda(c.transpose(1, 2), g.T.contiguous(), plan)
    with pytest.raises(ValueError, match="depth"):
        emm.entangled_matmul_cuda(c, g, plan, packed=True)
