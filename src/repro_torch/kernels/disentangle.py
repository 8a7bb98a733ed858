"""Standalone disentangle (fail-stop recovery) pass: the CUDA kernel's
wrapper, its plain PyTorch version, and the kernel's launch counter.

Replaces the Pallas TPU kernel ``repro/kernels/disentangle.py``
(``disentangle_pallas``, body ``_disentangle_kernel``): recover all M
streams from the entangled rows of ``delta [M, N]`` without reading row
``r`` (paper eq. 16-19: Horner telescoping, the sign-extended bit-field
split of d_r / d_q, the eq. (19) chain), in one 32-bit word or a dual-word
temporary as ``plan.temp`` says.

The kernel (``csrc/codec_pass.cu``, the arithmetic of ``csrc/codec.cuh``
that the fused GEMM's epilogue shares) is CUDA C++ for ``sm_90a``, in one
library with :mod:`.entangle`. What bounds it on an H100: device-memory
bytes — it reads the M-1 rows ``(r+1+j) mod M`` (row r is never loaded)
and writes all M rows, one column per thread in a grid-stride loop that
masks the ragged end of N.

:func:`disentangle_cuda` launches the kernel on a CUDA tensor and raises on
anything it does not take; :func:`disentangle_plain` is the plain version,
used for CPU tensors and as the kernel's yardstick on the card.
``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import entangle as _ent
from repro_torch.kernels.codec import disentangle_block

# one library with the entangle pass (one source, one build)
build = _ent.build

# kernel launches since import (or the last reset by the caller)
launches = 0


def disentangle_plain(delta: torch.Tensor, plan: EntanglePlan,
                      r: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``delta [M, N]`` int -> ``[M, N]`` int32 in
    stream order, never reading row ``r``; on any device, bit-identical to
    the kernel and to the reference's Pallas kernel."""
    if delta.shape[0] != plan.M:
        raise ValueError(f"delta has {delta.shape[0]} streams, "
                         f"plan.M={plan.M}")
    return disentangle_block(delta, plan, r % plan.M)


def disentangle_cuda(delta: torch.Tensor, plan: EntanglePlan,
                     r: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on ``delta [M, N]`` int32, contiguous on a
    CUDA device; row ``r`` (taken mod M) is never read. Returns ``[M, N]``
    int32 on ``torch.cuda.current_stream()``; raises on any input the
    kernel does not take and on a failed launch."""
    global launches
    _ent.check_streams(delta, plan)
    lib = _ent.load()
    out = torch.empty_like(delta)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        rc = lib.codec_disentangle_launch(
            delta.data_ptr(), out.data_ptr(), plan.M, delta.shape[1], plan.l,
            int(r) % plan.M, int(plan.temp == "dualword"),
            _ent.grid(delta, lib), stream)
    _ent.raise_on(rc, lib, "disentangle")
    launches += 1
    return out
