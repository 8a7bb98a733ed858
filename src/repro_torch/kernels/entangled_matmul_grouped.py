"""Grouped (per-expert) fused entangled integer GEMM — the MoE form: the
CUDA kernels' wrappers, their plain PyTorch version, and the launch
counters.

Replaces the Pallas TPU kernel ``repro/kernels/entangled_matmul_grouped.py``
(``entangled_matmul_grouped_pallas``, body ``_emmg_kernel``). For c
``[M, E, Cg, K]`` and g ``[E, K, N]`` (packed: ``[E, ceil(K/4), N]``) it
computes, per expert e, the dense kernel's function on that expert's rows
and weights::

    out[m, e] = disentangle(eps[m, e] @ g[e])     fuse_epilogue=True
    out[m, e] = eps[m, e] @ g[e]                  fuse_epilogue=False

with ``eps = (roll(c, 1, axis=0) << l) + c``. Entanglement spans the M
stream axis only, so a fail-stopped stream rolls forward for every expert
at once. Only these two modes exist (the chain modes are dense-only, as in
the reference).

The two kernels of the dense form compute it with the expert as one more
grid coordinate (see the sources' headers), and
:func:`entangled_matmul_grouped_cuda` routes by ``packed`` alone: packed
weights (the serving path's) take the s8 tensor-core kernel
(``csrc/entangled_matmul_s8.cu``), unpacked full-range int32 weights the
CUDA-core kernel (``csrc/entangled_matmul.cu``). Each block owns rows of
one expert and reads that expert's weights. What bounds the s8 kernel on
an H100: the weight bytes. At the decode shapes (2 rows per stream per
expert, 64 experts) most experts hold no token: their rows are zero, and
a block whose entangled operand is all zero skips its expert's weights,
so the bytes read are those of the occupied experts. The kernels are
built with the dense form's (:func:`build`, :func:`build_s8`) and bound
with ``ctypes``.

:func:`entangled_matmul_grouped_cuda` launches a kernel on CUDA tensors
and raises on anything it does not take;
:func:`entangled_matmul_grouped_plain` is the plain version, used for CPU
tensors and as the kernels' yardstick on the card. ``launches_s8`` and
``launches_cuda_core`` count each route's kernel launches of this wrapper
(never plain-version calls).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels.codec import (disentangle_block, entangle_block,
                                       unpack_int8)

# the libraries are the dense form's (one build per source)
build = emm.build
build_s8 = emm.build_s8
MODES = (False, True)

# kernel launches since import (or the last reset by the caller), per route
launches_s8 = 0
launches_cuda_core = 0


def _check_mode(fuse_epilogue) -> None:
    if fuse_epilogue not in MODES:
        raise ValueError(f"the grouped kernel takes fuse_epilogue True or "
                         f"False only, got {fuse_epilogue!r}")


def entangled_matmul_grouped_plain(c: torch.Tensor, g: torch.Tensor,
                                   plan: EntanglePlan, *, fuse_epilogue=False,
                                   failed: Optional[int] = None,
                                   packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    c ``[M, E, Cg, K]`` int, g ``[E, K, N]`` int or packed ``[E, ceil(K/4),
    N]``; returns ``[M, E, Cg, N]`` int32, bit-identical to the kernel and
    to the reference's Pallas kernel. Each expert's product is the dense
    plain version's limb product, batched over experts, so it is exact mod
    2**32 for any int32 operands with K < 2**21 (any K for packed weights,
    in K slices of at most 65536 as in the s8 kernel).
    """
    _check_mode(fuse_epilogue)
    M, E, Cg, K = c.shape
    if M != plan.M:
        raise ValueError(f"c has {M} streams, plan.M={plan.M}")
    if g.shape[0] != E:
        raise ValueError(f"g has {g.shape[0]} experts, c has E={E}")
    eps = entangle_block(c.to(torch.int32), plan.l)
    g = unpack_int8(g, axis=1, n=K) if packed else g.to(torch.int32)
    if g.shape[1] != K:
        raise ValueError(f"g has depth {g.shape[1]}, c has K={K}")
    N = g.shape[2]
    rows = eps.transpose(0, 1).reshape(E, M * Cg, K)  # expert-major rows
    out = emm._matmul_mod32(rows, g, g_int8=packed)
    out = out.reshape(E, M, Cg, N).transpose(0, 1)
    if fuse_epilogue:
        out = disentangle_block(out, plan, 0 if failed is None else failed)
    return out.contiguous()


def _launch(c: torch.Tensor, g: torch.Tensor, plan: EntanglePlan,
            fuse_epilogue, failed: Optional[int], packed: bool,
            route: str) -> torch.Tensor:
    _check_mode(fuse_epilogue)
    emm.check_operands(c, g, 4)
    M, E, Cg, K = c.shape
    if g.shape[0] != E:
        raise ValueError(f"g has {g.shape[0]} experts, c has E={E}")
    out = emm.launch(c, g, plan, E=E, Cg=Cg, K=K, N=g.shape[2],
                     fuse_epilogue=fuse_epilogue, failed=failed,
                     packed=packed, route=route)
    return out.reshape(M, E, Cg, g.shape[2])


def entangled_matmul_grouped_cuda(c: torch.Tensor, g: torch.Tensor,
                                  plan: EntanglePlan, *, fuse_epilogue=False,
                                  failed: Optional[int] = None,
                                  packed: bool = False) -> torch.Tensor:
    """Launch a CUDA kernel: c ``[M, E, Cg, K]`` int32, g ``[E, K, N]``
    int32 or packed ``[E, ceil(K/4), N]``, both contiguous on one CUDA
    device. Packed weights take the s8 tensor-core kernel (any K),
    unpacked ones the CUDA-core kernel. Returns ``[M, E, Cg, N]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does
    not take and on a failed launch."""
    global launches_s8, launches_cuda_core
    out = _launch(c, g, plan, fuse_epilogue, failed, packed,
                  "s8" if packed else "cuda_core")
    if packed:
        launches_s8 += 1
    else:
        launches_cuda_core += 1
    return out


def entangled_matmul_grouped_cuda_core(c: torch.Tensor, g: torch.Tensor,
                                       plan: EntanglePlan, *,
                                       fuse_epilogue=False,
                                       failed: Optional[int] = None,
                                       packed: bool = False) -> torch.Tensor:
    """Launch the CUDA-core kernel on either weight form (packed weights
    too, so it can be timed beside the s8 kernel); otherwise as
    :func:`entangled_matmul_grouped_cuda`."""
    global launches_cuda_core
    out = _launch(c, g, plan, fuse_epilogue, failed, packed, "cuda_core")
    launches_cuda_core += 1
    return out
