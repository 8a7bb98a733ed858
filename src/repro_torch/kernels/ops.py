"""Dispatch over the port's kernels (the public op API of
:mod:`repro.kernels.ops`): the dense and the grouped entangled GEMM, the
standalone entangle and disentangle passes, the checksum stream, and the
plain and the entangled depthwise causal conv1d.

The device of the operands picks the implementation, and nothing else
does: a CPU tensor goes to the plain PyTorch version, a CUDA tensor to the
hand-written kernel, which launches or raises — there is no quiet fallback
from one to the other. The CUDA kernel masks ragged edges itself, so no
padding happens here (the reference pads to its block sizes), and there is
no block-size or autotune argument in this slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import checksum as cks
from repro_torch.kernels import conv1d as cv
from repro_torch.kernels import disentangle as dis
from repro_torch.kernels import entangle as ent
from repro_torch.kernels import entangled_conv1d as ecv
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import entangled_matmul_grouped as emmg


def _two_operands(name: str, a: torch.Tensor, b: torch.Tensor, plain, cuda):
    """``plain(a, b)`` for CPU operands, ``cuda`` on their int32 contiguous
    forms for CUDA operands; raises for anything else."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(a, b)
    if a.is_cuda and b.is_cuda:
        return cuda(a.to(torch.int32).contiguous(),
                    b.to(torch.int32).contiguous())
    raise ValueError(f"{name} needs both operands on the CPU or both on "
                     f"CUDA, got {a.device} and {b.device}")


def entangled_matmul(c: torch.Tensor, g: torch.Tensor, plan: EntanglePlan, *,
                     fuse_epilogue=False, failed: Optional[int] = None,
                     packed: bool = False) -> torch.Tensor:
    """Fused entangle + GEMM [+ extract]: c ``[M, B, K]``, g ``[K, N]``
    (packed: ``[ceil(K/4), N]``) -> ``[M, B, N]`` int32, for any B, K, N.

    ``fuse_epilogue`` is one of True / False / 'chain' / 'chain_final'
    (see :mod:`repro_torch.kernels.entangled_matmul`); ``failed`` is the
    stream the extraction never reads (None means stream 0).
    """
    kw = dict(fuse_epilogue=fuse_epilogue, failed=failed, packed=packed)
    return _two_operands(
        "entangled_matmul", c, g,
        lambda a, b: emm.entangled_matmul_plain(a, b, plan, **kw),
        lambda a, b: emm.entangled_matmul_cuda(a, b, plan, **kw))


def entangled_matmul_grouped(c: torch.Tensor, g: torch.Tensor,
                             plan: EntanglePlan, *, fuse_epilogue=False,
                             failed: Optional[int] = None,
                             packed: bool = False) -> torch.Tensor:
    """Grouped (per-expert) fused entangle + GEMM [+ extract], the MoE form:
    c ``[M, E, Cg, K]``, g ``[E, K, N]`` (packed: ``[E, ceil(K/4), N]``) ->
    ``[M, E, Cg, N]`` int32. ``fuse_epilogue`` is True or False (the chain
    modes are dense-only and raise, as in the reference)."""
    kw = dict(fuse_epilogue=fuse_epilogue, failed=failed, packed=packed)
    return _two_operands(
        "entangled_matmul_grouped", c, g,
        lambda a, b: emmg.entangled_matmul_grouped_plain(a, b, plan, **kw),
        lambda a, b: emmg.entangled_matmul_grouped_cuda(a, b, plan, **kw))


def _codec_pass(name: str, x: torch.Tensor, plain, cuda) -> torch.Tensor:
    """Flatten ``[M, ...]`` to ``[M, N]``, run the pass on the operand's
    device, and restore the shape."""
    flat = x.reshape(x.shape[0], -1)
    if flat.device.type == "cpu":
        out = plain(flat)
    elif flat.is_cuda:
        out = cuda(flat.to(torch.int32).contiguous())
    else:
        raise ValueError(f"{name} needs a CPU or CUDA tensor, got {x.device}")
    return out.reshape(x.shape)


def entangle(c: torch.Tensor, plan: EntanglePlan) -> torch.Tensor:
    """Entangle M streams of any trailing shape: ``c [M, ...]`` int ->
    int32 of the same shape."""
    return _codec_pass("entangle", c, lambda f: ent.entangle_plain(f, plan),
                       lambda f: ent.entangle_cuda(f, plan))


def disentangle(delta: torch.Tensor, plan: EntanglePlan, *,
                failed: Optional[int] = None) -> torch.Tensor:
    """Recover all M streams from entangled ``delta [M, ...]`` of any
    trailing shape, never reading stream ``failed`` (None means stream 0,
    as in the reference)."""
    r = 0 if failed is None else failed
    return _codec_pass("disentangle", delta,
                       lambda f: dis.disentangle_plain(f, plan, r),
                       lambda f: dis.disentangle_cuda(f, plan, r))


def checksum(c: torch.Tensor) -> torch.Tensor:
    """Checksum stream ``r = sum_m c_m`` (paper eq. 4) of ``[M, ...]``
    inputs -> ``[...]`` int32, wrapping mod 2**32."""
    flat = c.reshape(c.shape[0], -1)
    if flat.device.type == "cpu":
        out = cks.checksum_plain(flat)
    elif flat.is_cuda:
        out = cks.checksum_cuda(flat.to(torch.int32).contiguous())
    else:
        raise ValueError(f"checksum needs a CPU or CUDA tensor, got "
                         f"{c.device}")
    return out.reshape(c.shape[1:])


def entangled_conv1d(x: torch.Tensor, w: torch.Tensor, plan: EntanglePlan, *,
                     fuse_epilogue: bool = False,
                     failed: Optional[int] = None,
                     packed: bool = False) -> torch.Tensor:
    """Fused entangle + depthwise causal conv1d [+ extract]: x ``[M, B, D,
    T]``, w ``[D, K_f]`` int (packed: ``[ceil(D/4), K_f]`` int8 lanes along
    the depth axis) -> ``[M, B, D, T]`` int32, any K_f >= 1.
    ``fuse_epilogue`` is True or False (the chain modes are dense-only and
    raise, as in the reference); ``failed`` is the stream the extraction
    never computes (None means stream 0)."""
    ecv.check_mode(fuse_epilogue)
    kw = dict(fuse_epilogue=fuse_epilogue, failed=failed, packed=packed)
    return _two_operands(
        "entangled_conv1d", x, w,
        lambda a, b: ecv.entangled_conv1d_plain(a, b, plan, **kw),
        lambda a, b: ecv.entangled_conv1d_cuda(a, b, plan, **kw))


def conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (unentangled): x ``[B, D, T]``, w ``[D,
    K_f]`` int -> ``[B, D, T]`` int32, any K_f >= 1."""
    return _two_operands("conv1d_causal", x, w, cv.conv1d_causal_plain,
                         cv.conv1d_causal_cuda)
