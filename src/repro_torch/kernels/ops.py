"""Dispatch over the port's kernels (the serving and training slices of
:mod:`repro.kernels.ops`): the dense and the grouped entangled GEMM, and
the standalone entangle and disentangle passes.

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
from repro_torch.kernels import disentangle as dis
from repro_torch.kernels import entangle as ent
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import entangled_matmul_grouped as emmg


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
    if c.device.type == "cpu" and g.device.type == "cpu":
        return emm.entangled_matmul_plain(c, g, plan, **kw)
    if c.is_cuda and g.is_cuda:
        return emm.entangled_matmul_cuda(
            c.to(torch.int32).contiguous(), g.to(torch.int32).contiguous(),
            plan, **kw)
    raise ValueError(f"entangled_matmul needs both operands on the CPU or "
                     f"both on CUDA, got {c.device} and {g.device}")


def entangled_matmul_grouped(c: torch.Tensor, g: torch.Tensor,
                             plan: EntanglePlan, *, fuse_epilogue=False,
                             failed: Optional[int] = None,
                             packed: bool = False) -> torch.Tensor:
    """Grouped (per-expert) fused entangle + GEMM [+ extract], the MoE form:
    c ``[M, E, Cg, K]``, g ``[E, K, N]`` (packed: ``[E, ceil(K/4), N]``) ->
    ``[M, E, Cg, N]`` int32. ``fuse_epilogue`` is True or False (the chain
    modes are dense-only and raise, as in the reference)."""
    kw = dict(fuse_epilogue=fuse_epilogue, failed=failed, packed=packed)
    if c.device.type == "cpu" and g.device.type == "cpu":
        return emmg.entangled_matmul_grouped_plain(c, g, plan, **kw)
    if c.is_cuda and g.is_cuda:
        return emmg.entangled_matmul_grouped_cuda(
            c.to(torch.int32).contiguous(), g.to(torch.int32).contiguous(),
            plan, **kw)
    raise ValueError(f"entangled_matmul_grouped needs both operands on the "
                     f"CPU or both on CUDA, got {c.device} and {g.device}")


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
