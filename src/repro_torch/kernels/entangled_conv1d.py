"""Fused entangled depthwise causal conv1d: the CUDA kernel's wrapper, its
plain PyTorch version, and the kernel's launch counter.

Replaces the Pallas TPU kernel ``repro/kernels/entangled_conv1d.py``
(``entangled_conv1d_pallas``, body ``_econv_kernel``). For M int32 streams
x ``[M, B, D, T]`` and taps w ``[D, K_f]`` (``packed``: int8 lanes packed 4
per int32 word along D, ``[ceil(D/4), K_f]``) it computes the causal conv
of :mod:`.conv1d` on the entangled streams ``eps = (roll(x, 1) << l) + x``
(the halo entangled too)::

    fuse_epilogue=False  delta[m] = conv(eps[m], w)      (entangled outputs)
    fuse_epilogue=True   d[m]     = conv(x[m], w)        (recovered, eq. 16-19,
                                                          never computing
                                                          stream ``failed``)

Depthwise conv is sesquilinear in the stream, so ``conv(E x) = E conv(x)``
(paper Sec. III) and the extraction recovers the true outputs while they
are within the plan's ``max_output_magnitude`` (eq. 13).

The kernel is ``csrc/conv1d.cu`` with M streams per block (one build with
:mod:`.conv1d`): the window of all M streams is entangled while it is
staged, each tap is read once for all M streams, and with extraction the
M - 1 streams other than ``failed`` are accumulated in the rotated order
that ``disentangle_one`` of ``csrc/codec.cuh`` consumes at the flush. What
bounds it on an H100: the int32 multiply-adds on the CUDA cores at the
stream-conv shapes (operations), device-memory bytes at the depthwise model
shape.

:func:`entangled_conv1d_cuda` launches the kernel on CUDA tensors and
raises on anything it does not take; :func:`entangled_conv1d_plain` is the
plain version, used for CPU tensors and as the kernel's yardstick on the
card. ``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import conv1d as _conv
from repro_torch.kernels.codec import (PACK_LANES, disentangle_block,
                                       entangle_block, unpack_int8)

# one library with the plain conv (one source, one build)
build = _conv.build
MODES = (False, True)

# kernel launches since import (or the last reset by the caller)
launches = 0


def check_mode(fuse_epilogue) -> None:
    if fuse_epilogue not in MODES:
        raise ValueError(f"fuse_epilogue must be one of {MODES}, got "
                         f"{fuse_epilogue!r}")


def _taps_depth(D: int, packed: bool) -> int:
    return -(-D // PACK_LANES) if packed else D


def entangled_conv1d_plain(x: torch.Tensor, w: torch.Tensor,
                           plan: EntanglePlan, *, fuse_epilogue=False,
                           failed: Optional[int] = None,
                           packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: x ``[M, B, D,
    T]`` int, w ``[D, K_f]`` int or packed ``[ceil(D/4), K_f]``; returns
    ``[M, B, D, T]`` int32, bit-identical to the kernel and to the
    reference's Pallas kernel."""
    check_mode(fuse_epilogue)
    M, B, D, T = x.shape
    if M != plan.M:
        raise ValueError(f"x has {M} streams, plan.M={plan.M}")
    if w.shape[0] != _taps_depth(D, packed):
        raise ValueError(f"w {tuple(w.shape)} does not match depth D={D} "
                         f"(packed={packed})")
    w = unpack_int8(w, axis=0, n=D) if packed else w.to(torch.int32)
    eps = entangle_block(x, plan.l)
    out = _conv.conv1d_causal_plain(eps.reshape(M * B, D, T), w)
    out = out.reshape(M, B, D, T)
    if fuse_epilogue:
        out = disentangle_block(out, plan, 0 if failed is None else failed)
    return out


def entangled_conv1d_cuda(x: torch.Tensor, w: torch.Tensor,
                          plan: EntanglePlan, *, fuse_epilogue=False,
                          failed: Optional[int] = None,
                          packed: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel: x ``[M, B, D, T]`` int32, w ``[D, K_f]`` or
    packed ``[ceil(D/4), K_f]`` int32, both contiguous on one CUDA device,
    3 <= M <= 8. Returns ``[M, B, D, T]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does
    not take and on a failed launch."""
    global launches
    check_mode(fuse_epilogue)
    _conv.check_operands(x, w, 4)
    M, _, D, _ = x.shape
    if M != plan.M or not 3 <= M <= 8:
        raise ValueError(f"x has {M} streams; need plan.M={plan.M} in 3..8")
    if w.shape[0] != _taps_depth(D, packed):
        raise ValueError(f"w {tuple(w.shape)} does not match depth D={D} "
                         f"(packed={packed})")
    r = 0 if failed is None else int(failed) % M
    out = _conv.launch(x, w, M=M, packed=packed, l=plan.l, r=r,
                       extract=bool(fuse_epilogue),
                       dualword=plan.temp == "dualword")
    launches += 1
    return out
