"""Checksum-stream generation (the checksum-ABFT baseline, paper eq. 4):
the CUDA kernel's wrapper, its plain PyTorch version, and the kernel's
launch counter.

Replaces the Pallas TPU kernel ``repro/kernels/checksum.py``
(``checksum_pallas``, body ``_checksum_kernel``): the (M+1)-th stream
``r = sum_m c_m`` of the M int32 streams in the rows of ``c [M, N]``,
wrapping mod 2**32.

The kernel (``csrc/codec_pass.cu``, in one library with :mod:`.entangle`
and :mod:`.disentangle`) is CUDA C++ for ``sm_90a``. What bounds it on an
H100: device-memory bytes — M loads and one store of 4 bytes per column
against M - 1 adds; each thread sums a column's M words (independent loads,
coalesced across the warp along N) in a grid-stride loop that masks the
ragged end of N.

:func:`checksum_cuda` launches the kernel on a CUDA tensor and raises on
anything it does not take; :func:`checksum_plain` is the plain version,
used for CPU tensors and as the kernel's yardstick on the card.
``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import entangle as _ent

# one library with the entangle and disentangle passes
build = _ent.build

# kernel launches since import (or the last reset by the caller)
launches = 0


def checksum_plain(c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``c [M, N]`` int -> ``[N]`` int32, the sum
    over the rows mod 2**32, on any device."""
    return torch.sum(c.to(torch.int32), dim=0, dtype=torch.int32)


def checksum_cuda(c: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``c [M, N]`` int32, contiguous on a CUDA
    device, any M >= 1. Returns ``[N]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does
    not take and on a failed launch."""
    global launches
    if not c.is_cuda:
        raise ValueError(f"need a CUDA tensor, got {c.device}")
    if c.dtype != torch.int32:
        raise TypeError(f"need int32 streams, got {c.dtype}")
    if not c.is_contiguous():
        raise ValueError("the streams must be contiguous")
    if c.dim() != 2 or c.shape[0] < 1 or c.shape[1] < 1:
        raise ValueError(f"need [M >= 1, N >= 1] streams, got "
                         f"{tuple(c.shape)}")
    lib = _ent.load()
    out = torch.empty(c.shape[1], dtype=torch.int32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.codec_checksum_launch(c.data_ptr(), out.data_ptr(),
                                       c.shape[0], c.shape[1],
                                       _ent.grid(c, lib), stream)
    _ent.raise_on(rc, lib, "checksum")
    launches += 1
    return out
