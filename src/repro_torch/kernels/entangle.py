"""Standalone entangle pass: the CUDA kernel's wrapper, its plain PyTorch
version, and the kernel's launch counter.

Replaces the Pallas TPU kernel ``repro/kernels/entangle.py``
(``entangle_pallas``, body ``_entangle_kernel``): for M int32 streams as
the rows of ``c [M, N]``::

    eps_m = (c_{(m-1) mod M} << l) + c_m          (wrapping mod 2**32)

The kernel (``csrc/codec_pass.cu``, the arithmetic of ``csrc/codec.cuh``)
is CUDA C++ for ``sm_90a``. What bounds it on an H100: one load and one
store of 4 bytes per word against a shift and an add, so device-memory
bytes; each thread loads a column's M words once (coalesced across the
warp along N) and writes the M entangled words, in a grid-stride loop that
masks the ragged end of N. It is built with ``nvcc`` at first use into
``_build/`` and bound with ``ctypes`` (:mod:`.nvcc`), in one library with
:mod:`.disentangle` and :mod:`.checksum`.

:func:`entangle_cuda` launches the kernel on a CUDA tensor and raises on
anything it does not take; :func:`entangle_plain` is the plain version, used
for CPU tensors and as the kernel's yardstick on the card. ``launches``
counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import nvcc
from repro_torch.kernels.codec import entangle_block

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "codec_pass.cu"

# kernel launches since import (or the last reset by the caller)
launches = 0

# blocks per SM of the grid-stride launch: enough resident warps to keep
# the loads of every SM in flight (the rule; a ``blocks`` dict's
# "blocks_per_sm" sets it per call)
BLOCKS_PER_SM = 8
CODEC_KEYS = ("blocks_per_sm",)

# blocks_per_sm and grid of the last launch of any of the three passes
last_launch: dict = {}


def build(verbose: bool = False) -> tuple:
    """Compile ``csrc/codec_pass.cu`` (and ``csrc/codec.cuh``) into
    ``_build/`` if needed; see :func:`.nvcc.build`."""
    return nvcc.build(SRC, verbose)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.codec_entangle_launch.argtypes = [p, p, i, ll, i, i, p]
    lib.codec_entangle_launch.restype = i
    lib.codec_disentangle_launch.argtypes = [p, p, i, ll, i, i, i, i, p]
    lib.codec_disentangle_launch.restype = i
    lib.codec_checksum_launch.argtypes = [p, p, i, ll, i, p]
    lib.codec_checksum_launch.restype = i
    lib.codec_error_string.argtypes = [i]
    lib.codec_error_string.restype = ctypes.c_char_p
    lib.codec_threads.argtypes = []
    lib.codec_threads.restype = i


def load():
    """The ``codec_pass`` library, built and loaded once per process."""
    return nvcc.load(SRC, _declare)


def check_streams(x: torch.Tensor, plan: EntanglePlan) -> None:
    """Raise unless ``x`` is a contiguous int32 ``[plan.M, N]`` CUDA tensor
    with N >= 1 and 3 <= M <= 8."""
    if not x.is_cuda:
        raise ValueError(f"need a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"need int32 streams, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the streams must be contiguous")
    if x.dim() != 2 or x.shape[0] != plan.M or x.shape[1] < 1:
        raise ValueError(f"need [M={plan.M}, N >= 1] streams, got "
                         f"{tuple(x.shape)}")
    if not 3 <= plan.M <= 8:
        raise ValueError(f"the kernel takes 3 <= M <= 8, got M={plan.M}")


def blocks_per_sm(blocks) -> int:
    """The blocks per SM that ``blocks`` (None or {"blocks_per_sm": n})
    sets; raises on any other key or on n < 1."""
    if not blocks:
        return BLOCKS_PER_SM
    unknown = set(blocks) - set(CODEC_KEYS)
    if unknown:
        raise ValueError(f"the codec passes take blocks keys {CODEC_KEYS}, "
                         f"got {sorted(unknown)}")
    n = blocks.get("blocks_per_sm", BLOCKS_PER_SM)
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"blocks_per_sm must be an int >= 1, got {n!r}")
    return n


def grid(x: torch.Tensor, lib, blocks=None) -> int:
    """Blocks of the grid-stride launch over the N columns of ``x``: one
    per column of threads, at most ``blocks_per_sm`` (the rule's
    :data:`BLOCKS_PER_SM` unless ``blocks`` sets it) per SM. Records the
    launch in :data:`last_launch`."""
    global last_launch
    bps = blocks_per_sm(blocks) if blocks else BLOCKS_PER_SM
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n = max(1, min(-(-x.shape[1] // lib.codec_threads()), bps * sms))
    last_launch = {"blocks_per_sm": bps, "grid": n}
    return n


def raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.codec_error_string(rc).decode()}")


def entangle_plain(c: torch.Tensor, plan: EntanglePlan) -> torch.Tensor:
    """Plain PyTorch version: ``c [M, N]`` int -> ``[M, N]`` int32, on any
    device; bit-identical to the kernel and to the reference's Pallas
    kernel."""
    if c.shape[0] != plan.M:
        raise ValueError(f"c has {c.shape[0]} streams, plan.M={plan.M}")
    return entangle_block(c, plan.l)


def entangle_cuda(c: torch.Tensor, plan: EntanglePlan, *,
                  blocks=None) -> torch.Tensor:
    """Launch the CUDA kernel on ``c [M, N]`` int32, contiguous on a CUDA
    device (``blocks``: see :func:`grid`). Returns ``[M, N]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does
    not take and on a failed launch."""
    global launches
    check_streams(c, plan)
    lib = load()
    out = torch.empty_like(c)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.codec_entangle_launch(c.data_ptr(), out.data_ptr(), plan.M,
                                       c.shape[1], plan.l,
                                       grid(c, lib, blocks), stream)
    raise_on(rc, lib, "entangle")
    launches += 1
    return out
