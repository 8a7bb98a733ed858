"""Depthwise causal integer conv1d: the CUDA kernel's wrapper, its plain
PyTorch version, and the kernel's launch counter.

Replaces the Pallas TPU kernel ``repro/kernels/conv1d.py``
(``conv1d_causal_pallas``, body ``_conv1d_kernel``): for x ``[B, D, T]``
and taps w ``[D, K_f]``, with zero left padding and wrapping mod 2**32::

    out[b, d, t] = sum_j w[d, j] * x[b, d, t - K_f + 1 + j]

It is the paper's experimental op (Fig. 2): the LSB ops ``conv`` and
``xcorr`` of :mod:`repro_torch.core.lsb_ops` run as this conv over the
streams (on B, with D = 1). Any K_f >= 1 runs as it is (the reference
promotes K_f = 1 to a zero leading tap, which gives the same result).

The kernel (``csrc/conv1d.cu``, shared with :mod:`.entangled_conv1d`, which
is its M-stream entangled form) is CUDA C++ for ``sm_90a``. What bounds it
on an H100: at the stream-conv shapes (T about 1e6, K_f up to 4500) the
K_f int32 multiply-adds per output on the CUDA cores, so operations; at the
depthwise model shape (D = 8192, K_f = 4) device-memory bytes. A block
owns one (b, d) row and a time tile, stages the taps in chunks and only
the K_f - 1 halo columns beyond its tile, and each thread keeps 8
consecutive outputs in registers (see the source's header). It is built
with ``nvcc`` at first use into ``_build/`` and bound with ``ctypes``
(:mod:`.nvcc`).

:func:`conv1d_causal_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`conv1d_causal_plain` is the plain
version, used for CPU tensors and as the kernel's yardstick on the card.
``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import nvcc

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "conv1d.cu"

# kernel launches since import (or the last reset by the caller)
launches = 0


def build(verbose: bool = False) -> tuple:
    """Compile ``csrc/conv1d.cu`` (and ``csrc/codec.cuh``) into
    ``_build/`` if needed; see :func:`.nvcc.build`."""
    return nvcc.build(SRC, verbose)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv1d_launch.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, i, i, p]
    lib.conv1d_launch.restype = i
    lib.conv1d_error_string.argtypes = [i]
    lib.conv1d_error_string.restype = ctypes.c_char_p


def load():
    """The ``conv1d`` library, built and loaded once per process."""
    return nvcc.load(SRC, _declare)


def conv1d_causal_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x ``[B, D, T]`` int, w ``[D, K_f]`` int ->
    ``[B, D, T]`` int32 on any device, a loop over the taps in int32 ops
    (which wrap mod 2**32); bit-identical to the kernel and to the
    reference's Pallas kernel."""
    x = x.to(torch.int32)
    w = w.to(torch.int32)
    B, D, T = x.shape
    if w.dim() != 2 or w.shape[0] != D:
        raise ValueError(f"w {tuple(w.shape)} does not match depth D={D}")
    kf = w.shape[1]
    xp = torch.nn.functional.pad(x, (kf - 1, 0))
    out = torch.zeros_like(x)
    for j in range(kf):
        out += w[None, :, j:j + 1] * xp[:, :, j:j + T]
    return out


def check_operands(x: torch.Tensor, w: torch.Tensor, dims: int) -> None:
    """Raise unless x and w are contiguous int32 tensors on one CUDA
    device, x with ``dims`` axes and w with 2."""
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dim() != dims or w.dim() != 2:
        raise ValueError(f"need x with {dims} axes and w with 2, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if min(x.shape) < 1 or w.shape[1] < 1:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")


def launch(x: torch.Tensor, w: torch.Tensor, *, M: int, packed: bool = False,
           l: int = 0, r: int = 0, extract: bool = False,
           dualword: bool = False) -> torch.Tensor:
    """Launch the kernel on checked operands: x ``[M, B, D, T]`` (M = 1:
    ``[B, D, T]``), returns an int32 tensor of x's shape. M = 1 is the
    plain conv; 3 <= M <= 8 entangles on load with shift ``l`` and, with
    ``extract``, disentangles without computing stream ``r``. Raises on a
    launch the kernel refuses. Counting the launch is the caller's."""
    B, D, T = x.shape[-3:]
    lib = load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), M,
                               B, D, T, w.shape[1], int(packed), l, r,
                               int(extract), int(dualword), stream)
    if rc != 0:
        raise RuntimeError(f"conv1d kernel launch failed: "
                           f"{lib.conv1d_error_string(rc).decode()}")
    return out


def conv1d_causal_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x ``[B, D, T]`` int32, w ``[D, K_f]`` int32,
    both contiguous on one CUDA device. Returns ``[B, D, T]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does not
    take and on a failed launch."""
    global launches
    check_operands(x, w, 3)
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} does not match depth "
                         f"D={x.shape[1]}")
    out = launch(x, w, M=1)
    launches += 1
    return out
