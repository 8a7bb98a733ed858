"""Depthwise causal integer conv1d: the CUDA kernels' wrapper, its plain
PyTorch version, the route rule, and the kernels' launch counters.

Replaces the Pallas TPU kernel ``repro/kernels/conv1d.py``
(``conv1d_causal_pallas``, body ``_conv1d_kernel``): for x ``[B, D, T]``
and taps w ``[D, K_f]``, with zero left padding and wrapping mod 2**32::

    out[b, d, t] = sum_j w[d, j] * x[b, d, t - K_f + 1 + j]

It is the paper's experimental op (Fig. 2): the LSB ops ``conv`` and
``xcorr`` of :mod:`repro_torch.core.lsb_ops` run as this conv over the
streams (on B, with D = 1). Any K_f >= 1 runs as it is (the reference
promotes K_f = 1 to a zero leading tap, which gives the same result).

Two hand-written CUDA C++ kernels for ``sm_90a`` compute it, both in
``csrc/conv1d.cu`` (shared with :mod:`.entangled_conv1d`, the M-stream
entangled form), bit for bit alike:

* ``"s8"``, the int8 tensor cores. At the stream-conv shapes (T about 1e6,
  K_f up to 4500) the K_f multiply-adds per output bound the conv. The
  kernel runs them as a Toeplitz (taps) x Hankel (overlapping input
  windows) product in blocks of :data:`S8_BLOCK` outputs, with the int32
  words split into four exact u8 limbs and the taps into balanced s8
  limbs: each limb product is a warpgroup MMA (``wgmma``, s8 x u8, the
  windows read from shared memory as they were staged). The products with
  limb shift u + v <= 3 are recombined mod 2**32 after each chunk of at
  most :data:`S8_CHUNK` taps, so no s32 sum overflows. Tap limb planes
  above the highest one that is nonzero over a chunk are skipped inside
  the block: taps in [-128, 128) cost 4 limb products per MAC, full-range
  taps 10;
* ``"cuda_core"``, int32 multiply-adds on the CUDA cores: the route of
  short filters, where the conv is bound by device-memory bytes (the
  depthwise model shape, D = 8192, T = 512, K_f = 4). A thread owns 4
  consecutive outputs (one 16-byte store), the time tile is fitted to T
  with several rows per block when T is short, and the taps are not padded
  beyond a multiple of 4.

``route=None`` picks by :func:`route_for`, a rule on K_f and T taken from a
sweep of both routes on the card (``chip_conv_routes.py``, ``[conv-route]``
lines).
Both routes raise when they fail to build or launch; nothing drops to the
plain version. The source is built with ``nvcc`` at first use into
``_build/`` and bound with ``ctypes`` (:mod:`.nvcc`).

:func:`conv1d_causal_cuda` launches a kernel on CUDA tensors and raises on
anything it does not take; :func:`conv1d_causal_plain` is the plain
version, used for CPU tensors and as the kernels' yardstick on the card.
``launches`` counts kernel launches (never plain-version calls), and
``launches_s8`` / ``launches_cuda_core`` split them by route.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import nvcc

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "conv1d.cu"

# kernel launches since import (or the last reset by the caller): all, and
# per route
launches = 0
launches_s8 = 0
launches_cuda_core = 0

ROUTES = ("cuda_core", "s8")  # the launcher's route codes 0 and 1
# The s8 kernel's geometry (csrc/conv1d.cu, namespace s8): outputs per
# Hankel row, and taps per chunk, after which the limb sums are folded
S8_BLOCK = 64
S8_CHUNK = 4608
# The route rule. Sweep of both routes on the card (chip_conv_routes.py,
# [conv-route] lines; NVIDIA H100 80GB HBM3, 700.00 W), ms CUDA-core / s8 at
# K_f = 100 and 500: the stream shape [8, 1, 1e6 + K_f - 1] 0.0899 / 0.0566
# and 0.3407 / 0.0772, its fused entangled conv (M = 8) 0.0851 / 0.0909 and
# 0.2985 / 0.1064, the depthwise shape [8, 8192, 512] 0.3362 / 0.5368 and
# 1.4699 / 1.0502 (entangled, M = 4: 0.9332 / 1.5559 and 4.1813 / 3.0693).
# Up to K_f = 33 the CUDA cores won at every shape (33, stream: 0.0444 /
# 0.0455); at 100 they won but for the plain conv over long rows; from 500
# on the s8 route won at every shape. So: s8 from S8_MIN_KF taps, and the
# plain conv from S8_MIN_KF_PLAIN taps over rows of at least one full s8
# tile (S8_LONG_T outputs; shorter rows take the s8 kernel's 512-output
# tile, which lost at T = 512).
S8_MIN_KF = 500
S8_MIN_KF_PLAIN = 100
S8_LONG_T = 48 * S8_BLOCK


def route_for(kf: int, T: int, entangled: bool = False) -> str:
    """The route ``route=None`` takes for ``kf`` taps over rows of ``T``
    steps, for the plain or the ``entangled`` conv: "s8" where the sweep
    showed the s8 kernel faster, else "cuda_core"."""
    if kf >= S8_MIN_KF or (not entangled and kf >= S8_MIN_KF_PLAIN
                           and T >= S8_LONG_T):
        return "s8"
    return "cuda_core"


def resolve_route(route, kf: int, T: int, entangled: bool = False) -> str:
    """``route`` itself, or :func:`route_for` when it is None; raises on an
    unknown route."""
    if route is None:
        return route_for(kf, T, entangled)
    if route not in ROUTES:
        raise ValueError(f"route must be None or one of {ROUTES}, got "
                         f"{route!r}")
    return route


def build(verbose: bool = False) -> tuple:
    """Compile ``csrc/conv1d.cu`` (and ``csrc/codec.cuh``) into
    ``_build/`` if needed; see :func:`.nvcc.build`."""
    return nvcc.build(SRC, verbose)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv1d_launch.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, i, i,
                                  i, p]
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


def launch(x: torch.Tensor, w: torch.Tensor, *, M: int, route: str,
           packed: bool = False, l: int = 0, r: int = 0,
           extract: bool = False, dualword: bool = False) -> torch.Tensor:
    """Launch the ``route`` kernel ("s8" or "cuda_core") on checked
    operands: x ``[M, B, D, T]`` (M = 1: ``[B, D, T]``), returns an int32
    tensor of x's shape. M = 1 is the plain conv; 3 <= M <= 8 entangles on
    load with shift ``l`` and, with ``extract``, disentangles without
    computing stream ``r``. Raises on a launch the kernel refuses. Counting
    the launch is the caller's."""
    B, D, T = x.shape[-3:]
    lib = load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), M,
                               B, D, T, w.shape[1], int(packed), l, r,
                               int(extract), int(dualword),
                               ROUTES.index(route), stream)
    if rc != 0:
        raise RuntimeError(f"conv1d {route} kernel launch failed: "
                           f"{lib.conv1d_error_string(rc).decode()}")
    return out


def conv1d_causal_cuda(x: torch.Tensor, w: torch.Tensor, *,
                       route=None) -> torch.Tensor:
    """Launch a CUDA kernel: x ``[B, D, T]`` int32, w ``[D, K_f]`` int32,
    both contiguous on one CUDA device; ``route`` None (the rule of
    :func:`route_for`), "s8" or "cuda_core". Returns ``[B, D, T]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does not
    take and on a failed build or launch."""
    global launches, launches_s8, launches_cuda_core
    route = resolve_route(route, w.shape[-1], x.shape[-1])
    check_operands(x, w, 3)
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} does not match depth "
                         f"D={x.shape[1]}")
    out = launch(x, w, M=1, route=route)
    launches += 1
    if route == "s8":
        launches_s8 += 1
    else:
        launches_cuda_core += 1
    return out
