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

The kernels are the two routes of ``csrc/conv1d.cu`` (one build with
:mod:`.conv1d`, which describes them), with the entangle on load and the
extraction at the flush:

* ``"s8"`` (the int8 tensor cores; bound by the limb products at the
  stream-conv shapes): a block stages one stream slot's window at a time,
  entangled from two input streams, as four u8 limb planes; the taps' limb
  planes are staged once for every slot. With extraction only the M - 1
  slots other than ``failed`` are computed, and the block reads its tile's
  M - 1 entangled values back to disentangle them (``disentangle_one`` of
  ``csrc/codec.cuh``);
* ``"cuda_core"`` (int32 multiply-adds; bound by bytes at the depthwise
  model shape): the window of all M streams is entangled while it is
  staged, each tap is read once for all M streams, and with extraction the
  M - 1 streams other than ``failed`` are accumulated in the rotated order
  that ``disentangle_one`` consumes at the flush.

``route=None`` picks by :func:`.conv1d.route_for` (a rule on K_f and T
from a sweep on the card, ``chip_conv_routes.py``); both routes raise when they fail to build or
launch.

:func:`entangled_conv1d_cuda` launches a kernel on CUDA tensors and raises
on anything it does not take; :func:`entangled_conv1d_plain` is the plain
version, used for CPU tensors and as the kernels' yardstick on the card.
``launches`` counts kernel launches (never plain-version calls), and
``launches_s8`` / ``launches_cuda_core`` split them by route.
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

# kernel launches since import (or the last reset by the caller): all, and
# per route
launches = 0
launches_s8 = 0
launches_cuda_core = 0


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
                          failed: Optional[int] = None, packed: bool = False,
                          route=None) -> torch.Tensor:
    """Launch a CUDA kernel: x ``[M, B, D, T]`` int32, w ``[D, K_f]`` or
    packed ``[ceil(D/4), K_f]`` int32, both contiguous on one CUDA device,
    3 <= M <= 8; ``route`` None (the rule of :func:`.conv1d.route_for`),
    "s8" or "cuda_core". Returns ``[M, B, D, T]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input the kernel does
    not take and on a failed build or launch."""
    global launches, launches_s8, launches_cuda_core
    check_mode(fuse_epilogue)
    route = _conv.resolve_route(route, w.shape[-1], x.shape[-1],
                                entangled=True)
    _conv.check_operands(x, w, 4)
    M, _, D, _ = x.shape
    if M != plan.M or not 3 <= M <= 8:
        raise ValueError(f"x has {M} streams; need plan.M={plan.M} in 3..8")
    if w.shape[0] != _taps_depth(D, packed):
        raise ValueError(f"w {tuple(w.shape)} does not match depth D={D} "
                         f"(packed={packed})")
    r = 0 if failed is None else int(failed) % M
    out = _conv.launch(x, w, M=M, route=route, packed=packed, l=plan.l, r=r,
                       extract=bool(fuse_epilogue),
                       dualword=plan.temp == "dualword")
    launches += 1
    if route == "s8":
        launches_s8 += 1
    else:
        launches_cuda_core += 1
    return out
