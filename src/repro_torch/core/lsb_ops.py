"""Registry of Linear / Sesquilinear / Bijective (LSB) operations — paper
eq. (2); port of :mod:`repro.core.lsb_ops`.

Each :class:`LSBOp` knows how to
  * apply itself to a stack of (possibly entangled) streams,
  * prepare its kernel for entangled execution (ops in {+, -} need the
    kernel self-entangled, paper footnote 3),
  * combine per-stream outputs into the checksum-stream prediction used by
    the checksum-ABFT baseline (Sec. II.A), including the op-specific
    correction for ops that are affine rather than linear in the stream
    (e.g. ``add``: e = sum_m d_m - (M-1) g).

Only *data-independent* ops qualify (paper footnote 2): permutations use
fixed index sets.

Where the reference ``vmap``s an op over the stream axis, the port's ops
take the whole stack ``[S, ...]`` and compute all streams in one batched
tensor op. All integer results wrap mod 2**32 as the reference's int32 ops
do. ``conv`` and ``xcorr`` are the causal conv of
:func:`repro_torch.kernels.ops.conv1d_causal` (the hand-written kernel on
a CUDA tensor) over the streams zero-padded on the right by K - 1, with the
taps flipped for ``conv``; the other ops are plain torch ops, as the
reference computes them in jnp outside any Pallas kernel. Torch has no
int32 matmul on CUDA, so ``dot`` and ``circconv`` are elementwise products
and integer sums (exact mod 2**32).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.entangle import entangle_kernel_addsub
from repro_torch.core.plan import EntanglePlan


def sum_streams(d: torch.Tensor) -> torch.Tensor:
    """sum_m d_m through :func:`repro_torch.kernels.ops.checksum` (imported
    here: the kernel modules import this package)."""
    from repro_torch.kernels import ops

    return ops.checksum(d)


@dataclasses.dataclass(frozen=True)
class LSBOp:
    """A data-independent linear/sesquilinear/bijective stream operation.

    Attributes:
      name: registry key.
      apply: (streams ``[S, ...]``, kernel) -> outputs ``[S, ...]``; linear
        in each stream (for a fixed kernel) or a fixed bijection.
      needs_kernel_entangled: True for op in {+, -} (footnote 3).
      checksum_combine: maps (stacked outputs d[M, ...], kernel, M) to the
        value the checksum stream's output must equal; defaults to
        sum_m d_m.
    """

    name: str
    apply: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
    needs_kernel_entangled: bool = False
    checksum_combine: Optional[Callable] = None

    def kernel_for_entangled(self, g, plan: EntanglePlan):
        if g is not None and self.needs_kernel_entangled:
            return entangle_kernel_addsub(torch.as_tensor(g), plan)
        return g

    def checksum_prediction(self, d: torch.Tensor, g, M: int) -> torch.Tensor:
        if self.checksum_combine is not None:
            return self.checksum_combine(d, g, M)
        return sum_streams(d)


def _scale(c, g):
    return c * g


def _add(c, g):
    return c + g


def _sub(c, g):
    return c - g


def _wrap_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of int32 products over ``dim``, wrapping mod 2**32."""
    return torch.sum(x, dim=dim, dtype=torch.int32)


def _dot(c, g):
    """``c[s] . g`` per stream: g ``[N]`` -> ``[S]``, g ``[N, P]`` ->
    ``[S, P]``."""
    c, g = c.to(torch.int32), torch.as_tensor(g).to(torch.int32)
    if g.dim() == 1:
        return _wrap_sum(c * g, -1)
    return _wrap_sum(c.unsqueeze(-1) * g, -2)


def _outer(c, g):
    return c.to(torch.int32).unsqueeze(-1) * torch.as_tensor(g).to(torch.int32)


def _int_conv(c, g, flip: bool):
    """Exact integer 'full' convolution/correlation of each stream ``c[s]``
    ``[N]`` with ``g [K]`` -> ``[S, N + K - 1]``: a causal conv (taps
    flipped for the convolution) of the streams padded with K - 1 zeros on
    the right."""
    from repro_torch.kernels import ops

    g = torch.as_tensor(g).to(torch.int32)
    nk = g.shape[-1]
    kern = torch.flip(g, (-1,)) if flip else g
    x = torch.nn.functional.pad(c.to(torch.int32), (0, nk - 1))
    return ops.conv1d_causal(x.unsqueeze(1), kern.unsqueeze(0)).squeeze(1)


def _conv_full(c, g):
    return _int_conv(c, g, flip=True)


def _xcorr_full(c, g):
    return _int_conv(c, g, flip=False)


def _circular_conv(c, g):
    """The reference's ``dot(gg[idx].T, c)`` with ``idx = (i - j) mod n``:
    ``out[a] = sum_b gg[(b - a) mod n] c[b] = sum_k g[k] c[(a + k) mod n]``,
    one rolled product per tap instead of an [n, n] index matrix."""
    c = c.to(torch.int32)
    g = torch.as_tensor(g).to(torch.int32)
    out = torch.zeros_like(c)
    for k in range(g.shape[-1]):
        out += g[k] * torch.roll(c, -k, dims=-1)
    return out


def _permute(c, g):
    # g is a fixed index set (bijection I -> G): out[i] = c[g[i]]
    return c[..., torch.as_tensor(g).to(device=c.device, dtype=torch.long)]


def _identity(c, g):
    del g
    return c


OPS: Dict[str, LSBOp] = {
    op.name: op
    for op in [
        LSBOp("scale", _scale),
        # e = (sum_m c_m) + g = sum_m d_m - (M-1) g
        LSBOp("add", _add, needs_kernel_entangled=True,
              checksum_combine=lambda d, g, M: sum_streams(d) - (M - 1) * g),
        LSBOp("sub", _sub, needs_kernel_entangled=True,
              checksum_combine=lambda d, g, M: sum_streams(d) + (M - 1) * g),
        LSBOp("dot", _dot),
        LSBOp("outer", _outer),
        LSBOp("conv", _conv_full),
        LSBOp("xcorr", _xcorr_full),
        LSBOp("circconv", _circular_conv),
        LSBOp("permute", _permute),
        LSBOp("identity", _identity),
    ]
}


def get_op(name: str) -> LSBOp:
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(f"unknown LSB op {name!r}; known: {sorted(OPS)}") from None


def apply_streams(op: LSBOp, c: torch.Tensor, g) -> torch.Tensor:
    """An LSB op over the leading stream axis of ``c`` (one batched call
    where the reference ``vmap``s)."""
    return op.apply(c, g)
