"""Numerical entanglement — the paper's core contribution (Sec. III), port
of :mod:`repro.core.entangle`.

Entanglement (eq. 6 / 14 / 15) overwrites each of ``M >= 3`` integer
streams by the superposition of itself and its cyclic predecessor
left-shifted by ``l`` bits::

    eps_m = S_l{ c_{(m-1) mod M} } + c_m

Disentanglement (eq. 16-19) recovers all ``M`` outputs from any ``M-1``
entangled outputs with adds and arithmetic shifts only; the shared row
math lives in :func:`repro_torch.kernels.codec.disentangle_rows` (int32
and dual-word temporaries). All arithmetic is two's-complement ring
arithmetic mod 2**32, exactly as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels.codec import disentangle_rows, entangle_block

__all__ = ["entangle", "disentangle", "extract", "entangle_kernel_addsub",
           "reentangle_stream", "disentangle_oracle_np"]

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8)


def _check_streams(x: torch.Tensor, plan: EntanglePlan, axis: int) -> None:
    if x.shape[axis] != plan.M:
        raise ValueError(
            f"stream axis {axis} has size {x.shape[axis]}, expected M={plan.M}")
    if x.dtype not in _INT_DTYPES:
        raise TypeError(f"entanglement operates on integer streams, got {x.dtype}")


def entangle(c: torch.Tensor, plan: EntanglePlan, axis: int = 0) -> torch.Tensor:
    """Apply the circulant entanglement operator E (eq. 14/15); int32 out."""
    _check_streams(c, plan, axis)
    return torch.movedim(entangle_block(torch.movedim(c, axis, 0), plan.l),
                         0, axis)


def entangle_kernel_addsub(g: torch.Tensor, plan: EntanglePlan) -> torch.Tensor:
    """Self-entangle the kernel for op in {+, -} (paper footnote 3)."""
    g = g.to(torch.int32)
    return (g << plan.l) + g


def disentangle(delta: torch.Tensor, plan: EntanglePlan,
                failed: Optional[int] = None, axis: int = 0) -> torch.Tensor:
    """Recover all M true outputs from entangled outputs (eq. 16-19).

    ``failed`` is the fail-stopped stream, which is never read (its slot
    may hold garbage); ``None`` means no failure, and stream 0 is then the
    one not consulted. Returns int32, original stream order.
    """
    _check_streams(delta, plan, axis)
    d = torch.movedim(delta, axis, 0).to(torch.int32)
    r = 0 if failed is None else int(failed) % plan.M
    out = torch.stack(disentangle_rows([d[m] for m in range(plan.M)], plan, r))
    return torch.movedim(out, 0, axis)


def extract(delta: torch.Tensor, plan: EntanglePlan, axis: int = 0) -> torch.Tensor:
    """Failure-free extraction of results (same mechanism, r := 0)."""
    return disentangle(delta, plan, failed=None, axis=axis)


def reentangle_stream(recovered: torch.Tensor, plan: EntanglePlan,
                      stream: int) -> torch.Tensor:
    """Recreate the lost entangled stream ``delta_stream`` from the
    recovered d's, streams on the leading axis: ``delta_m = S_l{d_{m-1}} +
    d_m`` (roll-forward repair of persisted entangled state)."""
    d = recovered
    m = stream % plan.M
    return (d[(m - 1) % plan.M] << plan.l) + d[m]


def disentangle_oracle_np(delta: np.ndarray, plan: EntanglePlan,
                          failed: Optional[int] = None) -> np.ndarray:
    """Disentanglement in numpy int64 (the reference's CPU oracle), streams
    on the leading axis; stream ``failed`` is never read."""
    M, l = plan.M, plan.l
    r = 0 if failed is None else int(failed) % M
    B = (M - 1) * l
    sign = -1 if (M % 2) else 1
    q = (r + M - 1) % M

    d64 = delta.astype(np.int64)
    t = d64[(r + 1) % M].copy()
    for m in range(2, M):
        t = t << l
        t = (t - d64[(r + m) % M]) if (m % 2 == 0) else (t + d64[(r + m) % M])
    t_lo = (t << (64 - B)) >> (64 - B)  # the low B bits, sign-extended
    d_q = sign * t_lo
    d_r = (t - t_lo) >> B

    out = [None] * M
    out[r], out[q] = d_r, d_q
    for m in range(1, M - 1):
        idx = (r + m) % M
        out[idx] = d64[idx] - (out[(r + m - 1) % M] << l)
    return np.stack(out, axis=0).astype(np.int64)
