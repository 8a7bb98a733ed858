"""Checksum-based ABFT baseline — paper Sec. II.A, eq. (3)-(5); port of
:mod:`repro.core.checksum`.

One additional stream ``r = sum_m c_m`` is created and processed alongside
the M originals on an (M+1)-th core. Any single fail-stop among the M+1
streams is recovered:

  * failed data stream m:  d_m = e - sum_{m' != m} d_m'   (op-corrected)
  * failed checksum stream: nothing to recover (outputs unaffected).

The sums over the streams run through
:func:`repro_torch.kernels.ops.checksum` (the hand-written checksum kernel
on a CUDA tensor): a stream ``axis`` other than 0 is moved to the front
first, as the reference's ``moveaxis`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lsb_ops import LSBOp, sum_streams


def make_checksum_stream(c: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """r_n = sum_m c_{m,n} over the stream axis ``axis`` (eq. 4), int32
    wrapping mod 2**32. The caller owns the reduced dynamic range budget
    (w - ceil(log2 M) bits, Table I)."""
    return sum_streams(torch.movedim(c, axis, 0).contiguous())


def attach_checksum(c: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Stack the checksum stream as stream index M along ``axis`` (eq. 5
    left-hand side)."""
    r = make_checksum_stream(c, axis=axis)
    return torch.cat([c.to(torch.int32), r.unsqueeze(axis)], dim=axis)


def recover_from_checksum(outputs: torch.Tensor, op: LSBOp, g,
                          failed: Optional[int],
                          axis: int = 0) -> torch.Tensor:
    """Recover the M true outputs from M+1 streams with stream ``failed``
    lost.

    Args:
      outputs: [M+1, ...] op outputs along ``axis``; the last stream is
        the checksum stream's output ``e = op(r, g)``.
      failed: lost stream index in [0, M] (M = checksum stream) or None.

    Returns:
      [M, ...] recovered outputs along ``axis``; stream ``failed`` is never
      read.
    """
    outputs = torch.movedim(outputs, axis, 0)
    M = outputs.shape[0] - 1
    d, e = outputs[:M], outputs[M]
    if failed is None or failed == M:
        return torch.movedim(d, 0, axis)
    f = int(failed)
    others = sum_streams(d.contiguous()) - d[f]
    # e == op-corrected sum of all d's; invert for the missing one.
    corr = op.checksum_prediction(torch.zeros_like(d), g, M)
    res = d.clone()
    res[f] = e - corr - others
    return torch.movedim(res, 0, axis)
