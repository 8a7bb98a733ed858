"""Checksum-based ABFT baseline — paper Sec. II.A, eq. (3)-(5); port of
:mod:`repro.core.checksum`.

One additional stream ``r = sum_m c_m`` is created and processed alongside
the M originals on an (M+1)-th core. Any single fail-stop among the M+1
streams is recovered:

  * failed data stream m:  d_m = e - sum_{m' != m} d_m'   (op-corrected)
  * failed checksum stream: nothing to recover (outputs unaffected).

The sums over the streams run through
:func:`repro_torch.kernels.ops.checksum` (the hand-written checksum kernel
on a CUDA tensor).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lsb_ops import LSBOp, sum_streams


def make_checksum_stream(c: torch.Tensor) -> torch.Tensor:
    """r_n = sum_m c_{m,n} over the leading stream axis (eq. 4), int32
    wrapping mod 2**32. The caller owns the reduced dynamic range budget
    (w - ceil(log2 M) bits, Table I)."""
    return sum_streams(c)


def attach_checksum(c: torch.Tensor) -> torch.Tensor:
    """Stack the checksum stream as stream index M (eq. 5 left-hand
    side)."""
    r = make_checksum_stream(c)
    return torch.cat([c.to(torch.int32), r.unsqueeze(0)], dim=0)


def recover_from_checksum(outputs: torch.Tensor, op: LSBOp, g,
                          failed: Optional[int]) -> torch.Tensor:
    """Recover the M true outputs from M+1 streams with stream ``failed``
    lost.

    Args:
      outputs: [M+1, ...] op outputs, last stream is the checksum stream's
        output ``e = op(r, g)``.
      failed: lost stream index in [0, M] (M = checksum stream) or None.

    Returns:
      [M, ...] recovered outputs; stream ``failed`` is never read.
    """
    M = outputs.shape[0] - 1
    d, e = outputs[:M], outputs[M]
    if failed is None or failed == M:
        return d
    f = int(failed)
    others = sum_streams(d) - d[f]
    # e == op-corrected sum of all d's; invert for the missing one.
    corr = op.checksum_prediction(torch.zeros_like(d), g, M)
    res = d.clone()
    res[f] = e - corr - others
    return res
