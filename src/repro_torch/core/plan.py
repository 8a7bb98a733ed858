"""Entanglement parameter planning — paper Sec. III.B, Table I (the port's
copy of :mod:`repro.core.plan`, kept free of the JAX package).

Chooses the shift amount ``l`` and headroom ``k`` for ``M``-stream numerical
entanglement under a ``w``-bit integer representation, subject to the paper's
overflow constraint (eq. 12)::

    (M - 1) * l + k <= w,   k <= l,   l >= 1, k >= 1

The objective reproduced from Table I is the *output* bitwidth
``(M - 2) * l + k`` (ties broken toward larger ``k``); the supported output
dynamic range is eq. (13)::

    |d| <= 2^((M-3)l + k) * (2^(l-1) - 1)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EntanglePlan:
    """Static parameters of one entanglement configuration.

    Attributes:
      M: number of jointly-entangled streams (>= 3).
      w: logical integer width of each stream element, in bits (8/16/32).
      l: arithmetic-shift amount of the superposed stream (paper ``l``).
      k: headroom bits (paper ``k``).
      temp: implementation of the 2w-bit temporary of eq. (16):
        ``'int32'``   — plain int32 container (valid when (2M-3)l+k+1 <= 32),
        ``'dualword'``— two 32-bit words (hi:int32, lo:uint32); realization of
                        paper Remark 1 (the port carries it as
                        one int64 word),
        ``'int64np'`` — numpy int64 oracle (CPU reference only).
    """

    M: int
    w: int
    l: int
    k: int
    temp: str = "int32"

    def __post_init__(self):
        if self.M < 3:
            raise ValueError(f"entanglement needs M >= 3 streams, got M={self.M}")
        if not (1 <= self.k <= self.l):
            raise ValueError(f"need 1 <= k <= l, got l={self.l} k={self.k}")
        if (self.M - 1) * self.l + self.k > self.w:
            raise ValueError(
                f"overflow constraint (M-1)l+k <= w violated: "
                f"({self.M}-1)*{self.l}+{self.k} > {self.w}"
            )
        if self.temp not in ("int32", "dualword", "int64np"):
            raise ValueError(f"unknown temp mode {self.temp!r}")
        if self.temp == "int32" and self.temp_bits > 32:
            raise ValueError(
                f"temp mode 'int32' needs (2M-3)l+k+1 <= 32, got {self.temp_bits}"
            )

    # ---- derived quantities -------------------------------------------------

    @property
    def output_bits(self) -> int:
        """Usable output bitwidth, Table I column '(M-2)l + k'."""
        return (self.M - 2) * self.l + self.k

    @property
    def temp_bits(self) -> int:
        """Bits needed by the eq. (16) temporary: (2M-3)l + k + 1."""
        return (2 * self.M - 3) * self.l + self.k + 1

    @property
    def max_output_magnitude(self) -> int:
        """Largest |d| any LSB output may take — paper eq. (13)."""
        return (1 << ((self.M - 3) * self.l + self.k)) * ((1 << (self.l - 1)) - 1)

    @property
    def max_output_magnitude_tight(self) -> int:
        """Exact sufficient output bound (beyond-paper).

        Eq. (13) is conservative and collapses to 0 at ``l == 1`` (e.g. the
        M=32 Table I row). The scheme only needs:
          (a) entangled outputs fit w bits:  (2^l + 1) * D <= 2^(w-1) - 1
          (b) low-word extraction:           D <= 2^((M-1)l - 1) - 1
          (c) d_temp fits its container:     (2^((M-1)l) + 1) * D <= 2^(cap-1) - 1
        """
        cap = 32 if self.temp == "int32" else 64
        a = ((1 << (self.w - 1)) - 1) // ((1 << self.l) + 1)
        b = (1 << ((self.M - 1) * self.l - 1)) - 1
        c = ((1 << (cap - 1)) - 1) // ((1 << ((self.M - 1) * self.l)) + 1)
        return min(a, b, c)

    @property
    def container_bits(self) -> int:
        """Bits of the integer container used to store streams on device."""
        return 32 if self.w > 16 else (16 if self.w > 8 else 8)

    def headroom_for_reduction(self, depth: int) -> int:
        """Bits of |d| budget consumed by an exact sum of ``depth`` terms."""
        return max(0, math.ceil(math.log2(max(depth, 1))))


def plan_lk(M: int, w: int = 32, headroom_bits: int = 0) -> tuple[int, int]:
    """Choose (l, k) reproducing paper Table I.

    Maximizes output bitwidth (M-2)l + k subject to eq. (12), k <= l; ties
    broken toward larger k (matches every Table I row). ``headroom_bits``
    shrinks the effective width budget — used when the LSB op is a deep
    reduction (e.g. an R-term dot product or cross-replica gradient sum needs
    ceil(log2 R) extra bits of output headroom).
    """
    w_eff = w - headroom_bits
    best: Optional[tuple[int, int]] = None
    best_key = None
    for l in range(1, w_eff + 1):
        k = min(l, w_eff - (M - 1) * l)
        if k < 1:
            continue
        key = ((M - 2) * l + k, k)
        if best_key is None or key > best_key:
            best_key, best = key, (l, k)
    if best is None:
        raise ValueError(f"no feasible (l,k) for M={M}, w={w}, headroom={headroom_bits}")
    return best


def make_plan(
    M: int,
    w: int = 32,
    headroom_bits: int = 0,
    temp: Optional[str] = None,
) -> EntanglePlan:
    """Plan (l,k) and pick the widest-compatible temp mode automatically."""
    l, k = plan_lk(M, w, headroom_bits)
    if temp is None:
        temp_bits = (2 * M - 3) * l + k + 1
        temp = "int32" if temp_bits <= 32 else "dualword"
    return EntanglePlan(M=M, w=w, l=l, k=k, temp=temp)


def checksum_output_bits(M: int, w: int = 32) -> int:
    """Output bitwidth of the checksum-based method, Table I right column."""
    return w - math.ceil(math.log2(M))


def container_dtype(plan: EntanglePlan):
    """numpy dtype of the stream container of a ``w``-bit plan (the
    reference's; the port's codec itself keeps int32 words)."""
    return {8: np.int8, 16: np.int16, 32: np.int32}[plan.container_bits]
