"""Plan registry: one :class:`ProtectionPlan` per (site, call shape) of a
protected GEMM (port of :mod:`repro.ft.registry`).

The serving engine builds ONE registry at startup; every protected
projection resolves its plan here, so the whole forward pass shares a
single :class:`~repro_torch.core.plan.EntanglePlan`. The engine's
census-only forward pass populates it, and
:func:`repro_torch.ft.plans.compile_plans` then freezes it.

A plain site's shape is ``(M, Bg, K, N)``: ``Bg`` rows per stream (the
flattened row count padded to a multiple of M, divided by M). A grouped
(MoE per-expert) site's shape is ``(M, E, Bg, K, N)`` with ``grouped=True``;
``Bg`` then counts per-expert rows per stream. The reference also
keys plans by kernel backend and carries TPU block sizes; the port's only
kernel picks its own tiling from the shape, so neither exists here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.plan import EntanglePlan


def group_rows(rows: int, M: int) -> int:
    """Per-group row count after padding ``rows`` to a multiple of M."""
    return -(-rows // M)


@dataclasses.dataclass(frozen=True)
class ProtectionPlan:
    """Immutable protection parameters of one GEMM site at one call shape."""

    site: str
    shape: tuple  # (M, Bg, K, N), or (M, E, Bg, K, N) when grouped
    plan: EntanglePlan
    grouped: bool = False


class PlanRegistry:
    """(site, shape) -> :class:`ProtectionPlan` map."""

    def __init__(self, plan: EntanglePlan):
        self.plan = plan
        self._entries: dict[tuple, ProtectionPlan] = {}
        # fanout site groups noted by the census: sites consuming the same
        # activations, which share one quantize/permute pass
        self._chains: set[tuple] = set()

    def shape_for(self, rows: int, K: int, N: int,
                  groups: Optional[int] = None) -> tuple:
        """The kernel-call shape key of a site invocation over ``rows``
        flattened samples (per expert when ``groups`` is given)."""
        Bg = group_rows(rows, self.plan.M)
        if groups is None:
            return (self.plan.M, Bg, K, N)
        return (self.plan.M, groups, Bg, K, N)

    def entry(self, site: str, rows: int, K: int, N: int, *,
              groups: Optional[int] = None) -> ProtectionPlan:
        """Resolve (creating on first use) the plan for one call site."""
        shape = self.shape_for(rows, K, N, groups)
        e = self._entries.get((site, shape))
        if e is None:
            e = ProtectionPlan(site=site, shape=shape, plan=self.plan,
                               grouped=groups is not None)
            self._entries[(site, shape)] = e
        return e

    def note_chain(self, sites: tuple) -> None:
        """Record one fanout site group."""
        if len(sites) >= 2:
            self._chains.add(tuple(sites))

    def chains(self) -> frozenset:
        return frozenset(self._chains)

    def entries(self) -> list:
        return list(self._entries.values())

    def census(self) -> dict:
        """{(site, shape): plan} over every registered entry."""
        return {(e.site, e.shape): e for e in self._entries.values()}
