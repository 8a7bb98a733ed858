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
``Bg`` then counts per-expert rows per stream.

Each plan carries the kernel ``backend`` its calls name (None: the
device rule of :func:`repro_torch.kernels.ops.resolve_backend`) and its
``blocks``, the registry's policy:

  * policy ``None`` — None: the launcher's rule, which picks the tiles for
    the kernel the call reaches (packed weights: the s8 kernel; float or
    unpacked weights: the CUDA-core kernel) and the card's SM count.
    :func:`default_blocks` reports what that rule picks for the engine's
    packed, fused calls; the reference's plans carry its block sizes
    because its Pallas wrapper's defaults do not fit a decode batch;
  * policy ``"auto"`` — :mod:`repro_torch.kernels.autotune`; the engine's
    ``warm_autotune`` sweeps every registered shape at startup, so each
    call is a cache hit;
  * a dict — that dict, for every site (the engine gives its layer sites
    the ``None`` policy: a user's dict targets the head's shape).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.plan import EntanglePlan


def group_rows(rows: int, M: int) -> int:
    """Per-group row count after padding ``rows`` to a multiple of M."""
    return -(-rows // M)


def default_blocks(Bg: int, K: int, N: int, *, M: int = 4,
                   sms: Optional[int] = None) -> dict:
    """The rule's launch tiles, ``{"bb", "splits"}``, of one (Bg, K, N)
    protected GEMM as the engine runs it (packed weights, the fused
    extraction: the s8 kernel over M - 1 computed streams) on a card of
    ``sms`` SMs (default: an H100's). For reporting: a plan under the
    ``None`` policy passes None, and the launcher applies this rule
    itself."""
    from repro_torch.kernels import entangled_matmul as emm

    return emm.rule_blocks("s8", M, 1, Bg, K, N, True,
                           sms or emm.SMS_H100)


@dataclasses.dataclass(frozen=True)
class ProtectionPlan:
    """Immutable protection parameters of one GEMM site at one call shape."""

    site: str
    shape: tuple  # (M, Bg, K, N), or (M, E, Bg, K, N) when grouped
    plan: EntanglePlan
    grouped: bool = False
    backend: Optional[str] = None  # None: the device rule
    blocks: object = None  # None | dict | "auto", passed to kernels.ops


# the reference's older name of the same record
PlanEntry = ProtectionPlan


class PlanRegistry:
    """(site, shape) -> :class:`ProtectionPlan` map; ``blocks`` is the
    policy its plans carry, ``backend`` the kernel backend they name."""

    def __init__(self, plan: EntanglePlan, *, blocks: object = None,
                 backend: Optional[str] = None):
        self.plan = plan
        self.blocks_policy = blocks
        self.backend = backend
        self._entries: dict[tuple, ProtectionPlan] = {}
        # fanout site groups noted by the census: sites consuming the same
        # activations, which share one quantize/permute pass
        self._chains: set[tuple] = set()

    @staticmethod
    def key(site: str, shape: tuple, M: Optional[int] = None,
            backend: Optional[str] = None) -> tuple:
        """An entry's key, with the reference's signature. A registry
        holds one plan (one M) and one backend, so the port keys its
        entries by ``(site, shape)`` alone; ``M`` and ``backend`` are
        taken and not part of the key."""
        return (site, shape)

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
        e = self._entries.get(self.key(site, shape))
        if e is None:
            e = ProtectionPlan(site=site, shape=shape, plan=self.plan,
                               grouped=groups is not None,
                               backend=self.backend,
                               blocks=self.blocks_policy)
            self._entries[self.key(site, shape)] = e
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
        """{(site, shape): plan} over every registered entry (what
        ``warm_autotune`` iterates; grouped sites carry 5-tuple shapes)."""
        return {(e.site, e.shape): e for e in self._entries.values()}

    def get(self, site: str, shape: tuple,
            backend: Optional[str] = None) -> Optional[ProtectionPlan]:
        """The entry of ``(site, shape)``, or None; a ``backend`` other
        than the one the registry's plans name finds none."""
        e = self._entries.get(self.key(site, shape))
        if e is None or (backend is not None and backend != self.backend):
            return None
        return e
