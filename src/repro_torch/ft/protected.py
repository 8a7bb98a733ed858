"""Protected GEMMs — the paper's entangled roll-forward around the serving
path's projections (port of the serving part of :mod:`repro.ft.protected`).

:func:`protected_matmul` is the one code path every protected projection
runs through: float activations of any leading shape are flattened to
rows, quantized per row onto the plan's eq. (13) integer grid, padded with
zero rows to a multiple of M (exact: zeros entangle to zeros), mapped
round-robin onto the M entangled streams (row -> group = row % M), and
pushed through the fused kernel behind :mod:`repro_torch.kernels.ops`:
entangle-on-load, int GEMM, extraction in the epilogue, one kernel call.
A fail-stopped group's accumulator is excluded from the extraction
(``failed=r``), so its outputs are rolled forward from the other M-1
streams and the recovered integers equal a healthy run's bit for bit.

:func:`protected_matmul_grouped` is the grouped (per-expert) twin for MoE:
activations ``[..., E, C, K]`` against per-expert weights ``[E, K, N]``
run as ONE grouped entangled kernel call — rows map round-robin onto the M
streams *within each expert*, so recovery holds independently and
identically for every expert.

:func:`entangled_chain` runs consecutive linear GEMMs inside the entangled
domain (one entangle, one extraction) when the plan's headroom allows it,
and :class:`ProtectedLinear` is the executor over one compiled plan.

:class:`FTContext` is threaded through the model (``models/api.py ->
transformer.apply_stack -> layers``): it decides which site categories the
configured ``ft_scope`` protects, resolves each site's plan, and carries
the ``failed_group`` of the current step. Site names are
``"<category>.<proj>"``:

  ``head``  the vocab projection (always protected when FT is on)
  ``qkv``   mixer input projections: attention Q/K/V, MLA q and kv_a
  ``mlp``   FFN projections: MLP gate/up/down (dense and MoE-shared) and
            the MoE router
  ``out``   the attention / MLA output projection
  ``moe``   MoE per-expert gate/up/down GEMMs (the grouped kernel)
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Union

import torch

from repro_torch.core.entangle import disentangle as core_disentangle
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import EntanglePlan
from repro_torch.ft.quantize import (chain_budget, quantize_acts,
                                     quantize_weight, quantize_weight_stacked)
from repro_torch.ft.registry import PlanRegistry, ProtectionPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.codec import unpack_int8

# scope -> protected site categories (cumulative; head is always in)
SCOPES: dict[str, frozenset] = {
    "head": frozenset({"head"}),
    "qkv": frozenset({"head", "qkv"}),
    "mlp": frozenset({"head", "mlp"}),
    "out": frozenset({"head", "out"}),
    "moe": frozenset({"head", "moe"}),
    "all": frozenset({"head", "qkv", "mlp", "out", "moe"}),
}

# float weight, or (int8-range int32 weights, scale) pre-quantized at startup
Weight = Union[torch.Tensor, tuple]


def group_order(R: int, M: int, device=None) -> tuple:
    """Permutation realizing round-robin grouping (row -> group = row % M)
    on a contiguous [M, R/M] stream layout: ``order[g * R//M + j] = j * M +
    g``; ``inv`` undoes it. Built on ``device`` (no host-to-device copy on
    the serving path)."""
    if R % M:
        raise ValueError(f"row count {R} must split into M={M} groups")
    order = torch.arange(R, device=device).reshape(R // M, M).T.reshape(R)
    return order, torch.argsort(order)


def _split_weight(w: Weight) -> tuple:
    """(wq, w_scale) from a float master or a pre-quantized pair."""
    return w if isinstance(w, tuple) else quantize_weight(w)


def _is_packed(wq: torch.Tensor, K: int) -> bool:
    """A packed copy carries ceil(K/4) words along the contraction axis."""
    return wq.shape[-2] != K


def _unpacked_f32(wq: torch.Tensor, K: int) -> torch.Tensor:
    """Float view of a maybe-packed weight [..., K, N] (the census only
    needs shapes)."""
    if _is_packed(wq, K):
        wq = unpack_int8(wq, axis=-2, n=K)
    return wq.to(torch.float32)


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def _grouped_acts(x: torch.Tensor, plan: EntanglePlan, contiguous: bool,
                  budget: Optional[int] = None):
    """Quantize (onto ``budget``'s grid, if given) + pad + group-permute:
    returns (xg [M, Rp/M, K] int32, per-row scale [R, 1], inverse
    permutation or None, Rp)."""
    R, K = _rows(x), x.shape[-1]
    M = plan.M
    xq, a_scale = quantize_acts(x.reshape(R, K), plan, K, budget=budget)
    pad = (-R) % M
    if pad:
        xq = torch.cat([xq, xq.new_zeros((pad, K))], dim=0)
    Rp = R + pad
    if contiguous:
        return xq.reshape(M, Rp // M, K), a_scale, None, Rp
    order, inv = group_order(Rp, M, device=x.device)
    return xq[order].reshape(M, Rp // M, K).contiguous(), a_scale, inv, Rp


def _dequant(rec: torch.Tensor, inv, R: int, a_scale, w_scale,
             lead: tuple) -> torch.Tensor:
    N = rec.shape[-1]
    y = rec.reshape(-1, N).to(torch.float32)
    if inv is not None:
        y = y[inv]
    y = y[:R] / (a_scale * w_scale)
    return y.reshape(*lead, N)


def protected_matmul(
    x: torch.Tensor,  # [..., K] float activations
    w: Weight,  # [K, N] float weights, or (wq, w_scale) pre-quantized
    *,
    plan: EntanglePlan,
    failed_group: Optional[int] = None,
    fuse_epilogue: bool = True,
    contiguous: bool = False,
    blocks=None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Entangled int8 GEMM with in-kernel fail-stop roll-forward.

    Returns dequantized float32 outputs ``[..., N]``. ``contiguous=True``
    keeps the caller's row order as the [M, R/M] group layout; the default
    maps rows round-robin onto groups. ``fuse_epilogue=False`` runs the
    unfused path: the kernel returns raw entangled accumulators, the failed
    group's are overwritten with GARBAGE, and a separate disentangle
    recovers them (the reference the fused path is held against).
    ``blocks`` and ``backend`` go to the kernel call
    (:mod:`repro_torch.kernels.ops`).
    """
    wq, w_scale = _split_weight(w)
    lead, K = tuple(x.shape[:-1]), x.shape[-1]
    packed = _is_packed(wq, K)
    xg, a_scale, inv, _ = _grouped_acts(x, plan, contiguous)
    if fuse_epilogue:
        rec = kops.entangled_matmul(xg, wq, plan, fuse_epilogue=True,
                                    failed=failed_group, packed=packed,
                                    blocks=blocks, backend=backend)
    else:
        delta = kops.entangled_matmul(xg, wq, plan, packed=packed,
                                      blocks=blocks, backend=backend)
        if failed_group is not None:
            delta = delta.clone()
            delta[failed_group] = GARBAGE
        rec = core_disentangle(delta, plan, failed=failed_group)
    return _dequant(rec, inv, _rows(x), a_scale, w_scale, lead)


def protected_matmul_grouped(
    x: torch.Tensor,  # [..., E, C, K] float activations (C rows per expert)
    w: Weight,  # [E, K, N] float, or (wq [E, K, N], w_scale scalar or [E])
    *,
    plan: EntanglePlan,
    failed_group: Optional[int] = None,
    fuse_epilogue: bool = True,
    blocks=None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Grouped (per-expert) entangled int8 GEMM — the MoE form.

    Expert e's C rows (times any leading batch axes) multiply expert e's
    [K, N] weights; all E GEMMs run in ONE grouped kernel call. Rows map
    round-robin onto the M streams within each expert, zero rows pad each
    expert's bucket to a multiple of M (exact), and ``failed_group``
    excludes that stream's accumulators from the extraction, so every
    expert's outputs roll forward at once. A float ``w`` is quantized per
    expert. ``fuse_epilogue=False`` is the unfused path, as in
    :func:`protected_matmul`, and so are ``blocks`` and ``backend``.
    Returns dequantized float32 ``[..., E, C, N]``.
    """
    if isinstance(w, tuple):
        wq, w_scale = w
    else:
        q8 = quantize_weight_stacked(w)  # per-expert grids
        wq, w_scale = q8["w"], q8["scale"]
    E, N = wq.shape[0], wq.shape[2]
    K = x.shape[-1]
    lead, C = tuple(x.shape[:-3]), x.shape[-2]
    if x.shape[-3] != E:
        raise ValueError(f"activations {tuple(x.shape)} do not match "
                         f"{E} experts")
    L = math.prod(lead)
    R = L * C  # rows per expert
    M = plan.M
    # [..., E, C, K] -> [E, R, K]: expert-major rows, leading axes folded
    xf = x.reshape(L, E, C, K).transpose(0, 1).reshape(E, R, K)
    xq, a_scale = quantize_acts(xf, plan, K)
    pad = (-R) % M
    if pad:
        xq = torch.cat([xq, xq.new_zeros((E, pad, K))], dim=1)
    Rp = R + pad
    order, inv = group_order(Rp, M, device=x.device)
    # per-expert round-robin onto streams: [E, Rp, K] -> [M, E, Rp/M, K]
    xg = xq[:, order].reshape(E, M, Rp // M, K).transpose(0, 1).contiguous()
    packed = _is_packed(wq, K)
    if fuse_epilogue:
        rec = kops.entangled_matmul_grouped(
            xg, wq, plan, fuse_epilogue=True, failed=failed_group,
            packed=packed, blocks=blocks, backend=backend)
    else:
        delta = kops.entangled_matmul_grouped(xg, wq, plan, packed=packed,
                                              blocks=blocks, backend=backend)
        if failed_group is not None:
            delta = delta.clone()
            delta[failed_group] = GARBAGE
        rec = core_disentangle(delta, plan, failed=failed_group)
    y = rec.transpose(0, 1).reshape(E, Rp, N).to(torch.float32)
    y = y[:, inv][:, :R]
    w_s = torch.as_tensor(w_scale)
    scale = a_scale * (w_s if w_s.dim() == 0 else w_s[:, None, None])
    y = y / scale
    return y.reshape(E, L, C, N).transpose(0, 1).reshape(*lead, E, C, N)


def entangled_chain(
    x: torch.Tensor,  # [..., K] float activations of the FIRST hop
    ws: list,  # per-hop weights: float [K_i, N_i] or (wq, w_scale) pairs
    *,
    plan: EntanglePlan,
    failed_group: Optional[int] = None,
    contiguous: bool = False,
    blocks=None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """N consecutive strictly-linear protected GEMMs that never leave the
    entangled domain: one entangle, N GEMMs, one extraction.

    Entanglement is linear over streams, so ``(E c) @ g = E (c @ g)``:
    the first hop entangles on load and returns raw entangled accumulators
    (``fuse_epilogue=False``), every middle hop multiplies them through
    per stream (``'chain'``: no entangle, no extraction), and the last
    hop extracts at its flush (``'chain_final'``) without reading
    ``failed_group``'s stream. A fail-stopped stream's garbage stays in
    its own stream, so the roll-forward is exact for any single failed
    stream.

    The one extraction must absorb the whole chain's amplification, so
    the first hop quantizes onto :func:`~repro_torch.ft.quantize.
    chain_budget`'s grid. When that budget is 0 (infeasible under this
    plan), or for a single hop, each hop runs as its own
    :func:`protected_matmul` (one extraction per hop, requantizing
    between hops). ``blocks`` is None or one blocks policy per hop, and
    ``backend`` names the kernel backend. Returns dequantized float32
    outputs ``[..., N_last]``.
    """
    if not ws:
        raise ValueError("entangled_chain needs at least one hop")
    bl = list(blocks) if blocks is not None else [None] * len(ws)
    if len(bl) != len(ws):
        raise ValueError(f"{len(bl)} blocks policies for {len(ws)} hops")
    split = [_split_weight(w) for w in ws]
    lead, K = tuple(x.shape[:-1]), x.shape[-1]
    # a packed hop's true N is its column count (packing runs along K)
    depths = [K] + [wq.shape[1] for wq, _ in split[:-1]]
    budget = chain_budget(plan, depths)
    if budget < 1 or len(ws) == 1:
        y = x
        for w, b in zip(ws, bl):
            y = protected_matmul(y, w, plan=plan, failed_group=failed_group,
                                 contiguous=contiguous, blocks=b,
                                 backend=backend)
        return y
    cur, a_scale, inv, _ = _grouped_acts(x, plan, contiguous, budget=budget)
    depth = K
    for i, (wq, _) in enumerate(split):
        mode = (False if i == 0 else
                "chain_final" if i == len(split) - 1 else "chain")
        cur = kops.entangled_matmul(cur, wq, plan, fuse_epilogue=mode,
                                    failed=failed_group,
                                    packed=_is_packed(wq, depth),
                                    blocks=bl[i], backend=backend)
        depth = wq.shape[1]
    w_prod = 1.0
    for _, w_scale in split:
        w_prod = w_prod * w_scale
    return _dequant(cur, inv, _rows(x), a_scale, w_prod, lead)


@dataclasses.dataclass(frozen=True)
class ProtectedLinear:
    """Thin executor over ONE :class:`ProtectionPlan`: the plan (site,
    shape, entanglement parameters, backend, launch parameters,
    grouped-ness) is fixed at construction, and a call runs
    :func:`protected_matmul` (or :func:`protected_matmul_grouped` for a
    grouped site) with it."""

    plan: ProtectionPlan

    def __call__(self, x: torch.Tensor, w: Weight, *,
                 failed_group: Optional[int] = None,
                 contiguous: bool = False) -> torch.Tensor:
        p = self.plan
        if p.grouped:
            return protected_matmul_grouped(
                x, w, plan=p.plan, failed_group=failed_group,
                blocks=p.blocks, backend=p.backend)
        return protected_matmul(x, w, plan=p.plan, failed_group=failed_group,
                                contiguous=contiguous, blocks=p.blocks,
                                backend=p.backend)


@dataclasses.dataclass(frozen=True)
class FTContext:
    """Protection context threaded through the model forward pass.

    ``plans`` is the immutable :class:`~repro_torch.ft.plans.CompiledPlans`
    the engine builds at startup; a lookup miss (a census gap) falls back
    to a lazily created registry entry with a warning and is counted in
    ``plans.misses``. ``census_only=True`` turns :meth:`matmul` into a
    plain float einsum that only REGISTERS the call shape: the engine runs
    the forward pass on the ``meta`` device with such a context to list
    every protected shape without running a kernel.
    """

    registry: PlanRegistry
    scope: str = "head"
    failed_group: Optional[int] = None
    census_only: bool = False
    plans: Optional[object] = None  # repro_torch.ft.plans.CompiledPlans

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"unknown ft_scope {self.scope!r}; expected "
                             f"one of {sorted(SCOPES)}")

    def protects(self, site: str) -> bool:
        return site.split(".", 1)[0] in SCOPES[self.scope]

    def with_failed(self, failed_group: Optional[int]) -> "FTContext":
        return dataclasses.replace(self, failed_group=failed_group)

    def with_plans(self, plans) -> "FTContext":
        return dataclasses.replace(self, plans=plans)

    def _resolve(self, site: str, rows: int, K: int, N: int,
                 groups: Optional[int] = None) -> ProtectionPlan:
        if self.plans is not None:
            shape = self.registry.shape_for(rows, K, N, groups)
            p = self.plans.lookup(site, shape)
            if p is not None:
                return p
            warnings.warn(
                f"protected site {site!r} shape {shape} is missing from the "
                f"compiled plans (startup census gap); creating a lazy "
                f"registry entry", RuntimeWarning)
        return self.registry.entry(site, rows, K, N, groups=groups)

    def matmul(self, site: str, x: torch.Tensor, w: Weight) -> torch.Tensor:
        """Run (or, census-only, record) one protected GEMM site."""
        wq = w[0] if isinstance(w, tuple) else w
        # K comes from the activations: a packed copy holds ceil(K/4) words
        K, N = x.shape[-1], wq.shape[-1]
        if self.census_only:
            self.registry.entry(site, _rows(x), K, N)
            return torch.einsum("...k,kn->...n", x.to(torch.float32),
                                _unpacked_f32(wq, K))
        p = self._resolve(site, _rows(x), K, N)
        return ProtectedLinear(p)(x, w, failed_group=self.failed_group)

    def matmul_fanout(self, sites: tuple, x: torch.Tensor,
                      ws: tuple) -> list:
        """Run (or record) a FANOUT site group: every site multiplies the
        SAME activations ``x`` against its own weight. The group shares
        one quantize + pad + permute pass and each member runs its own
        fused kernel call; bit-identical to per-site :meth:`matmul` calls
        (the grid depends only on x, plan and K)."""
        if self.census_only:
            self.registry.note_chain(tuple(sites))
            return [self.matmul(s, x, w) for s, w in zip(sites, ws)]
        K, rows = x.shape[-1], _rows(x)
        plans = [self._resolve(s, rows, K, _split_weight(w)[0].shape[-1])
                 for s, w in zip(sites, ws)]
        plan = plans[0].plan
        xg, a_scale, inv, _ = _grouped_acts(x, plan, contiguous=False)
        outs = []
        for p, w in zip(plans, ws):
            wq, w_scale = _split_weight(w)
            rec = kops.entangled_matmul(
                xg, wq, p.plan, fuse_epilogue=True, failed=self.failed_group,
                packed=_is_packed(wq, K), blocks=p.blocks,
                backend=p.backend)
            outs.append(_dequant(rec, inv, rows, a_scale, w_scale,
                                 tuple(x.shape[:-1])))
        return outs

    def matmul_grouped(self, site: str, x: torch.Tensor,
                       w: Weight) -> torch.Tensor:
        """Run (or, census-only, record) one grouped per-expert protected
        GEMM site: x ``[..., E, C, K]`` against per-expert weights
        ``[E, K, N]``."""
        wq = w[0] if isinstance(w, tuple) else w
        E, N = wq.shape[-3], wq.shape[-1]
        K = x.shape[-1]
        rows = math.prod(x.shape[:-3]) * x.shape[-2]
        if self.census_only:
            self.registry.entry(site, rows, K, N, groups=E)
            return torch.einsum("...eck,ekn->...ecn", x.to(torch.float32),
                                _unpacked_f32(wq, K))
        p = self._resolve(site, rows, K, N, groups=E)
        return ProtectedLinear(p)(x, w, failed_group=self.failed_group)
