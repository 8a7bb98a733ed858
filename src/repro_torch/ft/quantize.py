"""Int8 quantization policy of the protected-GEMM subsystem (port of
:mod:`repro.ft.quantize`).

  * weights — symmetric per-tensor int8: ``scale = 127 / max|w|``, values
    clipped to [-127, 127] in an int32 container; the stacked form gives
    every leading index (layer repeat) its own scale;
  * activations — symmetric PER-ROW quantization into the plan's eq. (13)
    budget: a ``depth``-deep dot of int8 weights stays within
    ``plan.max_output_magnitude`` when every activation is bounded by
    :func:`activation_budget`. Per-row scales make each request's integer
    stream a function of its own activations only.

Rounding is ``torch.round`` (half to even), the same as ``jnp.round``, and
every float step is the reference's float32 arithmetic in the same order,
so the integer grids agree with the reference bit for bit on equal inputs.
(A Python scalar divided by a tensor is ``reciprocal(t) * scalar`` in
torch, one rounding more than ``jnp``'s true division: the scales below
divide tensor by tensor.)
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels.codec import PACK_LANES, pack_int8


# how often the weight quantization runs (each call counts one, a stack
# included): the engine quantizes every protected site once at startup, so
# a step, or a replica built from a sibling's warm state, never adds to it
TRACE_STATS = {"weight_quantize_calls": 0}


def quantize_weight(w: torch.Tensor) -> tuple:
    """Symmetric per-tensor int8 weight quantization (int32 container).
    Returns ``(int32 values, float32 scalar scale)``."""
    TRACE_STATS["weight_quantize_calls"] += 1
    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(), min=1e-9)
    scale = torch.full_like(amax, 127.0) / amax
    return torch.clamp(torch.round(w * scale), -127, 127).to(torch.int32), scale


def quantize_weight_stacked(w: torch.Tensor, *, packed: bool = False) -> dict:
    """Per-matrix int8 quantization of a stacked weight ``[..., K, N]``:
    every leading index gets its own scale. Returns ``{"w": int32
    [..., K, N] (packed: [..., ceil(K/4), N]), "scale": float32 [...]}``.

    One matrix is quantized (and packed) at a time into a preallocated
    result, so the float32 and int64 temporaries are one matrix's, not the
    whole stack's (an expert stack [layers, E, K, N] would otherwise need
    several times its size at once); the bits are the same."""
    TRACE_STATS["weight_quantize_calls"] += 1
    lead, (K, N) = w.shape[:-2], w.shape[-2:]
    rows = -(-K // PACK_LANES) if packed else K
    out = torch.empty((*lead, rows, N), dtype=torch.int32, device=w.device)
    scale = torch.empty(lead, dtype=torch.float32, device=w.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        wi = w[idx].to(torch.float32)
        amax = torch.clamp(wi.abs().amax(), min=1e-9)
        s = torch.full_like(amax, 127.0) / amax
        wq = torch.clamp(torch.round(wi * s), -127, 127).to(torch.int32)
        out[idx] = pack_int8(wq, axis=-2) if packed else wq
        scale[idx] = s
    return {"w": out, "scale": scale}


def activation_budget(plan: EntanglePlan, depth: int) -> int:
    """Largest activation magnitude so a ``depth``-deep int8 dot stays
    within the plan's eq. (13) output range (floor 1)."""
    return max(plan.max_output_magnitude // (depth * 127), 1)


def chain_budget(plan: EntanglePlan, depths: Sequence[int]) -> int:
    """Activation budget of an entangled-domain GEMM *chain*: hops of
    contraction depths ``K_1 .. K_n`` against int8 weights amplify the
    first hop's activations by at most ``prod(K_i * 127)`` before the one
    final extraction, so the first hop's grid must satisfy ``budget *
    prod(K_i * 127) <= plan.max_output_magnitude``. 0 when no grid does:
    the chain is infeasible under this plan, and
    :func:`~repro_torch.ft.protected.entangled_chain` extracts per hop."""
    amp = 1
    for K in depths:
        amp *= int(K) * 127
    return plan.max_output_magnitude // amp


def quantize_acts(x: torch.Tensor, plan: EntanglePlan, depth: int, *,
                  budget: Optional[int] = None) -> tuple:
    """Quantize float activations onto the eq. (13)-budgeted integer grid
    of a ``depth``-deep contraction. Returns ``(int32 values, scale)`` with
    the scale PER ROW (the last axis reduced to 1). ``budget`` overrides
    the single GEMM's (the chain executor passes :func:`chain_budget`'s
    tighter grid)."""
    if budget is None:
        budget = activation_budget(plan, depth)
    x = x.to(torch.float32)
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-9)
    a_scale = torch.full_like(amax, budget) / amax
    return torch.round(x * a_scale).to(torch.int32), a_scale
