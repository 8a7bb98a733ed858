"""Entangled int8 logits projection — the serving head's entries (port of
:mod:`repro.ft.heads`).

The head GEMM (hidden [B, D] x head [D, V]) runs through
:func:`~repro_torch.ft.protected.protected_matmul`: rows map round-robin
onto the M request groups (slot -> group = slot % M), activations are
quantized per row within the plan's eq. (13) budget, and the fused kernel
rolls any single group's fail-stop forward inside the same kernel call.
The head weights are quantized ONCE at engine startup
(:func:`quantize_head`), never per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.ft.protected import protected_matmul
from repro_torch.ft.quantize import quantize_weight as quantize_head  # noqa: F401


def ft_logits_decode(h: torch.Tensor, head_q: torch.Tensor,
                     w_scale: torch.Tensor, *, plan: EntanglePlan,
                     failed_group: Optional[int] = None,
                     fuse_epilogue: bool = True) -> torch.Tensor:
    """The engine's per-step entry: one fused entangled head GEMM over the
    whole slot batch ``h`` [B, D]; returns float32 logits [B, V]."""
    return protected_matmul(h, (head_q, w_scale), plan=plan,
                            failed_group=failed_group,
                            fuse_epilogue=fuse_epilogue)


def ft_logits_prefill(h: torch.Tensor, head_q: torch.Tensor,
                      w_scale: torch.Tensor, *, plan: EntanglePlan,
                      failed_group: Optional[int] = None,
                      fuse_epilogue: bool = True) -> torch.Tensor:
    """Admission-time entry: the last-prompt hidden states [n, D] of a
    bucketed batched prefill through the SAME fused kernel and plan as
    decode (rows padded to a multiple of M with zero rows, which is
    exact)."""
    return protected_matmul(h, (head_q, w_scale), plan=plan,
                            failed_group=failed_group,
                            fuse_epilogue=fuse_epilogue)
