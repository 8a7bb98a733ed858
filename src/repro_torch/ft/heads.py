"""Entangled int8 logits projection — the serving head's entries (port of
:mod:`repro.ft.heads`).

The head GEMM (hidden [B, D] x head [D, V]) runs through
:func:`~repro_torch.ft.protected.protected_matmul`: in the serving entries
rows map round-robin onto the M request groups (slot -> group = slot % M;
:func:`ft_logits`, the library form, keeps the caller's contiguous
[M, B/M] grouping), activations are
quantized per row within the plan's eq. (13) budget, and the fused kernel
rolls any single group's fail-stop forward inside the same kernel call.
The head weights are quantized ONCE at engine startup
(:func:`quantize_head`), never per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import EntanglePlan, make_plan
from repro_torch.ft.protected import group_order, protected_matmul
from repro_torch.ft.quantize import quantize_weight as quantize_head  # noqa: F401


def ft_logits(h: torch.Tensor, head_q: torch.Tensor, w_scale: torch.Tensor,
              *, M: int = 4, plan: Optional[EntanglePlan] = None,
              failed_group: Optional[int] = None,
              fuse_epilogue: bool = True, blocks=None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Library form: the rows of ``h`` [B, D] grouped contiguously (the
    caller's [M, B/M] layout); ``plan`` defaults to ``make_plan(M, 32)``.
    ``blocks`` and ``backend`` go to the kernel call. Returns float32
    logits [B, V]."""
    B = h.shape[0]
    if B % M:
        raise ValueError(f"batch {B} must split into M={M} request groups")
    return protected_matmul(h, (head_q, w_scale),
                            plan=plan or make_plan(M, 32),
                            failed_group=failed_group,
                            fuse_epilogue=fuse_epilogue, contiguous=True,
                            blocks=blocks, backend=backend)


def decode_group_order(B: int, M: int) -> tuple:
    """The engine's slot -> group = slot % M permutation and its inverse
    (:func:`repro_torch.ft.protected.group_order`, under the reference's
    older name)."""
    return group_order(B, M)


def ft_logits_decode(h: torch.Tensor, head_q: torch.Tensor,
                     w_scale: torch.Tensor, *, plan: EntanglePlan,
                     failed_group: Optional[int] = None,
                     fuse_epilogue: bool = True, blocks=None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """The engine's per-step entry: one fused entangled head GEMM over the
    whole slot batch ``h`` [B, D]; returns float32 logits [B, V]."""
    return protected_matmul(h, (head_q, w_scale), plan=plan,
                            failed_group=failed_group,
                            fuse_epilogue=fuse_epilogue, blocks=blocks,
                            backend=backend)


def ft_logits_prefill(h: torch.Tensor, head_q: torch.Tensor,
                      w_scale: torch.Tensor, *, plan: EntanglePlan,
                      failed_group: Optional[int] = None,
                      fuse_epilogue: bool = True, blocks=None,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Admission-time entry: the last-prompt hidden states [n, D] of a
    bucketed batched prefill through the SAME fused kernel and plan as
    decode (rows padded to a multiple of M with zero rows, which is
    exact)."""
    return protected_matmul(h, (head_q, w_scale), plan=plan,
                            failed_group=failed_group,
                            fuse_epilogue=fuse_epilogue, blocks=blocks,
                            backend=backend)
