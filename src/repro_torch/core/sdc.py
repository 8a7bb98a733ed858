"""Silent-data-corruption detection over entangled outputs (port of
:mod:`repro.core.sdc`).

With M entangled outputs but only M-1 needed for extraction, each output
position carries one redundant constraint per held-out stream r::

    predict(delta_r) := S_l{d_hat_{r-1}} + d_hat_r,  d_hat := disentangle w/o r

A healthy position satisfies ``predict(delta_r) == delta_r`` for every r;
a corruption of one stream at a position violates it. One parity cannot
localize the corrupted stream, so :func:`localize` is a heuristic: the
recovery that holds out the corrupted stream gives values inside the
eq. (13) range, while the others amplify the corruption.

Every disentangle pass goes through the kernel layer
(:func:`repro_torch.kernels.ops.disentangle`): the hand-written CUDA pass
for CUDA tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.entangle import reentangle_stream
from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import ops


def detect(delta: torch.Tensor, plan: EntanglePlan) -> torch.Tensor:
    """Bool mask over the output positions ``delta.shape[1:]``: True where
    ANY of the M cyclic redundancy constraints is violated."""
    bad = None
    for r in range(plan.M):
        pred = reentangle_stream(ops.disentangle(delta, plan, failed=r), plan,
                                 stream=r)
        viol = pred != delta[r]
        bad = viol if bad is None else (bad | viol)
    return bad


def localize(delta: torch.Tensor, plan: EntanglePlan) -> torch.Tensor:
    """Best-effort corrupted-stream index per position (int32; -1 = clean
    or ambiguous): at a detected position, the held-out stream whose
    recovery has the smallest largest magnitude (as unsigned 32-bit
    values, as the reference compares them)."""
    bad = detect(delta, plan)
    scores = torch.stack([
        ops.disentangle(delta, plan, failed=r).to(torch.int64).abs()
        .amax(dim=0)
        for r in range(plan.M)])  # [M, ...]
    blame = torch.argmin(scores, dim=0).to(torch.int32)
    return torch.where(bad, blame, torch.full_like(blame, -1))
