"""Fail-stop protection engine: one interface over all recovery families
(port of :mod:`repro.core.failstop`).

The paper positions numerical entanglement as a *third family* of
fail-stop recovery next to checksum-ABFT and modular redundancy (MR). This
module exposes all three (plus unprotected passthrough) behind one
functional API, the comparison the paper's Fig. 2 makes.

A fail-stop is a stream whose computation never returned (crash or
deadline miss — paper Sec. I treats both identically). Recovery must never
depend on that stream, so the engine, the tests, the chip smoke's poison
check and the unfused protected path overwrite its slot with
:data:`GARBAGE` before recovering: any use of it would show in the result.

The device of the streams picks the implementation of every pass (the
codec, the op's kernel, the checksum sum): the plain PyTorch versions for
CPU tensors, the hand-written CUDA kernels of :mod:`repro_torch.kernels`
for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.checksum import attach_checksum, recover_from_checksum
from repro_torch.core.entangle import _check_streams
from repro_torch.core.lsb_ops import LSBOp, apply_streams, get_op
from repro_torch.core.plan import EntanglePlan, make_plan

# poison for lost streams (same value as the reference)
GARBAGE = -0x5A5A5A5A


@dataclasses.dataclass(frozen=True)
class FTConfig:
    """Fault-tolerance selection for a protected computation."""

    mode: str = "entangle"  # none | entangle | checksum | mr
    M: int = 4

    def plan(self) -> EntanglePlan:
        return make_plan(self.M, 32)

    @property
    def extra_streams(self) -> int:
        """Cores beyond M required by this family (paper Sec. II)."""
        if self.mode == "mr":
            return self.M
        return {"none": 0, "entangle": 0, "checksum": 1}.get(self.mode, 0)


@dataclasses.dataclass(frozen=True)
class FTReport:
    mode: str
    failed: Optional[int]
    recovered: bool


def _poison(x: torch.Tensor, stream: int) -> torch.Tensor:
    out = x.clone()
    out[stream] = GARBAGE
    return out


def run_protected(op_name: str, c: torch.Tensor, g, cfg: FTConfig,
                  failed: Optional[int] = None
                  ) -> tuple[torch.Tensor, FTReport]:
    """Run op over M streams under the configured protection family.

    Args:
      op_name: key into the LSB op registry.
      c: [M, ...] integer input streams.
      g: kernel/operand (op-specific; None for identity).
      cfg: protection family config.
      failed: injected fail-stop stream index (None = healthy run). For
        mode='checksum' the index may equal M (the checksum core itself).

    Returns:
      ([M, ...] recovered true outputs, report). mode='none' with a failure
      returns poisoned outputs and recovered=False — the failure-intolerant
      baseline semantics.
    """
    op: LSBOp = get_op(op_name)
    M = cfg.M
    if c.shape[0] != M:
        raise ValueError(f"expected {M} streams, got {c.shape[0]}")

    if cfg.mode == "none":
        d = apply_streams(op, c, g)
        if failed is not None:
            return _poison(d, failed), FTReport("none", failed, False)
        return d, FTReport("none", None, True)

    if cfg.mode == "entangle":
        # imported here: the kernel modules import this package
        from repro_torch.kernels import ops as kops

        plan = cfg.plan()
        _check_streams(c, plan, 0)
        eps = kops.entangle(c, plan)
        ge = op.kernel_for_entangled(g, plan)
        delta = apply_streams(op, eps, ge)
        if failed is not None:
            delta = _poison(delta, failed)
        d = kops.disentangle(delta, plan, failed=failed)
        return d, FTReport("entangle", failed, True)

    if cfg.mode == "checksum":
        cr = attach_checksum(c)
        out = apply_streams(op, cr, g)
        if failed is not None:
            out = _poison(out, failed)
        d = recover_from_checksum(out, op, g, failed)
        return d, FTReport("checksum", failed, True)

    if cfg.mode == "mr":
        # Dual modular redundancy: every stream computed twice (2M cores);
        # a fail-stop in copy A of stream f is served by copy B.
        both = torch.cat([c, c], dim=0)
        out = apply_streams(op, both, g)
        if failed is not None:
            out = _poison(out, failed)
        pick = torch.arange(M, device=out.device) == (
            failed if failed is not None else -1)
        pick = pick.reshape((M,) + (1,) * (out.dim() - 1))
        return torch.where(pick, out[M:], out[:M]), FTReport("mr", failed,
                                                             True)

    raise ValueError(f"unknown ft mode {cfg.mode!r}")
