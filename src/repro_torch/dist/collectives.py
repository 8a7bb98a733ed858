"""Fault-tolerant gradient synchronization — the paper's codec on the
data-parallel gradient path (port of :mod:`repro.dist.collectives`).

``ft_grad_sync`` protects the gradient sum with numerical entanglement:
each gradient tensor is fixed-point quantized into the plan's eq. (13)
budget (with ``n_replicas`` reduction headroom), split into M stream
blocks, entangled, summed across replicas (the sum is an LSB op, so it
commutes with the entanglement operator), and disentangled. A block that
fail-stops is rolled forward exactly from the surviving M-1 entangled
blocks: the synced gradients, and so the training step, are bit-identical
with and without the failure.

``checksum_grad_sync`` is the checksum-ABFT baseline (paper Sec. II) on the
same path: one extra sum stream, float arithmetic, recovery by subtraction.

Codec dispatch: ``codec='plain'`` runs the core codec in torch ops
(:mod:`repro_torch.core.entangle`, the counterpart of the reference's
``'xla'``); ``codec='kernel'`` routes entangle / disentangle through the
kernel layer (:mod:`repro_torch.kernels.ops`: the hand-written CUDA passes
on the card, their plain versions on the CPU; the counterpart of
``'pallas'``).

Only the single-process form is ported (``axis_name=None``): the
cross-replica sum over ``torch.distributed`` is not.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.entangle import disentangle as _disentangle_plain
from repro_torch.core.entangle import entangle as _entangle_plain
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import EntanglePlan, make_plan
from repro_torch.tree import tree_map

CODECS = ("plain", "kernel")

# float32(ln 2): the reference's exp2 / log2 are exp(x * ln2_f32) and
# log(x) / ln2_f32 in float32
_LN2_F32 = 0.6931471824645996
_TINY_F32 = torch.finfo(torch.float32).tiny


def _check_axis(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"the cross-replica sum over axis_name={axis_name!r} is not "
            f"ported yet (it needs torch.distributed); use axis_name=None")


def _pow2_scale(amax: torch.Tensor, max_magnitude: int,
                depth: int) -> torch.Tensor:
    """Fixed-point scale with ``depth``-term sum headroom: the reference's
    float32 ``exp2(floor(log2(budget / amax)))``.

    The reference evaluates ``log2`` as ``log(q) / ln2`` and ``exp2`` as
    ``exp(k * ln2)`` in float32; here ``log`` and ``exp`` are evaluated in
    float64 and rounded once to float32 (correctly rounded), the rest in
    float32 in the reference's order. That gives the reference's scale
    everywhere except where XLA's float32 ``log`` is not correctly rounded
    AND ``log(q) / ln2`` lands on an integer: quotients within a few ulps
    of some powers of two (2**27, 2**31, ...), where the reference's floor
    is one lower (listed in ROADMAP queue 3; shown by
    ``tests/test_torch_train.py``). The result is then twice the
    reference's, which changes the rounding grid, never the roll-forward.
    """
    dev = amax.device
    budget = torch.tensor(float(max_magnitude // max(depth, 1)),
                          dtype=torch.float32, device=dev)
    ln2 = torch.tensor(_LN2_F32, dtype=torch.float32, device=dev)
    q = budget / torch.clamp(amax.to(torch.float32), min=_TINY_F32)
    k = torch.floor(torch.log(q.double()).float() / ln2)
    return torch.exp((k * ln2).double()).float()


def _to_blocks(flat: torch.Tensor, M: int) -> tuple:
    """``[n]`` -> ``([M, ceil(n / M)], n)``, zero-padded at the end."""
    n = flat.shape[0]
    pad = (-n) % M
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(M, (n + pad) // M), n


def _codec_fns(codec: str, plan: EntanglePlan, failed: Optional[int]):
    if codec == "kernel":
        from repro_torch.kernels import ops as kops

        return (lambda q: kops.entangle(q, plan),
                lambda eps: kops.disentangle(eps, plan, failed=failed))
    if codec == "plain":
        return (lambda q: _entangle_plain(q, plan),
                lambda eps: _disentangle_plain(eps, plan, failed=failed))
    raise ValueError(f"codec must be one of {CODECS}, got {codec!r}")


def ft_grad_sync(grads: Any, *, axis_name: Optional[str] = None,
                 n_replicas: int, M: int = 4,
                 failed_block: Optional[int] = None,
                 plan: Optional[EntanglePlan] = None,
                 codec: str = "plain") -> tuple:
    """Entanglement-protected mean of ``grads``.

    Args:
      grads: nested dicts / lists / tuples of float gradient tensors.
      axis_name: must be None (the single-process form).
      n_replicas: number of contributions to the sum (reduction headroom).
      M: number of entangled stream blocks per tensor.
      failed_block: fail-stopped block index; its entangled data is
        overwritten with :data:`GARBAGE` to prove recovery never reads it.
      plan: entanglement plan override (default ``make_plan(M, 32)``).
      codec: 'plain' (torch ops) or 'kernel' (the kernel layer).

    Returns:
      (synced gradients of the same structure, diagnostics dict).
    """
    _check_axis(axis_name)
    plan = plan or make_plan(M, 32)
    entangle_fn, disentangle_fn = _codec_fns(codec, plan, failed_block)

    def sync_leaf(g: torch.Tensor) -> torch.Tensor:
        blocks, n = _to_blocks(g.reshape(-1).to(torch.float32), M)
        scale = _pow2_scale(blocks.abs().amax(), plan.max_output_magnitude,
                            n_replicas)
        q = torch.round(blocks * scale).to(torch.int32)
        eps = entangle_fn(q)
        if failed_block is not None:
            eps[failed_block % M] = GARBAGE
        rec = disentangle_fn(eps)
        out = rec.to(torch.float32) / (scale * n_replicas)
        return out.reshape(-1)[:n].reshape(g.shape).to(g.dtype)

    diag = {"ne_failed": -1 if failed_block is None else failed_block % M,
            "ne_M": M}
    return tree_map(sync_leaf, grads), diag


def checksum_grad_sync(grads: Any, *, axis_name: Optional[str] = None,
                       n_replicas: int, M: int = 4,
                       failed_block: Optional[int] = None) -> tuple:
    """Checksum-ABFT baseline: one extra sum stream, float recovery."""
    _check_axis(axis_name)

    def sync_leaf(g: torch.Tensor) -> torch.Tensor:
        blocks, n = _to_blocks(g.reshape(-1).to(torch.float32), M)
        csum = blocks.sum(dim=0)
        if failed_block is not None:
            fb = failed_block % M
            others = blocks.sum(dim=0) - blocks[fb]
            blocks = torch.cat([blocks[:fb], (csum - others)[None],
                                blocks[fb + 1:]])
        out = blocks / n_replicas
        return out.reshape(-1)[:n].reshape(g.shape).to(g.dtype)

    diag = {"cs_failed": -1 if failed_block is None else failed_block % M}
    return tree_map(sync_leaf, grads), diag
