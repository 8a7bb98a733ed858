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

The cross-replica sum runs over ``torch.distributed``: ``axis_name`` is a
process group (every rank of it one replica), or the name of a dimension
of the mesh installed by :func:`repro_torch.dist.sharding.axis_rules`,
or None (single process: the gradients are already the full sum). The
replicas agree on the scale through ``all_reduce(MAX)`` of the amax (the
reference's ``pmax``), and the entangled int32 blocks are summed by
``all_reduce(SUM)``, which wraps mod 2^32 as ``psum`` does — exact, since
the sum is an LSB op. The wrap is checked across several ranks on gloo
only: NCCL has run as a one-rank group so far (it takes one GPU per rank),
where the sum adds nothing. Each rank returns the same synced gradients.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.entangle import disentangle as _disentangle_plain
from repro_torch.core.entangle import entangle as _entangle_plain
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.fixed_point import pow2_scale as _pow2_scale
from repro_torch.core.plan import EntanglePlan, make_plan
from repro_torch.tree import tree_map

CODECS = ("plain", "kernel")


def _group(axis_name):
    """The process group of ``axis_name``: None (no cross-replica sum), a
    group as given, or a mesh dimension's group under ``axis_rules``."""
    if axis_name is None or not isinstance(axis_name, str):
        return axis_name
    from repro_torch.dist.sharding import current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"axis_name={axis_name!r} names a mesh dimension, "
                         f"but no axis_rules(mesh) is active")
    return mesh.get_group(axis_name)


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


def ft_grad_sync(grads: Any, *, axis_name=None,
                 n_replicas: int, M: int = 4,
                 failed_block: Optional[int] = None,
                 plan: Optional[EntanglePlan] = None,
                 codec: str = "plain") -> tuple:
    """Entanglement-protected mean of ``grads``.

    Args:
      grads: nested dicts / lists / tuples of float gradient tensors (this
        replica's, or the full gradients when ``axis_name`` is None).
      axis_name: the replicas' process group, a mesh dimension's name
        under ``axis_rules``, or None for single-process use.
      n_replicas: number of contributions to the sum (reduction headroom).
      M: number of entangled stream blocks per tensor.
      failed_block: fail-stopped block index; its entangled data is
        overwritten with :data:`GARBAGE` to prove recovery never reads it.
      plan: entanglement plan override (default ``make_plan(M, 32)``).
      codec: 'plain' (torch ops) or 'kernel' (the kernel layer).

    Returns:
      (synced gradients of the same structure, diagnostics dict).
    """
    group = _group(axis_name)
    plan = plan or make_plan(M, 32)
    entangle_fn, disentangle_fn = _codec_fns(codec, plan, failed_block)

    def sync_leaf(g: torch.Tensor) -> torch.Tensor:
        blocks, n = _to_blocks(g.reshape(-1).to(torch.float32), M)
        amax = blocks.abs().amax()
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _pow2_scale(amax, plan.max_output_magnitude, n_replicas)
        q = torch.round(blocks * scale).to(torch.int32)
        eps = entangle_fn(q)
        if group is not None:
            dist.all_reduce(eps, op=dist.ReduceOp.SUM, group=group)
        if failed_block is not None:
            eps[failed_block % M] = GARBAGE
        rec = disentangle_fn(eps)
        out = rec.to(torch.float32) / (scale * n_replicas)
        return out.reshape(-1)[:n].reshape(g.shape).to(g.dtype)

    diag = {"ne_failed": -1 if failed_block is None else failed_block % M,
            "ne_M": M}
    return tree_map(sync_leaf, grads), diag


def checksum_grad_sync(grads: Any, *, axis_name=None,
                       n_replicas: int, M: int = 4,
                       failed_block: Optional[int] = None) -> tuple:
    """Checksum-ABFT baseline: one extra sum stream, float recovery;
    ``axis_name`` as in :func:`ft_grad_sync`."""
    group = _group(axis_name)

    def sync_leaf(g: torch.Tensor) -> torch.Tensor:
        blocks, n = _to_blocks(g.reshape(-1).to(torch.float32), M)
        csum = blocks.sum(dim=0)
        if group is not None:
            blocks = blocks.clone()  # the reduce is in place; g may share it
            dist.all_reduce(blocks, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(csum, op=dist.ReduceOp.SUM, group=group)
        if failed_block is not None:
            fb = failed_block % M
            others = blocks.sum(dim=0) - blocks[fb]
            blocks = torch.cat([blocks[:fb], (csum - others)[None],
                                blocks[fb + 1:]])
        out = blocks / n_replicas
        return out.reshape(-1)[:n].reshape(g.shape).to(g.dtype)

    diag = {"cs_failed": -1 if failed_block is None else failed_block % M}
    return tree_map(sync_leaf, grads), diag


def _gather_words(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dimension 0, as one int32-word
    ``all_reduce(SUM)`` of a zero buffer in which each rank fills its own
    block (bit for bit: a float sum would turn -0.0 into 0.0)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    shape = (n * x.shape[0],) + tuple(x.shape[1:])
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    rows = x.shape[0]
    buf[r * rows:(r + 1) * rows] = x
    words = buf.reshape(-1).view(torch.uint8)
    if words.numel() % 4:
        raise ValueError(f"{tuple(shape)} {x.dtype} does not fill whole "
                         f"int32 words")
    dist.all_reduce(words.view(torch.int32), op=dist.ReduceOp.SUM,
                    group=group)
    return buf


class _GatherRows(torch.autograd.Function):
    """The gather's backward is a reduce-scatter: the float32 sum over the
    group of the gathered tensor's gradient, of which each rank keeps its
    own block (an ``all_reduce`` and a slice, which gloo runs on the
    ranks' CUDA tensors too)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows, ctx.dtype = group, x.shape[0], x.dtype
        return _gather_words(x, group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32).contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows].to(ctx.dtype), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dimension 0 in rank order (the
    ranks' shapes equal), on every rank of ``group``: the all-gather that
    the reference's GSPMD lowering makes of a row-sharded tensor.

    It runs as one ``all_reduce(SUM)`` of a zero buffer in which each rank
    fills its own block, summed as int32 words, so that the bits come back
    as they were (a float sum would turn -0.0 into 0.0). Gloo, which takes
    the ranks' CUDA tensors when they share one card, runs no other
    collective on them; NCCL runs it as well. A float ``x`` that requires
    grad gets the gather's backward: the gradient of rank g's block is the
    float32 sum over the group of the gathered tensor's gradient there
    (what GSPMD's transpose of the gather computes). On the ``meta``
    device (a shape census) it returns an empty tensor of the gathered
    shape."""
    if x.device.type == "meta":
        n = dist.get_world_size(group)
        return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, group)
    return _gather_words(x, group)
