"""Operation and byte counts of one step, for the roofline (the port's
counterpart of :mod:`repro.launch.hlo_cost`).

The port has no compiled HLO to parse, so it counts what an eager step
does: :func:`count` runs the step under a ``TorchDispatchMode`` (on the
``meta`` device, where nothing is allocated or computed, or on real
tensors) and tallies every aten op it dispatches:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls, convs,
    attention); elementwise ops count none, as there;
  * bytes: every input and output tensor of every op that is not a view
    or an empty allocation, each op on its own — the **unfused upper
    bound** of the step's memory traffic (a fused kernel reads less); a
    gather (an embedding lookup, ``index_select``) counts the rows it
    reads, not its whole table, and a scatter into a cache the rows it
    writes, not the whole cache;
  * collectives: the bytes and the count of each ``torch.distributed``
    op (c10d), the larger of its buffers as the payload;
  * the port's kernels as their own work, not as the plain versions'
    torch ops: while counting, a backend of the kernel registry
    (:mod:`repro_torch.kernels.ops`) is the process default, and each
    kernel call adds its integer operations (a GEMM's int32 MACs over the
    streams it computes, M - 1 with the fused extraction, as 2 ops each;
    2, 3 and 1 ops per word for the entangle, disentangle and checksum
    passes; a conv's MACs the same way) and its bytes once (each input
    read once, each output written once), and returns an empty output of
    the right shape.

No trip-count pass is needed: the reference had to multiply a scanned
layer's body by its trip count, but eager code runs the layer loop in
Python, so every layer's ops are dispatched and counted. On the ``meta``
device the card's padding (``layers.GEMM_ROWS`` rows per unprotected
GEMM, ``attention_core.Q_BLOCK`` queries) is not applied, so the counts
are the step's useful work; and the recurrent scans' steps, skipped
there (``layers._mamba_scan``, ``_lru_scan`` run a one-expression
stand-in), are not counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

BACKEND = "op_cost"

# allocations whose outputs are not written by the op (no traffic)
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "lift_fresh", "detach", "alias"}
# ops that read rows of their first argument (the table): the output's
# bytes are read and written, the indices read
_GATHER = {"embedding", "index_select", "index", "gather", "take"}
# ops that write rows into their first argument (the destination): the
# other arguments' bytes (values, indices) are read and written
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
            "index_copy_", "scatter", "scatter_", "index_add_",
            "scatter_add_", "slice_scatter", "select_scatter"}


@dataclasses.dataclass
class Cost:
    """What one counted run did."""

    flops: float = 0.0  # float operations (flop_counter's formulas)
    bytes: float = 0.0  # every op's inputs and outputs: the unfused bound
    int_ops: float = 0.0  # the kernels' integer operations
    kernel_bytes: float = 0.0  # the kernels' bytes, each once (in bytes)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes_by_op: dict = dataclasses.field(default_factory=dict)
    ops: int = 0  # aten ops dispatched

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        from torch.utils.flop_counter import flop_registry

        self.formulas = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        ns = func.namespace
        if ns == "c10d":
            name = func._overloadpacket.__name__.rstrip("_")
            payload = max((_nbytes(t) for t in _tensors((args, kwargs))),
                          default=0)
            c.collective_counts[name] = c.collective_counts.get(name, 0) + 1
            c.collective_bytes_by_op[name] = (
                c.collective_bytes_by_op.get(name, 0) + payload)
            c.collective_bytes += payload
            return out
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            c.flops += formula(*args, **kwargs, out_val=out)
        name = func._overloadpacket.__name__
        if name in _GATHER:
            c.bytes += (sum(_nbytes(t) for t in _tensors((args[1:], kwargs)))
                        + 2 * sum(_nbytes(t) for t in _tensors(out)))
        elif name in _SCATTER:
            c.bytes += 2 * sum(_nbytes(t) for t in _tensors((args[1:],
                                                             kwargs)))
        elif not (func.is_view or name in _ALLOC):
            c.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


def _kernel_impls(cost: Cost) -> dict:
    """The counting backend: each op notes its kernel's work and returns
    an empty output of the right shape on the operands' device."""
    def note(op: str, int_ops: float, ins, out_shape, out_dtype=torch.int32):
        out = torch.empty(out_shape, dtype=out_dtype, device=ins[0].device)
        cost.int_ops += int_ops
        cost.kernel_bytes += sum(_nbytes(t) for t in ins) + _nbytes(out)
        cost.kernel_calls[op] = cost.kernel_calls.get(op, 0) + 1
        return out

    def emm(c, g, *, plan, fuse_epilogue, failed, packed, blocks):
        M, B, K = c.shape
        ns = M - int(fuse_epilogue in (True, "chain_final"))
        return note("entangled_matmul", 2 * ns * B * K * g.shape[-1],
                    (c, g), (M, B, g.shape[-1]))

    def emmg(c, g, *, plan, fuse_epilogue, failed, packed, blocks):
        M, E, Cg, K = c.shape
        ns = M - int(bool(fuse_epilogue))
        return note("entangled_matmul_grouped",
                    2 * ns * E * Cg * K * g.shape[-1], (c, g),
                    (M, E, Cg, g.shape[-1]))

    def econv(x, w, *, plan, fuse_epilogue, failed, packed, blocks):
        M = x.shape[0]
        ns = M - int(bool(fuse_epilogue))
        return note("entangled_conv1d",
                    2 * ns * math.prod(x.shape[1:]) * w.shape[-1], (x, w),
                    x.shape)

    return {
        "entangled_matmul": emm,
        "entangled_matmul_grouped": emmg,
        "entangle": lambda c, *, plan, blocks: note(
            "entangle", 2 * c.numel(), (c,), c.shape),
        "disentangle": lambda d, *, plan, failed, blocks: note(
            "disentangle", 3 * d.numel(), (d,), d.shape),
        "checksum": lambda c, *, blocks: note(
            "checksum", c.numel(), (c,), c.shape[1:]),
        "entangled_conv1d": econv,
        "conv1d_causal": lambda x, w, *, blocks: note(
            "conv1d_causal", 2 * x.numel() * w.shape[-1], (x, w), x.shape),
    }


@contextlib.contextmanager
def counting():
    """Count everything run inside: yields the :class:`Cost` it fills.
    The port's kernels go to the counting backend (the process default
    while inside)."""
    from repro_torch.kernels import ops as kops

    cost = Cost()
    prev = kops.default_backend()
    kops.register_backend(BACKEND, _kernel_impls(cost),
                          description="op_cost's counting stand-in")
    kops.set_default_backend(BACKEND)
    try:
        with _Counter(cost):
            yield cost
    finally:
        kops.unregister_backend(BACKEND)
        kops.set_default_backend(prev)


def count(fn: Callable, *args: Any, **kwargs: Any) -> tuple:
    """``(fn(*args, **kwargs), Cost)``: one run of ``fn``, counted."""
    with counting() as cost:
        out = fn(*args, **kwargs)
    return out, cost
