"""Pipeline parallelism: a GPipe-style rotational schedule over the ranks
of a process group (port of :mod:`repro.dist.pipeline`).

Rank s of the group owns stage s (a contiguous slice of layers).
Microbatches enter at stage 0; every tick each stage applies its layers
and sends its activation to its successor (s + 1) mod S, through
``batch_isend_irecv``; the last stage collects the finished microbatches.
``N + S - 1`` ticks drain N microbatches through S stages — the standard
fill / steady / drain schedule.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map


def make_layer_stage(layer_fn: Callable) -> Callable:
    """Lift a per-layer fn ``layer_fn(params_i, x) -> x`` into a stage fn
    applying a stacked slice of layers (leading axis) in order."""

    def stage_fn(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        for i in range(leaves(stage_params)[0].shape[0]):
            x = layer_fn(tree_map(lambda p: p[i], stage_params), x)
        return x

    return stage_fn


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def split_stages(layer_params: Any, n_stages: int) -> Any:
    """Reshape layer-stacked params [L, ...] -> [S, L/S, ...]."""

    def split(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])

    return tree_map(split, layer_params)


def pipeline_stack(stage_fn: Callable, stage_params: Any,
                   x_micro: torch.Tensor, *, group=None) -> torch.Tensor:
    """Run ``x_micro`` [N_micro, ...] through the S stages of ``group`` (a
    process group; None: the default group).

    ``stage_params`` leaves are stage-stacked [S, ...], as in the
    reference; rank s of the group applies slice s. Every rank passes the
    same ``x_micro`` (stage 0 reads it). The last stage (group rank S - 1)
    collects the outputs and broadcasts them, so every rank of the group
    returns [N_micro, ...], equal to applying all stages in order."""
    S = dist.get_world_size(group)
    s = dist.get_rank(group)
    N = x_micro.shape[0]
    params = tree_map(lambda p: p[s], stage_params)
    nxt = _global_rank(group, (s + 1) % S)
    prv = _global_rank(group, (s - 1) % S)
    carry = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(N + S - 1):
        y = stage_fn(params, x_micro[min(t, N - 1)] if s == 0 else carry)
        if s == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = y
        if S == 1:
            carry = y
            continue
        recv = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        carry = recv
    dist.broadcast(outs, src=_global_rank(group, S - 1), group=group)
    return outs
