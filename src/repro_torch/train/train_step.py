"""The training step: forward + CE loss + backward + gradient sync + AdamW
(port of :mod:`repro.train.train_step`).

Gradient-sync flavours, as in the reference:
  * 'spmd'     — no explicit sync (on one device the gradients are already
    the full sum; the reference leaves the cross-device sum to GSPMD);
  * 'entangle' — the paper's protected sync (:func:`ft_grad_sync`): a
    fail-stopped gradient block is rolled forward from the surviving M-1
    entangled blocks, so the step is bit-identical with and without it;
  * 'checksum' — the checksum-ABFT baseline.

Params live in the state as plain tensors; each step makes them autograd
leaves (``detach().requires_grad_()``, no copy), runs the model's forward
and the loss, and takes the gradients with ``torch.autograd.grad`` over the
leaf list. The model's backward is autograd through ordinary torch ops;
the sync runs after it, so no kernel of the step needs a backward.

Data parallelism, as the reference's launcher gets it from GSPMD on an
(n, 1) data x model mesh. The step takes the global batch. Under
``axis_rules`` of a ``DeviceMesh`` whose ``batch`` axis spans n > 1 ranks
(:func:`repro_torch.dist.sharding.axis_group`), rank g of that group
computes rows [g·b/n, (g+1)·b/n) of each microbatch of b rows, the
layout GSPMD gives the reference's batch-sharded activations. Its loss
divides its rows' masked sums by the global microbatch's mask counts
(:func:`mask_counts`), so the ranks' losses and gradients add up to the
global batch's. The float32 gradients and losses are then summed over the
group (``all_reduce(SUM)``, where GSPMD sums them), before the configured
sync, which protects the summed gradient with ``axis_name=None`` and
``n_replicas=1`` exactly as the reference's step does. Every rank then
holds the same gradient, the same metrics and the same new state. Where n
does not divide b the reference drops the batch sharding: every rank
computes the whole microbatch, in the one-process layout of n shards (a
``StandInMesh``: the MoE block's n dispatch groups), and nothing is
summed. With no rules, on a mesh of one rank along ``batch`` or on a
``StandInMesh``, the step is the one-process step.

The reference lays its activations out with ``constrain(..., "batch",
...)`` at ``models/layers.py:367-369, 477, 626-650, 695-696, 754-855,
917, 1006, 1107`` (and ``models/api.py:107, 302``,
``models/transformer.py:262, 285``). A rank holds plain local tensors, on
which ``constrain`` is the identity, so the port splits the batch once,
at the step's entry, and adds no call at those sites. The MoE block's
dispatch groups follow the split (:func:`repro_torch.models.layers.
moe_groups`: G = 1 on a rank, the reference's group g); a data-parallel
step refuses ``dispatch="global_sort"``, whose gather of every rank's
tokens has no backward in the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import checksum_grad_sync, ft_grad_sync
from repro_torch.dist.sharding import (StandInMesh, axis_group, axis_rules,
                                       current_mesh, mesh_shape)
from repro_torch.models.api import get_model, lm_loss
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, tree_map, unflatten

GRAD_SYNCS = ("spmd", "entangle", "checksum")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    grad_sync: str = "spmd"  # spmd | entangle | checksum
    grad_codec: str = "plain"  # plain | kernel — entangle/disentangle impl
    #   of the FT sync ('kernel' goes through the kernel layer, the
    #   hand-written CUDA passes on the card; 'plain' is the torch-op codec)
    ft_M: int = 4
    max_seq: int = 4096
    grad_accum: int = 1  # microbatches per step (activation-memory lever)


def init_state(gen: torch.Generator, cfg: ModelConfig, tcfg: TrainConfig,
               device=None) -> dict:
    """Random params from ``gen``, zero moments and step 0, on ``device``
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    params = get_model(cfg).init(gen, cfg, tcfg.max_seq, device=dev)
    return {"params": params, "opt": adamw_mod.init(params, tcfg.adamw),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_and_grads(cfg: ModelConfig, params, batch: dict,
                   counts=None) -> tuple:
    """``(loss, grads)`` of one (micro)batch; the grads have the params'
    structure. ``counts`` replaces the loss terms' mask counts
    (:func:`repro_torch.models.api.lm_loss`)."""
    model = get_model(cfg)
    lv = [t.detach().requires_grad_() for t in leaves(params)]
    loss = lm_loss(model.forward_train(unflatten(params, lv), batch, cfg),
                   batch, cfg, counts)
    grads = torch.autograd.grad(loss, lv)
    return loss.detach(), unflatten(params, list(grads))


def mask_counts(batch: dict) -> tuple:
    """The float32 counts of the loss's two masks over ``batch``: the
    t+1 term's ``loss_mask[:, 1:]`` and the MTP t+2 term's
    ``loss_mask[:, 2:]`` (all ones when the batch has no mask)."""
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(batch["tokens"])
    return tuple(torch.sum(mask[:, s:].to(torch.float32)) for s in (1, 2))


def data_shard():
    """``(group, rank, n)``: the process group the ``batch`` axis is split
    over under the active ``axis_rules``, this process's rank in it and
    its size; ``(None, 0, 1)`` when the batch is not split across
    processes."""
    group = axis_group("batch")
    if group is None:
        return None, 0, 1
    return group, dist.get_rank(group), dist.get_world_size(group)


def _microbatches(batch: dict, k: int) -> list:
    B = batch["tokens"].shape[0]
    if B % k:
        raise ValueError(f"batch {B} does not split into {k} microbatches")
    return [{key: v.reshape(k, B // k, *v.shape[1:])[i]
             for key, v in batch.items()} for i in range(k)]


def _rank_rows(mb: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s rows of microbatch ``mb``: [rank·b/n, (rank+1)·b/n)."""
    b = mb["tokens"].shape[0] // n
    return {key: v[rank * b:(rank + 1) * b] for key, v in mb.items()}


def accumulated_grads(cfg: ModelConfig, tcfg: TrainConfig, params,
                      batch: dict) -> tuple:
    """``(loss, grads)`` of the global batch over ``tcfg.grad_accum``
    equal microbatches: the float32 sums, divided by their count. Under a
    data-parallel mesh (:func:`data_shard`) each rank computes its rows of
    every microbatch and the group sums (module docstring); every rank
    returns the global loss and gradients."""
    group, rank, n = data_shard()
    k = max(tcfg.grad_accum, 1)
    if group is not None and batch["tokens"].shape[0] // k % n:
        # the reference's rule drops a sharding that does not divide: the
        # whole microbatch on every rank, laid out as n shards
        with axis_rules(StandInMesh(mesh_shape(current_mesh()))):
            return accumulated_grads(cfg, tcfg, params, batch)
    if group is not None and getattr(cfg.moe, "dispatch",
                                     "grouped") != "grouped":
        raise NotImplementedError(
            f"data-parallel training with MoE dispatch "
            f"{cfg.moe.dispatch!r}: its gather of every rank's tokens has "
            f"no backward")
    if k == 1 and group is None:
        return loss_and_grads(cfg, params, batch)
    acc = None
    for mb in _microbatches(batch, k):
        counts = None
        if group is not None:
            counts = mask_counts(mb)
            mb = _rank_rows(mb, rank, n)
        loss, grads = loss_and_grads(cfg, params, mb, counts)
        if k == 1:  # one microbatch: its gradient in the leaves' dtypes
            acc = (loss, grads)
            continue
        if acc is None:
            acc = (torch.zeros((), dtype=torch.float32, device=loss.device),
                   tree_map(lambda p: torch.zeros(
                       p.shape, dtype=torch.float32, device=p.device),
                       params))
        acc = (acc[0] + loss, tree_map(lambda a, x: a + x.to(torch.float32),
                                       acc[1], grads))
    loss, grads = acc
    if k > 1:
        loss, grads = loss / k, tree_map(lambda g: g / k, grads)
    return (loss, grads) if group is None else _sum_over(group, loss, grads)


def _sum_over(group, loss: torch.Tensor, grads) -> tuple:
    """The loss and the gradients summed over ``group`` in float32 (the
    sum GSPMD makes of a batch-sharded gradient), each gradient cast back
    to its own dtype. A float32 gradient is summed in place: this rank's
    share is not needed again."""
    with torch.no_grad():
        loss = loss.to(torch.float32, copy=True)
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        out = []
        for g in leaves(grads):
            s = g.to(torch.float32)
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
            out.append(s.to(g.dtype))
    return loss, unflatten(grads, out)


def sync_grads(grads, tcfg: TrainConfig,
               failed_block: Optional[int] = None) -> tuple:
    """``(grads, diagnostics)`` after the configured gradient sync."""
    if tcfg.grad_sync == "entangle":
        return ft_grad_sync(grads, axis_name=None, n_replicas=1, M=tcfg.ft_M,
                            failed_block=failed_block, codec=tcfg.grad_codec)
    if tcfg.grad_sync == "checksum":
        return checksum_grad_sync(grads, axis_name=None, n_replicas=1,
                                  M=tcfg.ft_M, failed_block=failed_block)
    if tcfg.grad_sync != "spmd":
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got "
                         f"{tcfg.grad_sync!r}")
    return grads, {}


def apply_grads(state: dict, grads, cfg: ModelConfig,
                tcfg: TrainConfig) -> dict:
    """The AdamW update of ``state`` by (synced) ``grads``; a new state."""
    with torch.no_grad():
        params, opt = adamw_mod.update(
            grads, state["opt"], state["params"], state["step"],
            adamw_mod.effective_lr_config(tcfg.adamw, cfg.d_model))
    return {"params": params, "opt": opt, "step": state["step"] + 1}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    failed_block: Optional[int] = None):
    """Returns ``step(state, batch) -> (state, metrics)``; ``failed_block``
    injects a fail-stop of that gradient block into the FT sync."""
    if tcfg.grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got "
                         f"{tcfg.grad_sync!r}")

    def step(state: dict, batch: dict) -> tuple:
        loss, grads = accumulated_grads(cfg, tcfg, state["params"], batch)
        with torch.no_grad():
            grads, diag = sync_grads(grads, tcfg, failed_block)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                   for g in leaves(grads)))
        new_state = apply_grads(state, grads, cfg, tcfg)
        return new_state, {"loss": loss, "grad_norm": gnorm, **diag}

    return step
