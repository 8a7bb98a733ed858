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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import checksum_grad_sync, ft_grad_sync
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
    return {"params": params, "opt": adamw_mod.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_and_grads(cfg: ModelConfig, params, batch: dict) -> tuple:
    """``(loss, grads)`` of one (micro)batch; the grads have the params'
    structure."""
    model = get_model(cfg)
    lv = [t.detach().requires_grad_() for t in leaves(params)]
    loss = lm_loss(model.forward_train(unflatten(params, lv), batch, cfg),
                   batch, cfg)
    grads = torch.autograd.grad(loss, lv)
    return loss.detach(), unflatten(params, list(grads))


def accumulated_grads(cfg: ModelConfig, tcfg: TrainConfig, params,
                      batch: dict) -> tuple:
    """``(loss, grads)`` over ``tcfg.grad_accum`` equal microbatches of the
    batch: the float32 sums, divided by their count."""
    k = tcfg.grad_accum
    if k <= 1:
        return loss_and_grads(cfg, params, batch)
    B = batch["tokens"].shape[0]
    if B % k:
        raise ValueError(f"batch {B} does not split into {k} microbatches")
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(k):
        mb = {key: v.reshape(k, B // k, *v.shape[1:])[i]
              for key, v in batch.items()}
        l, g = loss_and_grads(cfg, params, mb)
        loss = loss + l
        g_acc = tree_map(lambda a, x: a + x.to(torch.float32), g_acc, g)
    return loss / k, tree_map(lambda g: g / k, g_acc)


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
