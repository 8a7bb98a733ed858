"""AdamW over nested param dicts (port of :mod:`repro.optim.adamw`).

Plain functions, as in the reference: ``init`` makes the moments,
``update`` returns new params and moments (out of place) from the
gradients. Every float step is float32 in the reference's order of
operations — the schedule from the int step, ``b1 ** t`` with ``t`` the
int step plus one, the ``(0.1 + 0.9 * cos)`` decay — so the two agree to
float32 rounding (XLA's and torch's ``cos`` and ``pow`` may differ in the
last ulp). The step and the learning rate stay tensors on the params'
device, so an update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000


# muP-style width transfer: ``lr`` is tuned at this width; the effective
# rate scales by MUP_BASE_WIDTH/d_model so narrow smoke models and wide
# production models share one tuning (the reference's default)
MUP_BASE_WIDTH = 2048


def effective_lr_config(cfg: AdamWConfig, d_model: int) -> AdamWConfig:
    """Width-transferred copy of ``cfg`` for a model of width ``d_model``."""
    if d_model <= 0 or d_model == MUP_BASE_WIDTH:
        return cfg
    return dataclasses.replace(cfg, lr=cfg.lr * MUP_BASE_WIDTH / d_model)


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at the int32 ``step`` (a 0-dim tensor): linear warmup
    from ``step + 1`` (the first step must not be a no-op), then cosine
    decay to a tenth. float32, on the step's device."""
    dev = step.device
    warm = torch.clamp((step + 1).to(torch.float32)
                       / _f32(max(cfg.warmup_steps, 1), dev), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).to(torch.float32)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params) -> dict:
    """Zero float32 moments ``m`` and ``v``, one pair per param (the
    reference's default ``state_dtype``; its bfloat16 moments are not
    ported)."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(z, params), "v": tree_map(z, params)}


def update(grads, opt_state, params, step: torch.Tensor, cfg: AdamWConfig):
    """One AdamW step; returns ``(new params, {"m", "v"})``. ``step`` is the
    int32 0-dim step counter before this update."""
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(torch.float32)
    dev = step.device
    bc1 = 1 - torch.pow(_f32(b1, dev), t)
    bc2 = 1 - torch.pow(_f32(b2, dev), t)

    def m_upd(g, m):
        return b1 * m + (1 - b1) * g.to(torch.float32)

    def v_upd(g, v):
        return b2 * v + (1 - b2) * torch.square(g.to(torch.float32))

    m_new = tree_map(m_upd, grads, opt_state["m"])
    v_new = tree_map(v_upd, grads, opt_state["v"])

    def p_upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        step_ = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - lr * step_).to(p.dtype)

    params_new = tree_map(p_upd, params, m_new, v_new)
    return params_new, {"m": m_new, "v": v_new}
