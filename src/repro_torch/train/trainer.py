"""Training driver: checkpoint/restart and the fail-stop drill (port of
:mod:`repro.train.trainer`).

The loop composes the substrates: the stateless synthetic data pipeline
-> the train step -> the NE / checksum-protected gradient sync -> async
checkpointing -> restart.

Failure drills (exercised in the tests):
  * kill/restart: the trainer resumes from the latest atomic snapshot (the
    data pipeline is pure in the step, so there is no data state);
  * fail-stop: at ``fail_block_at_step`` gradient block 1 is lost and
    rolled forward from the other M-1 entangled blocks (the loss curve is
    unaffected).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 10
    seed: int = 0
    fail_block_at_step: Optional[int] = None  # inject fail-stop at this step


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
               loop: LoopConfig, log: Callable[[str], None] = print,
               device=None) -> tuple:
    """Train ``loop.total_steps`` steps from the latest checkpoint under
    ``loop.ckpt_dir`` (or from random params seeded by ``loop.seed``) on
    ``device`` (CUDA unless the caller asks for the CPU). Returns ``(state,
    losses of the steps run)``."""
    # the LR schedule is defined over the run: a loop shorter than the
    # configured warmup would otherwise train at ~0 lr for its whole life
    if tcfg.adamw.total_steps > loop.total_steps:
        tcfg = dataclasses.replace(
            tcfg,
            adamw=dataclasses.replace(
                tcfg.adamw,
                total_steps=loop.total_steps,
                warmup_steps=min(tcfg.adamw.warmup_steps,
                                 max(loop.total_steps // 10, 1)),
            ),
        )

    dev = resolve_device(device)
    data = SyntheticLM(dcfg)
    ckpt = CheckpointManager(loop.ckpt_dir)
    gen = torch.Generator(device=dev).manual_seed(loop.seed)

    state = init_state(gen, cfg, tcfg, dev)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        log(f"[trainer] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    step_fail = None
    if loop.fail_block_at_step is not None and tcfg.grad_sync in (
            "entangle", "checksum"):
        step_fail = make_train_step(cfg, tcfg, failed_block=1)

    losses = []
    t0 = time.monotonic()
    for step in range(start_step, loop.total_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        fn = (step_fail if (step_fail is not None
                            and step == loop.fail_block_at_step) else step_fn)
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % loop.log_every == 0:
            dt = time.monotonic() - t0
            log(f"[trainer] step {step+1} loss={losses[-1]:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} ({dt:.1f}s)")
        if (step + 1) % loop.ckpt_every == 0:
            ckpt.save(state, step + 1)
    t_save = time.monotonic()
    ckpt.save(state, loop.total_steps, blocking=True)
    log(f"[trainer] checkpoint of step {loop.total_steps} written in "
        f"{time.monotonic() - t_save:.1f}s")
    return state, np.array(losses)
