"""Per-slot serving engine, the unprotected baseline (port of
:mod:`repro.serve.reference`): one batch-1 prefill per admitted request
and one batch-1 decode call per active slot per step.

The batched :class:`~repro_torch.serve.ServeEngine` at ``ft_mode='none'``
must give the same greedy tokens; the per-slot engine is what its batching
is measured against. Every admission starts from one shared zeroed cache
of one row (prefill copies nothing into it), so a recycled slot never sees
its previous tenant's state, and a request stops after exactly
``max_new`` tokens.

Fault tolerance is not implemented here: recovery needs the M request
groups in one GEMM, which is what the batched engine does, so ``ft_mode``
must be ``'none'``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Request, ServeConfig
from repro_torch.tree import tree_map


class PerSlotEngine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params, *,
                 device=None):
        if scfg.ft_mode != "none":
            raise ValueError(
                "PerSlotEngine is the unprotected baseline; entangled "
                "serving needs the batched ServeEngine (M groups must share "
                "one GEMM)")
        self.device = resolve_device(device)
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.model = get_model(cfg)
        self.slots: list = [None] * scfg.max_batch
        self.queue: list = []
        self.done: list = []
        # the zero template every admission's cache is copied from
        self._fresh_slot = self.model.init_cache(cfg, 1, scfg.max_seq,
                                                 device=self.device)
        self.decode_calls = 0  # batch-1 decode calls

    def submit(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new
        if need > self.scfg.max_seq:  # the batched engine's capacity rule
            raise ValueError(f"request rid={req.rid} needs {need} positions "
                             f"> max_seq={self.scfg.max_seq}")
        self.queue.append(req)

    def _finish(self, i: int) -> None:
        s = self.slots[i]
        req = s["req"]
        req.out = np.asarray(s["toks"][: req.max_new], np.int32)
        self.done.append(req)
        self.slots[i] = None

    def step(self) -> int:
        """Admit and prefill new requests, then one batch-1 decode call per
        active slot. Returns the active slot count."""
        dev = self.device
        for i in range(len(self.slots)):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                cache = tree_map(torch.clone, self._fresh_slot)
                logits, cache = self.model.prefill(
                    self.params, {"tokens": torch.as_tensor(
                        req.prompt[None, :].astype(np.int64), device=dev)},
                    self.cfg, cache)
                self.slots[i] = {"req": req, "cache": cache,
                                 "pos": len(req.prompt),
                                 "toks": [int(torch.argmax(logits[0]))]}
                if req.max_new <= 1:
                    self._finish(i)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok = torch.as_tensor([[s["toks"][-1]]], dtype=torch.int64,
                                  device=dev)
            logits, s["cache"] = self.model.decode_step(
                self.params, tok, s["cache"], s["pos"], self.cfg)
            self.decode_calls += 1
            s["pos"] += 1
            s["toks"].append(int(torch.argmax(logits[0])))
            if len(s["toks"]) >= s["req"].max_new:
                self._finish(i)
        return sum(s is not None for s in self.slots)

    def run_to_completion(self, max_steps: int = 1000) -> list:
        steps = 0
        while ((self.queue or any(s is not None for s in self.slots))
               and steps < max_steps):
            self.step()
            steps += 1
        return self.done
