"""Batched serving engine with the entangled logits head on the hot path
(port of the serving slice of :mod:`repro.serve.engine`).

One engine step issues ONE batched decode over the whole slot pool:

  * the KV cache is slot-batched — slot i is batch row i of every cache
    tensor — and every slot decodes at its own position (a per-slot
    position vector);
  * admission is bucketed batched prefill: queued prompts are padded to a
    small set of length buckets (``ServeConfig.prefill_buckets``; default
    8, 16, 32, ..., max_seq), all same-bucket admits prefill in one
    [Bp, bucket] call, and their cache rows are copied into free slots;
  * finished slots are freed and their cache rows zeroed, so no tenant
    sees a predecessor's state.

Fault tolerance: with ``ft_mode='entangle'`` the vocab projection of every
decode step and of every admission batch's first token runs as the fused
entangled int8 GEMM over M request groups (slot -> group = slot % M).
``ft_scope`` widens protection to the in-model projections (``qkv``,
``mlp``, ``out``, ``moe`` — the MoE expert GEMMs, through the grouped
kernel — and ``all``). At startup the engine runs the forward pass on
the ``meta`` device with a census-only :class:`~repro_torch.ft.FTContext`
to list every protected (site, shape), freezes that census into
``CompiledPlans`` and quantizes every protected weight once
(``prepare_params``). ``step(failed_group=r)`` fail-stops group r at every
protected site of the step; the kernels roll it forward, so the tokens are
bit-identical to a healthy run.

The reference jit-compiles its decode and prefill programs and donates the
cache to them so XLA updates it in place (``engine.py:402-430``). That
block has no counterpart here: PyTorch runs eagerly, and the port's layers
write the cache in place themselves.

Not ported yet (raise ``NotImplementedError``): chunked prefill
(``prefill_chunk > 0``), token-packed admission (``token_budget > 0``),
warm-started replicas (``warm=``) and autotuned blocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import make_plan
from repro_torch.ft import (SCOPES, FTContext, PlanRegistry, compile_plans,
                            prepare_params)
from repro_torch.ft.heads import (ft_logits_decode, ft_logits_prefill,
                                  quantize_head)
from repro_torch.kernels.codec import pack_int8
from repro_torch.models.api import get_model
from repro_torch.models.transformer import readout_scale
from repro_torch.serve.scheduler import ChunkScheduler
from repro_torch.tree import tree_map


def geometric_buckets(max_seq: int, base: int = 8) -> tuple:
    """Default prefill length buckets: powers of two from ``base`` up,
    capped with ``max_seq`` itself."""
    out, b = [], base
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


def resolve_buckets(scfg: "ServeConfig") -> tuple:
    buckets = tuple(sorted(set(
        int(b) for b in (scfg.prefill_buckets
                         or geometric_buckets(scfg.max_seq)))))
    if buckets[0] < 1 or buckets[-1] > scfg.max_seq:
        raise ValueError(f"prefill_buckets {buckets} must lie in [1, "
                         f"max_seq={scfg.max_seq}]")
    return buckets


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4  # slot count; must be divisible by ft_M if entangling
    max_seq: int = 256
    ft_mode: str = "none"  # none | entangle
    ft_M: int = 4
    ft_w: int = 32
    ft_scope: str = "head"  # head | qkv | mlp | out | moe | all
    greedy: bool = True
    blocks: Optional[object] = None  # not ported: the kernel picks its tiles
    prefill_buckets: Optional[Sequence[int]] = None  # None = geometric set
    prefill_chunk: int = 0  # > 0 (chunked prefill) is not ported yet
    token_budget: int = 0  # > 0 (token-packed admission) is not ported yet
    max_queue: int = 0  # wait-queue bound; submit raises past it. 0 = off
    clock: Optional[Callable[[], float]] = None  # None = time.monotonic


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [T] int32
    max_new: int = 16
    out: Optional[np.ndarray] = None
    deadline_ms: Optional[float] = None  # shed from the queue past it
    eos_token: Optional[int] = None
    # engine-owned state: queued | prefill | decoding | done | shed
    status: str = "new"
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params, *,
                 device=None, warm: Optional[dict] = None):
        if warm is not None:
            raise NotImplementedError("warm-started replicas (warm=) are "
                                      "not ported yet")
        if not scfg.greedy:
            raise NotImplementedError("only greedy decode is implemented")
        if scfg.prefill_chunk:
            raise NotImplementedError(
                f"prefill_chunk={scfg.prefill_chunk}: chunked prefill is "
                f"not ported yet")
        if scfg.token_budget:
            raise NotImplementedError(
                f"token_budget={scfg.token_budget}: token-packed admission "
                f"is not ported yet")
        if scfg.blocks is not None:
            raise NotImplementedError(
                f"blocks={scfg.blocks!r}: block sizes and autotuning are "
                f"not ported yet")
        self.device = resolve_device(device)
        leaf = params["embed"]["tok"]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"runs on {self.device}")
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.model = get_model(cfg)
        B, S = scfg.max_batch, scfg.max_seq
        # THE slot-batched cache: slot i = batch row i of every tensor
        self.cache = self.model.init_cache(cfg, B, S, device=self.device)
        self.slots: list = [None] * B
        self.queue: list = []
        self.done: list = []
        self.pos = np.zeros(B, np.int64)  # per-slot next decode position
        self.last_tok = np.zeros(B, np.int64)
        self.census: dict = {"prefill": {}, "decode": {}}
        self.decode_calls = 0  # batched decode calls (one per step)
        self.buckets = resolve_buckets(scfg)
        self.Bp = B  # admission batch rows
        # admission-batch cache, zeroed before every admission
        self._prefill_cache = self.model.init_cache(cfg, self.Bp, S,
                                                    device=self.device)
        self.sched = ChunkScheduler(max_queue=scfg.max_queue,
                                    clock=scfg.clock or time.monotonic)
        self._clock = self.sched.clock
        self.metrics = {"queue_depth_peak": 0, "rejected": 0, "shed": 0}

        self.plans = None
        self.ft_params = params
        if scfg.ft_mode == "entangle":
            if B % scfg.ft_M:
                raise ValueError(
                    f"max_batch={B} must be divisible by ft_M={scfg.ft_M}")
            if scfg.ft_scope not in SCOPES:
                raise ValueError(f"unknown ft_scope {scfg.ft_scope!r}; "
                                 f"expected one of {sorted(SCOPES)}")
            # made ONCE, shared by every decode step, every admission head
            # projection and every in-model protected site
            self.plan = make_plan(scfg.ft_M, scfg.ft_w)
            # protected int8 weights are stored packed 4 per int32 word
            self.head_q, self.w_scale = quantize_head(
                self.model.head_weights(params, cfg))
            self.head_q = pack_int8(self.head_q, axis=0)
            self.registry = PlanRegistry(self.plan)
            self.ftx = FTContext(registry=self.registry, scope=scfg.ft_scope)
        elif scfg.ft_mode != "none":
            raise ValueError(f"unknown ft_mode {scfg.ft_mode!r}")
        # startup plan compilation: census -> compile_plans -> q8 hoist
        self.protected_census = self._protected_shape_census()
        if scfg.ft_mode == "entangle" and scfg.ft_scope != "head":
            self.plans = compile_plans(self.registry, self.protected_census)
            self.plans.assert_covers(self.protected_census)
            self.ftx = self.ftx.with_plans(self.plans)
            self.ft_params = prepare_params(params, scope=scfg.ft_scope)

    # -- startup census ------------------------------------------------------

    def _protected_shape_census(self) -> dict:
        """{(site, shape): plan} for every in-model protected GEMM the
        engine can run — shape ``(M, Bg, K, N)``, or ``(M, E, Bg, K, N)``
        for a grouped MoE site: the decode step and one prefill per bucket
        run on the ``meta`` device with a census-only context, which
        records each site's shape and runs no kernel. The MoE dispatch
        (top-k, sort, gathers) runs there too: its capacity is a function
        of the token count, so every shape is static. Empty at
        ft_scope='head'."""
        if self.scfg.ft_mode != "entangle" or self.scfg.ft_scope == "head":
            return {}
        ctx = dataclasses.replace(self.ftx, census_only=True)
        meta = torch.device("meta")
        mp = tree_map(lambda t: torch.empty_like(t, device=meta), self.params)
        B, S = self.scfg.max_batch, self.scfg.max_seq
        self.model.decode_hidden(
            mp, torch.zeros((B, 1), dtype=torch.int64, device=meta),
            self.model.init_cache(self.cfg, B, S, device=meta),
            torch.zeros((B,), dtype=torch.int64, device=meta), self.cfg,
            ft=ctx)
        for C in self.buckets:  # whole-bucket prefill: one width per bucket
            self.model.prefill_chunk(
                mp, torch.zeros((self.Bp, C), dtype=torch.int64, device=meta),
                self.cfg, self.model.init_cache(self.cfg, self.Bp, S,
                                                device=meta),
                pos0=0, lengths=torch.zeros((self.Bp,), dtype=torch.int64,
                                            device=meta), ft=ctx)
        return self.registry.census()

    # -- requests -------------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Enqueue a request. Raises on a prompt longer than the largest
        bucket, on a request that would run past ``max_seq``, and
        (:class:`~repro_torch.serve.scheduler.AdmissionRejected`) when the
        wait queue is at ``max_queue``."""
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"request rid={req.rid} prompt length {len(req.prompt)} > "
                f"largest prefill bucket {self.buckets[-1]}")
        need = len(req.prompt) + req.max_new
        if need > self.scfg.max_seq:
            raise ValueError(
                f"request rid={req.rid} needs {need} positions (prompt "
                f"{len(req.prompt)} + max_new {req.max_new}) > max_seq="
                f"{self.scfg.max_seq}")
        try:
            self.sched.check_admission(req.rid, len(self.queue))
        except RuntimeError:
            self.metrics["rejected"] += 1
            raise
        req.status = "queued"
        req.t_submit = self._clock()
        self.queue.append(req)
        self.metrics["queue_depth_peak"] = max(
            self.metrics["queue_depth_peak"], len(self.queue))
        return req

    def _bucket_for(self, req: Request) -> int:
        return next(b for b in self.buckets if len(req.prompt) <= b)

    # -- the forward pieces ---------------------------------------------------

    def _model_ft(self, failed_group: Optional[int]):
        """The FT context threaded INTO the model, or None when no in-model
        site is protected (ft off, or scope 'head')."""
        if self.scfg.ft_mode != "entangle" or self.scfg.ft_scope == "head":
            return None
        return self.ftx.with_failed(failed_group)

    def _head_logits(self, h: torch.Tensor, mask: torch.Tensor,
                     failed_group: Optional[int], ft_fn) -> torch.Tensor:
        """Head of decode steps and admission batches: masked rows are
        zeroed (their logits are then deterministic); with ft on, the fused
        entangled int8 GEMM, scaled to head_project's readout temperature."""
        if self.scfg.ft_mode != "entangle":
            return self.model.head_project(self.ft_params, h, self.cfg)
        hf = torch.where(mask[:, None], h.to(torch.float32), 0.0)
        logits = ft_fn(hf, self.head_q, self.w_scale, plan=self.plan,
                       failed_group=failed_group)
        return logits * readout_scale(self.cfg)

    def _zero_rows(self, slots: list) -> None:
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        tree_map(lambda t: t.index_fill_(1, idx, 0), self.cache)

    # -- admission ------------------------------------------------------------

    def _admit_one_batch(self, failed_group: Optional[int]) -> bool:
        """Form one admission batch (EDF over the queue, the most urgent
        request's bucket, every same-bucket request up to the free slots),
        prefill it in ONE batched call, project its first tokens and copy
        its cache rows into the slots. Returns False if nothing admitted."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not self.queue or not free:
            return False
        ordered = self.sched.order_queue(self.queue)
        b0 = self._bucket_for(ordered[0])
        budget = min(len(free), self.Bp)
        take, rest = [], []
        for req in ordered:
            (take if len(take) < budget and self._bucket_for(req) == b0
             else rest).append(req)
        self.queue = rest
        tokens = np.zeros((self.Bp, b0), np.int64)
        lengths = np.zeros(self.Bp, np.int64)
        for j, req in enumerate(take):
            tokens[j, : len(req.prompt)] = req.prompt
            lengths[j] = len(req.prompt)
            req.status = "prefill"
        dev = self.device
        pcache = self._prefill_cache
        tree_map(lambda t: t.zero_(), pcache)
        fg = failed_group if self._model_ft(failed_group) is not None else None
        len_t = torch.as_tensor(lengths, device=dev)
        h, _ = self.model.prefill_chunk(
            self.ft_params, torch.as_tensor(tokens, device=dev), self.cfg,
            pcache, pos0=0, lengths=len_t, ft=self._model_ft(fg))
        rows = torch.arange(self.Bp, device=dev)
        h_last = h[rows, torch.clamp(len_t - 1, min=0)]
        valid = torch.as_tensor(np.arange(self.Bp) < len(take), device=dev)
        first = torch.argmax(self._head_logits(
            h_last, valid, failed_group, ft_logits_prefill), dim=-1).cpu()
        self.census["prefill"][(self.Bp, b0)] = \
            self.census["prefill"].get((self.Bp, b0), 0) + 1
        slots = free[: len(take)]
        sid = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        n = len(take)
        for big_u, small_u in zip(self.cache, pcache):
            for big, small in zip(big_u, small_u):
                for key in big:
                    big[key].index_copy_(1, sid, small[key][:, :n])
        now = self._clock()
        for j, (i, req) in enumerate(zip(slots, take)):
            tok = int(first[j])
            self.slots[i] = {"req": req, "toks": [tok]}
            self.pos[i] = len(req.prompt)
            self.last_tok[i] = tok
            req.status = "decoding"
            req.t_first = now
            if req.max_new <= 1 or (req.eos_token is not None
                                    and tok == req.eos_token):
                self._finish(i)
        return True

    def _finish(self, i: int) -> None:
        req = self.slots[i]["req"]
        req.out = np.asarray(self.slots[i]["toks"][: req.max_new], np.int32)
        req.status = "done"
        req.t_done = self._clock()
        self.done.append(req)
        self.slots[i] = None
        self.pos[i] = 0
        self.last_tok[i] = 0
        self._zero_rows([i])

    # -- the step -------------------------------------------------------------

    def step(self, failed_group: Optional[int] = None) -> int:
        """One engine step: admit what fits (each batch one prefill call),
        then ONE batched decode for every active slot. ``failed_group``
        fail-stops that entangled group at every protected site of the
        step; the kernels roll it forward. Returns the active slot count."""
        if failed_group is not None:
            if self.scfg.ft_mode != "entangle":
                raise ValueError("failed_group requires ft_mode='entangle'")
            if not 0 <= failed_group < self.scfg.ft_M:
                raise ValueError(f"failed_group={failed_group} out of range "
                                 f"for ft_M={self.scfg.ft_M}")
        if any(r.deadline_ms is not None for r in self.queue):
            self.queue, shed = self.sched.shed_expired(self.queue)
            for req in shed:
                req.status = "shed"
                req.out = np.zeros(0, np.int32)
                req.t_done = self._clock()
                self.metrics["shed"] += 1
        while self._admit_one_batch(failed_group):
            pass
        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        if active_idx:
            dev = self.device
            active = np.zeros(self.scfg.max_batch, bool)
            active[active_idx] = True
            h, _ = self.model.decode_hidden(
                self.ft_params, torch.as_tensor(self.last_tok[:, None],
                                                device=dev),
                self.cache, torch.as_tensor(self.pos, device=dev), self.cfg,
                ft=self._model_ft(failed_group))
            nxt = torch.argmax(self._head_logits(
                h, torch.as_tensor(active, device=dev), failed_group,
                ft_logits_decode), dim=-1).cpu().numpy()
            self.decode_calls += 1
            sig = (len(active_idx), self.scfg.max_batch)
            self.census["decode"][sig] = self.census["decode"].get(sig, 0) + 1
            for i in active_idx:
                s = self.slots[i]
                self.pos[i] += 1
                tok = int(nxt[i])
                s["toks"].append(tok)
                self.last_tok[i] = tok
                req = s["req"]
                if (len(s["toks"]) >= req.max_new
                        or (req.eos_token is not None
                            and tok == req.eos_token)):
                    self._finish(i)
        return sum(s is not None for s in self.slots)

    def idle(self) -> bool:
        """True when the queue is empty and every slot is free."""
        return not self.queue and all(s is None for s in self.slots)

    def run_to_completion(self, max_steps: int = 1000,
                          failed_group: Optional[int] = None) -> list:
        """Drain the queue; ``failed_group`` is injected on EVERY step."""
        steps = 0
        while not self.idle() and steps < max_steps:
            self.step(failed_group=failed_group)
            steps += 1
        return self.done
