"""Batched serving engine with the entangled logits head on the hot path
(port of :mod:`repro.serve.engine`).

One engine step issues ONE batched decode over the whole slot pool:

  * the KV cache is slot-batched (slot i is batch row i of every cache
    tensor) and every slot decodes at its own position (a per-slot
    position vector); the decode's tensors keep one shape whatever the
    traffic, and nothing is read to the host between the model call and
    the argmax;
  * finished slots are recycled: their cache rows are zeroed before the
    next decode, so no tenant sees a predecessor's state. The zeroing is
    deferred and batched: it rides in the next landing's row copy, or one
    batched fill per step zeroes what no landing took.

Admission is bucketed batched prefill: queued prompts are padded to a small
set of length buckets (``ServeConfig.prefill_buckets``; default 8, 16, 32,
..., max_seq), and same-bucket requests form one admission batch of
``Bp = max_batch`` rows that prefills in ``[Bp, width]`` calls. Then:

  * ``prefill_chunk = 0``: each batch prefills its whole bucket in one call
    and lands in the same step;
  * ``prefill_chunk > 0`` (chunked prefill): each step advances at most
    ``max_prefill_per_step`` chunks (earliest deadline, then shortest
    remaining prefill, first) before the decode, so decode latency stays
    flat while long prompts are admitted;
  * ``refill`` (default on): a slot freed mid-flight is planned into a new
    admission batch while other batches are still mid-chunk; ``refill=
    False`` admits one batch at a time (boundary mode);
  * ``token_budget > 0`` (token-packed admission): each step runs ONE
    ``[Rp, Cp]`` program (``Rp = token_budget / prefill_chunk`` rows of
    ``Cp = prefill_chunk`` tokens) gathering the next chunk of up to Rp
    requests from ALL in-flight batches, each row at its own offset and
    advancing to its true prompt length (bucket padding is never packed).
    Per-slot prefill state lives in a slot-indexed staging cache; rows
    are gathered from it, fresh rows (offset 0) zeroed, and written back.
  * a batch lands when its prefill is complete: its first tokens come from
    the rows' last-prompt hidden states, and its cache rows are copied
    into their slots in one row copy per cache tensor.

``submit`` returns a :class:`~repro_torch.serve.scheduler.RequestHandle`
(iterate it to stream tokens, ``cancel()`` it in any state); a queued
request past its ``deadline_ms`` is shed; ``max_queue`` bounds the wait
queue.

Fault tolerance: with ``ft_mode='entangle'`` the vocab projection of every
decode step and of every admission batch's first tokens runs as the fused
entangled int8 GEMM over M request groups (slot -> group = slot % M).
``ft_scope`` widens protection to the in-model projections (``qkv``,
``mlp``, ``out``, ``moe`` — the MoE expert GEMMs, through the grouped
kernel — and ``all``), in decode and in every prefill program. At startup
the engine runs the decode and every prefill program shape it can run
(each chunk width, or the one packed shape) on the ``meta`` device with a
census-only :class:`~repro_torch.ft.FTContext` to list every protected
(site, shape), freezes that census into ``CompiledPlans`` and quantizes
every protected weight once (``prepare_params``); ``plans.misses`` stays 0
under any admission mix. ``step(failed_group=r)`` fail-stops group r at
every protected site of the step; the kernels roll it forward, so the
tokens are bit-identical to a healthy run in every admission mode.
As in the reference, the encoder-decoder family (whisper) takes no scope
but ``head``, and its first admission raises (its prefill needs frames):
it is served through the model API and the protected head
(:mod:`repro_torch.ft.heads`).

``warm_state()`` hands those startup products to a replica of the same
configuration: ``ServeEngine(..., warm=state)`` reruns no census, no plan
compile and no weight quantization.

The reference jit-compiles its programs and donates buffers so XLA updates
them in place; PyTorch runs eagerly, and the port's layers write the
caches in place themselves. Not ported: ``prefill_batch`` (no ported
caller sets it; admission batches have ``max_batch`` rows).

Serving across ranks: the engine reads ``dist.sharding.serve_mesh()`` at
construction, as the reference does. Under a process group of n >= 2
ranks (one process per GPU, e.g. ``torchrun``) that is a ``DeviceMesh``
with one ``data`` dimension, and the slot batch splits across it as the
reference's ``batch -> data`` rule splits it across devices: rank g holds
the cache rows of slots ``[g B/n, (g+1) B/n)`` and runs decode and the
entangled head over them (the M request groups are the rank's own rows).
An admission batch's ``Bp`` rows (or a packed program's ``Rp``) split into
n contiguous blocks too, and block g's rows take free slots of block g, so
prefill and landing stay on that rank. The sampled tokens are all-gathered
over a gloo group of the same ranks, on the host. Every rank is built from
the same config and params and given the same requests and calls; it makes
the same host decisions (shedding, EDF order, admission, finishing,
metrics) from the exchanged state and one clock (rank 0's, broadcast), so
its host state equals every other rank's after every step. A batch whose
rows do not divide by n runs whole on every rank (the reference's rule
drops the axis there), under a stand-in mesh, so that its MoE layers still
form the n dispatch groups of :func:`repro_torch.models.layers.moe_groups`.
Outside a group of two or more ranks the engine takes a stand-in mesh
(``{"data": n}``, a ``shape`` mapping) from an active ``axis_rules``: one
process then lays its slots out and runs every block, as the reference
does on one host of n devices. With neither, everything is one block.

Launch parameters (``ServeConfig.blocks``): None keeps the kernels' rules
(the launcher picks the head's rows per block for each call's rows, which
is what the reference's ``_default_head_blocks`` clamp does, so the port
has no such method); a dict ({"bb", "splits"}) sets the head GEMM's;
``"auto"`` autotunes the head and every in-model protected site:
:meth:`ServeEngine.warm_autotune` sweeps the head's decode and prefill
shapes and the startup census at startup (:mod:`repro_torch.kernels.autotune`; a shape the shipped H100
seed cache covers is a hit, not a sweep), so every call in a step is a
cache hit. A replica started from ``warm=`` state sweeps nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import make_plan
from repro_torch.dist import sharding
from repro_torch.ft import (SCOPES, FTContext, PlanRegistry, compile_plans,
                            prepare_params)
from repro_torch.ft.heads import (ft_logits_decode, ft_logits_prefill,
                                  quantize_head)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.codec import pack_int8
from repro_torch.models.api import get_model
from repro_torch.models.layers import ACT_DTYPE
from repro_torch.models.transformer import readout_scale
from repro_torch.serve.scheduler import (ChunkScheduler, RequestHandle,
                                         TokenRing)
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
    # head-GEMM launch parameters: None | dict | "auto" (autotuned at
    # startup, the in-model sites too)
    blocks: Optional[object] = None
    prefill_buckets: Optional[Sequence[int]] = None  # None = geometric set
    prefill_chunk: int = 0  # > 0: chunked prefill, one chunk per call
    # > 0: token-packed admission, one [token_budget // prefill_chunk,
    # prefill_chunk] program per step over every in-flight batch (needs
    # prefill_chunk > 0, a multiple of it, and rows <= max_batch)
    token_budget: int = 0
    refill: bool = True  # plan new batches while others are mid-prefill
    max_prefill_per_step: int = 1  # chunked: prefill calls before decode
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
    # engine-owned state: queued | prefill | decoding | done | cancelled |
    # shed, and the latency stamps
    status: str = "new"
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    tok_times: list = dataclasses.field(default_factory=list)


class SlotLayout:
    """Where an engine's batches lie across the ``data`` dimension of its
    mesh (None, a stand-in, or a ``DeviceMesh`` of ``procs`` ranks).

    ``n`` is the dimension's extent. A batch of X rows is *split* when the
    ranks are processes (``procs > 1``), n divides X and the slot count B
    (admission rows then fall in the slot blocks of their ranks); this
    process then computes rows ``span(X)`` of it, else all X. The slots are
    *blocked* (admission rows kept in their slots' blocks) whenever n > 1
    divides B, in one process too, so that a stand-in engine plans the
    same batches as the ranks do."""

    def __init__(self, mesh, B: int):
        self.mesh, self.B = mesh, B
        self.n = (sharding.mesh_shape(mesh).get("data", 1)
                  if mesh is not None else 1)
        self.procs = (self.n if mesh is not None
                      and sharding.is_device_mesh(mesh) else 1)
        self.rank = mesh.get_local_rank("data") if self.procs > 1 else 0
        self.blocked = self.n > 1 and B % self.n == 0
        self.whole = sharding.StandInMesh({"data": self.n})
        self.host = None
        if self.procs > 1:
            import torch.distributed as dist

            g = mesh.get_group("data")
            # the tokens and the clock go through the host: gloo
            self.host = g if dist.get_backend(g) == "gloo" else \
                dist.new_group(dist.get_process_group_ranks(g),
                               backend="gloo")
            self._src = dist.get_global_rank(self.host, 0)

    def split(self, X: int) -> bool:
        return self.procs > 1 and self.blocked and X % self.n == 0

    def span(self, X: int) -> tuple:
        """Rows [lo, hi) of an X-row batch that this process computes."""
        if not self.split(X):
            return 0, X
        b = X // self.n
        return self.rank * b, (self.rank + 1) * b

    def rules(self, X: int):
        """The sharding rules an X-row batch's program runs under: the
        ranks' mesh where each holds its own rows, else the stand-in
        (this process holds every shard)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding.axis_rules(self.mesh if self.split(X)
                                   else self.whole)

    def block_of_slot(self, slot: int) -> int:
        return slot // (self.B // self.n) if self.blocked else 0

    def gather(self, local: np.ndarray, X: int) -> np.ndarray:
        """Every rank's rows of a split X-row result, in row order; the
        result itself when this process computed all X rows."""
        if not self.split(X):
            return local
        import torch.distributed as dist

        t = torch.as_tensor(np.ascontiguousarray(local))
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t, group=self.host)
        return torch.cat(parts).numpy()

    def clock(self, base: Callable[[], float]) -> Callable[[], float]:
        """One clock for every rank: rank 0's reading of ``base``,
        broadcast (each call is a collective, which every rank makes at
        the same point)."""
        if self.procs == 1:
            return base
        import torch.distributed as dist

        def shared() -> float:
            t = torch.tensor([base()], dtype=torch.float64)
            dist.broadcast(t, self._src, group=self.host)
            return float(t[0])

        return shared


def _engine_mesh():
    """The engine's mesh: ``serve_mesh()`` in a group of two or more ranks,
    else a stand-in of more than one ``data`` shard from the active
    ``axis_rules``, else None."""
    mesh = sharding.serve_mesh()
    if mesh is not None:
        return mesh
    cur = sharding.current_mesh()
    if (cur is not None and not sharding.is_device_mesh(cur)
            and sharding.mesh_shape(cur).get("data", 1) > 1):
        return cur
    return None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params, *,
                 device=None, warm: Optional[dict] = None):
        self.cfg, self.scfg, self.params = cfg, scfg, params
        if not scfg.greedy:
            raise NotImplementedError("only greedy decode is implemented")
        if not (scfg.blocks is None or scfg.blocks == "auto"
                or isinstance(scfg.blocks, dict)):
            raise ValueError(f"blocks must be None, a dict or 'auto', got "
                             f"{scfg.blocks!r}")
        self.mesh = _engine_mesh()
        self.lay = SlotLayout(self.mesh, scfg.max_batch)
        if warm is not None and warm.get("sig") != self._warm_sig():
            raise ValueError(
                "warm state was built by a differently configured engine; "
                "replicas sharing startup products must share (cfg, scfg "
                "but its clock)")
        self.device = resolve_device(device)
        leaf = params["embed"]["tok"]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"runs on {self.device}")
        self.model = get_model(cfg)
        B, S = scfg.max_batch, scfg.max_seq
        # THE slot-batched cache: slot i = batch row i - slot_lo of every
        # tensor; this process holds slots [slot_lo, slot_hi)
        self.slot_lo, self.slot_hi = self.lay.span(B)
        self.cache = self.model.init_cache(cfg, self.slot_hi - self.slot_lo,
                                           S, device=self.device)
        self.slots: list = [None] * B
        self.queue: list = []
        self.done: list = []
        self.pos = np.zeros(B, np.int64)  # per-slot next decode position
        self.last_tok = np.zeros(B, np.int64)
        self.census: dict = {"prefill": {}, "decode": {}}
        self.decode_calls = 0  # batched decode calls (one per step)
        self.prefill_calls = 0  # prefill calls (chunks or packed steps)
        self.buckets = resolve_buckets(scfg)
        if scfg.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{scfg.prefill_chunk}")
        if scfg.token_budget < 0:
            raise ValueError(f"token_budget must be >= 0, got "
                             f"{scfg.token_budget}")
        if scfg.token_budget:
            # the packed program has ONE shape: the budget tiles into
            # chunk-wide rows, and every row stages in a distinct slot
            if not scfg.prefill_chunk:
                raise ValueError(
                    f"token_budget={scfg.token_budget} requires "
                    f"prefill_chunk > 0 (rows are prefill_chunk tokens "
                    f"wide)")
            if scfg.token_budget % scfg.prefill_chunk:
                raise ValueError(
                    f"token_budget={scfg.token_budget} must be a multiple "
                    f"of prefill_chunk={scfg.prefill_chunk}")
            if scfg.token_budget // scfg.prefill_chunk > B:
                raise ValueError(
                    f"token_budget={scfg.token_budget} / prefill_chunk="
                    f"{scfg.prefill_chunk} = "
                    f"{scfg.token_budget // scfg.prefill_chunk} packed rows "
                    f"> max_batch={B} (each row stages in a distinct slot)")
        # packed geometry: Rp rows of Cp tokens; Rp == 0 is per-batch
        # chunking
        self.Rp = (scfg.token_budget // scfg.prefill_chunk
                   if scfg.token_budget else 0)
        self.Cp = scfg.prefill_chunk
        self.Bp = B  # admission batch rows
        # packed programs keep their rows in the slot blocks when they split
        self._pack_blocks = (self.lay.n if self.Rp and self.lay.blocked
                             and self.Rp % self.lay.n == 0 else 1)
        if self.Rp:
            # slot-indexed staging cache (row i = slot i - stage_lo) of
            # every packed row's mid-prefill state, and its last-prompt
            # hidden states: this rank's slots when the program splits
            self.stage_lo, stage_hi = (self.lay.span(B)
                                       if self.lay.split(self.Rp) else (0, B))
            self._pack_cache = self.model.init_cache(
                cfg, stage_hi - self.stage_lo, S, device=self.device)
            self._pack_hlast = torch.zeros(
                (stage_hi - self.stage_lo, cfg.d_model), dtype=ACT_DTYPE,
                device=self.device)
        self._inflight: list = []  # admission batches not landed yet
        self._reserved: set = set()  # slots claimed by in-flight rows
        self._dirty: list = []  # freed slots whose rows await zeroing
        self._rings: dict = {}  # id(req) -> TokenRing
        self.scatter_calls = 0  # batched row copies / zero fills
        self.sched = ChunkScheduler(
            max_prefill_per_step=scfg.max_prefill_per_step,
            max_queue=scfg.max_queue,
            clock=self.lay.clock(scfg.clock or time.monotonic))
        self._clock = self.sched.clock
        self.metrics = {"queue_depth_peak": 0, "rejected": 0, "shed": 0,
                        "refill_admissions": 0, "landings": 0,
                        "merged_zero_rows": 0, "cancelled": 0,
                        # true prompt tokens packed (padding excluded),
                        # packed calls, and the most admission batches
                        # co-packed into one call
                        "packed_tokens": 0, "packed_calls": 0,
                        "packed_batches_peak": 0,
                        # slots recycled, the batched fills that zeroed
                        # those no landing took, and the landing copies
                        # that zeroed some
                        "recycled": 0, "zero_flushes": 0,
                        "merged_landings": 0}

        self.plans = None
        self.ft_params = params
        if scfg.ft_mode == "entangle":
            if B % scfg.ft_M:
                raise ValueError(
                    f"max_batch={B} must be divisible by ft_M={scfg.ft_M}")
            if scfg.ft_scope not in SCOPES:
                raise ValueError(f"unknown ft_scope {scfg.ft_scope!r}; "
                                 f"expected one of {sorted(SCOPES)}")
            if scfg.ft_scope != "head" and cfg.family == "encdec":
                raise ValueError(
                    "in-model protected GEMMs are decoder-only; enc-dec "
                    "supports ft_scope='head' only")
            if warm is not None:  # the sibling replica's plan and head
                self.plan = warm["plan"]
                self.head_q, self.w_scale = warm["head_q"], warm["w_scale"]
                self.registry = warm["registry"]
            else:
                # made ONCE, shared by every decode step, every admission
                # head projection and every in-model protected site
                self.plan = make_plan(scfg.ft_M, scfg.ft_w)
                # protected int8 weights are stored packed 4 per int32 word
                self.head_q, self.w_scale = quantize_head(
                    self.model.head_weights(params, cfg))
                self.head_q = pack_int8(self.head_q, axis=0)
                # layer sites are autotuned only when the engine tunes; a
                # user's dict targets the head's shape, not theirs
                self.registry = PlanRegistry(
                    self.plan,
                    blocks="auto" if scfg.blocks == "auto" else None)
            self.ftx = FTContext(registry=self.registry, scope=scfg.ft_scope)
        elif scfg.ft_mode != "none":
            raise ValueError(f"unknown ft_mode {scfg.ft_mode!r}")
        self._chunk_widths = self._all_chunk_widths()
        if warm is not None:
            # census, compiled plans and quantized params are immutable
            # after startup: a replica of the same config shares them (and
            # the plans' misses counter)
            self.protected_census = warm["census"]
            self.plans = warm["plans"]
            self.ft_params = warm["ft_params"]
            if self.plans is not None:
                self.ftx = self.ftx.with_plans(self.plans)
            return
        # startup plan compilation: census -> compile_plans -> q8 hoist
        self.protected_census = self._protected_shape_census()
        if scfg.ft_mode == "entangle" and scfg.ft_scope != "head":
            self.plans = compile_plans(self.registry, self.protected_census)
            self.plans.assert_covers(self.protected_census)
            self.ftx = self.ftx.with_plans(self.plans)
            self.ft_params = prepare_params(params, scope=scfg.ft_scope)
        if scfg.blocks == "auto":
            self.warm_autotune()

    def warm_autotune(self) -> dict:
        """Sweep (or find in the cache) the launch parameters of every
        protected GEMM the engine runs: the head's decode and prefill
        shapes and, beyond scope head, every in-model site of the startup
        census. Runs on the engine's device, now, so that ``blocks="auto"``
        in a step is a cache hit; a no-op unless the entangled head is on
        and ``blocks == "auto"``. Returns {shape or (site, shape):
        winner}, also recorded in ``census["head_gemm"]`` and
        ``census["protected"]``."""
        if self.scfg.ft_mode != "entangle" or self.scfg.blocks != "auto":
            return {}
        M = self.plan.M
        D, V = self.cfg.d_model, self.head_q.shape[1]
        # this rank's decode and landing rows, padded to a multiple of M
        shapes = {(M, -(-self._local_rows(n) // M), D, V)
                  for n in (self.scfg.max_batch, self.Bp)}
        won = {}
        for shape in sorted(shapes):
            won[shape] = kops.warm_entangled_matmul(
                *shape, self.plan, fuse_epilogue=True, packed=True,
                device=self.device)
            self.census.setdefault("head_gemm", {})[shape] = won[shape]
        for site, shape in sorted(self.protected_census):
            # 5-tuple shapes are grouped (MoE per-expert) sites
            warm = (kops.warm_entangled_matmul_grouped if len(shape) == 5
                    else kops.warm_entangled_matmul)
            w = warm(*shape, self.plan, fuse_epilogue=True, packed=True,
                     device=self.device)
            self.census.setdefault("protected", {})[(site, shape)] = w
            won[(site, shape)] = w
        return won

    def _warm_sig(self) -> tuple:
        """What replicas sharing startup products must share: the model
        config, the serving config but its clock, and the slot layout."""
        return (self.cfg, dataclasses.replace(self.scfg, clock=None),
                (self.lay.n, self.lay.procs, self.lay.rank))

    def _local_rows(self, X: int) -> int:
        """How many rows of an X-row batch this process computes."""
        lo, hi = self.lay.span(X)
        return hi - lo

    def warm_state(self) -> dict:
        """Startup products a replica of IDENTICAL config can share: the
        protected-site census, the compiled plans (and so their misses
        counter), the startup-quantized params and the quantized head.
        ``ServeEngine(cfg, scfg, params, warm=...)`` then reruns no census,
        no plan compile and no weight quantization."""
        w = {"sig": self._warm_sig(), "census": self.protected_census,
             "plans": self.plans, "ft_params": self.ft_params}
        if self.scfg.ft_mode == "entangle":
            w.update(plan=self.plan, head_q=self.head_q,
                     w_scale=self.w_scale, registry=self.registry)
        return w

    # -- startup census ------------------------------------------------------

    def _all_chunk_widths(self) -> frozenset:
        """Every prefill width per-batch admission can run, from the bucket
        set and the chunk size alone; a refilled batch replays these same
        widths, so refill never meets a shape the census missed."""
        widths = set()
        for Tb in self.buckets:
            step = self.scfg.prefill_chunk or Tb
            for pos0 in range(0, Tb, step):
                widths.add(min(step, Tb - pos0))
        return frozenset(widths)

    def _protected_shape_census(self) -> dict:
        """{(site, shape): plan} for every in-model protected GEMM the
        engine can run — shape ``(M, Bg, K, N)``, or ``(M, E, Bg, K, N)``
        for a grouped MoE site: the decode step and every prefill program
        (one per chunk width, or the one packed ``[Rp, Cp]`` shape) run on
        the ``meta`` device with a census-only context, which records each
        site's shape and runs no kernel. The MoE dispatch (top-k, sort,
        gathers) runs there too: its capacity is a function of the token
        count, so every shape is static. Empty at ft_scope='head'."""
        if self.scfg.ft_mode != "entangle" or self.scfg.ft_scope == "head":
            return {}
        ctx = dataclasses.replace(self.ftx, census_only=True)
        meta = torch.device("meta")
        mp = tree_map(lambda t: torch.empty_like(t, device=meta), self.params)
        S = self.scfg.max_seq

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=meta)

        # every program at this rank's own rows, under its own rules
        B = self._local_rows(self.scfg.max_batch)
        with self.lay.rules(self.scfg.max_batch):
            self.model.decode_hidden(
                mp, zeros(B, 1), self.model.init_cache(self.cfg, B, S,
                                                       device=meta),
                zeros(B), self.cfg, ft=ctx)
        if self.Rp:  # one program shape for every packing mix
            R = self._local_rows(self.Rp)
            with self.lay.rules(self.Rp):
                self.model.prefill_packed(
                    mp, zeros(R, self.Cp), self.cfg,
                    self.model.init_cache(self.cfg, R, S, device=meta),
                    pos0=zeros(R), lengths=zeros(R), ft=ctx)
        else:
            Bp = self._local_rows(self.Bp)
            for C in sorted(self._chunk_widths):
                with self.lay.rules(self.Bp):
                    self.model.prefill_chunk(
                        mp, zeros(Bp, C), self.cfg,
                        self.model.init_cache(self.cfg, Bp, S, device=meta),
                        pos0=0, lengths=zeros(Bp), ft=ctx)
        return self.registry.census()

    # -- requests -------------------------------------------------------------

    def submit(self, req: Request) -> RequestHandle:
        """Enqueue a request; returns its handle (iterate it for the token
        stream, ``cancel()``, ``result()``). Raises on a prompt longer
        than the largest bucket, on a request that would run past
        ``max_seq``, and (:class:`~repro_torch.serve.scheduler.
        AdmissionRejected`) when the wait queue is at ``max_queue``."""
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
        ring = TokenRing(req.max_new)
        self._rings[id(req)] = ring
        self.queue.append(req)
        self.metrics["queue_depth_peak"] = max(
            self.metrics["queue_depth_peak"], len(self.queue))
        return RequestHandle(self, req, ring)

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
                       failed_group=failed_group, blocks=self.scfg.blocks)
        return logits * readout_scale(self.cfg)

    def _copy_rows(self, src, src_rows: list, dst_slots: list,
                   zero_slots: list, src_lo: int = 0) -> None:
        """ONE batched row copy into the slot pool per cache tensor: row
        ``src_rows[j]`` of ``src`` lands in slot ``dst_slots[j]``, and the
        recycled ``zero_slots`` are zeroed in the same copy. Rows and
        slots are batch-wide numbers; this process copies those of its own
        slots (``src`` holds rows from ``src_lo`` on)."""
        self.scatter_calls += 1
        lo, hi = self.slot_lo, self.slot_hi
        pairs = [(r - src_lo, i - lo) for r, i in zip(src_rows, dst_slots)
                 if lo <= i < hi]
        src_rows, dst_slots = [r for r, _ in pairs], [i for _, i in pairs]
        zero_slots = [i - lo for i in zero_slots if lo <= i < hi]
        if not (dst_slots or zero_slots):
            return
        dev = self.device
        sids = torch.as_tensor(dst_slots + zero_slots, dtype=torch.int64,
                               device=dev)
        # zero rows read row 0 of src and are masked to zero
        take = torch.as_tensor(src_rows + [0] * len(zero_slots),
                               dtype=torch.int64, device=dev)
        zero = (torch.as_tensor([False] * len(dst_slots)
                                + [True] * len(zero_slots), device=dev)
                if zero_slots else None)

        def land(big, small):
            rows = small.index_select(1, take)
            if zero is not None:
                z = zero.reshape((1, -1) + (1,) * (rows.dim() - 2))
                rows = torch.where(z, rows.new_zeros(()), rows)
            big.index_copy_(1, sids, rows)

        tree_map(land, self.cache, src)

    # -- admission ------------------------------------------------------------

    def _plan_admission(self) -> bool:
        """Form the next admission batch: EDF over the wait queue, the most
        urgent request's bucket, then every same-bucket request up to the
        free slots. With ``refill`` this runs while other batches are still
        mid-prefill; boundary mode waits for the in-flight batch. Planned
        rows reserve their slots. Returns True if a batch was formed."""
        if not self.queue:
            return False
        if self._inflight and not self.scfg.refill:
            return False
        free = [i for i, s in enumerate(self.slots)
                if s is None and i not in self._reserved]
        if not free:
            return False
        ordered = self.sched.order_queue(self.queue)
        b0 = self._bucket_for(ordered[0])
        budget = min(len(free), self.Bp)
        take, rest = [], []
        for req in ordered:
            (take if len(take) < budget and self._bucket_for(req) == b0
             else rest).append(req)
        self.queue = rest
        if self._inflight:  # a mid-flight refill
            self.metrics["refill_admissions"] += 1
        tokens = np.zeros((self.Bp, b0), np.int64)
        lengths = np.zeros(self.Bp, np.int64)
        slots = free[: len(take)]
        rows = self._admission_rows(slots)
        # p["reqs"][j] is row j's (slot, request); (None, None) is an
        # empty row between filled ones (the slot-block layout)
        reqs = [(None, None)] * (max(rows) + 1)
        for j, slot, req in zip(rows, slots, take):
            tokens[j, : len(req.prompt)] = req.prompt
            lengths[j] = len(req.prompt)
            req.status = "prefill"
            reqs[j] = (slot, req)
        self._reserved.update(slots)
        dev = self.device
        p = {"reqs": reqs, "bucket": b0, "pos0": 0,
             "tokens_np": tokens, "lengths_np": lengths,
             # each row's prefill offset (token-packed admission)
             "rowpos": np.zeros(self.Bp, np.int64)}
        if not self.Rp:  # per-batch chunking: the batch's own cache
            lo, hi = self.lay.span(self.Bp)
            p.update(tokens=torch.as_tensor(tokens[lo:hi], device=dev),
                     lengths=torch.as_tensor(lengths[lo:hi], device=dev),
                     cache=self.model.init_cache(self.cfg, hi - lo,
                                                 self.scfg.max_seq,
                                                 device=dev),
                     h_last=torch.zeros((hi - lo, self.cfg.d_model),
                                        dtype=ACT_DTYPE, device=dev))
        self._inflight.append(p)
        return True

    def _admission_rows(self, slots: list) -> list:
        """The row of the admission batch each slot's request takes: in
        order, or, with the slots blocked, the next free row of the slot's
        block (so that a row and its slot lie on one rank)."""
        if not self.lay.blocked:
            return list(range(len(slots)))
        b = self.Bp // self.lay.n
        used = [0] * self.lay.n
        rows = []
        for i in slots:
            g = self.lay.block_of_slot(i)
            rows.append(g * b + used[g])
            used[g] += 1
        return rows

    def _prefill_fg(self, failed_group: Optional[int]) -> Optional[int]:
        """The failed group a prefill program sees: only an in-model scope
        injects into it (at scope 'head' the landing head does)."""
        return failed_group if self._model_ft(failed_group) is not None \
            else None

    def _advance_prefill(self, p: dict, failed_group: Optional[int]) -> None:
        """Run ONE chunk of admission batch ``p`` at offset ``pos0``,
        keeping each row's last-prompt hidden state once its chunk has run;
        land the batch after its last chunk."""
        Tb = p["bucket"]
        C = self.scfg.prefill_chunk or Tb
        pos0 = p["pos0"]
        sz = min(C, Tb - pos0)
        with self.lay.rules(self.Bp):
            h, _ = self.model.prefill_chunk(
                self.ft_params, p["tokens"][:, pos0:pos0 + sz], self.cfg,
                p["cache"], pos0=pos0, lengths=p["lengths"],
                ft=self._model_ft(self._prefill_fg(failed_group)))
        self.prefill_calls += 1
        idx = p["lengths"] - 1 - pos0
        in_chunk = (idx >= 0) & (idx < sz)
        h_at = h[torch.arange(h.shape[0], device=h.device),
                 idx.clamp(0, sz - 1)]
        p["h_last"] = torch.where(in_chunk[:, None], h_at, p["h_last"])
        p["pos0"] = pos0 + sz
        if p["pos0"] < Tb:
            return
        self.census["prefill"][(self.Bp, Tb)] = \
            self.census["prefill"].get((self.Bp, Tb), 0) + 1
        self._land(p, failed_group, p["cache"],
                   [j for j, (_, r) in enumerate(p["reqs"]) if r is not None])

    def _land(self, p: dict, failed_group: Optional[int], src,
              src_rows: list) -> None:
        """Land a COMPLETE admission batch: project its first tokens from
        ``p["h_last"]`` ([Bp] rows in admission order) and copy its live
        rows (row ``src_rows[j]`` of ``src``) into their slots, with the
        recycled rows that are waiting for zeroing in the same copy. Rows
        cancelled mid-prefill never land. ``p["h_last"]`` holds this
        process's rows of the batch; the first tokens are gathered."""
        live = [(j, i, req) for j, (i, req) in enumerate(p["reqs"])
                if req is not None]
        if live:
            valid = np.zeros(self.Bp, bool)
            valid[[j for j, _, _ in live]] = True
            lo, hi = self.lay.span(self.Bp)
            first = self.lay.gather(torch.argmax(self._head_logits(
                p["h_last"], torch.as_tensor(valid[lo:hi], device=self.device),
                failed_group, ft_logits_prefill), dim=-1).cpu().numpy(),
                self.Bp)
        dst = [i for _, i, _ in live]
        merge = [i for i in self._dirty
                 if self.slots[i] is None and i not in self._reserved
                 and i not in dst]
        for i in merge:
            self._dirty.remove(i)
        self.metrics["merged_zero_rows"] += len(merge)
        self.metrics["merged_landings"] += bool(merge)
        if dst or merge:
            self._copy_rows(src, src_rows, dst, merge,
                            src_lo=(self.stage_lo if self.Rp
                                    else self.lay.span(self.Bp)[0]))
        now = self._clock()
        for j, i, req in live:
            self._reserved.discard(i)
            tok = int(first[j])
            self.slots[i] = {"req": req, "toks": [tok]}
            self.pos[i] = len(req.prompt)
            self.last_tok[i] = tok
            req.status = "decoding"
            self._emit(req, tok, now)
            if req.max_new <= 1 or (req.eos_token is not None
                                    and tok == req.eos_token):
                self._finish(i)
        self.metrics["landings"] += 1
        self._inflight.remove(p)

    # -- token-packed admission ----------------------------------------------

    def _advance_packed(self, failed_group: Optional[int]) -> bool:
        """Run ONE token-packed prefill step: up to ``Rp`` rows from all
        in-flight batches (:meth:`ChunkScheduler.pack_rows`), each the next
        chunk of its true prompt at its own offset, in one ``[Rp, Cp]``
        program over rows gathered from the staging cache; then land every
        batch whose live rows are all complete. Returns True if any row
        was packed."""
        nb = self._pack_blocks
        rows = self.sched.pack_rows(
            self._inflight, self.Rp, blocks=nb,
            block_of=lambda p, i: self.lay.block_of_slot(p["reqs"][i][0]))
        if rows:
            tok = np.zeros((self.Rp, self.Cp), np.int64)
            sids = np.zeros(self.Rp, np.int64)
            pos0r = np.zeros(self.Rp, np.int64)
            lens = np.zeros(self.Rp, np.int64)
            real = np.zeros(self.Rp, bool)
            true_toks = 0
            # a row's place: in order, or the next one of its slot's block
            per, used_rows = self.Rp // nb, [0] * nb
            for p, i in rows:
                g = self.lay.block_of_slot(p["reqs"][i][0]) if nb > 1 else 0
                r = g * per + used_rows[g]
                used_rows[g] += 1
                off = int(p["rowpos"][i])
                n = min(self.Cp, int(p["lengths_np"][i]) - off)
                tok[r, :n] = p["tokens_np"][i, off:off + n]
                sids[r] = p["reqs"][i][0]
                pos0r[r] = off
                lens[r] = p["lengths_np"][i]
                real[r] = True
                true_toks += n
            # pad rows stage in distinct spare slots (of their block);
            # nothing is written back for them
            used = set(sids[real].tolist())
            spare = [[s for s in range(self.scfg.max_batch) if s not in used
                      and (nb == 1 or self.lay.block_of_slot(s) == g)]
                     for g in range(nb)]
            for r in np.nonzero(~real)[0]:
                sids[r] = spare[r // per].pop()
            self._prefill_packed(tok, sids, pos0r, lens,
                                 len(rows) if nb == 1 else real,
                                 self._prefill_fg(failed_group))
            self.prefill_calls += 1
            self.metrics["packed_calls"] += 1
            self.metrics["packed_tokens"] += true_toks
            self.metrics["packed_batches_peak"] = max(
                self.metrics["packed_batches_peak"],
                len({id(p) for p, _ in rows}))
            # ONE program shape whatever the packing mix
            key = (self.Rp, self.Cp)
            self.census["prefill"][key] = \
                self.census["prefill"].get(key, 0) + 1
            for p, i in rows:
                p["rowpos"][i] = min(int(p["rowpos"][i]) + self.Cp,
                                     int(p["lengths_np"][i]))
        for p in list(self._inflight):
            live = [i for i, (_, r) in enumerate(p["reqs"]) if r is not None]
            if all(p["rowpos"][i] >= p["lengths_np"][i] for i in live):
                self._land_packed(p, failed_group)
        return bool(rows)

    def _prefill_packed(self, tok, sids, pos0r, lens, n,
                        failed_group: Optional[int]) -> None:
        """The packed program: gather the rows' staging state by slot,
        zero fresh rows (offset 0: a recycled staging row never leaks into
        a new prompt), run the model's token-packed prefill, keep each
        row's last-prompt hidden state, and write the real rows back:
        the first ``n``, or those of the boolean mask ``n`` (the slot-block
        layout). This process runs its own rows of the program."""
        dev = self.device
        lo, hi = self.lay.span(self.Rp)
        real = (np.arange(self.Rp) < n if isinstance(n, int)
                else np.asarray(n))[lo:hi]
        tok = tok[lo:hi]
        sid_t = torch.as_tensor(sids[lo:hi] - self.stage_lo, device=dev)
        pos_t = torch.as_tensor(pos0r[lo:hi], device=dev)
        len_t = torch.as_tensor(lens[lo:hi], device=dev)
        fresh = pos_t == 0

        def take(a):
            rows = a.index_select(1, sid_t)
            f = fresh.reshape((1, -1) + (1,) * (rows.dim() - 2))
            return torch.where(f, rows.new_zeros(()), rows)

        rows = tree_map(take, self._pack_cache)
        with self.lay.rules(self.Rp):
            h, _ = self.model.prefill_packed(
                self.ft_params, torch.as_tensor(tok, device=dev), self.cfg,
                rows, pos0=pos_t, lengths=len_t,
                ft=self._model_ft(failed_group))
        Cp = tok.shape[1]
        idx = len_t - 1 - pos_t
        in_chunk = (idx >= 0) & (idx < Cp)
        h_at = h[torch.arange(h.shape[0], device=dev), idx.clamp(0, Cp - 1)]
        hrow = torch.where(in_chunk[:, None], h_at,
                           self._pack_hlast.index_select(0, sid_t))
        ri = torch.as_tensor(np.nonzero(real)[0], device=dev)
        if not len(ri):
            return
        dst = sid_t[ri]
        tree_map(lambda big, small: big.index_copy_(
            1, dst, small.index_select(1, ri)), self._pack_cache, rows)
        self._pack_hlast.index_copy_(0, dst, hrow[ri])

    def _land_packed(self, p: dict, failed_group: Optional[int]) -> None:
        """Land a finished packed batch: its last-prompt hidden states are
        gathered into [Bp] rows in admission order (so the landing head's
        row -> group map is the per-batch path's), and its live rows move
        from the staging cache to the same slots of the pool."""
        sids_l = [i for i, _ in p["reqs"]]
        sids_l += [None] * (self.Bp - len(sids_l))
        spare = [s for s in range(self.scfg.max_batch) if s not in sids_l]
        b = self.Bp // self.lay.n if self.lay.blocked else self.Bp
        for j, i in enumerate(sids_l):  # an empty row reads a spare slot
            if i is None:  # of its block
                i = next(s for s in spare
                         if self.lay.block_of_slot(s) == j // b)
                spare.remove(i)
                sids_l[j] = i
        lo, hi = self.lay.span(self.Bp)
        gsids = torch.as_tensor(sids_l[lo:hi], dtype=torch.int64,
                                device=self.device) - self.stage_lo
        p["h_last"] = self._pack_hlast.index_select(0, gsids)
        self._land(p, failed_group, self._pack_cache,
                   [i for i, r in p["reqs"] if r is not None])

    # -- tokens, cancel, recycling ---------------------------------------------

    def _emit(self, req: Request, tok: int, now: float) -> None:
        """Push a token into the request's ring; stamp TTFT and token
        times."""
        if req.t_first is None:
            req.t_first = now
        req.tok_times.append(now)
        ring = self._rings.get(id(req))
        if ring is not None:
            ring.push(tok)

    def _finish(self, i: int) -> None:
        s = self.slots[i]
        req = s["req"]
        req.out = np.asarray(s["toks"][: req.max_new], np.int32)
        req.status = "done"
        req.t_done = self._clock()
        self._rings.pop(id(req), None)  # the handle keeps its own reference
        self.done.append(req)
        self._recycle(i)

    def cancel(self, req: Request) -> None:
        """Abandon a request in whatever state it is in: a queued request
        leaves the queue; a row mid-prefill is voided (it keeps computing
        under fixed shapes but never lands, and its slot frees at once); a
        decoding slot keeps its partial output and recycles. A finished
        request is left as it is."""
        if req.status in ("done", "cancelled", "shed"):
            return
        if req.status == "queued":
            self.queue = [r for r in self.queue if r is not req]
        elif req.status == "prefill":
            for p in self._inflight:
                for j, (slot, r) in enumerate(p["reqs"]):
                    if r is req:
                        p["reqs"][j] = (slot, None)
                        self._reserved.discard(slot)
        else:  # decoding
            for i, s in enumerate(self.slots):
                if s is not None and s["req"] is req:
                    req.out = np.asarray(s["toks"], np.int32)
                    self._recycle(i)
        req.status = "cancelled"
        if req.out is None:
            req.out = np.zeros(0, np.int32)
        req.t_done = self._clock()
        self._rings.pop(id(req), None)
        self.metrics["cancelled"] += 1

    def _recycle(self, i: int) -> None:
        """Free slot i and queue its cache row for zeroing: the zeroing
        rides in the next landing's row copy, or in one batched fill
        before the next decode (:meth:`_flush_recycled`)."""
        self.slots[i] = None
        self.pos[i] = 0
        self.last_tok[i] = 0
        self._dirty.append(i)
        self.metrics["recycled"] += 1

    def _flush_recycled(self) -> None:
        """Zero the freed rows no landing took, in ONE fill per cache
        tensor. Re-occupied slots are skipped (their landing overwrote the
        row); slots reserved by an in-flight batch wait (their landing will
        overwrite them, or a later flush zeroes them if the row is
        cancelled)."""
        keep, flush = [], []
        for i in sorted(set(self._dirty)):
            if self.slots[i] is not None:
                continue
            (keep if i in self._reserved else flush).append(i)
        self._dirty = keep
        if flush:
            own = [i - self.slot_lo for i in flush
                   if self.slot_lo <= i < self.slot_hi]
            if own:
                idx = torch.as_tensor(own, dtype=torch.int64,
                                      device=self.device)
                tree_map(lambda t: t.index_fill_(1, idx, 0), self.cache)
            self.scatter_calls += 1
            self.metrics["zero_flushes"] += 1

    # -- the step -------------------------------------------------------------

    def step(self, failed_group: Optional[int] = None) -> int:
        """One engine step: shed expired queued requests, advance
        admission, zero the recycled rows no landing took, then ONE batched
        decode for every active slot. Admission without chunking lands
        every batch it can form in this step; chunked admission runs at
        most ``max_prefill_per_step`` prefill calls (per-batch chunks, or
        packed steps after planning every batch that can form).
        ``failed_group`` fail-stops that entangled group at every
        protected site of the step; the kernels roll it forward. Returns
        the active slot count."""
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
                self._rings.pop(id(req), None)
                self.metrics["shed"] += 1
        if self.Rp:
            for _ in range(self.scfg.max_prefill_per_step):
                while self._plan_admission():
                    pass
                if not self._advance_packed(failed_group):
                    break
        else:
            budget = (self.scfg.max_prefill_per_step
                      if self.scfg.prefill_chunk else float("inf"))
            while budget > 0:
                self._plan_admission()
                p = self.sched.pick_batch(self._inflight)
                if p is None:
                    break
                self._advance_prefill(p, failed_group)
                budget -= 1
        self._flush_recycled()
        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        if active_idx:
            dev = self.device
            B, lo, hi = self.scfg.max_batch, self.slot_lo, self.slot_hi
            active = np.zeros(B, bool)
            active[active_idx] = True
            with self.lay.rules(B):  # this process's slots
                h, _ = self.model.decode_hidden(
                    self.ft_params, torch.as_tensor(
                        self.last_tok[lo:hi, None], device=dev),
                    self.cache, torch.as_tensor(self.pos[lo:hi], device=dev),
                    self.cfg, ft=self._model_ft(failed_group))
            nxt = self.lay.gather(torch.argmax(self._head_logits(
                h, torch.as_tensor(active[lo:hi], device=dev), failed_group,
                ft_logits_decode), dim=-1).cpu().numpy(), B)
            self.decode_calls += 1
            sig = (len(active_idx), self.scfg.max_batch)
            self.census["decode"][sig] = self.census["decode"].get(sig, 0) + 1
            now = self._clock()
            for i in active_idx:
                s = self.slots[i]
                req = s["req"]
                self.pos[i] += 1
                tok = int(nxt[i])
                s["toks"].append(tok)
                self.last_tok[i] = tok
                self._emit(req, tok, now)
                if (len(s["toks"]) >= req.max_new
                        or (req.eos_token is not None
                            and tok == req.eos_token)):
                    self._finish(i)
        return sum(s is not None for s in self.slots)

    def idle(self) -> bool:
        """True when the queue is empty, no admission batch is in flight
        and every slot is free."""
        return (not self.queue and not self._inflight
                and all(s is None for s in self.slots))

    def run_to_completion(self, max_steps: int = 1000,
                          failed_group: Optional[int] = None) -> list:
        """Drain the queue; ``failed_group`` is injected on EVERY step. The
        drained engine's freed rows are zeroed."""
        steps = 0
        while not self.idle() and steps < max_steps:
            self.step(failed_group=failed_group)
            steps += 1
        self._flush_recycled()
        return self.done
