"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch llama3.2-1b --smoke``

Boots the batched serving engine with random weights (from a seeded
``torch.Generator``) on ``--device`` (default ``cuda``) and runs a
synthetic request wave. Every arch of the reference is ported; the
engine serves all but whisper-small (as the reference's engine). The
launcher keeps float32 masters; ``--n-layers`` cuts the depth of the
published config (float32 masters alone take about 63 GB for
deepseek-v2-lite's 27 layers and 81 GB for granite-20b's 52; deepseek-v3
at published widths serves on one card with bf16 masters through the
model API, as ``chip_smoke.py`` does). ``--ft-mode entangle`` runs the
vocab projection of every decode step and admission batch as the fused
entangled int8 GEMM (slot -> group = slot % ft_M); ``--ft-scope`` widens
protection to the in-model projections; ``--failed-group r`` fail-stops
group r on every step. With ``--smoke`` and entanglement on, the launcher prints a
per-scope recovery summary (the head scope and the configured scope;
healthy and injected tokens compared request by request), ending in
``EXACT ROLL-FORWARD`` or ``RECOVERY FAILED``; a mismatch exits 1.

Admission: ``--prefill-buckets 8,16,32`` overrides the geometric length
buckets, ``--prefill-chunk C`` interleaves C-token prefill chunks with the
decode steps (0 = a whole bucket per call), ``--token-budget N`` packs up
to N prompt tokens per step from every in-flight admission batch into one
``[N / C, C]`` program (needs ``--prefill-chunk`` > 0, N a multiple of it,
and N / C <= ``--max-batch``), and ``--no-refill`` admits one batch at a
time. ``--arrival-rate r`` submits the wave as a seeded open-loop Poisson
trace of r requests per second (0 = all at once), ``--deadline-ms d``
gives every request a deadline past which it is shed from the queue. Every
cross-flag rule is checked at parse time.

Fleet flags: ``--replicas N`` (N > 1, or any fleet flag) serves the wave
through the multi-replica fleet (:mod:`repro_torch.serve.fleet`): the
router admits, and N in-process engines serve. ``--kill-replica-at S
--kill-replica R`` fail-stops replica R at fleet step S (the router
migrates its requests and the wave still completes; an incomplete wave
exits 1), and ``--max-replicas M --scale-up-depth D`` turns on
queue-depth autoscaling between the initial pool and M.

Across ranks: under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1)
the launcher joins the process group from the environment (NCCL on the
cards, one per rank, ``LOCAL_RANK`` selecting it; gloo with ``--device
cpu``) and every rank serves the same wave through one engine whose slot
batch splits across the ranks (``ServeEngine``'s ``serve_mesh`` path).
Every rank checks the roll-forward; rank 0 prints. The fleet flags run in
one process only. The group is left on exit.

``--ckpt-dir D`` serves the params of the latest checkpoint under D (one
written by either package's trainer) instead of the random ones.

``--blocks`` sets the kernels' launch parameters (``ServeConfig.blocks``):
'' keeps the rules, ``auto`` autotunes every protected GEMM at startup
(a sweep on the card, or a hit in the H100 seed cache; the CPU's plain
versions have none to tune, so ``auto`` needs the card), and a JSON dict
such as ``'{"bb": 2, "splits": 4}'`` sets the head GEMM's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.ft import SCOPES
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.serve.fleet import Fleet, FleetConfig, ScalingPolicy
from repro_torch.train.checkpoint import CheckpointManager

# the drain bound of a closed wave; kill schedules are checked against it
# at parse time
MAX_WAVE_STEPS = 10_000


def _say(*args) -> None:
    """Print on rank 0 only (every rank of a group computes the same)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args)


def _wave(eng: ServeEngine, n_requests: int, vocab: int, max_new: int,
          failed_group, arrival_rate: float = 0.0, deadline_ms=None) -> dict:
    """Serve the synthetic wave (8-token prompts from a seeded generator);
    returns {rid: tokens} of the requests that completed. With
    ``arrival_rate`` > 0 each request is submitted at its seeded Poisson
    arrival time on the engine's clock (the wall clock; across ranks rank
    0's, so every rank submits at the same step), the engine stepping in
    between."""
    rng = np.random.default_rng(0)
    reqs = [Request(rid=r, max_new=max_new, deadline_ms=deadline_ms,
                    prompt=rng.integers(0, vocab, size=8).astype(np.int32))
            for r in range(n_requests)]
    if not arrival_rate:
        for req in reqs:
            eng.submit(req)
        eng.run_to_completion(max_steps=MAX_WAVE_STEPS,
                              failed_group=failed_group)
    else:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate,
                                             size=n_requests))
        clock = eng.sched.clock
        t0, i, steps = clock(), 0, 0
        while i < n_requests or not eng.idle():
            now = clock() - t0
            if i < n_requests and eng.idle() and arrivals[i] > now:
                time.sleep(arrivals[i] - now)  # nothing to serve yet
                now = clock() - t0
            while i < n_requests and arrivals[i] <= now:
                eng.submit(reqs[i])
                i += 1
            eng.step(failed_group=failed_group)
            steps += 1
            if steps >= MAX_WAVE_STEPS:
                raise RuntimeError("open-loop wave failed to drain")
    shed = sum(r.status == "shed" for r in reqs)
    if shed:
        _say(f"[launch.serve] shed {shed} queued requests past "
              f"--deadline-ms {deadline_ms}")
    return {r.rid: np.asarray(r.out) for r in reqs if r.status == "done"}


def _fleet_wave(cfg, scfg: ServeConfig, params, args, failed_group,
                dev) -> None:
    """Serve the synthetic wave through the fleet, with the scheduled
    replica fail-stop if any, and print the migration summary. Every
    request must complete (or be shed past its deadline) even when a
    replica is killed mid-wave; otherwise it exits 1."""
    pol = None
    if args.max_replicas:
        pol = ScalingPolicy(min_replicas=args.replicas,
                            max_replicas=args.max_replicas,
                            scale_up_depth=args.scale_up_depth)
    fleet = Fleet(cfg, scfg, params,
                  FleetConfig(replicas=args.replicas, policy=pol, device=dev))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=r, max_new=args.max_new, deadline_ms=args.deadline_ms,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=8).astype(np.int32))
            for r in range(args.requests)]
    for req in reqs:
        fleet.submit(req)
    steps = 0
    while not fleet.idle():
        if steps == args.kill_replica_at:
            print(f"[launch.serve] killing replica {args.kill_replica} at "
                  f"fleet step {steps} (fail-stop injected)")
            fleet.kill_replica(args.kill_replica)
        fleet.step(failed_group=failed_group)
        steps += 1
        if steps >= MAX_WAVE_STEPS:
            raise RuntimeError("fleet wave failed to drain")
    m = fleet.fleet_metrics()
    states = {rid: rep["state"] for rid, rep in m["replicas"].items()}
    done = sum(r.status == "done" for r in reqs)
    print(f"[launch.serve] fleet: {done}/{args.requests} requests completed "
          f"in {steps} fleet steps over {m['spawned']} replicas (states: "
          f"{states})")
    print(f"[launch.serve] fleet migration summary: failed={m['failed']} "
          f"migrated={m['router_migrated']} "
          f"(prefix-resume={m['router_resume_prefix']}, "
          f"recompute={m['router_resume_recompute']}, "
          f"replayed={m['router_replayed']}) scale_ups={m['scale_ups']} "
          f"scale_downs={m['scale_downs']} shed={m['router_shed']}")
    if done + sum(r.status == "shed" for r in reqs) != args.requests:
        raise SystemExit(1)


def _validate_args(ap: argparse.ArgumentParser, args):
    """Fail misconfigurations at parse time; returns the bucket tuple."""
    if args.blocks not in ("", "auto"):
        try:
            blocks = json.loads(args.blocks)
        except ValueError:
            blocks = None
        if not isinstance(blocks, dict):
            ap.error(f"--blocks must be '', 'auto' or a JSON object, got "
                     f"{args.blocks!r}")
    if args.ft_mode == "entangle":
        if args.ft_M < 3:
            ap.error(f"--ft-M must be >= 3 (the paper's minimum stream "
                     f"count), got {args.ft_M}")
        if args.max_batch % args.ft_M:
            ap.error(f"--max-batch ({args.max_batch}) must be divisible by "
                     f"--ft-M ({args.ft_M}): slots map round-robin onto "
                     f"the M entangled request groups")
    if args.failed_group >= 0:
        if args.ft_mode != "entangle":
            ap.error("--failed-group requires --ft-mode entangle")
        if args.failed_group >= args.ft_M:
            ap.error(f"--failed-group must be < --ft-M ({args.ft_M})")
    if args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk must be >= 0, got {args.prefill_chunk}")
    if args.token_budget < 0:
        ap.error(f"--token-budget must be >= 0, got {args.token_budget}")
    if args.token_budget:
        # the packed program is [token-budget / prefill-chunk rows,
        # prefill-chunk tokens], each row staged in a distinct slot
        if args.prefill_chunk <= 0:
            ap.error(f"--token-budget ({args.token_budget}) requires "
                     f"--prefill-chunk > 0: packed rows are prefill-chunk "
                     f"tokens wide")
        if args.token_budget % args.prefill_chunk:
            ap.error(f"--token-budget ({args.token_budget}) must be a "
                     f"multiple of --prefill-chunk ({args.prefill_chunk}): "
                     f"the packed program has one shape")
        if args.token_budget // args.prefill_chunk > args.max_batch:
            ap.error(f"--token-budget/--prefill-chunk = "
                     f"{args.token_budget // args.prefill_chunk} packed "
                     f"rows > --max-batch ({args.max_batch}): every packed "
                     f"row stages in a distinct slot")
    buckets = None
    if args.prefill_buckets:
        try:
            buckets = tuple(int(b) for b in args.prefill_buckets.split(","))
        except ValueError:
            ap.error(f"--prefill-buckets must be comma-separated ints, got "
                     f"{args.prefill_buckets!r}")
        if any(b < 1 or b > args.max_seq for b in buckets):
            ap.error(f"--prefill-buckets {list(buckets)} must lie in "
                     f"[1, max-seq={args.max_seq}]")
    if args.arrival_rate < 0:
        ap.error(f"--arrival-rate must be >= 0 (requests/sec; 0 = closed "
                 f"wave), got {args.arrival_rate}")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be > 0, got {args.deadline_ms}")
    # -- fleet flags ---------------------------------------------------------
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.max_replicas and args.max_replicas < args.replicas:
        ap.error(f"--max-replicas ({args.max_replicas}) must be >= "
                 f"--replicas ({args.replicas}): autoscaling grows the "
                 f"pool above its initial size, never below it")
    if args.scale_up_depth < 1:
        ap.error(f"--scale-up-depth must be >= 1 (queued requests per "
                 f"healthy replica), got {args.scale_up_depth}")
    if args.kill_replica_at >= 0:
        if args.replicas < 2 and not args.max_replicas:
            ap.error("--kill-replica-at requires --replicas >= 2 or "
                     "--max-replicas autoscaling: a surviving replica must "
                     "take the migrated requests or the wave cannot drain")
        if args.kill_replica_at >= MAX_WAVE_STEPS:
            ap.error(f"--kill-replica-at ({args.kill_replica_at}) must be "
                     f"< {MAX_WAVE_STEPS}, the wave's drain bound; a later "
                     f"kill step would never fire")
        if not 0 <= args.kill_replica < args.replicas:
            ap.error(f"--kill-replica ({args.kill_replica}) must name a "
                     f"replica in the initial pool [0, {args.replicas})")
    elif args.kill_replica:
        ap.error(f"--kill-replica ({args.kill_replica}) requires "
                 f"--kill-replica-at to schedule the fail-stop")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and (
            args.replicas > 1 or args.max_replicas
            or args.kill_replica_at >= 0):
        ap.error("the fleet flags serve in one process; under torchrun "
                 "the ranks split one engine's slot batch")
    return buckets


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a synthetic request wave with the port's engine.")
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the config to this many layers (0 = all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--ft-mode", default="none", choices=["none", "entangle"])
    ap.add_argument("--ft-M", type=int, default=4)
    ap.add_argument("--ft-scope", default="head", choices=sorted(SCOPES))
    ap.add_argument("--failed-group", type=int, default=-1)
    ap.add_argument("--prefill-buckets", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="> 0: prefill in chunks of this many tokens, one "
                         "chunk per engine step before its decode")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="> 0: token-packed admission, up to this many "
                         "prompt tokens per step from every in-flight "
                         "batch in one program")
    ap.add_argument("--no-refill", action="store_true",
                    help="admit one batch at a time (no mid-flight refill)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="> 0: seeded open-loop Poisson arrivals, requests "
                         "per second (0 = the whole wave at once)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="deadline of every request; queued requests past "
                         "it are shed")
    ap.add_argument("--replicas", type=int, default=1,
                    help="> 1 (or any fleet flag): serve through the "
                         "fleet, router-owned admission over this many "
                         "in-process engine replicas")
    ap.add_argument("--kill-replica-at", type=int, default=-1,
                    help=">= 0: fail-stop a whole replica at this fleet "
                         "step; the router migrates its requests")
    ap.add_argument("--kill-replica", type=int, default=0,
                    help="the replica --kill-replica-at kills (in the "
                         "initial pool)")
    ap.add_argument("--max-replicas", type=int, default=0,
                    help="> 0: queue-depth autoscaling between --replicas "
                         "and this bound (0 = a fixed pool)")
    ap.add_argument("--scale-up-depth", type=int, default=4,
                    help="spawn a replica when the router queue exceeds "
                         "this many requests per healthy replica")
    ap.add_argument("--ckpt-dir", default="",
                    help="serve the params of the latest checkpoint under "
                         "this directory")
    ap.add_argument("--blocks", default="",
                    help="kernel launch parameters: '' (the rules), 'auto' "
                         "(autotuned at startup, on the card) or a JSON "
                         "dict for the head GEMM, e.g. '{\"bb\": 2}'")
    return ap


def parse_blocks(text: str):
    """``--blocks``'s value as ``ServeConfig.blocks``: None, "auto" or a
    dict."""
    if text in ("", "auto"):
        return text or None
    return json.loads(text)


@contextlib.contextmanager
def _process_group(device: str):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): join the group from the
    environment, NCCL on the cards (this rank's card, ``LOCAL_RANK``,
    made current first) or gloo on the CPU, and leave it on exit. With no
    ``WORLD_SIZE``, or a group already made by the caller, nothing."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        yield
        return
    cpu = torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    buckets = _validate_args(ap, args)
    with _process_group(args.device):
        _serve(ap, args, buckets)


def _serve(ap, args, buckets) -> None:
    try:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    except NotImplementedError as e:
        ap.error(str(e))
    if args.n_layers:
        first = cfg.moe.first_dense_layers if cfg.moe else 0
        if not first < args.n_layers <= cfg.n_layers:
            ap.error(f"--n-layers must lie in ({first}, {cfg.n_layers}]")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    dev = resolve_device(args.device)
    model = get_model(cfg)
    gen = torch.Generator(device=dev)
    params = model.init(gen.manual_seed(0), cfg,
                        max_seq=args.max_seq, device=dev)
    if args.ckpt_dir:
        restored, step = CheckpointManager(args.ckpt_dir).restore(
            {"params": params})
        params = restored["params"]
        _say(f"[launch.serve] restored params from step {step}")
    scfg = ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                       ft_mode=args.ft_mode, ft_M=args.ft_M,
                       ft_scope=args.ft_scope, prefill_buckets=buckets,
                       prefill_chunk=args.prefill_chunk,
                       token_budget=args.token_budget,
                       refill=not args.no_refill,
                       blocks=parse_blocks(args.blocks))
    failed = args.failed_group if args.failed_group >= 0 else None

    if (args.replicas > 1 or args.max_replicas > 0
            or args.kill_replica_at >= 0):
        _fleet_wave(cfg, scfg, params, args, failed, dev)
        return

    eng = ServeEngine(cfg, scfg, params, device=dev)
    outs = _wave(eng, args.requests, cfg.vocab_size, args.max_new, failed,
                 arrival_rate=args.arrival_rate,
                 deadline_ms=args.deadline_ms)
    first = outs[0][:8].tolist() if 0 in outs else "<request 0 not completed>"
    ranks = (f" over {eng.lay.procs} ranks (this one: slots "
             f"[{eng.slot_lo}, {eng.slot_hi}))" if eng.lay.procs > 1 else "")
    _say(f"[launch.serve] {len(outs)}/{args.requests} requests completed in "
         f"{eng.decode_calls} batched decode calls{ranks}; first output: "
         f"{first}")
    _say(f"[launch.serve] shape census: {eng.census}")
    if args.blocks == "auto":
        from repro_torch.kernels import autotune

        _say(f"[launch.serve] autotune: {autotune.stats()}; head-GEMM "
             f"winners: {eng.census.get('head_gemm')}; protected sites "
             f"warmed: {len(eng.census.get('protected', {}))}")
    del eng  # the recovery summary's engines hold their own int8 copies

    if args.smoke and args.ft_mode == "entangle":
        # per-scope recovery summary: the head scope and the configured
        # scope; for the configured scope the wave above is one side of
        # the comparison and only the other side runs, unless it was an
        # open-loop or deadline wave (then both sides run as closed waves)
        inj = failed if failed is not None else 0
        closed = not args.arrival_rate and args.deadline_ms is None
        any_mismatch = False
        for scope in dict.fromkeys(["head", args.ft_scope]):
            sc = dataclasses.replace(scfg, ft_scope=scope)

            def wave(fg):
                return _wave(ServeEngine(cfg, sc, params, device=dev),
                             args.requests, cfg.vocab_size, args.max_new, fg)

            if scope == args.ft_scope and closed:
                other = wave(inj if failed is None else None)
                healthy, injected = ((outs, other) if failed is None
                                     else (other, outs))
            else:
                healthy, injected = wave(None), wave(inj)
            mismatches = sum(not np.array_equal(healthy[r], injected[r])
                             for r in healthy)
            tokens = sum(len(v) for v in healthy.values())
            verdict = ("EXACT ROLL-FORWARD" if mismatches == 0
                       else "RECOVERY FAILED")
            _say(f"[launch.serve] recovery summary [scope={scope}]: "
                 f"failed_group={inj} injected on every step; "
                 f"{len(healthy)} requests / {tokens} tokens compared; "
                 f"mismatching requests: {mismatches} ({verdict})")
            any_mismatch |= bool(mismatches)
        if any_mismatch:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
