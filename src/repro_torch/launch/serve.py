"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch llama3.2-1b --smoke``

Boots the batched serving engine with random weights (from a seeded
``torch.Generator``) on ``--device`` (default ``cuda``) and runs a
synthetic request wave. The ported archs are llama3.2-1b (dense) and
deepseek-v2-lite-16b (MLA + MoE); ``--n-layers`` cuts the depth of the
published config (deepseek-v2-lite's 27 layers of float32 masters alone
take about 63 GB). ``--ft-mode entangle`` runs the vocab projection
of every decode step and admission batch as the fused entangled int8 GEMM
(slot -> group = slot % ft_M); ``--ft-scope`` widens protection to the
in-model projections; ``--failed-group r`` fail-stops group r on every
step. With ``--smoke`` and entanglement on, the launcher prints a
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

Flags of the reference's launcher that belong to later slices of the port
(fleet, autotuned blocks, checkpoints) are rejected at parse time with
"not ported yet".
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.ft import SCOPES
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

MAX_WAVE_STEPS = 10_000

# flag -> its "off" value; any other value is a later slice's feature
_NOT_PORTED = {
    "replicas": 1, "kill_replica_at": -1, "kill_replica": 0,
    "max_replicas": 0, "scale_up_depth": 4, "blocks": "", "ckpt_dir": "",
}


def _wave(eng: ServeEngine, n_requests: int, vocab: int, max_new: int,
          failed_group, arrival_rate: float = 0.0, deadline_ms=None) -> dict:
    """Serve the synthetic wave (8-token prompts from a seeded generator);
    returns {rid: tokens} of the requests that completed. With
    ``arrival_rate`` > 0 each request is submitted at its seeded Poisson
    arrival time (wall clock), the engine stepping in between."""
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
        t0, i, steps = time.monotonic(), 0, 0
        while i < n_requests or not eng.idle():
            now = time.monotonic() - t0
            if i < n_requests and eng.idle() and arrivals[i] > now:
                time.sleep(arrivals[i] - now)  # nothing to serve yet
                now = time.monotonic() - t0
            while i < n_requests and arrivals[i] <= now:
                eng.submit(reqs[i])
                i += 1
            eng.step(failed_group=failed_group)
            steps += 1
            if steps >= MAX_WAVE_STEPS:
                raise RuntimeError("open-loop wave failed to drain")
    shed = sum(r.status == "shed" for r in reqs)
    if shed:
        print(f"[launch.serve] shed {shed} queued requests past "
              f"--deadline-ms {deadline_ms}")
    return {r.rid: np.asarray(r.out) for r in reqs if r.status == "done"}


def _validate_args(ap: argparse.ArgumentParser, args):
    """Fail misconfigurations at parse time; returns the bucket tuple."""
    for flag, off in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            ap.error(f"--{flag.replace('_', '-')} is not ported yet")
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
    # later slices' flags: accepted by the parser so that using one gives
    # a clear "not ported yet" error
    ap.add_argument("--ckpt-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--blocks", default="", help=argparse.SUPPRESS)
    ap.add_argument("--replicas", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--kill-replica-at", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--kill-replica", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--max-replicas", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--scale-up-depth", type=int, default=4,
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    buckets = _validate_args(ap, args)
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
    scfg = ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                       ft_mode=args.ft_mode, ft_M=args.ft_M,
                       ft_scope=args.ft_scope, prefill_buckets=buckets,
                       prefill_chunk=args.prefill_chunk,
                       token_budget=args.token_budget,
                       refill=not args.no_refill)
    failed = args.failed_group if args.failed_group >= 0 else None

    eng = ServeEngine(cfg, scfg, params, device=dev)
    outs = _wave(eng, args.requests, cfg.vocab_size, args.max_new, failed,
                 arrival_rate=args.arrival_rate,
                 deadline_ms=args.deadline_ms)
    first = outs[0][:8].tolist() if 0 in outs else "<request 0 not completed>"
    print(f"[launch.serve] {len(outs)}/{args.requests} requests completed in "
          f"{eng.decode_calls} batched decode calls; first output: {first}")
    print(f"[launch.serve] shape census: {eng.census}")
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
            print(f"[launch.serve] recovery summary [scope={scope}]: "
                  f"failed_group={inj} injected on every step; "
                  f"{len(healthy)} requests / {tokens} tokens compared; "
                  f"mismatching requests: {mismatches} ({verdict})")
            any_mismatch |= bool(mismatches)
        if any_mismatch:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
