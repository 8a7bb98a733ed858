"""Time the port's serving decode step for several checkouts on one card,
in turns over the checkouts and back (0, 1, 1, 0 for two), ``--rounds``
times, each turn a process of its own.

    python3 chip_decode_ab.py DIR [DIR ...] [--scope all] [--waves 2]
                              [--rounds 2]

``DIR`` is the root of a checkout; a turn puts its ``src/`` first on the
import path, so each turn runs that checkout's ``repro_torch`` (its
kernels are built on first use, under that checkout). A turn serves
llama3.2-1b at published widths (random weights from seed 0) at
``chip_smoke.py``'s serving geometry (8 slots, M = 4, max_seq 256, ft
entangle at ``--scope``): one warm-up wave, then ``--waves`` waves of 8
requests (prompts of 8 tokens, 16 new tokens), each ``engine.step``
timed on the host's clock after a device synchronize. It also times the
host side of the protected GEMM's wrapper alone: 200 calls of
``kernels.ops.entangled_matmul`` at llama's mlp.down decode shape
(packed, fused, failed = 1) queued without a synchronize, 20 such
batches, in microseconds per call: their least (the least noise from the
host, which other work shares) and their median.

Prints one line per turn and, last, one JSON object with every turn's
figures and the card's name and power limit. Needs a CUDA device; exits 1
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

SERVE = dict(max_batch=8, ft_M=4, max_seq=256)
WAVE = dict(requests=8, prompt_len=8, max_new=16)
HOST_CALLS, HOST_BATCHES = 200, 20


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def turn(scope: str, waves: int) -> dict:
    """One checkout's figures (run inside the turn's process)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels.codec import pack_int8
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config("llama3.2-1b")
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 cfg, max_seq=SERVE["max_seq"], device=dev)
    eng = ServeEngine(cfg, ServeConfig(ft_mode="entangle", ft_scope=scope,
                                       **SERVE), params, device=dev)
    rng = np.random.default_rng(0)
    steps = []
    for w in range(waves + 1):
        for r in range(WAVE["requests"]):
            eng.submit(Request(rid=w * 100 + r, prompt=rng.integers(
                0, cfg.vocab_size, size=WAVE["prompt_len"]).astype(np.int32),
                max_new=WAVE["max_new"]))
        while not eng.idle():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if w:  # the first wave warms up
                steps.append(1e3 * (time.perf_counter() - t0))
    del eng, params
    torch.cuda.empty_cache()

    plan = make_plan(SERVE["ft_M"], 32)
    gen = torch.Generator(device=dev).manual_seed(1)
    K, N = cfg.d_ff, cfg.d_model
    c = torch.randint(-100, 100, (plan.M, 2, K), generator=gen, device=dev,
                      dtype=torch.int32)
    g = pack_int8(torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                dtype=torch.int32), axis=0)
    kw = dict(fuse_epilogue=True, failed=1, packed=True)
    ops.entangled_matmul(c, g, plan, **kw)
    torch.cuda.synchronize()
    host = []
    for _ in range(HOST_BATCHES):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            ops.entangled_matmul(c, g, plan, **kw)
        host.append(1e6 * (time.perf_counter() - t0) / HOST_CALLS)
        torch.cuda.synchronize()
    return dict(steps=len(steps), step_ms_min=min(steps),
                step_ms_median=statistics.median(steps),
                step_ms_mean=statistics.fmean(steps),
                host_us_min=min(host), host_us_median=statistics.median(host))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="roots of the checkouts")
    ap.add_argument("--scope", default="all")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--turn", action="store_true",
                    help="run one turn in this process (internal)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_ab.py: no CUDA device", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(turn(args.scope, args.waves)))
        return 0
    if not args.roots:
        ap.error("name at least one checkout")
    smi = nvidia_smi()
    out = []
    order = list(enumerate(args.roots))
    for label, root in (order + order[::-1]) * args.rounds:
        root = pathlib.Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        r = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--turn",
             "--scope", args.scope, "--waves", str(args.waves)],
            env=env, capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(r.stdout, r.stderr, sep="\n", file=sys.stderr)
            return r.returncode
        fig = json.loads(r.stdout.strip().splitlines()[-1])
        fig.update(turn=label, root=str(root))
        out.append(fig)
        print(f"[decode-ab] {label} ({root}): llama3.2-1b scope "
              f"{args.scope}, {fig['steps']} steps: min "
              f"{fig['step_ms_min']:.3f}, median {fig['step_ms_median']:.3f}, "
              f"mean {fig['step_ms_mean']:.3f} ms; wrapper host min "
              f"{fig['host_us_min']:.2f}, median {fig['host_us_median']:.2f} "
              f"us a call; {smi}", flush=True)
    print(json.dumps({"nvidia_smi": smi, "scope": args.scope,
                      "turns": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
