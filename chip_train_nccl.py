#!/usr/bin/env python3
"""Training across cards over NCCL against one process on one card.

    python3 chip_train_nccl.py [--cards 4] [--steps 4]   # from a checkout

Runs the port's train launcher twice from the root of the checkout, with
the same flags (llama3.2-1b at published widths, seq 512, global batch 8,
the entangled gradient sync): under ``torchrun --nproc-per-node CARDS``
(NCCL, one card a rank: each rank trains its rows of the global batch and
the ranks sum their gradients with NCCL's float ``all_reduce``), then in
one process on card 0. Prints both logs, every rank's losses, and each
step's loss against the one process's: the first within LOSS_ATOL (the
same params; printed to 4 decimals, so half a unit of the last place is
added), later ones within LOOP_LOSS_ATOL (the two runs part by the
rounding of each step's gradient sum), the train tests' tolerances
(tests/test_torch_train_mesh.py). Exits nonzero when a check fails.
Checkpoints go to temporary directories, deleted after each run.
"""
import argparse
import collections
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
LOSS_ATOL = 1e-4
LOOP_LOSS_ATOL = 1e-3
PRINTED = 5e-5  # half a unit of the log's 4th decimal
STEP = re.compile(r"^\[trainer\] step (\d+) loss=([0-9.]+) gnorm=([0-9.]+)")


def run(cmd: list, env: dict, args: list) -> list:
    """Run ``cmd`` with the launcher's ``args`` in a fresh checkpoint
    directory; ``{logs}`` in ``cmd`` names a directory for torchrun's
    per-rank output files (so that the ranks' lines cannot interleave).
    Returns every process's output."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_train_nccl_"))
    cmd = [c.format(logs=tmp / "logs") for c in cmd]
    try:
        proc = subprocess.run(
            cmd + args + ["--ckpt-dir", str(tmp / "ckpt")], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=1500)
        outs = [proc.stdout] + [f.read_text() for f in sorted(
            (tmp / "logs").rglob("stdout.log"))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for out in outs:
        print(out, flush=True)
    if proc.returncode:
        raise SystemExit(f"{cmd[:4]} exited {proc.returncode}")
    return outs


def steps(outs: list) -> dict:
    """{step: [(loss, gnorm) of every process that logged it]}."""
    got = collections.defaultdict(list)
    for out in outs:
        for line in out.splitlines():
            m = STEP.match(line)
            if m:
                got[int(m[1])].append((float(m[2]), float(m[3])))
    return dict(got)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    flags = ["--arch", "llama3.2-1b", "--seq", "512", "--batch", "8",
             "--steps", str(args.steps)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout, flush=True)
    many = steps(run([sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc-per-node", str(args.cards),
                      "--redirects", "3", "--log-dir", "{logs}",
                      "-m", "repro_torch.launch.train"], env, flags))
    one = steps(run([sys.executable, "-m", "repro_torch.launch.train"],
                    dict(env, CUDA_VISIBLE_DEVICES="0"), flags))
    fails = []
    for s in range(1, args.steps + 1):
        ranks, (want, _) = many.get(s, []), one[s][0]
        tol = (LOSS_ATOL if s == 1 else LOOP_LOSS_ATOL) + PRINTED
        worst = max((abs(loss - want) for loss, _ in ranks),
                    default=float("inf"))
        same = len(set(ranks)) == 1
        ok = len(ranks) == args.cards and same and worst <= tol
        print(f"[train-nccl] step {s}: {len(ranks)} ranks' loss, grad norm "
              f"{sorted(set(ranks))} ({'equal' if same else 'DIFFER'}); "
              f"one process {one[s][0]}; |dloss| {worst:.4f} (<= {tol:.5f})"
              f" -> {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fails.append(s)
    print(f"[train-nccl] {args.cards} cards over NCCL against one card: "
          f"{'every step within tolerance' if not fails else f'steps {fails} failed'}",
          flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
