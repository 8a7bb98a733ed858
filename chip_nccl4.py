#!/usr/bin/env python3
"""Serving and global_sort MoE training across cards over NCCL, each held
against one process on one card.

    python3 chip_nccl4.py [--cards 4]        # from a checkout

Runs two workers of this script under ``torchrun --nproc-per-node CARDS``
(NCCL, one card a rank) and alone on card 0:

  * serve: llama3.2-1b at published widths, one engine whose 16 slots
    split across the ranks, the entangled head and every protected site
    (scope all), 16 requests of 8 seeded prompt tokens and 16 new ones,
    healthy and with ``failed_group=1`` on every step. Every request's
    tokens across the cards must equal one process's, and the injected
    wave the healthy one (EXACT ROLL-FORWARD) on both;
  * train: deepseek-v2-lite-16b at published widths cut to 2 of its 27
    layers (the dense first layer and one MoE layer) with MoE
    ``dispatch="global_sort"`` (each rank gathers every rank's tokens
    into one dispatch group; the gather's backward sums its gradient over
    the ranks), seq 512, global batch 8, the entangled sync on the kernel
    codec, 3 steps with block 1 fail-stopped at step 1, no checkpoint.
    Each step's loss across the cards against one process's: the first
    within LOSS_ATOL (the same params), later ones within LOOP_LOSS_ATOL,
    the train tests' tolerances (tests/test_torch_train_mesh.py).

Prints each worker's output, every check and the card's name and power
limit; exits nonzero when a check fails. ``--smoke --device cpu``
rehearses it on the CPU (smoke configs, gloo).
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
LOSS_ATOL = 1e-4
LOOP_LOSS_ATOL = 1e-3
SERVE = dict(arch="llama3.2-1b", max_batch=16, max_seq=256, requests=16,
             max_new=16)
TRAIN = dict(arch="deepseek-v2-lite-16b", layers=2, seq=512, batch=8,
             steps=3, fail_step=1)


def _config(arch: str, smoke: bool):
    from repro_torch.configs import get_config, get_smoke_config

    return get_smoke_config(arch) if smoke else get_config(arch)


def serve_worker(out: pathlib.Path, smoke: bool, device: str) -> None:
    import torch

    from repro_torch.launch import serve as ls
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, ServeEngine

    with ls._process_group(device):
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device(device)
        cfg = _config(SERVE["arch"], smoke)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = get_model(cfg).init(gen, cfg, max_seq=SERVE["max_seq"],
                                     device=dev)
        scfg = ServeConfig(max_batch=SERVE["max_batch"],
                           max_seq=SERVE["max_seq"], ft_mode="entangle",
                           ft_scope="all")
        got = {}
        for name, fg in (("healthy", None), ("injected", 1)):
            eng = ServeEngine(cfg, scfg, params, device=dev)
            outs = ls._wave(eng, SERVE["requests"], cfg.vocab_size,
                            SERVE["max_new"], fg)
            got[name] = {str(r): t.tolist() for r, t in outs.items()}
            got["slots"] = [eng.slot_lo, eng.slot_hi]
            del eng
        rank = int(os.environ.get("RANK", "0"))
        print(f"[serve] rank {rank}: slots {got['slots']}, "
              f"{len(got['healthy'])} requests", flush=True)
        if rank == 0:
            out.write_text(json.dumps(got))


def train_worker(out: pathlib.Path, smoke: bool, device: str) -> None:
    import dataclasses

    import torch.distributed as dist

    from repro_torch.data.synthetic import DataConfig
    from repro_torch.dist.sharding import axis_rules
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import LoopConfig, train_loop

    dev = lt._rank_device(device)
    cfg = _config(TRAIN["arch"], smoke)
    cfg = dataclasses.replace(cfg, n_layers=TRAIN["layers"],
                              moe=dataclasses.replace(
                                  cfg.moe, dispatch="global_sort"))
    seq = 32 if smoke else TRAIN["seq"]
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=TRAIN["steps"]),
                       grad_sync="entangle", grad_codec="kernel",
                       max_seq=seq)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      batch_size=TRAIN["batch"])
    loop = LoopConfig(total_steps=TRAIN["steps"], ckpt_dir=None, log_every=1,
                      fail_block_at_step=TRAIN["fail_step"])
    logs = []
    with lt._process_group(dev):
        rank = dist.get_rank()
        with axis_rules(make_local_mesh()):
            _, losses = train_loop(cfg, tcfg, dcfg, loop, log=logs.append,
                                   device=dev)
        print(f"[train] rank {rank} of world {dist.get_world_size()}: "
              f"losses {[float(x) for x in losses]}", flush=True)
        if rank == 0:
            out.write_text(json.dumps(dict(
                losses=[float(x) for x in losses], log=logs)))


def _run(role: str, cards: int, args, tmp: pathlib.Path) -> dict:
    """``role``'s worker under torchrun on ``cards`` ranks (1: alone);
    returns what rank 0 wrote."""
    out = tmp / f"{role}_{cards}.json"
    me = [str(ROOT / "chip_nccl4.py"), "--worker", role, "--out", str(out),
          "--device", args.device] + (["--smoke"] if args.smoke else [])
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(cards)] if cards > 1
           else [sys.executable]) + me
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=1200)
    print(proc.stdout[-6000:], flush=True)
    if proc.returncode:
        raise SystemExit(f"{role} on {cards} exited {proc.returncode}")
    return json.loads(out.read_text())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--worker", choices=("serve", "train"), default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.worker:
        fn = serve_worker if args.worker == "serve" else train_worker
        fn(pathlib.Path(args.out), args.smoke, args.device)
        return 0
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    fails = []
    with tempfile.TemporaryDirectory(prefix="chip_nccl4_") as d:
        tmp = pathlib.Path(d)
        many, one = (_run("serve", n, args, tmp) for n in (args.cards, 1))
        for name, got in ((f"{args.cards} ranks", many), ("one process", one)):
            bad = sum(got["healthy"][r] != got["injected"].get(r)
                      for r in got["healthy"])
            verdict = "EXACT ROLL-FORWARD" if not bad else "RECOVERY FAILED"
            print(f"[serve] {name}: failed_group=1 on every step, "
                  f"{len(got['healthy'])} requests compared, mismatching "
                  f"{bad} ({verdict})", flush=True)
            if bad or len(got["healthy"]) != SERVE["requests"]:
                fails.append(f"serve {name}: {bad} requests parted")
        differ = sorted({r for k in ("healthy", "injected") for r in one[k]
                         if many[k].get(r) != one[k][r]})
        print(f"[serve] {args.cards} ranks against one process: requests "
              f"whose tokens differ {differ} of {len(one['healthy'])}",
              flush=True)
        if differ:
            fails.append(f"serve: requests {differ} differ")
        many, one = (_run("train", n, args, tmp) for n in (args.cards, 1))
        for i, (a, b) in enumerate(zip(many["losses"], one["losses"])):
            tol = LOSS_ATOL if i == 0 else LOOP_LOSS_ATOL
            ok = abs(a - b) < tol
            print(f"[train] global_sort step {i}: loss {a:.6f} on "
                  f"{args.cards} ranks, {b:.6f} in one process, |d| "
                  f"{abs(a - b):.2e} (< {tol}) -> "
                  f"{'ok' if ok else 'OUT OF TOLERANCE'}", flush=True)
            if not ok:
                fails.append(f"train step {i}")
        if len(many["losses"]) != TRAIN["steps"]:
            fails.append(f"train: {len(many['losses'])} steps")
    print(f"[chip_nccl4] "
          f"{'ok' if not fails else 'FAILED: ' + '; '.join(fails)}",
          flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
