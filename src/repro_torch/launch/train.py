"""Training launcher of the port:
``python -m repro_torch.launch.train --arch llama3.2-1b --smoke --device cpu``

Trains the arch's config (``--smoke``: its reduced config) on the
synthetic corpus through :func:`repro_torch.train.trainer.train_loop` on
one device, ``--device`` (default ``cuda``; it raises when no GPU is
present). The flags are the reference launcher's, and as there the loop
runs under ``axis_rules(make_local_mesh())``, every rank on ``data``;
``--batch`` is the global batch, of which each rank trains its rows
(:mod:`repro_torch.train.train_step`). Under ``torchrun`` (``WORLD_SIZE``
> 1) the launcher joins the group from the environment: NCCL with one
card a rank (``LOCAL_RANK``), or gloo with ``--device cpu``::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch llama3.2-1b --smoke --device cpu

With no ``WORLD_SIZE`` and no process group yet, it makes a one-rank group
from a local store (NCCL on the card, gloo on the CPU); it ends the group
it made. The CLI exposes no codec flag: the entangled sync runs
``TrainConfig.grad_codec``'s default.
Every decoder family trains: the dense decoders, MLA + MoE
(deepseek-v2-lite-16b), Mamba-1 (falcon-mamba-7b), RG-LRU + local
attention (recurrentgemma-2b) and the vision-language text path; the
synthetic corpus has no audio frames for whisper-small.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.dist.sharding import axis_rules, mesh_shape
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import LoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--grad-sync", default="entangle",
                    choices=["spmd", "entangle", "checksum"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    dev = _rank_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        grad_sync=args.grad_sync,
        grad_accum=args.grad_accum,
        max_seq=args.seq,
    )
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch)
    loop = LoopConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir,
                      log_every=max(args.steps // 10, 1))
    with _process_group(dev):
        mesh = make_local_mesh()
        rank = f"rank {dist.get_rank()} of world {dist.get_world_size()}"
        print(f"[launch.train] {rank}: arch={cfg.name} device={dev} "
              f"mesh={mesh_shape(mesh)} grad_sync={args.grad_sync} "
              f"codec={tcfg.grad_codec} global batch={args.batch}",
              flush=True)
        with axis_rules(mesh):
            state, losses = train_loop(cfg, tcfg, dcfg, loop, device=dev)
    print(f"[launch.train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)


def _under_torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _rank_device(device: str):
    """This process's device: under ``torchrun`` with a card, the card
    ``LOCAL_RANK`` (made current), else ``device`` resolved."""
    if _under_torchrun() and torch.device(device).type == "cuda" \
            and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(device)


@contextlib.contextmanager
def _process_group(dev):
    """The default process group: the caller's if one exists; under
    ``torchrun`` the group joined from the environment (NCCL on the cards,
    gloo on the CPU); else a one-rank group from a local store. A group
    made here is ended on exit. The one-rank NCCL group is not bound to
    the card, so NCCL sets up no communicator until a collective runs,
    and a one-card loop runs none (the train step syncs with
    ``axis_name=None``)."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if _under_torchrun():
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
