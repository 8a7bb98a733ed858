"""Training launcher of the port:
``python -m repro_torch.launch.train --arch llama3.2-1b --smoke --device cpu``

Trains the arch's config (``--smoke``: its reduced config) on the
synthetic corpus through :func:`repro_torch.train.trainer.train_loop` on
one device, ``--device`` (default ``cuda``; it raises when no GPU is
present). The flags are the reference launcher's; there is no mesh, since
the port runs on one device. As in the reference, the CLI exposes no codec
flag: the entangled sync runs ``TrainConfig.grad_codec``'s default.
Training is ported for the dense decoder (llama3.2-1b); other archs raise
"not ported yet".
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.synthetic import DataConfig
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

    dev = resolve_device(args.device)
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
    print(f"[launch.train] arch={cfg.name} device={dev} "
          f"grad_sync={args.grad_sync} codec={tcfg.grad_codec}")
    state, losses = train_loop(cfg, tcfg, dcfg, loop, device=dev)
    print(f"[launch.train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
