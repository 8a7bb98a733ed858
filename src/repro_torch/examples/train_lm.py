"""End-to-end driver (counterpart of ``examples/train_lm.py``): train a
~100M llama-style model on the synthetic corpus with the paper's technique
protecting the gradient path (the entangled int32 gradient sync),
checkpointing, and a fail-stopped block injected mid-run.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
        [--small] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import LoopConfig, train_loop
from repro_torch.tree import leaves


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m", family="dense", n_layers=8, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000, head_dim=64,
        rope_theta=5e5, tie_embeddings=True,
    )


def model_small() -> ModelConfig:
    return ModelConfig(
        name="llama-8m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=4096, head_dim=64,
        tie_embeddings=True,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="8M params (CPU-friendly smoke)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_small() if args.small else model_100m()
    seq = args.seq or (128 if args.small else 512)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        grad_sync="entangle",  # the paper's technique on the gradient path
        ft_M=4,
        max_seq=seq,
    )
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      batch_size=4 if args.small else 8)
    loop = LoopConfig(
        total_steps=args.steps,
        ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir,
        log_every=max(args.steps // 20, 1),
        fail_block_at_step=args.steps // 2,  # fail-stop drill mid-training
    )
    print(f"[train_lm] {cfg.name}: seq={seq}, grad_sync=entangle(M="
          f"{tcfg.ft_M}), fail-stop injected at step "
          f"{loop.fail_block_at_step}, device {dev}")
    state, losses = train_loop(cfg, tcfg, dcfg, loop, device=dev)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    print(f"[train_lm] {n_params / 1e6:.1f}M params: loss {losses[0]:.3f} "
          f"-> {losses[-1]:.3f} over {len(losses)} steps (fail-stop step "
          f"caused no disruption)")
    assert losses[-1] < losses[0], "model did not learn"
    return losses


if __name__ == "__main__":
    main()
