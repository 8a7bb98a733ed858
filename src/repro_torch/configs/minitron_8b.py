"""Minitron-8B — width-pruned Nemotron-4.

[arXiv:2407.14679; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    rope_theta=1e4,
    mlp_gated=False,  # Nemotron squared-ReLU MLP (gated would be ~9.9B)
    mlp_act="relu2",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        mlp_gated=False,
        mlp_act="relu2",
    )
