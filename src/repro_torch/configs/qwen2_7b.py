"""Qwen2-7B — GQA with QKV bias.

[arXiv:2407.10671; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        qkv_bias=True,
    )
