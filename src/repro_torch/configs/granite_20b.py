"""Granite-20B-Code — llama-style architecture with MQA (kv=1).

[arXiv:2405.04324; hf] 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=1e4,
    mlp_gated=False,  # classic 4x GPT MLP (gated would be ~28B, not 20B)
    mlp_act="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,  # preserve the MQA shape
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        mlp_gated=False,
        mlp_act="gelu",
    )
