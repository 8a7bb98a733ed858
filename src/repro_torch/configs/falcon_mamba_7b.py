"""Falcon-Mamba-7B — attention-free Mamba-1 SSM.

[arXiv:2410.05355; unverified] 64L d_model=4096 vocab=65024 ssm_state=16,
d_conv=4, expand=2 (d_inner=8192).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # attn-free
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=256,
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    )
