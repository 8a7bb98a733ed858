"""RecurrentGemma-2B — RG-LRU recurrent blocks + local attention, 1:2 ratio.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000,
local attention window 2048, head_dim=256, pattern (rglru, rglru, local_attn).
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    local_window=2048,
    rope_theta=1e4,
    tie_embeddings=True,  # Gemma family ties embed/head (2.7B, not 3.6B)
    rglru=RGLRUConfig(lru_width=2560, d_conv=4, c=8.0),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=3,  # one full (rglru, rglru, local_attn) unit
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        head_dim=32,
        local_window=16,
        tie_embeddings=True,
        rglru=RGLRUConfig(lru_width=64, d_conv=4, c=8.0),
    )
