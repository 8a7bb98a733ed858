"""InternVL2-2B — InternViT frontend (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
Vision frontend is a STUB per task spec: input_specs() provides precomputed
patch embeddings; the backbone transformer is fully modeled.
"""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1e6,
    vision=VisionConfig(n_patches=256),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        rope_theta=1e6,
        vision=VisionConfig(n_patches=8),
    )
