"""Whisper-small — encoder-decoder; conv frontend is a STUB (task spec):
input_specs() provides precomputed frame embeddings [B, 1500, d_model].

[arXiv:2212.04356; unverified] 12L (x2 enc/dec) d_model=768 12H d_ff=3072
vocab=51865, LayerNorm, learned positions (no RoPE).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,  # decoder layers; encoder in EncoderConfig
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    norm_kind="layernorm",
    norm_eps=1e-5,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        family="encdec",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        norm_kind="layernorm",
        norm_eps=1e-5,
        encoder=EncoderConfig(n_layers=2, n_frames=16),
    )
