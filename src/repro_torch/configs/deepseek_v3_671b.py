"""DeepSeek-V3 (671B total / 37B active) — MLA + MoE + MTP.

[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff_expert=2048 vocab=129280,
MLA kv_lora=512 q_lora=1536, 1 shared + 256 routed experts top-8, first 3
layers dense (d_ff=18432), sigmoid gating, multi-token-prediction module.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense first layers
    vocab_size=129280,
    rope_theta=1e4,
    mtp=True,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        gating="sigmoid",
        first_dense_layers=3,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab_size=256,
        mtp=True,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            n_shared=1,
            d_ff_expert=32,
            gating="sigmoid",
            first_dense_layers=1,
        ),
        mla=MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=48,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
    )
