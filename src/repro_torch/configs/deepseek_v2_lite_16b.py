"""DeepSeek-V2-Lite (16B total / 2.4B active) — MLA + MoE.

[arXiv:2405.04434; hf] 27L d_model=2048 16H d_ff_expert=1408 vocab=102400,
MLA kv_lora=512 (no q-lora), 2 shared + 64 routed experts top-6, first layer
dense (d_ff=10944), softmax gating.

Note: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed"; 160
routed is full V2 — the V2-LITE checkpoint has 64 routed experts, which the
"64e top-6" prefix (and HF config) confirms, so 64 is used.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # dense first layer
    vocab_size=102400,
    rope_theta=1e4,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_ff_expert=1408,
        gating="softmax",
        first_dense_layers=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab_size=256,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            n_shared=1,
            d_ff_expert=32,
            gating="softmax",
            first_dense_layers=1,
        ),
        mla=MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=0,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
    )
