"""Architecture config schema (copy of :mod:`repro.configs.base`; the port
keeps its own so that it runs without the JAX package).

One frozen dataclass drives model construction, sharding rules, input specs
and the dry-run. Every assigned architecture gets a module in this package
exporting ``CONFIG`` (exact published hyperparameters) and ``smoke_config()``
(reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    gating: str = "softmax"  # softmax (v2) | sigmoid (v3)
    first_dense_layers: int = 0  # leading layers that use a dense FFN
    capacity_factor: float = 1.25  # expert buffer slack; >= n_experts/top_k
    #   makes dispatch dropless (exactness tests use that)
    dispatch: str = "grouped"  # grouped (shard-local + EP all-to-all, §Perf
    #   iteration 1) | global_sort (pre-iteration baseline)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = full-rank Q projection (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 = ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""

    lru_width: int = 0  # 0 = d_model
    d_conv: int = 4
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (Whisper). Frontend is a stub: inputs are
    precomputed frame embeddings (task spec)."""

    n_layers: int = 12
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """VLM frontend stub: inputs are precomputed patch embeddings."""

    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 = d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    local_window: int = 0  # >0: sliding-window attention (recurrentgemma)
    attn_pattern: Tuple[str, ...] = ()  # per-unit block names; () = (attn,)*
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    mtp: bool = False  # DeepSeek-V3 multi-token-prediction head
    remat: str = "none"  # none | full | dots — activation checkpointing of
    #   each scanned unit body (train memory vs recompute trade)
    norm_f32: bool = True  # True: f32-materialized normalize (faithful
    #   default); False: f32 stats but bf16 elementwise apply (§Perf lever —
    #   removes one f32 [B,T,D] round-trip per norm on memory-bound cells)
    loss_impl: str = "naive"  # naive | streamed — streamed CE scans vocab
    #   chunks, avoiding f32 [tokens, vocab] softmax buffers (§Perf lever)
    mlp_gated: Optional[bool] = None  # None = by family (rmsnorm -> gated)
    mlp_act: str = "silu"  # silu | gelu | relu2 (Nemotron squared ReLU)
    mla_absorb: bool = False  # decode-time absorbed MLA projections: score
    #   cached latents directly (O(S·r) instead of O(S·r·d_head) per head) —
    #   §Perf lever for the DeepSeek decode cells; False = paper-faithful
    #   naive up-projection

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_pattern(self) -> Sequence[tuple[Tuple[str, ...], int]]:
        """[(unit_block_names, repeats)] — homogeneous units are scanned.

        Every unit repetition is compiled ONCE (jax.lax.scan over stacked
        params), keeping HLO size O(#unit kinds), not O(#layers) — required
        to compile 61-layer configs in the dry-run.
        """
        if self.family == "ssm":
            return [(("mamba",), self.n_layers)]
        if self.family == "hybrid":
            # RecurrentGemma 1 local-attn : 2 recurrent, pattern (rg, rg, att)
            n_units, rem = divmod(self.n_layers, 3)
            pat: list[tuple[Tuple[str, ...], int]] = []
            if n_units:
                pat.append((("rglru", "rglru", "local_attn"), n_units))
            if rem:
                pat.append((tuple(["rglru"] * rem), 1))
            return pat
        if self.family == "moe":
            assert self.moe is not None
            fd = self.moe.first_dense_layers
            pat = []
            if fd:
                pat.append((("attn_dense",), fd))
            pat.append((("attn_moe",), self.n_layers - fd))
            return pat
        # dense / vlm / encdec decoder
        return [(("attn_dense",), self.n_layers)]

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state does not grow linearly with full context —
        the long_500k eligibility rule (see DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def cells_for(cfg: ModelConfig) -> Sequence[ShapeCell]:
    """Shape cells applicable to an architecture (DESIGN.md §6)."""
    cells = []
    for cell in SHAPE_CELLS:
        if cell.name == "long_500k" and not cfg.is_subquadratic:
            continue  # full-attention archs: 512k dense decode is skipped
        cells.append(cell)
    return cells
