"""Model building blocks of the dense decoder, in PyTorch (port of the
dense part of :mod:`repro.models.layers`).

Conventions, as in the reference:
  * params are nested dicts of tensors (float32 masters; matmuls run in
    bfloat16, :data:`ACT_DTYPE`);
  * ``mode`` is ``prefill`` or ``decode``; decode processes T=1 tokens
    against a KV cache with a per-row position vector ``pos`` [B];
  * :func:`dense` / :func:`dense_fanout` are the protected-GEMM
    chokepoints: with an :class:`~repro_torch.ft.FTContext` whose scope
    covers the site, the projection runs as the fused entangled int8 GEMM.

Unlike the reference, caches are updated IN PLACE (the functions receive
per-layer views of the engine's stacked cache tensors and write into
them), which saves a copy of the largest buffer per step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

ACT_DTYPE = torch.bfloat16


def he_init(gen: torch.Generator, shape: tuple, fan_in: int) -> torch.Tensor:
    """float32 normal(0, 1/fan_in) weights on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * (
        1.0 / math.sqrt(fan_in))


# ----------------------------------------------------------------- norms ----

def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm in float32 (the llama family's norm)."""
    if cfg.norm_kind != "rmsnorm" or not cfg.norm_f32:
        raise NotImplementedError(f"norm {cfg.norm_kind!r} (norm_f32="
                                  f"{cfg.norm_f32}) is not ported yet")
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), -1, keepdim=True)
    return (x32 * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]).to(ACT_DTYPE)


# ------------------------------------------------------------------ rope ----

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX-style rotary embedding. x: [B, T, H, hd], positions: [B, T]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [B, T, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- dense ----

def _dense_w(p):
    """The startup pre-quantized (wq, scale) pair when installed, else the
    float master."""
    return (p["q8"]["w"], p["q8"]["scale"]) if "q8" in p else p["w"]


def dense(p, x: torch.Tensor, *, ft=None, site: Optional[str] = None):
    """Dense projection — THE protected-GEMM chokepoint: with ``ft``
    covering ``site`` it runs as the fused entangled int8 GEMM, otherwise
    as a bfloat16 matmul (biases are not ported yet)."""
    if ft is not None and site is not None and ft.protects(site):
        return ft.matmul(site, x, _dense_w(p)).to(ACT_DTYPE)
    return torch.matmul(x.to(ACT_DTYPE), p["w"].to(ACT_DTYPE))


def dense_fanout(ps, x: torch.Tensor, *, ft, sites) -> list:
    """Fanout form of :func:`dense` for sites that project the SAME
    activations (attention Q/K/V, MLP gate/up): when all are protected,
    one quantize/permute pass feeds every member's kernel call."""
    if ft is None or not all(ft.protects(s) for s in sites):
        return [dense(p, x, ft=ft, site=s) for p, s in zip(ps, sites)]
    ys = ft.matmul_fanout(tuple(sites), x, tuple(_dense_w(p) for p in ps))
    return [y.to(ACT_DTYPE) for y in ys]


# ---------------------------------------------------------- GQA attention ----

def init_attention(gen, cfg: ModelConfig, repeat: int) -> dict:
    hd, D = cfg.resolved_head_dim, cfg.d_model
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported yet")
    return {
        "norm": {"scale": torch.ones((repeat, D), device=gen.device)},
        "wq": {"w": he_init(gen, (repeat, D, cfg.n_heads * hd), D)},
        "wk": {"w": he_init(gen, (repeat, D, cfg.n_kv_heads * hd), D)},
        "wv": {"w": he_init(gen, (repeat, D, cfg.n_kv_heads * hd), D)},
        "wo": {"w": he_init(gen, (repeat, cfg.n_heads * hd, D),
                            cfg.n_heads * hd)},
    }


def init_attn_cache(cfg: ModelConfig, repeat: int, batch: int, max_seq: int,
                    device) -> dict:
    shape = (repeat, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device)}


def apply_attention(p, x: torch.Tensor, *, cfg: ModelConfig, cache: dict,
                    pos, mode: str, rope_theta: Optional[float] = None,
                    ft=None):
    """GQA attention against the KV cache, writing it in place.

    ``prefill``: ``pos`` is the chunk offset (int) of tokens [B, T]; keys
    and values of all T positions land at ``pos..pos+T-1`` (bucket padding
    included, as in the reference), and the queries attend causally to
    every cached position before them. ``decode``: ``pos`` is the per-row
    position vector [B] of the one new token.
    """
    from repro_torch.models.attention_core import attend, attend_decode

    B, T, _ = x.shape
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = apply_norm(p["norm"], x, cfg)
    q, k, v = dense_fanout((p["wq"], p["wk"], p["wv"]), h, ft=ft,
                           sites=("qkv.q", "qkv.k", "qkv.v"))
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, Hkv, hd)
    v = v.reshape(B, T, Hkv, hd)
    if mode == "decode":
        positions = pos.to(torch.int64)[:, None].expand(B, T)
    elif mode == "prefill":
        off = int(pos or 0)
        positions = (torch.arange(T, device=x.device) + off)[None].expand(B, T)
    else:
        raise NotImplementedError(f"attention mode {mode!r} is not ported yet")
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if mode == "decode":
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, positions[:, 0]] = k[:, 0]
        cache["v"][rows, positions[:, 0]] = v[:, 0]
        k_all, v_all = cache["k"], cache["v"]
    else:
        cache["k"][:, off:off + T] = k
        cache["v"][:, off:off + T] = v
        k_all = cache["k"][:, :off + T] if off else k
        v_all = cache["v"][:, :off + T] if off else v

    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    kt = k_all.permute(0, 2, 1, 3)
    vt = v_all.permute(0, 2, 1, 3)
    if mode == "decode":
        S = k_all.shape[1]
        slot = torch.arange(S, device=x.device)[None, :]
        abs_pos = torch.where(slot <= positions[:, :1], slot, -1)  # [B, S]
        o = attend_decode(qg, kt, vt, abs_pos=abs_pos)
    else:
        o = attend(qg, kt, vt, kind="causal", q_off=off)
    out = o.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd)
    return dense(p["wo"], out.to(ACT_DTYPE), ft=ft, site="out.o"), cache


# ------------------------------------------------------------------- MLP ----

def init_mlp(gen, cfg: ModelConfig, repeat: int) -> dict:
    if cfg.mlp_gated is False or cfg.norm_kind != "rmsnorm":
        raise NotImplementedError("only the gated MLP is ported yet")
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "norm": {"scale": torch.ones((repeat, D), device=gen.device)},
        "gate": {"w": he_init(gen, (repeat, D, Fd), D)},
        "up": {"w": he_init(gen, (repeat, D, Fd), D)},
        "down": {"w": he_init(gen, (repeat, Fd, D), Fd)},
    }


def silu(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference evaluates it on bfloat16:
    ``a * (1 / (1 + exp(-a)))`` rounded to the working dtype after every
    op. (``F.silu`` rounds once, which moves about a third of the bf16
    outputs by one ulp against the reference.)"""
    return a * torch.reciprocal(torch.exp(-a) + 1)


def _mlp_act(cfg: ModelConfig, a: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act != "silu":
        raise NotImplementedError(f"mlp_act {cfg.mlp_act!r} is not ported yet")
    return silu(a)


def apply_mlp(p, x: torch.Tensor, *, cfg: ModelConfig, ft=None):
    """Gated MLP: down(act(gate(h)) * up(h)) with gate/up one fanout group."""
    h = apply_norm(p["norm"], x, cfg)
    gate, up = dense_fanout((p["gate"], p["up"]), h, ft=ft,
                            sites=("mlp.gate", "mlp.up"))
    return dense(p["down"], _mlp_act(cfg, gate) * up, ft=ft, site="mlp.down")
