"""Model building blocks of the ported decoders, in PyTorch (port of the
dense-decoder, MLA and MoE parts of :mod:`repro.models.layers`).

Conventions, as in the reference:
  * params are nested dicts of tensors (float32 masters; matmuls run in
    bfloat16, :data:`ACT_DTYPE`);
  * ``mode`` is ``prefill``, ``decode`` or ``train``; decode processes
    T=1 tokens against a KV cache with a per-row position vector ``pos``
    [B]; train runs a whole sequence with no cache (dense decoder only);
  * :func:`dense` / :func:`dense_fanout` are the protected-GEMM
    chokepoints: with an :class:`~repro_torch.ft.FTContext` whose scope
    covers the site, the projection runs as the fused entangled int8 GEMM;
    the MoE expert GEMMs go through ``FTContext.matmul_grouped`` (the
    grouped kernel) the same way.

Unlike the reference, caches are updated IN PLACE (the functions receive
per-layer views of the engine's stacked cache tensors and write into
them), which saves a copy of the largest buffer per step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

ACT_DTYPE = torch.bfloat16
# the card's unprotected bf16 GEMMs take their rows in multiples of this
# (zero rows appended, their outputs dropped): for fewer rows cuBLAS may
# split a deep contraction (it does at K = 8192 for 128 rows or fewer),
# so a row's bits would depend on how many rows share the call, and a
# token's on how its prompt was chunked or packed; at 256, 512 and 2048
# rows every row of llama3.2-1b's projections gets the same bits (on the
# H100; tests/test_torch_cuda.py holds it)
GEMM_ROWS = 256
# largest T * S of the reference's materialized attention (FLASH_THRESHOLD
# 2048: T * S <= 2048**2 / 4); train mode beyond it needs the flash path
TRAIN_SCORES_MAX = 2048 * 2048 // 4


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
    return _bf16_matmul(x, p["w"])


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in bfloat16; on the card with the rows padded to a
    multiple of :data:`GEMM_ROWS`, so that each row's result does not
    depend on the other rows of the call."""
    x, w = x.to(ACT_DTYPE), w.to(ACT_DTYPE)
    K = x.shape[-1]
    R = x.numel() // K
    pad = (-R) % GEMM_ROWS if x.is_cuda else 0
    if not pad:
        return torch.matmul(x, w)
    y = torch.matmul(F.pad(x.reshape(R, K), (0, 0, 0, pad)), w)
    return y[:R].reshape(*x.shape[:-1], w.shape[-1])


def dense_fanout(ps, x: torch.Tensor, *, ft, sites) -> list:
    """Fanout form of :func:`dense` for sites that project the SAME
    activations (attention Q/K/V, MLP gate/up): when all are protected,
    one quantize/permute pass feeds every member's kernel call."""
    if ft is None or not all(ft.protects(s) for s in sites):
        return [dense(p, x, ft=ft, site=s) for p, s in zip(ps, sites)]
    ys = ft.matmul_fanout(tuple(sites), x, tuple(_dense_w(p) for p in ps))
    return [y.to(ACT_DTYPE) for y in ys]


# ------------------------------------------------------ positions / masks ----

def is_pos_vector(pos) -> bool:
    """True when ``pos`` is a per-row vector [B] (decode positions, or the
    row offsets of a token-packed prefill) rather than one shared int."""
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def prefill_off(pos):
    """Offset of a prefill call: an int shared by every row (bucketed,
    chunked prefill; None = 0), or a per-row offset vector [B] (token-
    packed prefill, every row a different request)."""
    return pos.to(torch.int64) if is_pos_vector(pos) else int(pos or 0)


def _positions(pos, mode: str, B: int, T: int, device) -> tuple:
    """``([B, T] absolute positions, prefill offset)`` of a step: decode
    takes the per-row position vector ``pos`` [B] (T == 1); prefill the
    chunk offset ``pos``, an int shared by every row or a per-row vector
    [B] (:func:`prefill_off`); train the whole sequence from position 0."""
    if mode == "decode":
        return pos.to(torch.int64)[:, None].expand(B, T), 0
    if mode not in ("prefill", "train"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported yet")
    off = prefill_off(pos)
    t = torch.arange(T, device=device)
    if is_pos_vector(off):
        return off[:, None] + t[None], off
    return (t + off)[None].expand(B, T), off


def _decode_abs_pos(S: int, positions: torch.Tensor) -> torch.Tensor:
    """[B, S] absolute position of each linear-cache slot at decode, -1
    past the row's position (slot s holds position s)."""
    slot = torch.arange(S, device=positions.device)[None, :]
    return torch.where(slot <= positions[:, :1], slot, -1)


def _write_rows(buf: torch.Tensor, new: torch.Tensor,
                qpos: torch.Tensor) -> None:
    """Write each row's chunk ``new`` [B, T, ...] into its cache row ``buf``
    [B, S, ...] at absolute positions ``qpos`` [B, T] (consecutive per
    row), in place. Positions past S are dropped, as the reference's
    scatter drops them; every slot is selected from the old content or
    the chunk, so no two writes meet."""
    S, T = buf.shape[1], new.shape[1]
    j = torch.arange(S, device=buf.device)[None, :] - qpos[:, :1]  # [B, S]
    sel = (j >= 0) & (j < T)
    idx = j.clamp(0, T - 1)
    idx = idx.reshape(idx.shape + (1,) * (new.dim() - 2)).expand(
        (-1, -1) + new.shape[2:])
    sel = sel.reshape(sel.shape + (1,) * (new.dim() - 2))
    buf.copy_(torch.where(sel, torch.gather(new, 1, idx), buf))


def _prefill_valid(off, T: int, lengths) -> Optional[torch.Tensor]:
    """[B, T] mask of the REAL positions of a bucketed prefill chunk:
    position off+t belongs to row b iff off+t < lengths_b. ``off`` is an
    int shared by every row or a per-row vector [B] (token-packed
    prefill). None when ``lengths`` is None (the whole batch is real)."""
    if lengths is None:
        return None
    t = torch.arange(T, device=lengths.device)
    g = off[:, None] + t[None] if is_pos_vector(off) else (off + t)[None, :]
    return g < lengths.to(torch.int64)[:, None]


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
    every cached position before them. Token-packed prefill: ``pos`` is a
    per-row offset vector [B] (each row a different request); each row's
    keys land at its own offset and its queries attend over the full
    cache under a per-row causal mask (:func:`attend_prefill_packed`; the
    masked keys add exact zeros). ``decode``: ``pos`` is the per-row
    position vector [B] of the one new token. ``train``: no cache (it must
    be None, so that nothing is written in place under autograd); the
    sequence attends causally to itself, through the materialized-score
    path, which the reference takes while ``T * T <= 2048**2 / 4`` (its
    flash path beyond that is not ported yet).
    """
    from repro_torch.models.attention_core import (attend, attend_decode,
                                                   attend_prefill_packed)

    B, T, _ = x.shape
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = apply_norm(p["norm"], x, cfg)
    q, k, v = dense_fanout((p["wq"], p["wk"], p["wv"]), h, ft=ft,
                           sites=("qkv.q", "qkv.k", "qkv.v"))
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, Hkv, hd)
    v = v.reshape(B, T, Hkv, hd)
    positions, off = _positions(pos, mode, B, T, x.device)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if mode == "train":
        if cache is not None:
            raise ValueError("train mode takes no cache")
        if T * T > TRAIN_SCORES_MAX:
            raise NotImplementedError(
                f"train attention over T={T} needs the reference's flash "
                f"path, which is not ported yet (T*T <= {TRAIN_SCORES_MAX})")
        k_all, v_all = k, v
    elif mode == "decode":
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, positions[:, 0]] = k[:, 0]
        cache["v"][rows, positions[:, 0]] = v[:, 0]
        k_all, v_all = cache["k"], cache["v"]
    elif is_pos_vector(off):
        _write_rows(cache["k"], k, positions)
        _write_rows(cache["v"], v, positions)
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
        o = attend_decode(qg, kt, vt,
                          abs_pos=_decode_abs_pos(k_all.shape[1], positions))
    elif is_pos_vector(off):
        o = attend_prefill_packed(qg, kt, vt, qpos=positions)
    else:
        o = attend(qg, kt, vt, kind="causal", q_off=off)
    out = o.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd)
    return dense(p["wo"], out.to(ACT_DTYPE), ft=ft, site="out.o"), cache


# ---------------------------------------------------------- MLA attention ----

def init_mla(gen, cfg: ModelConfig, repeat: int) -> dict:
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    if m.q_lora_rank:
        raise NotImplementedError(
            "MLA with q_lora_rank > 0 (deepseek-v3) is not ported yet")
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    return {
        "norm": {"scale": torch.ones((repeat, D), device=gen.device)},
        "wkv_a": {"w": he_init(gen, (repeat, D, r + m.qk_rope_head_dim), D)},
        "kv_norm": {"scale": torch.ones((repeat, r), device=gen.device)},
        "wkv_b": {"w": he_init(
            gen, (repeat, r, H * (m.qk_nope_head_dim + m.v_head_dim)), r)},
        "wo": {"w": he_init(gen, (repeat, H * m.v_head_dim, D),
                            H * m.v_head_dim)},
        "wq": {"w": he_init(gen, (repeat, D, H * qk_dim), D)},
    }


def init_mla_cache(cfg: ModelConfig, repeat: int, batch: int, max_seq: int,
                   device) -> dict:
    """The compressed latent c_kv and the shared roped key, per position."""
    m = cfg.mla
    return {"ckv": torch.zeros((repeat, batch, max_seq, m.kv_lora_rank),
                               dtype=ACT_DTYPE, device=device),
            "krope": torch.zeros((repeat, batch, max_seq,
                                  m.qk_rope_head_dim),
                                 dtype=ACT_DTYPE, device=device)}


def apply_mla(p, x: torch.Tensor, *, cfg: ModelConfig, cache: dict, pos,
              mode: str, ft=None):
    """Multi-head latent attention (DeepSeek), the reference's
    non-absorbed path: the cache holds only the normed latent c_kv [B, S,
    r] and the shared roped key [B, S, dr], written in place, and every
    step up-projects the cached latents to per-head keys and values
    (``wkv_b``, an unprotected projection). ``pos`` and ``mode`` as in
    :func:`apply_attention`, the per-row prefill offsets included."""
    from repro_torch.models.attention_core import (attend, attend_decode,
                                                   attend_prefill_packed)

    m = cfg.mla
    if mode == "train":
        raise NotImplementedError("MLA in train mode is not ported yet")
    if cfg.mla_absorb:
        raise NotImplementedError("absorbed MLA (mla_absorb) is not ported "
                                  "yet")
    B, T, _ = x.shape
    H, r = cfg.n_heads, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h = apply_norm(p["norm"], x, cfg)
    # wq and wkv_a project the same normed residual: one fanout group
    q, kv = dense_fanout((p["wq"], p["wkv_a"]), h, ft=ft,
                         sites=("qkv.q", "qkv.kv"))
    q = q.reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = apply_norm(p["kv_norm"], kv[..., :r], cfg)
    positions, off = _positions(pos, mode, B, T, x.device)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    # one roped key shared across heads
    k_rope = rope(kv[..., r:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0]
    if mode == "decode":
        rows = torch.arange(B, device=x.device)
        cache["ckv"][rows, positions[:, 0]] = ckv[:, 0]
        cache["krope"][rows, positions[:, 0]] = k_rope[:, 0]
        ckv_s, kr_s = cache["ckv"], cache["krope"]
    elif is_pos_vector(off):
        _write_rows(cache["ckv"], ckv, positions)
        _write_rows(cache["krope"], k_rope, positions)
        ckv_s, kr_s = cache["ckv"], cache["krope"]
    else:
        cache["ckv"][:, off:off + T] = ckv
        cache["krope"][:, off:off + T] = k_rope
        ckv_s = cache["ckv"][:, :off + T] if off else ckv
        kr_s = cache["krope"][:, :off + T] if off else k_rope
    Tk = ckv_s.shape[1]
    kvb = dense(p["wkv_b"], ckv_s).reshape(B, Tk, H, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    k_full = torch.cat([k_nope, kr_s[:, :, None, :].expand(B, Tk, H, dr)],
                       dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    qg = q_full.permute(0, 2, 1, 3)[:, :, None]  # [B, H, 1, T, dn + dr]
    kt = k_full.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(dn + dr)
    if mode == "decode":
        o = attend_decode(qg, kt, vt, abs_pos=_decode_abs_pos(Tk, positions),
                          scale=scale)
    elif is_pos_vector(off):
        o = attend_prefill_packed(qg, kt, vt, qpos=positions, scale=scale)
    else:
        o = attend(qg, kt, vt, kind="causal", scale=scale, q_off=off)
    out = o[:, :, 0].permute(0, 2, 1, 3).reshape(B, T, H * dv)
    return dense(p["wo"], out.to(ACT_DTYPE), ft=ft, site="out.o"), cache


# ------------------------------------------------------------------- MLP ----

def init_mlp(gen, cfg: ModelConfig, repeat: int,
             d_ff: Optional[int] = None) -> dict:
    if cfg.mlp_gated is False or cfg.norm_kind != "rmsnorm":
        raise NotImplementedError("only the gated MLP is ported yet")
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
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


# ------------------------------------------------------------------- MoE ----

def _moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer rows for ``n_tokens`` routed tokens: the expected
    load times the capacity factor, capped at the dropless ceiling and
    rounded up to a multiple of 8 (at least 8)."""
    mc = cfg.moe
    c = int(math.ceil(n_tokens * mc.top_k / mc.n_experts * mc.capacity_factor))
    c = min(c, n_tokens * mc.top_k)  # dropless ceiling
    return max(8, -(-c // 8) * 8)


def init_moe(gen, cfg: ModelConfig, repeat: int) -> dict:
    mc, D = cfg.moe, cfg.d_model
    E, F = mc.n_experts, mc.d_ff_expert
    p = {
        "norm": {"scale": torch.ones((repeat, D), device=gen.device)},
        "router": he_init(gen, (repeat, D, E), D),
        "we_gate": he_init(gen, (repeat, E, D, F), D),
        "we_up": he_init(gen, (repeat, E, D, F), D),
        "we_down": he_init(gen, (repeat, E, F, D), F),
    }
    if mc.n_shared:
        p["shared"] = init_mlp(gen, cfg, repeat, d_ff=mc.n_shared * F)
        del p["shared"]["norm"]  # shares the block's norm
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple:
    """``lax.top_k``: the k largest along the last axis, ties broken
    towards the lower index (a stable descending sort; ``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, hf: torch.Tensor, *, cfg: ModelConfig, ft=None) -> tuple:
    """The router: normed tokens [N, D] -> (combine weights [N, k] float32,
    expert ids [N, k]), the top-k of the gate probabilities renormalized
    to sum to 1. With ``ft`` covering ``mlp.router`` the logits come from
    the protected GEMM, so a failed group cannot reroute tokens."""
    if ft is not None and ft.protects("mlp.router"):
        rw = ((p["router_q8"]["w"], p["router_q8"]["scale"])
              if "router_q8" in p else p["router"])
        logits = ft.matmul("mlp.router", hf, rw)
    else:  # bf16 operands, float32 accumulation and result
        logits = torch.matmul(hf.to(torch.float32),
                              p["router"].to(ACT_DTYPE).to(torch.float32))
    probs = (torch.sigmoid(logits) if cfg.moe.gating == "sigmoid"
             else torch.softmax(logits, dim=-1))
    vals, idx = _top_k(probs, cfg.moe.top_k)
    return vals / (vals.sum(-1, keepdim=True) + 1e-9), idx


def apply_moe(p, x: torch.Tensor, *, cfg: ModelConfig, valid=None, ft=None):
    """Routed experts plus shared experts, with the reference's sort-based
    capacity dispatch over the whole batch (one dispatch group; the
    reference's data-parallel groups and sharding constraints do not
    apply to one card).

    Each token picks its top-k experts; assignments are sorted by expert
    (stably, so within an expert they keep token order) and expert e's
    buffer of C rows (:func:`_moe_capacity`) takes its first C
    assignments; later ones are dropped. ``valid`` [B, T] (bucketed
    prefill) routes pad tokens to a virtual expert E, so they never take
    capacity from real tokens. With ``ft`` covering ``moe.gate`` the three
    expert projections run through the grouped entangled kernel, all E
    experts in one call each."""
    mc = cfg.moe
    B, T, D = x.shape
    N, E, K = B * T, mc.n_experts, mc.top_k
    dev = x.device
    hf = apply_norm(p["norm"], x, cfg).reshape(N, D)
    weights, idx = route(p, hf, cfg=cfg, ft=ft)  # [N, K] each

    C = _moe_capacity(N, cfg)
    A = N * K  # assignments
    if valid is not None:  # pad tokens -> virtual expert E
        idx = torch.where(valid.reshape(N, 1), idx, E)
    e_flat, w_flat = idx.reshape(A), weights.reshape(A)
    order = torch.argsort(e_flat, stable=True)
    starts = torch.searchsorted(e_flat[order],
                                torch.arange(E + 1, device=dev), side="left")
    # buffer slot e*C + j takes sorted assignment starts[e] + j
    slot = torch.arange(E * C, device=dev)
    eidx = slot // C
    src = starts[eidx] + slot % C
    slot_ok = src < starts[eidx + 1]
    src_tok = order[torch.clamp(src, max=A - 1)] // K
    expert_in = torch.where(slot_ok[:, None], hf[src_tok],
                            0).reshape(E, C, D)
    if ft is not None and ft.protects("moe.gate"):
        def _we(name):
            q = p.get(name + "_q8")
            return (q["w"], q["scale"]) if q is not None else p[name]

        a = silu(ft.matmul_grouped("moe.gate", expert_in, _we("we_gate"))
                 ).to(ACT_DTYPE) * ft.matmul_grouped(
            "moe.up", expert_in, _we("we_up")).to(ACT_DTYPE)
        out_e = ft.matmul_grouped("moe.down", a,
                                  _we("we_down")).to(ACT_DTYPE)
    else:
        a = silu(torch.matmul(expert_in, p["we_gate"].to(ACT_DTYPE))) \
            * torch.matmul(expert_in, p["we_up"].to(ACT_DTYPE))
        out_e = torch.matmul(a, p["we_down"].to(ACT_DTYPE))

    # combine: assignment (t, k) sits at sorted position inv_order, its
    # rank within the expert is that minus starts[e], its slot e*C + rank
    inv_order = torch.argsort(order)
    rank = inv_order - starts[e_flat]
    keep = rank < C
    if valid is not None:
        keep &= e_flat < E  # virtual-expert (pad) assignments add nothing
    src_slot = torch.clamp(e_flat * C + rank, max=E * C - 1)
    hsel = out_e.reshape(E * C, D)[src_slot]  # [A, D]
    contrib = torch.where(keep[:, None],
                          w_flat[:, None].to(ACT_DTYPE) * hsel, 0)
    out = contrib.reshape(N, K, D).sum(dim=1)

    if mc.n_shared:
        sp = p["shared"]
        g_s, u_s = dense_fanout((sp["gate"], sp["up"]), hf, ft=ft,
                                sites=("mlp.gate", "mlp.up"))
        out = out + dense(sp["down"], silu(g_s) * u_s, ft=ft,
                          site="mlp.down")
    return out.reshape(B, T, D)
