"""Model building blocks of the ported decoders, in PyTorch (port of the
dense-decoder, MLA, MoE, rolling-window attention, Mamba-1 and RG-LRU
parts of :mod:`repro.models.layers`).

Conventions, as in the reference:
  * params are nested dicts of tensors (float32 masters; matmuls run in
    bfloat16, :data:`ACT_DTYPE`);
  * ``mode`` is ``prefill``, ``decode`` or ``train``; decode processes
    T=1 tokens against a KV cache (or a recurrent state) with a per-row
    position vector ``pos`` [B]; train runs a whole sequence from
    position 0 with no cache (every block, under autograd);
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

import contextlib
import contextvars
import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

ACT_DTYPE = torch.bfloat16
# the card's unprotected GEMMs run in blocks of this many rows (the last
# block padded with zero rows, their outputs dropped), one GEMM of one
# shape per block: cuBLAS picks its kernel by the row count (it splits a
# deep contraction, K = 8192, for 128 rows or fewer), so a row's bits
# would depend on how many rows share the call, and a token's on how its
# prompt was chunked or packed; on the H100 even padded calls of 256 and
# 1024 rows of falcon-mamba-7b's 4096 x 16384 in_proj differed
# (tests/test_torch_cuda.py holds every served projection shape)
GEMM_ROWS = 256
# the absorbed MLA decode runs its float32 einsums over slabs of
# this many rows (the engine's default slot count), for the same reason
ABSORB_ROWS = 8
# the training scan of a Mamba block runs in checkpointed chunks of this
# many steps when they divide the sequence (the reference's Q)
MAMBA_CHUNK = 64


def he_init(gen: torch.Generator, shape: tuple, fan_in: int) -> torch.Tensor:
    """float32 normal(0, 1/fan_in) weights on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * (
        1.0 / math.sqrt(fan_in))


# the dtype :func:`bf16_read_init` stores weights in (set by
# :func:`master_dtype` around a model's ``init``)
_MASTER_DTYPE = contextvars.ContextVar("master_dtype", default=torch.float32)


@contextlib.contextmanager
def master_dtype(dtype: torch.dtype):
    """Within: :func:`bf16_read_init` stores its weights in ``dtype``."""
    token = _MASTER_DTYPE.set(dtype)
    try:
        yield
    finally:
        _MASTER_DTYPE.reset(token)


def bf16_read_init(gen: torch.Generator, shape: tuple,
                   fan_in: int) -> torch.Tensor:
    """:func:`he_init` for a weight that every forward reads only through
    a bfloat16 cast (a projection's ``w``, the router, the expert stacks,
    the embedding and the head): float32 by default; under
    ``master_dtype(torch.bfloat16)`` drawn one matrix ``shape[-2:]`` at a
    time in float32 and rounded to bfloat16, so that the float32 temporary
    is one matrix (one expert's slab of a stack), never the whole leaf."""
    dtype = _MASTER_DTYPE.get()
    if dtype == torch.float32:
        return he_init(gen, shape, fan_in)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for idx in itertools.product(*(range(n) for n in shape[:-2])):
        out[idx] = he_init(gen, shape[-2:], fan_in)
    return out


# ----------------------------------------------------------------- norms ----

def init_norm(cfg: ModelConfig, shape: tuple, device) -> dict:
    """A norm's params of ``shape`` (``(d,)``, or ``(repeat, d)`` for a
    stack): ``scale`` ones, and for a layernorm ``bias`` zeros."""
    p = {"scale": torch.ones(shape, device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros(shape, device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The config's norm, cast to bfloat16: LayerNorm (whisper: mean and
    biased variance, scale and bias) in float32, or RMSNorm (the
    decoders): float32 statistics, then with ``cfg.norm_f32`` a float32
    apply, else the reference's bf16 elementwise apply ``x * inv * scale``
    in bfloat16 (no float32 [B, T, D] product)."""
    x32 = x.to(torch.float32)
    if cfg.norm_kind == "layernorm":
        mu = _rows_mean(x32)
        var = _rows_mean(torch.square(x32 - mu))
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["scale"] + p["bias"]).to(ACT_DTYPE)
    ms = _rows_mean(torch.square(x32))
    if cfg.norm_f32:
        return (x32 * torch.rsqrt(ms + cfg.norm_eps)
                * p["scale"]).to(ACT_DTYPE)
    inv = torch.rsqrt(ms + cfg.norm_eps).to(ACT_DTYPE)
    return x.to(ACT_DTYPE) * inv * p["scale"].to(ACT_DTYPE)


def _rows_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(-1, keepdim=True)``; on the card in blocks of
    :data:`GEMM_ROWS` rows (the last one padded with zero rows), one
    reduction of one shape per block: the reduction kernel orders a row's
    sum by how many rows share the call (a norm's mean square got other
    float32 bits in a decode step of 4 rows than of 8 on the H100), so a
    row's bits would depend on the batch. A training forward (under
    autograd) keeps one reduction."""
    if not x.is_cuda or x.requires_grad:
        return torch.mean(x, -1, keepdim=True)
    D = x.shape[-1]
    R = x.numel() // D
    xr = F.pad(x.reshape(R, D), (0, 0, 0, (-R) % GEMM_ROWS))
    ys = [torch.mean(xr[i:i + GEMM_ROWS], -1, keepdim=True)
          for i in range(0, xr.shape[0], GEMM_ROWS)]
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    return y[:R].reshape(*x.shape[:-1], 1)


def _sum_in_order(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``a.sum(dim)`` over a short axis as left-to-right float32 adds,
    rounded to ``a``'s dtype once: one order on every device and batch
    (a library reduction orders a sum by the shape of the call)."""
    parts = a.to(torch.float32).unbind(dim)
    acc = parts[0]
    for t in parts[1:]:
        acc = acc + t
    return acc.to(a.dtype)


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


def _add_bias(p, y: torch.Tensor) -> torch.Tensor:
    """Add the site's bias ``b`` (qwen2's q/k/v), if it has one, in
    bfloat16 after the projection; it is never quantized."""
    return y + p["b"].to(ACT_DTYPE) if "b" in p else y


def dense(p, x: torch.Tensor, *, ft=None, site: Optional[str] = None):
    """Dense projection — THE protected-GEMM chokepoint: with ``ft``
    covering ``site`` it runs as the fused entangled int8 GEMM, otherwise
    as a bfloat16 matmul; the bias stays in float either way."""
    if ft is not None and site is not None and ft.protects(site):
        y = ft.matmul(site, x, _dense_w(p)).to(ACT_DTYPE)
    else:
        y = _bf16_matmul(x, p["w"])
    return _add_bias(p, y)


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in bfloat16 (:func:`_rows_matmul`)."""
    return _rows_matmul(x.to(ACT_DTYPE), w.to(ACT_DTYPE))


def _rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' dtype; on the card in blocks of
    :data:`GEMM_ROWS` rows (the last one padded with zero rows), one GEMM
    of the same shape per block, so that each row's result does not depend
    on how many rows share the call. A training forward (weights under
    autograd) keeps one GEMM: no other call must reproduce its bits."""
    if not x.is_cuda or w.requires_grad:
        return torch.matmul(x, w)
    K = x.shape[-1]
    R = x.numel() // K
    xr = F.pad(x.reshape(R, K), (0, 0, 0, (-R) % GEMM_ROWS))
    ys = [torch.matmul(xr[i:i + GEMM_ROWS], w)
          for i in range(0, xr.shape[0], GEMM_ROWS)]
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    return y[:R].reshape(*x.shape[:-1], w.shape[-1])


def dense_fanout(ps, x: torch.Tensor, *, ft, sites) -> list:
    """Fanout form of :func:`dense` for sites that project the SAME
    activations (attention Q/K/V, MLP gate/up): when all are protected,
    one quantize/permute pass feeds every member's kernel call."""
    if ft is None or not all(ft.protects(s) for s in sites):
        return [dense(p, x, ft=ft, site=s) for p, s in zip(ps, sites)]
    ys = ft.matmul_fanout(tuple(sites), x, tuple(_dense_w(p) for p in ps))
    return [_add_bias(p, y.to(ACT_DTYPE)) for p, y in zip(ps, ys)]


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
    [B] (:func:`prefill_off`); train and encode the whole sequence from
    position 0."""
    if mode == "decode":
        return pos.to(torch.int64)[:, None].expand(B, T), 0
    if mode not in ("prefill", "train", "encode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    off = prefill_off(pos) if mode == "prefill" else 0
    t = torch.arange(T, device=device)
    if is_pos_vector(off):
        return off[:, None] + t[None], off
    return (t + off)[None].expand(B, T), off


def _cache_abs_pos(S: int, pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """[B, S] absolute position of each cache slot of a row whose last
    written position is ``pos`` [B], -1 where the slot holds none. Linear
    cache: slot s holds position s, valid while s <= pos. Rolling window
    cache: slot s holds the latest position congruent to s (mod
    ``window``) that is at most pos and within the window."""
    slot = torch.arange(S, device=pos.device)[None, :]
    pos = pos.to(torch.int64)[:, None]
    if not window:
        return torch.where(slot <= pos, slot, -1)
    base = (pos // window) * window
    abs_pos = torch.where(slot <= pos % window, base + slot,
                          base - window + slot)
    ok = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - window)
    return torch.where(ok, abs_pos, -1)


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


def _prefill_valid(off, T: int, lengths, *,
                   time_major: bool = False) -> Optional[torch.Tensor]:
    """[B, T] (``time_major``: [T, B]) mask of the REAL positions of a
    bucketed prefill chunk: position off+t belongs to row b iff off+t <
    lengths_b. ``off`` is an int shared by every row or a per-row vector
    [B] (token-packed prefill). None when ``lengths`` is None (the whole
    batch is real)."""
    if lengths is None:
        return None
    t = torch.arange(T, device=lengths.device)
    g = off[:, None] + t[None] if is_pos_vector(off) else (off + t)[None, :]
    m = g < lengths.to(torch.int64)[:, None]
    return m.T if time_major else m


def _off_any(off) -> bool:
    """True when any row of this prefill call may start past position 0
    (an earlier chunk's conv tail and state exist). Always True for a
    per-row offset vector: rows at offset 0 read a zeroed cache row,
    which is bit-identical to the fresh-state branch."""
    return is_pos_vector(off) or bool(off)


def _conv_tail_state(xp: torch.Tensor, off, T: int, lengths,
                     d_conv: int) -> torch.Tensor:
    """Per-row depthwise-conv tail of a bucketed prefill chunk: the last
    ``d_conv - 1`` REAL inputs of each row, gathered from ``xp = [previous
    tail (d_conv - 1), inputs (T)]``; a row with no real position in the
    chunk keeps its previous tail. Shared by Mamba and RG-LRU."""
    B = xp.shape[0]
    if lengths is None:
        e = torch.full((B,), T, dtype=torch.int64, device=xp.device)
    else:
        e = torch.clamp(lengths.to(torch.int64) - off, 0, T)
    gidx = e[:, None] + torch.arange(d_conv - 1, device=xp.device)[None]
    gidx = gidx[..., None].expand(-1, -1, xp.shape[-1])
    return torch.gather(xp, 1, gidx).to(ACT_DTYPE)


def _causal_conv(xp: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """Depthwise causal conv in float32: ``xp`` [B, d_conv - 1 + T, d] (the
    tail, then the inputs), ``w`` [d, d_conv] -> [B, T, d], summed over
    the taps in order, j = 0 first. Prefill and decode (T = 1, xp the
    window of the tail and the new input) share it, so that a position
    gets the same bits from both."""
    wf = w.to(torch.float32)
    acc = xp[:, 0:T].to(torch.float32) * wf[:, 0]
    for j in range(1, w.shape[-1]):
        acc = acc + xp[:, j:j + T].to(torch.float32) * wf[:, j]
    return acc


# ---------------------------------------------------------- GQA attention ----

def init_attention(gen, cfg: ModelConfig, repeat: int) -> dict:
    """GQA projections; with ``cfg.qkv_bias`` (qwen2) q, k and v each get
    a bias ``b``, zeros as in the reference."""
    hd, D = cfg.resolved_head_dim, cfg.d_model

    def proj(n_out, bias=False):
        p = {"w": bf16_read_init(gen, (repeat, D, n_out), D)}
        if bias:
            p["b"] = torch.zeros((repeat, n_out), device=gen.device)
        return p

    return {
        "norm": init_norm(cfg, (repeat, D), gen.device),
        "wq": proj(cfg.n_heads * hd, cfg.qkv_bias),
        "wk": proj(cfg.n_kv_heads * hd, cfg.qkv_bias),
        "wv": proj(cfg.n_kv_heads * hd, cfg.qkv_bias),
        "wo": {"w": bf16_read_init(gen, (repeat, cfg.n_heads * hd, D),
                                   cfg.n_heads * hd)},
    }


def init_attn_cache(cfg: ModelConfig, repeat: int, batch: int, max_seq: int,
                    device, window: int = 0) -> dict:
    """The KV cache: ``max_seq`` slots, or with ``window`` a rolling buffer
    of min(max_seq, window) slots (position p in slot p % window)."""
    S = min(max_seq, window) if window else max_seq
    shape = (repeat, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device)}


def _buffer_holds_chunk(S: int, off, T: int, window: int) -> bool:
    """True when no position of a prefill chunk reaches the window, so
    that the rolling buffer, once the chunk is written, still holds every
    key its queries attend to: always when the buffer is shorter than the
    window (max_seq < window: no position ever reaches it), else when the
    chunk (one shared offset) ends within the first window."""
    return S < window or (not is_pos_vector(off) and off + T <= window)


def _window_prefill_write(cache: dict, k: torch.Tensor, v: torch.Tensor, *,
                          off, lengths, window: int) -> None:
    """Masked rolling-buffer write of a bucketed, chunked or token-packed
    prefill chunk, in place: per row, the last min(T, window) REAL
    positions before ``end_b = min(lengths_b, off + T)`` go to slot
    p % window. Pad positions and positions of earlier chunks leave the
    buffer as it was, so padding a prompt to its bucket never clobbers a
    real key. Written as a gather over the buffer's S slots: slot s takes
    the one position of the row's written range [start_b, end_b) (at most
    ``window`` long) congruent to s, if there is one, so no two writes
    meet and no index leaves the buffer, also when it holds fewer slots
    than the window (S = max_seq < window)."""
    B, T = k.shape[0], k.shape[1]
    S, dev = cache["k"].shape[1], k.device
    off_b = (off if is_pos_vector(off) else
             torch.full((B,), off, dtype=torch.int64, device=dev))
    if lengths is None:
        end = off_b + T
    else:
        end = torch.minimum(torch.maximum(lengths.to(torch.int64), off_b),
                            off_b + T)
    start = torch.maximum(end - min(T, window), off_b)[:, None]
    p = start + torch.remainder(torch.arange(S, device=dev)[None] - start,
                                window)  # [B, S]
    hit = (p < end[:, None])[..., None, None]
    local = torch.clamp(p - off_b[:, None], 0, T - 1)
    for name, new in (("k", k), ("v", v)):
        idx = local[..., None, None].expand(-1, -1, *new.shape[2:])
        buf = cache[name]
        buf.copy_(torch.where(hit, torch.gather(new, 1, idx), buf))


def _window_prefill(cache: dict, k, v, positions, *, off, lengths,
                    window: int) -> tuple:
    """The batched rolling-window prefill: write the chunk's real keys
    into the buffer (in place) and return ``(keys, values, their absolute
    positions [B, S'] (-1: none), slots)``, what its queries attend to.
    While no position of the chunk reaches the window
    (:func:`_buffer_holds_chunk`) that is the written buffer itself, in
    the slot order decode reads it in (``slots`` True; so a position gets
    decode's bits); else, as in the reference, the OLD buffer (earlier
    chunks) followed by the chunk's own keys."""
    B, T = k.shape[0], k.shape[1]
    S = cache["k"].shape[1]
    if _buffer_holds_chunk(S, off, T, window):
        _window_prefill_write(cache, k, v, off=off, lengths=lengths,
                              window=window)
        last = positions[:, -1]
        if lengths is not None:
            last = torch.minimum(lengths.to(torch.int64) - 1, last)
        return (cache["k"], cache["v"], _cache_abs_pos(S, last, window),
                True)
    prev_end = torch.zeros((B,), dtype=torch.int64, device=k.device) + off
    if lengths is not None:  # the real positions of earlier chunks
        prev_end = torch.minimum(lengths.to(torch.int64).clamp(min=0),
                                 prev_end)
    valid_new = _prefill_valid(off, T, lengths)
    if valid_new is None:
        valid_new = torch.ones((B, T), dtype=torch.bool, device=k.device)
    kabs = torch.cat([_cache_abs_pos(S, prev_end - 1, window),
                      torch.where(valid_new, positions, -1)], dim=1)
    k_all = torch.cat([cache["k"], k], dim=1)
    v_all = torch.cat([cache["v"], v], dim=1)
    _window_prefill_write(cache, k, v, off=off, lengths=lengths,
                          window=window)
    return k_all, v_all, kabs, False


def apply_attention(p, x: torch.Tensor, *, cfg: ModelConfig, cache: dict,
                    pos, mode: str, rope_theta: Optional[float] = None,
                    window: int = 0, lengths=None, ft=None, cross_kv=None):
    """GQA attention against the KV cache, writing it in place; with
    ``rope_theta`` None no rotary embedding (whisper's learned positions).

    ``cross_kv`` (whisper's decoder): the precomputed encoder keys and
    values ``(k, v)`` [B, F, Hkv, hd]; only ``wq`` is projected, every
    query attends to all F frames, and ``cache`` (None) is returned as
    it was. ``encode`` (whisper's encoder): no cache; the sequence
    attends to itself in both directions.

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
    sequence attends causally (with ``window``, within its window) to
    itself, through the materialized scores while ``T * T <= 2048**2 /
    4``, past that through the blocked forward and backward, as the
    reference.

    With ``window`` (recurrentgemma's local attention) the cache is a
    rolling buffer: decode writes slot pos % window and masks the slots on
    their absolute positions; a bucketed, chunked or packed prefill
    (``lengths`` [B], the rows' true prompt lengths, or an offset) writes
    its last real keys (:func:`_window_prefill_write`) and attends, masked
    on per-row absolute positions so that a pad or another row's length
    never enters a window: over the written buffer in slot order (decode's
    layout) while no position reaches the window
    (:func:`_buffer_holds_chunk`), else, as the reference, against the OLD
    buffer plus its own keys; a whole prompt from position 0 with
    no ``lengths`` attends to itself under the window mask and writes its
    last min(T, window) keys.
    """
    from repro_torch.models.attention_core import (attend, attend_decode,
                                                   attend_prefill_packed,
                                                   attend_prefill_window)

    B, T, _ = x.shape
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = apply_norm(p["norm"], x, cfg)
    if cross_kv is not None:
        q = dense(p["wq"], h, ft=ft, site="qkv.q").reshape(B, T, H, hd)
    else:
        q, k, v = dense_fanout((p["wq"], p["wk"], p["wv"]), h, ft=ft,
                               sites=("qkv.q", "qkv.k", "qkv.v"))
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, Hkv, hd)
        v = v.reshape(B, T, Hkv, hd)
        positions, off = _positions(pos, mode, B, T, x.device)
        if rope_theta:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
    win_kabs = win_slots = None  # set by the batched rolling-window prefill
    if cross_kv is not None:
        k_all, v_all = cross_kv
    elif mode in ("train", "encode"):
        if cache is not None:
            raise ValueError(f"{mode} mode takes no cache")
        k_all, v_all = k, v
    elif mode == "decode":
        rows = torch.arange(B, device=x.device)
        slot = positions[:, 0] % window if window else positions[:, 0]
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        k_all, v_all = cache["k"], cache["v"]
    elif window and (lengths is not None or is_pos_vector(off) or off):
        k_all, v_all, win_kabs, win_slots = _window_prefill(
            cache, k, v, positions, off=off, lengths=lengths, window=window)
    elif window:  # a whole prompt from position 0: its last window keys
        keep = min(T, window)
        slots = torch.arange(T - keep, T, device=x.device) % window
        cache["k"][:, slots] = k[:, T - keep:]
        cache["v"][:, slots] = v[:, T - keep:]
        k_all, v_all = k, v
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
    if cross_kv is not None or mode == "encode":
        o = attend(qg, kt, vt, kind="full")
    elif mode == "decode":
        o = attend_decode(qg, kt, vt, abs_pos=_cache_abs_pos(
            k_all.shape[1], positions[:, 0], window))
    elif win_kabs is not None:
        o = attend_prefill_window(qg, kt, vt, qpos=positions if
                                  is_pos_vector(off) else positions[0],
                                  kabs=win_kabs, window=window,
                                  slots=win_slots)
    elif is_pos_vector(off):
        o = attend_prefill_packed(qg, kt, vt, qpos=positions)
    else:
        o = attend(qg, kt, vt, kind="window" if window else "causal",
                   q_off=off, window=window)
    out = o.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd)
    return dense(p["wo"], out.to(ACT_DTYPE), ft=ft, site="out.o"), cache


# ---------------------------------------------------------- MLA attention ----

def init_mla(gen, cfg: ModelConfig, repeat: int) -> dict:
    """MLA's projections: ``wkv_a`` (the latent and the shared rope key),
    ``wkv_b`` (the latent's per-head keys and values), ``wo``, and either
    the full-rank ``wq`` or, with ``q_lora_rank`` (deepseek-v3), the
    low-rank ``wq_a`` -> ``q_norm`` -> ``wq_b``."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    p = {
        "norm": init_norm(cfg, (repeat, D), gen.device),
        "wkv_a": {"w": bf16_read_init(gen, (repeat, D,
                                            r + m.qk_rope_head_dim), D)},
        "kv_norm": init_norm(cfg, (repeat, r), gen.device),
        "wkv_b": {"w": bf16_read_init(
            gen, (repeat, r, H * (m.qk_nope_head_dim + m.v_head_dim)), r)},
        "wo": {"w": bf16_read_init(gen, (repeat, H * m.v_head_dim, D),
                                   H * m.v_head_dim)},
    }
    if m.q_lora_rank:
        q = m.q_lora_rank
        p["wq_a"] = {"w": bf16_read_init(gen, (repeat, D, q), D)}
        p["q_norm"] = init_norm(cfg, (repeat, q), gen.device)
        p["wq_b"] = {"w": bf16_read_init(gen, (repeat, q, H * qk_dim), q)}
    else:
        p["wq"] = {"w": bf16_read_init(gen, (repeat, D, H * qk_dim), D)}
    return p


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
    """Multi-head latent attention (DeepSeek): the cache holds only the
    normed latent c_kv [B, S, r] and the shared roped key [B, S, dr],
    written in place, and every step up-projects the cached latents to
    per-head keys and values (``wkv_b``, an unprotected projection) — the
    reference's naive path; with ``cfg.mla_absorb`` a decode step instead
    attends over the latents themselves (:func:`_mla_absorbed`), and
    prefill stays naive, as in the reference. ``pos`` and ``mode`` as in
    :func:`apply_attention`, the per-row prefill offsets and train mode
    (no cache, the sequence's own latents) included."""
    from repro_torch.models.attention_core import (attend, attend_decode,
                                                   attend_prefill_packed)

    m = cfg.mla
    B, T, _ = x.shape
    H, r = cfg.n_heads, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h = apply_norm(p["norm"], x, cfg)
    # wq_a (or wq) and wkv_a project the same normed residual: one fanout
    # group; the low-rank Q's up-projection wq_b is a site of its own
    if m.q_lora_rank:
        qa, kv = dense_fanout((p["wq_a"], p["wkv_a"]), h, ft=ft,
                              sites=("qkv.q_a", "qkv.kv"))
        q = dense(p["wq_b"], apply_norm(p["q_norm"], qa, cfg), ft=ft,
                  site="qkv.q")
    else:
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
    if mode == "train":
        if cache is not None:
            raise ValueError("train mode takes no cache")
        ckv_s, kr_s = ckv, k_rope
    elif mode == "decode":
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
    if mode == "decode" and cfg.mla_absorb:
        o = _mla_absorbed(p["wkv_b"]["w"], q_nope, q_rope, ckv_s, kr_s,
                          positions[:, 0], cfg)
        return dense(p["wo"], o.to(ACT_DTYPE), ft=ft, site="out.o"), cache
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
        o = attend_decode(qg, kt, vt,
                          abs_pos=_cache_abs_pos(Tk, positions[:, 0]),
                          scale=scale)
    elif is_pos_vector(off):
        o = attend_prefill_packed(qg, kt, vt, qpos=positions, scale=scale)
    else:
        o = attend(qg, kt, vt, kind="causal", scale=scale, q_off=off)
    out = o[:, :, 0].permute(0, 2, 1, 3).reshape(B, T, H * dv)
    return dense(p["wo"], out.to(ACT_DTYPE), ft=ft, site="out.o"), cache


def _mla_absorbed(w_kv_b: torch.Tensor, q_nope, q_rope, ckv, kr,
                  pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's absorbed MLA decode (``mla_absorb``): ``W_uk`` folded
    into the queries and ``W_uv`` out of the value sum, so that attention
    runs over the cached latents ``ckv`` [B, S, r] themselves, in float32
    einsums; ``kr`` [B, S, dr] is the shared roped key, ``pos`` [B] each
    row's position. Returns the heads' values [B, T, H * dv] in float32.

    The rows go in slabs of :data:`ABSORB_ROWS` (the last one padded with
    zero rows), each through the same einsums of one shape, so that a
    slot's bits do not depend on how many slots share the step
    (:func:`_rows_matmul`'s rule). TF32 stays off, as everywhere in the
    port."""
    B = q_nope.shape[0]
    if B == ABSORB_ROWS:
        return _mla_absorbed_rows(w_kv_b, q_nope, q_rope, ckv, kr, pos, cfg)
    pad = (-B) % ABSORB_ROWS

    def padded(t, fill=0):
        return torch.cat([t, t.new_full((pad,) + t.shape[1:], fill)]) \
            if pad else t

    args = [padded(t) for t in (q_nope, q_rope, ckv, kr)] + [padded(pos, -1)]
    outs = [_mla_absorbed_rows(w_kv_b, *(t[i:i + ABSORB_ROWS] for t in args),
                               cfg) for i in range(0, B + pad, ABSORB_ROWS)]
    return torch.cat(outs)[:B]


def _mla_absorbed_rows(w_kv_b, q_nope, q_rope, ckv, kr, pos,
                       cfg: ModelConfig) -> torch.Tensor:
    m, H = cfg.mla, cfg.n_heads
    B, T = q_nope.shape[:2]
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    f32 = torch.float32
    wb = w_kv_b.to(f32).reshape(m.kv_lora_rank, H, dn + dv)
    w_uk, w_uv = wb[..., :dn], wb[..., dn:]
    ckv32 = ckv.to(f32)
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope.to(f32), w_uk)
    s_nope = torch.einsum("bthr,bsr->bhts", q_eff, ckv32)
    s_rope = torch.einsum("bthd,bsd->bhts", q_rope.to(f32), kr.to(f32))
    s = (s_nope + s_rope) * (1.0 / math.sqrt(dn + dr))
    ok = _cache_abs_pos(ckv.shape[1], pos) >= 0  # [B, S]
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, -1e30))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhts,bsr->bthr", probs, ckv32)
    o = torch.einsum("bthr,rhd->bthd", ctx, w_uv)
    return o.reshape(B, T, H * dv)


# ------------------------------------------------------------------- MLP ----

def init_mlp(gen, cfg: ModelConfig, repeat: int,
             d_ff: Optional[int] = None, gated: bool = True) -> dict:
    """The gated MLP (gate, up, down), or the ungated one (up, down:
    minitron's relu2, granite's gelu, whisper's). ``cfg.mlp_gated``
    decides when set, else ``gated``, the block's default (a layernorm
    model's dense and encoder-decoder blocks are ungated)."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    p = {"norm": init_norm(cfg, (repeat, D), gen.device)}
    if gated if cfg.mlp_gated is None else cfg.mlp_gated:
        p["gate"] = {"w": bf16_read_init(gen, (repeat, D, Fd), D)}
    p["up"] = {"w": bf16_read_init(gen, (repeat, D, Fd), D)}
    p["down"] = {"w": bf16_read_init(gen, (repeat, Fd, D), Fd)}
    return p


def silu(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference evaluates it on bfloat16:
    ``a * (1 / (1 + exp(-a)))`` rounded to the working dtype after every
    op. (``F.silu`` rounds once, which moves about a third of the bf16
    outputs by one ulp against the reference.)"""
    return a * torch.reciprocal(torch.exp(-a) + 1)


def relu2(a: torch.Tensor) -> torch.Tensor:
    """``jnp.square(jax.nn.relu(a))``, Nemotron's squared ReLU."""
    return torch.square(torch.relu(a))


def gelu(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default) as the reference
    evaluates it on bfloat16: every op rounded to the working dtype, the
    cube as two products and the constants rounded to it first (a Python
    float meets a bfloat16 array as a bfloat16 there). ``F.gelu(a,
    approximate="tanh")`` rounds once, which moves many of the bf16
    outputs by an ulp against the reference."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=a.dtype, device=a.device)
    k = torch.tensor(0.044715, dtype=a.dtype, device=a.device)
    return a * (0.5 * (1.0 + torch.tanh(c * (a + k * (a * a * a)))))


_ACTS = {"silu": silu, "relu2": relu2, "gelu": gelu}


def _mlp_act(cfg: ModelConfig, a: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act not in _ACTS:
        raise NotImplementedError(f"mlp_act {cfg.mlp_act!r} is not ported yet")
    return _ACTS[cfg.mlp_act](a)


def apply_mlp(p, x: torch.Tensor, *, cfg: ModelConfig, ft=None):
    """Gated MLP: down(act(gate(h)) * up(h)) with gate/up one fanout group;
    ungated (no ``gate``): down(act(up(h))), each a protected site of its
    own; a layernorm model's ungated MLP always takes ``gelu``, whatever
    ``cfg.mlp_act`` says, as in the reference."""
    h = apply_norm(p["norm"], x, cfg)
    if "gate" in p:
        gate, up = dense_fanout((p["gate"], p["up"]), h, ft=ft,
                                sites=("mlp.gate", "mlp.up"))
        a = _mlp_act(cfg, gate) * up
    else:
        up = dense(p["up"], h, ft=ft, site="mlp.up")
        a = gelu(up) if cfg.norm_kind == "layernorm" else _mlp_act(cfg, up)
    return dense(p["down"], a, ft=ft, site="mlp.down")


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
        "norm": init_norm(cfg, (repeat, D), gen.device),
        "router": bf16_read_init(gen, (repeat, D, E), D),
        "we_gate": bf16_read_init(gen, (repeat, E, D, F), D),
        "we_up": bf16_read_init(gen, (repeat, E, D, F), D),
        "we_down": bf16_read_init(gen, (repeat, E, F, D), F),
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
    """The router: normed tokens [..., D] -> (combine weights [..., k]
    float32, expert ids [..., k]), the top-k of the gate probabilities
    renormalized to sum to 1. With ``ft`` covering ``mlp.router`` the
    logits come from the protected GEMM, so a failed group cannot reroute
    tokens; else a float32 GEMM in :func:`_rows_matmul`'s blocks, so that
    a token's route on the card does not depend on how many tokens share
    the call."""
    if ft is not None and ft.protects("mlp.router"):
        rw = ((p["router_q8"]["w"], p["router_q8"]["scale"])
              if "router_q8" in p else p["router"])
        logits = ft.matmul("mlp.router", hf, rw)
    else:  # bf16 operands, float32 accumulation and result
        logits = _rows_matmul(hf.to(torch.float32),
                              p["router"].to(ACT_DTYPE).to(torch.float32))
    probs = (torch.sigmoid(logits) if cfg.moe.gating == "sigmoid"
             else torch.softmax(logits, dim=-1))
    vals, idx = _top_k(probs, cfg.moe.top_k)
    return vals / (_sum_in_order(vals, -1)[..., None] + 1e-9), idx


def moe_groups(n_tokens: int, cfg: ModelConfig) -> tuple:
    """(G, group): the dispatch groups of :func:`apply_moe` over
    ``n_tokens`` tokens of this process, and the process group whose ranks'
    tokens it gathers first (or None).

    The rule: G counts the ``batch`` shards that THIS process's tensor
    holds (:func:`repro_torch.dist.sharding.local_extent`). Under a
    stand-in mesh ``{"data": n}`` one process holds every shard, so G = n,
    the reference's ``axis_extent("batch")``; on a rank of a ``DeviceMesh``
    (the engine's mesh across processes) the tensor is that rank's shard
    already, so G = 1, and the rank's tokens are its group. G falls back
    to 1 where it does not divide the tokens, as in the reference.
    ``dispatch="global_sort"`` keeps one group over every token: on a
    ``DeviceMesh`` the ranks' tokens are all-gathered first (what the
    reference's GSPMD lowering did), and each rank keeps its own rows of
    the result."""
    from repro_torch.dist.sharding import axis_group, local_extent

    if getattr(cfg.moe, "dispatch", "grouped") == "grouped":
        G, group = local_extent("batch"), None
    else:
        G, group = 1, axis_group("batch")
    return (1 if n_tokens % G else G), group


def apply_moe(p, x: torch.Tensor, *, cfg: ModelConfig, valid=None, ft=None):
    """Routed experts plus shared experts, with the reference's grouped
    sort-based capacity dispatch: the N tokens split into G contiguous
    groups of ``n_loc`` (:func:`moe_groups`), and each group routes, sorts,
    fills its experts' buffers and combines on its own.

    Each token picks its top-k experts; a group's assignments are sorted
    by expert (stably, so within an expert they keep token order) and
    expert e's buffer of C rows (:func:`_moe_capacity` of ``n_loc``) takes
    its first C assignments; later ones are dropped. ``valid`` [B, T]
    (bucketed prefill) routes pad tokens to a virtual expert E, so they
    never take capacity from real tokens. With ``ft`` covering ``moe.gate``
    the three expert projections run through the grouped entangled kernel
    on the [G, E, C, D] buffer, all E experts of every group in one call
    each."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import all_gather_rows

    mc = cfg.moe
    B, T, D = x.shape
    E, K = mc.n_experts, mc.top_k
    dev = x.device
    hf = apply_norm(p["norm"], x, cfg).reshape(B * T, D)
    G, group = moe_groups(B * T, cfg)
    hr, vr = hf, valid
    if group is not None:  # global_sort across ranks: every rank's tokens
        hr = all_gather_rows(hf, group)
        if valid is not None:
            vr = all_gather_rows(valid.reshape(-1).to(torch.int32),
                                 group).bool()
    N = hr.shape[0]
    n_loc = N // G
    hg = hr.reshape(G, n_loc, D)
    weights, idx = route(p, hr, cfg=cfg, ft=ft)  # [N, K] each
    weights, idx = weights.reshape(G, n_loc, K), idx.reshape(G, n_loc, K)

    C = _moe_capacity(n_loc, cfg)
    A = n_loc * K  # assignments per group
    if vr is not None:  # pad tokens -> virtual expert E
        idx = torch.where(vr.reshape(G, n_loc, 1), idx, E)
    e_flat, w_flat = idx.reshape(G, A), weights.reshape(G, A)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    starts = torch.searchsorted(
        torch.gather(e_flat, 1, order),
        torch.arange(E + 1, device=dev).expand(G, E + 1).contiguous(),
        side="left")  # [G, E + 1]
    # buffer slot e*C + j takes the group's sorted assignment starts[e] + j
    slot = torch.arange(E * C, device=dev)
    eidx = slot // C
    src = starts[:, eidx] + slot % C  # [G, E*C]
    slot_ok = src < starts[:, eidx + 1]
    src_tok = torch.gather(order, 1, torch.clamp(src, max=A - 1)) // K
    rows = torch.gather(hg, 1, src_tok[..., None].expand(G, E * C, D))
    expert_in = torch.where(slot_ok[..., None], rows,
                            0).reshape(G, E, C, D)
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
    inv_order = torch.argsort(order, dim=-1)
    within = inv_order - torch.gather(starts, 1, e_flat)
    keep = within < C
    if vr is not None:
        keep &= e_flat < E  # virtual-expert (pad) assignments add nothing
    src_slot = torch.clamp(e_flat * C + within, max=E * C - 1)
    hsel = torch.gather(out_e.reshape(G, E * C, D), 1,
                        src_slot[..., None].expand(G, A, D))  # [G, A, D]
    contrib = torch.where(keep[..., None],
                          w_flat[..., None].to(ACT_DTYPE) * hsel, 0)
    out = _sum_in_order(contrib.reshape(N, K, D), 1)
    if group is not None:  # this rank's own rows
        r = dist.get_rank(group)
        out = out[r * B * T:(r + 1) * B * T]

    if mc.n_shared:
        sp = p["shared"]
        g_s, u_s = dense_fanout((sp["gate"], sp["up"]), hf, ft=ft,
                                sites=("mlp.gate", "mlp.up"))
        out = out + dense(sp["down"], silu(g_s) * u_s, ft=ft,
                          site="mlp.down")
    return out.reshape(B, T, D)


# ------------------------------------------------- recurrent float pieces ----

def softplus(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(a, 0)`` written as jnp writes
    it: ``max(a, 0) + log1p(exp(-|a|))``. (``F.softplus`` returns ``a``
    itself above its threshold of 20 and is another formula below.)"""
    return torch.clamp_min(a, 0) + torch.log1p(torch.exp(-torch.abs(a)))


def log_sigmoid(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-a)``."""
    return -softplus(-a)


def _sum_last(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving, one fixed order for
    every batch size (a library reduction may pick its order by the shape
    of the call, and a position must get the same bits from prefill and
    from decode). An odd length adds its last element first."""
    while a.shape[-1] > 1:
        n = a.shape[-1]
        if n % 2:
            a = torch.cat([a[..., :1] + a[..., -1:], a[..., 1:-1]], dim=-1)
            n -= 1
        a = a[..., :n // 2] + a[..., n // 2:]
    return a[..., 0]


def _state_in(cache, off, mode: str, shape: tuple, device) -> torch.Tensor:
    """The carried state h a recurrent block starts from: the cache's at
    decode and past position 0 (and under token packing, whose fresh rows
    the engine zeroes), else zeros."""
    if cache is not None and (mode == "decode" or _off_any(off)):
        return cache["h"]
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _conv_inputs(cache, xs: torch.Tensor, off, mode: str, d_conv: int):
    """``xp = [tail (d_conv - 1), xs]``: the tail is the cache's at decode
    and past position 0, zeros at a fresh prompt's start."""
    B, _, d = xs.shape
    if cache is not None and (mode == "decode" or _off_any(off)):
        pad = cache["conv"].to(xs.dtype)
    else:
        pad = xs.new_zeros((B, d_conv - 1, d))
    return torch.cat([pad, xs], dim=1)


def _new_conv_tail(xp, off, T: int, lengths, mode: str, d_conv: int):
    if mode == "decode":
        return xp[:, 1:]
    if lengths is not None or _off_any(off):
        return _conv_tail_state(xp, off, T, lengths, d_conv)
    return xp[:, -(d_conv - 1):].to(ACT_DTYPE)


def _mamba_scan(dt, dtu, Bc, Cc, A, h, valid) -> tuple:
    """Mamba-1's selective scan over the chunk's T steps, sequential:
    h = exp(dt_t * A) * h + (dt_t * u_t) B_t, y_t = h . C_t, with ``da``
    and ``db`` formed per step ([B, d_inner, d_state], never over T) and
    h held where ``valid`` [T, B] is False (a pad step). dt, dtu [B, T,
    di]; Bc, Cc [B, T, S]; A [di, S]; h [B, di, S]. Returns (y [B, T, di],
    the last h). On the ``meta`` device (the engine's shape census and
    the dry run; no protected site lies inside) the steps are skipped: one
    expression of the outputs' shapes over every input stands in, so that
    a backward still reaches each of them."""
    if h.is_meta:
        y = (dt * dtu + (Bc * Cc).sum(-1, keepdim=True)
             + (A.sum(-1) + h.sum((0, 2)))[None, None])
        return y, h + A
    T = dt.shape[1]
    dts, dbu = dt[..., None].unbind(1), dtu[..., None].unbind(1)
    bs, cs = Bc[:, :, None, :].unbind(1), Cc[:, :, None, :].unbind(1)
    vs = valid[..., None, None].unbind(0) if valid is not None else None
    ys = []
    for t in range(T):
        h_new = torch.addcmul(dbu[t] * bs[t], torch.exp(dts[t] * A), h)
        h = h_new if vs is None else torch.where(vs[t], h_new, h)
        ys.append(_sum_last(h * cs[t]))
    return torch.stack(ys, dim=1), h


def _mamba_scan_chunked(dt, dtu, Bc, Cc, A, h) -> tuple:
    """:func:`_mamba_scan` in chunks of :data:`MAMBA_CHUNK` steps, each
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
    its chunk body): the backward keeps the state h at the chunk
    boundaries and recomputes a chunk's steps, never holding every step's
    [B, d_inner, d_state] at once. The steps are :func:`_mamba_scan`'s, so
    the outputs are its bits."""
    from torch.utils.checkpoint import checkpoint

    ys = []
    for t0 in range(0, dt.shape[1], MAMBA_CHUNK):
        sl = slice(t0, t0 + MAMBA_CHUNK)
        y, h = checkpoint(_mamba_scan, dt[:, sl], dtu[:, sl], Bc[:, sl],
                          Cc[:, sl], A, h, None, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _lru_scan(a, x, h, valid) -> tuple:
    """The RG-LRU recurrence h = a_t * h + x_t over the chunk's T steps,
    h held where ``valid`` [T, B] is False. a, x [B, T, w]; h [B, w].
    Returns (every step's h [B, T, w], the last h); on the ``meta`` device
    the steps are skipped, as in :func:`_mamba_scan`."""
    if h.is_meta:
        hs = a * x + h[:, None]
        return hs, hs[:, -1]
    a_s, x_s = a.unbind(1), x.unbind(1)
    vs = valid[..., None].unbind(0) if valid is not None else None
    hs = []
    for t in range(a.shape[1]):
        h_new = torch.addcmul(x_s[t], a_s[t], h)
        h = h_new if vs is None else torch.where(vs[t], h_new, h)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _store_state(cache, conv_tail, h) -> None:
    """Write a recurrent block's new conv tail and state into its cache
    (in place; no cache in train mode)."""
    if cache is not None:
        cache["conv"].copy_(conv_tail)
        cache["h"].copy_(h)


# ----------------------------------------------------------------- Mamba ----

def _mamba_dims(cfg: ModelConfig) -> tuple:
    di = cfg.ssm.expand * cfg.d_model
    return di, cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def init_mamba(gen, cfg: ModelConfig, repeat: int) -> dict:
    sc, D, dev = cfg.ssm, cfg.d_model, gen.device
    di, dtr = _mamba_dims(cfg)
    a = torch.log(torch.arange(1, sc.d_state + 1, dtype=torch.float32,
                               device=dev))
    dt_b = torch.log(torch.expm1(torch.tensor(0.01, dtype=torch.float32)))
    return {
        "norm": init_norm(cfg, (repeat, D), dev),
        "in_proj": {"w": he_init(gen, (repeat, D, 2 * di), D)},
        "conv_w": he_init(gen, (repeat, di, sc.d_conv), sc.d_conv),
        "conv_b": torch.zeros((repeat, di), device=dev),
        "x_proj": {"w": he_init(gen, (repeat, di, dtr + 2 * sc.d_state),
                                di)},
        "dt_proj": {"w": he_init(gen, (repeat, dtr, di), dtr),
                    "b": torch.full((repeat, di), float(dt_b), device=dev)},
        "A_log": a.expand(repeat, di, sc.d_state).clone(),
        "D_skip": torch.ones((repeat, di), device=dev),
        "out_proj": {"w": he_init(gen, (repeat, di, D), di)},
    }


def init_mamba_cache(cfg: ModelConfig, repeat: int, batch: int, max_seq: int,
                     device) -> dict:
    """The conv tail (the last d_conv - 1 inputs) and the SSM state h."""
    sc = cfg.ssm
    di, _ = _mamba_dims(cfg)
    return {"conv": torch.zeros((repeat, batch, sc.d_conv - 1, di),
                                dtype=ACT_DTYPE, device=device),
            "h": torch.zeros((repeat, batch, di, sc.d_state),
                             dtype=torch.float32, device=device)}


def apply_mamba(p, x: torch.Tensor, *, cfg: ModelConfig, cache, pos,
                mode: str, lengths=None, ft=None):
    """Mamba-1 mixer, writing its conv tail and state into ``cache`` in
    place. The GEMMs are hoisted out of the recurrence: ``in_proj`` is the
    protected site ``qkv.in``, ``out_proj`` ``out.o``; ``x_proj`` (bf16)
    and ``dt_proj`` (float32) are unprotected, as in the reference. The
    selective scan walks the chunk's steps with the discretized ``da`` /
    ``db`` formed per step (never over [B, T, d_inner, d_state]).

    Prefill: ``pos`` is the chunk offset (int, or per row under token
    packing); past position 0 the conv reads the cached tail. ``lengths``
    [B] gates the recurrence per row, so a pad step holds h and the tail
    keeps the last real inputs: bucket padding never enters the carried
    state. Decode (T = 1) runs the same conv and step functions as
    prefill, so a position gets the same bits from both. Train (no cache,
    from position 0) runs them too, its scan in checkpointed chunks
    (:func:`_mamba_scan_chunked`) when :data:`MAMBA_CHUNK` divides T."""
    sc = cfg.ssm
    B, T, _ = x.shape
    di, dtr = _mamba_dims(cfg)
    S = sc.d_state
    off = 0 if mode == "decode" else prefill_off(pos)
    h_in = apply_norm(p["norm"], x, cfg)
    xz = dense(p["in_proj"], h_in, ft=ft, site="qkv.in")
    xs, z = xz[..., :di], xz[..., di:]
    xp = _conv_inputs(cache, xs, off, mode, sc.d_conv)
    conv = _causal_conv(xp, p["conv_w"], T)
    u = silu(conv + p["conv_b"].to(torch.float32))  # [B, T, di] float32

    proj = dense(p["x_proj"], u.to(ACT_DTYPE)).to(torch.float32)
    dt = softplus(_rows_matmul(proj[..., :dtr],
                               p["dt_proj"]["w"].to(torch.float32))
                  + p["dt_proj"]["b"])
    Bc = proj[..., dtr:dtr + S]
    Cc = proj[..., dtr + S:]
    A = -torch.exp(p["A_log"])  # [di, S]
    valid = (_prefill_valid(off, T, lengths, time_major=True)
             if mode == "prefill" else None)  # [T, B]
    h = _state_in(cache, off, mode, (B, di, S), x.device)
    if mode == "train" and T % MAMBA_CHUNK == 0 and T > MAMBA_CHUNK:
        ys, h = _mamba_scan_chunked(dt, dt * u, Bc, Cc, A, h)
    else:
        ys, h = _mamba_scan(dt, dt * u, Bc, Cc, A, h, valid)
    y = ys + u * p["D_skip"].to(torch.float32)
    y = y.to(ACT_DTYPE) * silu(z)
    _store_state(cache, _new_conv_tail(xp, off, T, lengths, mode, sc.d_conv),
                 h)
    return dense(p["out_proj"], y, ft=ft, site="out.o")


# ---------------------------------------------------------------- RG-LRU ----

def init_rglru(gen, cfg: ModelConfig, repeat: int) -> dict:
    rc, D, dev = cfg.rglru, cfg.d_model, gen.device
    w = rc.lru_width or D

    def proj(n_in, n_out, bias=False):
        q = {"w": he_init(gen, (repeat, n_in, n_out), n_in)}
        if bias:
            q["b"] = torch.zeros((repeat, n_out), device=dev)
        return q

    return {
        "norm": init_norm(cfg, (repeat, D), dev),
        "in_x": proj(D, w),
        "in_gate": proj(D, w),
        "conv_w": he_init(gen, (repeat, w, rc.d_conv), rc.d_conv),
        "conv_b": torch.zeros((repeat, w), device=dev),
        "w_a": proj(w, w, bias=True),
        "w_i": proj(w, w, bias=True),
        "lam": torch.full((repeat, w), 4.0, device=dev),
        "out": proj(w, D),
    }


def init_rglru_cache(cfg: ModelConfig, repeat: int, batch: int, max_seq: int,
                     device) -> dict:
    rc = cfg.rglru
    w = rc.lru_width or cfg.d_model
    return {"conv": torch.zeros((repeat, batch, rc.d_conv - 1, w),
                                dtype=ACT_DTYPE, device=device),
            "h": torch.zeros((repeat, batch, w), dtype=torch.float32,
                             device=device)}


def apply_rglru(p, x: torch.Tensor, *, cfg: ModelConfig, cache, pos,
                mode: str, lengths=None, ft=None):
    """RG-LRU mixer (RecurrentGemma), writing its conv tail and state into
    ``cache`` in place. ``in_gate`` / ``in_x`` project the same normed
    input, one protected fanout group (``qkv.gate``, ``qkv.in``); the
    gate goes through ``gelu``, the input through the causal conv, then
    the unprotected bf16 gates ``w_a`` / ``w_i`` and the scan
    h = a * h + sqrt(1 - a^2) * (i * u); ``out`` is ``out.o``. ``pos``,
    ``lengths``, the gating of pad steps and train mode (one scan over
    the whole sequence) as in :func:`apply_mamba`."""
    rc = cfg.rglru
    B, T, _ = x.shape
    w = rc.lru_width or cfg.d_model
    off = 0 if mode == "decode" else prefill_off(pos)
    h_in = apply_norm(p["norm"], x, cfg)
    gate_p, u = dense_fanout((p["in_gate"], p["in_x"]), h_in, ft=ft,
                             sites=("qkv.gate", "qkv.in"))
    gate = gelu(gate_p)
    up = _conv_inputs(cache, u, off, mode, rc.d_conv)
    u = (_causal_conv(up, p["conv_w"], T)
         + p["conv_b"].to(torch.float32)).to(ACT_DTYPE)

    r = torch.sigmoid(dense(p["w_a"], u).to(torch.float32))
    i = torch.sigmoid(dense(p["w_i"], u).to(torch.float32))
    log_a = rc.c * r * log_sigmoid(p["lam"].to(torch.float32))
    a = torch.exp(log_a)
    inp = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u.to(torch.float32))
    valid = (_prefill_valid(off, T, lengths, time_major=True)
             if mode == "prefill" else None)  # [T, B]
    h = _state_in(cache, off, mode, (B, w), x.device)
    hs, h = _lru_scan(a, inp, h, valid)
    rec = hs.to(ACT_DTYPE)
    _store_state(cache, _new_conv_tail(up, off, T, lengths, mode, rc.d_conv),
                 h)
    return dense(p["out"], rec * gate, ft=ft, site="out.o")
