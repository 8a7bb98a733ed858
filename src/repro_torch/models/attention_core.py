"""Attention core of the port: causal and sliding-window prefill (one
shared offset, or one offset per row for token-packed prefill), the
rolling-window prefill against a cache plus the chunk's own keys, and
single-position decode (the decoder part of
:mod:`repro.models.attention_core`).

Heads layout is GQA-grouped, as in the reference: q ``[B, Hkv, G, T, dk]``,
k ``[B, Hkv, S, dk]``, v ``[B, Hkv, S, dv]``; outputs are float32
``[B, Hkv, G, T, dv]``. Scores are materialized (explicit matmul, mask,
softmax) in float32 — the reference's own path for every problem with
``T * S <= 2048**2 / 4`` and for decode. Past that, :func:`attend` takes
the reference's blocked forward (:func:`_flash_fwd`: query blocks of 512,
each with an online softmax over the key blocks of its band), so the
scores never grow as T * S and the sums are the reference's (whisper's
encoder, 1500 frames against 1500), and its blocked backward
(:func:`_flash_bwd`) recomputes each block's probabilities from the saved
logsumexp, so training past that limit never forms [T, S] either.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEG = -1e30
# the reference's materialization limit: T * S <= FLASH_THRESHOLD**2 / 4
# scores at once; the rolling-window prefill bands its queries beyond it
FLASH_THRESHOLD = 2048
DEFAULT_QB = 512
DEFAULT_KB = 512
# the card's attention GEMMs take their queries in blocks of this many
# (_softmax_attend)
Q_BLOCK = 16
# ... and their batch rows in slabs of this many (layers.ABSORB_ROWS, the
# engine's default slot count): cuBLAS picks a batched GEMM's kernel by
# its batch count too (deepseek-v2-lite's MLA prefill scores, 192 wide,
# got other bits at 4 rows than at 8 on the H100)
B_SLAB = 8


class MaskInfo(NamedTuple):
    kind: str  # causal | window | full
    kv_len: int = 0  # true (unpadded) kv length; 0 = all
    q_off: int = 0  # absolute position of query 0
    window: int = 0  # kind "window": keys in (q - window, q]


def _mask(info: MaskInfo, T: int, S: int, device) -> Optional[torch.Tensor]:
    """Boolean [T, S] mask from absolute positions, or None (attend all)."""
    return _block_mask(info, torch.arange(T, device=device) + info.q_off,
                       torch.arange(S, device=device))


def _block_mask(info: MaskInfo, qpos: torch.Tensor,
                kpos: torch.Tensor) -> Optional[torch.Tensor]:
    """Boolean [len(qpos), len(kpos)] mask of the queries at absolute
    positions ``qpos`` against the keys at ``kpos``, or None (attend
    all)."""
    ok = (kpos[None, :] < info.kv_len) if info.kv_len else None
    if info.kind == "full":
        return ok
    if info.kind not in ("causal", "window"):
        raise NotImplementedError(f"mask kind {info.kind!r} is not ported yet")
    causal = kpos[None, :] <= qpos[:, None]
    if info.kind == "window":
        causal &= kpos[None, :] > qpos[:, None] - info.window
    return causal if ok is None else (causal & ok)


def _softmax_attend(q, k, v, ok, scale: float) -> torch.Tensor:
    """Masked softmax attention, scores and weighted sum in float32. On
    the card the batch rows go in slabs of :data:`B_SLAB` (the last slab
    padded with zero rows) and, within a slab, the queries in blocks of
    :data:`Q_BLOCK` (the last block padded with masked zero queries): one
    pair of GEMMs of one shape per block. cuBLAS picks its kernel by the
    query rows and by the batch count, so a decode step's single query got
    other bits than the same query inside a prefill chunk
    (recurrentgemma-2b's MQA, 10 query heads of 256 on one key head, on
    the H100), which a position's prefill / decode bit-identity (the
    fleet's prefix resume) cannot have, and a row's bits would depend on
    how many rows share the call (the engine split across ranks). The
    operands go in as contiguous float32 copies, so that every call hands
    cuBLAS one layout (a padded slab is a new tensor; a cache view is
    strided). A training forward (under autograd) keeps one pair of
    GEMMs."""
    if not q.is_cuda or q.requires_grad:
        return _softmax_block(q, k, v, ok, scale)
    q, k, v = (t.to(torch.float32, memory_format=torch.contiguous_format)
               for t in (q, k, v))
    B = q.shape[0]
    pad = (-B) % B_SLAB
    per_row = ok is not None and ok.dim() == 5 and ok.shape[0] != 1
    if pad:
        q, k, v = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                   for t in (q, k, v))
        if per_row:
            ok = torch.cat([ok, ok.new_zeros((pad,) + ok.shape[1:])])
    outs = [_query_blocks(q[i:i + B_SLAB], k[i:i + B_SLAB], v[i:i + B_SLAB],
                          ok[i:i + B_SLAB] if per_row else ok, scale)
            for i in range(0, B + pad, B_SLAB)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:B]


def _query_blocks(q, k, v, ok, scale: float) -> torch.Tensor:
    """:func:`_softmax_block` over the queries in blocks of
    :data:`Q_BLOCK`."""
    T = q.shape[3]
    pad = (-T) % Q_BLOCK
    if pad:
        q = torch.cat([q, q.new_zeros(q.shape[:3] + (pad,) + q.shape[4:])],
                      dim=3)
    if ok is not None and ok.shape[-2] != 1:
        if pad:
            ok = torch.cat([ok, ok.new_zeros(ok.shape[:-2]
                                             + (pad, ok.shape[-1]))], dim=-2)
        oks = [ok[..., i:i + Q_BLOCK, :] for i in range(0, T + pad, Q_BLOCK)]
    else:
        oks = [ok] * ((T + pad) // Q_BLOCK)
    outs = [_softmax_block(q[:, :, :, i * Q_BLOCK:(i + 1) * Q_BLOCK], k, v,
                           m, scale) for i, m in enumerate(oks)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out[:, :, :, :T]


def _softmax_block(q, k, v, ok, scale: float) -> torch.Tensor:
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if ok is not None:
        s = torch.where(ok, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))


def _pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """``x`` padded with zeros at the end of ``axis`` to a multiple of
    ``mult``."""
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _band(info: MaskInfo, iq: int, qb: int, kb: int, nk: int) -> tuple:
    """The key blocks [lo, hi) that query block ``iq`` can attend to:
    every one for kind ``full``, those up to its last query for causal,
    and for a window also none below its first query's window."""
    if info.kind == "full":
        return 0, nk
    hi = min(nk, -(-(info.q_off + (iq + 1) * qb) // kb))
    if info.kind == "window":
        return max(0, (info.q_off + iq * qb - info.window + 1) // kb), hi
    return 0, hi


def _flash_fwd(q, k, v, info: MaskInfo, scale: float, qb: int,
               kb: int) -> tuple:
    """The reference's blocked forward (``_flash_fwd_inner``): q
    [B,Hkv,G,T,dk] with T % qb == 0, k / v padded to multiples of kb (the
    pad keys masked by ``info.kv_len``). Query block by query block, an
    online softmax over the key blocks of its band, in float32: running
    max m, denominator l and accumulator, rescaled by exp(m - m_new) per
    key block; masked scores are NEG and their weights exact zeros.
    Returns (out [B,Hkv,G,T,dv] float32, logsumexp [B,Hkv,G,T])."""
    B, Hkv, G, T, _ = q.shape
    S, dv = k.shape[2], v.shape[-1]
    nk = S // kb
    outs, lses = [], []
    for iq in range(T // qb):
        qi = q[:, :, :, iq * qb:(iq + 1) * qb].to(torch.float32)
        qpos = info.q_off + iq * qb + torch.arange(qb, device=q.device)
        m = torch.full((B, Hkv, G, qb), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, qb, dv), dtype=torch.float32,
                          device=q.device)
        lo, hi = _band(info, iq, qb, kb, nk)
        for jk in range(lo, hi):
            kj = k[:, :, jk * kb:(jk + 1) * kb].to(torch.float32)
            vj = v[:, :, jk * kb:(jk + 1) * kb].to(torch.float32)
            kpos = jk * kb + torch.arange(kb, device=q.device)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            mask = _block_mask(info, qpos, kpos)
            if mask is not None:
                s = torch.where(mask, s, torch.full_like(s, NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if mask is not None:
                p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vj)
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


def _flash_bwd(q, k, v, out, lse, dout, info: MaskInfo, scale: float,
               qb: int, kb: int) -> tuple:
    """The reference's blocked backward (``_flash_bwd``): the probabilities
    of each (query block, key block) pair of a band are recomputed from the
    saved logsumexp, so no [T, S] tensor is formed. dq query block by
    query block over its band's key blocks; dk / dv key block by key block
    over the query blocks whose band holds it. Sums in float32; returns
    (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Hkv, G, T, dk = q.shape
    S, dv = k.shape[2], v.shape[-1]
    nq, nk = T // qb, S // kb
    dout = dout.to(torch.float32)
    D = (dout * out).sum(dim=-1)  # [B,Hkv,G,T]
    f32 = torch.float32

    def q_blk(iq):
        sl = slice(iq * qb, (iq + 1) * qb)
        return (q[:, :, :, sl].to(f32), dout[:, :, :, sl], lse[..., sl],
                D[..., sl], info.q_off + iq * qb + torch.arange(
                    qb, device=q.device))

    def k_blk(jk):
        sl = slice(jk * kb, (jk + 1) * kb)
        return k[:, :, sl].to(f32), v[:, :, sl].to(f32)

    def probs(qi, lse_i, qpos, kj, jk):
        kpos = jk * kb + torch.arange(kb, device=q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
        mask = _block_mask(info, qpos, kpos)
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, NEG))
        p = torch.exp(s - lse_i[..., None])
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        return p

    dq_blocks = []
    for iq in range(nq):
        qi, do_i, lse_i, D_i, qpos = q_blk(iq)
        dq_i = torch.zeros((B, Hkv, G, qb, dk), dtype=f32, device=q.device)
        lo, hi = _band(info, iq, qb, kb, nk)
        for jk in range(lo, hi):
            kj, vj = k_blk(jk)
            p = probs(qi, lse_i, qpos, kj, jk)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_i, vj)
            ds = p * (dp - D_i[..., None])
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds, kj)
        dq_blocks.append(dq_i * scale)
    bands = [_band(info, iq, qb, kb, nk) for iq in range(nq)]
    dk_blocks, dv_blocks = [], []
    for jk in range(nk):
        kj, vj = k_blk(jk)
        dk_j = torch.zeros((B, Hkv, kb, dk), dtype=f32, device=q.device)
        dv_j = torch.zeros((B, Hkv, kb, dv), dtype=f32, device=q.device)
        for iq in (i for i, (lo, hi) in enumerate(bands) if lo <= jk < hi):
            qi, do_i, lse_i, D_i, qpos = q_blk(iq)
            p = probs(qi, lse_i, qpos, kj, jk)
            dv_j = dv_j + torch.einsum("bhgqk,bhgqd->bhkd", p, do_i)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_i, vj)
            ds = p * (dp - D_i[..., None])
            dk_j = dk_j + torch.einsum("bhgqk,bhgqd->bhkd", ds, qi)
        dk_blocks.append(dk_j * scale)
        dv_blocks.append(dv_j)
    return (torch.cat(dq_blocks, dim=3).to(q.dtype),
            torch.cat(dk_blocks, dim=2).to(k.dtype),
            torch.cat(dv_blocks, dim=2).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The blocked forward, saving (q, k, v, out, lse), and the blocked
    backward (the reference's ``flash_attention`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, info, scale, qb, kb):
        out, lse = _flash_fwd(q, k, v, info, scale, qb, kb)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (info, scale, qb, kb)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _flash_bwd(*ctx.saved_tensors, dout, *ctx.args) + (
            None,) * 4


def flash_attention(q, k, v, info: MaskInfo, scale: float, qb: int,
                    kb: int) -> torch.Tensor:
    """Blocked attention of padded q [B,Hkv,G,T,dk] (T % qb == 0) against k
    / v padded to multiples of kb, with the blocked backward under
    autograd: [B,Hkv,G,T,dv] float32."""
    return _FlashAttention.apply(q, k, v, info, scale, qb, kb)


def attend(q, k, v, *, kind: str, kv_len: int = 0,
           scale: Optional[float] = None, q_off: int = 0,
           window: int = 0) -> torch.Tensor:
    """q [B,Hkv,G,T,dk], k [B,Hkv,S,dk], v [B,Hkv,S,dv] -> [B,Hkv,G,T,dv]
    (float32). ``q_off`` is the absolute position of query 0; kind
    ``window`` attends to the keys in (q - window, q]. Scores are
    materialized while ``T * S <= 2048**2 / 4`` or T == 1, as in the
    reference; past that the queries and keys are padded to blocks of
    512 and go through its blocked forward and, under autograd, its
    blocked backward (:func:`flash_attention`)."""
    T, S = q.shape[3], k.shape[2]
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    if T * S <= FLASH_THRESHOLD * FLASH_THRESHOLD // 4 or T == 1:
        ok = _mask(MaskInfo(kind, kv_len or 0, q_off, window), T, S,
                   q.device)
        return _softmax_attend(q, k, v, ok, scale)
    qb, kb = DEFAULT_QB, DEFAULT_KB
    out = flash_attention(_pad_axis(q, 3, qb), _pad_axis(k, 2, kb),
                          _pad_axis(v, 2, kb),
                          MaskInfo(kind, kv_len or S, q_off, window), scale,
                          qb, kb)
    return out[:, :, :, :T]


def _prefill_window_inner(q, k, v, qpos, kabs, window: int, scale: float):
    """Materialized attention masked on absolute positions: ``qpos`` [T]
    (one shared offset) or [B, T] (per row), ``kabs`` [B, S] (-1 = not a
    key); a key is attended iff it lies in (q - window, q]."""
    ka = kabs[:, None, None, None, :]
    qp = (qpos[:, None, None, :, None] if qpos.dim() == 2
          else qpos[None, None, None, :, None])
    ok = (ka >= 0) & (ka <= qp)
    if window:
        ok = ok & (ka > qp - window)
    return _softmax_attend(q, k, v, ok, scale)


def attend_prefill_window(q, k, v, *, qpos: torch.Tensor, kabs: torch.Tensor,
                          window: int, scale: Optional[float] = None,
                          qb: int = DEFAULT_QB,
                          slots: bool = False) -> torch.Tensor:
    """Bucketed, chunked or token-packed prefill of a rolling-window layer.

    q [B,Hkv,G,T,dk] are the chunk's queries at absolute positions
    ``qpos`` ([T], or [B, T] per row); k/v [B,Hkv,S,*] are the rolling
    cache's S_c = S - T slots (earlier chunks, slot order) followed by the
    chunk's own T keys in position order, or with ``slots`` the buffer
    alone (S slots) with the chunk already written; ``kabs`` [B, S] holds
    each key's absolute position (-1: an empty slot, or a pad past the
    row's prompt). The buffer's slot order is undone by masking on
    absolute positions, as at decode. Past the reference's materialization
    limit the queries go in bands of ``qb``: band [i0, i1) needs only the
    cache slots and the chunk keys (i0 - window, i1), so the scores never
    grow as T * S."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    T, S = q.shape[3], k.shape[2]
    if T * S <= FLASH_THRESHOLD * FLASH_THRESHOLD // 4:
        return _prefill_window_inner(q, k, v, qpos, kabs, window, scale)
    if slots:  # every band against the whole buffer
        return torch.cat([_prefill_window_inner(
            q[:, :, :, i0:i0 + qb], k, v, qpos[..., i0:i0 + qb], kabs,
            window, scale) for i0 in range(0, T, qb)], dim=3)
    S_c = S - T
    outs = []
    for i0 in range(0, T, qb):
        i1 = min(i0 + qb, T)
        lo = S_c + max(0, i0 - window + 1)
        ks = torch.cat([k[:, :, :S_c], k[:, :, lo:S_c + i1]], dim=2)
        vs = torch.cat([v[:, :, :S_c], v[:, :, lo:S_c + i1]], dim=2)
        kab = torch.cat([kabs[:, :S_c], kabs[:, lo:S_c + i1]], dim=1)
        outs.append(_prefill_window_inner(
            q[:, :, :, i0:i1], ks, vs, qpos[..., i0:i1], kab, window, scale))
    return torch.cat(outs, dim=3)


def attend_prefill_packed(q, k, v, *, qpos: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causal prefill attention with one query offset per row (token-packed
    serving, where every row is a different request's chunk): row b's
    queries sit at absolute positions ``qpos[b]`` ([B, T]); k/v
    [B,Hkv,S,*] are each row's FULL linear cache (slot s holds position s)
    with the chunk's keys already written at ``qpos``. A key is attended
    iff its position is at most the query's, so keys past a row's written
    prefix drop out by causality; their scores are NEG and softmax to
    exact 0.0."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    kpos = torch.arange(k.shape[2], device=q.device)
    ok = kpos[None, None, None, None, :] <= qpos[:, None, None, :, None]
    return _softmax_attend(q, k, v, ok, scale)


def attend_decode(q, k, v, *, abs_pos: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Single-position decode: q [B,Hkv,G,1,dk] against the cache k/v
    [B,Hkv,S,*]. ``abs_pos`` is [S] (shared) or [B, S] (per-row) absolute
    position of each cache slot, -1 where the slot is not valid."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    ok = abs_pos >= 0
    ok = ok[None, None, None, None, :] if ok.dim() == 1 \
        else ok[:, None, None, None, :]
    return _softmax_attend(q, k, v, ok, scale)
