"""Attention core of the port: causal prefill (one shared offset, or one
offset per row for token-packed prefill) and single-position decode (the
dense-decoder part of :mod:`repro.models.attention_core`).

Heads layout is GQA-grouped, as in the reference: q ``[B, Hkv, G, T, dk]``,
k ``[B, Hkv, S, dk]``, v ``[B, Hkv, S, dv]``; outputs are float32
``[B, Hkv, G, T, dv]``. Scores are materialized (explicit matmul, mask,
softmax) in float32 — the reference's own path for every problem with
``T * S <= 2048**2 / 4`` and for decode. Its flash-style blocked path for
longer prompts computes the same function and is not needed by the
serving shapes of this slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEG = -1e30


class MaskInfo(NamedTuple):
    kind: str  # causal | full
    kv_len: int = 0  # true (unpadded) kv length; 0 = all
    q_off: int = 0  # absolute position of query 0


def _mask(info: MaskInfo, T: int, S: int, device) -> Optional[torch.Tensor]:
    """Boolean [T, S] mask from absolute positions, or None (attend all)."""
    kpos = torch.arange(S, device=device)
    ok = (kpos[None, :] < info.kv_len) if info.kv_len else None
    if info.kind == "full":
        return ok
    if info.kind != "causal":
        raise NotImplementedError(f"mask kind {info.kind!r} is not ported yet")
    qpos = torch.arange(T, device=device) + info.q_off
    causal = kpos[None, :] <= qpos[:, None]
    return causal if ok is None else (causal & ok)


def _softmax_attend(q, k, v, ok, scale: float) -> torch.Tensor:
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if ok is not None:
        s = torch.where(ok, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))


def attend(q, k, v, *, kind: str, kv_len: int = 0,
           scale: Optional[float] = None, q_off: int = 0) -> torch.Tensor:
    """q [B,Hkv,G,T,dk], k [B,Hkv,S,dk], v [B,Hkv,S,dv] -> [B,Hkv,G,T,dv]
    (float32). ``q_off`` is the absolute position of query 0."""
    T, S = q.shape[3], k.shape[2]
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    ok = _mask(MaskInfo(kind, kv_len or 0, q_off), T, S, q.device)
    return _softmax_attend(q, k, v, ok, scale)


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
