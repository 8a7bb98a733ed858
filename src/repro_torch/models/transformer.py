"""Decoder assembly: stacked layer params, embedding and head (port of
the decoder part of :mod:`repro.models.transformer`).

Blocks (``cfg.layer_pattern()`` names them), each with its cache:

  attn_dense  GQA attention (or MLA if cfg.mla) + MLP (gated, or ungated)
  attn_moe    GQA attention (or MLA if cfg.mla) + MoE FFN
  local_attn  rolling-window GQA/MQA attention + gated MLP
  mamba       Mamba-1 selective-SSM mixer (no MLP)
  rglru       RG-LRU recurrent mixer + gated MLP

Params keep the reference's stacked layout — a list over pattern units,
each a tuple (one entry per block of the unit) of dicts whose leaves carry
a leading ``[repeat]`` axis — so that the reference's params bridge over
leaf for leaf. The reference runs a unit with ``lax.scan``; here a Python
loop walks the stack, handing each layer views of its slice of the params
and of the cache (or, in train mode, autograd views of the stacked
leaves).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.tree import leaves, unflatten


def _init_attn(gen, cfg: ModelConfig, repeat: int) -> dict:
    return (L.init_mla if cfg.mla else L.init_attention)(gen, cfg, repeat)


def _attend(p, x, *, cfg, cache, pos, mode, ft):
    """The block's mixer and its residual: MLA or GQA attention."""
    if cfg.mla:
        a, _ = L.apply_mla(p["attn"], x, cfg=cfg, cache=cache, pos=pos,
                           mode=mode, ft=ft)
    else:
        a, _ = L.apply_attention(p["attn"], x, cfg=cfg, cache=cache, pos=pos,
                                 mode=mode, rope_theta=cfg.rope_theta, ft=ft)
    return x + a


def _init_attn_dense(gen, cfg, repeat):
    return {"attn": _init_attn(gen, cfg, repeat),
            "mlp": L.init_mlp(gen, cfg, repeat,
                              gated=cfg.norm_kind == "rmsnorm")}


def _apply_attn_dense(p, x, *, cfg, cache, pos, mode, lengths, ft):
    x = _attend(p, x, cfg=cfg, cache=cache, pos=pos, mode=mode, ft=ft)
    return x + L.apply_mlp(p["mlp"], x, cfg=cfg, ft=ft)


def _init_attn_moe(gen, cfg, repeat):
    return {"attn": _init_attn(gen, cfg, repeat),
            "moe": L.init_moe(gen, cfg, repeat)}


def _apply_attn_moe(p, x, *, cfg, cache, pos, mode, lengths, ft):
    x = _attend(p, x, cfg=cfg, cache=cache, pos=pos, mode=mode, ft=ft)
    # bucket padding: pad tokens must not take expert capacity (per row
    # under token packing, where every row has its own offset)
    valid = (L._prefill_valid(L.prefill_off(pos), x.shape[1], lengths)
             if mode == "prefill" else None)
    return x + L.apply_moe(p["moe"], x, cfg=cfg, valid=valid, ft=ft)


def _init_local_attn(gen, cfg, repeat):
    return {"attn": L.init_attention(gen, cfg, repeat),
            "mlp": L.init_mlp(gen, cfg, repeat)}


def _apply_local_attn(p, x, *, cfg, cache, pos, mode, lengths, ft):
    a, _ = L.apply_attention(p["attn"], x, cfg=cfg, cache=cache, pos=pos,
                             mode=mode, rope_theta=cfg.rope_theta,
                             window=cfg.local_window, lengths=lengths, ft=ft)
    x = x + a
    return x + L.apply_mlp(p["mlp"], x, cfg=cfg, ft=ft)


def _apply_mamba(p, x, *, cfg, cache, pos, mode, lengths, ft):
    return x + L.apply_mamba(p, x, cfg=cfg, cache=cache, pos=pos, mode=mode,
                             lengths=lengths, ft=ft)


def _init_rglru(gen, cfg, repeat):
    return {"rec": L.init_rglru(gen, cfg, repeat),
            "mlp": L.init_mlp(gen, cfg, repeat)}


def _apply_rglru(p, x, *, cfg, cache, pos, mode, lengths, ft):
    x = x + L.apply_rglru(p["rec"], x, cfg=cfg, cache=cache, pos=pos,
                          mode=mode, lengths=lengths, ft=ft)
    return x + L.apply_mlp(p["mlp"], x, cfg=cfg, ft=ft)


def _attn_cache(cfg, repeat, batch, max_seq, device):
    """MLA's latent cache, or the linear KV cache."""
    init = L.init_mla_cache if cfg.mla else L.init_attn_cache
    return init(cfg, repeat, batch, max_seq, device)


def _window_cache(cfg, repeat, batch, max_seq, device):
    return L.init_attn_cache(cfg, repeat, batch, max_seq, device,
                             window=cfg.local_window)


class Block(NamedTuple):
    init: Callable  # (gen, cfg, repeat) -> stacked params
    apply: Callable  # (params, x, *, cfg, cache, pos, mode, lengths, ft) -> x
    init_cache: Callable  # (cfg, repeat, batch, max_seq, device) -> cache


BLOCKS = {
    "attn_dense": Block(_init_attn_dense, _apply_attn_dense, _attn_cache),
    "attn_moe": Block(_init_attn_moe, _apply_attn_moe, _attn_cache),
    "local_attn": Block(_init_local_attn, _apply_local_attn, _window_cache),
    "mamba": Block(L.init_mamba, _apply_mamba, L.init_mamba_cache),
    "rglru": Block(_init_rglru, _apply_rglru, L.init_rglru_cache),
}


def _check_pattern(cfg: ModelConfig):
    pat = cfg.layer_pattern()
    for blocks, _ in pat:
        for b in blocks:
            if b not in BLOCKS:
                raise NotImplementedError(
                    f"block {b!r} ({cfg.name}) is not ported yet")
    return pat


def init_stack(gen, cfg: ModelConfig) -> list:
    return [tuple(BLOCKS[b].init(gen, cfg, repeat) for b in blocks)
            for blocks, repeat in _check_pattern(cfg)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     device) -> list:
    """Every block's cache, stacked per pattern unit like the params (the
    slot on axis 1 of every leaf): the attention blocks' KV or latent
    cache, a rolling buffer for ``local_attn``, the conv tail and state h
    of a recurrent block."""
    return [tuple(BLOCKS[b].init_cache(cfg, repeat, batch, max_seq, device)
                  for b in blocks)
            for blocks, repeat in _check_pattern(cfg)]


def layer_views(tree, repeat: int) -> list:
    """Per-layer views of a stacked subtree (every leaf ``[repeat, ...]``):
    one ``unbind`` per leaf, so that under autograd a stack's gradient is
    gathered by one node instead of one full-size scatter per layer."""
    per_leaf = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [u[i] for u in per_leaf]) for i in range(repeat)]


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat='dots'``: keep the matmuls' outputs, recompute the rest
    (the counterpart of ``checkpoint_dots_with_no_batch_dims``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """``body(x)`` under ``remat``'s activation checkpointing: 'none' runs
    it as it is, 'dots' saves only the matmul outputs, any other value
    saves nothing (the reference's ``nothing_saveable``)."""
    if remat == "none":
        return body
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda x: checkpoint(body, x, use_reentrant=False, **kw)


def apply_stack(units_params, x, *, cfg: ModelConfig, caches=None, pos=None,
                mode: str, lengths=None, ft=None):
    """Run every layer of every pattern unit in order. ``mode`` is
    ``prefill`` / ``decode`` (the caches are written in place) or
    ``train`` (no caches; the params may be autograd leaves; each unit's
    body per repeat under ``cfg.remat``'s activation checkpointing, as the
    reference's scan body). In prefill
    ``pos`` is the chunk offset shared by every row, or a per-row offset
    vector [B] (token-packed prefill: with the chunk width it gives every
    row its own [T] position grid). ``lengths`` [B] (bucketed prefill)
    are the rows' true prompt lengths. Each layer
    gets its slice of the stacked params — startup-quantized q8 stacks
    included, so an expert stack's scales ``[repeat, E]`` reach the grouped
    site as ``[E]``. Returns the hidden states."""
    if mode == "train" and caches is not None:
        raise ValueError("train mode takes no caches")
    remat = cfg.remat if mode == "train" else "none"
    for u, (blocks, repeat) in enumerate(_check_pattern(cfg)):
        p_u = [layer_views(p, repeat) for p in units_params[u]]
        c_u = ([layer_views(c, repeat) for c in caches[u]]
               if caches is not None
               else [[None] * repeat for _ in blocks])
        for i in range(repeat):
            # bound now: a checkpoint calls the body again in the backward
            body = functools.partial(
                _unit_body, blocks, [p[i] for p in p_u], [c[i] for c in c_u],
                cfg=cfg, pos=pos, mode=mode, lengths=lengths, ft=ft)
            x = _remat(body, remat)(x)
    return x


def _unit_body(blocks, ps, cs, x, **kw):
    """One repeat of a pattern unit: its blocks in order."""
    for name, p, c in zip(blocks, ps, cs):
        x = BLOCKS[name].apply(p, x, cache=c, **kw)
    return x


# ---- embeddings / head ------------------------------------------------------

def init_embed(gen, cfg: ModelConfig, max_seq: int) -> dict:
    """Token embedding, final norm, the head unless tied, and for a
    layernorm model (whisper) learned positions ``pos`` [max_seq, D]."""
    p = {"tok": L.bf16_read_init(gen, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model),
         "final_norm": L.init_norm(cfg, (cfg.d_model,), gen.device)}
    if not cfg.tie_embeddings:
        p["head"] = L.bf16_read_init(gen, (cfg.d_model, cfg.vocab_size),
                                     cfg.d_model)
    if cfg.norm_kind == "layernorm":
        p["pos"] = L.he_init(gen, (max_seq, cfg.d_model), cfg.d_model)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 pos=None) -> torch.Tensor:
    """bfloat16 embeddings of ``tokens`` [B, T], plus the learned
    position embeddings where the model has them: positions 0..T-1 when
    ``pos`` is None, else from ``pos``: a per-row vector [B] (decode, T ==
    1), a [B, T] grid (token-packed prefill) or an int offset."""
    x = p["tok"][tokens].to(L.ACT_DTYPE)
    if "pos" not in p:
        return x
    T = tokens.shape[1]
    if pos is None:
        pe = p["pos"][:T][None]
    elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pe = p["pos"][pos][:, None]
    elif isinstance(pos, torch.Tensor) and pos.dim() == 2:
        pe = p["pos"][pos]
    else:  # an int offset
        pe = p["pos"][pos:pos + T][None]
    return x + pe.to(L.ACT_DTYPE)


def logits_head(p, x, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits of the final-norm'd hidden states (train mode)."""
    return head_project(p, final_hidden(p, x, cfg), cfg)


def final_hidden(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm'd hidden states — what the protected head quantizes."""
    return L.apply_norm(p["final_norm"], x, cfg)


def readout_scale(cfg: ModelConfig) -> float:
    """muP-style readout temperature shared by the plain and FT heads."""
    return 1.0 / math.sqrt(cfg.d_model)


def head_weights(p, cfg: ModelConfig) -> torch.Tensor:
    """The [D, V] head matrix (the embedding's transpose when tied)."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return w.to(torch.float32)


def head_project(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project final-norm'd hidden states [..., D] to float32 logits."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = torch.matmul(h.to(L.ACT_DTYPE), w.to(L.ACT_DTYPE))
    return (logits * readout_scale(cfg)).to(torch.float32)
