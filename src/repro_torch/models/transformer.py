"""Decoder assembly: stacked layer params, embedding and head (port of the
dense-decoder and MoE parts of :mod:`repro.models.transformer`).

Blocks (``cfg.layer_pattern()`` names them):

  attn_dense  GQA attention (or MLA if cfg.mla) + gated MLP
  attn_moe    GQA attention (or MLA if cfg.mla) + MoE FFN

Params keep the reference's stacked layout — a list over pattern units,
each a tuple (one entry per block of the unit) of dicts whose leaves carry
a leading ``[repeat]`` axis — so that the reference's params bridge over
leaf for leaf. The reference runs a unit with ``lax.scan``; here a Python
loop walks the stack, handing each layer views of its slice of the params
and of the cache (or, in train mode, autograd views of the stacked
leaves).
"""
from __future__ import annotations

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
            "mlp": L.init_mlp(gen, cfg, repeat)}


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


class Block(NamedTuple):
    init: Callable  # (gen, cfg, repeat) -> stacked params
    apply: Callable  # (params, x, *, cfg, cache, pos, mode, lengths, ft) -> x


BLOCKS = {
    "attn_dense": Block(_init_attn_dense, _apply_attn_dense),
    "attn_moe": Block(_init_attn_moe, _apply_attn_moe),
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
    """Both blocks cache their attention: the latent cache under MLA, the
    KV cache otherwise."""
    init = L.init_mla_cache if cfg.mla else L.init_attn_cache
    return [tuple(init(cfg, repeat, batch, max_seq, device) for _ in blocks)
            for blocks, repeat in _check_pattern(cfg)]


def _layers(tree, repeat: int) -> list:
    """Per-layer views of a stacked subtree (every leaf ``[repeat, ...]``):
    one ``unbind`` per leaf, so that under autograd a stack's gradient is
    gathered by one node instead of one full-size scatter per layer."""
    per_leaf = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [u[i] for u in per_leaf]) for i in range(repeat)]


def apply_stack(units_params, x, *, cfg: ModelConfig, caches=None, pos=None,
                mode: str, lengths=None, ft=None):
    """Run every layer of every pattern unit in order. ``mode`` is
    ``prefill`` / ``decode`` (the caches are written in place) or
    ``train`` (no caches; the params may be autograd leaves). In prefill
    ``pos`` is the chunk offset shared by every row, or a per-row offset
    vector [B] (token-packed prefill: with the chunk width it gives every
    row its own [T] position grid). ``lengths`` [B] (bucketed prefill)
    are the rows' true prompt lengths. Each layer
    gets its slice of the stacked params — startup-quantized q8 stacks
    included, so an expert stack's scales ``[repeat, E]`` reach the grouped
    site as ``[E]``. Returns the hidden states."""
    if mode == "train":
        if caches is not None:
            raise ValueError("train mode takes no caches")
        if cfg.remat != "none":
            raise NotImplementedError(
                f"remat={cfg.remat!r} is not ported yet (only 'none')")
    for u, (blocks, repeat) in enumerate(_check_pattern(cfg)):
        for b, name in enumerate(blocks):
            if mode == "train" and name != "attn_dense":
                raise NotImplementedError(
                    f"block {name!r} in train mode is not ported yet")
        p_u = [_layers(p, repeat) for p in units_params[u]]
        c_u = ([_layers(c, repeat) for c in caches[u]] if caches is not None
               else [[None] * repeat for _ in blocks])
        for i in range(repeat):
            for b, name in enumerate(blocks):
                x = BLOCKS[name].apply(p_u[b][i], x, cfg=cfg,
                                       cache=c_u[b][i], pos=pos, mode=mode,
                                       lengths=lengths, ft=ft)
    return x


# ---- embeddings / head ------------------------------------------------------

def init_embed(gen, cfg: ModelConfig) -> dict:
    p = {"tok": L.he_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model),
         "final_norm": {"scale": torch.ones((cfg.d_model,), device=gen.device)}}
    if not cfg.tie_embeddings:
        p["head"] = L.he_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens].to(L.ACT_DTYPE)


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
