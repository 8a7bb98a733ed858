"""Model API of the port, decoder-only: the dense, MoE, SSM (Mamba-1) and
hybrid (RG-LRU + rolling-window attention) families (the serving part of
:mod:`repro.models.api`, and training for the dense decoder)::

    model = get_model(cfg)
    params = model.init(gen, cfg, max_seq, device=dev)  # gen: torch.Generator
    logits = model.forward_train(params, batch, cfg)    # [B, T, V] float32
    loss = lm_loss(logits, batch, cfg)
    cache = model.init_cache(cfg, batch, max_seq, device=dev)
    h, cache = model.prefill_chunk(params, tokens, cfg, cache,
                                   pos0=0, lengths=lens, ft=ctx)  # [B, C, D]
    h, cache = model.prefill_packed(params, tokens, cfg, rows,
                                    pos0=offs, lengths=lens, ft=ctx)
    h, cache = model.decode_hidden(params, tok, cache, pos, cfg, ft=ctx)
    logits = model.head_project(params, h, cfg)                     # [B, V]
    logits, cache = model.prefill(params, {"tokens": t}, cfg, cache)  # [B, V]
    logits, cache = model.decode_step(params, tok, cache, pos, cfg)   # [B, V]

``decode_hidden`` takes ``pos`` as a per-row position vector [B] and
returns the final-norm'd hidden states [B, D] before the vocab projection,
so serving can route the head through the protected entangled GEMM.
``prefill_packed`` is the token-packed prefill: every row of tokens [R, C]
is one chunk of a different request at its own offset ``offs`` [R].
``prefill`` (a whole prompt from position 0) and ``decode_step`` (one
token at an int or per-row position) return logits; they are the entries
of the unprotected per-slot baseline engine.
``ft`` is an :class:`~repro_torch.ft.FTContext` threaded to every
protected projection. Caches are written in place; the returned cache is
the one passed in.

``init`` and ``init_cache`` run on CUDA unless ``device`` says otherwise
(and raise when no GPU is present). ``init`` draws from the given
``torch.Generator``, on the generator's device, and moves the result to
``device``: the reference's ``jax.random`` weights cannot be reproduced,
so tests bridge the reference's params instead (:mod:`repro_torch.bridge`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


class Model(NamedTuple):
    init: Callable
    forward_train: Callable  # (params, batch, cfg) -> float32 logits [B, T, V]
    prefill_chunk: Callable
    prefill_packed: Callable
    decode_hidden: Callable
    head_project: Callable  # (params, h [B, D], cfg) -> logits [B, V]
    head_weights: Callable  # (params, cfg) -> [D, V] float32
    init_cache: Callable
    prefill: Callable  # (params, {"tokens": [B, T]}, cfg, cache) -> logits
    decode_step: Callable  # (params, tok, cache, pos, cfg) -> logits


def _init(gen: torch.Generator, cfg: ModelConfig, max_seq: int,
          device=None) -> dict:
    dev = resolve_device(device)
    p = {"embed": T.init_embed(gen, cfg), "stack": T.init_stack(gen, cfg)}
    return tree_map(lambda t: t.to(dev), p)


def _init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return T.init_stack_cache(cfg, batch, max_seq, resolve_device(device))


def _forward_train(p, batch, cfg: ModelConfig):
    """Logits of a training batch ``{"tokens": [B, T]}``: the whole
    sequence, causal, no cache (the dense decoder; MLA, MoE, local
    attention, Mamba and RG-LRU blocks raise "not ported yet" in train
    mode). The params may be autograd leaves."""
    if cfg.mtp:
        raise NotImplementedError("the MTP head is not ported yet")
    x = T.embed_tokens(p["embed"], batch["tokens"], cfg)
    h = T.apply_stack(p["stack"], x, cfg=cfg, mode="train")
    return T.logits_head(p["embed"], h, cfg)


def _prefill_chunk(p, tokens, cfg: ModelConfig, cache, *, pos0: int = 0,
                   lengths=None, ft=None):
    """Batched prefill of tokens [B, C] at positions pos0..pos0+C-1.
    ``lengths`` [B] (the rows' true prompt lengths) keep the MoE blocks'
    pad tokens out of expert capacity, hold the recurrent blocks' state
    over pad steps and keep pads out of the rolling window's buffer; the
    linear KV and latent caches store the bucket padding like the
    reference."""
    x = T.embed_tokens(p["embed"], tokens, cfg)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache, pos=pos0,
                      mode="prefill", lengths=lengths, ft=ft)
    return T.final_hidden(p["embed"], h, cfg), cache


def _prefill_packed(p, tokens, cfg: ModelConfig, cache, *, pos0,
                    lengths=None, ft=None):
    """Token-packed prefill: tokens [R, C] where every row is one chunk of
    a different request, row r at positions pos0[r]..pos0[r]+C-1 (``pos0``
    an int vector [R]); ``lengths`` [R] are the rows' true prompt lengths
    and ``cache`` holds the R rows' own state (the engine gathers them from
    its staging cache). The linear caches are written per row and attended
    over their full extent under a per-row causal mask. Returns the
    final-norm'd hidden states [R, C, D] and the cache."""
    x = T.embed_tokens(p["embed"], tokens, cfg)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache,
                      pos=torch.as_tensor(pos0, device=tokens.device),
                      mode="prefill", lengths=lengths, ft=ft)
    return T.final_hidden(p["embed"], h, cfg), cache


def _decode_hidden(p, tok, cache, pos, cfg: ModelConfig, ft=None):
    x = T.embed_tokens(p["embed"], tok, cfg)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache, pos=pos,
                      mode="decode", ft=ft)
    return T.final_hidden(p["embed"], h, cfg)[:, 0], cache


def _prefill(p, batch, cfg: ModelConfig, cache):
    """A whole prompt batch ``{"tokens": [B, T]}`` from position 0, no
    padding: the logits [B, V] of its last position and the cache."""
    h, cache = _prefill_chunk(p, batch["tokens"], cfg, cache)
    return T.head_project(p["embed"], h[:, -1], cfg), cache


def _decode_step(p, tok, cache, pos, cfg: ModelConfig):
    """One token per row, tok [B, 1], at ``pos`` (an int shared by every
    row, or a per-row vector [B]): the logits [B, V] and the cache."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tok.device)
    if pos.dim() == 0:
        pos = pos.expand(tok.shape[0])
    h, cache = _decode_hidden(p, tok, cache, pos, cfg)
    return T.head_project(p["embed"], h, cfg), cache


def _head_project(p, h, cfg: ModelConfig):
    return T.head_project(p["embed"], h, cfg)


def _head_weights(p, cfg: ModelConfig):
    return T.head_weights(p["embed"], cfg)


DECODER_MODEL = Model(init=_init, forward_train=_forward_train,
                      prefill_chunk=_prefill_chunk,
                      prefill_packed=_prefill_packed,
                      decode_hidden=_decode_hidden,
                      head_project=_head_project, head_weights=_head_weights,
                      init_cache=_init_cache, prefill=_prefill,
                      decode_step=_decode_step)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet")
    return DECODER_MODEL


# ------------------------------------------------------------------- loss ----

def lm_loss(logits: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross entropy over the batch's ``loss_mask`` (all ones
    when absent): the reference's ``loss_impl='naive'`` (a float32
    log-softmax over the whole vocab). The streamed CE and the MTP term
    are not ported yet."""
    if cfg.loss_impl != "naive":
        raise NotImplementedError(
            f"loss_impl={cfg.loss_impl!r} is not ported yet (only 'naive')")
    if isinstance(logits, tuple):
        raise NotImplementedError("the MTP loss term is not ported yet")
    tokens = batch["tokens"]
    full_mask = batch.get("loss_mask")
    if full_mask is None:
        full_mask = torch.ones_like(tokens)
    mask = full_mask[:, 1:].to(torch.float32)
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ll = torch.take_along_dim(lp, tokens[:, 1:, None].to(torch.int64),
                              dim=-1)[..., 0]
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
