"""Model API of the port, decoder-only: the dense and MoE families (the
serving part of :mod:`repro.models.api`)::

    model = get_model(cfg)
    params = model.init(gen, cfg, max_seq, device=dev)  # gen: torch.Generator
    cache = model.init_cache(cfg, batch, max_seq, device=dev)
    h, cache = model.prefill_chunk(params, tokens, cfg, cache,
                                   pos0=0, lengths=lens, ft=ctx)  # [B, C, D]
    h, cache = model.decode_hidden(params, tok, cache, pos, cfg, ft=ctx)
    logits = model.head_project(params, h, cfg)                     # [B, V]

``decode_hidden`` takes ``pos`` as a per-row position vector [B] and
returns the final-norm'd hidden states [B, D] before the vocab projection,
so serving can route the head through the protected entangled GEMM.
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


class Model(NamedTuple):
    init: Callable
    prefill_chunk: Callable
    decode_hidden: Callable
    head_project: Callable  # (params, h [B, D], cfg) -> logits [B, V]
    head_weights: Callable  # (params, cfg) -> [D, V] float32
    init_cache: Callable


def _init(gen: torch.Generator, cfg: ModelConfig, max_seq: int,
          device=None) -> dict:
    dev = resolve_device(device)
    p = {"embed": T.init_embed(gen, cfg), "stack": T.init_stack(gen, cfg)}
    return T.tree_map(lambda t: t.to(dev), p)


def _init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return T.init_stack_cache(cfg, batch, max_seq, resolve_device(device))


def _prefill_chunk(p, tokens, cfg: ModelConfig, cache, *, pos0: int = 0,
                   lengths=None, ft=None):
    """Batched prefill of tokens [B, C] at positions pos0..pos0+C-1.
    ``lengths`` [B] (the rows' true prompt lengths) keep the MoE blocks'
    pad tokens out of expert capacity; the linear KV and latent caches
    store the bucket padding like the reference."""
    x = T.embed_tokens(p["embed"], tokens, cfg)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache, pos=pos0,
                      mode="prefill", lengths=lengths, ft=ft)
    return T.final_hidden(p["embed"], h, cfg), cache


def _decode_hidden(p, tok, cache, pos, cfg: ModelConfig, ft=None):
    x = T.embed_tokens(p["embed"], tok, cfg)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache, pos=pos,
                      mode="decode", ft=ft)
    return T.final_hidden(p["embed"], h, cfg)[:, 0], cache


def _head_project(p, h, cfg: ModelConfig):
    return T.head_project(p["embed"], h, cfg)


def _head_weights(p, cfg: ModelConfig):
    return T.head_weights(p["embed"], cfg)


DECODER_MODEL = Model(init=_init, prefill_chunk=_prefill_chunk,
                      decode_hidden=_decode_hidden,
                      head_project=_head_project, head_weights=_head_weights,
                      init_cache=_init_cache)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet")
    return DECODER_MODEL
