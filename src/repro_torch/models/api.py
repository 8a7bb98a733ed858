"""Model API of the port: the decoder families — dense, MoE, SSM (Mamba-1),
hybrid (RG-LRU + rolling-window attention) and the vision-language one
(a dense decoder behind precomputed patch embeddings) — and the
encoder-decoder family (whisper) (port of :mod:`repro.models.api`; every
family trains)::

    model = get_model(cfg)
    params = model.init(gen, cfg, max_seq, device=dev)  # gen: torch.Generator
    logits = model.forward_train(params, batch, cfg)    # [B, T, V] float32
    #   (deepseek-v3: (logits, mtp_logits))
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

Batches: ``{"tokens": [B, T]}``; the vision-language family's may add
``"patch_embeds"`` [B, P, D] (the vision frontend is a stub, as in the
reference): ``prefill`` and ``forward_train`` put them before the
tokens, decoding then runs at positions ``P + t``, and only the text
positions give logits. The encoder-decoder family's batches carry
``"frames"`` [B, F, D] (the conv frontend's output, also a stub): its
``prefill`` encodes them, stores every decoder layer's cross-attention
keys and values in the cache and runs the prompt; ``decode_hidden`` /
``decode_step`` attend to them; its chunked and packed prefill raise, and
``decode_hidden`` refuses ``ft``, as the reference's do (the serving
engine protects only its head).

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
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.loss import streamed_lm_ce
from repro_torch.tree import tree_map


class Model(NamedTuple):
    init: Callable
    forward_train: Callable  # (params, batch, cfg) -> float32 logits [B, T, V]
    #   (with cfg.mtp the pair (logits, mtp_logits))
    prefill_chunk: Callable
    prefill_packed: Callable
    decode_hidden: Callable
    head_project: Callable  # (params, h [B, D], cfg) -> logits [B, V]
    head_weights: Callable  # (params, cfg) -> [D, V] float32
    init_cache: Callable
    prefill: Callable  # (params, {"tokens": [B, T]}, cfg, cache) -> logits
    decode_step: Callable  # (params, tok, cache, pos, cfg) -> logits


def _init(gen: torch.Generator, cfg: ModelConfig, max_seq: int,
          device=None, master_dtype: torch.dtype = torch.float32) -> dict:
    """``embed`` and ``stack``, and with ``cfg.mtp`` (deepseek-v3) the
    train-only ``mtp`` subtree as in the reference: ``proj`` [2D, D], one
    ``attn_dense`` block stacked with repeat 1, ``norm_h`` and ``norm_e``
    (serving never reads it, and ``prepare_params`` skips it).

    ``master_dtype`` is the reference's float32 by default. With
    ``torch.bfloat16`` (a model too large for its float32 masters on one
    card, deepseek-v3) every weight that the forward passes read only
    through a bfloat16 cast is stored as bfloat16, rounded as it is drawn
    (:func:`~repro_torch.models.layers.bf16_read_init`): the embedding
    ``tok``, the untied ``head``, every projection's ``w`` of GQA
    attention, MLA (``wq`` / ``wq_a`` / ``wq_b`` / ``wkv_a`` / ``wkv_b`` /
    ``wo``) and the MLPs (the shared expert and the MTP block's included),
    the MTP ``proj``, the ``router`` and the expert stacks ``we_gate`` /
    ``we_up`` / ``we_down``. Every other leaf stays float32: the norms'
    ``scale`` (and a LayerNorm's ``bias``), the qkv biases ``b``, learned
    positions ``pos``, and every leaf of the Mamba and RG-LRU blocks. The
    int8 grids and every product are then those of float32 masters holding
    the same bf16-representable values (the weights are upcast one matrix
    at a time for quantization). Serving only: training takes float32."""
    dev = resolve_device(device)
    with L.master_dtype(master_dtype):
        p = {"embed": T.init_embed(gen, cfg, max_seq),
             "stack": T.init_stack(gen, cfg)}
        if cfg.mtp:
            p["mtp"] = {
                "proj": {"w": L.bf16_read_init(
                    gen, (2 * cfg.d_model, cfg.d_model), 2 * cfg.d_model)},
                "block": T.BLOCKS["attn_dense"].init(gen, cfg, 1),
                "norm_h": L.init_norm(cfg, (cfg.d_model,), gen.device),
                "norm_e": L.init_norm(cfg, (cfg.d_model,), gen.device)}
    return tree_map(lambda t: t.to(dev), p)


def _init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return T.init_stack_cache(cfg, batch, max_seq, resolve_device(device))


def _prefix_embeds(p, batch, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings, with the batch's patch embeddings (a
    vision-language batch) before them."""
    x = T.embed_tokens(p["embed"], batch["tokens"], cfg)
    if "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(L.ACT_DTYPE), x], dim=1)
    return x


def _mtp_logits(p, h, batch, cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction: one more ``attn_dense`` block
    predicting token t+2 from ``proj([norm_h(h_t); norm_e(emb(tok_{t+1}))])``
    (the last position's next token wraps around, as the reference's
    ``roll``), sharing the embedding, the final norm and the head."""
    emb_next = T.embed_tokens({"tok": p["embed"]["tok"]},
                              torch.roll(batch["tokens"], -1, dims=1), cfg)
    hh = torch.cat([L.apply_norm(p["mtp"]["norm_h"], h, cfg),
                    L.apply_norm(p["mtp"]["norm_e"], emb_next, cfg)], dim=-1)
    x = L.dense(p["mtp"]["proj"], hh)
    for p_i in T.layer_views(p["mtp"]["block"], 1):
        x = T.BLOCKS["attn_dense"].apply(p_i, x, cfg=cfg, cache=None,
                                         pos=None, mode="train",
                                         lengths=None, ft=None)
    return T.logits_head(p["embed"], x, cfg)


def _forward_train(p, batch, cfg: ModelConfig):
    """Logits of a training batch ``{"tokens": [B, T]}`` (and
    ``"patch_embeds"``, whose positions give no logits): the whole
    sequence, causal, no cache, every block of the pattern (under
    ``cfg.remat``'s activation checkpointing). The params may be autograd
    leaves. With ``cfg.mtp`` the pair ``(logits, mtp_logits)``, the second
    predicting t+2 (:func:`_mtp_logits`)."""
    h = T.apply_stack(p["stack"], _prefix_embeds(p, batch, cfg), cfg=cfg,
                      mode="train")
    if "patch_embeds" in batch:  # only text positions produce logits
        h = h[:, batch["patch_embeds"].shape[1]:]
    logits = T.logits_head(p["embed"], h, cfg)
    if cfg.mtp:
        return logits, _mtp_logits(p, h, batch, cfg)
    return logits


def _prefill_chunk(p, tokens, cfg: ModelConfig, cache, *, pos0: int = 0,
                   lengths=None, ft=None):
    """Batched prefill of tokens [B, C] at positions pos0..pos0+C-1.
    ``lengths`` [B] (the rows' true prompt lengths) keep the MoE blocks'
    pad tokens out of expert capacity, hold the recurrent blocks' state
    over pad steps and keep pads out of the rolling window's buffer; the
    linear KV and latent caches store the bucket padding like the
    reference."""
    x = T.embed_tokens(p["embed"], tokens, cfg, pos=pos0 or None)
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
    pos0 = torch.as_tensor(pos0, device=tokens.device)
    grid = pos0[:, None] + torch.arange(tokens.shape[1], device=pos0.device)
    x = T.embed_tokens(p["embed"], tokens, cfg, pos=grid)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache, pos=pos0,
                      mode="prefill", lengths=lengths, ft=ft)
    return T.final_hidden(p["embed"], h, cfg), cache


def _decode_hidden(p, tok, cache, pos, cfg: ModelConfig, ft=None):
    x = T.embed_tokens(p["embed"], tok, cfg, pos=pos)
    h = T.apply_stack(p["stack"], x, cfg=cfg, caches=cache, pos=pos,
                      mode="decode", ft=ft)
    return T.final_hidden(p["embed"], h, cfg)[:, 0], cache


def _prefill(p, batch, cfg: ModelConfig, cache):
    """A whole prompt batch ``{"tokens": [B, T]}`` (with ``"patch_embeds"``
    [B, P, D] before it) from position 0, no padding: the logits [B, V] of
    its last position and the cache."""
    h = T.apply_stack(p["stack"], _prefix_embeds(p, batch, cfg), cfg=cfg,
                      caches=cache, pos=0, mode="prefill")
    return _head_project(p, T.final_hidden(p["embed"], h[:, -1], cfg),
                         cfg), cache


def _pos_vector(pos, tok: torch.Tensor) -> torch.Tensor:
    """``pos``, an int shared by every row or a per-row vector, as an int64
    vector [B]."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tok.device)
    return pos.expand(tok.shape[0]) if pos.dim() == 0 else pos


def _decode_step(p, tok, cache, pos, cfg: ModelConfig):
    """One token per row, tok [B, 1], at ``pos`` (an int shared by every
    row, or a per-row vector [B]): the logits [B, V] and the cache."""
    h, cache = _decode_hidden(p, tok, cache, _pos_vector(pos, tok), cfg)
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


# ----------------------------------------------------------------- enc-dec --

def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] float32 sinusoidal positions of the encoder: sines of the
    first d/2 frequencies, then their cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _xattn_apply(p, x, *, cfg: ModelConfig, cache, pos, mode: str):
    """One decoder layer: causal self-attention against the cache, then
    cross-attention to the cache's encoder keys and values (skipped with
    no cache, as the reference's), then the MLP."""
    a, _ = L.apply_attention(p["self"], x, cfg=cfg,
                             cache=None if cache is None else cache["self"],
                             pos=pos, mode=mode)
    x = x + a
    if cache is not None:
        a, _ = L.apply_attention(p["cross"], x, cfg=cfg, cache=None, pos=pos,
                                 mode=mode, cross_kv=(cache["cross_k"],
                                                      cache["cross_v"]))
        x = x + a
    return x + L.apply_mlp(p["mlp"], x, cfg=cfg)


def _enc_block_apply(p, x, *, cfg: ModelConfig):
    a, _ = L.apply_attention(p["attn"], x, cfg=cfg, cache=None, pos=None,
                             mode="encode")
    x = x + a
    return x + L.apply_mlp(p["mlp"], x, cfg=cfg)


def _ed_init(gen: torch.Generator, cfg: ModelConfig, max_seq: int,
             device=None) -> dict:
    """The reference's layout: ``stack`` (decoder layers: ``self``,
    ``cross``, ``mlp``) and ``enc`` (encoder layers: ``attn``, ``mlp``),
    each leaf with a leading layer axis, ``enc_norm`` and the embedding
    (learned positions included)."""
    dev = resolve_device(device)
    n, n_enc = cfg.n_layers, cfg.encoder.n_layers
    p = {"embed": T.init_embed(gen, cfg, max_seq),
         "stack": {"self": L.init_attention(gen, cfg, n),
                   "cross": L.init_attention(gen, cfg, n),
                   "mlp": L.init_mlp(gen, cfg, n, gated=False)},
         "enc": {"attn": L.init_attention(gen, cfg, n_enc),
                 "mlp": L.init_mlp(gen, cfg, n_enc, gated=False)},
         "enc_norm": L.init_norm(cfg, (cfg.d_model,), gen.device)}
    return tree_map(lambda t: t.to(dev), p)


def _encode(p, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over frames [B, F, D] plus sinusoidal positions,
    bidirectional, then ``enc_norm``: [B, F, D] bfloat16."""
    x = frames.to(L.ACT_DTYPE)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None].to(L.ACT_DTYPE)
    for p_i in T.layer_views(p["enc"], cfg.encoder.n_layers):
        x = _enc_block_apply(p_i, x, cfg=cfg)
    return L.apply_norm(p["enc_norm"], x, cfg)


def _cross_kv(p_stack, enc_out: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Every decoder layer's cross-attention keys and values of the
    encoder output: two [L, B, F, Hkv, hd] stacks."""
    B, F = enc_out.shape[:2]
    shape = (B, F, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks, vs = [], []
    for p_i in T.layer_views(p_stack, cfg.n_layers):
        ks.append(L.dense(p_i["cross"]["wk"], enc_out).reshape(shape))
        vs.append(L.dense(p_i["cross"]["wv"], enc_out).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


def _ed_forward_train(p, batch, cfg: ModelConfig):
    """Logits of ``{"tokens": [B, T], "frames": [B, F, D]}``: the encoder,
    then the decoder over the whole sequence (causal self-attention, cross
    to the encoder's keys and values), no cache."""
    enc_out = _encode(p, batch["frames"], cfg)
    x = T.embed_tokens(p["embed"], batch["tokens"], cfg)
    ks, vs = _cross_kv(p["stack"], enc_out, cfg)
    for i, p_i in enumerate(T.layer_views(p["stack"], cfg.n_layers)):
        a, _ = L.apply_attention(p_i["self"], x, cfg=cfg, cache=None,
                                 pos=None, mode="train")
        x = x + a
        a, _ = L.apply_attention(p_i["cross"], x, cfg=cfg, cache=None,
                                 pos=None, mode="train",
                                 cross_kv=(ks[i], vs[i]))
        x = x + a
        x = x + L.apply_mlp(p_i["mlp"], x, cfg=cfg)
    return T.logits_head(p["embed"], x, cfg)


def _ed_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Per decoder layer: the self-attention KV cache, and the encoder's
    keys and values ``cross_k`` / ``cross_v`` [L, B, F, Hkv, hd] that
    :func:`_ed_prefill` fills."""
    dev = resolve_device(device)
    n = cfg.n_layers
    shape = (n, batch, cfg.encoder.n_frames, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"self": L.init_attn_cache(cfg, n, batch, max_seq, dev),
            "cross_k": torch.zeros(shape, dtype=L.ACT_DTYPE, device=dev),
            "cross_v": torch.zeros(shape, dtype=L.ACT_DTYPE, device=dev)}


def _ed_prefill(p, batch, cfg: ModelConfig, cache):
    """``{"tokens": [B, T], "frames": [B, F, D]}``: encode the frames,
    store the cross keys and values in the cache, run the prompt from
    position 0; the logits [B, V] of its last position and the cache."""
    ks, vs = _cross_kv(p["stack"], _encode(p, batch["frames"], cfg), cfg)
    cache["cross_k"].copy_(ks)
    cache["cross_v"].copy_(vs)
    del ks, vs
    x = T.embed_tokens(p["embed"], batch["tokens"], cfg)
    for p_i, c_i in zip(T.layer_views(p["stack"], cfg.n_layers),
                        T.layer_views(cache, cfg.n_layers)):
        x = _xattn_apply(p_i, x, cfg=cfg, cache=c_i, pos=None,
                         mode="prefill")
    return _head_project(p, T.final_hidden(p["embed"], x[:, -1], cfg),
                         cfg), cache


def _ed_decode_hidden(p, tok, cache, pos, cfg: ModelConfig, ft=None):
    if ft is not None:
        raise NotImplementedError(
            "in-model protected GEMMs are decoder-only; the enc-dec family "
            "supports ft_scope='head' (engine-side entangled head) only")
    x = T.embed_tokens(p["embed"], tok, cfg, pos=pos)
    for p_i, c_i in zip(T.layer_views(p["stack"], cfg.n_layers),
                        T.layer_views(cache, cfg.n_layers)):
        x = _xattn_apply(p_i, x, cfg=cfg, cache=c_i, pos=pos, mode="decode")
    return T.final_hidden(p["embed"], x, cfg)[:, 0], cache


def _ed_decode_step(p, tok, cache, pos, cfg: ModelConfig):
    h, cache = _ed_decode_hidden(p, tok, cache, _pos_vector(pos, tok), cfg)
    return T.head_project(p["embed"], h, cfg), cache


def _ed_prefill_chunk(p, tokens, cfg: ModelConfig, cache, *, pos0: int = 0,
                      lengths=None, ft=None):
    raise NotImplementedError(
        "chunked/bucketed prefill is decoder-only; enc-dec prefill needs "
        "frames and runs whole-prompt (_ed_prefill)")


def _ed_prefill_packed(p, tokens, cfg: ModelConfig, cache, *, pos0,
                       lengths=None, ft=None):
    raise NotImplementedError(
        "token-packed prefill is decoder-only; enc-dec prefill needs "
        "frames and runs whole-prompt (_ed_prefill)")


ENCDEC_MODEL = Model(init=_ed_init, forward_train=_ed_forward_train,
                     prefill_chunk=_ed_prefill_chunk,
                     prefill_packed=_ed_prefill_packed,
                     decode_hidden=_ed_decode_hidden,
                     head_project=_head_project, head_weights=_head_weights,
                     init_cache=_ed_init_cache, prefill=_ed_prefill,
                     decode_step=_ed_decode_step)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return ENCDEC_MODEL
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet")
    return DECODER_MODEL


# ------------------------------------------------------------------- loss ----

def lm_loss(logits, batch: dict, cfg: ModelConfig,
            counts=None) -> torch.Tensor:
    """Next-token cross entropy over the batch's ``loss_mask`` (all ones
    when absent): a float32 log-softmax over the whole vocab, or with
    ``loss_impl='streamed'`` (:func:`repro_torch.models.loss.
    streamed_lm_ce`, which saves no [tokens, vocab] residual). ``logits``
    may be the pair ``(logits, mtp_logits)`` (deepseek-v3): the MTP
    logits' t+2 cross entropy is then added with weight 0.3.

    Each term is a masked sum over its mask's count. ``counts`` (a pair
    of float32 scalars, the t+1 and the t+2 term's) replaces those
    counts: a data-parallel rank's share of a global batch's loss divides
    its rows' sums by the global batch's counts
    (:func:`repro_torch.train.train_step.mask_counts`)."""
    main, mtp = logits if isinstance(logits, tuple) else (logits, None)
    tokens = batch["tokens"]
    full_mask = batch.get("loss_mask")
    if full_mask is None:
        full_mask = torch.ones_like(tokens)
    c1, c2 = (None, None) if counts is None else counts
    if cfg.loss_impl == "streamed":
        loss = streamed_lm_ce(main, tokens, full_mask, shift=1, count=c1)
        if mtp is not None:
            loss = loss + 0.3 * streamed_lm_ce(mtp, tokens, full_mask,
                                               shift=2, count=c2)
        return loss
    loss = _naive_ce(main, tokens, full_mask, 1, c1)
    if mtp is not None:
        loss = loss + 0.3 * _naive_ce(mtp, tokens, full_mask, 2, c2)
    return loss


def _naive_ce(logits, tokens, full_mask, shift: int,
              count=None) -> torch.Tensor:
    """Masked CE of position t predicting token t + ``shift``, summed over
    ``count`` (the mask's own sum by default), at least 1."""
    mask = full_mask[:, shift:].to(torch.float32)
    lp = torch.log_softmax(logits[:, :-shift].to(torch.float32), dim=-1)
    ll = torch.take_along_dim(lp, tokens[:, shift:, None].to(torch.int64),
                              dim=-1)[..., 0]
    denom = torch.sum(mask) if count is None else count
    return -torch.sum(ll * mask) / torch.clamp(denom, min=1.0)
