"""Meta-device stand-ins for every (arch x shape cell) step input (port of
:mod:`repro.launch.input_specs`).

No memory is allocated: every tensor lies on the ``meta`` device, which
keeps shape and dtype only, and the dry run (:mod:`.dryrun`) runs the
step functions on them. The params are drawn by the model's own ``init``
under a ``FakeTensorMode`` (its ``torch.Generator`` draws nothing there),
so their tree is the model's, leaf for leaf. The vision-language and
audio front ends are stubs, as in the reference: the batch carries their
patch or frame embeddings beside the tokens.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.tree import tree_map

META = torch.device("meta")


def meta_like(t: torch.Tensor) -> torch.Tensor:
    """An empty meta tensor of ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, device=META)


def params_specs(cfg: ModelConfig, max_seq: int,
                 master_dtype: torch.dtype = torch.float32):
    """The model's params as meta tensors, from its ``init`` run under a
    ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    gen = torch.Generator().manual_seed(0)
    kw = {} if master_dtype == torch.float32 else {"master_dtype": master_dtype}
    with FakeTensorMode():
        p = get_model(cfg).init(gen, cfg, max_seq=max_seq, device="cpu", **kw)
    return tree_map(meta_like, p)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    return get_model(cfg).init_cache(cfg, batch, max_seq, device=META)


def _batch_specs(cfg: ModelConfig, cell: ShapeCell, kind: str) -> dict:
    B, T = cell.global_batch, cell.seq_len
    batch: dict[str, Any] = {}
    if cfg.family == "vlm":
        P = cfg.vision.n_patches
        batch["patch_embeds"] = torch.empty((B, P, cfg.d_model),
                                            dtype=L.ACT_DTYPE, device=META)
        T = max(T - P, 1)
    elif cfg.family == "encdec":
        batch["frames"] = torch.empty((B, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=L.ACT_DTYPE, device=META)
    batch["tokens"] = torch.empty((B, T), dtype=torch.int64, device=META)
    if kind == "train":
        batch["loss_mask"] = torch.empty((B, T), dtype=torch.int32,
                                         device=META)
    return batch


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Everything the cell's step function consumes, as meta tensors.

    train:   {'batch': ...}                          for step(state, batch)
    prefill: {'batch': ..., 'cache': ...}            for prefill(params, batch, cfg, cache)
    decode:  {'tok': ..., 'cache': ..., 'pos': ...}  for decode_step(...)

    A decode cell's ``pos`` is a per-row vector [B], the serving engine's
    form (the reference's is one shared scalar; a meta tensor has no value
    to read as one).
    """
    if cell.kind == "train":
        return {"batch": _batch_specs(cfg, cell, "train")}
    if cell.kind == "prefill":
        return {"batch": _batch_specs(cfg, cell, "prefill"),
                "cache": cache_specs(cfg, cell.global_batch, cell.seq_len)}
    if cell.kind == "decode":
        return {"tok": torch.empty((cell.global_batch, 1), dtype=torch.int64,
                                   device=META),
                "cache": cache_specs(cfg, cell.global_batch, cell.seq_len),
                "pos": torch.empty((cell.global_batch,), dtype=torch.int64,
                                   device=META)}
    raise ValueError(cell.kind)
