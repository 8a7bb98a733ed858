"""Synthetic LM data pipeline: deterministic, seekable, shard-aware (the
port's own copy of :mod:`repro.data.synthetic`, which is numpy only; the
port keeps a copy so that it runs without the reference package).

Generates token streams with enough structure for a ~100M model to visibly
learn (repeating n-gram processes seeded per document), so the end-to-end
example's loss curve is meaningful, while remaining fully offline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 512
    batch_size: int = 8
    seed: int = 0
    order: int = 3  # markov order of the synthetic process


class SyntheticLM:
    """Deterministic synthetic corpus: mixture of per-document Markov chains.

    ``batch(step)`` is pure in (config, step) — any worker can regenerate any
    batch, which is what makes checkpoint-restart and elastic re-sharding
    trivially consistent (the data pipeline is stateless)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        k = min(64, v)
        # order-1 Markov with biased per-state emission pools: each state
        # emits from its own small token pool with a Zipf-ish profile, and
        # the next state is a direct function of the emitted token — so
        # bigram statistics alone already cut the conditional entropy from
        # ln(V) to ~ln(pool)/2, giving a loss curve that visibly bends
        # within a handful of smoke-test steps
        pool = min(17, v)
        self._emit = rng.integers(0, v, size=(k, pool)).astype(np.int32)
        # Zipf-ish index profile: index j is emitted with weight 1/(j+1)
        w = 1.0 / np.arange(1, pool + 1)
        self._cdf = np.cumsum(w / w.sum())
        self._cdf[-1] = 1.0  # float cumsum can land below 1.0; a uniform
        # draw in that gap would searchsorted past the last pool index

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(hash((cfg.seed, step)) % (2**31))
        B, T = cfg.batch_size, cfg.seq_len
        k = self._emit.shape[0]
        state = rng.integers(0, k, size=B)
        pick = np.searchsorted(self._cdf, rng.random((B, T)))
        toks = np.empty((B, T), np.int32)
        for t in range(T):
            toks[:, t] = self._emit[state, pick[:, t]]
            state = toks[:, t] % k
        return {
            "tokens": toks,
            "loss_mask": np.ones((B, T), np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
