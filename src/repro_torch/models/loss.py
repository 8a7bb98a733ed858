"""Fused cross-entropy without float32 [tokens, vocab] softmax residuals
(port of :mod:`repro.models.loss`).

The naive CE (a log-softmax, then a gather) makes autograd save the
float32 log-probabilities for the backward, the largest activation of a
long-context step. :func:`streamed_ce` saves only the [N] logsumexp and
recomputes ``(softmax - onehot)`` in its backward, as the reference's
custom VJP does.
"""
from __future__ import annotations

import torch


def _stats(logits2d: torch.Tensor, targets: torch.Tensor) -> tuple:
    """(logsumexp [N], target logit [N]) of float32 logits [N, V]."""
    l32 = logits2d.to(torch.float32)
    m = l32.amax(dim=-1)
    s = torch.exp(l32 - m[:, None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    tl = torch.take_along_dim(l32, targets[:, None].to(torch.int64),
                              dim=-1)[:, 0]
    return lse, tl


class _StreamedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits2d, targets, mask, count):
        lse, tl = _stats(logits2d, targets)
        denom = torch.clamp(mask.sum() if count is None else count, min=1.0)
        ctx.save_for_backward(logits2d, targets, mask, lse, denom)
        return ((lse - tl) * mask).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits2d, targets, mask, lse, denom = ctx.saved_tensors
        coef = (g * mask / denom).to(torch.float32)
        p = torch.exp(logits2d.to(torch.float32) - lse[:, None])
        # p - onehot, in place: the [N, V] dlogits is the only large tensor
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, targets.to(torch.int64)] -= 1.0
        return (coef[:, None] * p).to(logits2d.dtype), None, None, None


def streamed_ce(logits2d: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean masked CE over logits [N, V] (float32 math), targets [N] and a
    float32 mask [N]: the masked sum over ``count`` (a float32 scalar;
    the mask's own sum by default), at least 1."""
    return _StreamedCE.apply(logits2d, targets, mask, count)


def streamed_lm_ce(logits: torch.Tensor, tokens: torch.Tensor,
                   mask: torch.Tensor, chunk: int = 0, shift: int = 1,
                   count=None) -> torch.Tensor:
    """CE over logits [B, T, V] where position t predicts token t +
    ``shift``; ``mask`` [B, T] weighs the predicted tokens, and ``count``
    (:func:`streamed_ce`) divides their sum. (``chunk`` is the
    reference's, kept for its signature and unused.)"""
    del chunk
    V = logits.shape[-1]
    return streamed_ce(logits[:, :-shift].reshape(-1, V),
                       tokens[:, shift:].reshape(-1),
                       mask[:, shift:].reshape(-1).to(torch.float32), count)
