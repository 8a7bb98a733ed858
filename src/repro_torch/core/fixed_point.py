"""Float <-> fixed-point bridge for applying entanglement to float data
(port of :mod:`repro.core.fixed_point`).

The paper's scheme is exact only on integers, so float data (gradients,
activations) is quantized to fixed point first:

  * a per-tensor power-of-two scale into the plan's output budget
    (dequantization is then an exponent adjustment, with no rounding in
    the scale itself);
  * reduction headroom: a sum over ``depth`` terms (the cross-replica
    gradient sum, a dot product) multiplies magnitudes by up to ``depth``,
    so the budget is divided by it first and the summed stream still
    meets the eq. (13) range;
  * optional stochastic rounding (unbiased), from a ``torch.Generator``
    where the reference takes a ``jax.random`` key.
"""
from __future__ import annotations

from typing import Optional

import torch

# float32(ln 2): the reference's exp2 / log2 are exp(x * ln2_f32) and
# log(x) / ln2_f32 in float32
_LN2_F32 = 0.6931471824645996
_TINY_F32 = torch.finfo(torch.float32).tiny


def pow2_scale(amax: torch.Tensor, max_magnitude: int,
               depth: int = 1) -> torch.Tensor:
    """The largest power-of-two scale that keeps ``amax * scale`` within
    the budget after an exact ``depth``-term sum: the reference's float32
    ``exp2(floor(log2(budget / amax)))``.

    The reference evaluates ``log2`` as ``log(q) / ln2`` and ``exp2`` as
    ``exp(k * ln2)`` in float32; here ``log`` and ``exp`` are evaluated in
    float64 and rounded once to float32 (correctly rounded), the rest in
    float32 in the reference's order. That gives the reference's scale
    everywhere except where XLA's float32 ``log`` is not correctly rounded
    AND ``log(q) / ln2`` lands on an integer: quotients within a few ulps
    of some powers of two (2**27, 2**31, ...), where the reference's floor
    is one lower (``tests/test_torch_train.py`` shows them). The result is
    then twice the reference's, which changes the rounding grid, never the
    roll-forward.
    """
    dev = amax.device
    budget = torch.tensor(float(max_magnitude // max(depth, 1)),
                          dtype=torch.float32, device=dev)
    ln2 = torch.tensor(_LN2_F32, dtype=torch.float32, device=dev)
    q = budget / torch.clamp(amax.to(torch.float32), min=_TINY_F32)
    k = torch.floor(torch.log(q.double()).float() / ln2)
    return torch.exp((k * ln2).double()).float()


def fit_scale(x: torch.Tensor, max_magnitude: int,
              reduction_depth: int = 1) -> torch.Tensor:
    """:func:`pow2_scale` of ``max |x|``: a float32 scalar tensor."""
    return pow2_scale(x.abs().amax(), max_magnitude, reduction_depth)


def quantize(x: torch.Tensor, max_magnitude: int, reduction_depth: int = 1,
             generator: Optional[torch.Generator] = None) -> tuple:
    """Floats to int32 within the entanglement budget: ``(q, scale)`` with
    ``x ~= q / scale``. Round half to even, or with ``generator``
    stochastic rounding ``floor(y + 0.5 + u)``, u uniform in [-0.5, 0.5)
    (unbiased)."""
    scale = fit_scale(x, max_magnitude, reduction_depth)
    y = x.to(torch.float32) * scale
    if generator is not None:
        noise = torch.rand(y.shape, generator=generator,
                           device=generator.device).to(y.device) - 0.5
        q = torch.floor(y + 0.5 + noise)
    else:
        q = torch.round(y)
    return q.to(torch.int32), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q / scale`` in float32, cast to ``dtype``."""
    return (q.to(torch.float32) / scale).to(dtype)
