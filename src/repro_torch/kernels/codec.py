"""The paper's codec as plain PyTorch tensor ops (port of
:mod:`repro.kernels.codec`).

``entangle_block`` is eq. (14/15): one shift-add per element against the
cyclic predecessor row. ``disentangle_rows`` is eq. (16-19): the Horner
telescoping sum, the sign-extended bit-field split of d_r / d_q, and the
eq. (19) recovery chain. The CUDA kernel in ``csrc/entangled_matmul.cu``
carries the same math in registers; these functions are its plain
version and the CPU path.

Integer semantics match the reference bit for bit:

  * int32 tensors wrap mod 2**32 under ``+``, ``-`` and ``<<`` in torch,
    and ``>>`` on a negative int32 is arithmetic, as in ``jnp``;
  * the reference's dual-word temporary (``hi:int32``/``lo:uint32``, ring
    arithmetic mod 2**64, :mod:`repro.core.wideint`) is carried as one
    torch int64, which has the same ring semantics: widen is a sign
    extension, ``shl``/``add``/``sub`` wrap mod 2**64, the low-bits
    extraction sign-extends bits [0, B), and ``shr_exact_to_i32`` keeps
    bits [B, B+32) of the word.

The int8 lane packing uses the reference's bit layout (lane j of a word in
bits [8j, 8j+8), packed along the contraction axis), so q8 weights packed
by either package are interchangeable.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import torch

if TYPE_CHECKING:  # core.entangle imports this module
    from repro_torch.core.plan import EntanglePlan

PACK_LANES = 4  # int8 lanes per int32 word


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an integer tensor, as two's-complement int32."""
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def entangle_block(c: torch.Tensor, l: int) -> torch.Tensor:
    """eps_m = (c_{(m-1) mod M} << l) + c_m over the leading axis (int32)."""
    c = c.to(torch.int32)
    return (torch.roll(c, 1, dims=0) << l) + c


def pack_int8(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int8-valued ``x`` 4-to-1 along ``axis`` into int32 words.

    ``axis`` is zero-padded to a multiple of :data:`PACK_LANES` (zero packs
    and unpacks exactly). Values outside [-128, 127] are truncated mod 256.
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    pad = (-n) % PACK_LANES
    x = torch.movedim(x.to(torch.int64), axis, -1)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    lanes = x.reshape(*x.shape[:-1], (n + pad) // PACK_LANES, PACK_LANES)
    word = torch.zeros(lanes.shape[:-1], dtype=torch.int64, device=x.device)
    for j in range(PACK_LANES):
        word = word + ((lanes[..., j] & 0xFF) << (8 * j))
    # contiguous, so that the kernel reads the packed copy in place (a
    # strided view would be copied on every call)
    return torch.movedim(wrap_i32(word), -1, axis).contiguous()


def unpack_int8(p: torch.Tensor, axis: int = -2,
                n: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`pack_int8`: expand ``axis`` 1-to-4, sign-extended.

    ``n`` truncates the unpacked axis back to its original length.
    """
    axis = axis % p.ndim
    p = p.to(torch.int32)
    lanes = [(p << (24 - 8 * j)) >> 24 for j in range(PACK_LANES)]
    out = torch.stack(lanes, dim=axis + 1)
    shape = list(p.shape)
    shape[axis] = p.shape[axis] * PACK_LANES
    out = out.reshape(shape)
    if n is not None and n != out.shape[axis]:
        out = out.narrow(axis, 0, n)
    return out


def disentangle_rows(delta_rows: Sequence[torch.Tensor], plan: EntanglePlan,
                     r: int = 0) -> list:
    """Recover all M outputs from the M entangled rows, never reading row r.

    ``delta_rows[m]`` is the int32 entangled output of stream m (any
    common shape); the failed/excluded index ``r`` is static. Returns the
    M recovered int32 outputs in stream order.
    """
    M, l = plan.M, plan.l
    if len(delta_rows) != M:
        raise ValueError(f"expected {M} rows, got {len(delta_rows)}")
    r = r % M
    B = (M - 1) * l
    sign = -1 if (M % 2) else 1  # (-1)^M
    q = (r + M - 1) % M

    deltas = [delta_rows[(r + 1 + m) % M].to(torch.int32)
              for m in range(M - 1)]
    if plan.temp == "dualword":
        t = deltas[0].to(torch.int64)
        for j, d in enumerate(deltas[1:], start=2):
            t = t << l
            t = (t - d.to(torch.int64)) if (j % 2 == 0) else (t + d.to(torch.int64))
        t_lo = (t << (64 - B)) >> (64 - B)  # sign-extended low B bits
        d_q = wrap_i32(sign * t_lo)
        d_r = wrap_i32((t - t_lo) >> B)
    else:  # one int32 word (valid when plan.temp_bits <= 32)
        t = deltas[0]
        for j, d in enumerate(deltas[1:], start=2):
            t = t << l
            t = (t - d) if (j % 2 == 0) else (t + d)
        shift = 32 - B
        t_lo = (t << shift) >> shift
        d_q = t_lo if sign == 1 else -t_lo
        d_r = (t - t_lo) >> B

    out: list = [None] * M
    out[r], out[q] = d_r, d_q
    for m in range(1, M - 1):  # eq. (19) chain
        idx = (r + m) % M
        out[idx] = delta_rows[idx].to(torch.int32) - (out[(r + m - 1) % M] << l)
    return out


def disentangle_block(delta: torch.Tensor, plan: EntanglePlan,
                      r: int = 0) -> torch.Tensor:
    """:func:`disentangle_rows` over the leading axis of a stacked block."""
    return torch.stack(
        disentangle_rows([delta[m] for m in range(plan.M)], plan, r), dim=0)
