"""Torch oracles for every kernel of the port (port of
:mod:`repro.kernels.ref`): the semantics, where the kernels are the
schedules.

Each function is shape-polymorphic and exact: integer products and sums
run in int64 (whose wrap mod 2**64 keeps every result exact mod 2**32)
and wrap to int32 at the end, the way the reference's int32 ``jnp`` ops
wrap. torch has no int64 matmul on CUDA, so the GEMM oracles compute on
the CPU and return their result on the operands' device. These are
tensor code plainer than the plain versions (which repeat the kernels'
limb arithmetic): they are what both are held against, and they make the
``reference`` kernel backend of :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.codec import unpack_int8, wrap_i32


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def entangle_ref(c: torch.Tensor, l: int) -> torch.Tensor:
    """eps_m = (c_{(m-1) mod M} << l) + c_m over axis 0."""
    c = _i64(c)
    return wrap_i32((torch.roll(c, 1, dims=0) << l) + c)


def disentangle_ref(delta: torch.Tensor, plan, r: int = 0) -> torch.Tensor:
    """Delegates to the core codec (held against the reference's numpy
    int64 oracle in the CPU tests)."""
    from repro_torch.core.entangle import disentangle

    return disentangle(delta.to(torch.int32), plan, failed=r)


def _matmul_i32(a: torch.Tensor, g: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, g)`` exact mod 2**32, on ``a``'s device."""
    out = torch.einsum(eq, _i64(a).cpu(), _i64(g).cpu())
    return wrap_i32(out).to(a.device)


def entangled_matmul_ref(c: torch.Tensor, g: torch.Tensor,
                         l: int) -> torch.Tensor:
    """delta[m] = ((c_{m-1} << l) + c_m) @ g, int32 ring arithmetic."""
    return _matmul_i32(entangle_ref(c, l), g, "mbk,kn->mbn")


def entangled_matmul_fused_ref(c: torch.Tensor, g: torch.Tensor, plan,
                               r: int = 0) -> torch.Tensor:
    """Oracle for the fused epilogue: disentangled entangled products."""
    return disentangle_ref(entangled_matmul_ref(c, g, plan.l), plan, r)


def entangled_matmul_grouped_ref(c: torch.Tensor, g: torch.Tensor,
                                 l: int) -> torch.Tensor:
    """Grouped (per-expert) form: delta[m, e] = (E c)[m, e] @ g[e] for c
    [M, E, Cg, K], g [E, K, N]; the entanglement spans the M axis only."""
    return _matmul_i32(entangle_ref(c, l), g, "meck,ekn->mecn")


def entangled_matmul_grouped_fused_ref(c: torch.Tensor, g: torch.Tensor,
                                       plan, r: int = 0) -> torch.Tensor:
    """Oracle for the fused grouped epilogue: each expert's GEMM is
    linear, so one disentangle over the stream axis recovers them all."""
    return disentangle_ref(entangled_matmul_grouped_ref(c, g, plan.l), plan,
                           r)


def conv1d_causal_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b,d,t] = sum_j w[d,j] * x[b,d,t-K_f+1+j] with zero left-pad."""
    B, D, T = x.shape
    kf = w.shape[1]
    xp = torch.nn.functional.pad(_i64(x), (kf - 1, 0))
    w = _i64(w)
    out = torch.zeros((B, D, T), dtype=torch.int64, device=x.device)
    for j in range(kf):
        out += w[None, :, j:j + 1] * xp[:, :, j:j + T]
    return wrap_i32(out)


def entangled_conv1d_ref(x: torch.Tensor, w: torch.Tensor,
                         l: int) -> torch.Tensor:
    """delta[m] = conv1d_causal(E x)[m] for x [M, B, D, T], w [D, K_f]."""
    eps = entangle_ref(x, l)
    return torch.stack([conv1d_causal_ref(eps[m], w)
                        for m in range(x.shape[0])])


def entangled_conv1d_fused_ref(x: torch.Tensor, w: torch.Tensor, plan,
                               r: int = 0) -> torch.Tensor:
    """Oracle for the fused conv epilogue: true per-stream conv outputs."""
    return disentangle_ref(entangled_conv1d_ref(x, w, plan.l), plan, r)


def checksum_ref(c: torch.Tensor) -> torch.Tensor:
    """Sum over the M streams of axis 0, kept as a unit axis (the
    reference's ``keepdims=True``), wrapping mod 2**32."""
    return wrap_i32(torch.sum(_i64(c), dim=0, keepdim=True))


def unpacked(g: torch.Tensor, packed: bool, axis: int,
             n: int) -> torch.Tensor:
    """``g`` with its int8 lanes unpacked along ``axis`` to depth ``n``
    (packed weights), or as it is."""
    return unpack_int8(g, axis=axis, n=n) if packed else g
