"""The arithmetic of the conv's s8 tensor-core route, modelled in plain torch
and held to the plain conv (and at one shape to the reference's oracle).

``csrc/conv1d.cu``'s s8 route has no CPU mode, so this file models what it
computes, step for step, at the kernel's own geometry
(``conv1d.S8_BLOCK`` outputs per Hankel row, ``conv1d.S8_CHUNK`` taps per
chunk): the conv of one row as a Hankel (overlapping input windows) x
Toeplitz (taps) product, the words split into four u8 limbs and the taps
into balanced s8 limbs, one s32 accumulator per limb shift u + v <= 3
(each checked to stay in s32), the shifts folded mod 2**32 after each tap
chunk, and the tap limb planes that are zero over a chunk skipped. The
model must equal ``conv1d_causal_plain`` bit for bit; the entangled form
(entangle, the model, extraction without stream r) must equal
``entangled_conv1d_plain``. The kernel itself is held to the plain
versions on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import make_plan
from repro_torch.kernels import conv1d as cv
from repro_torch.kernels import entangled_conv1d as ecv
from repro_torch.kernels.codec import (disentangle_block, entangle_block,
                                       pack_int8, unpack_int8, wrap_i32)

P, KC = cv.S8_BLOCK, cv.S8_CHUNK
S32 = 2**31


def data_limbs(x: torch.Tensor) -> torch.Tensor:
    """[4, ...] u8 limbs of the words as uint32: sum_u l_u 2**(8u)."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(u >> (8 * k)) & 0xFF for k in range(4)])


def tap_limbs(w: torch.Tensor) -> torch.Tensor:
    """[4, ...] balanced signed limbs in [-128, 127]: sum_v l_v 2**(8v) is w
    mod 2**32."""
    t = w.to(torch.int64)
    out = []
    for _ in range(4):
        b = ((t + 128) & 0xFF) - 128
        out.append(b)
        t = (t - b) >> 8
    return torch.stack(out)


def s8_conv_row(eps: torch.Tensor, w: torch.Tensor, kc_max: int = KC,
                stats: dict = None) -> torch.Tensor:
    """The s8 route's conv of one row: eps ``[T]`` words, w ``[K_f]`` taps
    -> ``[T]`` int32. ``stats`` (if given) collects the limb products per
    MAC of each chunk."""
    T, kf = eps.shape[0], w.shape[0]
    J = -(-T // P)  # Hankel rows: blocks of P outputs
    acc = torch.zeros(J, P, dtype=torch.int64)
    for j0 in range(0, kf, kc_max):
        kc = min(kc_max, kf - j0)
        d32 = -(-(P - 1 + kc) // 32) * 32
        # X[j, q] = eps[j P + q - (K_f - 1) + j0], zero outside [0, T)
        pos = (torch.arange(J)[:, None] * P + torch.arange(d32)[None, :]
               - (kf - 1) + j0)
        X = torch.where((pos >= 0) & (pos < T), eps[pos.clamp(0, T - 1)],
                        torch.zeros((), dtype=eps.dtype))
        # W[q, p] = w[j0 + q - p], zero outside the chunk
        y = torch.arange(d32)[:, None] - torch.arange(P)[None, :]
        W = torch.where((y >= 0) & (y < kc), w[j0 + y.clamp(0, kc - 1)],
                        torch.zeros((), dtype=w.dtype))
        xl, wl = data_limbs(X).double(), tap_limbs(W)
        planes = [v for v in range(4) if v == 0 or bool(wl[v].any())]
        shifts = torch.zeros(4, J, P, dtype=torch.int64)
        for v in planes:
            for u in range(4 - v):
                # u8 x s8 products; float64 is exact (|sum| < 2**53)
                shifts[u + v] += (xl[u] @ wl[v].double()).to(torch.int64)
        # the kernel keeps each shift in an s32 accumulator
        assert int(shifts.abs().max()) < S32
        fold = sum(shifts[s] << (8 * s) for s in range(4))
        acc = (acc + fold) & 0xFFFFFFFF
        if stats is not None:
            stats.setdefault("limb_products", []).append(
                sum(4 - v for v in planes))
    return wrap_i32(acc.reshape(-1)[:T])


def s8_conv(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """The model over x ``[B, D, T]``, w ``[D, K_f]``: row by row."""
    B, D, T = x.shape
    out = torch.empty_like(x, dtype=torch.int32)
    for b in range(B):
        for d in range(D):
            out[b, d] = s8_conv_row(x[b, d], w[d], **kw)
    return out


def s8_econv(x, w, plan, *, fuse_epilogue, failed=None, packed=False, **kw):
    """The model's entangled conv: the slots entangled on load, with
    extraction only the M - 1 slots other than ``failed`` computed (stream
    r's entangled outputs are never formed: poisoned here), then
    disentangled."""
    M, B, D, T = x.shape
    if packed:
        w = unpack_int8(w, axis=0, n=D)
    eps = entangle_block(x, plan.l)
    r = 0 if failed is None else failed
    out = torch.full_like(eps, GARBAGE)
    for m in range(M):
        if fuse_epilogue and m == r:
            continue
        out[m] = s8_conv(eps[m], w, **kw)
    return disentangle_block(out, plan, r) if fuse_epilogue else out


def _full(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=shape,
                                         dtype=np.int64).astype(np.int32))


def _taps(rng, shape, kind):
    if kind == "full":
        return _full(rng, shape)
    return torch.from_numpy(rng.integers(-128, 128, size=shape).astype(
        np.int32))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# K_f at the kernel's edges: 1, 2, P - 1, P, P + 1 and a chunk + 1; ragged
# T around a row block and the kernel's 512-output tile
@pytest.mark.parametrize("T,kf", [(37, 1), (50, 2), (97, P - 1), (512, P),
                                  (513, P + 1), (130, KC + 1)])
@pytest.mark.parametrize("kind", ["full", "byte"])
def test_s8_model_matches_plain_conv(T, kf, kind):
    rng = np.random.default_rng(T * 7 + kf)
    x = _full(rng, (2, 1, T))
    w = _taps(rng, (1, kf), kind)
    torch.testing.assert_close(s8_conv(x, w), cv.conv1d_causal_plain(x, w),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kf", [33, 100, 131])
def test_s8_model_chunk_folds(kf):
    """Chunks of 32 taps: the fold mod 2**32 after each chunk adds up."""
    rng = np.random.default_rng(kf)
    x, w = _full(rng, (1, 3, 300)), _full(rng, (3, kf))
    torch.testing.assert_close(s8_conv(x, w, kc_max=32),
                               cv.conv1d_causal_plain(x, w), rtol=0, atol=0)


def test_s8_model_matches_reference():
    """At one ragged shape, the model equals the reference's jnp oracle."""
    rng = np.random.default_rng(3)
    x, w = _full(rng, (2, 3, 101)), _full(rng, (3, 60))
    want = np.asarray(ref.conv1d_causal_ref(jnp.asarray(x.numpy()),
                                            jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(s8_conv(x, w).numpy(), want)


@pytest.mark.parametrize("lo,hi,products", [
    (-4, 4, [4]), (-128, 128, [4]), (-2**15, 2**15, [7]),
    (-2**23, 2**23, [9]), (-2**31, 2**31, [10])])
def test_s8_model_skips_zero_tap_limbs(lo, hi, products):
    """Limb planes v >= 1 that are zero over the chunk are skipped: 4, 7, 9
    or 10 limb products per MAC, and the result stays exact."""
    rng = np.random.default_rng(hi % 1000)
    x = _full(rng, (1, 1, 200))
    w = torch.from_numpy(rng.integers(lo, hi, size=(1, 70)).astype(np.int32))
    w[0, 0] = lo  # the range's end is reached
    stats = {}
    torch.testing.assert_close(s8_conv(x, w, stats=stats),
                               cv.conv1d_causal_plain(x, w), rtol=0, atol=0)
    assert stats["limb_products"] == products


def test_s8_model_skip_is_per_chunk():
    """A chunk whose taps fit one byte takes 4 limb products even when
    another chunk needs all four limbs."""
    rng = np.random.default_rng(9)
    x = _full(rng, (1, 1, 150))
    w = torch.from_numpy(rng.integers(-4, 4, size=(1, 64)).astype(np.int32))
    w[0, 40:] = _full(rng, (24,))
    stats = {}
    torch.testing.assert_close(s8_conv(x, w, kc_max=32, stats=stats),
                               cv.conv1d_causal_plain(x, w), rtol=0, atol=0)
    assert stats["limb_products"] == [4, 10]


@pytest.mark.parametrize("M,w", [(3, 16), (8, 32)])
@pytest.mark.parametrize("kind", ["full", "byte"])
def test_s8_model_entangled_matches_plain(M, w, kind):
    """Both modes, every failed stream, unpacked and (for one-byte taps)
    packed taps; ragged T and a K_f past a row block."""
    plan = make_plan(M, w)
    rng = np.random.default_rng(M + w)
    x = _full(rng, (M, 1, 2, 61))
    taps = _taps(rng, (2, P + 3), kind)
    forms = [(False, taps)]
    if kind == "byte":
        forms.append((True, pack_int8(taps, axis=0)))
    for packed, tw in forms:
        kw = dict(packed=packed)
        torch.testing.assert_close(
            s8_econv(x, tw, plan, fuse_epilogue=False, **kw),
            ecv.entangled_conv1d_plain(x, tw, plan, **kw), rtol=0, atol=0)
        for r in range(M):
            torch.testing.assert_close(
                s8_econv(x, tw, plan, fuse_epilogue=True, failed=r, **kw),
                ecv.entangled_conv1d_plain(x, tw, plan, fuse_epilogue=True,
                                           failed=r, **kw), rtol=0, atol=0)


def test_s8_geometry_matches_the_source():
    """The model's block and chunk, and the rule's long row, are the
    kernel's; a chunk's limb sums stay in s32 (4 products of 255 x 128 per
    shift and tap)."""
    src = cv.SRC.read_text()
    assert int(re.search(r"constexpr int P = (\d+);", src).group(1)) == P
    assert int(re.search(r"constexpr int KC_MAX = (\d+);", src).group(1)) == KC
    nj = int(re.search(r"constexpr int NJ_LONG = (\d+);", src).group(1))
    assert nj * P == cv.S8_LONG_T
    assert 4 * 255 * 128 * KC < S32


def test_route_rule_and_route_argument():
    """route=None follows the rule; an unknown route raises before any
    launch; a CPU tensor still raises on either route."""
    for entangled in (False, True):
        assert cv.route_for(cv.S8_MIN_KF, 512, entangled) == "s8"
        assert cv.route_for(cv.S8_MIN_KF - 1, 512, entangled) == "cuda_core"
        assert cv.route_for(4, 10**6, entangled) == "cuda_core"
    assert cv.route_for(cv.S8_MIN_KF - 1, 10**6, True) == "cuda_core"
    assert cv.route_for(cv.S8_MIN_KF_PLAIN, cv.S8_LONG_T) == "s8"
    assert cv.route_for(cv.S8_MIN_KF_PLAIN - 1, 10**6) == "cuda_core"
    assert cv.route_for(cv.S8_MIN_KF_PLAIN, cv.S8_LONG_T - 1) == "cuda_core"
    assert cv.resolve_route("s8", 4, 512) == "s8"
    x = torch.zeros((1, 1, 8), dtype=torch.int32)
    w = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        cv.conv1d_causal_cuda(x, w, route="tensor")
    with pytest.raises(ValueError, match="route"):
        ecv.entangled_conv1d_cuda(x.expand(4, 1, 1, 8).contiguous(), w,
                                  make_plan(4, 32), route="tensor")
    for route in (None, *cv.ROUTES):
        with pytest.raises(ValueError, match="CUDA"):
            cv.conv1d_causal_cuda(x, w, route=route)
