"""Fused entangled integer GEMM: the two CUDA kernels' wrappers, their
plain PyTorch version, and the kernels' launch counters.

Replaces the Pallas TPU kernel ``repro/kernels/entangled_matmul.py``
(``entangled_matmul_pallas``, body ``_emm_kernel``): entangle-on-load
``eps = (roll(c, 1) << l) + c``, int32 accumulation ``acc[m] += eps[m] @
g``, and extraction at the flush without reading stream ``failed``
(the kernel does not even compute that stream's accumulator). The
four ``fuse_epilogue`` modes select which codec halves run:

  ================  =================  ================
  fuse_epilogue     entangle prologue  extract at flush
  ================  =================  ================
  ``True``          yes                yes
  ``False``         yes                no
  ``'chain'``       no                 no
  ``'chain_final'`` no                 yes
  ================  =================  ================

``packed=True`` reads ``g`` as ``[ceil(K/4), N]`` int8 lanes packed 4 per
int32 word along K (:func:`repro_torch.kernels.codec.pack_int8`).

Two hand-written CUDA C++ kernels for ``sm_90a`` compute this function,
and :func:`entangled_matmul_cuda` routes by ``packed`` alone:

* packed weights (every protected weight on the serving path) take the
  s8 tensor-core kernel, ``csrc/entangled_matmul_s8.cu``: eps split into
  four exact byte limbs, each an ``u8 x s8 -> s32`` MMA against the packed
  words as they are, recombined mod 2**32; weight tiles stream through a
  pipelined ring in shared memory (``cp.async`` on ``mbarrier``s). It is
  bound by the weight bytes. A limb's sums stay in s32 over at most
  :data:`S8_MAX_K` = 65536 of K, so a deeper K is split into slices of at
  most that depth whose 32-bit sums add mod 2**32 (split-K);
* unpacked full-range int32 weights have no s8 form and take the
  CUDA-core kernel, ``csrc/entangled_matmul.cu`` (uint32 multiply-adds).
  It also takes packed weights when called directly
  (:func:`entangled_matmul_cuda_core`), so the two designs can be timed
  side by side.

The grouped (per-expert) form of :mod:`.entangled_matmul_grouped` runs the
same two kernels with an expert axis, launched through :func:`launch`.
Each source is built with ``nvcc`` at first use into ``_build/`` (listed
in ``.gitignore``) and bound with ``ctypes`` (:mod:`.nvcc`).

:func:`entangled_matmul_cuda` launches a kernel on a CUDA tensor and
raises on anything it does not take; :func:`entangled_matmul_plain` is the
plain version, used for CPU tensors and as the kernels' yardstick on the
card; for packed weights it repeats the s8 kernel's limb arithmetic.
``launches_s8`` and ``launches_cuda_core`` count each route's kernel
launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import nvcc
from repro_torch.kernels.codec import (PACK_LANES, disentangle_block,
                                       entangle_block, unpack_int8, wrap_i32)

# fuse_epilogue values whose prologue entangles / whose flush extracts
ENTANGLE_MODES = (False, True)
EXTRACT_MODES = (True, "chain_final")
FUSE_MODES = (False, True, "chain", "chain_final")

# kernel launches since import (or the last reset by the caller), per
# route: the s8 tensor-core kernel and the CUDA-core kernel
launches_s8 = 0
launches_cuda_core = 0

# the deepest K slice of one s8 limb product: 255 * 128 * 65536 < 2**31,
# so no limb's partial sum leaves s32; deeper K is cut into such slices
S8_MAX_K = 65536

# the kernels' tile geometry (csrc/entangled_matmul_s8.cu: BN = WARPS *
# WARP_N, BK = 4 * BKQ, MAX_PAIRS, MAX_CROWS; csrc/entangled_matmul.cu: BN
# = THREADS * TN, BK), checked against the built library at each launch
S8_BLOCK_N, S8_BLOCK_K = 256, 64
S8_MAX_PAIRS, S8_MAX_CROWS = 16, 24
CORE_BLOCK_N, CORE_BLOCK_K = 256, 32
# the launch parameters a ``blocks`` dict may set: rows per block, K splits
GEMM_KEYS = ("bb", "splits")
# the SM count the rule's split assumes where no card is at hand (candidate
# lists on the CPU): an H100 SXM's
SMS_H100 = 132

# route, bb, splits and k_chunk of the last launch of either kernel
last_launch: dict = {}

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SRC = _CSRC / "entangled_matmul.cu"
_SRC_S8 = _CSRC / "entangled_matmul_s8.cu"


def _check_mode(fuse_epilogue) -> None:
    if fuse_epilogue not in FUSE_MODES:
        raise ValueError(
            f"fuse_epilogue must be one of {FUSE_MODES}, got {fuse_epilogue!r}")


def _limb_matmul(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``a @ g`` mod 2**32 for int32 ``a [..., R, K]`` and int8-valued
    ``g [..., K, N]``, as the s8 kernel computes it: a as uint32 is
    ``sum_u a_u * 2**(8u)`` with byte limbs a_u in [0, 255]; each limb
    times g is an exact u8 x s8 product (a float64 matmul, exact: every
    partial sum is below 2**31), and the four products recombine with
    shifts mod 2**32. Each limb's sums must fit s32, as the tensor core's
    accumulator must: a K slice of at most :data:`S8_MAX_K` bounds every
    partial sum by 255 * 128 * 65536 < 2**31, so K is cut into such
    slices, as the kernel splits it, and the slices' recombined sums add
    mod 2**32. The slices' sums are checked (a read to the host, so not
    while a CUDA graph is being captured, which forbids one)."""
    u = a.to(torch.int64) & 0xFFFFFFFF
    gf = g.to(torch.float64)
    check = not (a.is_cuda and torch.cuda.is_current_stream_capturing())
    acc = torch.zeros((), dtype=torch.int64, device=a.device)
    for k0 in range(0, a.shape[-1], S8_MAX_K):
        us, gs = u[..., k0:k0 + S8_MAX_K], gf[..., k0:k0 + S8_MAX_K, :]
        for j in range(4):
            limb = ((us >> (8 * j)) & 0xFF).to(torch.float64)
            part = (limb @ gs).to(torch.int64)
            if check and part.numel() and not (-2**31 <= int(part.min())
                                               and int(part.max()) < 2**31):
                raise AssertionError(f"limb {j}'s sums leave s32")
            acc = (acc + (part << (8 * j))) & 0xFFFFFFFF
    return wrap_i32(acc)


def _matmul_mod32(a: torch.Tensor, g: torch.Tensor, *,
                  g_int8: bool) -> torch.Tensor:
    """``a @ g`` for int32 ``a [R, K]``, ``g [K, N]``, exact mod 2**32.

    ``g_int8`` (values in [-128, 127], the packed weights) repeats the s8
    kernel's byte-limb arithmetic (:func:`_limb_matmul`, any K).
    Otherwise, as the CUDA-core kernel takes any int32 weights: neither
    the CPU nor the GPU has an int32 matmul in torch, so the operands are
    split into 16-bit limbs (``x = hi * 2**16 + lo``, ``lo`` in [0,
    2**16)) and each limb product runs as a float64 matmul. Every limb
    product is below 2**32 in magnitude, so every partial sum stays below
    2**53 — and float64 is exact — for any int32 inputs with K < 2**21.
    The ``hi @ hi`` term is a multiple of 2**32 and drops out. The limb
    sums combine in int64 and wrap to int32.
    """
    if g_int8:
        return _limb_matmul(a, g)
    if a.shape[-1] >= (1 << 21):
        raise ValueError(f"K={a.shape[-1]} too deep for the exact float64 path")
    a64 = a.to(torch.int64)
    a_lo = (a64 & 0xFFFF).to(torch.float64)
    a_hi = (a64 >> 16).to(torch.float64)
    g64 = g.to(torch.int64)
    g_lo = (g64 & 0xFFFF).to(torch.float64)
    g_hi = (g64 >> 16).to(torch.float64)
    ll = (a_lo @ g_lo).to(torch.int64)
    mid = ((a_hi @ g_lo).to(torch.int64) + (a_lo @ g_hi).to(torch.int64))
    return wrap_i32(ll + ((mid & 0xFFFF) << 16))


def entangled_matmul_plain(c: torch.Tensor, g: torch.Tensor,
                           plan: EntanglePlan, *, fuse_epilogue=False,
                           failed: Optional[int] = None,
                           packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    c ``[M, B, K]`` int, g ``[K, N]`` int or packed ``[ceil(K/4), N]``;
    returns ``[M, B, N]`` int32, bit-identical to the kernels and to the
    reference's Pallas kernel. The GEMM is exact mod 2**32 for any int32
    operands (float64 limb products, see :func:`_matmul_mod32`), with
    K < 2**21, or any K for packed weights (K slices of at most 65536, as
    in the s8 kernel); the codec runs in int32/int64 torch ops.
    """
    _check_mode(fuse_epilogue)
    M, B, K = c.shape
    if M != plan.M:
        raise ValueError(f"c has {M} streams, plan.M={plan.M}")
    c = c.to(torch.int32)
    eps = entangle_block(c, plan.l) if fuse_epilogue in ENTANGLE_MODES else c
    g = unpack_int8(g, axis=0, n=K) if packed else g.to(torch.int32)
    if g.shape[0] != K:
        raise ValueError(f"g has depth {g.shape[0]}, c has K={K}")
    out = _matmul_mod32(eps.reshape(M * B, K), g, g_int8=packed)
    out = out.reshape(M, B, g.shape[1])
    if fuse_epilogue in EXTRACT_MODES:
        out = disentangle_block(out, plan, 0 if failed is None else failed)
    return out


# ------------------------------------------------------------- the kernel --

def build(verbose: bool = False) -> tuple:
    """Compile ``csrc/entangled_matmul.cu``, the CUDA-core kernel (and the
    ``csrc/codec.cuh`` it includes), into ``_build/`` if needed; see
    :func:`.nvcc.build`."""
    return nvcc.build(_SRC, verbose)


def build_s8(verbose: bool = False) -> tuple:
    """Compile ``csrc/entangled_matmul_s8.cu``, the s8 tensor-core kernel,
    into ``_build/`` if needed; see :func:`.nvcc.build`."""
    return nvcc.build(_SRC_S8, verbose)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emmg_launch.argtypes = [p, p, p, p, p] + [i] * 14 + [p]
    lib.emmg_launch.restype = i
    lib.emm_error_string.argtypes = [i]
    lib.emm_error_string.restype = ctypes.c_char_p
    for fn in ("emm_threads", "emm_block_n", "emm_block_k"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i


def _declare_s8(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emm_s8_launch.argtypes = [p, p, p, p, p] + [i] * 13 + [p]
    lib.emm_s8_launch.restype = i
    lib.emm_s8_error_string.argtypes = [i]
    lib.emm_s8_error_string.restype = ctypes.c_char_p
    for fn in ("emm_s8_block_n", "emm_s8_block_k"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i


def _load():
    return nvcc.load(_SRC, _declare)


def _load_s8():
    return nvcc.load(_SRC_S8, _declare_s8)


def _rows_per_block(B: int, M: int) -> int:
    """Smallest power of two covering B, capped at 8 (4 when M > 4)."""
    cap = 8 if M <= 4 else 4
    bb = 1
    while bb < min(B, cap):
        bb *= 2
    return bb


def _s8_rows_per_block(Cg: int, ns: int) -> int:
    """Rows per block of the s8 kernel for ``ns`` computed streams: its
    8-column MMA side holds one group of 8 (stream, row) pairs, or two
    when more rows than fit one group are waiting."""
    per = 8 // ns if ns * Cg <= 8 else 16 // ns
    return min(Cg, per)


def _split_k(n_tiles: int, K: int, block_k: int, sms: int,
             max_chunk: int = 0) -> tuple:
    """(splits, k_chunk): split K until about two blocks per SM exist,
    and (``max_chunk`` > 0, a multiple of ``block_k``) into at least
    ceil(K / max_chunk) splits, so that no split is deeper than
    ``max_chunk``."""
    k_tiles = -(-K // block_k)
    want = max(1, -(-2 * sms // n_tiles))
    splits = min(k_tiles, want)
    if max_chunk:
        splits = max(splits, -(-K // max_chunk))
    per = -(-k_tiles // splits)
    k_chunk = per * block_k
    return -(-K // k_chunk), k_chunk


def geometry(route: str) -> tuple:
    """(block_n, block_k) of the ``route`` kernel: columns per block and
    contraction depth per staged tile (the sources' BN and BK)."""
    if route == "s8":
        return S8_BLOCK_N, S8_BLOCK_K
    if route == "cuda_core":
        return CORE_BLOCK_N, CORE_BLOCK_K
    raise ValueError(f"unknown route {route!r}")


def max_rows_per_block(route: str, M: int, extract: bool) -> int:
    """The most rows per block the ``route`` kernel takes at M streams:
    the s8 kernel holds ns * bb <= MAX_PAIRS (stream, row) pairs and
    M * bb <= MAX_CROWS rows of c (ns = M - extract computed streams);
    the CUDA-core kernel has instances for bb in 1, 2, 4 and 8 (8 only
    for M <= 4)."""
    if route == "s8":
        return min(S8_MAX_PAIRS // (M - int(extract)), S8_MAX_CROWS // M)
    return 8 if M <= 4 else 4


def rule_blocks(route: str, M: int, E: int, Cg: int, K: int, N: int,
                extract: bool, sms: int = SMS_H100) -> dict:
    """The launch parameters the launcher picks by rule, ``{"bb": rows per
    block, "splits": K splits}``, on a card of ``sms`` SMs."""
    block_n, block_k = geometry(route)
    if route == "s8":
        bb = _s8_rows_per_block(Cg, M - int(extract))
    else:
        bb = _rows_per_block(Cg, M)
    n_tiles = -(-N // block_n) * E * -(-Cg // bb)
    splits, _ = _split_k(n_tiles, K, block_k, sms,
                         S8_MAX_K if route == "s8" else 0)
    return {"bb": bb, "splits": splits}


def check_blocks(route: str, M: int, E: int, Cg: int, K: int,
                 blocks: dict, extract: bool) -> int:
    """Raise, with the kernel's own reason, unless the ``route`` kernel
    takes ``blocks`` ({"bb", "splits"}) at this shape; returns the depth
    of one split (k_chunk). A split count is taken only as it is: K is
    cut into ``splits`` slices of ceil(k_tiles / splits) tiles, and a
    count that this leaves smaller (fewer slices needed) raises rather
    than being re-tiled."""
    unknown = set(blocks) - set(GEMM_KEYS)
    if unknown:
        raise ValueError(f"entangled_matmul takes blocks keys {GEMM_KEYS}, "
                         f"got {sorted(unknown)}")
    bb, splits = blocks["bb"], blocks["splits"]
    if not (isinstance(bb, int) and isinstance(splits, int)):
        raise TypeError(f"bb and splits must be ints, got {blocks}")
    top = max_rows_per_block(route, M, extract)
    if route == "s8" and not 1 <= bb <= top:
        ns = M - int(extract)
        raise ValueError(
            f"the s8 kernel takes bb={bb} rows per block only if ns * bb <= "
            f"MAX_PAIRS = {S8_MAX_PAIRS} and M * bb <= MAX_CROWS = "
            f"{S8_MAX_CROWS} (ns = {ns} computed streams, M = {M}): bb <= "
            f"{top}")
    if route == "cuda_core" and bb not in ((1, 2, 4, 8) if M <= 4
                                           else (1, 2, 4)):
        raise ValueError(f"the CUDA-core kernel has instances for bb in "
                         f"1, 2, 4 (and 8 when M <= 4), got bb={bb} at "
                         f"M={M}")
    if E * -(-Cg // bb) > 65535:
        raise ValueError(f"bb={bb} gives {E * -(-Cg // bb)} row tiles; the "
                         f"grid's y extent is at most 65535")
    _, block_k = geometry(route)
    k_tiles = -(-K // block_k)
    if not 1 <= splits <= min(k_tiles, 65535):
        raise ValueError(f"splits={splits} must lie in 1..{k_tiles} (K={K} "
                         f"is {k_tiles} tiles of {block_k})")
    k_chunk = -(-k_tiles // splits) * block_k
    if -(-K // k_chunk) != splits:
        raise ValueError(
            f"splits={splits} over {k_tiles} K tiles gives slices of "
            f"{k_chunk // block_k} tiles, which make "
            f"{-(-K // k_chunk)} splits, not {splits}")
    if route == "s8" and k_chunk > S8_MAX_K:
        raise ValueError(
            f"splits={splits} leaves K slices of {k_chunk} > S8_MAX_K = "
            f"{S8_MAX_K}: the s8 limb sums would leave s32 (need splits >= "
            f"{-(-K // S8_MAX_K)})")
    return k_chunk


def check_operands(c: torch.Tensor, g: torch.Tensor, dims: int) -> None:
    """Raise unless c and g are contiguous int32 tensors on one CUDA device,
    c with ``dims`` axes and g with ``dims - 1``."""
    for name, t in (("c", c), ("g", g)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c.device != g.device:
        raise ValueError(f"c on {c.device}, g on {g.device}")
    if c.dim() != dims or g.dim() != dims - 1:
        raise ValueError(f"need c with {dims} axes and g with {dims - 1}, "
                         f"got {tuple(c.shape)} and {tuple(g.shape)}")


def launch(c: torch.Tensor, g: torch.Tensor, plan: EntanglePlan, *, E: int,
           Cg: int, K: int, N: int, fuse_epilogue, failed: Optional[int],
           packed: bool, route: str,
           blocks: Optional[dict] = None) -> torch.Tensor:
    """Launch the ``route`` kernel ("s8", packed weights only, or
    "cuda_core") over E experts of Cg rows per stream (E = 1 is the dense
    form) on checked operands; returns ``[M, E * Cg, N]`` int32. Sizes the
    grid, splits K when the card would have too few blocks (the rule of
    :func:`rule_blocks`; ``blocks`` {"bb", "splits"}, either or both, sets
    them instead, checked by :func:`check_blocks`; without "splits" the
    rule splits K for the block's bb; None or {} is the rule, unchecked),
    allocates the output and split-K scratch, records the launch in
    :data:`last_launch`, and raises on a launch the kernel refuses.
    Counting the launch is the caller's."""
    global last_launch
    M = plan.M
    if c.shape[0] != M or not 3 <= M <= 8:
        raise ValueError(f"c has {c.shape[0]} streams; need plan.M={M} "
                         f"in 3..8")
    Kg = g.shape[-2]
    if Kg != (-(-K // PACK_LANES) if packed else K):
        raise ValueError(f"g depth {Kg} does not match K={K} "
                         f"(packed={packed})")
    if min(E, Cg, K, N) < 1:
        raise ValueError(f"empty GEMM: E={E}, rows={Cg}, K={K}, N={N}")
    extract = fuse_epilogue in EXTRACT_MODES
    if route == "s8":  # packed weights only
        lib = _load_s8()
        geo = lib.emm_s8_block_n(), lib.emm_s8_block_k()
    elif route == "cuda_core":
        lib = _load()
        geo = lib.emm_block_n(), lib.emm_block_k()
    else:
        raise ValueError(f"unknown route {route!r}")
    if geo != geometry(route):
        raise RuntimeError(f"the {route} kernel's (BN, BK) {geo} differ from "
                           f"the wrapper's {geometry(route)}")
    block_n, block_k = geo
    sms = torch.cuda.get_device_properties(c.device).multi_processor_count
    if blocks and "bb" in blocks:
        bb = blocks["bb"]
        if not isinstance(bb, int) or bb < 1:
            raise ValueError(f"bb must be an int >= 1, got {bb!r}")
    elif route == "s8":
        bb = _s8_rows_per_block(Cg, M - extract)
    else:
        bb = _rows_per_block(Cg, M)
    # the rule's split for this bb, with its own last slice, unless
    # blocks sets the split
    n_tiles = -(-N // block_n) * E * -(-Cg // bb)
    splits, k_chunk = _split_k(n_tiles, K, block_k, sms,
                               S8_MAX_K if route == "s8" else 0)
    if blocks:
        splits = blocks.get("splits", splits)
        chunk = check_blocks(route, M, E, Cg, K,
                             {**blocks, "bb": bb, "splits": splits}, extract)
        if "splits" in blocks:
            k_chunk = chunk
    last_launch = {"route": route, "bb": bb, "splits": splits,
                   "k_chunk": k_chunk}
    B = E * Cg
    if splits == 1:
        out = torch.empty((M, B, N), dtype=torch.int32, device=c.device)
        ws = counters = None
    elif extract:  # partial sums of the M-1 computed streams, then counters
        out = torch.empty((M, B, N), dtype=torch.int32, device=c.device)
        ws_n = (M - 1) * B * N
        scratch = torch.zeros(ws_n + n_tiles, dtype=torch.int32,
                              device=c.device)
        ws, counters = scratch, scratch[ws_n:]
    else:  # partial sums meet in the (zeroed) output itself
        out = torch.zeros((M, B, N), dtype=torch.int32, device=c.device)
        ws = counters = None
    r = 0 if failed is None else int(failed) % M
    args = (int(fuse_epilogue in ENTANGLE_MODES), int(extract),
            int(plan.temp == "dualword"), plan.l, r, bb, splits, k_chunk)
    ptrs = (c.data_ptr(), g.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr())
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        if route == "s8":
            rc = lib.emm_s8_launch(*ptrs, M, E, Cg, K, N, *args, stream)
            err = lib.emm_s8_error_string
        else:
            rc = lib.emmg_launch(*ptrs, M, E, Cg, K, N, int(packed), *args,
                                 stream)
            err = lib.emm_error_string
    if rc != 0:
        raise RuntimeError(f"entangled_matmul {route} kernel launch failed: "
                           f"{err(rc).decode()}")
    return out


def entangled_matmul_cuda(c: torch.Tensor, g: torch.Tensor,
                          plan: EntanglePlan, *, fuse_epilogue=False,
                          failed: Optional[int] = None,
                          packed: bool = False,
                          blocks: Optional[dict] = None) -> torch.Tensor:
    """Launch a CUDA kernel: c ``[M, B, K]`` int32, g ``[K, N]`` int32 or
    packed ``[ceil(K/4), N]``, both contiguous on one CUDA device. Packed
    weights take the s8 tensor-core kernel (any K), unpacked ones the
    CUDA-core kernel; ``blocks`` ({"bb", "splits"}) overrides the rule's
    launch parameters (see :func:`launch`). Returns ``[M, B, N]`` int32 on
    ``torch.cuda.current_stream()``; raises on any input or ``blocks`` the
    kernel does not take and on a failed launch."""
    global launches_s8, launches_cuda_core
    _check_mode(fuse_epilogue)
    check_operands(c, g, 3)
    M, B, K = c.shape
    out = launch(c, g, plan, E=1, Cg=B, K=K, N=g.shape[1],
                 fuse_epilogue=fuse_epilogue, failed=failed, packed=packed,
                 route="s8" if packed else "cuda_core", blocks=blocks)
    if packed:
        launches_s8 += 1
    else:
        launches_cuda_core += 1
    return out


def entangled_matmul_cuda_core(c: torch.Tensor, g: torch.Tensor,
                               plan: EntanglePlan, *, fuse_epilogue=False,
                               failed: Optional[int] = None,
                               packed: bool = False,
                               blocks: Optional[dict] = None) -> torch.Tensor:
    """Launch the CUDA-core kernel on either weight form (packed weights
    too, so it can be timed beside the s8 kernel); otherwise as
    :func:`entangled_matmul_cuda`."""
    global launches_cuda_core
    _check_mode(fuse_epilogue)
    check_operands(c, g, 3)
    M, B, K = c.shape
    out = launch(c, g, plan, E=1, Cg=B, K=K, N=g.shape[1],
                 fuse_epilogue=fuse_epilogue, failed=failed, packed=packed,
                 route="cuda_core", blocks=blocks)
    launches_cuda_core += 1
    return out
