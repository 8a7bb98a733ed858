"""Dispatch over the port's kernels (port of :mod:`repro.kernels.ops`):
the dense and the grouped entangled GEMM, the standalone entangle and
disentangle passes, the checksum stream, and the plain and the entangled
depthwise causal conv1d.

**Backends.** A registry of kernel backends, each an implementation of
every op in :data:`REQUIRED_OPS`. Shipped:

  - ``cuda_sm90``  the hand-written CUDA kernels (sm_90a), which launch on
                   CUDA tensors or raise;
  - ``plain``      the plain PyTorch versions, on any device;
  - ``reference``  the oracles of :mod:`repro_torch.kernels.ref`.

:func:`register_backend` takes another (it raises on a missing op).
Resolution per call: an explicit ``backend=``, then the process default
(:func:`set_default_backend`), then the device rule: CUDA operands go to
``cuda_sm90`` and CPU operands to ``plain``. A CUDA tensor reaches
``plain`` only when the caller names it (the card's yardsticks do). A
kernel that fails to build or launch raises: no backend gives way to
another. The reference's ``triton_cuda_stub`` (a namespace reserved for
kernels the JAX package lacked) is not ported: the port's kernels stand in
that place; the contract it tested, that a backend missing an op is
refused, is the registry's own.

**Launch parameters.** Every wrapper takes ``blocks``:

  - ``None``: the kernels' rules, unchanged;
  - a dict, merged over the rule: ``bb`` (rows per block) and ``splits``
    (K splits) for both GEMM kernels, ``route`` for the convs,
    ``blocks_per_sm`` for the codec passes; the CUDA launchers check it
    and raise, with the kernel's reason, on a key the kernel lacks or a
    value it cannot take (the call is never re-tiled);
  - ``"auto"``: :mod:`repro_torch.kernels.autotune` — a sweep once per
    (op, shape, backend, flags) key, then cache hits. The backend name is
    the key's namespace. Only a backend with a timer sweeps (``cuda_sm90``);
    the plain versions have no launch parameters, so ``"auto"`` on a CPU
    tensor raises.

The plain and reference backends accept a dict and ignore it. The CUDA
kernels mask ragged edges themselves, so no padding happens here (the
reference pads to its block sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Union

import torch

from repro_torch.core.plan import EntanglePlan
from repro_torch.kernels import autotune as at
from repro_torch.kernels import checksum as cks
from repro_torch.kernels import conv1d as cv
from repro_torch.kernels import disentangle as dis
from repro_torch.kernels import entangle as ent
from repro_torch.kernels import entangled_conv1d as ecv
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import entangled_matmul_grouped as emmg
from repro_torch.kernels import ref
from repro_torch.kernels.codec import PACK_LANES, disentangle_block

Blocks = Union[None, str, dict]

# the op surface every backend implements
REQUIRED_OPS = ("entangled_matmul", "entangled_matmul_grouped", "entangle",
                "disentangle", "checksum", "entangled_conv1d",
                "conv1d_causal")


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """One registered kernel backend.

    ``impls`` maps each :data:`REQUIRED_OPS` name to a callable:

      - ``entangled_matmul(c [M,B,K], g, *, plan, fuse_epilogue, failed,
        packed, blocks)`` and ``entangled_matmul_grouped(c [M,E,Cg,K], g,
        ...)`` the same keywords;
      - ``entangle(c [M,N], *, plan, blocks)``, ``disentangle(delta [M,N],
        *, plan, failed, blocks)`` (failed an int), ``checksum(c [M,N], *,
        blocks) -> [N]``;
      - ``entangled_conv1d(x [M,B,D,T], w, *, plan, fuse_epilogue, failed,
        packed, blocks)``, ``conv1d_causal(x [B,D,T], w, *, blocks)``;

    ``blocks`` is the resolved dict, or None for the rule. ``timer(thunk,
    repeats) -> ms`` times a call for ``blocks="auto"``; a backend without
    one cannot be swept.
    """

    name: str
    impls: Mapping[str, Callable]
    description: str = ""
    timer: Optional[Callable] = None


_BACKENDS: dict = {}
_DEFAULT: Optional[str] = None  # set_default_backend's pin


def register_backend(name: str, impls: Mapping[str, Callable], *,
                     description: str = "",
                     timer: Optional[Callable] = None) -> KernelBackend:
    """Register (or replace) a kernel backend under ``name``; ``impls``
    must cover every op in :data:`REQUIRED_OPS`. Its autotune keys are
    namespaced by ``name``, and a seed cache shipped as
    ``kernels/pretuned/<name>.json`` is read for it."""
    missing = [op for op in REQUIRED_OPS if op not in impls]
    if missing:
        raise ValueError(
            f"backend {name!r} is missing required ops {missing}; every "
            f"backend must provide {list(REQUIRED_OPS)}")
    b = KernelBackend(name=name, impls=dict(impls), description=description,
                      timer=timer)
    _BACKENDS[name] = b
    return b


def unregister_backend(name: str) -> None:
    """Remove a registered backend (and the default pin, if it was it)."""
    global _DEFAULT
    _BACKENDS.pop(name, None)
    if _DEFAULT == name:
        _DEFAULT = None


def backend_names() -> tuple:
    return tuple(sorted(_BACKENDS))


def get_backend(name: str) -> KernelBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"no kernel backend {name!r} registered; known: "
                       f"{backend_names()}") from None


def set_default_backend(name: Optional[str]) -> None:
    """Pin the process-wide default backend (None restores the device
    rule)."""
    global _DEFAULT
    if name is not None:
        get_backend(name)  # validate
    _DEFAULT = name


def default_backend() -> Optional[str]:
    return _DEFAULT


def resolve_backend(backend: Optional[str] = None, *tensors,
                    op: str = "kernel") -> str:
    """The backend name of one call: ``backend`` if given, else the
    process default, else the device rule over ``tensors`` (the call's
    operands): all on CUDA -> ``cuda_sm90``, all on the CPU -> ``plain``;
    anything else raises. The name is also the call's autotune
    namespace."""
    if backend is not None:
        get_backend(backend)
        return backend
    if _DEFAULT is not None:
        return _DEFAULT
    if all(t.device.type == "cuda" for t in tensors):
        return "cuda_sm90"
    if all(t.device.type == "cpu" for t in tensors):
        return "plain"
    if len(tensors) > 1:
        raise ValueError(f"{op} needs both operands on the CPU or both on "
                         f"CUDA, got {[str(t.device) for t in tensors]}")
    raise ValueError(f"{op} needs a CPU or CUDA tensor, got "
                     f"{[str(t.device) for t in tensors]}")


def _sms(t: torch.Tensor) -> Optional[int]:
    if t.is_cuda:
        return torch.cuda.get_device_properties(t.device).multi_processor_count
    return None


def _resolve_blocks(op: str, blocks: Blocks, shape_sig: tuple,
                    backend: str, bench, flags: tuple,
                    like: torch.Tensor) -> dict:
    """The launch parameters of a call whose ``blocks`` is not None: the
    caller's dict (the launcher checks it), or the autotuned winner of
    ``bench`` over the kernel's candidates. The wrappers skip this for
    ``blocks=None``, the rule's path."""
    if isinstance(blocks, dict):
        return blocks
    if blocks == "auto":
        return at.tune(op, shape_sig, backend, bench, flags=flags,
                       sms=_sms(like))
    raise ValueError(f"blocks must be None, a dict or 'auto', got {blocks!r}")


# --------------------------------------------------------------- flags ------

def _plan_flags(plan: EntanglePlan) -> tuple:
    """The codec parameters in an autotune key: the shift and the
    temporary's width change the epilogue's cost."""
    return (f"l{plan.l}", plan.temp)


def _matmul_flags(plan: EntanglePlan, fuse_epilogue,
                  packed: bool = False) -> tuple:
    """Autotune flags of the GEMMs, shared by the wrappers and the warm
    calls: each fuse / packed variant is its own namespace (the epilogue
    changes the cost, and packing picks the kernel)."""
    flags = _plan_flags(plan)
    if fuse_epilogue is True:
        flags += ("fused",)
    elif fuse_epilogue == "chain":
        flags += ("chain",)
    elif fuse_epilogue == "chain_final":
        flags += ("chainf",)
    if packed:
        flags += ("packed",)
    return flags


def _conv_flags(plan: EntanglePlan, fuse_epilogue, packed: bool) -> tuple:
    return (_plan_flags(plan) + (("fused",) if fuse_epilogue else ())
            + (("packed",) if packed else ()))


# ------------------------------------------------------------- LSB ops ------

def entangled_matmul(c: torch.Tensor, g: torch.Tensor, plan: EntanglePlan, *,
                     fuse_epilogue=False, failed: Optional[int] = None,
                     packed: bool = False, blocks: Blocks = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Fused entangle + GEMM [+ extract]: c ``[M, B, K]``, g ``[K, N]``
    (packed: ``[ceil(K/4), N]``) -> ``[M, B, N]`` int32, for any B, K, N.

    ``fuse_epilogue`` is one of True / False / 'chain' / 'chain_final'
    (see :mod:`repro_torch.kernels.entangled_matmul`); ``failed`` is the
    stream the extraction never reads (None means stream 0).
    """
    emm._check_mode(fuse_epilogue)
    name = resolve_backend(backend, c, g, op="entangled_matmul")
    impl = get_backend(name).impls["entangled_matmul"]
    kw = dict(plan=plan, fuse_epilogue=fuse_epilogue, failed=failed,
              packed=packed)
    if blocks is not None:
        blocks = _resolve_blocks(
            "entangled_matmul", blocks, (*c.shape, g.shape[1]), name,
            lambda b: (lambda: impl(c, g, blocks=b, **kw)),
            _matmul_flags(plan, fuse_epilogue, packed), c)
    return impl(c, g, blocks=blocks, **kw)


def entangled_matmul_grouped(c: torch.Tensor, g: torch.Tensor,
                             plan: EntanglePlan, *, fuse_epilogue=False,
                             failed: Optional[int] = None,
                             packed: bool = False, blocks: Blocks = None,
                             backend: Optional[str] = None) -> torch.Tensor:
    """Grouped (per-expert) fused entangle + GEMM [+ extract], the MoE form:
    c ``[M, E, Cg, K]``, g ``[E, K, N]`` (packed: ``[E, ceil(K/4), N]``) ->
    ``[M, E, Cg, N]`` int32. ``fuse_epilogue`` is True or False (the chain
    modes are dense-only and raise, as in the reference)."""
    emmg._check_mode(fuse_epilogue)
    name = resolve_backend(backend, c, g, op="entangled_matmul_grouped")
    impl = get_backend(name).impls["entangled_matmul_grouped"]
    kw = dict(plan=plan, fuse_epilogue=fuse_epilogue, failed=failed,
              packed=packed)
    if blocks is not None:
        blocks = _resolve_blocks(
            "entangled_matmul_grouped", blocks, (*c.shape, g.shape[2]), name,
            lambda b: (lambda: impl(c, g, blocks=b, **kw)),
            _matmul_flags(plan, fuse_epilogue, packed), c)
    return impl(c, g, blocks=blocks, **kw)


def _warm_operands(shape_c: tuple, shape_g: tuple, device) -> tuple:
    """Seeded int8-range operands for a sweep: nonzero, since the grouped
    s8 kernel skips an expert whose entangled rows are all zero."""
    gen = torch.Generator(device=device).manual_seed(0)
    c = torch.randint(-128, 128, shape_c, generator=gen, device=device,
                      dtype=torch.int32)
    g = torch.randint(-2**31, 2**31 - 1, shape_g, generator=gen,
                      device=device, dtype=torch.int32)
    return c, g


def _warm(fn, op: str, shape: tuple, plan: EntanglePlan, fuse_epilogue,
          packed: bool, backend: Optional[str], device) -> dict:
    """The cached winner of the GEMM wrapper ``fn`` (op name ``op``) at
    ``shape``, its shape signature; on a miss only, seeded operands are
    made on ``device`` and ``fn`` sweeps them."""
    name = resolve_backend(backend, torch.empty(0, device=device), op=op)
    key = at.cache_key(op, shape, name,
                       _matmul_flags(plan, fuse_epilogue, packed))
    won = at.get_cache().get(key)
    if won is None:
        *lead, K, N = shape
        Kg = -(-K // PACK_LANES) if packed else K
        c, g = _warm_operands((*lead, K), (*lead[1:-1], Kg, N), device)
        fn(c, g, plan, fuse_epilogue=fuse_epilogue, packed=packed,
           blocks="auto", backend=name)
        won = at.get_cache().peek(key)
    return dict(won)


def warm_entangled_matmul(M: int, B: int, K: int, N: int, plan: EntanglePlan,
                          *, fuse_epilogue=True, packed: bool = False,
                          backend: Optional[str] = None,
                          device="cuda") -> dict:
    """Tune the GEMM for one (M, B, K, N) shape now (the serving engine
    calls this at startup for every shape of its census, so that
    ``blocks="auto"`` in a step is a cache hit). A shape the cache holds
    is a hit and launches nothing; a miss is swept on seeded operands on
    ``device``. ``failed`` is not part of the key: one warm covers the
    healthy and every injected call. Returns the winning launch
    parameters."""
    return _warm(entangled_matmul, "entangled_matmul", (M, B, K, N), plan,
                 fuse_epilogue, packed, backend, device)


def warm_entangled_matmul_grouped(M: int, E: int, Cg: int, K: int, N: int,
                                  plan: EntanglePlan, *,
                                  fuse_epilogue: bool = True,
                                  packed: bool = False,
                                  backend: Optional[str] = None,
                                  device="cuda") -> dict:
    """Grouped twin of :func:`warm_entangled_matmul` for the MoE
    per-expert shapes of the engine census (every expert occupied)."""
    return _warm(entangled_matmul_grouped, "entangled_matmul_grouped",
                 (M, E, Cg, K, N), plan, fuse_epilogue, packed, backend,
                 device)


# --------------------------------------------------------------- codec ------

def _codec_pass(op: str, x: torch.Tensor, blocks: Blocks, backend,
                flags: tuple, call) -> torch.Tensor:
    """Flatten ``[M, ...]`` to ``[M, N]`` and run ``call(impl, flat,
    blocks)`` on the resolved backend."""
    flat = x.reshape(x.shape[0], -1)
    name = resolve_backend(backend, flat, op=op)
    impl = get_backend(name).impls[op]
    if blocks is not None:
        blocks = _resolve_blocks(op, blocks, tuple(flat.shape), name,
                                 lambda b: (lambda: call(impl, flat, b)),
                                 flags, flat)
    return call(impl, flat, blocks)


def entangle(c: torch.Tensor, plan: EntanglePlan, *, blocks: Blocks = None,
             backend: Optional[str] = None) -> torch.Tensor:
    """Entangle M streams of any trailing shape: ``c [M, ...]`` int ->
    int32 of the same shape."""
    out = _codec_pass("entangle", c, blocks, backend, _plan_flags(plan),
                      lambda impl, f, b: impl(f, plan=plan, blocks=b))
    return out.reshape(c.shape)


def disentangle(delta: torch.Tensor, plan: EntanglePlan, *,
                failed: Optional[int] = None, blocks: Blocks = None,
                backend: Optional[str] = None) -> torch.Tensor:
    """Recover all M streams from entangled ``delta [M, ...]`` of any
    trailing shape, never reading stream ``failed`` (None means stream 0,
    as in the reference)."""
    r = 0 if failed is None else failed
    out = _codec_pass("disentangle", delta, blocks, backend,
                      _plan_flags(plan),
                      lambda impl, f, b: impl(f, plan=plan, failed=r,
                                              blocks=b))
    return out.reshape(delta.shape)


def checksum(c: torch.Tensor, *, blocks: Blocks = None,
             backend: Optional[str] = None) -> torch.Tensor:
    """Checksum stream ``r = sum_m c_m`` (paper eq. 4) of ``[M, ...]``
    inputs -> ``[...]`` int32, wrapping mod 2**32."""
    out = _codec_pass("checksum", c, blocks, backend, (),
                      lambda impl, f, b: impl(f, blocks=b))
    return out.reshape(c.shape[1:])


# ---------------------------------------------------------------- convs -----

def entangled_conv1d(x: torch.Tensor, w: torch.Tensor, plan: EntanglePlan, *,
                     fuse_epilogue: bool = False,
                     failed: Optional[int] = None, packed: bool = False,
                     blocks: Blocks = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Fused entangle + depthwise causal conv1d [+ extract]: x ``[M, B, D,
    T]``, w ``[D, K_f]`` int (packed: ``[ceil(D/4), K_f]`` int8 lanes along
    the depth axis) -> ``[M, B, D, T]`` int32, any K_f >= 1.
    ``fuse_epilogue`` is True or False (the chain modes are dense-only and
    raise, as in the reference); ``failed`` is the stream the extraction
    never computes (None means stream 0)."""
    ecv.check_mode(fuse_epilogue)
    name = resolve_backend(backend, x, w, op="entangled_conv1d")
    impl = get_backend(name).impls["entangled_conv1d"]
    kw = dict(plan=plan, fuse_epilogue=fuse_epilogue, failed=failed,
              packed=packed)
    if blocks is not None:
        blocks = _resolve_blocks(
            "entangled_conv1d", blocks, (*x.shape, w.shape[1]), name,
            lambda b: (lambda: impl(x, w, blocks=b, **kw)),
            _conv_flags(plan, fuse_epilogue, packed), x)
    return impl(x, w, blocks=blocks, **kw)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, *, blocks: Blocks = None,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Depthwise causal conv1d (unentangled): x ``[B, D, T]``, w ``[D,
    K_f]`` int -> ``[B, D, T]`` int32, any K_f >= 1."""
    name = resolve_backend(backend, x, w, op="conv1d_causal")
    impl = get_backend(name).impls["conv1d_causal"]
    if blocks is not None:
        blocks = _resolve_blocks("conv1d_causal", blocks,
                                 (*x.shape, w.shape[1]), name,
                                 lambda b: (lambda: impl(x, w, blocks=b)),
                                 (), x)
    return impl(x, w, blocks=blocks)


# --------------------------------------------------- builtin backends -------

def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _cuda_impls() -> dict:
    """The hand-written kernels, on int32 contiguous operands; ``blocks``
    goes to the launcher, which checks it (a conv's ``route`` to its route
    argument)."""
    def emm_(c, g, *, plan, fuse_epilogue, failed, packed, blocks):
        return emm.entangled_matmul_cuda(
            _i32(c), _i32(g), plan, fuse_epilogue=fuse_epilogue,
            failed=failed, packed=packed, blocks=blocks)

    def emmg_(c, g, *, plan, fuse_epilogue, failed, packed, blocks):
        return emmg.entangled_matmul_grouped_cuda(
            _i32(c), _i32(g), plan, fuse_epilogue=fuse_epilogue,
            failed=failed, packed=packed, blocks=blocks)

    def econv(x, w, *, plan, fuse_epilogue, failed, packed, blocks):
        return ecv.entangled_conv1d_cuda(
            _i32(x), _i32(w), plan, fuse_epilogue=fuse_epilogue,
            failed=failed, packed=packed, route=cv.blocks_route(blocks))

    return {
        "entangled_matmul": emm_,
        "entangled_matmul_grouped": emmg_,
        "entangle": lambda c, *, plan, blocks: ent.entangle_cuda(
            _i32(c), plan, blocks=blocks),
        "disentangle": lambda d, *, plan, failed, blocks: dis.disentangle_cuda(
            _i32(d), plan, failed, blocks=blocks),
        "checksum": lambda c, *, blocks: cks.checksum_cuda(_i32(c),
                                                           blocks=blocks),
        "entangled_conv1d": econv,
        "conv1d_causal": lambda x, w, *, blocks: cv.conv1d_causal_cuda(
            _i32(x), _i32(w), route=cv.blocks_route(blocks)),
    }


def _plain_impls() -> dict:
    """The plain PyTorch versions (any device; ``blocks`` ignored)."""
    return {
        "entangled_matmul": lambda c, g, *, blocks, **kw:
            emm.entangled_matmul_plain(c, g, **kw),
        "entangled_matmul_grouped": lambda c, g, *, blocks, **kw:
            emmg.entangled_matmul_grouped_plain(c, g, **kw),
        "entangle": lambda c, *, plan, blocks: ent.entangle_plain(c, plan),
        "disentangle": lambda d, *, plan, failed, blocks:
            dis.disentangle_plain(d, plan, failed),
        "checksum": lambda c, *, blocks: cks.checksum_plain(c),
        "entangled_conv1d": lambda x, w, *, blocks, **kw:
            ecv.entangled_conv1d_plain(x, w, **kw),
        "conv1d_causal": lambda x, w, *, blocks: cv.conv1d_causal_plain(x,
                                                                        w),
    }


def _ref_impls() -> dict:
    """The oracles of :mod:`.ref` as a backend (``blocks`` ignored). Packed
    weights are unpacked first (an oracle defines semantics, not a memory
    schedule), and the chain modes compose the oracle pieces: a per-stream
    GEMM of the already entangled input (``(E c) @ g = E (c @ g)``),
    extracting only in ``'chain_final'``."""
    def emm_(c, g, *, plan, fuse_epilogue, failed, packed, blocks):
        if c.shape[0] != plan.M:
            raise ValueError(f"c has {c.shape[0]} streams, plan.M={plan.M}")
        g = ref.unpacked(g, packed, 0, c.shape[-1])
        r = 0 if failed is None else failed
        if fuse_epilogue in ("chain", "chain_final"):
            out = ref._matmul_i32(c, g, "mbk,kn->mbn")
            return (disentangle_block(out, plan, r)
                    if fuse_epilogue == "chain_final" else out)
        if fuse_epilogue:
            return ref.entangled_matmul_fused_ref(c, g, plan, r)
        return ref.entangled_matmul_ref(c, g, plan.l)

    def emmg_(c, g, *, plan, fuse_epilogue, failed, packed, blocks):
        g = ref.unpacked(g, packed, 1, c.shape[-1])
        r = 0 if failed is None else failed
        if fuse_epilogue:
            return ref.entangled_matmul_grouped_fused_ref(c, g, plan, r)
        return ref.entangled_matmul_grouped_ref(c, g, plan.l)

    def econv(x, w, *, plan, fuse_epilogue, failed, packed, blocks):
        w = ref.unpacked(w, packed, 0, x.shape[2])
        r = 0 if failed is None else failed
        if fuse_epilogue:
            return ref.entangled_conv1d_fused_ref(x, w, plan, r)
        return ref.entangled_conv1d_ref(x, w, plan.l)

    return {
        "entangled_matmul": emm_,
        "entangled_matmul_grouped": emmg_,
        "entangle": lambda c, *, plan, blocks: ref.entangle_ref(c, plan.l),
        "disentangle": lambda d, *, plan, failed, blocks:
            ref.disentangle_ref(d, plan, failed),
        "checksum": lambda c, *, blocks: ref.checksum_ref(c)[0],
        "entangled_conv1d": econv,
        "conv1d_causal": lambda x, w, *, blocks: ref.conv1d_causal_ref(x, w),
    }


register_backend(
    "cuda_sm90", _cuda_impls(), timer=at.cuda_graph_ms,
    description="hand-written CUDA C++ kernels for sm_90a (s8 tensor-core "
                "and CUDA-core GEMMs, codec passes, two-route conv)")
register_backend(
    "plain", _plain_impls(),
    description="the kernels' plain PyTorch versions (any device)")
register_backend(
    "reference", _ref_impls(),
    description="the oracles of kernels/ref.py (int64 tensor code)")
