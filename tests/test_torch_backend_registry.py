"""The port's kernel backend registry (``repro_torch.kernels.ops``), the
counterpart of ``tests/test_backend_registry.py``.

  * the shipped backends (``cuda_sm90``, ``plain``, ``reference``) and
    the resolution order: an explicit ``backend=``, then the process
    default, then the device rule (CUDA -> ``cuda_sm90``, CPU -> ``plain``);
    a kernel named for a tensor it cannot take raises, never gives way;
  * the ``reference`` (``kernels/ref.py``) and ``plain`` backends
    bit-identical to each other and to the JAX package's ``reference``
    backend (``repro.kernels.ref``) on the same seeded int32 inputs: every
    op, every failed stream, int32 and dual-word plans, packed and
    unpacked weights;
  * a backend registered from outside ``ops.py`` receives the resolved
    ``blocks`` dict, is reached by name and as the process default, and
    autotunes into its own namespace;
  * a backend missing an op is refused, and a ``blocks`` dict a kernel
    cannot take raises with the kernel's reason (the s8 kernel's
    ``ns * bb <= MAX_PAIRS``, ``M * bb <= MAX_CROWS``; a key the launcher
    lacks);
  * the plan registry's ``None`` policy leaves the tiles to the launcher.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import make_plan as jmake_plan
from repro.kernels import ops as jops
from repro.kernels.codec import pack_int8 as jpack_int8
from repro_torch.core.plan import make_plan
from repro_torch.ft import PlanRegistry, default_blocks
from repro_torch.kernels import autotune
from repro_torch.kernels import conv1d as kconv
from repro_torch.kernels import entangle as kent
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.kernels import ops

# an int32-temporary plan and a dual-word one
PLANS = [(3, 16, None), (4, 32, None), (3, 32, "dualword")]
GEMM_MODES = (False, True, "chain", "chain_final")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rs(M, mode):
    return [None, *range(M)] if mode in (True, "chain_final") else [None]


@pytest.fixture(scope="module", params=PLANS,
                ids=lambda p: f"M{p[0]}w{p[1]}{p[2] or ''}")
def case(request):
    """Seeded full-range int32 operands and the JAX reference backend's
    outputs of every op on them, built once per plan."""
    M, w, temp = request.param
    jp, tp = jmake_plan(M, w, temp=temp), make_plan(M, w, temp=temp)
    rng = np.random.default_rng(M * 100 + w)

    def ints(*shape, lo=-2**31, hi=2**31):
        return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(
            np.int32)

    c, g = ints(M, 5, 11), ints(11, 7)
    g8 = ints(11, 7, lo=-128, hi=128)
    cg, gg = ints(M, 3, 2, 9), ints(3, 9, 6)
    gg8 = ints(3, 9, 6, lo=-128, hi=128)
    x, wc = ints(M, 2, 5, 17), ints(5, 4, lo=-2**20, hi=2**20)
    wc8 = ints(5, 4, lo=-128, hi=128)
    flat = ints(M, 37)
    d = dict(c=c, g=g, gp=np.asarray(jpack_int8(jnp.asarray(g8), axis=0)),
             cg=cg, gg=gg, ggp=np.asarray(jpack_int8(jnp.asarray(gg8),
                                                     axis=1)),
             x=x, wc=wc, wcp=np.asarray(jpack_int8(jnp.asarray(wc8),
                                                   axis=0)),
             flat=flat)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    ref = {}
    for packed, gk, ggk, wk in ((False, "g", "gg", "wc"),
                                (True, "gp", "ggp", "wcp")):
        for mode in GEMM_MODES:
            for r in _rs(M, mode):
                ref[("emm", mode, packed, r)] = jops.entangled_matmul(
                    J["c"], J[gk], jp, fuse_epilogue=mode, failed=r,
                    packed=packed, backend="reference")
        for mode in (False, True):
            for r in _rs(M, mode):
                ref[("emmg", mode, packed, r)] = (
                    jops.entangled_matmul_grouped(
                        J["cg"], J[ggk], jp, fuse_epilogue=mode, failed=r,
                        packed=packed, backend="reference"))
                ref[("econv", mode, packed, r)] = jops.entangled_conv1d(
                    J["x"], J[wk], jp, fuse_epilogue=mode, failed=r,
                    packed=packed, backend="reference")
    ref["entangle"] = jops.entangle(J["flat"], jp, backend="reference")
    for r in range(M):
        ref[("disentangle", r)] = jops.disentangle(J["flat"], jp, failed=r,
                                                   backend="reference")
    ref["checksum"] = jops.checksum(J["flat"], backend="reference")
    ref["conv"] = jops.conv1d_causal(J["x"][0], J["wc"], backend="reference")
    return dict(tp=tp, M=M,
                t={k: torch.from_numpy(np.array(v)) for k, v in d.items()},
                ref={k: np.asarray(v) for k, v in ref.items()})


def _both(fn):
    """fn(backend) on the port's reference and plain backends, as numpy;
    the two must be bit-identical."""
    a, b = (fn(name).numpy() for name in ("reference", "plain"))
    np.testing.assert_array_equal(a, b)
    return a


def test_builtin_backends_and_resolution():
    assert {"cuda_sm90", "plain", "reference"} <= set(ops.backend_names())
    cpu = torch.zeros(2)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert ops.resolve_backend(None, cpu, cpu) == "plain"
    assert ops.resolve_backend(None, card, card) == "cuda_sm90"
    # a CUDA tensor reaches plain or reference only when the caller names it
    assert ops.resolve_backend("plain", card, card) == "plain"
    assert ops.resolve_backend("reference", card) == "reference"
    with pytest.raises(ValueError, match="both operands"):
        ops.resolve_backend(None, cpu, card)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.resolve_backend(None, cpu.to("meta"))
    with pytest.raises(KeyError, match="no kernel backend"):
        ops.resolve_backend("cuda_rocm_fpga", cpu)
    ops.set_default_backend("reference")
    try:
        assert ops.resolve_backend(None, card, card) == "reference"
        assert ops.resolve_backend("plain", cpu) == "plain"
    finally:
        ops.set_default_backend(None)
    assert ops.resolve_backend(None, card) == "cuda_sm90"


def test_named_kernel_never_gives_way():
    """The hand-written kernels named for CPU tensors raise: no backend
    falls back to another."""
    plan = make_plan(4, 32)
    c = torch.zeros((4, 2, 8), dtype=torch.int32)
    g = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.entangled_matmul(c, g, plan, backend="cuda_sm90")
    with pytest.raises(ValueError, match="CUDA"):
        ops.entangle(c.reshape(4, -1), plan, backend="cuda_sm90")
    with pytest.raises(ValueError, match="on the card"):
        ops.entangled_matmul(c, g, plan, blocks="auto")
    assert emm.launches_s8 == emm.launches_cuda_core == 0


def test_reference_and_plain_match_jax_reference(case):
    tp, t, ref = case["tp"], case["t"], case["ref"]
    for key, want in ref.items():
        if key[0] == "emm":
            _, mode, packed, r = key
            got = _both(lambda b: ops.entangled_matmul(
                t["c"], t["gp" if packed else "g"], tp, fuse_epilogue=mode,
                failed=r, packed=packed, backend=b))
        elif key[0] == "emmg":
            _, mode, packed, r = key
            got = _both(lambda b: ops.entangled_matmul_grouped(
                t["cg"], t["ggp" if packed else "gg"], tp,
                fuse_epilogue=mode, failed=r, packed=packed, backend=b))
        elif key[0] == "econv":
            _, mode, packed, r = key
            got = _both(lambda b: ops.entangled_conv1d(
                t["x"], t["wcp" if packed else "wc"], tp, fuse_epilogue=mode,
                failed=r, packed=packed, backend=b))
        elif key[0] == "disentangle":
            got = _both(lambda b: ops.disentangle(t["flat"], tp,
                                                  failed=key[1], backend=b))
        elif key == "entangle":
            got = _both(lambda b: ops.entangle(t["flat"], tp, backend=b))
        elif key == "checksum":
            got = _both(lambda b: ops.checksum(t["flat"], backend=b))
        else:
            got = _both(lambda b: ops.conv1d_causal(t["x"][0], t["wc"],
                                                    backend=b))
        np.testing.assert_array_equal(got, want, err_msg=str(key))


def test_registered_fake_backend_routes_and_namespaces(tmp_path):
    """A backend registered without touching ops.py receives the resolved
    blocks, is reached by name and as the process default, and its
    autotune winners land under its own name."""
    cache = autotune.reset_cache(str(tmp_path / "at.json"))
    plain = ops.get_backend("plain").impls
    calls = []

    def spy_emm(c, g, **kw):
        calls.append(kw["blocks"])
        return plain["entangled_matmul"](c, g, **kw)

    plan = make_plan(4, 32)
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.integers(-40, 40, (4, 10, 24)).astype(np.int32))
    g = torch.from_numpy(rng.integers(-25, 25, (24, 16)).astype(np.int32))
    want = ops.entangled_matmul(c, g, plan, fuse_epilogue=True).numpy()
    timings = iter([3.0, 1.0, 2.0] + [9.0] * 100)
    try:
        ops.register_backend("fake_accel", {**plain,
                                            "entangled_matmul": spy_emm},
                             timer=lambda thunk, repeats: (thunk(),
                                                           next(timings))[1])
        got = ops.entangled_matmul(c, g, plan, fuse_epilogue=True,
                                   blocks={"bb": 2}, backend="fake_accel")
        assert calls[-1] == {"bb": 2}
        np.testing.assert_array_equal(got.numpy(), want)
        ops.set_default_backend("fake_accel")
        n0 = len(calls)
        ops.entangled_matmul(c, g, plan, fuse_epilogue=True)
        assert len(calls) == n0 + 1 and calls[-1] is None
        assert ops.resolve_backend(None, c, g) == "fake_accel"
        # autotune: the fake timer ranks the second candidate first
        cands = autotune.candidates_for(
            "entangled_matmul", M=4, E=1, Cg=10, K=24, N=16, packed=False,
            extract=True)
        ops.entangled_matmul(c, g, plan, fuse_epilogue=True, blocks="auto")
        assert calls[-1] == cands[1]
        keys = list(cache._mem)
        assert keys and all("|fake_accel|" in k for k in keys), keys
        assert cache.sweeps == 1
        ops.entangled_matmul(c, g, plan, fuse_epilogue=True, blocks="auto")
        assert cache.sweeps == 1 and calls[-1] == cands[1]
        # a warm of a cached shape is a hit: no operands, no call
        n0 = len(calls)
        assert ops.warm_entangled_matmul(4, 10, 24, 16, plan,
                                         device="cpu") == cands[1]
        assert len(calls) == n0 and cache.sweeps == 1
    finally:
        ops.unregister_backend("fake_accel")
        autotune.reset_cache(None)
    assert ops.resolve_backend(None, c, g) == "plain"
    with pytest.raises(KeyError):
        ops.get_backend("fake_accel")


def test_register_backend_contract():
    """A backend missing an op is refused (the contract the reference's
    ``triton_cuda_stub`` test held, on the registry itself)."""
    with pytest.raises(ValueError, match="missing required ops"):
        ops.register_backend("half_port", {"entangled_matmul": lambda: 0})
    assert "half_port" not in ops.backend_names()
    assert set(ops.get_backend("cuda_sm90").impls) == set(ops.REQUIRED_OPS)


@pytest.mark.parametrize("route,M,extract,blocks,reason", [
    ("s8", 4, True, {"bb": 6, "splits": 1}, "MAX_PAIRS"),
    ("s8", 8, False, {"bb": 3, "splits": 1}, "MAX_CROWS"),
    ("cuda_core", 4, True, {"bb": 3, "splits": 1}, "instances for bb"),
    ("cuda_core", 8, True, {"bb": 8, "splits": 1}, "instances for bb"),
    ("s8", 4, True, {"bb": 2, "splits": 64}, "must lie in"),
    ("s8", 4, True, {"bb": 2, "splits": 3}, "not 3"),
    ("s8", 4, True, {"bb": 2, "bn": 64}, "blocks keys"),
])
def test_blocks_the_kernel_cannot_take_raise(route, M, extract, blocks,
                                             reason):
    """A dict the kernel cannot take raises with the kernel's reason; it
    is never re-tiled. K = 2048 (32 s8 tiles of 64), and 256 for the
    split that cannot be had (4 tiles: 3 splits of ceil(4 / 3) = 2 tiles
    make 2). Every candidate of ``candidates_for`` passes the same
    check."""
    bl = {"bb": 2, "splits": 1, **blocks}
    K = 2048 if reason != "not 3" else 64 * 4
    with pytest.raises((ValueError, TypeError), match=reason):
        emm.check_blocks(route, M, 1, 16, K, bl, extract)
    for cand in autotune.candidates_for(
            "entangled_matmul", M=M, E=1, Cg=16, K=K, N=512,
            packed=route == "s8", extract=extract):
        emm.check_blocks(route, M, 1, 16, K, cand, extract)


@pytest.mark.parametrize("check,blocks", [
    (lambda b: emm.check_blocks("s8", 4, 1, 16, 2048, b, True),
     {"bb": 2, "splits": 1, "bn": 64}),
    (lambda b: kent.blocks_per_sm(b), {"blocks_per_sm": 8, "bb": 2}),
    (lambda b: kconv.blocks_route(b), {"route": "s8", "bb": 2}),
], ids=["gemm", "codec", "conv"])
def test_launchers_refuse_keys_they_lack(check, blocks):
    """Each launcher checks a blocks dict's keys itself (the wrappers pass
    the dict on unchecked)."""
    with pytest.raises(ValueError, match="blocks keys"):
        check(blocks)


def test_registry_plans_carry_the_policy():
    """Policy None gives plans None (the launcher's rule for whichever
    kernel the call reaches); default_blocks reports the rule's tiles of
    the engine's packed, fused call, the first candidate of the sweep."""
    plan = make_plan(4, 32)
    for policy in (None, "auto", {"bb": 2}):
        reg = PlanRegistry(plan, blocks=policy)
        for rows in (9, 20):
            assert reg.entry("attn.q", rows, 64, 96).blocks == policy
    for Bg, K, N in ((2, 2048, 8192), (5, 8192, 2048), (64, 2048, 128256)):
        assert default_blocks(Bg, K, N) == autotune.candidates_for(
            "entangled_matmul", M=4, E=1, Cg=Bg, K=K, N=N, packed=True,
            extract=True)[0]


def test_s8_split_below_the_limb_limit_raises():
    """K past S8_MAX_K needs at least ceil(K / S8_MAX_K) s8 splits."""
    K = 2 * emm.S8_MAX_K + 64
    with pytest.raises(ValueError, match="S8_MAX_K"):
        emm.check_blocks("s8", 4, 1, 2, K, {"bb": 2, "splits": 2}, True)
    assert emm.check_blocks("s8", 4, 1, 2, K, {"bb": 2, "splits": 3},
                            True) <= emm.S8_MAX_K
