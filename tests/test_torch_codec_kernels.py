"""The port's standalone codec passes (entangle, disentangle) against the
reference.

The plain PyTorch versions (what a CPU tensor runs, and what the CUDA
kernels are held to on the card in ``test_torch_cuda.py``) must be
bit-identical to ``repro.kernels.ops.entangle`` / ``disentangle`` run as
the reference's own CPU tests run them (the Pallas kernels in interpret
mode) and to the jnp codec of ``repro.core.entangle``: M = 3..8, int32 and
dual-word plans, every excluded stream r, ragged N, full-range int32
inputs; and disentangling with row r overwritten by GARBAGE must equal the
healthy result (the pass never reads row r).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.entangle import disentangle as jdisentangle
from repro.core.entangle import entangle as jentangle
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import ops as jops
from repro_torch.core.entangle import entangle as tentangle
from repro_torch.core.failstop import GARBAGE
from repro_torch.core.plan import make_plan
from repro_torch.kernels import disentangle as dis
from repro_torch.kernels import entangle as ent
from repro_torch.kernels import ops

# (M, w): every M of Table I at w=32 (dual-word temporaries) and the int32
# temporaries of w=16
PLANS = [(M, 32) for M in range(3, 9)] + [(3, 16), (4, 16)]
N = 1031  # ragged: the reference pads it to its 1024-wide blocks


@pytest.fixture(scope="module", params=PLANS, ids=lambda p: f"M{p[0]}w{p[1]}")
def case(request):
    """One plan's inputs and the reference's outputs, built once: the
    interpret-mode Pallas entangle, the entangled rows' Pallas disentangle
    for every r, and the jnp codec's."""
    M, w = request.param
    jp, tp = jmake_plan(M, w), make_plan(M, w)
    rng = np.random.default_rng(M * 100 + w)
    c = rng.integers(-2**31, 2**31, size=(M, N), dtype=np.int64).astype(
        np.int32)
    eps = np.array(jops.entangle(jnp.asarray(c), jp,
                                   backend="interpret_cpu"))
    rec = {r: np.asarray(jops.disentangle(jnp.asarray(eps), jp, failed=r,
                                          backend="interpret_cpu"))
           for r in [None] + list(range(M))}
    jit_dis = jax.jit(jdisentangle, static_argnames=("plan", "failed"))
    core = {r: np.asarray(jit_dis(jnp.asarray(eps), plan=jp, failed=r))
            for r in range(M)}
    return dict(tp=tp, c=c, eps=eps, rec=rec, core=core,
                core_eps=np.asarray(jax.jit(jentangle, static_argnames=(
                    "plan",))(jnp.asarray(c), plan=jp)))


def test_plain_entangle_matches_reference(case):
    c = torch.from_numpy(case["c"])
    got = ent.entangle_plain(c, case["tp"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), case["eps"])
    np.testing.assert_array_equal(got.numpy(), case["core_eps"])
    np.testing.assert_array_equal(tentangle(c, case["tp"]).numpy(),
                                  case["eps"])


def test_plain_disentangle_matches_reference_every_r(case):
    tp = case["tp"]
    eps = torch.from_numpy(case["eps"])
    for r, want in case["rec"].items():
        got = dis.disentangle_plain(eps, tp, 0 if r is None else r)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"r={r}")
        np.testing.assert_array_equal(
            ops.disentangle(eps, tp, failed=r).numpy(), want)
    for r, want in case["core"].items():
        np.testing.assert_array_equal(
            dis.disentangle_plain(eps, tp, r).numpy(), want)


def test_poisoned_row_is_never_read(case):
    """Row r overwritten by GARBAGE: the result is the healthy one (on
    full-range words), and within the eq. (13) budget it is the true
    streams for every r."""
    tp = case["tp"]
    rng = np.random.default_rng(tp.M)
    lim = tp.max_output_magnitude
    c = torch.from_numpy(rng.integers(-lim, lim + 1, size=(tp.M, N)).astype(
        np.int32))
    eps_ok = ops.entangle(c, tp)
    for r in range(tp.M):
        bad = torch.from_numpy(case["eps"].copy())
        bad[r] = GARBAGE
        np.testing.assert_array_equal(
            ops.disentangle(bad, tp, failed=r).numpy(), case["rec"][r])
        bad = eps_ok.clone()
        bad[r] = GARBAGE
        np.testing.assert_array_equal(
            ops.disentangle(bad, tp, failed=r).numpy(), c.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 1023, 1025])
def test_ops_any_trailing_shape_on_the_cpu(n):
    """``ops`` flattens ``[M, ...]`` and restores it; ragged sizes need no
    padding; the CPU path never launches a kernel."""
    tp = make_plan(4, 32)
    rng = np.random.default_rng(n)
    lim = tp.max_output_magnitude
    c = torch.from_numpy(rng.integers(-lim, lim + 1, size=(4, n, 3)).astype(
        np.int32))
    before = (ent.launches, dis.launches)
    eps = ops.entangle(c, tp)
    assert eps.shape == c.shape and eps.dtype == torch.int32
    np.testing.assert_array_equal(
        eps.numpy(), ent.entangle_plain(c.reshape(4, -1), tp).reshape(
            c.shape).numpy())
    for r in range(4):
        np.testing.assert_array_equal(
            ops.disentangle(eps, tp, failed=r).numpy(), c.numpy())
    assert (ent.launches, dis.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never runs the plain version: a CPU tensor raises."""
    tp = make_plan(4, 32)
    c = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ent.entangle_cuda(c, tp)
    with pytest.raises(ValueError, match="CUDA"):
        dis.disentangle_cuda(c, tp, 1)


def test_build_hash_follows_the_shared_header(tmp_path):
    """The library name hashes the source AND the header it includes, so an
    edit to the shared header rebuilds every source that includes it."""
    from repro_torch.kernels import nvcc

    (tmp_path / "a.cuh").write_text("// v1\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "b.cuh"\n#include <stdint.h>\n')
    assert [p.name for p in nvcc.sources(src)] == ["k.cu", "b.cuh", "a.cuh"]
    before = nvcc.digest(src)
    (tmp_path / "a.cuh").write_text("// v2\n")
    assert nvcc.digest(src) != before
    assert [p.name for p in nvcc.sources(ent.SRC)] == ["codec_pass.cu",
                                                        "codec.cuh"]
    from repro_torch.kernels import entangled_matmul as emm

    assert [p.name for p in nvcc.sources(emm._SRC)] == [
        "entangled_matmul.cu", "codec.cuh"]


def test_loaded_library_is_reused_without_touching_files(monkeypatch):
    """Every launch asks ``nvcc.load`` for its library; once loaded, the
    lookup must not build, hash or resolve the source again (a path's
    system calls on every launch slowed the served decode step)."""
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels import nvcc

    lib, lib_s8 = object(), object()
    monkeypatch.setitem(nvcc._libs, emm._SRC, lib)
    monkeypatch.setitem(nvcc._libs, emm._SRC_S8, lib_s8)

    def touched(*a, **k):
        raise AssertionError("load touched the file system")

    monkeypatch.setattr(nvcc, "build", touched)
    monkeypatch.setattr(nvcc.pathlib.Path, "resolve", touched)
    monkeypatch.setattr(nvcc.pathlib.Path, "read_bytes", touched)
    assert emm._load() is lib
    assert emm._load_s8() is lib_s8
