"""The port's protected-GEMM subsystem against the reference.

  * quantization grids (weights per tensor, activations per row) equal the
    reference's bit for bit on equal float inputs, and so do the
    ``prepare_params`` q8 copies (packed words included);
  * ``protected_matmul``'s float32 outputs agree with the reference's on
    identical inputs (tolerance below; the reference runs its jnp oracle
    backend, which its own tests hold bit-identical to the Pallas kernel);
  * inside the port, a fail-stop in any group rolls forward to the healthy
    output exactly (fused and unfused paths), and the fanout executor is
    bit-identical to per-site calls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core.plan import make_plan as jmake_plan
from repro.ft import plans as jplans
from repro.ft import protected as jprot
from repro.ft import quantize as jq
from repro.models import get_model as jget_model
from repro_torch.bridge import params_from_numpy
from repro_torch.core.plan import make_plan
from repro_torch.ft import (FTContext, PlanRegistry, compile_plans,
                            prepare_params, protected_matmul, quantize_acts,
                            quantize_weight, quantize_weight_stacked)

# identical integer grids and the same float32 ops in the same order give
# identical float32 outputs; the tolerance only admits a last-ulp
# difference in the final division should either backend reassociate it
F32_TOL = dict(rtol=2e-7, atol=0)


def _np(t):
    return np.asarray(t)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return dict(
        x=(rng.standard_normal((3, 5, 48)) * 2).astype(np.float32),
        w=(rng.standard_normal((48, 40)) / 7).astype(np.float32),
        ws=(rng.standard_normal((3, 48, 40)) / 7).astype(np.float32))


def test_quantization_grids_bit_exact(data):
    jp, tp = jmake_plan(4, 32), make_plan(4, 32)
    jw, jsc = jq.quantize_weight(jnp.asarray(data["w"]))
    tw, tsc = quantize_weight(torch.from_numpy(data["w"]))
    np.testing.assert_array_equal(_np(jw), tw.numpy())
    assert np.float32(jsc) == tsc.item()
    jx, jas = jq.quantize_acts(jnp.asarray(data["x"]), jp, 48)
    tx, tas = quantize_acts(torch.from_numpy(data["x"]), tp, 48)
    np.testing.assert_array_equal(_np(jx), tx.numpy())
    np.testing.assert_array_equal(_np(jas), tas.numpy())
    assert jq.activation_budget(jp, 8192) == 8
    for packed in (False, True):
        jd = jq.quantize_weight_stacked(jnp.asarray(data["ws"]), packed=packed)
        td = quantize_weight_stacked(torch.from_numpy(data["ws"]),
                                     packed=packed)
        np.testing.assert_array_equal(_np(jd["w"]), td["w"].numpy())
        np.testing.assert_array_equal(_np(jd["scale"]), td["scale"].numpy())


@pytest.mark.parametrize("contiguous", [False, True])
def test_protected_matmul_matches_reference(data, contiguous):
    jp, tp = jmake_plan(4, 32), make_plan(4, 32)
    x = data["x"][:, :4]  # 12 rows
    want = _np(jprot.protected_matmul(
        jnp.asarray(x), jnp.asarray(data["w"]), plan=jp,
        contiguous=contiguous, backend="reference"))
    got = protected_matmul(torch.from_numpy(x), torch.from_numpy(data["w"]),
                           plan=tp, contiguous=contiguous)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # an odd row count pads with zero rows to a multiple of M
    want = _np(jprot.protected_matmul(
        jnp.asarray(data["x"][0]), jnp.asarray(data["w"]), plan=jp,
        backend="reference"))
    got = protected_matmul(torch.from_numpy(data["x"][0]),
                           torch.from_numpy(data["w"]), plan=tp)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("M", [3, 4, 8])
def test_failed_group_rolls_forward_exactly(data, M):
    """Fused (in-kernel) and unfused (GARBAGE-poisoned stream + separate
    disentangle) recovery equal the healthy output for every group."""
    plan = make_plan(M, 32)
    x = torch.from_numpy(data["x"])
    wq = quantize_weight_stacked(torch.from_numpy(data["w"]), packed=True)
    w = (wq["w"], wq["scale"])
    healthy = protected_matmul(x, w, plan=plan)
    for r in range(M):
        for fuse in (True, False):
            got = protected_matmul(x, w, plan=plan, failed_group=r,
                                   fuse_epilogue=fuse)
            assert torch.equal(got, healthy), (r, fuse)


def test_fanout_bit_identical_to_per_site(data):
    plan = make_plan(4, 32)
    reg = PlanRegistry(plan)
    x = torch.from_numpy(data["x"])
    ws = []
    for i in range(3):
        q = quantize_weight_stacked(torch.from_numpy(data["ws"][i]),
                                    packed=True)
        ws.append((q["w"], q["scale"]))
    sites = ("qkv.q", "qkv.k", "qkv.v")
    for r in (None, 2):
        ctx = FTContext(registry=reg, scope="all", failed_group=r)
        fan = ctx.matmul_fanout(sites, x, tuple(ws))
        per = [ctx.matmul(s, x, w) for s, w in zip(sites, ws)]
        for a, b in zip(fan, per):
            assert torch.equal(a, b)
    # census-only: records shapes and chains, runs no kernel
    cen = FTContext(registry=PlanRegistry(plan), scope="all",
                    census_only=True)
    out = cen.matmul_fanout(sites, x.to("meta"),
                            tuple(torch.empty(48, 40, device="meta")
                                  for _ in sites))
    assert out[0].shape == (3, 5, 40) and out[0].device.type == "meta"
    assert set(cen.registry.census()) == {(s, (4, 4, 48, 40)) for s in sites}
    plans = compile_plans(cen.registry)
    assert plans.chains == frozenset({sites}) and len(plans) == 3
    assert plans.lookup("qkv.q", (4, 4, 48, 40)) is not None
    assert plans.lookup("qkv.q", (4, 9, 48, 40)) is None and plans.misses == 1


@pytest.fixture(scope="module")
def smoke_params():
    cfg = jsmoke("llama3.2-1b")
    return jget_model(cfg).init(jax.random.PRNGKey(3), cfg, max_seq=16)


@pytest.mark.parametrize("scope", ["qkv", "all"])
def test_prepare_params_q8_bit_exact(smoke_params, scope):
    params = smoke_params
    jprep = jplans.prepare_params(params, scope=scope, packed=True)
    tprep = prepare_params(params_from_numpy(jax.tree.map(np.asarray, params),
                                             device="cpu"),
                           scope=scope)
    jflat = jax.tree_util.tree_flatten_with_path(jprep)[0]
    tleaves = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            tleaves[path] = node

    walk(tprep, ())
    n_q8 = 0
    for path, leaf in jflat:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        got = tleaves.pop(key)
        np.testing.assert_array_equal(_np(leaf), got.numpy(), err_msg=str(key))
        n_q8 += "q8" in key
    assert not tleaves  # same tree, leaf for leaf
    assert n_q8 == {"qkv": 6, "all": 14}[scope]  # (w, scale) per site


def _whole_stack_q8(w: torch.Tensor, packed: bool) -> dict:
    """The whole-stack quantization ``quantize_weight_stacked`` ran before
    it went one leading index at a time (the float32 stack, its int32 grid
    and, packed, its int64 lanes all at once): the bits to keep."""
    from repro_torch.kernels.codec import pack_int8

    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(dim=(-2, -1), keepdim=True), min=1e-9)
    scale = torch.full_like(amax, 127.0) / amax
    wq = torch.clamp(torch.round(w * scale), -127, 127).to(torch.int32)
    return {"w": pack_int8(wq, axis=-2) if packed else wq,
            "scale": scale[..., 0, 0]}


@pytest.mark.parametrize("packed", [False, True])
def test_quantize_weight_stacked_per_index_bit_exact(packed):
    """One leading index at a time gives the whole-stack bits and the
    reference's, on a [3, 5, 64, 40] expert-like stack (and a K that packs
    raggedly)."""
    rng = np.random.default_rng(5)
    for shape in ((3, 5, 64, 40), (2, 3, 13, 7)):
        w = (rng.standard_normal(shape) / 7).astype(np.float32)
        w[1, 2] *= 40  # one matrix on its own scale
        got = quantize_weight_stacked(torch.from_numpy(w), packed=packed)
        old = _whole_stack_q8(torch.from_numpy(w), packed)
        ref = jq.quantize_weight_stacked(jnp.asarray(w), packed=packed)
        assert got["w"].dtype == torch.int32 and got["w"].is_contiguous()
        assert got["scale"].shape == shape[:-2]
        np.testing.assert_array_equal(got["w"].numpy(), old["w"].numpy())
        np.testing.assert_array_equal(got["w"].numpy(), _np(ref["w"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      old["scale"].numpy())
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      _np(ref["scale"]))
