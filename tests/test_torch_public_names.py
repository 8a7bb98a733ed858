"""The port's public surface against the reference's, on the CPU.

* Every name in every ``__all__`` of a reference module resolves in the
  port's module of the same path (the port mirrors ``src/repro/`` module
  for module; ``core/wideint.py`` and ``launch/hlo_cost.py`` differ by
  design and are left out).
* The names of the protected head: ``repro_torch.serve`` re-exports the
  ``repro_torch.ft.heads`` functions themselves; ``decode_group_order(B,
  M)`` has the reference's signature and permutation; the entries whose
  signatures match by design keep the reference's (the heads take
  ``backend=`` where the reference takes ``use_pallas=``).
* ``triton_cuda_stub`` keeps tests/test_backend_registry.py's contract.
* ``CompiledPlans.plans / sites / categories`` and ``PlanRegistry.key /
  get`` give the reference's answers on the same census, and
  ``init_dense`` the reference's layer (shapes, dtypes, zero bias, He
  scale).
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import repro
from repro.core.plan import make_plan as jmake_plan
from repro.ft import heads as jheads
from repro.ft import plans as jplans
from repro.ft import registry as jregistry
from repro.models import layers as JL
from repro_torch.core import make_plan
from repro_torch.ft import heads, plans, registry
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

# reference modules whose port differs by design
BY_DESIGN = ("repro.core.wideint", "repro.launch.hlo_cost")


def _reference_modules() -> list:
    """Every reference module that declares ``__all__``."""
    out = []
    for m in pkgutil.walk_packages(repro.__path__, "repro."):
        if m.name in BY_DESIGN:
            continue
        mod = importlib.import_module(m.name)
        if hasattr(mod, "__all__"):
            out.append(m.name)
    return out


MODULES = _reference_modules()


def test_reference_packages_declare_names():
    assert {"repro.configs", "repro.core", "repro.serve",
            "repro.ft"} <= set(MODULES)


@pytest.mark.parametrize("name", MODULES)
def test_every_reference_name_resolves_in_the_port(name):
    want = importlib.import_module(name).__all__
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    missing = [n for n in want if not hasattr(port, n)]
    assert not missing, f"{name}: {missing}"


def test_serve_reexports_the_heads_themselves():
    import repro_torch.serve as serve

    for name in ("ft_logits", "ft_logits_decode", "ft_logits_prefill",
                 "quantize_head"):
        assert getattr(serve, name) is getattr(heads, name), name


def test_heads_signatures():
    """tests/test_ft_logits_shim.py's signatures, with ``backend``
    standing where the reference has ``use_pallas``."""
    for name in ("ft_logits", "ft_logits_decode", "ft_logits_prefill",
                 "decode_group_order"):
        want = list(inspect.signature(getattr(jheads, name)).parameters)
        want = ["backend" if p == "use_pallas" else p for p in want]
        got = list(inspect.signature(getattr(heads, name)).parameters)
        if "backend" in want:  # the port's backend comes last
            want = [p for p in want if p != "backend"] + ["backend"]
        assert got == want, name
    assert len(inspect.signature(heads.quantize_head).parameters) == \
        len(inspect.signature(jheads.quantize_head).parameters) == 1


@pytest.mark.parametrize("B,M", [(4, 4), (8, 4), (12, 3), (16, 8)])
def test_decode_group_order_matches_reference(B, M):
    order, inv = heads.decode_group_order(B, M)
    jorder, jinv = jheads.decode_group_order(B, M)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_triton_cuda_stub_contract():
    """One entry for every required op; it registers as a backend; every
    call raises NotImplementedError with "not ported yet", naming the
    port's own kernels."""
    stub = ops.triton_cuda_stub()
    assert set(stub) == set(ops.REQUIRED_OPS)
    ops.register_backend("triton_cuda", stub)
    try:
        assert "triton_cuda" in ops.backend_names()
        c = torch.zeros((4, 2, 8), dtype=torch.int32)
        g = torch.zeros((8, 8), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ops.entangled_matmul(c, g, make_plan(4, 32), fuse_epilogue=True,
                                 backend="triton_cuda")
        for op, impl in stub.items():
            with pytest.raises(NotImplementedError,
                               match="not ported yet.*cuda_sm90"):
                impl()
    finally:
        ops.unregister_backend("triton_cuda")
    assert "triton_cuda" not in ops.backend_names()


# a census: (site, rows, K, N, experts) of dense and grouped sites
SITES = (("attn.q", 8, 64, 64, None), ("attn.o", 8, 64, 64, None),
         ("mlp.gate", 6, 64, 128, None), ("mlp.down", 6, 128, 64, None),
         ("moe.gate", 5, 64, 32, 4))


def _registries():
    reg = registry.PlanRegistry(make_plan(4, 32), backend="cuda_sm90")
    jreg = jregistry.PlanRegistry(jmake_plan(4, 32))
    for site, rows, K, N, E in SITES:
        reg.entry(site, rows, K, N, groups=E)
        jreg.entry(site, rows, K, N, "pallas_tpu", groups=E)
    return reg, jreg


def test_compiled_plans_listing_matches_reference():
    reg, jreg = _registries()
    got = plans.compile_plans(reg)
    want = jplans.compile_plans(jreg)
    assert got.sites() == want.sites()
    assert got.categories() == want.categories() == {"attn", "mlp", "moe"}
    assert sorted((p.site, p.shape) for p in got.plans()) == \
        sorted((p.site, p.shape) for p in want.plans())
    assert len(got.plans()) == len(SITES)


def test_plan_registry_key_and_get():
    """``get`` finds what ``entry`` made, as the reference's does, and
    nothing for another shape or backend; the port's key is ``(site,
    shape)``."""
    reg, jreg = _registries()
    for site, rows, K, N, E in SITES:
        shape = reg.shape_for(rows, K, N, E)
        assert shape == jreg.shape_for(rows, K, N, E)
        e, je = reg.get(site, shape), jreg.get(site, shape, "pallas_tpu")
        assert e is not None and je is not None
        assert (e.site, e.shape) == (je.site, je.shape)
        assert reg.get(site, shape, "cuda_sm90") is e
        assert reg.get(site, shape, "plain") is None
        assert registry.PlanRegistry.key(site, shape, 4, "cuda_sm90") == \
            (site, shape)
    assert reg.get("attn.q", (4, 99, 64, 64)) is None
    assert jreg.get("attn.q", (4, 99, 64, 64), "pallas_tpu") is None


@pytest.mark.parametrize("bias", [False, True])
def test_init_dense_matches_reference(bias):
    import jax

    d_in, d_out = 256, 192
    got = TL.init_dense(torch.Generator().manual_seed(0), d_in, d_out,
                        bias=bias)
    want = JL.init_dense(jax.random.PRNGKey(0), d_in, d_out, bias=bias)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    if bias:
        assert not got["b"].any()
    # He-normal: std 1 / sqrt(d_in), as the reference's draw has
    std, jstd = float(got["w"].std()), float(np.asarray(want["w"]).std())
    assert abs(std * d_in ** 0.5 - 1) < 0.02
    assert abs(jstd * d_in ** 0.5 - 1) < 0.02
    gen = torch.Generator().manual_seed(0)
    torch.testing.assert_close(TL.init_dense(gen.manual_seed(0), d_in,
                                             d_out)["w"], got["w"])
