"""The MoE slice's pieces against the reference, on the deepseek-v2-lite
smoke config (params built once in JAX and bridged).

  * the configs equal ``repro.configs`` field by field;
  * the grouped entangled GEMM's plain version (what a CPU tensor runs)
    equals the reference's Pallas kernel in interpret mode and its jnp
    oracles bit for bit: every failed stream, M in {3, 4, 8}, int32 and
    dual-word plans, packed and unpacked weights, ragged E, Cg, K and N;
  * ``protected_matmul_grouped`` agrees with the reference's on identical
    inputs, and rolls any failed group forward exactly; the ``prepare_params``
    q8 copies (the expert stacks with their ``[repeat, E]`` scales, the
    router) equal the reference's bit for bit;
  * the float layers (MLA, the MoE block with bucket-padding mask) agree
    within a bf16 tolerance, and the router picks the same experts except
    where the reference's own gate probabilities are near-tied.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core.plan import make_plan as jmake_plan
from repro.ft import plans as jplans
from repro.ft import protected as jprot
from repro.ft import quantize as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.codec import pack_int8 as jpack_int8
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as tbase
from repro_torch.core.plan import make_plan
from repro_torch.ft import (FTContext, PlanRegistry, compile_plans,
                            prepare_params, protected_matmul_grouped,
                            quantize_weight_stacked)
from repro_torch.kernels import entangled_matmul_grouped as emmg
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

ARCH = "deepseek-v2-lite-16b"
# M in {3, 4, 8}, int32 and dual-word temporaries
PLANS = [(3, 16, None), (4, 16, None), (4, 32, None), (8, 32, None)]
# identical integer grids and the same float32 ops in the same order; the
# tolerance only admits a last-ulp difference in the final division
F32_TOL = dict(rtol=2e-7, atol=0)
# bf16 activations through one layer, summed in different orders by the
# two frameworks: a few bf16 ulps (2**-8 relative) of the largest output
LAYER_TOL = 2.0 ** -6
# gate probabilities closer than this count as tied (float32 router
# logits summed in different orders differ by ~1e-7 relative)
ROUTE_TIE = 1e-5


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_configs_equal_reference(arch):
    for cls in ("ModelConfig", "MoEConfig", "MLAConfig"):
        tf, jf = (dataclasses.fields(getattr(m, cls)) for m in (tbase, jbase))
        assert [(f.name, f.default) for f in tf] == \
            [(f.name, f.default) for f in jf], cls
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), get
        assert list(t.layer_pattern()) == list(j.layer_pattern())


# ------------------------------------------------------- the grouped GEMM --

@pytest.fixture(scope="module", params=PLANS, ids=lambda p: f"M{p[0]}w{p[1]}")
def gcase(request):
    """Full-range int32 operands on a ragged grouped shape and the
    reference's outputs for one plan: the interpret-mode Pallas kernel for
    the unfused mode and the fused mode at every failed stream (packed, as
    the serving path runs it), built once."""
    M, w, temp = request.param
    jp, tp = jmake_plan(M, w, temp=temp), make_plan(M, w, temp=temp)
    rng = np.random.default_rng(M * 100 + w)
    E, Cg, K, N = 3, 5, 13, 9
    c = rng.integers(-2**31, 2**31, size=(M, E, Cg, K),
                     dtype=np.int64).astype(np.int32)
    g = rng.integers(-2**31, 2**31, size=(E, K, N),
                     dtype=np.int64).astype(np.int32)
    g8 = rng.integers(-128, 128, size=(E, K, N)).astype(np.int32)
    gp = np.array(jpack_int8(jnp.asarray(g8), axis=1))
    kern = {}
    for packed, gg in ((False, g), (True, gp)):
        kern[(False, packed, None)] = np.asarray(jops.entangled_matmul_grouped(
            jnp.asarray(c), jnp.asarray(gg), jp, packed=packed,
            backend="interpret_cpu"))
    for r in range(M):
        kern[(True, True, r)] = np.asarray(jops.entangled_matmul_grouped(
            jnp.asarray(c), jnp.asarray(gp), jp, fuse_epilogue=True, failed=r,
            packed=True, backend="interpret_cpu"))
    return dict(jp=jp, tp=tp, c=c, g=g, g8=g8, gp=gp, kern=kern)


def _grouped(case, packed, **kw):
    g = case["gp"] if packed else case["g"]
    return ops.entangled_matmul_grouped(
        torch.from_numpy(case["c"]), torch.from_numpy(np.array(g)),
        case["tp"], packed=packed, **kw)


def test_grouped_plain_matches_interpret_kernel(gcase):
    for (mode, packed, r), want in gcase["kern"].items():
        got = _grouped(gcase, packed, fuse_epilogue=mode, failed=r)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"mode={mode} packed={packed} "
                                              f"r={r}")


def test_grouped_plain_matches_jnp_oracles(gcase):
    """Against ``repro.kernels.ref``: the entangled per-expert products
    (full-range and packed int8 weights) and the fused products for every
    failed stream, packed and unpacked."""
    jp, c = gcase["jp"], jnp.asarray(gcase["c"])
    for packed, gj in ((False, gcase["g"]), (True, gcase["g8"])):
        want = np.asarray(jref.entangled_matmul_grouped_ref(
            c, jnp.asarray(gj), jp.l))
        np.testing.assert_array_equal(_grouped(gcase, packed).numpy(), want)
    for r in [None] + list(range(jp.M)):
        want = np.asarray(jref.entangled_matmul_grouped_fused_ref(
            c, jnp.asarray(gcase["g8"]), jp, r=r or 0))
        for packed in (False, True):
            if not packed:  # the oracle's int8 weights, unpacked
                got = ops.entangled_matmul_grouped(
                    torch.from_numpy(gcase["c"]),
                    torch.from_numpy(gcase["g8"]), gcase["tp"],
                    fuse_epilogue=True, failed=r)
            else:
                got = _grouped(gcase, True, fuse_epilogue=True, failed=r)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"r={r} packed={packed}")


def test_grouped_dispatch_rejects_bad_calls():
    plan = make_plan(4, 32)
    c = torch.zeros((4, 2, 3, 8), dtype=torch.int32)
    g = torch.zeros((2, 8, 5), dtype=torch.int32)
    for mode in ("chain", "chain_final"):  # dense-only, as in the reference
        with pytest.raises(ValueError, match="True or False"):
            ops.entangled_matmul_grouped(c, g, plan, fuse_epilogue=mode)
    with pytest.raises(ValueError, match="both operands"):
        ops.entangled_matmul_grouped(c.to("meta"), g, plan)
    with pytest.raises(ValueError, match="streams"):
        ops.entangled_matmul_grouped(c[:3], g, plan)
    with pytest.raises(ValueError, match="experts"):
        ops.entangled_matmul_grouped(c, g[:1], plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        emmg.entangled_matmul_grouped_cuda(c, g, plan)
    # the CPU path never counts a kernel launch
    assert emmg.launches_s8 == emmg.launches_cuda_core == 0


# --------------------------------------------------- the protection layer --

@pytest.fixture(scope="module")
def gdata():
    rng = np.random.default_rng(5)
    return dict(
        x=(rng.standard_normal((2, 3, 7, 48)) * 2).astype(np.float32),
        w=(rng.standard_normal((3, 48, 40)) / 7).astype(np.float32))


def test_protected_matmul_grouped_matches_reference(gdata):
    """Leading batch axis, 14 rows per expert (padded to 16 for M = 4);
    float weights quantized per expert inside the call, and a packed
    startup-style q8 stack with per-expert scales."""
    jp, tp = jmake_plan(4, 32), make_plan(4, 32)
    x, w = gdata["x"], gdata["w"]
    ref = jax.jit(functools.partial(jprot.protected_matmul_grouped, plan=jp,
                                    backend="reference"),
                  static_argnames="failed_group")
    want = _np(ref(jnp.asarray(x), jnp.asarray(w)))
    got = protected_matmul_grouped(torch.from_numpy(x), torch.from_numpy(w),
                                   plan=tp)
    assert got.shape == (2, 3, 7, 40)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    jw = jq.quantize_weight_stacked(jnp.asarray(w), packed=True)
    tq = quantize_weight_stacked(torch.from_numpy(w), packed=True)
    np.testing.assert_array_equal(_np(jw["w"]), tq["w"].numpy())
    np.testing.assert_array_equal(_np(jw["scale"]), tq["scale"].numpy())
    for r in (None, 2):
        want = _np(ref(jnp.asarray(x[0]), (jw["w"], jw["scale"]),
                       failed_group=r))
        got = protected_matmul_grouped(torch.from_numpy(x[0]),
                                       (tq["w"], tq["scale"]), plan=tp,
                                       failed_group=r)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("M", [3, 4, 8])
def test_grouped_failed_group_rolls_forward_exactly(gdata, M):
    """Fused (in-kernel) and unfused (GARBAGE-poisoned stream + separate
    disentangle) recovery equal the healthy output for every group."""
    plan = make_plan(M, 32)
    x = torch.from_numpy(gdata["x"])
    q = quantize_weight_stacked(torch.from_numpy(gdata["w"]), packed=True)
    w = (q["w"], q["scale"])
    healthy = protected_matmul_grouped(x, w, plan=plan)
    for r in range(M):
        for fuse in (True, False):
            got = protected_matmul_grouped(x, w, plan=plan, failed_group=r,
                                           fuse_epilogue=fuse)
            assert torch.equal(got, healthy), (r, fuse)


def test_grouped_census_records_five_tuples(gdata):
    plan = make_plan(4, 32)
    ctx = FTContext(registry=PlanRegistry(plan), scope="moe",
                    census_only=True)
    x = torch.empty((2, 3, 7, 48), device="meta")
    out = ctx.matmul_grouped("moe.gate", x,
                             torch.empty((3, 48, 40), device="meta"))
    assert out.shape == (2, 3, 7, 40) and out.device.type == "meta"
    key = ("moe.gate", (4, 3, 4, 48, 40))  # (M, E, Bg, K, N): 14 rows -> 4
    assert set(ctx.registry.census()) == {key}
    plans = compile_plans(ctx.registry)
    assert len(plans) == 1 and plans.lookup(*key).grouped
    run = FTContext(registry=ctx.registry, scope="moe").with_plans(plans)
    q = quantize_weight_stacked(torch.from_numpy(gdata["w"]), packed=True)
    run.matmul_grouped("moe.gate", torch.from_numpy(gdata["x"]),
                       (q["w"], q["scale"]))
    assert plans.misses == 0


# ------------------------------------------------- params and float layers --

@pytest.fixture(scope="module")
def smoke():
    cfg = jconfigs.get_smoke_config(ARCH)
    params = jax.jit(functools.partial(jget_model(cfg).init, cfg=cfg,
                                       max_seq=16))(jax.random.PRNGKey(3))
    return dict(cfg=cfg, tcfg=tconfigs.get_smoke_config(ARCH), params=params,
                tparams=params_from_numpy(jax.tree.map(np.asarray, params),
                                          device="cpu"))


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


@pytest.mark.parametrize("scope", ["moe", "all"])
def test_prepare_params_q8_stacks_bit_exact(smoke, scope):
    jprep = jax.jit(functools.partial(jplans.prepare_params, scope=scope,
                                      packed=True))(smoke["params"])
    tleaves = dict(_leaves(prepare_params(smoke["tparams"], scope=scope)))
    n_q8 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jprep)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        got = tleaves.pop(key)
        np.testing.assert_array_equal(_np(leaf), got.numpy(), err_msg=str(key))
        n_q8 += any(str(k).endswith("q8") for k in key)
    assert not tleaves  # same tree, leaf for leaf
    # (w, scale) per site: the 3 expert stacks at scope moe; at scope all
    # also MLA q/kv_a/wo in both units (6), the dense layer's MLP (3), the
    # shared expert (3) and the router (1)
    assert n_q8 == 2 * {"moe": 3, "all": 16}[scope]
    moe = prepare_params(smoke["tparams"], scope=scope)["stack"][1][0]["moe"]
    E = smoke["cfg"].moe.n_experts
    assert moe["we_gate_q8"]["scale"].shape == (2, E)  # [repeat, E]
    assert moe["we_down_q8"]["w"].shape == (2, E, 32 // 4, 64)  # packed K


def _layer(params, u, name, i=0):
    return jax.tree.map(lambda t: t[i], params["stack"][u][0][name])


def test_mla_prefill_and_decode_within_bf16_tolerance(smoke):
    """MLA at a prefill chunk offset and at per-row decode positions,
    writing the latent cache."""
    cfg, tcfg = smoke["cfg"], smoke["tcfg"]
    p = _layer(smoke["params"], 1, "attn")
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jc = JL.init_mla_cache(cfg, 3, 16)
    tc = {k: v[0] for k, v in
          TL.init_mla_cache(tcfg, 1, 3, 16, device="cpu").items()}
    for step, (pos, mode, xs) in enumerate((
            (0, "prefill", slice(0, 4)), (4, "prefill", slice(4, 6)),
            (np.array([6, 7, 9]), "decode", slice(0, 1)))):
        jpos = jnp.asarray(pos) if mode == "decode" else pos
        tpos = torch.from_numpy(pos) if mode == "decode" else pos
        want, jc = jax.jit(functools.partial(
            JL.apply_mla, cfg=cfg, mode=mode,
            **({} if mode == "decode" else dict(pos=pos))))(
            p, jx[:, xs], cache=jc, **({"pos": jpos} if mode == "decode"
                                       else {}))
        got, tc = TL.apply_mla(tp, tx[:, xs], cfg=tcfg, cache=tc, pos=tpos,
                               mode=mode)
        want = _np(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=LAYER_TOL * np.abs(want).max(),
                                   err_msg=f"step {step} ({mode})")
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(
            tc[k].float().numpy(), _np(jc[k].astype(jnp.float32)), rtol=0,
            atol=LAYER_TOL * float(np.abs(_np(jc[k].astype(jnp.float32))).max()))


def _jroute(p, h, cfg):
    """The reference's router (``layers.apply_moe``), written out: the
    block's apply does not return its expert choice."""
    logits = jnp.einsum("nd,de->ne", h, p["router"].astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    vals, idx = jax.lax.top_k(probs, cfg.moe.top_k)
    return _np(probs), _np(idx)


def test_moe_block_routing_and_output(smoke):
    """The router's expert choice, then the block's output with a
    bucket-padding mask (pad tokens routed to the virtual expert) and
    without, within the bf16 tolerance."""
    cfg, tcfg = smoke["cfg"], smoke["tcfg"]
    p = _layer(smoke["params"], 1, "moe")
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    h = JL.apply_norm(p["norm"], jx, cfg).reshape(-1, cfg.d_model)
    probs, jidx = _jroute(p, h, cfg)
    _, tidx = TL.route(tp, TL.apply_norm(tp["norm"], tx, tcfg).reshape(
        -1, tcfg.d_model), cfg=tcfg)
    differ = np.nonzero((tidx.numpy() != jidx).any(-1))[0]
    for n in differ:  # only where the reference's own choice is near-tied
        picked = np.sort(probs[n])[::-1][: cfg.moe.top_k + 1]
        assert np.min(np.abs(np.diff(picked))) <= ROUTE_TIE, n
    assert len(differ) <= 1, differ
    lengths = np.array([8, 5, 1, 0])
    valid = np.arange(8)[None, :] < lengths[:, None]
    jmoe = jax.jit(functools.partial(JL.apply_moe, cfg=cfg))
    for v in (None, valid):
        want = _np(jmoe(p, jx, valid=None if v is None
                        else jnp.asarray(v)).astype(jnp.float32))
        got = TL.apply_moe(tp, tx, cfg=tcfg, valid=None if v is None
                           else torch.from_numpy(v)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LAYER_TOL * np.abs(want).max())
