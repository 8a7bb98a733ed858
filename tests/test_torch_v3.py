"""deepseek-v3-671b in the port against the reference, on its smoke config
(a dense first layer, then three MLA + MoE layers of 8 experts, top-2,
sigmoid gating, one shared expert; MLA with a low-rank Q; the MTP head)
with the reference's params bridged over.

  * the configs equal the reference's, and the bridge carries the ``mtp``
    subtree across leaf for leaf, with the port's own layout;
  * the low-rank-Q MLA block in train mode, in prefill (a whole bucket, a
    chunk at an offset, token-packed rows at their own offsets) and in
    decode, within test_torch_moe.py's LAYER_TOL;
  * ``prepare_params`` never quantizes ``mtp`` and its int8 grids at
    scopes moe and all equal the reference's bit for bit;
  * ``forward_train``'s logits and MTP logits, ``lm_loss`` naive and
    streamed, and every leaf's gradient against ``jax.grad``, driven along
    the reference's recorded routes (test_torch_train_moe.py says why);
  * one train step against the reference's jitted step, and the
    fail-stopped step bit-identical to the healthy one on both codecs;
  * ``dispatch='global_sort'`` equals ``'grouped'`` (counterpart of
    tests/test_perf_variants.py::test_grouped_dispatch_matches_global_sort);
  * bf16 masters (``init(master_dtype=torch.bfloat16)``) give the int8
    grids, logits and tokens of float32 masters holding the same values.

The serving engine against the reference's is tests/test_torch_serve_v3.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_oracle as oracle
from repro import configs as jconfigs
from repro.ft import plans as jplans
from repro.models import layers as JL
from repro.models.api import lm_loss as jlm_loss
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.ft import prepare_params
from repro_torch.ft.quantize import quantize_weight
from repro_torch.models import get_model, lm_loss
from repro_torch.models import layers as TL
from repro_torch.optim import adamw
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.train.train_step import (TrainConfig, loss_and_grads,
                                          make_train_step)
from repro_torch.tree import leaves, leaves_with_path, tree_map

ARCH = "deepseek-v3-671b"
B, T = 4, 32
MAX_SEQ = 64
# test_torch_train_moe.py's tolerances along the reference's routes, but
# the loss's: bf16 activations of the two frameworks an ulp apart here and
# there move the logits by up to ~1.1e-2 (mean 1.3e-3) through these four
# layers and the MTP block, and the loss by 1.4e-4 (measured; the loss
# function itself agrees within 1e-6 on equal logits)
LOGITS_TOL = dict(rtol=0.0, atol=0.0625)
LOSS_ATOL = 2.5e-4
GRAD_REL = 2.0 ** -4
# test_torch_moe.py's: a few bf16 ulps of the largest output of one layer
LAYER_TOL = 2.0 ** -6
SCOPES = ("moe", "all")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: each bit-for-bit comparison of two runs then
    sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's params, its forward / loss / gradients and one train
    step, built once."""
    cfg = jconfigs.get_smoke_config(ARCH)
    params = oracle.init_params(cfg, max_seq=MAX_SEQ)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return dict(
        cfg=cfg, params=params, tokens=tokens,
        fwd=oracle.loss_logits_grads(cfg, params, tokens),
        step=oracle.train_step(cfg, params, tokens, max_seq=MAX_SEQ,
                               grad_sync="entangle"))


def _params(ref):
    return params_from_numpy(ref["params"], device="cpu")


def _batch(ref):
    return {"tokens": torch.from_numpy(ref["tokens"])}


def test_v3_configs_equal_reference():
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(tconfigs, get)(ARCH), getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), get
        assert list(t.layer_pattern()) == list(j.layer_pattern())
    assert ARCH in tconfigs.PORTED


def test_bridge_carries_mtp(ref):
    """The bridged params hold ``mtp`` (``proj`` [2D, D], a repeat-1
    ``attn_dense`` block with the low-rank-Q MLA, ``norm_h``, ``norm_e``)
    and have exactly the leaves, shapes and dtypes of the port's own
    ``init``."""
    cfg = tconfigs.get_smoke_config(ARCH)
    bridged = _params(ref)
    own = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                              MAX_SEQ, device="cpu")
    shape = lambda tree: [(p, tuple(t.shape), t.dtype)  # noqa: E731
                          for p, t in leaves_with_path(tree)]
    assert shape(bridged) == shape(own)
    mtp = bridged["mtp"]
    assert sorted(mtp) == ["block", "norm_e", "norm_h", "proj"]
    assert tuple(mtp["proj"]["w"].shape) == (2 * cfg.d_model, cfg.d_model)
    assert tuple(mtp["block"]["attn"]["wq_b"]["w"].shape) == (
        1, cfg.mla.q_lora_rank, cfg.n_heads * (cfg.mla.qk_nope_head_dim
                                              + cfg.mla.qk_rope_head_dim))
    for (_, a), b in zip(leaves_with_path(bridged["mtp"]),
                         jax.tree.leaves(ref["params"]["mtp"])):
        assert torch.equal(a, torch.from_numpy(np.asarray(b)))


def _mla_layer(ref, u=1):
    p = jax.tree.map(lambda t: t[0], ref["params"]["stack"][u][0]["attn"])
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _close(got, want, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=LAYER_TOL * np.abs(want).max(),
                               err_msg=what)


def test_low_rank_q_mla_in_every_mode(ref):
    """Train mode (the sequence's own latents), a whole-bucket prefill, a
    chunk at offset 4, decode at per-row positions, and token-packed rows
    at their own offsets, each writing the latent cache."""
    cfg, tcfg = ref["cfg"], tconfigs.get_smoke_config(ARCH)
    p, tp = _mla_layer(ref)
    assert "wq_a" in tp and "q_norm" in tp and "wq" not in tp
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = jax.jit(functools.partial(JL.apply_mla, cfg=cfg,
                                        mode="train"))(p, jx)
    got, _ = TL.apply_mla(tp, tx, cfg=tcfg, cache=None, pos=None,
                          mode="train")
    _close(got, want, "train")
    jc = JL.init_mla_cache(cfg, 3, 16)
    tc = {k: v[0] for k, v in
          TL.init_mla_cache(tcfg, 1, 3, 16, device="cpu").items()}
    for step, (pos, mode, xs) in enumerate((
            (0, "prefill", slice(0, 4)), (4, "prefill", slice(4, 6)),
            (np.array([6, 7, 9]), "decode", slice(0, 1)))):
        kw = dict(pos=pos) if mode == "prefill" else {}
        want, jc = jax.jit(functools.partial(JL.apply_mla, cfg=cfg,
                                             mode=mode, **kw))(
            p, jx[:, xs], cache=jc,
            **({"pos": jnp.asarray(pos)} if mode == "decode" else {}))
        got, tc = TL.apply_mla(tp, tx[:, xs], cfg=tcfg, cache=tc,
                               pos=torch.from_numpy(pos)
                               if mode == "decode" else pos, mode=mode)
        _close(got, want, f"step {step} ({mode})")
    for k in ("ckv", "krope"):
        _close(tc[k], jc[k], k)
    # token-packed: three rows, each a 2-token chunk at its own offset of
    # the caches filled above
    off = np.array([7, 2, 10], np.int32)
    want, jc = jax.jit(functools.partial(JL.apply_mla, cfg=cfg,
                                         mode="prefill"))(
        p, jx[:, 4:6], cache=jc, pos=jnp.asarray(off))
    got, tc = TL.apply_mla(tp, tx[:, 4:6], cfg=tcfg, cache=tc,
                           pos=torch.from_numpy(off).long(), mode="prefill")
    _close(got, want, "packed")
    for k in ("ckv", "krope"):
        _close(tc[k], jc[k], f"packed {k}")


def _key(path):
    return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)


def _tleaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _tleaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _tleaves(v, path + (i,))
    else:
        yield path, node


@pytest.mark.parametrize("scope", SCOPES)
def test_prepare_params_skips_mtp_and_grids_bit_exact(ref, scope):
    jprep = jax.jit(functools.partial(jplans.prepare_params, scope=scope,
                                      packed=True))(ref["params"])
    tprep = prepare_params(_params(ref), scope=scope)
    tleaves = dict(_tleaves(tprep))
    n_q8 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jprep)[0]:
        key = _key(path)
        np.testing.assert_array_equal(np.asarray(leaf),
                                      tleaves.pop(key).numpy(),
                                      err_msg=str(key))
        n_q8 += any(str(k).endswith("q8") for k in key)
    assert not tleaves
    assert not any("q8" in str(k) for k, _ in _tleaves(tprep["mtp"]))
    # (w, scale) per site: the 3 expert stacks at scope moe; at all also
    # MLA q_a / q / kv / wo in both units (8), the dense layer's MLP (3),
    # the shared expert (3) and the router (1)
    assert n_q8 == 2 * {"moe": 3, "all": 18}[scope]


def test_forward_loss_and_grads_vs_reference(ref):
    """Logits and MTP logits, the naive loss (with its 0.3-weighted t+2
    term) and every leaf's gradient, the MTP block's included."""
    cfg = tconfigs.get_smoke_config(ARCH)
    params, batch, want = _params(ref), _batch(ref), ref["fwd"]
    with oracle.force_routes(want["routes"]):
        logits = get_model(cfg).forward_train(params, batch, cfg)
        loss, grads = loss_and_grads(cfg, params, batch)
    assert isinstance(logits, tuple) and len(logits) == 2
    for got, w in zip(logits, want["logits"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), w, **LOGITS_TOL)
    assert abs(loss.item() - want["loss"]) < LOSS_ATOL
    assert loss.item() == lm_loss(logits, batch, cfg).item()
    assert "mtp" in grads and torch.count_nonzero(
        grads["mtp"]["proj"]["w"]) > 0
    oracle.assert_grads_close(grads, want["grads"], GRAD_REL)


def test_streamed_loss_and_grads_vs_reference(ref):
    """``loss_impl='streamed'``: both terms through ``streamed_lm_ce``
    (``shift`` 1 and 2); the loss within LOSS_ATOL of the reference's
    streamed loss of its own logits, the gradients within GRAD_REL of
    ``jax.grad`` of its naive loss (the same function)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              loss_impl="streamed")
    jcfg = dataclasses.replace(ref["cfg"], loss_impl="streamed")
    want = ref["fwd"]
    jloss = float(jlm_loss(tuple(jnp.asarray(x) for x in want["logits"]),
                           {"tokens": jnp.asarray(ref["tokens"])}, jcfg))
    assert abs(jloss - want["loss"]) < LOSS_ATOL
    with oracle.force_routes(want["routes"]):
        loss, grads = loss_and_grads(cfg, _params(ref), _batch(ref))
    assert abs(loss.item() - jloss) < LOSS_ATOL
    oracle.assert_grads_close(grads, want["grads"], GRAD_REL)


def _tstate(ref):
    params = _params(ref)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.mark.parametrize("codec", ["plain", "kernel"])
def test_train_step_vs_reference(ref, codec):
    cfg = tconfigs.get_smoke_config(ARCH)
    tcfg = TrainConfig(max_seq=MAX_SEQ, grad_sync="entangle",
                       grad_codec=codec)
    want = ref["step"]
    with oracle.force_routes(want["routes"]):
        new, metrics = make_train_step(cfg, tcfg)(_tstate(ref), _batch(ref))
    assert metrics["ne_failed"] == -1
    oracle.assert_step_close(new, metrics, want, LOSS_ATOL)


@pytest.mark.parametrize("codec", ["plain", "kernel"])
def test_failstop_step_bit_identical(ref, codec):
    cfg = tconfigs.get_smoke_config(ARCH)
    tcfg = TrainConfig(max_seq=MAX_SEQ, grad_sync="entangle",
                       grad_codec=codec)
    s_clean, m_clean = make_train_step(cfg, tcfg)(_tstate(ref), _batch(ref))
    s_fail, m_fail = make_train_step(cfg, tcfg, failed_block=1)(
        _tstate(ref), _batch(ref))
    assert m_fail["ne_failed"] == 1 and m_clean["ne_failed"] == -1
    for a, b in zip(leaves(s_clean), leaves(s_fail)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capacity_factor", [None, 1e9])
def test_global_sort_matches_grouped(ref, capacity_factor):
    """One dispatch group over the whole batch on one device: equal logits
    (both heads) and gradients, dropless and at the default capacity."""
    cfg = tconfigs.get_smoke_config(ARCH)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    cfg_s = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="global_sort"))
    params, batch = _params(ref), _batch(ref)
    la, ga = loss_and_grads(cfg, params, batch)
    lb, gb = loss_and_grads(cfg_s, params, batch)
    assert torch.equal(la, lb)
    for a, b in zip(leaves(ga), leaves(gb)):
        assert torch.equal(a, b)


def test_bf16_masters_match_float32_holding_their_values():
    """``master_dtype=torch.bfloat16`` stores every weight read through a
    bf16 cast as bf16 (norms stay float32); against float32 masters
    holding the same values: the int8 grids of ``prepare_params`` at both
    scopes and of the head, the training logits, and the engine's tokens
    at scope all, all equal."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = get_model(cfg)
    p16 = model.init(torch.Generator().manual_seed(1), cfg, MAX_SEQ,
                     device="cpu", master_dtype=torch.bfloat16)
    p32 = tree_map(lambda t: t.to(torch.float32), p16)
    kinds = {p: t.dtype for p, t in leaves_with_path(p16)}
    assert all(d == torch.float32 for p, d in kinds.items()
               if "norm" in p)
    assert all(d == torch.bfloat16 for p, d in kinds.items()
               if "norm" not in p)
    for scope in SCOPES:
        a = leaves(prepare_params(p16, scope=scope))
        b = leaves(prepare_params(p32, scope=scope))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype or x.dtype == torch.bfloat16
            assert torch.equal(x.to(y.dtype), y)
    for x, y in zip(quantize_weight(model.head_weights(p16, cfg)),
                    quantize_weight(model.head_weights(p32, cfg))):
        assert torch.equal(x, y)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 16)))}
    for x, y in zip(model.forward_train(p16, batch, cfg),
                    model.forward_train(p32, batch, cfg)):
        assert torch.equal(x, y)
    toks = []
    for p in (p16, p32):
        eng = ServeEngine(cfg, ServeConfig(max_batch=8, max_seq=32, ft_M=4,
                                           ft_mode="entangle",
                                           ft_scope="all"), p, device="cpu")
        rng = np.random.default_rng(0)
        for r in range(8):
            eng.submit(Request(rid=r, max_new=4, prompt=rng.integers(
                0, cfg.vocab_size, size=8).astype(np.int32)))
        toks.append([np.asarray(r.out) for r in eng.run_to_completion()])
        assert eng.plans.misses == 0
    np.testing.assert_array_equal(np.stack(toks[0]), np.stack(toks[1]))
