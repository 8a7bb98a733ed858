"""Training the MLA + MoE family (deepseek-v2-lite-16b's smoke config:
a dense first layer, then two MLA + MoE layers of 8 experts, top-2, one
shared expert) against the reference, on its own params bridged over.

The router's top-k is discontinuous: where the two frameworks' gate
probabilities of a token's k-th and (k+1)-th expert lie closer than their
float rounding, they pick different experts, and everything downstream
(that token, the later tokens of its row through attention, whatever the
capacity then drops) differs by more than any float tolerance. So the
float comparisons drive the port along the reference's own routes
(recorded as the reference runs; the port's gate probabilities at them),
and a separate test holds the port's own choice to the reference's but at
near-ties (gap <= 2**-9, as in test_torch_serve_moe.py). The batch
overflows expert capacity (asserted), so the drops are compared too.

  * ``forward_train`` logits, ``lm_loss`` and every leaf's gradient
    against ``jax.grad`` of the reference's loss;
  * one ``make_train_step`` (entangled sync, both codecs) against the
    reference's jitted step;
  * the step with a fail-stopped gradient block equals the healthy one
    bit for bit, on both codecs;
  * ``dispatch='global_sort'`` equals ``'grouped'`` (one dispatch group on
    one device), dropless and at the default capacity, and capacity
    dropping is deterministic (mirrors tests/test_perf_variants.py);
  * ``python -m repro_torch.launch.train --arch deepseek-v2-lite-16b
    --smoke --device cpu`` trains with finite, falling losses.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _train_oracle as oracle
from repro.configs import get_smoke_config as jsmoke
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model, lm_loss
from repro_torch.models import layers as TL
from repro_torch.optim import adamw
from repro_torch.train.train_step import (TrainConfig, loss_and_grads,
                                          make_train_step)
from repro_torch.tree import leaves

ARCH = "deepseek-v2-lite-16b"
B, T = 4, 32
# float tolerances against the reference along its routes (measured, with
# margin): bf16 activations of the two frameworks round apart by an ulp
# here and there (test_torch_moe.py), which moves the logits by up to
# ~8e-3 and each leaf's gradient by up to 2.5% normwise
LOGITS_TOL = dict(rtol=0.0, atol=0.0625)  # test_torch_train.py's
LOSS_ATOL = 1e-4
GRAD_REL = 2.0 ** -4
# top-k gaps at or below this are near-ties (test_torch_serve_moe.py)
NEAR_TIE = 2.0 ** -9


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
    cfg = jsmoke(ARCH)
    params = oracle.init_params(cfg, max_seq=64)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return dict(params=params, tokens=tokens,
                fwd=oracle.loss_logits_grads(cfg, params, tokens),
                step=oracle.train_step(cfg, params, tokens, max_seq=64,
                                       grad_sync="entangle"))


def _params(ref):
    return params_from_numpy(ref["params"], device="cpu")


def _batch(ref):
    return {"tokens": torch.from_numpy(ref["tokens"])}


def test_reference_batch_overflows_capacity(ref):
    """Some expert of each MoE layer gets more assignments than its
    capacity, so the comparisons below include capacity drops."""
    cfg = get_smoke_config(ARCH)
    C = TL._moe_capacity(B * T, cfg)
    routes = ref["fwd"]["routes"]
    assert len(routes) == cfg.n_layers - cfg.moe.first_dense_layers
    for r in routes:
        assert np.bincount(r.ravel(), minlength=cfg.moe.n_experts).max() > C


def test_forward_loss_and_grads_vs_reference(ref):
    cfg = get_smoke_config(ARCH)
    params, batch, want = _params(ref), _batch(ref), ref["fwd"]
    with oracle.force_routes(want["routes"]):
        logits = get_model(cfg).forward_train(params, batch, cfg)
        loss, grads = loss_and_grads(cfg, params, batch)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               **LOGITS_TOL)
    assert abs(lm_loss(logits, batch, cfg).item() - want["loss"]) < LOSS_ATOL
    assert loss.item() == lm_loss(logits, batch, cfg).item()
    oracle.assert_grads_close(grads, want["grads"], GRAD_REL)


def test_router_picks_the_reference_experts_but_at_near_ties(ref):
    """Fed the reference's upstream routes, each MoE layer's router picks
    the reference's experts for every token whose k-th and (k+1)-th gate
    probabilities lie more than NEAR_TIE apart."""
    cfg = get_smoke_config(ARCH)
    routes = ref["fwd"]["routes"]
    with oracle.force_routes(routes) as own:
        get_model(cfg).forward_train(_params(ref), _batch(ref), cfg)
    assert len(own) == len(routes)
    for (ids, gap), want in zip(own, routes):
        differ = (np.sort(ids.numpy(), 1) != np.sort(want, 1)).any(1)
        assert (gap.numpy()[differ] <= NEAR_TIE).all(), \
            (np.where(differ), gap.numpy()[differ])


def _tstate(ref):
    params = _params(ref)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.mark.parametrize("codec", ["plain", "kernel"])
def test_train_step_vs_reference(ref, codec):
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(max_seq=64, grad_sync="entangle", grad_codec=codec)
    want = ref["step"]
    with oracle.force_routes(want["routes"]):
        new, metrics = make_train_step(cfg, tcfg)(_tstate(ref), _batch(ref))
    assert metrics["ne_failed"] == -1
    oracle.assert_step_close(new, metrics, want, LOSS_ATOL)


@pytest.mark.parametrize("codec", ["plain", "kernel"])
def test_failstop_step_bit_identical(ref, codec):
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(max_seq=64, grad_sync="entangle", grad_codec=codec)
    s_clean, m_clean = make_train_step(cfg, tcfg)(_tstate(ref), _batch(ref))
    s_fail, m_fail = make_train_step(cfg, tcfg, failed_block=1)(
        _tstate(ref), _batch(ref))
    assert m_fail["ne_failed"] == 1 and m_clean["ne_failed"] == -1
    for a, b in zip(leaves(s_clean), leaves(s_fail)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capacity_factor", [None, 1e9])
def test_global_sort_matches_grouped(ref, capacity_factor):
    """On one device both dispatches are one group over the whole batch:
    equal logits and gradients, dropless and at the default capacity
    (where tokens are dropped); a second run drops the same tokens."""
    cfg = get_smoke_config(ARCH)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    cfg_s = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="global_sort"))
    params, batch = _params(ref), _batch(ref)
    la, ga = loss_and_grads(cfg, params, batch)
    for c in (cfg_s, cfg):
        lb, gb = loss_and_grads(c, params, batch)
        assert torch.equal(la, lb)
        for a, b in zip(leaves(ga), leaves(gb)):
            assert torch.equal(a, b)


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
          "--seq", "32", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "grad_sync=entangle codec=plain" in out
    first, last = (float(x) for x in out.split("done: loss ")[1].split(
        " -> "))
    assert np.isfinite([first, last]).all() and last < first
