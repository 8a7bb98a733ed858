"""Training the recurrent families against the reference, on their smoke
configs' params bridged over: falcon-mamba-7b (Mamba-1, 2 layers) and
recurrentgemma-2b (two RG-LRU blocks and a local-attention block with a
window of 16, shorter than the sequence).

  * ``forward_train`` logits, ``lm_loss`` and every leaf's gradient
    against ``jax.grad`` of the reference's loss, at T = 40 (Mamba's
    unchunked scan) and, for Mamba, at T = 128 (its scan in checkpointed
    chunks of 64 in both packages);
  * the chunked scan equals the unchunked one bit for bit (logits and
    gradients): the same steps, recomputed;
  * one ``make_train_step`` (entangled sync) against the reference's;
  * the step with a fail-stopped gradient block equals the healthy one
    bit for bit, on both codecs;
  * ``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu`` trains with finite, falling losses.

XLA's ``exp`` is its own polynomial (test_torch_recurrent.py), and the
bf16 activations round apart by an ulp here and there, so the gradients
agree normwise within a few percent; the tolerances are measured, with
margin.
"""
import functools

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

ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
B = 4
# measured: logits within 2e-3 (falcon) / 1.2e-2 (gemma), the loss within
# 2e-5, each leaf's gradient within 0.6% / 3.5% normwise
LOGITS_TOL = dict(rtol=0.0, atol=0.0625)  # test_torch_train.py's
LOSS_ATOL = 1e-4
GRAD_REL = 2.0 ** -4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the scans are thousands of tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref(arch, T):
    """The reference's params, a seeded batch [B, T] and its loss, logits
    and gradients; built once per module."""
    cfg = jsmoke(arch)
    params = oracle.init_params(cfg, max_seq=T)
    tokens = np.random.default_rng(T).integers(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return dict(params=params, tokens=tokens,
                fwd=oracle.loss_logits_grads(cfg, params, tokens))


def _inputs(ref):
    return (params_from_numpy(ref["params"], device="cpu"),
            {"tokens": torch.from_numpy(ref["tokens"])})


@pytest.mark.parametrize("arch,T", [("falcon-mamba-7b", 40),
                                    ("falcon-mamba-7b", 128),
                                    ("recurrentgemma-2b", 40)])
def test_forward_loss_and_grads_vs_reference(arch, T):
    ref = _ref(arch, T)
    cfg = get_smoke_config(arch)
    params, batch = _inputs(ref)
    logits = get_model(cfg).forward_train(params, batch, cfg)
    np.testing.assert_allclose(logits.detach().numpy(), ref["fwd"]["logits"],
                               **LOGITS_TOL)
    assert abs(lm_loss(logits, batch, cfg).item()
               - ref["fwd"]["loss"]) < LOSS_ATOL
    _, grads = loss_and_grads(cfg, params, batch)
    oracle.assert_grads_close(grads, ref["fwd"]["grads"], GRAD_REL)


def test_mamba_chunked_scan_equals_unchunked(monkeypatch):
    """At T = 128 the scan runs in two checkpointed chunks of 64; with the
    chunk raised past T it runs whole: the same logits and gradients, bit
    for bit."""
    cfg = get_smoke_config("falcon-mamba-7b")
    params, batch = _inputs(_ref("falcon-mamba-7b", 128))
    calls = []
    chunked = TL._mamba_scan_chunked
    monkeypatch.setattr(TL, "_mamba_scan_chunked",
                        lambda *a: calls.append(1) or chunked(*a))
    want = get_model(cfg).forward_train(params, batch, cfg)
    lw, gw = loss_and_grads(cfg, params, batch)
    assert len(calls) == 2 * cfg.n_layers
    monkeypatch.setattr(TL, "MAMBA_CHUNK", 256)
    assert torch.equal(get_model(cfg).forward_train(params, batch, cfg), want)
    lg, gg = loss_and_grads(cfg, params, batch)
    assert len(calls) == 2 * cfg.n_layers and torch.equal(lg, lw)
    for a, b in zip(leaves(gg), leaves(gw)):
        assert torch.equal(a, b)


def _tstate(ref):
    params, _ = _inputs(ref)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_vs_reference(arch):
    ref = _ref(arch, 40)
    want = oracle.train_step(jsmoke(arch), ref["params"], ref["tokens"],
                             max_seq=40, grad_sync="entangle")
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(max_seq=40, grad_sync="entangle", grad_codec="kernel")
    new, metrics = make_train_step(cfg, tcfg)(_tstate(ref), _inputs(ref)[1])
    oracle.assert_step_close(new, metrics, want, LOSS_ATOL)


@pytest.mark.parametrize("codec", ["plain", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_failstop_step_bit_identical(arch, codec):
    ref = _ref(arch, 40)
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(max_seq=40, grad_sync="entangle", grad_codec=codec)
    batch = _inputs(ref)[1]
    s_clean, m_clean = make_train_step(cfg, tcfg)(_tstate(ref), batch)
    s_fail, m_fail = make_train_step(cfg, tcfg, failed_block=3)(
        _tstate(ref), batch)
    assert m_fail["ne_failed"] == 3 and m_clean["ne_failed"] == -1
    for a, b in zip(leaves(s_clean), leaves(s_fail)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_the_cpu(arch, tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
          "--seq", "32", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "grad_sync=entangle codec=plain" in out
    first, last = (float(x) for x in out.split("done: loss ")[1].split(
        " -> "))
    assert np.isfinite([first, last]).all() and last < first
