"""The port's llama3.2-1b decoder against the reference on bridged params.

Both packages compute from the same float32 weights (the reference's
params, bridged leaf for leaf). The float path is compared within a
tolerance, never bitwise: XLA and torch order the float32 sums of the
attention scores and of softmax differently (and XLA's ``exp`` is its own
polynomial), so about 0.15% of a layer's bf16 attention outputs round one
ulp apart; the residual stream then carries those flips into every later
matmul, and the final hidden states differ by a few bf16 ulps (observed
max 0.04 at |h| ~ 3). Norms, rope, the bf16 matmuls and the MLP are
bit-identical in isolation (``layers.silu`` reproduces the reference's
per-op bf16 rounding of ``jax.nn.silu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.models import get_model
from repro_torch.models import layers as TL

# a few bf16 ulps at the hidden states' scale (see the module docstring)
HIDDEN_TOL = dict(rtol=0.0, atol=0.0625)


@pytest.fixture(scope="module")
def ref():
    cfg = get_smoke_config("llama3.2-1b")
    jm = jget_model(cfg)
    params = jm.init(jax.random.PRNGKey(0), cfg, max_seq=32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(4, 8)).astype(np.int32)
    lengths = np.array([8, 5, 3, 8], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, size=(3, 4, 1)).astype(np.int32)
    cache = jm.init_cache(cfg, 4, 32)
    h, cache = jm.prefill_chunk(params, jnp.asarray(tokens), cfg, cache,
                                pos0=0, lengths=jnp.asarray(lengths))
    dec, pos = [], lengths.copy()
    for t in range(3):  # per-row positions differ (ragged prompts)
        hd, cache = jm.decode_hidden(params, jnp.asarray(nxt[t]), cache,
                                     jnp.asarray(pos), cfg)
        dec.append(np.asarray(hd.astype(jnp.float32)))
        pos += 1
    return dict(cfg=cfg, params=params, tokens=tokens, lengths=lengths,
                nxt=nxt, prefill=np.asarray(h.astype(jnp.float32)), dec=dec,
                head=np.asarray(jm.head_weights(params, cfg)))


def test_prefill_and_decode_hidden_within_bf16_tolerance(ref):
    cfg = tget_smoke("llama3.2-1b")
    model = get_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params"]),
                               device="cpu")
    cache = model.init_cache(cfg, 4, 32, device="cpu")
    h, cache = model.prefill_chunk(
        params, torch.from_numpy(ref["tokens"]).long(), cfg, cache, pos0=0,
        lengths=torch.from_numpy(ref["lengths"]))
    assert h.dtype == TL.ACT_DTYPE and h.shape == (4, 8, cfg.d_model)
    np.testing.assert_allclose(h.float().numpy(), ref["prefill"],
                               **HIDDEN_TOL)
    pos = torch.from_numpy(ref["lengths"]).long()
    for t in range(3):
        hd, cache = model.decode_hidden(
            params, torch.from_numpy(ref["nxt"][t]).long(), cache, pos, cfg)
        np.testing.assert_allclose(hd.float().numpy(), ref["dec"][t],
                                   **HIDDEN_TOL)
        pos = pos + 1
    np.testing.assert_array_equal(model.head_weights(params, cfg).numpy(),
                                  ref["head"])


def test_layer_pieces_bit_identical(ref):
    """Norm, silu and the bf16 dense projection equal the reference
    exactly on identical inputs."""
    cfg = ref["cfg"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    p = jax.tree.map(lambda t: t[0], ref["params"]["stack"][0][0]["mlp"])
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(JL.apply_mlp(p, jx, cfg=cfg).astype(jnp.float32))
    np.testing.assert_array_equal(
        TL.apply_mlp(tp, tx, cfg=cfg).float().numpy(), want)
    np.testing.assert_array_equal(
        TL.silu(tx).float().numpy(),
        np.asarray(jax.nn.silu(jx).astype(jnp.float32)))


def test_entry_points_default_to_cuda():
    """With no device given, the entry points run on CUDA, and without a
    GPU they raise instead of falling back to the CPU."""
    cfg = tget_smoke("llama3.2-1b")
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert model.init_cache(cfg, 1, 4)[0][0]["k"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init(gen, cfg, max_seq=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_cache(cfg, 1, 4)
    p = model.init(gen, cfg, max_seq=8, device="cpu")
    assert p["embed"]["tok"].shape == (cfg.vocab_size, cfg.d_model)
    assert p["stack"][0][0]["mlp"]["down"]["w"].shape == (
        cfg.n_layers, cfg.d_ff, cfg.d_model)
