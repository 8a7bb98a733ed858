"""The port's vision-language family (internvl2-2b: a dense GQA decoder
behind precomputed patch embeddings) against the reference, at its smoke
config (2 layers, d_model 64, 8 patches), on the reference's params
bridged over.

The vision frontend is a stub in both packages: a batch carries
``patch_embeds`` [B, P, D] that go before the token embeddings. Checked:
``forward_train`` with patch embeddings (only the text positions give
logits), and ``prefill`` of the prefix and a prompt followed by 8 decode
steps at positions ``P + T + t``, every step's logits within
``LOGIT_TOL`` of the largest |logit| (as in ``test_torch_serve.py``).

The serving engine serves the text path like any dense decoder: at scopes
head and all, a wave with any of the M = 4 groups fail-stopped on every
step gives the healthy wave's tokens bit for bit (the paper's
roll-forward inside the port).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as JA
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import api as TA
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeConfig, ServeEngine

ARCH = "internvl2-2b"
B, PROMPT, MAX_SEQ, DECODE_STEPS = 4, 6, 48, 8
LOGIT_TOL = 2.0 ** -5  # of the largest |logit|, as in test_torch_serve.py
M = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return a.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _setup():
    """(reference cfg, port cfg, reference params, port params, patch
    embeddings, prompt tokens), made once per module."""
    cfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jp = JA.get_model(cfg).init(jax.random.PRNGKey(0), cfg, max_seq=MAX_SEQ)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    patches = rng.standard_normal(
        (B, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return cfg, tcfg, jp, tp, patches, tokens


def _batches(patches, tokens):
    return ({"tokens": jnp.asarray(tokens),
             "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(tokens).long(),
             "patch_embeds": torch.from_numpy(patches)})


def _assert_logits_close(want, got, what):
    want, got = _np(want), _t(got)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    gap = np.abs(got - want).max()
    assert gap <= LOGIT_TOL * np.abs(want).max(), (what, gap)


def test_configs_equal_reference():
    from repro.configs import get_config as jget_config

    for get, jget in ((get_config, jget_config),
                      (get_smoke_config, jget_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get_config(ARCH).vision.n_patches == 256
    assert get_model(get_smoke_config(ARCH)) is TA.DECODER_MODEL


def test_forward_train_with_patches_close():
    cfg, tcfg, jp, tp, patches, tokens = _setup()
    jb, tb = _batches(patches, tokens)
    want = JA._dec_forward_train(jp, jb, cfg)
    got = get_model(tcfg).forward_train(tp, tb, tcfg)
    assert got.shape == (B, PROMPT, cfg.vocab_size)  # text positions only
    _assert_logits_close(want, got, "forward_train")


def test_prefill_with_prefix_then_decode_close():
    cfg, tcfg, jp, tp, patches, tokens = _setup()
    jb, tb = _batches(patches, tokens)
    P = cfg.vision.n_patches
    jcache = JA.get_model(cfg).init_cache(cfg, B, MAX_SEQ)
    tcache = get_model(tcfg).init_cache(tcfg, B, MAX_SEQ, device="cpu")
    jl, jcache = JA._dec_prefill(jp, jb, cfg, jcache)
    tl, tcache = get_model(tcfg).prefill(tp, tb, tcfg, tcache)
    _assert_logits_close(jl, tl, "prefill")
    jdec = jax.jit(functools.partial(JA._dec_decode, cfg=cfg))
    rng = np.random.default_rng(1)
    for s in range(DECODE_STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), P + PROMPT + s)
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache,
                          jnp.asarray(pos, jnp.int32))
        tl, tcache = get_model(tcfg).decode_step(
            tp, torch.from_numpy(tok).long(), tcache, torch.from_numpy(pos),
            tcfg)
        _assert_logits_close(jl, tl, f"decode step {s} at {P}+{PROMPT}+{s}")


def _wave(tp, tcfg, scope, failed_group=None):
    eng = ServeEngine(tcfg, ServeConfig(max_batch=8, max_seq=MAX_SEQ, ft_M=M,
                                        ft_mode="entangle", ft_scope=scope),
                      tp, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=r, prompt=rng.integers(
        0, tcfg.vocab_size, size=int(rng.integers(3, 12))).astype(np.int32),
        max_new=5) for r in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(failed_group=failed_group)
    assert eng.plans is None or eng.plans.misses == 0
    return {r.rid: np.asarray(r.out) for r in reqs}


@functools.lru_cache(maxsize=None)
def _healthy(scope):
    _, tcfg, _, tp = _setup()[:4]
    return _wave(tp, tcfg, scope)


@pytest.mark.parametrize("scope", ["head", "all"])
@pytest.mark.parametrize("failed_group", range(M))
def test_engine_failed_group_rolls_forward_exactly(scope, failed_group):
    _, tcfg, _, tp = _setup()[:4]
    healthy = _healthy(scope)
    injected = _wave(tp, tcfg, scope, failed_group)
    assert set(injected) == set(healthy)
    for rid in healthy:
        assert healthy[rid].shape == (5,)
        np.testing.assert_array_equal(injected[rid], healthy[rid],
                                      err_msg=f"{scope} rid {rid}")
