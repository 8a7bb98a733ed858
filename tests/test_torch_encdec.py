"""The port's encoder-decoder family (whisper-small) against the reference,
at its smoke config (2 encoder and 2 decoder layers, d_model 64, 16
frames), on the reference's params bridged over; and the blocked
attention forward past the reference's materialization limit.

Pieces, each on the same inputs in both packages: the LayerNorm, the
encoder's output (sinusoidal positions, bidirectional attention, the
ungated gelu MLP, ``enc_norm``), the cross-attention keys and values of
every decoder layer, the whole-prompt prefill's logits, 8 decode steps at
mixed per-row positions (the rows 0, 1, 0 and 2 positions apart, so
that each row reads its own learned position and its own cache extent),
and ``forward_train``'s logits. Tolerances: the norm bit for bit; the
bf16 encoder output and cross keys within a few bf16 ulps of its
magnitude (~3.4: XLA fuses the scanned layer body and keeps some bf16
intermediates in float32); logits within ``LOGIT_TOL`` of the largest
|logit|, as in ``test_torch_serve.py``.

The serving engine refuses whisper as the reference's does: a
ValueError at any ``ft_scope`` but ``head``, and at ``head`` the first
step's prefill raises NotImplementedError (it needs frames).
``prepare_params`` walks the ``self``, ``cross`` and ``enc`` subtrees
into the reference's int8 copies, bit for bit.

``attend`` at T = S = 1100 (above 2048**2 / 4 scores) takes the
reference's blocked online-softmax forward in both packages; kinds full
and causal, with keys padded to the 512 block, agree within a few
float32 ulps (the blocked sums in the same order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as JA
from repro.models import attention_core as JC
from repro.models import layers as JL
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import api as TA
from repro_torch.models import attention_core as TC
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.serve import Request, ServeConfig, ServeEngine

ARCH = "whisper-small"
B, PROMPT, MAX_SEQ, DECODE_STEPS = 4, 6, 32, 8
# per-row position offsets of the decode steps (mixed positions)
ROW_OFFSETS = np.array([0, 1, 0, 2])
# a few bf16 ulps (2**-6 at magnitude 2..4) of the encoder's bf16 output
HIDDEN_TOL = dict(rtol=0.0, atol=2.0 ** -4)
LOGIT_TOL = 2.0 ** -5  # of the largest |logit|, as in test_torch_serve.py
# float32 sums of the blocked forward, same blocks, same order
ATTEND_TOL = dict(rtol=0.0, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small ops, which thread handoffs only
    slow down beside other test workers."""
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
    """(reference cfg, port cfg, reference params, port params, frames,
    prompt tokens), made once per module."""
    cfg, tcfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jp = JA.get_model(cfg).init(jax.random.PRNGKey(0), cfg, max_seq=MAX_SEQ)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return cfg, tcfg, jp, tp, frames, tokens


def _batches(frames, tokens):
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tokens).long(),
             "frames": torch.from_numpy(frames)})


@functools.lru_cache(maxsize=None)
def _encoded():
    cfg, tcfg, jp, tp, frames, _ = _setup()
    return (JA._encode(jp, jnp.asarray(frames), cfg),
            TA._encode(tp, torch.from_numpy(frames), tcfg))


def _assert_logits_close(want, got, what):
    want, got = _np(want), _t(got)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    gap = np.abs(got - want).max()
    assert gap <= LOGIT_TOL * np.abs(want).max(), (what, gap)


def test_config_is_ported():
    cfg, tcfg = _setup()[:2]
    assert tcfg == get_smoke_config(ARCH)
    assert get_model(tcfg) is TA.ENCDEC_MODEL
    assert tcfg.family == cfg.family == "encdec"


def test_layernorm_bit_identical():
    cfg, tcfg, jp, tp = _setup()[:4]
    x = (np.random.default_rng(1).standard_normal((B, 7, cfg.d_model))
         * 3).astype(np.float32)
    scale = np.random.default_rng(2).standard_normal(cfg.d_model)
    p = {"scale": scale.astype(np.float32),
         "bias": (scale[::-1] * 0.1).astype(np.float32)}
    want = JL.apply_norm(jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x, jnp.bfloat16), cfg)
    got = TL.apply_norm({k: torch.from_numpy(v.copy()) for k, v in p.items()},
                        torch.from_numpy(x).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_t(got), _np(want))


def test_encoder_output_close():
    want, got = _encoded()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_t(got), _np(want), **HIDDEN_TOL)


def test_cross_kv_close():
    cfg, tcfg, jp, tp = _setup()[:4]
    je, te = _encoded()
    jk, jv = JA._cross_kv(jp["stack"], je, cfg)
    tk, tv = TA._cross_kv(tp["stack"], te, tcfg)
    for want, got in ((jk, tk), (jv, tv)):
        assert got.shape == want.shape == (
            cfg.n_layers, B, cfg.encoder.n_frames, cfg.n_kv_heads,
            cfg.resolved_head_dim)
        np.testing.assert_allclose(_t(got), _np(want), **HIDDEN_TOL)


def test_forward_train_close():
    cfg, tcfg, jp, tp, frames, tokens = _setup()
    jb, tb = _batches(frames, tokens)
    _assert_logits_close(JA._ed_forward_train(jp, jb, cfg),
                         TA._ed_forward_train(tp, tb, tcfg), "forward_train")


def test_prefill_then_mixed_position_decode_close():
    """The whole-prompt prefill's logits, then 8 decode steps with the
    rows at different positions (``ROW_OFFSETS``), each step's logits."""
    cfg, tcfg, jp, tp, frames, tokens = _setup()
    jb, tb = _batches(frames, tokens)
    jcache = JA.get_model(cfg).init_cache(cfg, B, MAX_SEQ)
    tcache = get_model(tcfg).init_cache(tcfg, B, MAX_SEQ, device="cpu")
    jl, jcache = JA._ed_prefill(jp, jb, cfg, jcache)
    tl, tcache = get_model(tcfg).prefill(tp, tb, tcfg, tcache)
    _assert_logits_close(jl, tl, "prefill")
    np.testing.assert_array_equal(_t(tcache["cross_k"]),
                                  _t(TA._cross_kv(tp["stack"], _encoded()[1],
                                                  tcfg)[0]))
    rng = np.random.default_rng(3)
    jdec = jax.jit(functools.partial(JA._ed_decode, cfg=cfg))
    for s in range(DECODE_STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = PROMPT + s + ROW_OFFSETS
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache,
                          jnp.asarray(pos, jnp.int32))
        tl, tcache = get_model(tcfg).decode_step(
            tp, torch.from_numpy(tok).long(), tcache, torch.from_numpy(pos),
            tcfg)
        _assert_logits_close(jl, tl, f"decode step {s}")


def test_decode_hidden_refuses_ft_as_reference():
    cfg, tcfg, jp, tp = _setup()[:4]
    tcache = get_model(tcfg).init_cache(tcfg, B, MAX_SEQ, device="cpu")
    with pytest.raises(NotImplementedError) as theirs:
        JA._ed_decode_hidden(jp, jnp.zeros((B, 1), jnp.int32),
                             JA.get_model(cfg).init_cache(cfg, B, MAX_SEQ),
                             jnp.zeros((B,), jnp.int32), cfg, ft=object())
    with pytest.raises(NotImplementedError) as ours:
        get_model(tcfg).decode_hidden(
            tp, torch.zeros((B, 1), dtype=torch.long), tcache,
            torch.zeros(B, dtype=torch.long), tcfg, ft=object())
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("scope", ["head", "all"])
def test_prepare_params_walks_whisper_subtrees_as_reference(scope):
    """``prepare_params`` walks the ``self``, ``cross`` and ``enc``
    subtrees: no int8 copy at scope head (the only scope the engine
    allows whisper), and at scope all the reference's packed copies and
    scales, bit for bit, at the same paths."""
    from repro.ft import prepare_params as jprepare_params
    from repro_torch.ft import prepare_params
    from repro_torch.tree import leaves_with_path

    jp, tp = _setup()[2:4]
    want = dict(leaves_with_path(jax.tree.map(
        np.asarray, jprepare_params(jp, scope=scope))))
    got = {k: v.numpy() for k, v in leaves_with_path(
        prepare_params(tp, scope=scope))}
    assert got.keys() == want.keys()
    q8 = [k for k in got if "q8" in k]
    assert bool(q8) == (scope == "all")
    assert {k.split("]")[1] for k in q8} == (
        {"['cross'", "['self'", "['mlp'", "['attn'"} if q8 else set())
    for k in q8:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("entry", ["prefill_chunk", "prefill_packed"])
def test_chunked_and_packed_prefill_raise_as_reference(entry):
    cfg, tcfg, jp, tp = _setup()[:4]
    kw = dict(pos0=0) if entry == "prefill_chunk" else dict(pos0=[0] * B)
    with pytest.raises(NotImplementedError) as theirs:
        getattr(JA.get_model(cfg), entry)(jp, jnp.zeros((B, 4), jnp.int32),
                                          cfg, None, **kw)
    with pytest.raises(NotImplementedError) as ours:
        getattr(get_model(tcfg), entry)(tp, torch.zeros((B, 4)), tcfg, None,
                                        **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("scope", ["qkv", "all"])
def test_engine_refuses_in_model_scopes_as_reference(scope):
    cfg, tcfg, jp, tp = _setup()[:4]
    kw = dict(max_batch=4, max_seq=MAX_SEQ, ft_mode="entangle", ft_M=4,
              ft_scope=scope)
    with pytest.raises(ValueError) as theirs:
        JServeEngine(cfg, JServeConfig(**kw), jp)
    with pytest.raises(ValueError) as ours:
        ServeEngine(tcfg, ServeConfig(**kw), tp, device="cpu")
    assert str(ours.value) == str(theirs.value)


def test_engine_head_scope_prefill_raises_as_reference():
    cfg, tcfg, jp, tp = _setup()[:4]
    kw = dict(max_batch=4, max_seq=MAX_SEQ, ft_mode="entangle", ft_M=4,
              ft_scope="head")
    prompt = np.arange(5, dtype=np.int32)
    jeng = JServeEngine(cfg, JServeConfig(**kw), jp)
    jeng.submit(JRequest(rid=0, prompt=prompt, max_new=2))
    with pytest.raises(NotImplementedError) as theirs:
        jeng.step()
    eng = ServeEngine(tcfg, ServeConfig(**kw), tp, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=2))
    with pytest.raises(NotImplementedError) as ours:
        eng.step()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", ["full", "causal"])
def test_attend_blocked_path_matches_reference(kind):
    """T = S = 1100 lies above the materialization limit (1100**2 >
    2048**2 / 4): both packages pad to 1536 and run the blocked forward;
    a T == 1 query and a small problem stay materialized and agree too."""
    rng = np.random.default_rng(4 if kind == "full" else 5)
    T = 1100
    q = rng.standard_normal((1, 2, 1, T, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, T, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, T, 16)).astype(np.float32)
    assert T * T > JC.FLASH_THRESHOLD ** 2 // 4
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    for sl in (slice(None), slice(0, 1), slice(0, 100)):
        want = JC.attend(j(q[:, :, :, sl]), j(k), j(v), kind=kind)
        got = TC.attend(t(q[:, :, :, sl]), t(k), t(v), kind=kind)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATTEND_TOL)
