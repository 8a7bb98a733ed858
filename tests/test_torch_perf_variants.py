"""The reference's perf variants in the port, against the reference
(counterpart of tests/test_perf_variants.py).

  * ``norm_f32=False`` (float32 statistics, the bf16 elementwise apply):
    ``apply_norm`` within one bf16 ulp of the reference's output; the
    llama smoke ``forward_train`` with it within the reference test's
    bounds of the reference's own and of the port's float32 apply (max |Δ|
    < 0.25, argmax agreement > 0.95);
  * the absorbed MLA decode (``mla_absorb``) of deepseek-v2-lite-16b and
    deepseek-v3-671b at smoke size (``capacity_factor=1e9``, as in the
    reference test), 4 decode steps after a 16-token prefill: the port's
    absorbed logits within ABSORB_TOL of the reference's absorbed ones,
    and within the reference test's bounds of the port's naive decode on
    the same cache (max |Δ| < 0.5, cosine > 0.999);
  * AdamW with bf16 moments (``state_dtype='bfloat16'``): one update from
    the same params, gradients and moments gives the reference's ``m`` and
    ``v`` bit for bit and its params within PARAM_ULPS float32 ulps;
  * the bf16 moments' checkpoint: a checkpoint the reference writes after
    one bf16-moment train step restores in the port bit for bit, and the
    port's own files for that state have the reference's bytes (equal
    manifests, SHA-256 included).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import TrainConfig, init_state
from repro_torch.tree import leaves, leaves_with_path, tree_map

KEY = jax.random.PRNGKey(0)
# the reference test's bounds (tests/test_perf_variants.py)
NORM_MAX_DIFF = 0.25
NORM_AGREE = 0.95
NAIVE_MAX_DIFF = 0.5
NAIVE_COS = 0.999
# port absorbed vs reference absorbed logits, as a fraction of the
# largest logit: bf16 activations of the two frameworks an ulp apart here
# and there (measured up to 1.5%, the naive decode's own port-vs-reference
# gap)
ABSORB_TOL = 2.0 ** -5
# AdamW params: the two frameworks' float32 sqrt / division / pow may
# round an ulp apart
PARAM_ULPS = 4
MLA_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 ulp at each value of ``x`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------- norms ----

def test_norm_bf16_apply_within_one_ulp_of_reference():
    cfg = dataclasses.replace(jsmoke("llama3.2-1b"), norm_f32=False)
    tcfg = dataclasses.replace(tsmoke("llama3.2-1b"), norm_f32=False)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, cfg.d_model)) * 3).astype(np.float32)
    scale = (1 + 0.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    for dtype in (jnp.bfloat16, jnp.float32):
        jx = jnp.asarray(x).astype(dtype)
        want = _np(jax.jit(functools.partial(JL.apply_norm, cfg=cfg))(
            {"scale": jnp.asarray(scale)}, jx))
        tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                    else torch.float32)
        got = TL.apply_norm({"scale": torch.from_numpy(scale)}, tx, tcfg)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want)
        assert (err <= _bf16_ulp(want)).all(), float(err.max())


@pytest.fixture(scope="module")
def llama():
    cfg = jsmoke("llama3.2-1b")
    params = jax.jit(lambda k: jget_model(cfg).init(k, cfg, 64))(KEY)
    tokens = np.asarray(jax.random.randint(KEY, (2, 32), 0, cfg.vocab_size))
    return cfg, params, tokens


def _agree(a, b) -> float:
    return float(np.mean(a.argmax(-1) == b.argmax(-1)))


def test_forward_with_bf16_norm_apply_vs_reference(llama):
    cfg, params, tokens = llama
    cfg_b = dataclasses.replace(cfg, norm_f32=False)
    want = _np(jax.jit(lambda p, b: jget_model(cfg_b).forward_train(
        p, b, cfg_b))(params, {"tokens": jnp.asarray(tokens)}))
    tcfg = tsmoke("llama3.2-1b")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    batch = {"tokens": torch.from_numpy(tokens).long()}
    model = get_model(tcfg)
    with torch.no_grad():
        got = model.forward_train(
            tp, batch, dataclasses.replace(tcfg, norm_f32=False)).float()
        f32 = model.forward_train(tp, batch, tcfg).float()
    for a, b, what in ((got.numpy(), want, "port vs reference"),
                       (got.numpy(), f32.numpy(), "bf16 vs f32 apply")):
        assert float(np.abs(a - b).max()) < NORM_MAX_DIFF, what
        assert _agree(a, b) > NORM_AGREE, what


# ------------------------------------------------------- absorbed MLA ----

def _moe_cfg(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1e9))


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_absorbed_decode_vs_reference_and_naive(arch):
    cfg = _moe_cfg(jsmoke(arch))
    cfg_a = dataclasses.replace(cfg, mla_absorb=True)
    jm = jget_model(cfg)
    params = jax.jit(lambda k: jm.init(k, cfg, 64))(KEY)
    toks = np.asarray(jax.random.randint(KEY, (2, 20), 0, cfg.vocab_size))
    _, jcache = jax.jit(lambda p, b, c: jm.prefill(p, b, cfg, c))(
        params, {"tokens": jnp.asarray(toks[:, :16])}, jm.init_cache(
            cfg, 2, 64))
    jdec = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos, cfg_a))

    tcfg = _moe_cfg(tsmoke(arch))
    tcfg_a = dataclasses.replace(tcfg, mla_absorb=True)
    tm = get_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    with torch.no_grad():
        _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :16]).long()}, tcfg, tm.init_cache(tcfg, 2, 64,
                                                       device="cpu"))
    cache_a = tree_map(lambda t: t.clone(), cache)
    for t in range(16, 20):
        want, jcache = jdec(params, jnp.asarray(toks[:, t:t + 1]), jcache, t)
        want = _np(want)
        tok = torch.from_numpy(toks[:, t:t + 1]).long()
        with torch.no_grad():
            naive, cache = tm.decode_step(tp, tok, cache, t, tcfg)
            got, cache_a = tm.decode_step(tp, tok, cache_a, t, tcfg_a)
        got, naive = got.float().numpy(), naive.float().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ABSORB_TOL * np.abs(want).max(),
                                   err_msg=f"step {t}")
        assert float(np.abs(got - naive).max()) < NAIVE_MAX_DIFF
        cos = float(np.sum(got * naive) / np.sqrt(
            np.sum(got ** 2) * np.sum(naive ** 2)))
        assert cos > NAIVE_COS, (t, cos)


def test_mla_absorbed_is_decode_only():
    """Prefill with ``mla_absorb`` is the naive prefill, bit for bit."""
    arch = "deepseek-v2-lite-16b"
    tcfg = tsmoke(arch)
    tm = get_model(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0), tcfg, 32, device="cpu")
    tok = torch.randint(0, tcfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    outs = []
    with torch.no_grad():
        for c in (tcfg, dataclasses.replace(tcfg, mla_absorb=True)):
            logits, cache = tm.prefill(tp, {"tokens": tok}, c,
                                       tm.init_cache(c, 2, 32, device="cpu"))
            outs.append([logits] + leaves(cache))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_mla_absorbed_slabs_keep_a_slots_bits():
    """The absorbed decode runs in slabs of ``ABSORB_ROWS`` rows, the last
    one padded (at batch 1 and 11, which pads to 16): a slot gets the same
    bits at batch 1 as among 8 and 11 (deepseek-v3-671b's smoke MLA, a
    64-position latent cache), and the slabs equal one unslabbed call
    within ABSORB_TOL of its largest value."""
    cfg = dataclasses.replace(tsmoke("deepseek-v3-671b"), mla_absorb=True)
    gen = torch.Generator().manual_seed(0)
    p = tree_map(lambda t: t[0], TL.init_mla(gen, cfg, 1))
    S, B = 64, 11
    cache = {k: torch.randn(v.shape[1:], generator=gen).to(v.dtype)
             for k, v in TL.init_mla_cache(cfg, 1, B, S, "cpu").items()}
    x = torch.randn(B, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    pos = torch.randint(0, S, (B,), generator=gen)

    def run(rows):
        cc = {k: v[rows].clone() for k, v in cache.items()}
        with torch.no_grad():
            return TL.apply_mla(p, x[rows], cfg=cfg, cache=cc,
                                pos=pos[rows], mode="decode")[0]

    for n in (8, 11):
        whole = run(slice(0, n))
        for b in (0, 5, n - 1):
            assert torch.equal(run(slice(b, b + 1)), whole[b:b + 1]), (n, b)
    calls = []
    real = TL._mla_absorbed_rows

    def spy(*a):
        calls.append(a[1].shape[0])
        return real(*a)

    m = cfg.mla
    q = torch.randn(B, 1, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
                    generator=gen)
    args = (p["wkv_b"]["w"], q[..., :m.qk_nope_head_dim],
            q[..., m.qk_nope_head_dim:], cache["ckv"], cache["krope"], pos,
            cfg)
    TL._mla_absorbed_rows = spy
    try:
        slabs = TL._mla_absorbed(*args)
    finally:
        TL._mla_absorbed_rows = real
    assert calls == [TL.ABSORB_ROWS, TL.ABSORB_ROWS]
    one = real(*args)
    np.testing.assert_allclose(slabs.numpy(), one.numpy(), rtol=0,
                               atol=ABSORB_TOL * float(one.abs().max()))


# ------------------------------------------------------------- AdamW ----

def test_adamw_bf16_moments_vs_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 48), "b": (48,), "n": {"s": (7, 5)}}
    p = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                     shapes, is_leaf=lambda s: isinstance(s, tuple))
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 0.1, p)
    m = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.05).astype(
        np.float32), p)
    v = jax.tree.map(lambda x: (rng.random(x.shape) * 0.01).astype(
        np.float32), p)
    cfg = jadamw.AdamWConfig(state_dtype="bfloat16", warmup_steps=3,
                             total_steps=20)
    tcfg = adamw.AdamWConfig(state_dtype="bfloat16", warmup_steps=3,
                             total_steps=20)
    jbf = lambda t: jax.tree.map(lambda x: jnp.asarray(x).astype(  # noqa
        jnp.bfloat16), t)
    tbf = lambda t: tree_map(lambda x: torch.from_numpy(x).to(  # noqa
        torch.bfloat16), t)
    for step in (0, 5):
        wp, wst = jax.jit(functools.partial(jadamw.update, cfg=cfg))(
            jax.tree.map(jnp.asarray, g), {"m": jbf(m), "v": jbf(v)},
            jax.tree.map(jnp.asarray, p), jnp.int32(step))
        gp, gst = adamw.update(tree_map(torch.from_numpy, g),
                               {"m": tbf(m), "v": tbf(v)},
                               tree_map(torch.from_numpy, p),
                               torch.tensor(step, dtype=torch.int32), tcfg)
        for k in ("m", "v"):
            for a, b in zip(leaves(gst[k]), jax.tree.leaves(wst[k])):
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    a.view(torch.int16).numpy(),
                    np.asarray(b).view(np.int16), err_msg=f"{k} step {step}")
        for a, b in zip(leaves(gp), jax.tree.leaves(wp)):
            b = np.asarray(b)
            np.testing.assert_allclose(
                a.numpy(), b, rtol=0,
                atol=PARAM_ULPS * float(np.spacing(np.abs(b).max())))
    z = adamw.init(tree_map(torch.from_numpy, p), tcfg)
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in leaves(z["m"]) + leaves(z["v"]))
    assert all(t.dtype == torch.float32
               for t in leaves(adamw.init(tree_map(torch.from_numpy, p))["m"]))


# -------------------------------------------------------- checkpoints ----

@pytest.fixture(scope="module")
def bf16_ckpt(tmp_path_factory, llama):
    """The reference's state after one bf16-moment train step, and the
    directory its CheckpointManager wrote it to."""
    cfg, params, tokens = llama
    tc = jts.TrainConfig(adamw=jadamw.AdamWConfig(state_dtype="bfloat16"),
                         max_seq=64, grad_sync="entangle")
    state = jts.init_state(KEY, cfg, tc)
    state, _ = jax.jit(jts.make_train_step(cfg, tc))(
        state, {"tokens": jnp.asarray(tokens)})
    d = tmp_path_factory.mktemp("ref_ckpt")
    JCheckpointManager(str(d)).save(state, 1, blocking=True)
    return state, d


def _manifest(d, step=1):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def test_bf16_moment_checkpoint_interchanges_with_reference(bf16_ckpt,
                                                            tmp_path):
    jstate, d = bf16_ckpt
    assert any(e["dtype"] == "bfloat16" for e in _manifest(d)["leaves"])
    tcfg = TrainConfig(adamw=adamw.AdamWConfig(state_dtype="bfloat16"),
                       max_seq=64)
    like = init_state(torch.Generator().manual_seed(1),
                      tsmoke("llama3.2-1b"), tcfg, device="cpu")
    restored, step = CheckpointManager(str(d)).restore(like)
    assert step == 1
    want = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    want = {jax.tree_util.keystr(k): v for k, v in want.items()}
    n_bf16 = 0
    for path, got in leaves_with_path(restored):
        w = np.asarray(want[path])
        if got.dtype == torch.bfloat16:
            n_bf16 += 1
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=path)
    assert n_bf16 == 2 * len(leaves(restored["params"]))
    CheckpointManager(str(tmp_path)).save(restored, 1, blocking=True)
    assert _manifest(tmp_path) == _manifest(d)
