"""The other dense decoders of the port, qwen2-7b (qkv bias), minitron-8b
(ungated MLP, relu2) and granite-20b (MQA, ungated MLP, gelu), at their
smoke configs, against the reference.

Per arch: the configs equal the reference's; the port's ServeEngine, on
the reference's params bridged over, gives the JAX engine's logits on the
same 8-request wave at scopes none and all, under the rule of
``test_torch_serve.py`` (teacher-forced along the reference's tokens,
logits within ``LOGIT_TOL`` of the largest |logit|, a differing greedy
token only at a near-tie in both packages); qwen2's biases are set to
random values first, so that the bias add is compared, not a zero. The
activations equal ``jax.nn``'s bit for bit on the same bfloat16 inputs,
the biased projection equals the reference's ``dense``, ``prepare_params``
leaves the biases in float, and a fail-stopped group rolls forward
exactly at scope all. The JAX engine runs are built once per arch and
shared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.ft.plans import prepare_params
from repro_torch.models import layers as TL
from repro_torch.serve import Request, ServeConfig, ServeEngine

ARCHS = ("qwen2-7b", "minitron-8b", "granite-20b")
SCOPES = ("none", "all")
MAX_NEW = 6
NEAR_TIE = 2.0 ** -6  # as in test_torch_serve.py
LOGIT_TOL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scfg(scope):
    return dict(max_batch=8, max_seq=32, ft_M=4,
                ft_mode="none" if scope == "none" else "entangle",
                ft_scope="head" if scope == "none" else scope)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=8).astype(np.int32)
            for _ in range(8)]


def _with_random_biases(params):
    """The reference's params with every bias leaf ``b`` drawn at random
    (the reference initializes them to zeros)."""
    rng = np.random.default_rng(5)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                        if k == "b" else walk(v)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


class _JRecording(JServeEngine):
    """The reference engine, keeping every head projection's logits."""

    def _head_logits(self, params, h, mask, head, failed_group, ft_fn):
        logits = super()._head_logits(params, h, mask, head, failed_group,
                                      ft_fn)
        jax.debug.callback(lambda x: self.logits_log.append(np.asarray(x)),
                           logits, ordered=True)
        return logits


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    arch = request.param
    cfg = jget_smoke(arch)
    jparams = get_model_params(cfg)
    out = {}
    for scope in SCOPES:
        eng = _JRecording(cfg, JServeConfig(**_scfg(scope)), jparams)
        eng.logits_log = []
        for r, p in enumerate(_prompts(cfg.vocab_size)):
            eng.submit(JRequest(rid=r, prompt=p, max_new=MAX_NEW))
        done = eng.run_to_completion()
        jax.effects_barrier()
        out[scope] = ({r.rid: np.asarray(r.out) for r in done},
                      set(eng.protected_census), np.stack(eng.logits_log))
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(arch=arch, jparams=jparams, np_params=np_params,
                params=params_from_numpy(np_params, device="cpu"), out=out)


def get_model_params(cfg):
    params = jget_model(cfg).init(jax.random.PRNGKey(0), cfg, max_seq=32)
    if cfg.qkv_bias:
        params = jax.tree.map(jnp.asarray, _with_random_biases(
            jax.tree.map(np.asarray, params)))
    return params


class _Forced(ServeEngine):
    """Keeps every step's logits and picks ``force[row][step]``."""

    def _head_logits(self, h, mask, failed_group, ft_fn):
        logits = super()._head_logits(h, mask, failed_group, ft_fn)
        t = len(self.logits_log)
        self.logits_log.append(logits.clone())
        forced = torch.full_like(logits, float("-inf"))
        for row, toks in self.force.items():
            forced[row, int(toks[t])] = 0.0
        return forced


def _port_wave(ref, scope, failed_group=None, force=None):
    cfg = get_smoke_config(ref["arch"])
    cls = ServeEngine if force is None else _Forced
    eng = cls(cfg, ServeConfig(**_scfg(scope)), ref["params"], device="cpu")
    eng.logits_log, eng.force = [], force
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW))
    done = eng.run_to_completion(failed_group=failed_group)
    return {r.rid: np.asarray(r.out) for r in done}, eng


def _gap(row, tok):
    top = float(row.max())
    return (top - float(row[tok])) / abs(top)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for t, j in ((get_config(arch), jget_config(arch)),
                 (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert list(t.layer_pattern()) == list(j.layer_pattern())


@pytest.mark.parametrize("scope", SCOPES)
def test_engine_matches_reference_logits(ref, scope):
    want, census_keys, jlogits = ref["out"][scope]
    assert sorted(want) == list(range(8)) and jlogits.shape[0] == MAX_NEW
    for rid in range(8):  # the recording is the reference's own choice
        np.testing.assert_array_equal(jlogits[:, rid].argmax(-1), want[rid])
    got, eng = _port_wave(ref, scope, force=want)
    assert sorted(got) == list(range(8))
    plogits = torch.stack(eng.logits_log).numpy()
    np.testing.assert_allclose(plogits, jlogits, rtol=0,
                               atol=LOGIT_TOL * np.abs(jlogits).max())
    ties = []
    for rid in range(8):
        own = plogits[:, rid].argmax(-1)
        for t in np.nonzero(own != want[rid])[0]:
            gp = _gap(plogits[t, rid], int(want[rid][t]))
            gj = _gap(jlogits[t, rid], int(own[t]))
            assert gp <= NEAR_TIE and gj <= NEAR_TIE, (
                f"request {rid} step {t}: port {own[t]}, reference "
                f"{want[rid][t]}; gaps {gp:.4f} / {gj:.4f}")
            ties.append((rid, int(t)))
    assert len(ties) <= 2, ties
    assert set(eng.protected_census) == census_keys
    if scope == "all":
        assert eng.plans.misses == 0


def test_failed_group_rolls_forward_exactly(ref):
    healthy, _ = _port_wave(ref, "all")
    for r in (0, 1, 3):
        injected, eng = _port_wave(ref, "all", failed_group=r)
        for rid in healthy:
            np.testing.assert_array_equal(injected[rid], healthy[rid])
        assert eng.plans.misses == 0


def test_prepare_params_leaves_biases_float(ref):
    """Every protected site gets its int8 copy; a bias leaf ``b`` is
    carried over as it is (float, the same tensor), never quantized."""
    prepped = prepare_params(ref["params"], scope="all")
    blk, pblk = ref["params"]["stack"][0][0], prepped["stack"][0][0]
    cfg = get_smoke_config(ref["arch"])
    for k in ("wq", "wk", "wv", "wo"):
        assert "q8" in pblk["attn"][k]
        assert ("b" in pblk["attn"][k]) == (cfg.qkv_bias and k != "wo")
        if "b" in blk["attn"][k]:
            assert pblk["attn"][k]["b"] is blk["attn"][k]["b"]
            assert pblk["attn"][k]["b"].dtype == torch.float32
    mlp_keys = ("up", "down") if cfg.mlp_gated is False else (
        "gate", "up", "down")
    assert sorted(k for k in pblk["mlp"] if k != "norm") == sorted(mlp_keys)
    assert all("q8" in pblk["mlp"][k] for k in mlp_keys)


def test_biased_projection_equals_reference(ref):
    """The bias add after the bf16 projection equals the reference's
    ``dense`` bit for bit (qwen2's q/k/v; the other archs have no bias)."""
    cfg = get_smoke_config(ref["arch"])
    if not cfg.qkv_bias:
        assert "b" not in ref["params"]["stack"][0][0]["attn"]["wq"]
        return
    x = np.random.default_rng(2).standard_normal((3, 5, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    for k in ("wq", "wk", "wv"):
        jp = jax.tree.map(lambda t: t[0],
                          ref["jparams"]["stack"][0][0]["attn"][k])
        tp = {n: t[0] for n, t in ref["params"]["stack"][0][0]["attn"][
            k].items()}
        assert float(np.abs(np.asarray(jp["b"])).max()) > 0
        want = np.asarray(JL.dense(jp, jx).astype(jnp.float32))
        np.testing.assert_array_equal(TL.dense(tp, tx).float().numpy(), want)


def test_mlp_block_equals_reference(ref):
    """The MLP block (norm, projections, activation; ungated for minitron
    and granite) against the reference's on identical inputs: equal bit
    for bit but where a float32 GEMM sum cancels to a value far below its
    terms, whose rounding then follows the summation order (one of granite
    smoke's 896 outputs here, an ulp of a value near 7e-6); every output
    within a bf16 ulp of the largest."""
    cfg, jcfg = get_smoke_config(ref["arch"]), jget_smoke(ref["arch"])
    x = np.random.default_rng(3).standard_normal((2, 7, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jp = jax.tree.map(lambda t: t[0], ref["jparams"]["stack"][0][0]["mlp"])
    tp = jax.tree.map(lambda t: t[0], ref["params"]["stack"][0][0]["mlp"])
    want = np.asarray(JL.apply_mlp(jp, jx, cfg=jcfg).astype(jnp.float32))
    got = TL.apply_mlp(tp, tx, cfg=cfg).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())
    assert (got != want).mean() <= 0.01


@pytest.mark.parametrize("name", ["gelu", "relu2"])
def test_activations_bit_identical_to_jax(name):
    """``jax.nn.gelu`` (tanh form) and ``square(relu)`` on bfloat16, over
    a spread of magnitudes and the signed zeros and limits around them."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal(1 << 15) * 4,
                        np.linspace(-12, 12, 4097),
                        [0.0, -0.0, 1e-30, -1e-30, 60.0, -60.0]])
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    if name == "gelu":
        want = jax.nn.gelu(jx)
    else:
        want = jnp.square(jax.nn.relu(jx))
    got = getattr(TL, name)(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))
