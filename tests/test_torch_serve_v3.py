"""deepseek-v3-671b served by the port's ServeEngine against the
reference's, at scopes moe (the expert GEMMs on the grouped kernel) and
all (also the low-rank-Q MLA's qkv.q_a / qkv.kv / qkv.q / out.o, the
router and the dense and shared MLPs), on the smoke config's params
bridged over; on the CPU the port's entangled GEMMs run their plain
versions and the reference's its ``reference`` kernel backend (the jnp
oracles of its Pallas kernels), its ``prepare_params`` jitted whole.

The port is teacher-forced along the reference's tokens, as in
test_torch_serve_moe.py, and along the reference's router choices (its
expert ids recorded per MoE layer and engine step, the admission step's
prefill included; tests/_train_oracle.py), with its own gate
probabilities at them: a near-tied router (gate probabilities within
``ROUTER_TIE`` at the top-k boundary) would otherwise change a prompt
token's cached latents and every later step of that request. So every
request's logits are held to ``LOGIT_TOL`` at every step, and its greedy
token to the reference's but at a greedy near-tie; the port's own route
choice is held to the reference's but at a router near-tie.

Inside the port the paper's property is exact: ``failed_group=1`` gives
the healthy tokens bit for bit at both scopes, on the port's own routes.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import _train_oracle as oracle
from repro import configs as jconfigs
from repro.ft import plans as jplans
from repro.kernels import ops as jops
from repro.serve import engine as jengine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from test_torch_serve_moe import (LOGIT_TOL, NEAR_TIE, ROUTER_TIE, _Forced,
                                  _gap, _JRecording)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.serve import Request, ServeConfig, ServeEngine

ARCH = "deepseek-v3-671b"
SCOPES = ("moe", "all")
MAX_NEW = 6
N_REQ = 8
MAX_SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scfg(scope):
    return dict(max_batch=8, max_seq=MAX_SEQ, ft_M=4, ft_mode="entangle",
                ft_scope=scope)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=8).astype(np.int32)
            for _ in range(N_REQ)]


def _jengine_wave(cfg, params, scope):
    """The reference engine's wave: tokens, protected and shape census,
    every step's logits, and its router's expert ids per call."""
    eng = _JRecording(cfg, JServeConfig(**_scfg(scope)), params)
    eng.logits_log = []
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(JRequest(rid=r, prompt=p, max_new=MAX_NEW))
    with oracle.recording_routes() as routes:
        done = eng.run_to_completion()
    return dict(tokens={r.rid: np.asarray(r.out) for r in done},
                census_keys=set(eng.protected_census), census=eng.census,
                logits=np.stack(eng.logits_log), routes=routes)


def _jit_prepare(params, *, scope, packed=True):
    """The reference's ``prepare_params`` as one jitted program: the same
    leaves bit for bit as its eager calls (one compile instead of one per
    leaf shape)."""
    return jax.jit(functools.partial(jplans.prepare_params, scope=scope,
                                     packed=packed))(params)


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke params, bridged over, and its engine's wave
    at each scope on them."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = oracle.init_params(jcfg, max_seq=MAX_SEQ)
    saved = jengine.prepare_params
    jops.set_default_backend("reference")
    jengine.prepare_params = _jit_prepare
    try:
        serve = {s: _jengine_wave(jcfg, params, s) for s in SCOPES}
    finally:
        jengine.prepare_params = saved
        jops.set_default_backend(None)
    return dict(params=params_from_numpy(params, device="cpu"), serve=serve)


def _port_wave(params, scope, failed_group=None, force=None):
    cfg = get_smoke_config(ARCH)
    cls = ServeEngine if force is None else _Forced
    eng = cls(cfg, ServeConfig(**_scfg(scope)), params, device="cpu")
    eng.logits_log, eng.force = [], force
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW))
    done = eng.run_to_completion(failed_group=failed_group)
    return {r.rid: np.asarray(r.out) for r in done}, eng


@pytest.mark.parametrize("scope", SCOPES)
def test_v3_engine_matches_reference_tokens(ref, scope):
    """Along the reference's tokens and routes: every request's logits
    within LOGIT_TOL at every step, greedy tokens equal but at a greedy
    near-tie, the port's own route choice the reference's but at a router
    near-tie; the same shape census and protected census, in which scope
    all sees the low-rank Q's sites."""
    want = ref["serve"][scope]
    jlogits = want["logits"]
    assert jlogits.shape[:2] == (MAX_NEW, N_REQ)
    cfg = get_smoke_config(ARCH)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert len(want["routes"]) == MAX_NEW * n_moe
    with oracle.force_routes(want["routes"]) as own:
        got, eng = _port_wave(ref["params"], scope, force=want["tokens"])
    assert sorted(got) == list(range(N_REQ))
    assert len(own) == len(want["routes"])
    for call, ((ids, gap), jids) in enumerate(zip(own, want["routes"])):
        moved = (np.sort(ids.numpy(), -1) != np.sort(jids, -1)).any(-1)
        assert (gap.numpy()[moved] <= ROUTER_TIE).all(), (
            call, np.nonzero(moved)[0], gap.numpy()[moved])
    plogits = torch.stack(eng.logits_log).numpy()
    err = np.abs(plogits - jlogits).max(-1)
    assert (err <= LOGIT_TOL * np.abs(jlogits).max()).all(), (
        np.argwhere(err > LOGIT_TOL * np.abs(jlogits).max()), err)
    for rid in range(N_REQ):
        own_tok = plogits[:, rid].argmax(-1)
        for t in np.nonzero(own_tok != want["tokens"][rid])[0]:
            gp = _gap(plogits[t, rid], int(want["tokens"][rid][t]))
            gj = _gap(jlogits[t, rid], int(own_tok[t]))
            assert gp <= NEAR_TIE and gj <= NEAR_TIE, (
                f"request {rid} step {t}: port picks {own_tok[t]}, "
                f"reference {want['tokens'][rid][t]}; gaps {gp:.4f} / "
                f"{gj:.4f}")
    census_keys = want["census_keys"]
    assert eng.census == want["census"]
    assert set(eng.protected_census) == census_keys
    sites = {site for site, _ in census_keys}
    grouped = {k for k in census_keys if len(k[1]) == 5}
    assert {s for s, _ in grouped} == {"moe.gate", "moe.up", "moe.down"}
    assert all(shape[1] == cfg.moe.n_experts for _, shape in grouped)
    if scope == "all":
        assert {"qkv.q_a", "qkv.kv", "qkv.q", "out.o", "mlp.router",
                "mlp.gate", "mlp.up", "mlp.down"} <= sites
    else:
        assert sites == {"moe.gate", "moe.up", "moe.down"}
    assert eng.plans.misses == 0


@pytest.mark.parametrize("scope", SCOPES)
def test_v3_failed_group_rolls_forward_exactly(ref, scope):
    healthy, _ = _port_wave(ref["params"], scope)
    injected, eng = _port_wave(ref["params"], scope, failed_group=1)
    for rid in healthy:
        np.testing.assert_array_equal(injected[rid], healthy[rid],
                                      err_msg=f"{scope} rid={rid}")
    assert eng.plans.misses == 0
