"""The slice end to end: the port's ServeEngine (on the CPU, where the
entangled GEMM runs its plain version) against the reference's
ServeEngine on the same bridged llama3.2-1b smoke params and the same
8-request wave, plus the port's CLI.

Both engines record every head projection's logits (admission first, then
each decode step). The port is teacher-forced along the reference's
tokens, so the two run on the same prefixes for the whole wave and every
step of every request is compared: the port's own greedy token (the
argmax of its logits) must equal the reference's. The float path is not
bitwise across frameworks (see ``test_torch_model.py``), so where two
logits lie within a few bf16 ulps the two packages may rank them
differently; such a step is accepted only if it is a near-tie in BOTH
packages: each package's token is within ``NEAR_TIE`` of the top logit in
the other's logits. The logits themselves must agree within ``LOGIT_TOL``
of the largest |logit| at every step. Observed on this config: 0, 1 and 2
of the 48 request-steps reach a near-tie at scopes none, head and all, and
the logits agree within 1.03% of the largest |logit|.

Inside the port the paper's property is exact: every injected
``failed_group`` gives the healthy tokens bit for bit.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.kernels import entangled_matmul as emm
from repro_torch.serve import Request, ServeConfig, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPES = ("none", "head", "all")
MAX_NEW = 6
# relative gap to the top logit under which two tokens count as tied:
# hidden states agree within a few bf16 ulps (2**-8 relative each)
NEAR_TIE = 2.0 ** -6
# logits: bf16 activations (2**-8 relative per rounding) through the two
# smoke layers and the head, rounded in different orders by the two
# frameworks; observed at most 1.03% of the largest |logit|
LOGIT_TOL = 2.0 ** -5


def _scfg(scope):
    return dict(max_batch=8, max_seq=32, ft_M=4,
                ft_mode="none" if scope == "none" else "entangle",
                ft_scope="head" if scope == "none" else scope)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=8).astype(np.int32)
            for _ in range(8)]


class _JRecording(JServeEngine):
    """The reference engine, keeping every head projection's logits (the
    projection runs inside the jitted step, so a debug callback hands them
    to the host in program order)."""

    def _head_logits(self, params, h, mask, head, failed_group, ft_fn):
        logits = super()._head_logits(params, h, mask, head, failed_group,
                                      ft_fn)
        jax.debug.callback(lambda x: self.logits_log.append(np.asarray(x)),
                           logits, ordered=True)
        return logits


@pytest.fixture(scope="module")
def ref():
    cfg = get_smoke_config("llama3.2-1b")
    params = get_model(cfg).init(jax.random.PRNGKey(0), cfg, max_seq=32)
    out = {}
    for scope in SCOPES:
        eng = _JRecording(cfg, JServeConfig(**_scfg(scope)), params)
        eng.logits_log = []
        for r, p in enumerate(_prompts(cfg.vocab_size)):
            eng.submit(JRequest(rid=r, prompt=p, max_new=MAX_NEW))
        done = eng.run_to_completion()
        jax.effects_barrier()
        out[scope] = ({r.rid: np.asarray(r.out) for r in done},
                      set(eng.protected_census), eng.census,
                      np.stack(eng.logits_log))
    return dict(params=params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"),
                out=out)


class _Forced(ServeEngine):
    """Keeps every step's logits (admission first, then decode) and picks
    the token of ``force[row][step]`` instead of its own argmax."""

    def _head_logits(self, h, mask, failed_group, ft_fn):
        logits = super()._head_logits(h, mask, failed_group, ft_fn)
        t = len(self.logits_log)
        self.logits_log.append(logits.clone())
        forced = torch.full_like(logits, float("-inf"))
        for row, toks in self.force.items():
            forced[row, int(toks[t])] = 0.0
        return forced


def _port_wave(params, scope, failed_group=None, force=None):
    cfg = tget_smoke("llama3.2-1b")
    cls = ServeEngine if force is None else _Forced
    eng = cls(cfg, ServeConfig(**_scfg(scope)), params, device="cpu")
    eng.logits_log, eng.force = [], force
    for r, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=r, prompt=p, max_new=MAX_NEW))
    done = eng.run_to_completion(failed_group=failed_group)
    return {r.rid: np.asarray(r.out) for r in done}, eng


def _gap(row, tok):
    """How far ``tok``'s logit trails the row's top logit, relative."""
    top = float(row.max())
    return (top - float(row[tok])) / abs(top)


@pytest.mark.parametrize("scope", SCOPES)
def test_engine_matches_reference_tokens(ref, scope):
    want, census_keys, shape_census, jlogits = ref["out"][scope]
    # all 8 requests admit in one batch: request r sits in slot / row r,
    # and logits_log[t] holds step t's logits of every row
    assert sorted(want) == list(range(8))
    assert jlogits.shape[0] == MAX_NEW
    for rid in range(8):  # the recording is the reference's own choice
        np.testing.assert_array_equal(jlogits[:, rid].argmax(-1), want[rid])
    got, eng = _port_wave(ref["params"], scope, force=want)
    assert sorted(got) == list(range(8))
    assert len(eng.logits_log) == MAX_NEW
    plogits = torch.stack(eng.logits_log).numpy()
    np.testing.assert_allclose(plogits, jlogits, rtol=0,
                               atol=LOGIT_TOL * np.abs(jlogits).max())
    ties = []
    for rid in range(8):
        own = plogits[:, rid].argmax(-1)  # the port's own greedy tokens
        for t in np.nonzero(own != want[rid])[0]:
            gp = _gap(plogits[t, rid], int(want[rid][t]))
            gj = _gap(jlogits[t, rid], int(own[t]))
            assert gp <= NEAR_TIE and gj <= NEAR_TIE, (
                f"request {rid} step {t}: port picks {own[t]}, reference "
                f"{want[rid][t]}; the reference's token trails the port's "
                f"top logit by {gp:.4f} and the port's trails the "
                f"reference's by {gj:.4f} (near-tie {NEAR_TIE})")
            ties.append((rid, int(t)))
    assert len(ties) <= 2, ties
    assert eng.census == shape_census
    assert set(eng.protected_census) == census_keys
    if scope == "all":
        assert len(census_keys) == 7 * 4  # 7 sites x (decode + 3 buckets)
        assert eng.plans.misses == 0


@pytest.mark.parametrize("scope", ["head", "all"])
def test_failed_group_rolls_forward_exactly(ref, scope):
    healthy, _ = _port_wave(ref["params"], scope)
    for r in range(4):
        injected, eng = _port_wave(ref["params"], scope, failed_group=r)
        for rid in healthy:
            np.testing.assert_array_equal(injected[rid], healthy[rid])
        if eng.plans is not None:
            assert eng.plans.misses == 0
    # CPU tensors never reach a CUDA kernel
    assert emm.launches_s8 == emm.launches_cuda_core == 0


def test_engine_rejects_unported_options(ref):
    """Only autotuned blocks are still refused: chunked prefill, token
    packing, boundary admission and warm replicas are ported (their tests
    are in ``test_torch_serve_admission.py``)."""
    cfg = tget_smoke("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServeEngine(cfg, ServeConfig(blocks="auto"), ref["params"],
                    device="cpu")
    for kw in (dict(prefill_chunk=4), dict(prefill_chunk=4, token_budget=8),
               dict(refill=False)):
        ServeEngine(cfg, ServeConfig(max_seq=32, **kw), ref["params"],
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, ServeConfig(), ref["params"])


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_reports_exact_roll_forward():
    res = _cli("--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
               "--ft-mode", "entangle", "--ft-scope", "all",
               "--failed-group", "1", "--max-new", "4")
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if "recovery summary" in ln]
    assert len(lines) == 2
    assert "[scope=head]" in lines[0] and "[scope=all]" in lines[1]
    assert all("EXACT ROLL-FORWARD" in ln for ln in lines)


@pytest.mark.parametrize("flag", [
    ["--replicas", "2"], ["--kill-replica-at", "5"], ["--max-replicas", "2"],
    ["--blocks", "auto"], ["--kill-replica", "1"], ["--ckpt-dir", "x"]])
def test_cli_rejects_later_slices_at_parse_time(flag):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    *flag])
    assert e.value.code == 2


def test_admission_policy_queue_bound_deadlines_and_eos(ref):
    """max_queue rejects loudly, a queued request past its deadline is
    shed before any prefill, EOS ends a request, and a finished request's
    cache row is zeroed when its slot is freed."""
    from repro_torch.serve.scheduler import AdmissionRejected

    cfg = tget_smoke("llama3.2-1b")
    now = [0.0]
    eng = ServeEngine(cfg, ServeConfig(max_batch=4, max_seq=32, max_queue=2,
                                       clock=lambda: now[0]),
                      ref["params"], device="cpu")
    p = _prompts(cfg.vocab_size)
    late = eng.submit(Request(rid=0, prompt=p[0], max_new=3,
                              deadline_ms=5.0))
    eng.submit(Request(rid=1, prompt=p[1], max_new=3))
    with pytest.raises(AdmissionRejected):
        eng.submit(Request(rid=2, prompt=p[2], max_new=3))
    assert eng.metrics["rejected"] == 1
    now[0] = 1.0  # past rid 0's deadline
    eng.step()
    assert late.status == "shed" and eng.metrics["shed"] == 1
    eng.run_to_completion()
    free = eng.done[0]
    assert free.rid == 1 and len(free.out) == 3
    # rid 1 ran in slot 0 (the first free slot)
    assert all(float(t[:, 0].abs().sum()) == 0
               for unit in eng.cache for blk in unit for t in blk.values())
    first = int(free.out[0])
    eng.submit(Request(rid=3, prompt=p[1], max_new=5, eos_token=first))
    eng.run_to_completion()
    assert eng.done[-1].out.tolist() == [first]
