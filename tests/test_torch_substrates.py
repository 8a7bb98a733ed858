"""The single-process substrates of the port against the reference, each
on the same numpy inputs: the entangled token-shard store and its
prefetcher (``data/pipeline.py``, files interchangeable both ways), the
straggler deadline executor, the fixed-point bridge, SDC detection and
localization, the two library examples on the CPU, and ``launch.serve
--ckpt-dir`` on a checkpoint of the port's trainer.

Counterparts of tests/test_substrates.py::test_token_shard_store_single_
loss_recovery, test_prefetcher_order and test_deadline_executor_marks_
straggler, tests/test_system.py::test_fixed_point_roundtrip_error and
tests/test_ft_engine.py::test_sdc_detection_guaranteed and
test_sdc_localization_heuristic.

The module runs on one torch intra-op thread (its ops are small; under
several test workers more threads only contend), and the outputs it
compares against more than once — each package's shard-store files, the
entangled streams of the SDC tests — are built once per module.
"""
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfp
from repro.core import sdc as jsdc
from repro.core.entangle import entangle as jentangle
from repro.core.plan import make_plan as jmake_plan
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import TokenShardStore as JStore
from repro.train.straggler import DeadlineExecutor as JDeadlineExecutor
from repro_torch.core import entangle, fixed_point, make_plan, sdc
from repro_torch.data.pipeline import Prefetcher, TokenShardStore
from repro_torch.kernels import disentangle as kdis
from repro_torch.train.straggler import DeadlineExecutor
from repro_torch.tree import leaves

M = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(seed, n=96, lim=1000):
    rng = np.random.default_rng(seed)
    return rng.integers(-lim, lim, size=(M, n)).astype(np.int32)


@pytest.fixture(scope="module")
def entangled():
    """Per seed of :func:`_streams`: (plan, reference plan, the port's
    entangled streams, the reference's)."""
    plan, jplan = make_plan(M, 32), jmake_plan(M, 32)
    out = {}
    for seed in (0, 1):
        c = _streams(seed)
        out[seed] = (plan, jplan, entangle(torch.from_numpy(c), plan),
                     jentangle(jnp.asarray(c), jplan))
    return out


# ----------------------------------------------------------- shard store --

def test_token_shard_store_single_loss_recovery(tmp_path):
    store = TokenShardStore(str(tmp_path), M=4)
    toks = np.random.default_rng(0).integers(
        0, 65000, size=(5, 331)).astype(np.int32)
    paths = store.write_group("g", toks)
    for lost in range(4):
        backup = paths[lost].read_bytes()
        paths[lost].unlink()
        got = TokenShardStore(str(tmp_path), M=4).read_group("g")
        np.testing.assert_array_equal(got, toks)
        assert got.dtype == np.int32
        paths[lost].write_bytes(backup)
    paths[0].unlink()
    paths[1].unlink()
    with pytest.raises(IOError, match="single-failure"):
        store.read_group("g")


STORES = {"port": TokenShardStore, "reference": JStore}


@pytest.fixture(scope="module")
def shard_groups(tmp_path_factory):
    """One group written by each package: (tokens, {package: (directory,
    shard paths)})."""
    toks = np.random.default_rng(1).integers(
        0, 65000, size=(3, 7, 129)).astype(np.int32)
    groups = {}
    for name, cls in STORES.items():
        d = tmp_path_factory.mktemp(f"shards_{name}")
        groups[name] = (d, cls(str(d), M=4).write_group("c", toks))
    return toks, groups


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shard_store_files_interchangeable(tmp_path, writer, shard_groups):
    """A group written by one package reads back in the other, with every
    single shard lost in turn; the files and manifests are the same
    bytes."""
    toks, groups = shard_groups
    other = [k for k in STORES if k != writer][0]
    w_dir, r_dir = tmp_path / "w", groups[other][0]
    shutil.copytree(groups[writer][0], w_dir)
    paths = [w_dir / p.name for p in groups[writer][1]]
    for p in list(paths) + [w_dir / "c.json"]:
        assert p.read_bytes() == (r_dir / p.name).read_bytes(), p.name
    reader = STORES[other](str(w_dir), M=4)
    np.testing.assert_array_equal(reader.read_group("c"), toks)
    for lost in range(4):
        backup = paths[lost].read_bytes()
        paths[lost].unlink()
        np.testing.assert_array_equal(reader.read_group("c"), toks)
        paths[lost].write_bytes(backup)


def test_prefetcher_order():
    assert list(Prefetcher(iter(range(7)), depth=2)) == list(range(7))
    assert list(Prefetcher(iter(range(7)), depth=2)) == list(
        JPrefetcher(iter(range(7)), depth=2))


# ------------------------------------------------------------- straggler --

def test_deadline_executor_marks_straggler():
    def fast():
        return 1

    def slow():
        time.sleep(1.5)
        return 2

    for cls in (DeadlineExecutor, JDeadlineExecutor):
        res = cls(deadline_s=0.3).run([fast, slow, fast])
        assert cls.failed_index(res) == 1
        assert res[0].value == 1 and res[2].value == 1 and res[1].failed
        assert [r.index for r in res] == [0, 1, 2]


# ----------------------------------------------------------- fixed point --

@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 7), (2, 64), (3, 2),
                                        (12345, 33)])
def test_fixed_point_roundtrip_error(seed, depth):
    """The reference's assertions on the port's result, and q, scale and
    the round trip equal the reference's bit for bit."""
    x = np.random.default_rng(seed).normal(size=128).astype(np.float32)
    plan = make_plan(4, 32)
    q, scale = fixed_point.quantize(torch.from_numpy(x),
                                    plan.max_output_magnitude,
                                    reduction_depth=depth)
    back = fixed_point.dequantize(q, scale)
    assert float((back - torch.from_numpy(x)).abs().max()) \
        <= 1.0 / float(scale) + 1e-12
    assert int(q.abs().max()) * depth <= plan.max_output_magnitude
    jq, jscale = jfp.quantize(jnp.asarray(x), plan.max_output_magnitude,
                              reduction_depth=depth)
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jfp.dequantize(jq, jscale)))
    b16 = fixed_point.dequantize(q, scale, torch.bfloat16)
    assert b16.dtype == torch.bfloat16 and torch.equal(b16,
                                                       back.to(b16.dtype))


def test_fixed_point_stochastic_rounding_is_unbiased():
    """Stochastic rounding lands on the floor or the ceiling of the scaled
    value, and its mean error over many draws is near 0."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=4096).astype(np.float32))
    mm = make_plan(4, 32).max_output_magnitude
    q, scale = fixed_point.quantize(x, mm, reduction_depth=1 << 20,
                                    generator=torch.Generator().manual_seed(0))
    y = x * scale
    assert torch.all((q == torch.floor(y)) | (q == torch.ceil(y)))
    assert abs(float((q - y).mean())) < 0.02


# ------------------------------------------------------------------- sdc --

def test_sdc_detection_guaranteed(entangled):
    plan, jplan, delta, jdelta = entangled[0]
    assert not sdc.detect(delta, plan).any()
    for j in range(M):
        for mag in (1, 255, 1 << 15):
            bad = delta.clone()
            bad[j, 17] += mag
            got = sdc.detect(bad, plan)
            assert got[17] and int(got.sum()) == 1, (j, mag)
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(jsdc.detect(jdelta.at[j, 17].add(mag), jplan)))


def test_sdc_localization_heuristic(entangled):
    plan, jplan, delta, jdelta = entangled[1]
    hits = 0
    for j in range(M):
        bad = delta.clone()
        bad[j, 3] += 12345
        blame = sdc.localize(bad, plan)
        assert blame.dtype == torch.int32
        np.testing.assert_array_equal(
            blame.numpy(),
            np.asarray(jsdc.localize(jdelta.at[j, 3].add(12345), jplan)))
        hits += int(blame[3] == j)
    assert hits >= 3
    assert kdis.launches == 0  # CPU tensors take the plain version


# -------------------------------------------------------------- examples --

def test_failstop_demo_on_the_cpu(capsys):
    """The reference example's verdicts: every (op, family) recovered, the
    corruption found at position 100 and blamed on stream 2, the shard
    group surviving a lost file."""
    from repro_torch.examples import failstop_demo

    failstop_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines()
            if ln.split()[:1] in (["scale"], ["add"], ["conv"], ["dot"],
                                  ["permute"])]
    assert len(rows) == 15 and all(r[2] == "True" for r in rows)
    assert [int(r[3]) for r in rows[:3]] == [0, 1, 4]
    assert out.count("[overhead]") == 2
    assert ("[sdc] silent corruption detected at position [100], blamed "
            "stream 2 (truth: 2)") in out
    assert "[storage] token shard group survived a lost file" in out


def test_serve_lm_on_the_cpu(capsys):
    """The reference example's verdicts: per-slot and batched tokens
    bit-identical, the entangled head exact under a fail-stop of any group,
    the library projection exact, and group 2 rolled forward past its
    deadline."""
    from repro_torch.examples import serve_lm

    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "outputs bit-identical" in out
    assert ("tokens bit-identical under a fail-stop in any of the 4 request "
            "groups") in out
    assert "standalone ft_logits: exact under any single-group fail-stop" \
        in out
    assert "deadline drill: group 2 missed the deadline" in out


# ------------------------------------------------------------ --ckpt-dir --

def test_serve_ckpt_dir_restores_the_trainers_params(tmp_path, capsys):
    """``launch.serve --ckpt-dir`` on the checkpoint the port's trainer
    wrote: it reports the step and serves the tokens of those params
    served directly."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train.checkpoint import CheckpointManager

    train.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                "--steps", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                "--max-new", "4", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[launch.serve] restored params from step 2" in out
    first = out.split("first output: ")[1].splitlines()[0]
    cfg = get_smoke_config("llama3.2-1b")
    like = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                               max_seq=256, device="cpu")
    state, step = CheckpointManager(str(tmp_path)).restore({"params": like})
    assert step == 2
    # the trained params, not the random ones
    assert any(not torch.equal(a, b) for a, b in zip(
        leaves(state["params"]), leaves(like)))
    outs = serve._wave(ServeEngine(cfg, ServeConfig(max_batch=4,
                                                    max_seq=256),
                                   state["params"], device="cpu"),
                       8, cfg.vocab_size, 4, None)
    assert first == str(outs[0][:8].tolist())
