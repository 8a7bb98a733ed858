"""Serving across ranks on the CPU: the engine's ``serve_mesh`` path, the
MoE dispatch groups and the serve launcher under ``torchrun``.

One module fixture starts every subprocess at once: a spawn of 2 gloo
ranks and one of 4 (tests/_serve_mesh_worker.py), the one-process oracles
(the one-rank engine, and one process of the 2-rank layout under a
stand-in mesh ``{"data": 2}``; the 4-shard one runs here meanwhile), the
reference's MoE block under meshes of 2 and 4 CPU devices (a subprocess
with ``--xla_force_host_platform_device_count``, as in
tests/test_pipeline_elastic.py) and the launcher under ``torchrun``. Each
rank serves every wave through one engine whose 8 slots split across the
ranks (4 a rank; 2 a rank under 4 ranks, fewer than M = 4, so the head
pads each rank's rows).

  * llama3.2-1b's smoke config, 2 and 4 ranks: the tokens and head logits
    equal the one-rank engine's bit for bit in every admission mode
    (whole bucket, chunked, boundary, packed), at scopes head and all,
    with ``failed_group`` None and 1, and the injected waves give the
    healthy wave's tokens (EXACT ROLL-FORWARD on every rank);
  * deepseek-v2-lite's smoke config at a capacity factor of 0.5, where
    capacity drops assignments in every mode (the logits differ from the
    dropless wave's): the ranks give the tokens and logits of one process
    with G = n dispatch groups in every mode at scope all, and at scope
    moe; dropless (capacity factor 1e3, as
    tests/test_torch_serve_admission.py does), the one-rank engine's;
    ``dispatch="global_sort"`` across 2 ranks, one process's single group;
  * on every rank, after every step, the engine's host state (slots,
    positions, queue, in-flight batches, metrics, census, counters, clock
    stamps) is the same, and the same as the one-process engine's of the
    same layout, on the same clock; each rank holds its own slots; under
    2 ranks its protected-shape census is that of an engine of B/2 slots;
    no plan misses;
  * a batch that does not divide by 4 (6 slots at M = 3; a packed program
    of 2 rows) runs whole on every rank, with the same tokens;
  * admission batches of ``prefill_batch`` rows across 2 ranks: 2 rows
    split (one a rank, in a slot of its own block), 3 rows run whole on
    every rank (and so does a packed program feeding them): in the whole
    bucket, chunked and packed modes at scope all, healthy and with
    failed group 1, the one-rank engine's tokens and logits and the
    2-shard process's host state, bit for bit;
  * ``apply_moe`` under a stand-in mesh of G = 2 and 4 ``data`` shards
    against the reference's under a mesh of that many CPU devices, with
    drops and with a bucket ``valid`` mask, within tests/test_torch_moe.py's
    tolerance;
  * ``python -m repro_torch.launch.serve`` under ``torchrun
    --nproc-per-node 2 ... --device cpu``: EXACT ROLL-FORWARD for both
    scopes, printed once, and the one-process launcher's first output.
"""
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _serve_mesh_worker as W
from repro_torch.configs import get_smoke_config
from repro_torch.dist.sharding import StandInMesh, axis_rules
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as TL

REPO = pathlib.Path(__file__).resolve().parents[1]
LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v2-lite-16b"
LENGTHS = [5, 6, 12, 3, 4, 6, 9, 2, 7, 15, 1, 8]
MAX_NEW = [1, 2, 3, 2, 1, 2, 4, 3, 2, 5, 1, 2]
MODES = {"whole": {}, "chunked": dict(prefill_chunk=8),
         "boundary": dict(prefill_chunk=8, refill=False),
         "packed": dict(prefill_chunk=8, token_budget=16)}
DROPS, DROPLESS = dict(capacity_factor=0.5), dict(capacity_factor=1e3)
# tests/test_torch_moe.py's bound: bf16 through one layer, summed in
# another order by each framework
LAYER_TOL = 2.0 ** -6


def _case(arch, mode, scope, fg=None, moe=None, max_batch=8, M=4, **kw):
    scfg = dict(max_batch=max_batch, max_seq=48, prefill_buckets=[8, 16],
                ft_mode="entangle", ft_M=M, ft_scope=scope,
                **{**MODES[mode], **kw})
    return dict(arch=arch, scfg=scfg, moe=moe, lengths=LENGTHS,
                max_new=MAX_NEW, failed_group=fg)


def _fg(fg) -> str:
    return "none" if fg is None else str(fg)


DENSE = {f"llama-{m}-{s}-{_fg(fg)}": _case(LLAMA, m, s, fg)
         for m in MODES for s in ("head", "all") for fg in (None, 1)}


def _moe(mode, scope, fg, moe):
    """A deepseek wave; its packed program has 8 rows of 8 (4 rows a
    group), so that its capacity of 8 per expert drops assignments too."""
    kw = dict(token_budget=64) if mode == "packed" else {}
    return _case(DEEPSEEK, mode, scope, fg, moe, **kw)


# MoE waves held to one process of G = 2 groups (stand-in mesh)
GROUPED = {f"moe-{m}-all-{_fg(fg)}": _moe(m, "all", fg, DROPS)
           for m in MODES for fg in (None, 1)}
GROUPED.update({f"moe-{m}-moe-none": _moe(m, "moe", None, DROPS)
                for m in ("chunked", "packed")})
GROUPED.update({f"gsort-{m}-all-none": _moe(
    m, "all", None, dict(DROPS, dispatch="global_sort"))
    for m in ("chunked", "packed")})
# dropless MoE waves, held to the one-rank engine too
DROPLESS_CASES = {f"dropless-{m}-all-none": _moe(m, "all", None, DROPLESS)
                  for m in MODES}
# admission batches of 2 rows (split, one a rank) and 3 (whole on every
# rank) of the 8 slots
PREFILL_BATCH = {f"llama-bp{bp}-{m}-all-{_fg(fg)}": _case(
    LLAMA, m, "all", fg, prefill_batch=bp)
    for bp in (2, 3) for m in ("whole", "chunked", "packed")
    for fg in (None, 1)}
TWO = {**DENSE, **GROUPED, **DROPLESS_CASES, **PREFILL_BATCH}
# 4 ranks: llama's 16 waves again (2 slots a rank, fewer than M = 4, so
# the head pads each rank's rows; the packed program's 2 rows do not
# divide by 4 and run whole on every rank), 6 slots at M = 3 (6 % 4 != 0:
# every batch whole on every rank), and deepseek with drops, held to one
# process of 4 groups (a packed program of 8 rows splits, one of 2 runs
# whole), and dropless, held to the one-rank engine
FOUR_GROUPED = {
    "llama-b6-chunked-all-none": _case(LLAMA, "chunked", "all", None,
                                       max_batch=6, M=3),
    "llama-b6-chunked-all-1": _case(LLAMA, "chunked", "all", 1,
                                    max_batch=6, M=3),
    "llama-b6-packed-all-1": _case(LLAMA, "packed", "all", 1, max_batch=6,
                                   M=3),
    "moe-chunked-all-1": _moe("chunked", "all", 1, DROPS),
    "moe-packed-all-none": _moe("packed", "all", None, DROPS),
    "moe-rp2-packed-all-none": _case(DEEPSEEK, "packed", "all", None,
                                     DROPS)}
FOUR = {**DENSE, **FOUR_GROUPED,
        **{k: v for k, v in DROPLESS_CASES.items()
           if "chunked" in k or "packed" in k}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(d: pathlib.Path, cases: dict, argvs: list) -> list:
    """Worker processes over ``cases`` in directory ``d``, one per argv."""
    d.mkdir()
    (d / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    worker = str(REPO / "tests" / "_serve_mesh_worker.py")
    return [subprocess.Popen([sys.executable, worker, *argv, str(d)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argvs]


def _collect(d: pathlib.Path, procs: list, names: list) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    for name, p, log in zip(names, procs, logs):
        assert p.returncode == 0, f"{name}:\n{log[-3000:]}"
    return [json.loads((d / f"{n}.json").read_text()) for n in names]


# the one-rank engine's waves; the dense waves held to one process of the
# 2-rank layout (a stand-in mesh) for their host state
ONE = {**DENSE, **DROPLESS_CASES, **PREFILL_BATCH,
       **{k: v for k, v in FOUR_GROUPED.items() if "llama" in k}}
ALONE2 = {**GROUPED, **DROPLESS_CASES, **PREFILL_BATCH,
          **{k: v for k, v in DENSE.items() if "-all-" in k}}


_REF_MOE = r"""
import dataclasses, functools, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.dist.sharding import axis_rules
from repro.models import get_model, layers as JL

assert len(jax.devices()) == 4
cfg = get_smoke_config("deepseek-v2-lite-16b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=0.5))
params = jax.jit(functools.partial(get_model(cfg).init, cfg=cfg,
                                   max_seq=16))(jax.random.PRNGKey(3))
p = jax.tree.map(lambda t: np.asarray(t[0]), params["stack"][1][0]["moe"])
inp = np.load(sys.argv[1])
jx = jnp.asarray(inp["x"]).astype(jnp.bfloat16)
out = {}
for G in (2, 4):
    mesh = Mesh(np.asarray(jax.devices()[:G]), ("data",))
    with mesh, axis_rules(mesh):
        f = jax.jit(functools.partial(JL.apply_moe, cfg=cfg))
        for tag, v in (("none", None), ("valid", jnp.asarray(inp["valid"]))):
            out[f"g{G}_{tag}"] = np.asarray(f(p, jx, valid=v).astype(
                jnp.float32))
flat = {}
def walk(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            walk(v, path + (k,))
    else:  # float32 values, the leaf's dtype in the key
        flat[f"p/{node.dtype}/" + "/".join(path)] = np.asarray(
            node.astype(jnp.float32))
walk(p, ())
np.savez(sys.argv[2], **out, **flat)
"""


# the launcher under torchrun, and in this process for its first output
LAUNCH_ARGV = ["--arch", LLAMA, "--smoke", "--device", "cpu", "--ft-mode",
               "entangle", "--ft-scope", "all", "--failed-group", "1",
               "--max-batch", "8", "--requests", "10", "--max-new", "4",
               "--prefill-chunk", "8"]


def _moe_inputs():
    """The reference comparison's MoE block input [4, 32, D] and its
    bucket mask (rows of 32, 21, 9 and 1 tokens)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32, get_smoke_config(DEEPSEEK).d_model)
                            ).astype(np.float32)
    valid = np.arange(32)[None, :] < np.array([32, 21, 9, 1])[:, None]
    return x, valid


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every subprocess of the module, started at once: both spawns of
    ranks, the one-process oracles but the 4-shard one, the reference's
    MoE block under meshes of 2 and 4 CPU devices, and the launcher under
    torchrun."""
    d = tmp_path_factory.mktemp("serve_mesh")
    groups = {"ranks2": (d / "r2", TWO, [["rank", str(r), "2"]
                                         for r in range(2)]),
              "ranks4": (d / "r4", FOUR, [["rank", str(r), "4"]
                                          for r in range(4)]),
              "one": (d / "a1", ONE, [["alone", "1"]]),
              "grouped2": (d / "a2", ALONE2, [["alone", "2"]])}
    out = {k: (sub, _spawn(sub, cases, argvs),
               [f"{a[0] if a[0] == 'alone' else 'rank'}{a[1]}"
                for a in argvs])
           for k, (sub, cases, argvs) in groups.items()}
    x, valid = _moe_inputs()
    np.savez(d / "moe_in.npz", x=x, valid=valid)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out["ref_moe"] = (d, subprocess.Popen(
        [sys.executable, "-c", _REF_MOE, str(d / "moe_in.npz"),
         str(d / "moe_out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    out["torchrun"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         *LAUNCH_ARGV], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=d)
    yield out
    for p in [p for k in groups for p in out[k][1]] + [
            out["ref_moe"][1], out["torchrun"]]:
        p.kill()


@pytest.fixture(scope="module")
def served(jobs):
    """{"ranks2", "ranks4": [each rank's waves], "one", "grouped2",
    "grouped4": the one-process waves (the last served here, while the
    other processes run)}."""
    out = {"grouped4": W.alone(4, FOUR_GROUPED)}
    for k in ("ranks2", "ranks4", "one", "grouped2"):
        sub, procs, names = jobs[k]
        got = _collect(sub, procs, names)
        out[k] = got if k.startswith("ranks") else got[0]
    return out


@pytest.fixture(scope="module")
def ref_moe(jobs):
    """The reference's MoE block under meshes of 2 and 4 CPU devices: its
    outputs and layer params (as torch tensors of their dtypes)."""
    d, proc = jobs["ref_moe"]
    log = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, log[-3000:]
    got = dict(np.load(d / "moe_out.npz"))
    tree: dict = {}
    for k, v in got.items():
        if k.startswith("p/"):
            node = tree
            _, dtype, *path, leaf = k.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = torch.from_numpy(v).to(getattr(torch, dtype))
    return got, tree


def _rank_logits(ranks, name) -> dict:
    """Every rank's logits digests of wave ``name``, by request: a
    request's rows come from the rank that holds them, or from every rank
    alike."""
    merged = {}
    for got in ranks:
        for rid, digests in got[name]["logits"].items():
            assert merged.setdefault(rid, digests) == digests, (name, rid)
    return merged


def _rank_tokens(ranks, name):
    for r, got in enumerate(ranks):
        assert got[name]["tokens"] == ranks[0][name]["tokens"], (name, r)
    toks = ranks[0][name]["tokens"]
    assert sorted(map(int, toks)) == list(range(len(LENGTHS)))
    assert all(len(v) == MAX_NEW[int(k)] for k, v in toks.items()), name
    return toks


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_ranks_give_the_one_rank_tokens(served, name):
    """llama across 2 ranks: the one-rank engine's tokens and head logits
    (bit for bit), request by request, in every admission mode, scope and
    failed group; the injected wave gives the healthy wave's tokens."""
    toks = _rank_tokens(served["ranks2"], name)
    assert toks == served["one"][name]["tokens"], name
    assert _rank_logits(served["ranks2"], name) == \
        served["one"][name]["logits"], name
    if name.endswith("-1"):
        assert toks == _rank_tokens(served["ranks2"],
                                    name[:-2] + "-none"), name


@pytest.mark.parametrize("name", sorted(PREFILL_BATCH))
def test_prefill_batch_ranks_give_the_one_rank_tokens(served, name):
    """Admission batches of ``prefill_batch`` rows across 2 ranks (2 rows:
    split; 3: whole on every rank): the one-rank engine's tokens and head
    logits bit for bit, and the 2-shard process's host state; failed
    group 1 rolls forward exactly; the census has the batch's rows."""
    toks = _rank_tokens(served["ranks2"], name)
    assert toks == served["one"][name]["tokens"], name
    assert _rank_logits(served["ranks2"], name) == \
        served["one"][name]["logits"], name
    for got in served["ranks2"]:
        assert got[name]["states"] == served["grouped2"][name]["states"]
    if name.endswith("-1"):
        assert toks == _rank_tokens(served["ranks2"],
                                    name[:-2] + "-none"), name
    bp = PREFILL_BATCH[name]["scfg"]["prefill_batch"]
    if "packed" not in name:
        assert {k[0] for k in served["one"][name]["prefill"]} == {bp}, name


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_moe_ranks_give_the_grouped_process_tokens(served, name):
    """deepseek across 2 ranks: the tokens and head logits of one process
    with G = 2 dispatch groups (global_sort: one group), bit for bit, with
    capacity dropping assignments; failed group 1 rolls forward exactly."""
    toks = _rank_tokens(served["ranks2"], name)
    assert toks == served["grouped2"][name]["tokens"], name
    assert _rank_logits(served["ranks2"], name) == \
        served["grouped2"][name]["logits"], name
    if name.endswith("-1"):
        assert toks == _rank_tokens(served["ranks2"],
                                    name[:-2] + "-none"), name


def test_capacity_drops_assignments(served):
    """At scope all the expert GEMMs are exact, so a wave whose capacity
    drops nothing gives the dropless wave's logits bit for bit: the
    grouped waves' logits differ from the dropless ones' in every mode,
    so their capacity dropped assignments."""
    got = served["grouped2"]
    differ = [m for m in MODES if got[f"moe-{m}-all-none"]["logits"]
              != got[f"dropless-{m}-all-none"]["logits"]]
    assert differ == list(MODES)


@pytest.mark.parametrize("name", sorted(DROPLESS_CASES))
def test_dropless_moe_ranks_give_the_one_rank_tokens(served, name):
    """deepseek across 2 ranks with a capacity no routing fills: the
    one-rank engine's tokens."""
    toks = _rank_tokens(served["ranks2"], name)
    assert toks == served["one"][name]["tokens"], name


@pytest.mark.parametrize("world,name", [(2, n) for n in sorted(TWO)]
                         + [(4, n) for n in sorted(FOUR)])
def test_host_state_is_the_same_on_every_rank(served, world, name):
    """After every step, every rank's host state equals rank 0's, and the
    one-process engine's of the same layout (a stand-in mesh of as many
    shards, on the same clock) where that wave ran there."""
    ranks = served[f"ranks{world}"]
    states = ranks[0][name]["states"]
    assert states
    for r, got in enumerate(ranks):
        assert got[name]["states"] == states, (name, r)
    alone = served[f"grouped{world}"]
    if name in alone:
        assert states == alone[name]["states"], name


def _census_of_half(case) -> list:
    """The protected-shape census of an engine with half ``case``'s slots
    (and packed rows), which every program of a 2-rank engine's rank
    matches row for row."""
    local = json.loads(json.dumps(case))
    sc = local["scfg"]
    sc["max_batch"] //= 2
    # a program splits where its rows and the admission batch's divide
    if sc.get("prefill_batch", 0) % 2 == 0:
        sc["prefill_batch"] = sc.get("prefill_batch", 0) // 2
        if sc.get("token_budget"):
            sc["token_budget"] //= 2
    local["lengths"], local["max_new"], local["failed_group"] = [3], [1], None
    return W.serve(local)["census"]


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_slots_and_census(served, world):
    """Rank g holds slots [g B/n, (g+1) B/n), or all of them where n does
    not divide B; under 2 ranks its protected-shape census is an engine's
    of B/2 slots (decode and every prefill program at half the rows; 4
    ranks of 8 slots hold 2 each, fewer than M, which no engine of its own
    may have); no wave met a plan miss."""
    cases = TWO if world == 2 else FOUR
    wants = {}
    for name, case in cases.items():
        B = case["scfg"]["max_batch"]
        split = B % world == 0
        if world == 2 and "gsort" not in name:
            key = json.dumps(dict(case, failed_group=None), sort_keys=True)
            if key not in wants:
                wants[key] = _census_of_half(case)
        for r, got in enumerate(served[f"ranks{world}"]):
            assert got[name]["rows"] == ([r * B // world, (r + 1) * B // world]
                                         if split else [0, B]), (name, r)
            head = case["scfg"]["ft_scope"] == "head"
            assert got[name]["misses"] == (None if head else 0), (name, r)
            if world == 2 and "gsort" not in name:
                assert got[name]["census"] == wants[key], (name, r)


@pytest.mark.parametrize("name", sorted(FOUR))
def test_four_ranks_give_the_oracles_tokens(served, name):
    """4 ranks: tokens and head logits bit for bit those of one process of
    the same layout (4 groups), or, for llama's 8-slot waves and the
    dropless ones, the one-rank engine's; a batch that does not divide by
    4 runs whole on every rank; failed group 1 rolls forward exactly."""
    toks = _rank_tokens(served["ranks4"], name)
    oracle = served["grouped4" if name in FOUR_GROUPED else "one"]
    assert toks == oracle[name]["tokens"], name
    assert _rank_logits(served["ranks4"], name) == oracle[name]["logits"], \
        name
    if "llama" in name:
        assert toks == served["one"][name]["tokens"], name
    if name.endswith("-1") and name[:-2] + "-none" in FOUR:
        assert toks == _rank_tokens(served["ranks4"],
                                    name[:-2] + "-none"), name


def _dropped(idx: np.ndarray, G: int, cfg) -> int:
    """Assignments the capacity drops when ``idx`` [N, k] (real tokens
    only) routes in G contiguous groups."""
    n_loc = idx.shape[0] // G
    C = TL._moe_capacity(n_loc, cfg)
    return sum(int(np.maximum(np.bincount(
        g.reshape(-1), minlength=cfg.moe.n_experts) - C, 0).sum())
        for g in idx.reshape(G, n_loc, -1))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_apply_moe_groups_match_the_reference_mesh(ref_moe, G, masked):
    """The port's ``apply_moe`` under a stand-in mesh of G ``data`` shards
    (G dispatch groups in one process) against the reference's under a
    mesh of G CPU devices, capacity dropping assignments in every group,
    with and without a bucket ``valid`` mask: the same expert choices but
    at the reference's near-ties, and outputs within the bf16 tolerance."""
    got, tree = ref_moe
    x, valid = _moe_inputs()
    cfg = get_smoke_config(DEEPSEEK)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **DROPS))
    tp = tree
    tx = torch.from_numpy(x).to(torch.bfloat16)
    v = torch.from_numpy(valid) if masked else None
    with axis_rules(StandInMesh({"data": G})):
        assert TL.moe_groups(x.shape[0] * x.shape[1], cfg) == (G, None)
        out = TL.apply_moe(tp, tx, cfg=cfg, valid=v).float().numpy()
    want = got[f"g{G}_{'valid' if masked else 'none'}"]
    _, idx = TL.route(tp, TL.apply_norm(tp["norm"], tx, cfg).reshape(
        -1, cfg.d_model), cfg=cfg)
    assert _dropped(idx.numpy(), G, cfg) > 0
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=LAYER_TOL * np.abs(want).max())
    with axis_rules(StandInMesh({"data": 3})):  # 128 tokens: one group
        assert TL.moe_groups(128, cfg) == (1, None)


def test_launcher_under_torchrun(jobs):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve ...
    --device cpu``: each rank checks the roll-forward, rank 0 prints one
    EXACT ROLL-FORWARD per scope, and the first output is the one-process
    launcher's."""
    proc = jobs["torchrun"]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, (stdout + stderr)[-3000:]
    lines = stdout.splitlines()
    assert sum("EXACT ROLL-FORWARD" in ln for ln in lines) == 2, stdout
    assert not any("RECOVERY FAILED" in ln for ln in lines)
    assert sum("over 2 ranks (this one: slots [0, 4))" in ln
               for ln in lines) == 1, stdout
    first = [ln.split("first output: ")[1] for ln in lines
             if "first output: " in ln]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(LAUNCH_ARGV)
    want = [ln.split("first output: ")[1] for ln in buf.getvalue().splitlines()
            if "first output: " in ln]
    assert first == want and len(want) == 1
