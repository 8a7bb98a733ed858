"""Training across ranks on the CPU: the train step's split of the global
batch and its gradient sum, the loop across ranks, checkpoint resume
across world sizes, and the train launcher under ``torchrun``.

One module fixture starts every subprocess at once: 2 gloo ranks of
tests/_train_mesh_worker.py over every case, the reference's oracles in
one subprocess per arch (:func:`_ref_job`; the ranks wait for its params)
and the launcher under ``python -m torch.distributed.run
--nproc-per-node 2``. The port's one-process oracle then runs each step
here, from the ranks' state before it, with no group, under a stand-in
mesh of 2 ``data`` shards (the one-process layout of the same mesh: the
MoE block's 2 dispatch groups).

The reference's own mesh run cannot be the oracle: under jax 0.9.0 its
launcher's ``jax.make_mesh`` makes Explicit axes, on which its
``constrain`` raises (ROADMAP queue 3). Up to float summation order, a
data-parallel GSPMD step is the single-device step on the global batch,
so the oracle is the reference's single-device step, composed as its
``make_train_step`` composes it (one compiled ``value_and_grad`` per
microbatch shape serves every sync flavour), with its ``apply_moe`` seeing
the 2 ``batch`` shards of the mesh (``axis_extent`` patched for the
oracle: the reference's dispatch groups, G = 2 contiguous halves).

  * llama3.2-1b and deepseek-v2-lite-16b smoke (MoE: grouped dispatch,
    G = 1 a rank, an expert's capacity overflowing in every layer), with
    ``grad_sync`` entangle (accum 1 and 2) and spmd, from the reference's
    params bridged over: the ranks are bit-identical to each other after
    every step; each step is within test_torch_train.py's tolerances of
    the port's one-process step from the same state (a later step's
    params within LATER_PARAM_REL of its lr), and the first step within
    them of the reference's (deepseek within MOE_REF); the routes are
    the reference's but at near-ties;
  * a fail-stopped gradient block gives the healthy step bit for bit on
    each rank, for every block;
  * a ``loss_mask`` whose rows count differently (naive and streamed CE,
    the MTP term of deepseek-v3, accum 2): the one-process loss and
    gradients; a rank that averaged its local mean would be far off;
  * a batch of 3 on 2 ranks: every rank computes it whole, and gives the
    one-process result bit for bit;
  * deepseek with ``dispatch="global_sort"``: every rank gathers all the
    ranks' tokens into one dispatch group (the gather's backward sums its
    gradient over the group), so the oracle is the reference's
    single-device step itself; the ranks' steps, routes and summed
    gradient match it and the one-process step as the grouped case's do,
    and a fail-stopped block rolls forward on the kernel codec;
  * the loop: its checkpoints are written by rank 0 alone and restored by
    every rank; the fail-stop drill changes nothing; resuming 2 ranks in
    one process and 1 process on 2 ranks continues the uninterrupted
    run's losses;
  * the launcher under torchrun: one banner a rank, naming world 2, and
    equal losses.
"""
import collections
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_mesh_worker as W
import _train_oracle as oracle
import repro.dist.sharding as JS
from repro.configs import get_smoke_config as jsmoke
from repro.dist import collectives as jcoll
from repro.models import get_model as jget_model
from repro.models.api import lm_loss as jlm_loss
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke_config
from repro_torch.dist.sharding import StandInMesh, axis_rules
from repro_torch.models import layers as TL
from repro_torch.optim import adamw
from repro_torch.train.train_step import loss_and_grads, mask_counts
from repro_torch.tree import leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
LLAMA, DEEPSEEK, V3 = "llama3.2-1b", "deepseek-v2-lite-16b", "deepseek-v3-671b"
WORLD, B, T, STEPS = 2, 4, 32, 2
# test_torch_train.py's tolerances of one train step (measured there)
LOSS_ATOL = 1e-4
GNORM_REL = 2e-3
# a rank's gradient against one process's: the weight gradients of the
# bf16 GEMMs are rounded to bf16 per rank before the float32 sum, one
# process rounds the whole sum once (2.4e-3 normwise measured here); a
# wrong loss weighting is off by order 1
GRAD_REL = 2.0 ** -6
# losses of a loop several steps on: each step's bf16 rounding of the
# ranks' partial gradients moves the next loss by up to 2.3e-4 here
# (measured), the loss falls by 4e-2 over the loop
LOOP_LOSS_ATOL = 1e-3
# a step after the first from the same state: AdamW's update then scales
# with the gradient's magnitude, which the ranks' bf16 partials round
# 2^-8 apart, so params may part by a small share of the step's lr
LATER_PARAM_REL = 2.0 ** -6
# deepseek against the reference: the two frameworks' bf16 activations
# round an ulp apart here and there (tests/test_torch_moe.py), which moves
# the smoke loss by up to 1.8e-4 over six batches and sets 1.5% of the
# params of a first step (sign(g) · lr) on the other side of 1e-6
# (measured, 1 and 2 dispatch groups); tests/test_torch_train_moe.py's
# batch stays within test_torch_train.py's tolerances, this one not
MOE_REF = dict(loss=2.0 ** -11, off=2.0 ** -5)
# top-k gaps at or below this are near-ties (test_torch_train_moe.py)
NEAR_TIE = 2.0 ** -9
SYNCS = (("entangle", 1, "plain"), ("entangle", 2, "kernel"),
         ("spmd", 1, "plain"))


def _steps_case(arch, sync, accum, codec, **kw):
    case = dict(kind="steps", arch=arch, params="ref", batches="b4",
                steps=STEPS, tcfg=dict(max_seq=64, grad_sync=sync,
                                       grad_accum=accum, grad_codec=codec),
                failed=[0, 1, 2, 3] if sync == "entangle" else [])
    case.update(kw)
    return case


STEP_CASES = {f"{a}-{s}-{k}": _steps_case(a, s, k, c)
              for a in (LLAMA, DEEPSEEK) for s, k, c in SYNCS}
MASK_CASES = {
    "mask-llama": _steps_case(LLAMA, "spmd", 1, "plain", params=None,
                              batches="bmask", steps=1, grads=True),
    "mask-llama-streamed": _steps_case(
        LLAMA, "spmd", 1, "plain", params=None, batches="bmask", steps=1,
        grads=True, cfg=dict(loss_impl="streamed")),
    "mask-llama-accum2": _steps_case(LLAMA, "entangle", 2, "kernel",
                                     params=None, batches="bmask", steps=1,
                                     grads=True, failed=[]),
    "mask-v3": _steps_case(V3, "spmd", 1, "plain", params=None,
                           batches="bmask", steps=1, grads=True)}
B3_CASES = {f"b3-{a}": _steps_case(a, "entangle", 1, "kernel", params=None,
                                   batches="b3", failed=[1])
            for a in (LLAMA, DEEPSEEK)}
LOOP = dict(kind="loop", arch=LLAMA, seq=T, batch=B,
            tcfg=dict(max_seq=64, grad_sync="entangle"),
            loop=dict(total_steps=4, ckpt_every=2, fail_block_at_step=1))
LOOP_CASES = {"loop": LOOP,
              "loop-healthy": dict(LOOP, loop=dict(LOOP["loop"],
                                                   fail_block_at_step=None)),
              "resume12": LOOP}
# every rank's tokens in one dispatch group: the single-device step's
GLOBAL_SORT = _steps_case(DEEPSEEK, "entangle", 1, "kernel", grads=True,
                          cfg=dict(moe=dict(dispatch="global_sort")))
# the ranks run them in this order: the reference's params arrive while
# they run the first ones, and resume12's checkpoint is the loop's here
CASES = {**MASK_CASES, **B3_CASES, "global-sort": GLOBAL_SORT,
         **{k: v for k, v in LOOP_CASES.items() if k != "resume12"},
         **STEP_CASES, "resume12": LOOP}
# the launcher under torchrun, and in this process
LAUNCH_ARGV = ["--arch", LLAMA, "--smoke", "--device", "cpu", "--steps", "2",
               "--seq", str(T)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(d: pathlib.Path) -> None:
    """The global batches: [STEPS, B, T] tokens; the same with a
    ``loss_mask`` whose rows keep 32, 20, 7 and 1 tokens; 3 rows."""
    tokens = np.random.default_rng(0).integers(
        0, get_smoke_config(LLAMA).vocab_size, size=(STEPS, B, T)
    ).astype(np.int32)
    mask = (np.arange(T)[None, :] < np.array([32, 20, 7, 1])[:, None])
    mask = np.broadcast_to(mask, tokens.shape).astype(np.int32)
    np.savez(d / "b4.npz", tokens=tokens)
    np.savez(d / "bmask.npz", tokens=tokens, loss_mask=mask)
    np.savez(d / "b3.npz", tokens=tokens[:, :3])


def _groups(name: str) -> int:
    return WORLD if name == "batch" else 1


def _ref_job(arch: str, d: str) -> None:
    """Run in a subprocess, one per arch, while the ranks run: the
    reference's params of ``arch`` into ``d/params_<arch>.npz`` (its
    leaves in its flattening order; the ranks wait for the file), then
    its first step from them on ``b4``'s first batch for every flavour of
    SYNCS into ``d/ref_<arch>.npz``: loss, grad norm, new params and
    routes, and step 0's lr; for an MoE arch also GLOBAL_SORT's first step
    (``gs/...``), whose one dispatch group is the single-device step's
    whatever the mesh."""
    d = pathlib.Path(d)
    cfg = jsmoke(arch)
    params = oracle.init_params(cfg, max_seq=64)
    flat = jax.tree.leaves(params)
    assert all(x.dtype == np.float32 for x in flat)
    np.savez(d / f"params_{arch}.tmp.npz",
             **{str(i): x for i, x in enumerate(flat)})
    os.replace(d / f"params_{arch}.tmp.npz", d / f"params_{arch}.npz")
    tokens = np.load(d / "b4.npz")["tokens"][0]
    jm = jget_model(cfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(jm.forward_train(p, b, cfg), b, cfg)))
    jp = jax.tree.map(jnp.asarray, params)
    lr_cfg = jadamw.effective_lr_config(jadamw.AdamWConfig(), cfg.d_model)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    JS.axis_extent = _groups  # the mesh's 2 dispatch groups
    with oracle.recording_routes() as routes:  # one list: compiled calls
        parts = {k: [vg(jp, {"tokens": jnp.asarray(mb)})  # report to it
                     for mb in tokens.reshape(k, B // k, T)] for k in (1, 2)}
        jax.block_until_ready(parts)
    routes = {1: routes[:n_moe], 2: routes[n_moe:3 * n_moe]}
    by_k = {1: parts[1][0]}
    # make_train_step's float32 accumulation over 2 microbatches
    loss = jnp.float32(0)
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    for l, g in parts[2]:
        loss = loss + l
        acc = jax.tree.map(lambda a, x: a + x.astype(jnp.float32), acc, g)
    by_k[2] = (loss / 2, jax.tree.map(lambda g: g / 2, acc))

    def finish(grads_by_k, syncs=SYNCS):  # the rest of the step, every
        done = {}                          # flavour at once
        for sync, k, _ in syncs:
            g = grads_by_k[k]
            if sync == "entangle":
                g, _ = jcoll.ft_grad_sync(g, axis_name=None, n_replicas=1,
                                          M=4, codec="xla")
            gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                                 for x in jax.tree.leaves(g)))
            new, _ = jadamw.update(g, jadamw.init(
                jp, jadamw.AdamWConfig()), jp, jnp.int32(0), lr_cfg)
            done[f"{sync}{k}"] = (gnorm, new)
        return done

    done = jax.jit(finish)({k: g for k, (_, g) in by_k.items()})
    out = {"lr": np.float32(jadamw.schedule(lr_cfg, 0))}
    for sync, k, _ in SYNCS:
        key = f"{sync}{k}"
        gnorm, new = done[key]
        out[f"{key}/loss"] = np.asarray(by_k[k][0])
        out[f"{key}/grad_norm"] = np.asarray(gnorm)
        out.update({f"{key}/params/{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(new))})
        out.update({f"{key}/routes/{i}": r
                    for i, r in enumerate(routes[k])})
    if cfg.moe is not None:
        gcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **GLOBAL_SORT["cfg"]["moe"]))
        gvg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm_loss(jm.forward_train(p, b, gcfg), b, gcfg)))
        with oracle.recording_routes() as groutes:
            gloss, grads = gvg(jp, {"tokens": jnp.asarray(tokens)})
            jax.block_until_ready(grads)
        gnorm, new = jax.jit(lambda g: finish(
            {1: g}, (("entangle", 1, "kernel"),))["entangle1"])(grads)
        out.update({"gs/loss": np.asarray(gloss),
                    "gs/grad_norm": np.asarray(gnorm)})
        out.update({f"gs/params/{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(new))})
        out.update({f"gs/routes/{i}": r for i, r in enumerate(groutes)})
    np.savez(d / f"ref_{arch}.npz", **out)


_REF_JOB = ("import sys; sys.path.insert(0, sys.argv[3]); "
            "import test_torch_train_mesh as t; "
            "t._ref_job(sys.argv[1], sys.argv[2])")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every result of the module: ``ranks`` (each rank's records),
    ``one`` (the one-process oracle's, each step from the ranks' state
    before it), ``ref`` (the reference's first steps, by arch), the
    one-process loops (``loop1``: uninterrupted, ``resume21``: resumed
    from the ranks' checkpoint of step 2), and the launcher's output
    under torchrun (``torchrun``) and in this process (``alone``)."""
    d = tmp_path_factory.mktemp("train_mesh")
    _batches(d)
    (d / "cases.json").write_text(json.dumps(CASES))
    one_dir = d / "one"
    one_dir.mkdir()
    for f in ("cases.json", "b4.npz", "bmask.npz", "b3.npz"):
        shutil.copy(d / f, one_dir)
    stand_in = StandInMesh({"data": WORLD, "model": 1})
    with axis_rules(stand_in):  # the run the ranks resume from
        loop1 = W.run_case("loop", LOOP, one_dir)
    shutil.copytree(one_dir / "loop" / "step_00000002",
                    d / "resume12" / "step_00000002")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    worker = str(REPO / "tests" / "_train_mesh_worker.py")
    launch_dir = d / "launch"
    launch_dir.mkdir()
    cmds = [[worker, str(r), str(WORLD), str(d)] for r in range(WORLD)]
    cmds += [["-c", _REF_JOB, a, str(d), str(REPO / "tests")]
             for a in (DEEPSEEK, LLAMA)]
    cmds.append(["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(WORLD), "-m",
                 "repro_torch.launch.train", *LAUNCH_ARGV, "--ckpt-dir",
                 str(launch_dir / "ckpt")])
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, *c], env=dict(env, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=launch_dir) for c in cmds]
        from repro_torch.launch.train import main as launch_main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_main([*LAUNCH_ARGV, "--ckpt-dir", str(d / "alone")])
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for c, p, log in zip(cmds, procs, logs):
        assert p.returncode == 0, f"{c[-3:]}:\n{log[-4000:]}"
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    ref = {a: dict(np.load(d / f"ref_{a}.npz")) for a in (LLAMA, DEEPSEEK)}
    one = {}
    with axis_rules(stand_in):
        for name, case in CASES.items():
            if case["kind"] != "steps":
                continue
            cfg, tcfg = W.build(case)
            for s in range(case["steps"]):
                state = (W.init(case, d, cfg, tcfg) if s == 0 else
                         W.state_from(case, d, ranks[0],
                                      f"{name}/s{s - 1}/state"))
                one.update(W.step_case(name, case, one_dir, state, s,
                                       grads=case.get("grads", False))[1])
        shutil.copytree(d / "loop" / "step_00000002",
                        one_dir / "resume21" / "step_00000002")
        resume21 = W.run_case("resume21", LOOP, one_dir)
    return dict(ranks=ranks, one=one, ref=ref, loop1=loop1,
                resume21=resume21, torchrun=logs[-1], alone=buf.getvalue())


def _lr(case, s) -> float:
    cfg = get_smoke_config(case["arch"])
    lr_cfg = adamw.effective_lr_config(adamw.AdamWConfig(), cfg.d_model)
    return adamw.schedule(lr_cfg, torch.tensor(s, dtype=torch.int32)).item()


def _params_close(got: list, want: list, lr: float, near: float = 1e-6,
                  off: float = 0.01) -> None:
    """test_torch_train.py's rule for one step's params: within 2·lr +
    1e-6 everywhere (AdamW's first step moves a param by lr·sign(g), so a
    near-zero gradient whose sign two sums round differently moves it
    2·lr apart) and within ``near`` for all but a share ``off`` of them."""
    assert len(got) == len(want)
    n_off = n_all = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        dd = np.abs(a - b)
        assert dd.max() <= 2 * lr + 1e-6
        n_off += int((dd > near).sum())
        n_all += dd.size
    assert n_off <= off * n_all, (n_off, n_all)


def _leaves(rec: dict, prefix: str) -> list:
    n = sum(1 for k in rec if k.startswith(prefix + "/"))
    return [rec[f"{prefix}/{i}"] for i in range(n)]


def _params_of(rec: dict, name: str, s: int) -> list:
    """The params of the state recorded after step s: its leaves, in the
    state's flattening order (sorted keys), are the moments m and v, the
    params, one leaf each, and then the step."""
    state = _leaves(rec, f"{name}/s{s}/state")
    n = (len(state) - 1) // 3
    return state[2 * n:3 * n]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_bit_identical(runs, name):
    """Every record of every case (losses, grad norms, states, gradients,
    checks) is the same bits on both ranks; a rank's routes are its own
    rows."""
    r0, r1 = runs["ranks"]
    keys = [k for k in r0 if k.startswith(name + "/")]
    assert keys and sorted(keys) == sorted(k for k in r1
                                           if k.startswith(name + "/"))
    for k in keys:
        if "/routes/" in k or "/gaps/" in k or k.endswith("/writes") \
                or k.endswith("/log"):
            continue
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
@pytest.mark.parametrize("s", range(STEPS))
def test_step_matches_one_process(runs, name, s):
    """Step s on the ranks against the port's one-process step from the
    same state (the ranks' state after step s - 1) on the same global
    batch: the first step within test_torch_train.py's tolerances; a
    later one with its params within LATER_PARAM_REL of its lr for all
    but 1% of them."""
    r0, one, case = runs["ranks"][0], runs["one"], STEP_CASES[name]
    key = f"{name}/s{s}"
    assert abs(float(r0[f"{key}/loss"]) - float(one[f"{key}/loss"])) \
        < LOSS_ATOL
    assert float(r0[f"{key}/grad_norm"]) == pytest.approx(
        float(one[f"{key}/grad_norm"]), rel=GNORM_REL)
    lr = _lr(case, s)
    _params_close(_params_of(r0, name, s), _params_of(one, name, s), lr,
                  near=1e-6 if s == 0 else LATER_PARAM_REL * lr)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_first_step_matches_reference(runs, name):
    """The ranks' first step against the reference's single-device step
    from its own params: llama within test_torch_train.py's tolerances,
    deepseek within MOE_REF."""
    case = STEP_CASES[name]
    tc = case["tcfg"]
    ref = runs["ref"][case["arch"]]
    key = f"{tc['grad_sync']}{tc['grad_accum']}"
    tol = (dict(loss=LOSS_ATOL, off=0.01) if case["arch"] == LLAMA
           else MOE_REF)
    r0 = runs["ranks"][0]
    assert abs(float(r0[f"{name}/s0/loss"]) - float(ref[f"{key}/loss"])) \
        < tol["loss"]
    assert float(r0[f"{name}/s0/grad_norm"]) == pytest.approx(
        float(ref[f"{key}/grad_norm"]), rel=GNORM_REL)
    _params_close(_params_of(r0, name, 0), _leaves(ref, f"{key}/params"),
                  float(ref["lr"]), off=tol["off"])


@pytest.mark.parametrize("name", sorted(k for k in STEP_CASES
                                        if k.startswith(DEEPSEEK)))
def test_moe_routes_are_the_reference_groups(runs, name):
    """deepseek's router (the one-process oracle, 2 dispatch groups) picks
    the reference's experts for every token but at near-ties (a gap of at
    most NEAR_TIE between its k-th and (k+1)-th probabilities, as
    tests/test_torch_train_moe.py allows; a token's experts in either
    order), and each rank's tokens are its rows of the oracle's routes;
    in every MoE layer of every microbatch some group overflows an
    expert's capacity, so the comparisons include capacity drops."""
    tc = STEP_CASES[name]["tcfg"]
    want = _leaves(runs["ref"][DEEPSEEK],
                   f"{tc['grad_sync']}{tc['grad_accum']}/routes")
    one = _leaves(runs["one"], f"{name}/s0/routes")
    gaps = _leaves(runs["one"], f"{name}/s0/gaps")
    ranks = [_leaves(r, f"{name}/s0/routes") for r in runs["ranks"]]
    assert len(one) == len(want) == len(ranks[0]) > 0
    cfg = get_smoke_config(DEEPSEEK)
    for i, w in enumerate(want):
        differ = (np.sort(one[i], -1) != np.sort(w, -1)).any(-1)
        assert (gaps[i][differ] <= NEAR_TIE).all(), gaps[i][differ]
        np.testing.assert_array_equal(
            np.concatenate([r[i] for r in ranks]), one[i])
        C = TL._moe_capacity(len(w) // WORLD, cfg)
        assert max(np.bincount(g.ravel(), minlength=cfg.moe.n_experts).max()
                   for g in np.split(w, WORLD)) > C


@pytest.mark.parametrize("name", sorted(
    k for k, c in {**STEP_CASES, **B3_CASES,
                   "global-sort": GLOBAL_SORT}.items() if c["failed"]))
def test_failstop_step_bit_identical_on_every_rank(runs, name):
    for r in runs["ranks"]:
        for fb in CASES[name]["failed"]:
            assert bool(r[f"{name}/s0/failed{fb}"]), (name, fb)


def _local_mean_grads(case: dict, d_batches: dict) -> list:
    """The gradient of a wrong weighting: each rank's own masked mean of
    its rows, averaged over the ranks (and the microbatches)."""
    from repro_torch.train.train_step import init_state

    cfg, tcfg = W.build(case)
    params = init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                        device="cpu")["params"]
    k = tcfg.grad_accum
    total = None
    for mb in range(k):
        rows = B // k
        for g in range(WORLD):
            lo = mb * rows + g * rows // WORLD
            hi = lo + rows // WORLD
            part = {key: torch.from_numpy(v[0][lo:hi])
                    for key, v in d_batches.items()}
            _, grads = loss_and_grads(cfg, params, part)
            flat = [x.to(torch.float32) / (WORLD * k) for x in leaves(grads)]
            total = flat if total is None else [a + b for a, b in
                                                zip(total, flat)]
    return [t.numpy() for t in total]


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_uneven_loss_mask_gives_the_global_loss(runs, name):
    """Rows that count 31, 19, 6 and 0 masked tokens: the ranks' loss
    and summed gradient are the one-process ones; the ranks' own means,
    averaged, would give a gradient far from it."""
    r0, one = runs["ranks"][0], runs["one"]
    key = f"{name}/s0"
    assert abs(float(r0[f"{key}/grad_loss"]) - float(one[f"{key}/grad_loss"])
               ) < LOSS_ATOL
    assert float(r0[f"{key}/loss"]) == float(r0[f"{key}/grad_loss"])
    got, want = _leaves(r0, f"{key}/grads"), _leaves(one, f"{key}/grads")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_REL
    wrong = _local_mean_grads(MASK_CASES[name], _mask_batches())
    worst = max(_rel(a, b) for a, b in zip(wrong, want))
    assert worst > 10 * GRAD_REL, worst


def _mask_batches() -> dict:
    tokens = np.random.default_rng(0).integers(
        0, get_smoke_config(LLAMA).vocab_size, size=(STEPS, B, T)
    ).astype(np.int32)
    mask = (np.arange(T)[None, :] < np.array([32, 20, 7, 1])[:, None])
    return {"tokens": tokens,
            "loss_mask": np.broadcast_to(mask, tokens.shape).astype(
                np.int32)}


def test_mask_counts_are_the_global_batch_counts():
    batch = {k: torch.from_numpy(v[0]) for k, v in _mask_batches().items()}
    c1, c2 = mask_counts(batch)
    assert (c1.item(), c2.item()) == (31 + 19 + 6 + 0, 30 + 18 + 5 + 0)
    c1, c2 = mask_counts({"tokens": batch["tokens"]})
    assert (c1.item(), c2.item()) == (B * (T - 1), B * (T - 2))


@pytest.mark.parametrize("name", sorted(B3_CASES))
def test_batch_that_does_not_divide_runs_whole(runs, name):
    """3 rows on 2 ranks: the reference's rule drops the split, so every
    rank computes the whole batch (in the one-process layout of 2 MoE
    dispatch groups) and gives the one-process result bit for bit."""
    r0, one = runs["ranks"][0], runs["one"]
    for s in range(STEPS):
        key = f"{name}/s{s}"
        for k in [k for k in one if k.startswith(key + "/")
                  and "/routes/" not in k]:
            np.testing.assert_array_equal(r0[k], one[k], err_msg=k)


def test_checkpoint_written_once_and_restored_on_every_rank(runs):
    """Rank 0 alone writes the loop's checkpoints (the steps one process
    writes), every rank restores the last one to its own final state bit
    for bit, and the fail-stop drill leaves the loop unchanged."""
    r0, r1 = runs["ranks"]
    np.testing.assert_array_equal(r0["loop/writes"],
                                  runs["loop1"]["loop/writes"])
    assert list(r0["loop/writes"]) == [2, 4, 4]
    assert r1["loop/writes"].size == 0
    for r in (r0, r1):
        assert bool(r["loop/restored"]) and bool(r["resume12/restored"])
        np.testing.assert_array_equal(r["loop/losses"],
                                      r["loop-healthy/losses"])
        for a, b in zip(_leaves(r, "loop/params"),
                        _leaves(r, "loop-healthy/params")):
            np.testing.assert_array_equal(a, b)
    want = runs["loop1"]["loop/losses"]
    got = r0["loop/losses"]
    assert abs(got[0] - want[0]) < LOSS_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOP_LOSS_ATOL)


@pytest.mark.parametrize("way", ["2->1", "1->2"])
def test_resume_across_world_sizes(runs, way):
    """The checkpoint of step 2 written by 2 ranks resumes in one process,
    and one process's resumes on 2 ranks: each continues the
    uninterrupted run that wrote it (its first loss from the restored
    params within one step's tolerance)."""
    if way == "2->1":
        logs = [str(runs["resume21"]["resume21/log"])]
        got = runs["resume21"]["resume21/losses"]
        want = runs["ranks"][0]["loop/losses"][2:]
    else:
        logs = [str(r["resume12/log"]) for r in runs["ranks"]]
        got = runs["ranks"][0]["resume12/losses"]
        want = runs["loop1"]["loop/losses"][2:]
    for log in logs:
        assert "[trainer] resumed from step 2" in log
    assert len(got) == 2
    assert abs(got[0] - want[0]) < LOSS_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOP_LOSS_ATOL)


def test_launcher_under_torchrun(runs):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train ... --device cpu``: one banner a rank, each
    naming world 2 and the (2, 1) mesh, and the same losses on both
    ranks; the first loss is the one-process launcher's."""
    out = runs["torchrun"].splitlines()
    banners = sorted(l for l in out if l.startswith("[launch.train] rank"))
    assert len(banners) == WORLD
    for r, line in enumerate(banners):
        assert line.startswith(f"[launch.train] rank {r} of world {WORLD}:")
        assert "mesh={'data': 2, 'model': 1}" in line
        assert "global batch=4" in line
    done = [l for l in out if l.startswith("[launch.train] done: loss")]
    assert len(done) == WORLD and done[0] == done[1]
    steps = collections.Counter(l.split(" (")[0] for l in out
                                if l.startswith("[trainer] step"))
    assert len(steps) == 2 and set(steps.values()) == {WORLD}, steps
    alone = runs["alone"]
    assert "[launch.train] rank 0 of world 1:" in alone
    first = float(done[0].split("done: loss ")[1].split(" -> ")[0])
    want = float(alone.split("done: loss ")[1].split(" -> ")[0])
    assert abs(first - want) <= 2e-4


@pytest.mark.parametrize("s", range(STEPS))
def test_global_sort_step_matches_one_process(runs, s):
    """``dispatch="global_sort"`` across 2 ranks: step s against the
    port's one-process step from the same state (one dispatch group over
    the global batch, as on the ranks): the loss and grad norm within the
    grouped case's tolerances, the summed gradient leaf by leaf within
    GRAD_REL, and the first step's params within test_torch_train.py's
    rule.

    The gather's backward hands each rank the gradient of its rows of the
    MoE block's input as one bf16 sum (router and expert rows), to which
    the shared experts' part is added after; one process adds the three
    in another order. So the block's input gradient parts by a few bf16
    ulps (2.8e-3 normwise at the smoke layer, measured), which every
    earlier layer carries: the summed gradient is 1.1e-2 from one
    process's here (2.4e-3 in the grouped case, whose ranks keep their
    tokens), and AdamW's update of a later step turns that into params
    more than LATER_PARAM_REL of the lr apart on 1.2% of them, so a later
    step is held by its loss, grad norm and summed gradient."""
    r0, one = runs["ranks"][0], runs["one"]
    key = f"global-sort/s{s}"
    assert abs(float(r0[f"{key}/loss"]) - float(one[f"{key}/loss"])) \
        < LOSS_ATOL
    assert float(r0[f"{key}/grad_norm"]) == pytest.approx(
        float(one[f"{key}/grad_norm"]), rel=GNORM_REL)
    if s == 0:
        _params_close(_params_of(r0, "global-sort", s),
                      _params_of(one, "global-sort", s),
                      _lr(GLOBAL_SORT, s))
    got, want = _leaves(r0, f"{key}/grads"), _leaves(one, f"{key}/grads")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_REL


def test_global_sort_first_step_matches_reference(runs):
    """The ranks' first global_sort step against the reference's
    single-device step on the global batch (its one dispatch group is
    what every rank routes after the gather): loss and params within
    MOE_REF and the grad norm within GNORM_REL, as the grouped case's;
    every rank routes all the global batch's tokens as one process does,
    and picks the reference's experts but at near-ties."""
    ref, r0 = runs["ref"][DEEPSEEK], runs["ranks"][0]
    assert abs(float(r0["global-sort/s0/loss"]) - float(ref["gs/loss"])) \
        < MOE_REF["loss"]
    assert float(r0["global-sort/s0/grad_norm"]) == pytest.approx(
        float(ref["gs/grad_norm"]), rel=GNORM_REL)
    _params_close(_params_of(r0, "global-sort", 0),
                  _leaves(ref, "gs/params"), float(ref["lr"]),
                  off=MOE_REF["off"])
    want = _leaves(ref, "gs/routes")
    one = _leaves(runs["one"], "global-sort/s0/routes")
    gaps = _leaves(runs["one"], "global-sort/s0/gaps")
    assert len(want) == len(one) > 0
    for r in runs["ranks"]:
        for a, b in zip(_leaves(r, "global-sort/s0/routes"), one):
            np.testing.assert_array_equal(a, b)
    for i, w in enumerate(want):
        assert one[i].shape == w.shape == (B * T, w.shape[1])
        differ = (np.sort(one[i], -1) != np.sort(w, -1)).any(-1)
        assert (gaps[i][differ] <= NEAR_TIE).all(), gaps[i][differ]
