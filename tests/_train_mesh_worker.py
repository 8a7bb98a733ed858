"""A rank of tests/test_torch_train_mesh.py's gloo group, and the
one-process oracle of the same cases (imports torch and the port only,
never JAX):

    python tests/_train_mesh_worker.py RANK WORLD DIR

The rank joins the group through the file store ``DIR/store``, runs every
case of ``DIR/cases.json`` (:func:`run_case`) under
``axis_rules(make_local_mesh())`` (every rank on ``data``) and writes what
each case gave to ``DIR/rank<RANK>.npz``. The test runs the same cases in
its own process, with no group, under a stand-in mesh of WORLD ``data``
shards: the one-process layout of the same mesh (the MoE block's WORLD
dispatch groups).

A case is a dict:

  * ``kind="steps"``: ``steps`` train steps of ``make_train_step`` from
    the reference's params (``DIR/params_<arch>.npz``, its leaves in the
    reference's flattening order) or from the port's seeded init, on the
    global batches ``DIR/<batches>.npz`` (``tokens`` and, optionally,
    ``loss_mask``, [steps, B, T]); records each step's loss, grad norm,
    routes and new state (:func:`step_case`), its summed gradient
    (``grads``), and whether the first step with each of ``failed``
    fail-stopped equals the healthy step bit for bit;
  * ``kind="loop"``: ``train_loop`` into ``DIR/<name>`` (which may hold a
    checkpoint to resume from); records the losses, the final params, the
    checkpoint writes this process made, the loop's log, and whether the
    latest checkpoint restores to the final state bit for bit.
"""
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def build(case: dict):
    """(cfg, TrainConfig) of a case: the arch's smoke config with the
    case's overrides (``moe``'s applied to its MoE config)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    over = dict(case.get("cfg", {}))
    cfg = get_smoke_config(case["arch"])
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    cfg = dataclasses.replace(cfg, **over)
    tc = dict(case["tcfg"])
    adamw = AdamWConfig(**tc.pop("adamw", {}))
    return cfg, TrainConfig(adamw=adamw, **tc)


def init(case: dict, d: pathlib.Path, cfg, tcfg) -> dict:
    """The case's initial train state on the CPU: the reference's params
    (bridged; waiting up to 5 minutes for their file) with fresh moments,
    or the port's seeded init, on the case's ``device`` (the CPU unless
    it says ``cuda``: gloo sums the ranks' CUDA tensors too)."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state
    from repro_torch.tree import leaves, unflatten

    dev = torch.device(case.get("device", "cpu"))
    state = init_state(torch.Generator(device=dev).manual_seed(
        case.get("seed", 0)), cfg, tcfg, device=dev)
    if case.get("params") != "ref":
        return state
    path = d / f"params_{case['arch']}.npz"
    for _ in range(1200):  # written, then renamed, by the test's job
        if path.exists():
            break
        time.sleep(0.25)
    got = np.load(path)
    like = state["params"]
    params = unflatten(like, [torch.from_numpy(got[str(i)]).to(t)
                              for i, t in enumerate(leaves(like))])
    return {"params": params, "opt": adamw.init(params, tcfg.adamw),
            "step": state["step"]}


def _flat(prefix: str, tree) -> dict:
    from repro_torch.tree import leaves

    return {f"{prefix}/{i}": t.detach().cpu().numpy().copy()
            for i, t in enumerate(leaves(tree))}


@contextlib.contextmanager
def own_routes():
    """Within: every MoE router call appends to the yielded list, in call
    order, its top-k expert ids [N, k] (the port's own choice) and the gap
    between each token's k-th and (k+1)-th probabilities [N]."""
    from repro_torch.models import layers as TL

    saved, out = TL._top_k, []

    def top_k(probs, k):
        vals, idx = saved(probs, k + 1)
        gap = (vals[..., k - 1] - vals[..., k]).detach()
        out.append((idx[..., :k].reshape(-1, k).cpu().numpy(),
                    gap.reshape(-1).cpu().numpy()))
        return vals[..., :k], idx[..., :k]

    TL._top_k = top_k
    try:
        yield out
    finally:
        TL._top_k = saved


def _equal(a, b) -> bool:
    from repro_torch.tree import leaves

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def batch_of(case: dict, d: pathlib.Path, s: int) -> dict:
    """Global batch ``s`` of a steps case, on its device."""
    data = np.load(d / f"{case['batches']}.npz")
    dev = torch.device(case.get("device", "cpu"))
    return {k: torch.from_numpy(data[k][s]).to(dev) for k in data.files}


def state_from(case: dict, d: pathlib.Path, flat: dict, prefix: str):
    """A train state of the case's structure from its leaves
    ``flat[f"{prefix}/{i}"]`` (as :func:`run_steps` records them)."""
    from repro_torch.tree import leaves, unflatten

    cfg, tcfg = build(case)
    like = init(dict(case, params=None), d, cfg, tcfg)
    return unflatten(like, [torch.from_numpy(flat[f"{prefix}/{i}"]).to(t)
                            for i, t in enumerate(leaves(like))])


def step_case(name: str, case: dict, d: pathlib.Path, state, s: int,
              failed=(), grads=False) -> tuple:
    """Step ``s`` of a steps case from ``state``: (new state, record of
    its loss, grad norm, routes, new state, the entangle and disentangle
    kernels' launches, and, with ``grads``, the summed gradient; for each
    block of ``failed``, whether the step with it fail-stopped equals the
    healthy step bit for bit)."""
    from repro_torch.kernels import disentangle as kdis
    from repro_torch.kernels import entangle as kent
    from repro_torch.train.train_step import (accumulated_grads,
                                              make_train_step)

    cfg, tcfg = build(case)
    batch = batch_of(case, d, s)
    out, key = {}, f"{name}/s{s}"
    if grads:
        loss, g = accumulated_grads(cfg, tcfg, state["params"], batch)
        out[f"{key}/grad_loss"] = loss.cpu().numpy()
        out.update(_flat(f"{key}/grads", g))
    before = (kent.launches, kdis.launches)
    with own_routes() as routes:
        new, metrics = make_train_step(cfg, tcfg)(state, batch)
    out[f"{key}/launches"] = np.array([kent.launches - before[0],
                                       kdis.launches - before[1]])
    for i, (r, gap) in enumerate(routes):
        out[f"{key}/routes/{i}"] = r
        out[f"{key}/gaps/{i}"] = gap
    for fb in failed:
        got, m = make_train_step(cfg, tcfg, failed_block=fb)(state, batch)
        out[f"{key}/failed{fb}"] = np.array(
            _equal(got, new) and m["ne_failed"] == fb
            and torch.equal(m["loss"], metrics["loss"])
            and torch.equal(m["grad_norm"], metrics["grad_norm"]))
    out[f"{key}/loss"] = metrics["loss"].cpu().numpy()
    out[f"{key}/grad_norm"] = metrics["grad_norm"].cpu().numpy()
    out.update(_flat(f"{key}/state", new))
    return new, out


def run_steps(name: str, case: dict, d: pathlib.Path) -> dict:
    cfg, tcfg = build(case)
    state, out = init(case, d, cfg, tcfg), {}
    for s in range(case["steps"]):
        state, rec = step_case(name, case, d, state, s,
                               failed=case.get("failed", ()) if s == 0
                               else (), grads=case.get("grads", False))
        out.update(rec)
    return out


def run_loop(name: str, case: dict, d: pathlib.Path) -> dict:
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import LoopConfig, train_loop

    cfg, tcfg = build(case)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=case["seq"],
                      batch_size=case["batch"])
    loop = LoopConfig(ckpt_dir=str(d / name), log_every=1, **case["loop"])
    writes, logs = [], []
    saved = CheckpointManager._write

    def write(self, host_state, step):
        writes.append(step)
        return saved(self, host_state, step)

    CheckpointManager._write = write
    try:
        state, losses = train_loop(cfg, tcfg, dcfg, loop, log=logs.append,
                                   device="cpu")
        # the loop's final save returns on every rank once rank 0's files
        # are published
        back, step = CheckpointManager(str(d / name)).restore(state)
    finally:
        CheckpointManager._write = saved
    out = {f"{name}/losses": np.asarray(losses),
           f"{name}/writes": np.asarray(writes, dtype=np.int64),
           f"{name}/restored": np.array(step == loop.total_steps
                                        and _equal(back, state)),
           f"{name}/log": np.array("\n".join(logs))}
    out.update(_flat(f"{name}/params", state["params"]))
    return out


def run_case(name: str, case: dict, d: pathlib.Path) -> dict:
    return {"steps": run_steps, "loop": run_loop}[case["kind"]](name, case,
                                                                d)


def main(argv: list) -> None:
    torch.set_num_threads(1)
    rank, world, d = int(argv[0]), int(argv[1]), pathlib.Path(argv[2])
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=world)
    from repro_torch.dist.sharding import axis_rules
    from repro_torch.launch.mesh import make_local_mesh

    try:
        cases = json.loads((d / "cases.json").read_text())
        out = {}
        with axis_rules(make_local_mesh()):
            for name, case in cases.items():
                out.update(run_case(name, case, d))
        np.savez(d / f"rank{rank}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
