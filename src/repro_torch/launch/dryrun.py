"""Dry run of every (arch x shape cell) on the production meshes (port of
:mod:`repro.launch.dryrun`), on the ``meta`` device.

Each cell's step (the train step, a prefill, or a decode step) runs once
on meta tensors from :mod:`.input_specs` under :mod:`.op_cost`, which
proves that the port builds and runs it at the cell's shape, and
records:

  * status, the error and a traceback on failure, and seconds;
  * the step's global FLOPs, integer kernel operations and bytes (op_cost:
    the bytes are the unfused upper bound);
  * per-device argument bytes (params, optimizer state, batch, cache)
    under :mod:`repro_torch.dist.params`'s placement rules on
    :func:`repro_torch.launch.mesh.production_mesh_shape`'s mesh. That
    mesh is a shape only: no process group is made, nothing is placed.

What the meta device cannot give is recorded as absent (None), not
guessed: XLA's temporary bytes and compile seconds have no counterpart in
eager PyTorch, and the sharded program's collectives are not run. One
JSON per cell goes to ``artifacts/dryrun_torch/`` (``--variant opt``:
``artifacts/dryrun_torch_opt/``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single           # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --variant opt
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell, cells_for
from repro_torch.dist import params as dparams
from repro_torch.dist.sharding import mesh_shape
from repro_torch.launch import input_specs as ispecs
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.api import get_model
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import leaves

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts"

# --variant opt: the reference's optimized configuration
_OPT_GRAD_ACCUM = {"deepseek-v3-671b": 8, "granite-20b": 4}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape alone (what the placement rules read); no devices,
    no process group."""

    shape: dict


def mesh_for(multi_pod: bool) -> tuple:
    """(name, :class:`MeshShape`) of a production mesh."""
    dims, axes = production_mesh_shape(multi_pod=multi_pod)
    name = ("multipod_" if multi_pod else "pod_") + "x".join(map(str, dims))
    return name, MeshShape(dict(zip(axes, dims)))


def _train_cfg_for(cfg: ModelConfig) -> TrainConfig:
    # bf16 Adam moments for the very large models, as in the reference
    big = cfg.name.startswith("deepseek-v3") or cfg.name.startswith("granite")
    return TrainConfig(
        adamw=AdamWConfig(state_dtype="bfloat16" if big else None),
        max_seq=4096)


def _apply_variant(cfg: ModelConfig, tcfg, cell, variant: str):
    if variant == "opt":
        cfg = dataclasses.replace(cfg, norm_f32=False, loss_impl="streamed",
                                  mla_absorb=True)
        if tcfg is not None and cell.kind == "train":
            tcfg = dataclasses.replace(
                tcfg, grad_accum=_OPT_GRAD_ACCUM.get(cfg.name, 1))
    return cfg, tcfg


def build(cfg: ModelConfig, cell: ShapeCell, mesh, variant: str = "baseline"):
    """``(fn, args, arg_groups, cfg_used)``: the cell's step, its meta
    arguments, and those arguments grouped as params / opt / batch / cache
    with their placements on ``mesh`` (anything with a ``shape`` dict)
    for the per-device bytes."""
    model = get_model(cfg)
    specs = ispecs.input_specs(cfg, cell)
    if cell.kind == "train":
        tcfg = _train_cfg_for(cfg)
        cfg_t = dataclasses.replace(cfg, remat="full")
        cfg_t, tcfg = _apply_variant(cfg_t, tcfg, cell, variant)
        p = ispecs.params_specs(cfg_t, max_seq=cell.seq_len)
        state = {"params": p, "opt": adamw_mod.init(p, tcfg.adamw),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=ispecs.META)}
        groups = {
            "params": (p, dparams.param_shardings(cfg_t, mesh, p)),
            "opt": (state["opt"], dparams.param_shardings(cfg_t, mesh,
                                                          state["opt"])),
            "batch": (specs["batch"],
                      dparams.batch_shardings(mesh, specs["batch"]))}
        return (make_train_step(cfg_t, tcfg), (state, specs["batch"]),
                groups, cfg_t)
    cfg, _ = _apply_variant(cfg, None, cell, variant)
    p = ispecs.params_specs(cfg, max_seq=cell.seq_len)
    groups = {"params": (p, dparams.param_shardings(cfg, mesh, p)),
              "cache": (specs["cache"], dparams.cache_shardings(
                  cfg, mesh, specs["cache"]))}
    if cell.kind == "prefill":
        groups["batch"] = (specs["batch"],
                           dparams.batch_shardings(mesh, specs["batch"]))

        def fn(params, batch, cache):
            return model.prefill(params, batch, cfg, cache)

        return fn, (p, specs["batch"], specs["cache"]), groups, cfg
    groups["batch"] = ({"tok": specs["tok"], "pos": specs["pos"]},
                       dparams.batch_shardings(
                           mesh, {"tok": specs["tok"], "pos": specs["pos"]}))

    def fn(params, tok, cache, pos):
        return model.decode_step(params, tok, cache, pos, cfg)

    return fn, (p, specs["tok"], specs["cache"], specs["pos"]), groups, cfg


def per_device_bytes(tree, shardings) -> int:
    """Bytes of ``tree`` held by one device: each leaf's bytes over the
    extent of the mesh axes its placement shards it on."""
    total = 0
    for t, sh in zip(leaves(tree), leaves(shardings)):
        ms = mesh_shape(sh.mesh)
        ext = 1
        for entry in sh.spec:
            for axis in (() if entry is None else
                         entry if isinstance(entry, tuple) else (entry,)):
                ext *= ms[axis]
        total += t.numel() * t.element_size() // ext
    return total


def run_cell(arch: str, cell: ShapeCell, multi_pod: bool,
             out_dir: pathlib.Path, variant: str = "baseline") -> dict:
    mesh_name, mesh = mesh_for(multi_pod)
    tag = f"{arch}__{cell.name}__{mesh_name}"
    rec: dict = {"arch": arch, "cell": cell.name, "mesh": mesh_name,
                 "devices": math.prod(mesh.shape.values()),
                 "seq_len": cell.seq_len, "global_batch": cell.global_batch,
                 "kind": cell.kind, "variant": variant,
                 # no counterpart on the meta device (see the docstring)
                 "temp_bytes_per_device": None, "compile_s": None,
                 "collective_bytes": None}
    t0 = time.monotonic()
    try:
        fn, args, groups, _ = build(get_config(arch), cell, mesh, variant)
        rec["arg_bytes_per_device"] = {
            k: per_device_bytes(tree, sh) for k, (tree, sh) in groups.items()}
        rec["arg_bytes_per_device"]["total"] = sum(
            rec["arg_bytes_per_device"].values())
        t1 = time.monotonic()
        _, cost = op_cost.count(fn, *args)
        rec["run_s"] = round(time.monotonic() - t1, 1)
        rec["cost"] = {k: v for k, v in cost.as_dict().items()
                       if not k.startswith("collective")}
        rec["ok"] = True
    except Exception as e:  # recorded: a failing cell is a fault to fix
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.monotonic() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    status = "OK" if rec["ok"] else f"FAIL ({rec['error'][:120]})"
    print(f"[dryrun] {tag}: {status} ({rec['total_s']}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"])
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out or ART_DIR / (
        "dryrun_torch" if args.variant == "baseline" else "dryrun_torch_opt"))
    n_ok = n_fail = 0
    for arch in archs:
        for cell in cells_for(get_config(arch)):
            if args.cell != "all" and cell.name not in args.cell.split(","):
                continue
            for mp in meshes:
                tag = f"{arch}__{cell.name}__{mesh_for(mp)[0]}"
                prev = out_dir / f"{tag}.json"
                if (args.skip_existing and prev.exists()
                        and json.loads(prev.read_text()).get("ok")):
                    print(f"[dryrun] {tag}: cached OK")
                    n_ok += 1
                    continue
                rec = run_cell(arch, cell, mp, out_dir, variant=args.variant)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
