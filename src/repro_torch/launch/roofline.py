"""Roofline analysis over the port's dry-run records (port of
:mod:`repro.launch.roofline`), at one NVIDIA H100's published dense peaks.

Per (arch x shape cell) and mesh, from :mod:`.dryrun`'s records (the
step's global counts by :mod:`.op_cost`, divided evenly over the mesh's
devices, as a balanced SPMD program would be):

  compute_s    = flops / PEAK_BF16 + int_ops / PEAK_INT8  per device
  memory_s     = (bytes + kernel_bytes) / HBM_BW           per device
  collective_s = collective bytes / LINK_BW                per device

The bytes are op_cost's unfused upper bound. The dry run makes no process
group, so the sharded program's collectives are not counted: its
collective term is recorded as absent (None), not guessed. Also reported:
MODEL_FLOPS = 6 N D (train) or 2 N D (inference), N the active non-embedding
params (MoE: the routed experts' top-k share), and the useful-compute
share MODEL_FLOPS / the step's FLOPs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re

from repro_torch.configs import get_config
from repro_torch.launch import input_specs as ispecs

# one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12  # FLOP/s
PEAK_INT8 = 1979e12  # OP/s
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # NVLink, bytes/s each way

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


def _paths(node, prefix: str = ""):
    """(path, leaf) pairs of a params tree, paths written as the
    reference's ``keystr``: ``['stack'][0]['wq']['w']``."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, f"{prefix}['{k}']")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, node


def param_counts(arch: str, max_seq: int = 4096) -> dict:
    """Exact parameter counts from the meta-device params (no
    allocation): total, embedding (``tok`` / ``head`` / ``pos``), routed
    experts, active (MoE: the routed experts' top-k share) and the
    non-embedding ones."""
    cfg = get_config(arch)
    total = emb = expert = 0
    for path, leaf in _paths(ispecs.params_specs(cfg, max_seq=max_seq)):
        n = leaf.numel()
        total += n
        if re.search(r"'tok'|'head'|'pos'", path):
            emb += n
        if re.search(r"we_gate|we_up|we_down", path):
            expert += n
    active = total
    if cfg.moe:
        active = total - expert + expert * cfg.moe.top_k / cfg.moe.n_experts
    return {"total": total, "embedding": emb, "expert": expert,
            "active": active, "nonemb": total - emb,
            "active_nonemb": active - emb}


def model_flops(arch: str, cell: dict, counts: dict) -> float:
    tokens = cell["global_batch"] * (cell["seq_len"]
                                     if cell["kind"] != "decode" else 1)
    mult = 6.0 if cell["kind"] == "train" else 2.0
    return mult * counts["active_nonemb"] * tokens


def analyze_cell(json_path: pathlib.Path) -> dict | None:
    """The roofline row of one dry-run record, or None for a failed
    cell."""
    rec = json.loads(pathlib.Path(json_path).read_text())
    if not rec.get("ok"):
        return None
    cost, chips = rec["cost"], rec["devices"]
    counts = param_counts(rec["arch"], max_seq=min(rec["seq_len"], 4096))
    mf = model_flops(rec["arch"], rec, counts)
    per = {k: cost[k] / chips for k in
           ("flops", "int_ops", "bytes", "kernel_bytes")}
    compute_s = per["flops"] / PEAK_BF16 + per["int_ops"] / PEAK_INT8
    memory_s = (per["bytes"] + per["kernel_bytes"]) / HBM_BW
    coll = rec.get("collective_bytes")
    coll_s = None if coll is None else coll / chips / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s}
    if coll_s is not None:
        terms["collective"] = coll_s
    return {
        "arch": rec["arch"], "cell": rec["cell"], "mesh": rec["mesh"],
        "kind": rec["kind"], "chips": chips, "variant": rec.get("variant"),
        "flops_per_device": per["flops"],
        "int_ops_per_device": per["int_ops"],
        "bytes_per_device": per["bytes"] + per["kernel_bytes"],
        "collective_bytes_per_device": (None if coll is None
                                        else coll / chips),
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "bound": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_frac": mf / cost["flops"] if cost["flops"] else 0.0,
        "params_total": counts["total"], "params_active": counts["active"],
        "arg_bytes_per_device": rec["arg_bytes_per_device"]["total"],
    }


_ADVICE = {
    "compute": "compute-bound: raise tensor-core utilization (fuse small "
               "ops, larger tiles) or cut redundant FLOPs",
    "memory": "memory-bound: fewer bytes per step (fusion, lower-precision "
              "states, int8 weights)",
    "collective": "collective-bound: reshard to cut cross-device traffic",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="pod_16x16")
    ap.add_argument("--dryrun-dir", default=str(ART / "dryrun_torch"))
    ap.add_argument("--out", default=str(ART / "roofline_torch"))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for jp in sorted(pathlib.Path(args.dryrun_dir).glob(
            f"*__{args.mesh}.json")):
        row = analyze_cell(jp)
        if row:
            rows.append(row)
            print(f"{row['arch']:22s} {row['cell']:12s} "
                  f"C={row['compute_s']:.2e}s M={row['memory_s']:.2e}s "
                  f"X={row['collective_s']} -> {row['bound']:10s} "
                  f"useful={row['useful_frac']:.2f}")
    (out_dir / "roofline.json").write_text(json.dumps(rows, indent=1))
    lines = [
        "| arch | cell | compute s | memory s | collective s | bound | "
        "MODEL_FLOPs | useful frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        coll = ("absent" if r["collective_s"] is None
                else f"{r['collective_s']:.2e}")
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {coll} | {r['bound']} | "
            f"{r['model_flops']:.2e} | {r['useful_frac']:.3f} | "
            f"{_ADVICE[r['bound']].split(':')[0]} |")
    (out_dir / "roofline.md").write_text("\n".join(lines) + "\n")
    print(f"[roofline] {len(rows)} cells -> {out_dir}")


if __name__ == "__main__":
    main()
