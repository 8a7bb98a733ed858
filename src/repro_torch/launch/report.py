"""The dry-run and roofline tables from the port's artifacts (port of
:mod:`repro.launch.report`): ``artifacts/dryrun_torch/`` (baseline) and
``artifacts/dryrun_torch_opt/`` (``--variant opt``), as markdown.

  PYTHONPATH=src python -m repro_torch.launch.report --what dryrun
  PYTHONPATH=src python -m repro_torch.launch.report --what roofline
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.roofline import ART, analyze_cell


def rows_for(dirname: str, mesh: str) -> dict:
    rows = {}
    for jp in sorted((ART / dirname).glob(f"*__{mesh}.json")):
        r = analyze_cell(jp)
        if r:
            rows[(r["arch"], r["cell"])] = r
    return rows


def _gb(x) -> str:
    return "absent" if x is None else f"{x / 1e9:.2f}"


def dryrun_table(dirname: str) -> str:
    """One row per dry-run record; a failed cell shows its error in place
    of the counts."""
    lines = [
        "| arch | cell | mesh | status | run s | args GB/dev | temp GB/dev "
        "| TFLOPs (global) | GB moved (global, unfused) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for jp in sorted((ART / dirname).glob("*.json")):
        rec = json.loads(jp.read_text())
        cost = rec.get("cost")
        args = (rec.get("arg_bytes_per_device") or {}).get("total")
        if cost:
            counts = (f"{cost['flops'] / 1e12:.1f} | "
                      f"{_gb(cost['bytes'] + cost['kernel_bytes'])}")
        else:
            counts = f"{rec.get('error', '')[:80]} |"
        lines.append(
            f"| {rec['arch']} | {rec['cell']} | {rec['mesh']} | "
            f"{'OK' if rec.get('ok') else 'FAIL'} | {rec.get('run_s', '')} | "
            f"{_gb(args)} | {_gb(rec.get('temp_bytes_per_device'))} | "
            f"{counts} |")
    return "\n".join(lines)


def roofline_table(base_dir: str, opt_dir: str, mesh: str) -> str:
    base, opt = rows_for(base_dir, mesh), rows_for(opt_dir, mesh)
    lines = [
        "| arch | cell | bound | base C/M (s) | opt C/M (s) | dominant Δ | "
        "useful base→opt |",
        "|---|---|---|---|---|---|---|",
    ]

    def fmt(r):
        return f"{r['compute_s']:.2g}/{r['memory_s']:.2g}"

    for key in sorted(base):
        b, o = base[key], opt.get(key)
        dom_b = max(b["compute_s"], b["memory_s"])
        if o:
            dom_o = max(o["compute_s"], o["memory_s"])
            delta = f"{dom_b / dom_o:.2f}x" if dom_o else "-"
            useful = f"{b['useful_frac']:.2f}→{o['useful_frac']:.2f}"
            ofmt = fmt(o)
        else:
            delta, useful, ofmt = "-", f"{b['useful_frac']:.2f}", "-"
        lines.append(f"| {key[0]} | {key[1]} | {b['bound']} | {fmt(b)} | "
                     f"{ofmt} | {delta} | {useful} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--base", default="dryrun_torch")
    ap.add_argument("--opt", default="dryrun_torch_opt")
    ap.add_argument("--mesh", default="pod_16x16")
    a = ap.parse_args(argv)
    if a.what == "roofline":
        print(roofline_table(a.base, a.opt, a.mesh))
    else:
        print(dryrun_table(a.base))


if __name__ == "__main__":
    main()
