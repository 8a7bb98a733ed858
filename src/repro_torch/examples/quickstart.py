"""Quickstart: the paper's mechanism in a few lines (counterpart of
``examples/quickstart.py``).

Entangles M=3 integer streams, runs the paper's experimental op (integer
convolution) directly on the entangled streams, kills one stream, and
recovers every result exactly from the survivors — no recomputation.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (FTConfig, disentangle, entangle, get_op,
                              make_plan, run_protected)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    dev = resolve_device(ap.parse_args(argv).device)
    # exact integer convolution of every stream [M, N] with g [K]
    conv = get_op("conv").apply
    rng = np.random.default_rng(0)

    # --- plan: M=3 streams, 32-bit integers (paper Table I row 1) ---------
    plan = make_plan(M=3, w=32)
    print(f"plan: M={plan.M} l={plan.l} k={plan.k} output budget "
          f"±{plan.max_output_magnitude} ({plan.output_bits} bits)")

    # --- three integer streams + an integer convolution kernel ------------
    c = torch.from_numpy(rng.integers(-100, 100, size=(3, 4096))
                         .astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.integers(-20, 20, size=(64,))
                         .astype(np.int32)).to(dev)

    # --- entangle (eq. 6): in place, no extra streams ---------------------
    eps = entangle(c, plan)
    print(f"entangled {tuple(c.shape)} -> {tuple(eps.shape)} (same storage,"
          f" +{plan.l}-bit shift) on {dev}")

    # --- the op runs directly on entangled data ---------------------------
    delta = conv(eps, g)

    # --- fail-stop: core 1 never returns; recover from the other two ------
    survivors_only = delta.clone()
    survivors_only[1] = -12345678  # poison the lost stream
    recovered = disentangle(survivors_only, plan, failed=1)

    truth = conv(c, g)
    assert torch.equal(recovered, truth)
    print("fail-stop on stream 1: all 3 outputs recovered EXACTLY from 2 "
          "streams")

    # --- one-liner engine with the checksum-ABFT baseline -----------------
    for mode in ("entangle", "checksum", "mr"):
        out, _ = run_protected("conv", c, g, FTConfig(mode=mode, M=3),
                               failed=0)
        ok = torch.equal(out, truth)
        extra = {"entangle": "0 extra cores", "checksum": "1 extra core",
                 "mr": "M extra cores"}[mode]
        print(f"  {mode:9s}: recovered={ok}  cost: {extra}")
        assert ok, mode


if __name__ == "__main__":
    main()
