"""Fail-stop mitigation tour (counterpart of ``examples/failstop_demo.py``):
all three recovery families (the paper's entanglement, checksum-ABFT,
modular redundancy) across the LSB op classes, with the overhead of each,
SDC detection and entangled storage recovery.

    PYTHONPATH=src python -m repro_torch.examples.failstop_demo [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import FTConfig, entangle, make_plan, run_protected
from repro_torch.core import sdc
from repro_torch.data.pipeline import TokenShardStore

M = 4


def _ints(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(1)
    c = _ints(rng.integers(-50, 50, size=(M, 1 << 16)), dev)
    ops = [
        ("scale", 9),
        ("add", -3),
        ("conv", _ints(rng.integers(-10, 10, (33,)), dev)),
        ("dot", _ints(rng.integers(-4, 4, (1 << 16,)), dev)),
        ("permute", torch.from_numpy(rng.permutation(1 << 16)).to(dev)),
    ]

    print(f"{'op':10s} {'family':10s} {'recovered':9s} {'extra cores':11s}")
    for opname, g in ops:
        truth, _ = run_protected(opname, c, g, FTConfig(mode="none", M=M))
        for mode, extra in (("entangle", 0), ("checksum", 1), ("mr", M)):
            failed = int(rng.integers(0, M))
            out, _ = run_protected(opname, c, g, FTConfig(mode=mode, M=M),
                                   failed=failed)
            ok = torch.equal(out, truth)
            print(f"{opname:10s} {mode:10s} {str(ok):9s} {extra:11d}")
            assert ok

    # --- timing: protection overhead on a big conv (paper Fig. 2 shape) ----
    big = _ints(rng.integers(-30, 30, size=(M, 200_000)), dev)
    g = _ints(rng.integers(-4, 4, (1000,)), dev)

    def timed(mode):
        cfg = FTConfig(mode=mode, M=M)
        run_protected("conv", big, g, cfg)  # warm-up (and kernel build)
        _sync(dev)
        t0 = time.perf_counter()
        run_protected("conv", big, g, cfg)
        _sync(dev)
        return time.perf_counter() - t0

    t_none = timed("none")
    for mode in ("entangle", "checksum"):
        t = timed(mode)
        print(f"[overhead] {mode:9s}: +{(t / t_none - 1) * 100:5.1f}% vs "
              f"failure-intolerant ({t_none * 1e3:.0f} ms)")

    # --- SDC detection (paper Remark 4) -------------------------------------
    plan = make_plan(M, 32)
    corrupted = entangle(c[:, :1024], plan).clone()
    corrupted[2, 100] += 123456789
    mask = sdc.detect(corrupted, plan).cpu().numpy()
    blame = sdc.localize(corrupted, plan).cpu().numpy()
    print(f"[sdc] silent corruption detected at position "
          f"{mask.nonzero()[0]}, blamed stream {blame[100]} (truth: 2)")

    # --- entangled storage: lose a shard file, keep the data ---------------
    with tempfile.TemporaryDirectory() as d:
        store = TokenShardStore(d, M=M)
        toks = rng.integers(0, 65000, size=(4, 4096)).astype(np.int32)
        paths = store.write_group("corpus", toks)
        paths[3].unlink()  # disk failure
        assert np.array_equal(store.read_group("corpus"), toks)
        print("[storage] token shard group survived a lost file "
              "(entangled at-rest, op=identity)")


if __name__ == "__main__":
    main()
