"""Make the H100 seed cache of the kernels' launch parameters,
``src/repro_torch/kernels/pretuned/cuda_sm90.json``.

Not part of ``chip_smoke.py``: run it when a kernel's launch parameters,
its candidates (``repro_torch/kernels/autotune.py``) or the serving
configuration of ``chip_smoke.py`` change. It builds the GEMM sources,
points the autotune cache at an empty file (and reads no shipped seed),
and starts ``ServeEngine`` with ``blocks="auto"`` on chip_smoke.py's
serving configuration (``SERVE``: 8 slots, M = 4, max_seq 256, whole-bucket
admission): llama3.2-1b at scopes head and all, and deepseek-v2-lite-16b
(cut to chip_smoke.py's ``DEEPSEEK_LAYERS``; the census does not depend on
depth) at moe and all. Each engine's ``warm_autotune`` sweeps every protected GEMM
shape of its census. The winners go to the output file with a ``_meta``
entry (the card's name and power limit from ``nvidia-smi``, the torch and
CUDA versions), and every sweep's rule and winner times are logged
(``[autotune-seed]`` lines).

From the root of a checkout, on a machine with a CUDA device:

    python3 chip_autotune_seed.py [OUT]   # default artifacts/cuda_sm90.json

then copy OUT over ``src/repro_torch/kernels/pretuned/cuda_sm90.json``.
The last line is one JSON object: every sweep's times by key. Exits
nonzero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (DEEPSEEK, LLAMA, SERVE, free_cuda,  # noqa: E402
                        init_model, kernel_table, log, nvidia_smi,
                        phase_build)

# (arch, scopes) whose startup census the seed covers
SEEDED = ((LLAMA, ("head", "all")), (DEEPSEEK, ("moe", "all")))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_autotune_seed: no CUDA device available", file=sys.stderr)
        return 2
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else ROOT / "artifacts" / "cuda_sm90.json")
    from repro_torch.kernels import autotune as at
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    log(f"[autotune-seed] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    phase_build([k for k in kernel_table()
                 if k["name"].startswith("entangled_matmul")])
    tmp = tempfile.mkdtemp(prefix="autotune-seed-")
    os.environ[at.ENV] = os.path.join(tmp, "autotune.json")
    cache = at.AutotuneCache(os.environ[at.ENV], seeds=False)
    at._cache = cache
    for arch, scopes in SEEDED:
        cfg, _, params = init_model(dev, arch)
        for scope in scopes:
            t0 = time.perf_counter()
            n0 = cache.sweeps
            eng = ServeEngine(cfg, ServeConfig(
                max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                ft_mode="entangle", ft_M=SERVE["ft_M"], ft_scope=scope,
                blocks="auto"), params, device=dev)
            log(f"[autotune-seed] {arch} scope={scope}: "
                f"{cache.sweeps - n0} shapes swept "
                f"({len(eng.protected_census)} census sites and the head), "
                f"startup {time.perf_counter() - t0:.1f} s ({smi})")
            del eng
            free_cuda()
        del params
        free_cuda()
    for key, times in sorted(cache.reports.items()):
        rule_b, rule_ms = times[0]
        won_b, won_ms = min(times, key=lambda ct: ct[1])
        log(f"[autotune-seed] {key}: rule {rule_b} {rule_ms:.4f} ms, winner "
            f"{won_b} {won_ms:.4f} ms ({rule_ms / won_ms:.2f}x; CUDA-graph "
            f"times, {len(times)} candidates; {smi})")
    entries = {k: v for k, v in cache._mem.items() if "|cuda_sm90|" in k}
    payload = {"_meta": {
        "version": 1, "backend": "cuda_sm90", "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "note": "made by chip_autotune_seed.py: ServeEngine.warm_autotune "
                "on an empty cache over chip_smoke.py's serving "
                "configuration (llama3.2-1b at scopes head and all, "
                "deepseek-v2-lite-16b at moe and all)"}, **entries}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    log(f"[autotune-seed] {len(entries)} winners -> {out}")
    print(json.dumps({k: [[c, ms] for c, ms in v]
                      for k, v in cache.reports.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
