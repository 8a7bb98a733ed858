"""Serving example (counterpart of ``examples/serve_lm.py``): the batched
continuous-batching engine against the per-slot baseline, the entangled
int8 logits projection protecting M=4 request groups on every decode step
(one fused GEMM per engine step, slot -> group = slot % M), the library
form of that projection, and a deadline-straggler drill with the host-side
:class:`~repro_torch.train.straggler.DeadlineExecutor`.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.ft.heads import ft_logits, quantize_head
from repro_torch.models import get_model
from repro_torch.serve import PerSlotEngine, Request, ServeConfig, ServeEngine
from repro_torch.train.straggler import DeadlineExecutor

rng = np.random.default_rng(0)

PROMPTS = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(8)]


def _serve_wave(eng, failed_group=None):
    for r, p in enumerate(PROMPTS):
        eng.submit(Request(rid=r, prompt=p.copy(), max_new=8))
    if failed_group is None:
        done = eng.run_to_completion()
    else:
        done = eng.run_to_completion(failed_group=failed_group)
    return {r.rid: np.asarray(r.out) for r in done}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("llama3.2-1b")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        max_seq=128, device=dev)

    # --- 1) batched vs per-slot serving -------------------------------------
    scfg = ServeConfig(max_batch=4, max_seq=128)
    t0 = time.monotonic()
    ref = _serve_wave(PerSlotEngine(cfg, scfg, params, device=dev))
    t_ref = time.monotonic() - t0
    eng = ServeEngine(cfg, scfg, params, device=dev)
    t0 = time.monotonic()
    out = _serve_wave(eng)
    t_bat = time.monotonic() - t0
    assert all(np.array_equal(ref[r], out[r]) for r in ref)
    print(f"[serve_lm] 8 requests: per-slot {t_ref:.2f}s vs batched "
          f"{t_bat:.2f}s ({eng.decode_calls} decode calls); outputs "
          f"bit-identical; sample: {out[0][:6].tolist()}")

    # --- 2) entangled head on the hot path: fail-stop roll-forward ----------
    ft_cfg = ServeConfig(max_batch=4, max_seq=128, ft_mode="entangle",
                         ft_M=4)
    healthy = _serve_wave(ServeEngine(cfg, ft_cfg, params, device=dev))
    for fg in range(4):
        injected = _serve_wave(ServeEngine(cfg, ft_cfg, params, device=dev),
                               failed_group=fg)
        assert all(np.array_equal(healthy[r], injected[r]) for r in healthy)
    print("[serve_lm] entangled int8 head on every decode step: tokens "
          "bit-identical under a fail-stop in any of the 4 request groups")

    # --- 3) the standalone fused projection (library form) ------------------
    B, D = 8, cfg.d_model
    h = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
    head = torch.from_numpy(
        rng.normal(size=(D, cfg.vocab_size)).astype(np.float32) * 0.02).to(dev)
    hq, ws = quantize_head(head)
    base = ft_logits(h, hq, ws, M=4)
    for fg in range(4):
        assert torch.equal(ft_logits(h, hq, ws, M=4, failed_group=fg), base)
    agree = (torch.argmax(base, -1) == torch.argmax(h @ head, -1)).to(
        torch.float32).mean().item()
    print(f"[serve_lm] standalone ft_logits: exact under any single-group "
          f"fail-stop; argmax agreement with f32 head: {agree:.2f}")

    # --- 4) straggler-as-fail-stop drill -------------------------------------
    def group_work(delay):
        def fn():
            time.sleep(delay)
            return "logits"
        return fn

    ex = DeadlineExecutor(deadline_s=0.25)
    results = ex.run([group_work(0.01), group_work(0.02),
                      group_work(5.0), group_work(0.015)])  # group 2 hangs
    failed = DeadlineExecutor.failed_index(results)
    print(f"[serve_lm] deadline drill: group {failed} missed the deadline -> "
          f"rolled forward via the entangled head (as in 2); no request "
          f"waited for the straggler")
    assert failed == 2


if __name__ == "__main__":
    main()
