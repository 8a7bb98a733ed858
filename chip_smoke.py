#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its results on lines of its own; any failed check
raises and the script exits nonzero:

  1. build   — compile every CUDA kernel of the serving path from the
               checkout's sources (one ``nvcc`` per source, all started
               together), report the build seconds and the card's
               ``nvidia-smi`` name and power limit;
  2. kernels — hold each kernel bit for bit against its plain PyTorch
               version on the card: every shape the full-width llama3.2-1b
               engine can send it (the vocab head plus the engine's own
               startup census of protected sites, decode and every prefill
               bucket) and ragged small ones, all ``fuse_epilogue`` modes,
               packed and unpacked weights, every failed stream, int32 and
               dual-word plans; plus the poison check (the fused kernel with
               ``failed=r`` equals the plain disentangle of the unfused
               kernel's output with stream r overwritten by GARBAGE);
  3. serve   — the port's ``ServeEngine`` serving llama3.2-1b at its
               published width (random weights from a seeded
               ``torch.Generator``): per ``ft_scope`` in (head, all), a
               healthy wave and a wave with ``failed_group=1`` must give
               equal tokens (EXACT ROLL-FORWARD); the kernels' launch counts
               are set to 0 just before the waves and read just after;
  4. timings — each kernel, its plain version and its bound at the
               main-path shapes: device time from a profiler trace after
               warm-up.

The line before the last is one JSON object with a record per kernel;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout of the repository, the script exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks used for the bounds: HBM3 at 3.35 TB/s (NVIDIA data
# sheet); int32 multiply-adds run on the CUDA cores at 64 lanes per SM per
# clock (Hopper architecture white paper) at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
L2_BYTES = 50 * 2**20

ARCH = "llama3.2-1b"
SERVE = dict(max_batch=8, ft_M=4, max_seq=256, requests=8, prompt_len=8,
             max_new=8)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ build --

def phase_build(kernels):
    """Build every kernel library at once, one nvcc per source."""
    import concurrent.futures as cf

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(kernels)) as ex:
        futs = {k["name"]: ex.submit(k["module"].build, True) for k in kernels}
        built = {name: f.result() for name, f in futs.items()}
    wall = time.perf_counter() - t0
    for name, (so, secs, text) in built.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: nvcc {secs:.1f} s -> {so.name}")
        for ln in regs[:6]:
            log(f"[build]   {ln}")
        if len(regs) > 6:
            log(f"[build]   ... {len(regs) - 6} more ptxas lines")
    log(f"[build] all kernels built in {wall:.1f} s wall")
    return wall


# ---------------------------------------------------------------- kernels --

def _rand(gen, lo, hi, shape, dev):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)


def phase_kernels(dev, shapes):
    """Kernel == plain version, bit for bit, plus the poison check, on
    ragged small shapes and on the main path's ``shapes`` (a list of
    ``(B, K, N, site)``). Returns the largest |kernel - plain| seen (0
    when all agree)."""
    import torch

    from repro_torch.core.entangle import disentangle
    from repro_torch.core.failstop import GARBAGE
    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels.codec import pack_int8

    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = 0
    n_cmp = 0

    def compare(c, g, plan, mode, r, packed, what):
        nonlocal worst, n_cmp
        k = emm.entangled_matmul_cuda(c, g, plan, fuse_epilogue=mode,
                                      failed=r, packed=packed)
        p = emm.entangled_matmul_plain(c, g, plan, fuse_epilogue=mode,
                                       failed=r, packed=packed)
        torch.cuda.synchronize()
        err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
        worst = max(worst, err)
        n_cmp += 1
        if err:
            raise AssertionError(
                f"kernel != plain for {what} mode={mode!r} failed={r} "
                f"packed={packed}: max |diff| {err}")
        return k

    def poison(c, g, plan, packed, what):
        delta = emm.entangled_matmul_cuda(c, g, plan, fuse_epilogue=False,
                                          packed=packed)
        for r in range(plan.M):
            fused = emm.entangled_matmul_cuda(c, g, plan, fuse_epilogue=True,
                                              failed=r, packed=packed)
            bad = delta.clone()
            bad[r] = GARBAGE
            ref = disentangle(bad, plan, failed=r)
            torch.cuda.synchronize()
            if not torch.equal(fused, ref):
                raise AssertionError(f"poison check failed for {what}, r={r}")

    # ragged small shapes, every plan / mode / packing / failed stream;
    # values over the whole int32 range (the GEMM is exact mod 2**32)
    plans = [make_plan(3, 16), make_plan(4, 16)] + [
        make_plan(M, 32) for M in range(3, 9)]
    small = [(6, 13, 9), (1, 1, 1), (17, 70, 300), (3, 2049, 257)]
    for plan in plans:
        for (B, K, N) in small:
            c = _rand(gen, -2**31, 2**31, (plan.M, B, K), dev)
            g32 = _rand(gen, -2**31, 2**31, (K, N), dev)
            g8 = _rand(gen, -128, 128, (K, N), dev)
            gp = pack_int8(g8, axis=0).contiguous()
            what = f"plan(M={plan.M},l={plan.l},{plan.temp}) B={B} K={K} N={N}"
            for packed, g in ((False, g32), (True, gp)):
                for mode in (False, "chain"):
                    compare(c, g, plan, mode, None, packed, what)
                for mode in (True, "chain_final"):
                    for r in [None] + list(range(plan.M)):
                        compare(c, g, plan, mode, r, packed, what)
            poison(c, gp, plan, True, what)
    log(f"[kernels] ragged shapes: {n_cmp} kernel-vs-plain comparisons "
        f"bit-identical; poison check passed")

    # the full-width main-path shapes: activations on the eq.-13 budget
    # grid, int8 weights packed 4 per word (what the serving path sends)
    plan = make_plan(SERVE["ft_M"], 32)
    before = n_cmp
    for (B, K, N, site) in shapes:
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (plan.M, B, K), dev)
        gp = pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0).contiguous()
        what = f"{site} [{plan.M},{B},{K}]x[{K // 4},{N}]"
        for mode in (False, "chain"):
            compare(c, gp, plan, mode, None, True, what)
        for mode in (True, "chain_final"):
            for r in [None] + list(range(plan.M)):
                compare(c, gp, plan, mode, r, True, what)
        poison(c, gp, plan, True, what)
        del c, gp
        torch.cuda.empty_cache()
    log(f"[kernels] full-width shapes: {len(shapes)} main-path shapes, "
        f"{n_cmp - before} comparisons bit-identical; poison check passed")
    return worst


# ------------------------------------------------------------------ serve --

def init_model(dev):
    """The published llama3.2-1b config with random weights from a seeded
    ``torch.Generator``; returns (cfg, model, params)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(ARCH)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        max_seq=SERVE["max_seq"], device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {ARCH} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; random init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def main_path_shapes(cfg, params, dev):
    """Every entangled-GEMM shape the serving engine can launch, as
    ``(B, K, N, sites)``: the vocab head (decode and admission both send
    max_batch / M rows per group) and the engine's own startup census of
    the in-model sites at ft_scope 'all' (the decode step and one
    whole-bucket prefill per bucket)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, ServeConfig(
        max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
        ft_mode="entangle", ft_M=SERVE["ft_M"], ft_scope="all"), params,
        device=dev)
    by_shape = {(SERVE["max_batch"] // SERVE["ft_M"], cfg.d_model,
                 cfg.vocab_size): ["head"]}
    for site, (_, Bg, K, N) in sorted(eng.protected_census):
        by_shape.setdefault((Bg, K, N), []).append(site)
    del eng
    return [(B, K, N, "/".join(sites)) for (B, K, N), sites in
            sorted(by_shape.items())]


def _wave_submit(eng, cfg):
    """Submit the seeded 8-request wave; returns the requests."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    reqs = [Request(rid=r, prompt=rng.integers(
        0, cfg.vocab_size, size=SERVE["prompt_len"]).astype(np.int32),
        max_new=SERVE["max_new"]) for r in range(SERVE["requests"])]
    for rq in reqs:
        eng.submit(rq)
    return reqs


def _wave(eng, cfg, failed_group, kernels):
    """Serve the 8-request wave; returns (tokens by rid, step seconds,
    kernel launches per step)."""
    import numpy as np
    import torch

    reqs = _wave_submit(eng, cfg)
    steps, launched = [], []
    while not eng.idle():
        before = sum(k["module"].launches for k in kernels)
        t0 = time.perf_counter()
        eng.step(failed_group=failed_group)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        launched.append(sum(k["module"].launches for k in kernels) - before)
        if len(steps) > 10 * SERVE["max_new"]:
            raise AssertionError("wave failed to drain")
    outs = {r.rid: np.asarray(r.out) for r in reqs}
    for rid, o in outs.items():
        if o.shape != (SERVE["max_new"],) or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: bad output {o}")
    return outs, steps, launched


def phase_serve(dev, kernels, cfg, model, params):
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    # small-input sanity of the float path: finite hidden states of the
    # expected shape from a batched prefill
    cache = model.init_cache(cfg, 2, 16, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev)
    h, _ = model.prefill_chunk(params, toks, cfg, cache, pos0=0,
                               lengths=torch.tensor([8, 5], device=dev))
    if h.shape != (2, 8, cfg.d_model) or not torch.isfinite(h.float()).all():
        raise AssertionError(f"prefill hidden states bad: {h.shape}")
    del cache, h

    base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                ft_mode="entangle", ft_M=SERVE["ft_M"])
    for k in kernels:
        k["module"].launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    results = {}
    t_serve = time.perf_counter()
    for scope in ("head", "all"):
        scfg = ServeConfig(ft_scope=scope, **base)
        eng = ServeEngine(cfg, scfg, params, device=dev)
        healthy, st_h, ln_h = _wave(eng, cfg, None, kernels)
        eng2 = ServeEngine(cfg, scfg, params, device=dev)
        injected, st_i, ln_i = _wave(eng2, cfg, 1, kernels)
        bad = sum(not np.array_equal(healthy[r], injected[r])
                  for r in healthy)
        ntok = sum(len(v) for v in healthy.values())
        verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
        log(f"[serve] recovery summary [scope={scope}]: failed_group=1 "
            f"injected on every step; {len(healthy)} requests / {ntok} "
            f"tokens compared; mismatching requests: {bad} ({verdict})")
        if bad:
            raise AssertionError(f"scope {scope}: {verdict}")
        if eng.plans is not None and (eng.plans.misses or eng2.plans.misses):
            raise AssertionError("compiled plans missed a shape")
        dec = st_h[1:] + st_i[1:]  # steps after the admission step
        wall = sum(st_h) + sum(st_i)
        results[scope] = dict(
            decode_calls=eng.decode_calls + eng2.decode_calls,
            step_ms=1e3 * sum(dec) / len(dec),
            tok_s=2 * ntok / wall,
            first_step_ms=1e3 * (st_h[0] + st_i[0]) / 2,
            launches_per_decode_step=sorted(set(ln_h[1:] + ln_i[1:])),
            launches_first_step=ln_h[0])
        log(f"[serve] scope={scope}: decode_calls {results[scope]['decode_calls']}"
            f", mean decode-step {results[scope]['step_ms']:.3f} ms, "
            f"admission+first step {results[scope]['first_step_ms']:.3f} ms, "
            f"{results[scope]['tok_s']:.1f} tokens/s; kernel launches per "
            f"decode step {results[scope]['launches_per_decode_step']} "
            f"(admission step {results[scope]['launches_first_step']}); "
            f"first output {healthy[0].tolist()}")
        del eng, eng2
    serve_s = time.perf_counter() - t_serve
    counts = {k["name"]: k["module"].launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] kernel launches over the 4 waves: {counts}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; {serve_s:.1f} s")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"main path")
    _breakdown(dev, cfg, params, base)
    return counts, results


def _breakdown(dev, cfg, params, base):
    """After the main path: the unprotected baseline (ft_mode none) and a
    profiler window over two decode steps at scope all, for PERF.md's
    "where the time goes". A measurement, not a check: if the profiler
    cannot trace the card, the share is reported as not measured."""
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, ServeConfig(**dict(base, ft_mode="none")), params,
                      device=dev)
    _, st, _ = _wave(eng, cfg, None, [])
    none_ms = 1e3 * sum(st[1:]) / len(st[1:])
    log(f"[serve] ft_mode=none: mean decode-step {none_ms:.3f} ms, "
        f"admission+first step {1e3 * st[0]:.3f} ms")
    eng = ServeEngine(cfg, ServeConfig(**dict(base, ft_scope="all")), params,
                      device=dev)
    _wave_submit(eng, cfg)
    eng.step()  # admission + first decode, outside the window
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []  # device-side events only (kernels, memsets, copies)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            rows.append((dev_us, e.key, e.count))
    except RuntimeError as err:
        log(f"[profile] not measured: {err}")
        return dict(step_ms=none_ms)
    busy = sum(r[0] for r in rows) / 1e3
    rows.sort(reverse=True)
    log(f"[profile] scope=all, 2 decode steps: wall {1e3 * wall:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / (1e3 * wall):.1f}%; idle "
        f"{100 - 100 * busy / (1e3 * wall):.1f}%)")
    for dev_us, key, count in rows[:8]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:160]}")
    return dict(step_ms=none_ms, profile_wall_ms=1e3 * wall, busy_ms=busy)


# ---------------------------------------------------------------- timings --

def _device_ms(fn, iters, match=None):
    """Mean device time of ``fn(i)`` in ms: the summed duration of the
    device-side events (kernels, fills, copies) that ``iters`` calls
    launch, from a ``torch.profiler`` trace — the host's launch gaps
    between calls are not counted. ``match`` keeps only events whose name
    contains it (the hand-written kernel alone)."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (match is None or match in e.key))
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / iters


def phase_timings(dev):
    """Kernel, plain version and bound at the decode-head and largest MLP
    shapes (weights rotated through enough copies to exceed the L2, as
    the decode loop finds them cold)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels.codec import pack_int8

    cfg = get_config(ARCH)
    plan = make_plan(SERVE["ft_M"], 32)
    gen = torch.Generator(device=dev).manual_seed(7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * BOOST_HZ
    gsz = SERVE["max_batch"] // plan.M
    rows = []
    for site, (B, K, N) in (("head", (gsz, cfg.d_model, cfg.vocab_size)),
                            ("mlp.down", (gsz, cfg.d_ff, cfg.d_model)),
                            ("mlp.gate/up", (gsz, cfg.d_model, cfg.d_ff))):
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (plan.M, B, K), dev)
        wbytes = (K // 4) * N * 4
        copies = max(1, -(-2 * L2_BYTES // wbytes))
        gs = [pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
              .contiguous() for _ in range(copies)]
        kw = dict(fuse_epilogue=True, failed=1, packed=True)
        iters = 20 if N > 100_000 else 50

        def kernel(i):
            return emm.entangled_matmul_cuda(c, gs[i % copies], plan, **kw)

        ms = _device_ms(kernel, iters)  # the kernel plus its scratch fill
        kernel_only = _device_ms(kernel, iters, match="emm_kernel")
        plain_ms = _device_ms(lambda i: emm.entangled_matmul_plain(
            c, gs[i % copies], plan, **kw), max(3, iters // 5))
        nbytes = 4 * (plan.M * B * K + (K // 4) * N + plan.M * B * N)
        # the extracting modes need the M-1 streams other than r only
        macs = (plan.M - 1) * B * K * N
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * macs / int32_rate
        rows.append(dict(site=site, shape=[plan.M, B, K, N], ms=ms,
                         kernel_only_ms=kernel_only,
                         plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes_ms=t_bytes, ops_ms=t_ops))
        log(f"[timing] {site} [{plan.M},{B},{K}]x[{K // 4},{N}] packed: kernel "
            f"{ms:.4f} ms (emm_kernel alone {kernel_only:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f}"
            f" ms ({rows[-1]['bound_by']}; bytes {t_bytes:.4f} ms, int32 MACs "
            f"of the M-1 streams {t_ops:.4f} ms), "
            f"{ms / max(t_bytes, t_ops):.2f}x bound; no single PyTorch call "
            f"computes this function")
        del c, gs
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------- main --

def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import entangled_matmul as emm

    kernels = [dict(name="entangled_matmul", module=emm, route="cuda",
                    source="src/repro_torch/kernels/csrc/entangled_matmul.cu",
                    replaces="src/repro/kernels/entangled_matmul.py:102")]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_all = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    phase_build(kernels)
    cfg, model, params = init_model(dev)
    shapes = main_path_shapes(cfg, params, dev)
    worst = phase_kernels(dev, shapes)
    counts, serve = phase_serve(dev, kernels, cfg, model, params)
    rows = phase_timings(dev)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    head = rows[0]
    record = dict(kernels=[dict(
        name=k["name"], route=k["route"], source=k["source"],
        replaces=k["replaces"], launches=counts[k["name"]],
        launches_per_decode_step={
            scope: r["launches_per_decode_step"] for scope, r in serve.items()},
        max_abs_err=worst, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=None, shape=head["shape"], timings=rows)
        for k in kernels])
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
