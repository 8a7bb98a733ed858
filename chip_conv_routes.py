"""Both conv routes on the card, beside the s8 route's MMA loop alone.

Not part of ``chip_smoke.py``: run it when the conv kernels or the route
rule of ``repro_torch/kernels/conv1d.py`` (``route_for``) change. It builds
the conv source, then

  * sweeps both routes of both convs (``route="cuda_core"`` and ``"s8"``)
    over K_f in SWEEP_KF at the paper's stream shape and at the depthwise
    model shape, and logs each pair of times beside the route that
    ``route=None`` takes (``[conv-route]`` lines; "DIFFERS" where the rule
    did not take the faster route);
  * times the s8 route's MMA loop alone at M = 8, K = 4500: a second build
    of ``csrc/conv1d.cu``, made by text substitution, that keeps every
    wgmma, the fold and the stores and drops the staging and the tap loads
    (its sums are wrong; it is a timing only).

From the root of a checkout, on a machine with a CUDA device:

    python3 chip_conv_routes.py

The last line is one JSON object with the sweep's rows and the loop's
times. Exits nonzero without a CUDA device, or when a substitution no
longer matches the source.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (CONV_ROUTES, DEPTHWISE, STREAM_MS,  # noqa: E402
                        _graph_ms, _padded, _rand, _turns, free_cuda,
                        kernel_table, log, nvidia_smi, phase_build,
                        stream_inputs)

# the sweep's filters
SWEEP_KF = (1, 4, 16, 33, 100, 500, 4500)


def _ceiling_build():
    """Build csrc/conv1d.cu as `s8_loop_ceiling` times it (see there) into
    ``_build/``; returns the library's path."""
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import nvcc

    src = kconv.SRC.read_text()
    for a, b in (("for (int e = 0; e < 8; ++e) wd[e] = tw[e];",
                  "for (int e = 0; e < 8; ++e) wd[e] = (uint32_t)(tb + e);"),
                 ("g0 < ng; g0 += STAGE * THREADS)",
                  "g0 < 0; g0 += STAGE * THREADS)"),
                 ("wi < p.tlen / 4; wi += THREADS)",
                  "wi < 0; wi += THREADS)")):
        if src.count(a) != 1:
            raise AssertionError(f"s8 ceiling: {a!r} not once in the source")
        src = src.replace(a, b)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="conv_ceiling_"))
    try:
        (tmp / kconv.SRC.name).write_text(src)
        shutil.copy(kconv.SRC.parent / "codec.cuh", tmp)
        return nvcc.build(tmp / kconv.SRC.name)[0]
    finally:
        shutil.rmtree(tmp)


def s8_loop_ceiling(dev, inputs, build):
    """What the s8 route's MMA loop gives alone: the conv over [8, 1, T] at
    M = 8, K = 4500, timed in turns with a build of csrc/conv1d.cu that
    keeps every wgmma (and the shared-memory reads of its B operand), the
    fold and the stores, and drops the staging of the windows and the taps
    and the tap loads that build the A fragments (wrong sums, timing only;
    ``build`` is the path :func:`_ceiling_build` returns). Returns
    (kernel ms, loop-only ms)."""
    import ctypes

    import torch

    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import nvcc

    loop_lib = ctypes.CDLL(str(build))
    kconv._declare(loop_lib)
    real_lib = kconv.load()
    M, K = max(inputs)
    x = _padded(inputs[(M, K)][0], K)[:, None].contiguous()
    taps = torch.flip(inputs[(M, K)][1], (0,))[None].contiguous()
    times = {"kernel": [], "loop": []}
    try:
        for which in ("kernel", "loop", "loop", "kernel"):
            nvcc._libs[kconv.SRC] = real_lib if which == "kernel" else loop_lib
            times[which].append(_graph_ms(
                lambda i: kconv.conv1d_causal_cuda(x, taps, route="s8"), 10))
    finally:
        nvcc._libs[kconv.SRC] = real_lib
    ms, loop_ms = (sum(times[k]) / 2 for k in ("kernel", "loop"))
    log(f"[timing] conv1d_causal s8 [{M}, 1, {x.shape[-1]}] x [1, {K}]: "
        f"kernel {ms:.4f} ms, its MMA loop alone (no staging, no A fragment "
        f"loads; timing only) {loop_ms:.4f} ms: staging and loads take "
        f"{100 * (1 - loop_ms / ms):.1f}%")
    return ms, loop_ms


def conv_route_sweep(dev, inputs):
    """Both routes of both convs at K_f in SWEEP_KF, one after the other
    (a route decision: chip_smoke.py's `stream_kernel_rows` times the main
    shapes in turns): at the stream shape (the M = 8 streams of the
    stream-conv inputs, taps in [-4, 4): the conv over [8, 1, 1e6 + K_f -
    1], the fused entangled conv over [8, 1, 1, T], stream 1 failed) and at
    the depthwise shape (full-range words and taps: the conv over [8, 8192,
    512], the fused entangled conv over [4, 8, 8192, 512]). Each time is
    logged beside the route ``route=None`` takes (kernels/conv1d.py's
    rule). Returns the rows."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import entangled_conv1d as kecv

    t0 = time.perf_counter()
    M = max(STREAM_MS)
    c = inputs[(M, max(k for m, k in inputs if m == M))][0]
    B, D, Td, _ = DEPTHWISE
    gen = torch.Generator(device=dev).manual_seed(7)
    xdw = _rand(gen, -2**31, 2**31, (4, B, D, Td), dev)
    rows = []
    for kf in SWEEP_KF:
        taps = _rand(gen, -4, 4, (1, kf), dev)
        wdw = _rand(gen, -2**31, 2**31, (D, kf), dev)
        xs = _padded(c, kf)[:, None].contiguous()
        T = xs.shape[-1]
        cases = [
            ("stream", "conv1d_causal", T,
             lambda r: (lambda i: kconv.conv1d_causal_cuda(xs, taps,
                                                           route=r))),
            ("stream", "entangled_conv1d", T,
             lambda r: (lambda i: kecv.entangled_conv1d_cuda(
                 xs[:, None], taps, make_plan(M, 32), fuse_epilogue=True,
                 failed=1, route=r))),
            ("depthwise", "conv1d_causal", Td,
             lambda r: (lambda i: kconv.conv1d_causal_cuda(xdw[0], wdw,
                                                           route=r))),
            ("depthwise", "entangled_conv1d", Td,
             lambda r: (lambda i: kecv.entangled_conv1d_cuda(
                 xdw, wdw, make_plan(4, 32), fuse_epilogue=True, failed=1,
                 route=r)))]
        for shape, name, tt, make in cases:
            turns = _turns({r: make(r) for r in CONV_ROUTES},
                           3 if kf >= 500 else 10, order=CONV_ROUTES)
            ms = {r: t[0] for r, t in turns.items()}
            faster = min(ms, key=ms.get)
            rule = kconv.route_for(kf, tt, name == "entangled_conv1d")
            rows.append(dict(shape=shape, name=name, kf=kf, T=tt, ms=ms,
                             turns=turns, faster=faster, rule=rule))
            log(f"[conv-route] {shape} {name} K_f={kf} T={tt}: CUDA-core "
                f"{ms['cuda_core']:.4f} ms, s8 {ms['s8']:.4f} ms; faster "
                f"{faster}, the rule takes {rule}"
                f"{'' if rule == faster else ' (DIFFERS)'}")
        del xs
        free_cuda()
    log(f"[conv-route] sweep {time.perf_counter() - t0:.1f} s; the rule "
        f"(s8 from K_f = {kconv.S8_MIN_KF}, the plain conv from "
        f"{kconv.S8_MIN_KF_PLAIN} over T >= {kconv.S8_LONG_T}) differs "
        f"from the faster route "
        f"in {sum(r['rule'] != r['faster'] for r in rows)} of {len(rows)}")
    del xdw
    free_cuda()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_routes: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    phase_build([k for k in kernel_table() if "conv" in k["name"]])
    t0 = time.perf_counter()
    loop_build = _ceiling_build()
    log(f"[build] the MMA-loop-only build: {time.perf_counter() - t0:.1f} s")
    inputs = stream_inputs(dev)
    ms, loop_ms = s8_loop_ceiling(dev, inputs, loop_build)
    sweep = conv_route_sweep(dev, inputs)
    print(smi, flush=True)
    print(json.dumps(dict(device=smi, s8_loop=dict(ms=ms, loop_ms=loop_ms),
                          sweep=sweep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
