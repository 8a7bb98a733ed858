#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

It drives the port's two serving paths and its training path, each at its
model's published widths with random weights from a seeded
``torch.Generator``: llama3.2-1b (dense decoder, 16 layers) served and
trained, and deepseek-v2-lite-16b (MLA attention, a dense first layer and
64-expert top-6 MoE layers; cut to 8 of its 27 layers, since its float32
masters and int8 copies at all 27 layers do not fit one 80 GB card)
served; and the paper's own experiment, the Fig. 2 stream convolution
(M = 3 and 8 streams of 1e6 int32 samples, kernel sizes 100..4500, nothing
cut) through the fail-stop engine ``run_protected``. Phases, each printing
its results on lines of its own; any failed check raises and the script
exits nonzero:

  1. build   — compile every CUDA source of the paths from the checkout
               (one ``nvcc`` per source, all started together), report the
               build seconds and the card's ``nvidia-smi`` name and power
               limit;
  2. kernels — per path, hold each kernel bit for bit against its plain
               PyTorch version on the card: the entangled GEMMs at every
               shape the full-width engine can send them (the vocab head
               plus the engine's own startup census of protected sites at
               scope all) and at ragged small ones, every
               ``fuse_epilogue`` mode, packed and unpacked weights, every
               failed stream, int32 and dual-word plans, each GEMM on both
               its routes (the s8 tensor-core kernel on packed weights, the
               CUDA-core kernel on both forms; every admission mode's
               census, and packed calls at K = 65540, past one exact s8
               limb product); the codec passes
               at every gradient leaf of full-width llama3.2-1b as the
               sync blocks it and at ragged widths, M = 3..8, every r;
               plus the poison checks (stream r overwritten by GARBAGE
               changes nothing);
  3. serve   — the port's ``ServeEngine`` serving the path's model: per
               protected ``ft_scope`` (llama: head, all; deepseek: moe,
               all) a healthy wave and a wave with ``failed_group=1`` must
               give equal tokens (EXACT ROLL-FORWARD), then ``ft_mode
               none`` once and a profiler window; every packed GEMM must
               have gone through the s8 kernel, none through the CUDA-core
               one;
  3b. serve-admission — the rest of the engine on the same models: a
               24-request wave (prompt lengths from ``--seed`` in 5..240,
               every bucket 8..256 driven, slots refilled mid-flight)
               under whole-bucket admission, chunked prefill (32) with
               refill, the same without refill, and token packing (4 rows
               of 32), each healthy and with ``failed_group=1`` at scopes
               head and all (EXACT ROLL-FORWARD (serve-admission), plan
               misses 0; the injected wave runs on a warm replica); the
               modes' tokens compared pairwise under the near-tie rule;
               a cancel in every state and a deadline shed; step ms with
               and without a prefill call, TTFT, tokens/s and the recycle
               zeroing's launches. deepseek: chunked and packed at scope
               all;
  4. train   — ``train_loop`` trains full-width llama3.2-1b with the
               entangled gradient sync on the kernel codec (a fail-stopped
               block at one step) and writes its final checkpoint; the
               losses must be finite. EXACT ROLL-FORWARD (train): one
               backward, synced healthy and with each of blocks 0-3 failed,
               every synced leaf and the updated state bit-identical. Then
               the mean step time per gradient sync and a profiler window;
  5. stream-conv — the conv, entangled conv and checksum kernels held
               against their plain versions (ragged shapes at K_f 1..4500,
               every plan, mode, packing and failed stream; the depthwise
               model shape [4, 8, 8192, 512]; the stream-conv shapes); then
               the path: ``run_protected("conv")`` under none / entangle /
               checksum / mr with every failed stream, and the fused
               entangled conv with every failed stream, must equal the
               failure-intolerant conv bit for bit (EXACT ROLL-FORWARD
               (stream conv)) per (M, K), and every other LSB op must
               recover exactly at the demo's size; then the Fig. 2 overheads
               of each family against the conventional conv on the card;
  6. timings — each kernel, its plain version and its bound at its
               main-path shapes, after warm-up: device time per call from
               the replay of a CUDA graph of many calls, and the kernel's
               own time per launch from a profiler trace; the GEMMs' two
               kernels in turns in the same call, and the grouped GEMM
               also at decode occupancy (most experts empty).

Every path sets the kernels' launch counts (per route) to 0 just before
it is driven and reads them just after; each kernel of the path must have
launched.
The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, the script exits nonzero and prints
no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks used for the bounds: HBM3 at 3.35 TB/s and dense int8
# tensor-core operations at 1,979 TOP/s (NVIDIA data sheet); int32
# multiply-adds run on the CUDA cores at 64 lanes per SM per clock (Hopper
# architecture white paper) at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
L2_BYTES = 50 * 2**20

LLAMA = "llama3.2-1b"
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_LAYERS = 8  # 1 dense + 7 MoE layers at published widths
SERVE = dict(max_batch=8, ft_M=4, max_seq=256, requests=8, prompt_len=8,
             max_new=8)
# the serve-admission path: the same engine geometry with every bucket of
# the geometric set (8 .. 256), a 24-request wave of seeded prompt lengths
# in [5, 240] (one in every bucket, the rest log-uniform) and the four
# admission modes, each healthy and with failed_group=1 at scopes head and
# all (deepseek: chunked and packed at scope all)
ADMIT = dict(requests=24, len_lo=5, len_hi=240, max_new=8, chunk=32,
             budget=128)
ADMIT_MODES = {"whole": {}, "chunked": dict(prefill_chunk=32),
               "boundary": dict(prefill_chunk=32, refill=False),
               "packed": dict(prefill_chunk=32, token_budget=128)}
# the near-tie rule of tests/test_torch_serve.py for two admission modes'
# greedy tokens: float reductions of other shapes move bf16 hidden states
# by a few ulps, so a request's tokens may part only where each mode's
# token is within NEAR_TIE of the top logit in the other's logits, and the
# logits of the shared prefix agree within LOGIT_TOL of the largest
# |logit|
NEAR_TIE = 2.0 ** -6
LOGIT_TOL = 2.0 ** -5
# the training path: llama3.2-1b at published widths; the loop's steps
# (block 1 of the entangled sync fail-stopped at FAIL_STEP), then the timed
# steps of each gradient sync
TRAIN = dict(batch=4, seq=512, ft_M=4, steps=4, fail_step=2, warm_steps=2,
             timed_steps=5)
# the stream-conv path: the paper's Fig. 2 configuration
# (repro_torch/configs/stream_conv.py: N_in = 1e6, K in 100..4500) at the
# stream counts its benchmark runs, nothing cut
STREAM_MS = (3, 8)
# ragged conv shapes of the kernel checks, (B, D, T, K_f)
CONV_SHAPES = [(2, 5, 33, 1), (1, 3, 700, 2), (3, 6, 1029, 4),
               (1, 1, 3001, 100), (1, 1, 5003, 4500)]
# the depthwise model shape (B, D, T, K_f): the Mamba conv1d of
# falcon-mamba-7b (d_inner 8192, d_conv 4) over 8 rows of 512 steps, M = 4
DEPTHWISE = (8, 8192, 512, 4)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def count(k, route: int = 0) -> int:
    """Launches of kernel ``k`` on its main route (``route`` 1: the second
    route of a GEMM, its CUDA-core kernel)."""
    return getattr(k["module"], k["counters"][route])


def reset_counts(kernels) -> None:
    """Set every route's launch count of every kernel to 0."""
    for k in kernels:
        for name in k["counters"]:
            setattr(k["module"], name, 0)


def free_cuda() -> None:
    gc.collect()
    import torch

    torch.cuda.empty_cache()


# ------------------------------------------------------------------ build --

def phase_build(kernels):
    """Build every CUDA source at once, one nvcc per source (kernels that
    share a source share its library)."""
    import concurrent.futures as cf

    builds = {src: fn for k in kernels for src, fn in k["builds"]}
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(builds)) as ex:
        futs = {src: ex.submit(fn, True) for src, fn in builds.items()}
        built = {src: f.result() for src, f in futs.items()}
    wall = time.perf_counter() - t0
    for src, (so, secs, text) in built.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", text)]
        users = [k["name"] for k in kernels
                 if src in dict(k["builds"])]
        log(f"[build] {src} ({', '.join(users)}): nvcc {secs:.1f} s -> "
            f"{so.name}; ptxas: {len(regs)} kernel instances, "
            f"{min(regs)}-{max(regs)} registers, largest spill "
            f"{max(spills)} bytes")
    log(f"[build] all kernels built in {wall:.1f} s wall")
    return wall


# ---------------------------------------------------------------- kernels --

def _rand(gen, lo, hi, shape, dev):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)


class Checker:
    """Kernel-vs-plain comparisons of one kernel (and, for a GEMM, its
    poison checks); keeps the largest |kernel - plain| seen (0 when all
    agree) and the count, per route. ``cuda_fn``/``plain_fn`` are the
    GEMM's pair for ``compare``; a GEMM's ``s8_fn`` (its wrapper, which
    sends packed calls to the s8 tensor-core kernel) is held against the
    same plain result on every packed call, beside ``cuda_fn`` (its
    CUDA-core kernel, called directly). The codec passes call ``equal``
    with their own results."""

    def __init__(self, cuda_fn=None, plain_fn=None, s8_fn=None):
        self.cuda_fn, self.plain_fn, self.s8_fn = cuda_fn, plain_fn, s8_fn
        self.worst_by_route, self.n_by_route = {}, {}

    @property
    def worst(self):
        return max(self.worst_by_route.values(), default=0)

    @property
    def n(self):
        return sum(self.n_by_route.values())

    def routes(self, packed):
        """(route, launch function) of each kernel that takes the call."""
        if self.s8_fn is None:
            return [("cuda", self.cuda_fn)]
        out = [("cuda_core", self.cuda_fn)]
        return [("s8", self.s8_fn)] + out if packed else out

    def equal(self, got, want, what, route="cuda"):
        import torch

        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        self.worst_by_route[route] = max(self.worst_by_route.get(route, 0),
                                         err)
        self.n_by_route[route] = self.n_by_route.get(route, 0) + 1
        if err:
            raise AssertionError(f"kernel != plain for {what} ({route}): max "
                                 f"|diff| {err}")

    def compare(self, c, g, plan, mode, r, packed, what):
        kw = dict(fuse_epilogue=mode, failed=r, packed=packed)
        want = self.plain_fn(c, g, plan, **kw)
        for route, fn in self.routes(packed):
            self.equal(fn(c, g, plan, **kw), want,
                       f"{what} mode={mode!r} failed={r} packed={packed}",
                       route)

    def sweep(self, c, g, plan, packed, what, modes):
        """Every mode of ``modes``, every failed stream where it extracts."""
        for mode in modes:
            rs = ([None] + list(range(plan.M))
                  if mode in (True, "chain_final") else [None])
            for r in rs:
                self.compare(c, g, plan, mode, r, packed, what)

    def poison(self, c, g, plan, packed, what):
        import torch

        from repro_torch.core.entangle import disentangle
        from repro_torch.core.failstop import GARBAGE

        for route, fn in self.routes(packed):
            delta = fn(c, g, plan, fuse_epilogue=False, packed=packed)
            for r in range(plan.M):
                fused = fn(c, g, plan, fuse_epilogue=True, failed=r,
                           packed=packed)
                bad = delta.clone()
                bad[r] = GARBAGE
                ref = disentangle(bad, plan, failed=r)
                torch.cuda.synchronize()
                if not torch.equal(fused, ref):
                    raise AssertionError(f"poison check failed for {what}, "
                                         f"r={r} ({route})")


DENSE_MODES = (False, True, "chain", "chain_final")
GROUPED_MODES = (False, True)
# a packed contraction deeper than one exact s8 limb product (65536)
DEEP_K = 65540


def _all_plans():
    from repro_torch.core.plan import make_plan

    return [make_plan(3, 16), make_plan(4, 16)] + [
        make_plan(M, 32) for M in range(3, 9)]


def check_dense(dev, chk, shapes, ragged: bool):
    """The dense kernel: ragged small shapes (every plan, full-range int32
    values) when ``ragged``, then the main path's ``shapes`` (a list of
    ``(B, K, N, sites)``) with activations on the eq.-13 budget grid and
    int8 weights packed 4 per word, as the serving path sends them."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels.codec import pack_int8

    gen = torch.Generator(device=dev).manual_seed(1234)
    if ragged:
        n0 = chk.n
        for plan in _all_plans():
            for (B, K, N) in [(6, 13, 9), (1, 1, 1), (17, 70, 300),
                              (3, 2049, 257)]:
                c = _rand(gen, -2**31, 2**31, (plan.M, B, K), dev)
                g32 = _rand(gen, -2**31, 2**31, (K, N), dev)
                gp = pack_int8(_rand(gen, -128, 128, (K, N), dev), axis=0)
                what = (f"plan(M={plan.M},l={plan.l},{plan.temp}) B={B} K={K}"
                        f" N={N}")
                for packed, g in ((False, g32), (True, gp)):
                    chk.sweep(c, g, plan, packed, what, DENSE_MODES)
                chk.poison(c, gp, plan, True, what)
        log(f"[kernels] entangled_matmul ragged shapes: {chk.n - n0} "
            f"kernel-vs-plain comparisons bit-identical; poison check passed")
        n0 = chk.n
        plan = make_plan(SERVE["ft_M"], 32)
        c = _rand(gen, -2**31, 2**31, (plan.M, 2, DEEP_K), dev)
        gp = pack_int8(_rand(gen, -128, 128, (DEEP_K, 300), dev), axis=0)
        what = f"K={DEEP_K} past one limb product's 65536"
        chk.sweep(c, gp, plan, True, what, DENSE_MODES)
        chk.poison(c, gp, plan, True, what)
        log(f"[kernels] entangled_matmul packed at K={DEEP_K} (split-K into "
            f"chunks of at most 65536): {chk.n - n0} comparisons "
            f"bit-identical; poison check passed")
    plan = make_plan(SERVE["ft_M"], 32)
    n0 = chk.n
    for (B, K, N, site) in shapes:
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (plan.M, B, K), dev)
        gp = pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
        what = f"{site} [{plan.M},{B},{K}]x[{K // 4},{N}]"
        chk.sweep(c, gp, plan, True, what, DENSE_MODES)
        chk.poison(c, gp, plan, True, what)
        del c, gp
        torch.cuda.empty_cache()
    log(f"[kernels] entangled_matmul full-width shapes: {len(shapes)} "
        f"main-path shapes, {chk.n - n0} comparisons bit-identical; poison "
        f"check passed")


def check_grouped(dev, chk, shapes):
    """The grouped kernel: ragged small shapes for every plan, then the
    main path's ``shapes`` (a list of ``(E, Cg, K, N, sites)``) under the
    serving plan (dual-word) and an int32 plan, packed int8 and unpacked
    full-range int32 weights, both modes, every failed stream; the poison
    check on every shape."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels.codec import pack_int8

    gen = torch.Generator(device=dev).manual_seed(4321)
    n0 = chk.n
    for plan in _all_plans():
        for (E, Cg, K, N) in [(3, 5, 13, 9), (1, 1, 1, 1), (4, 17, 70, 300),
                              (2, 3, 2049, 257)]:
            c = _rand(gen, -2**31, 2**31, (plan.M, E, Cg, K), dev)
            g32 = _rand(gen, -2**31, 2**31, (E, K, N), dev)
            gp = pack_int8(_rand(gen, -128, 128, (E, K, N), dev), axis=1)
            what = (f"plan(M={plan.M},l={plan.l},{plan.temp}) E={E} Cg={Cg} "
                    f"K={K} N={N}")
            for packed, g in ((False, g32), (True, gp)):
                chk.sweep(c, g, plan, packed, what, GROUPED_MODES)
            chk.poison(c, gp, plan, True, what)
    log(f"[kernels] entangled_matmul_grouped ragged shapes: {chk.n - n0} "
        f"kernel-vs-plain comparisons bit-identical; poison check passed")
    n0 = chk.n
    plan = make_plan(SERVE["ft_M"], 32)
    c = _rand(gen, -2**31, 2**31, (plan.M, 3, 2, DEEP_K), dev)
    c[:, 1] = 0  # an empty expert between occupied ones
    gp = pack_int8(_rand(gen, -128, 128, (3, DEEP_K, 260), dev), axis=1)
    what = f"E=3 K={DEEP_K} past one limb product's 65536"
    chk.sweep(c, gp, plan, True, what, GROUPED_MODES)
    chk.poison(c, gp, plan, True, what)
    log(f"[kernels] entangled_matmul_grouped packed at K={DEEP_K} (split-K "
        f"into chunks of at most 65536): {chk.n - n0} comparisons "
        f"bit-identical; poison check passed")
    n0 = chk.n
    for (E, Cg, K, N, site) in shapes:
        for plan in (make_plan(SERVE["ft_M"], 32), make_plan(SERVE["ft_M"],
                                                             16)):
            bud = activation_budget(plan, K)
            c = _rand(gen, -bud, bud + 1, (plan.M, E, Cg, K), dev)
            gp = pack_int8(_rand(gen, -127, 128, (E, K, N), dev), axis=1)
            g32 = _rand(gen, -2**31, 2**31, (E, K, N), dev)
            what = f"{site} [{plan.M},{E},{Cg},{K}]x[{E},{K // 4},{N}]"
            for packed, g in ((True, gp), (False, g32)):
                chk.sweep(c, g, plan, packed, what + f" {plan.temp}",
                          GROUPED_MODES)
            chk.poison(c, gp, plan, True, what)
            del c, gp, g32
            torch.cuda.empty_cache()
    log(f"[kernels] entangled_matmul_grouped full-width shapes: "
        f"{len(shapes)} main-path shapes x 2 plans, {chk.n - n0} comparisons "
        f"bit-identical; poison check passed")


def llama_grad_shapes(dev):
    """{numel: leaf names} of every gradient leaf of full-width llama3.2-1b
    (the stacked layout: one leaf per weight of all 16 layers), read from
    freshly made params."""
    import torch

    from repro_torch.models.api import get_model
    from repro_torch.tree import leaves_with_path

    cfg = model_config(LLAMA)
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 cfg, TRAIN["seq"], device=dev)
    out = {}
    for path, t in leaves_with_path(params):
        out.setdefault(t.numel(), []).append(
            f"{path}{list(t.shape)}".replace("'", ""))
    del params
    free_cuda()
    return out


def check_codec(dev, checkers, grad_shapes):
    """The entangle and disentangle passes against their plain versions:
    ragged widths under every plan of Table I (M = 3..8; dual-word at w=32,
    int32 at w=16) and every r, then every llama gradient leaf as the sync
    blocks it, ``[M, ceil(n / M)]`` under the training plan, every r; the
    poison check (row r overwritten by GARBAGE) everywhere. Full-range
    int32 words."""
    import torch

    from repro_torch.core.failstop import GARBAGE
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import disentangle as kdis
    from repro_torch.kernels import entangle as kent

    chk_e, chk_d = checkers["entangle"], checkers["disentangle"]
    gen = torch.Generator(device=dev).manual_seed(99)

    def one(plan, n, what):
        c = _rand(gen, -2**31, 2**31, (plan.M, n), dev)
        eps = kent.entangle_cuda(c, plan)
        chk_e.equal(eps, kent.entangle_plain(c, plan), what)
        for r in range(plan.M):
            got = kdis.disentangle_cuda(eps, plan, r)
            chk_d.equal(got, kdis.disentangle_plain(eps, plan, r),
                        f"{what} r={r}")
            eps_r = eps[r].clone()
            eps[r] = GARBAGE
            chk_d.equal(kdis.disentangle_cuda(eps, plan, r), got,
                        f"{what} r={r} poisoned")
            eps[r] = eps_r

    n0 = (chk_e.n, chk_d.n)
    plans = [make_plan(M, 32) for M in range(3, 9)] + [make_plan(3, 16),
                                                       make_plan(4, 16)]
    for plan in plans:
        for n in (1, 2, 3, 1023, 1025, 65537):
            one(plan, n, f"plan(M={plan.M},l={plan.l},{plan.temp}) N={n}")
    log(f"[kernels] entangle / disentangle ragged widths: {len(plans)} plans"
        f" x 6 widths, {chk_e.n - n0[0]} / {chk_d.n - n0[1]} comparisons "
        f"bit-identical; poison check passed")
    n0 = (chk_e.n, chk_d.n)
    plan = make_plan(TRAIN["ft_M"], 32)
    for n, names in sorted(grad_shapes.items()):
        one(plan, -(-n // plan.M), f"grad {names[0]} ({len(names)} leaves)")
        free_cuda()
    n_leaves = sum(map(len, grad_shapes.values()))
    log(f"[kernels] entangle / disentangle at the {len(grad_shapes)} "
        f"gradient-leaf sizes of full-width {LLAMA} ({n_leaves} "
        f"leaves, [{plan.M}, ceil(n/{plan.M})], plan(M={plan.M},l={plan.l},"
        f"{plan.temp})): {chk_e.n - n0[0]} / {chk_d.n - n0[1]} comparisons "
        f"bit-identical; poison check passed")


# ------------------------------------------------------------------ serve --

def model_config(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == DEEPSEEK:
        cfg = dataclasses.replace(cfg, n_layers=DEEPSEEK_LAYERS)
    return cfg


def init_model(dev, arch):
    """The published config (deepseek cut to DEEPSEEK_LAYERS layers) with
    random weights from a seeded ``torch.Generator``; returns (cfg, model,
    params)."""
    import torch

    from repro_torch.models.api import get_model

    cfg = model_config(arch)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        max_seq=SERVE["max_seq"], device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    extra = ""
    if cfg.moe:
        extra = (f", MLA kv_lora {cfg.mla.kv_lora_rank}, {cfg.moe.n_experts}"
                 f" experts top-{cfg.moe.top_k} (d_ff {cfg.moe.d_ff_expert},"
                 f" {cfg.moe.n_shared} shared), dense first layer d_ff "
                 f"{cfg.d_ff}")
    log(f"[serve] {arch} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}{extra}; {n / 1e9:.3f} G float32 "
        f"params; random init {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def main_path_shapes(cfg, params, dev):
    """Every entangled-GEMM shape the serving engine can launch: dense
    ``(B, K, N, sites)`` — the vocab head (decode and admission both send
    max_batch / M rows per group) plus the 4-tuples of the engine's own
    startup census at ft_scope 'all' in every admission mode (the decode
    step, one prefill per bucket, per chunk width of chunked admission,
    and the packed [Rp, Cp] program) — and grouped ``(E, Cg, K, N,
    sites)`` from the census's 5-tuples. Logs how many shapes the chunked
    and packed censuses add to the whole-bucket one."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dense = {(SERVE["max_batch"] // SERVE["ft_M"], cfg.d_model,
              cfg.vocab_size): ["head"]}
    grouped = {}
    census = {}
    for mode in ("whole", "chunked", "packed"):  # refill moves no shape
        kw = ADMIT_MODES[mode]
        eng = ServeEngine(cfg, ServeConfig(
            max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
            ft_mode="entangle", ft_M=SERVE["ft_M"], ft_scope="all", **kw),
            params, device=dev)
        census[mode] = set(eng.protected_census)
        del eng
        free_cuda()
    for site, shape in sorted(set().union(*census.values())):
        d = dense if len(shape) == 4 else grouped
        if site not in d.setdefault(shape[1:], []):
            d[shape[1:]].append(site)
    new = {m: len(c - census["whole"]) for m, c in census.items()
           if m != "whole"}
    log(f"[kernels] {cfg.name} census at scope all: whole-bucket "
        f"{len(census['whole'])} (site, shape) entries; entries the "
        f"chunked and packed ([{ADMIT['budget'] // ADMIT['chunk']}, "
        f"{ADMIT['chunk']}]) censuses add: {new}")
    flat = lambda d: [(*k, "/".join(v)) for k, v in sorted(d.items())]  # noqa: E731
    return flat(dense), flat(grouped)


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
    {kernel: launches per step})."""
    import numpy as np
    import torch

    reqs = _wave_submit(eng, cfg)
    steps = []
    launched = {k["name"]: [] for k in kernels}
    while not eng.idle():
        before = {k["name"]: count(k) for k in kernels}
        t0 = time.perf_counter()
        eng.step(failed_group=failed_group)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        for k in kernels:
            launched[k["name"]].append(count(k) - before[k["name"]])
        if len(steps) > 10 * SERVE["max_new"]:
            raise AssertionError("wave failed to drain")
    outs = {r.rid: np.asarray(r.out) for r in reqs}
    for rid, o in outs.items():
        if o.shape != (SERVE["max_new"],) or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: bad output {o}")
    return outs, steps, launched


def phase_serve(dev, kernels, path_kernels, cfg, model, params, scopes):
    """Serve the wave per protected scope, healthy and with failed_group=1;
    every kernel's count is set to 0 just before and read just after, and
    each of ``path_kernels`` must have launched, and no GEMM may have
    reached its CUDA-core route (every served weight is packed). Returns
    (counts, CUDA-core GEMM counts, results by scope, breakdown)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    # small-input sanity of the float path: finite hidden states of the
    # expected shape from a batched prefill with a padded row
    cache = model.init_cache(cfg, 2, 16, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev)
    h, _ = model.prefill_chunk(params, toks, cfg, cache, pos0=0,
                               lengths=torch.tensor([8, 5], device=dev))
    if h.shape != (2, 8, cfg.d_model) or not torch.isfinite(h.float()).all():
        raise AssertionError(f"prefill hidden states bad: {h.shape}")
    del cache, h

    base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                ft_mode="entangle", ft_M=SERVE["ft_M"])
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    results = {}
    t_serve = time.perf_counter()
    for scope in scopes:
        scfg = ServeConfig(ft_scope=scope, **base)
        eng = ServeEngine(cfg, scfg, params, device=dev)
        healthy, st_h, ln_h = _wave(eng, cfg, None, kernels)
        eng2 = ServeEngine(cfg, scfg, params, device=dev)
        injected, st_i, ln_i = _wave(eng2, cfg, 1, kernels)
        bad = sum(not np.array_equal(healthy[r], injected[r])
                  for r in healthy)
        ntok = sum(len(v) for v in healthy.values())
        verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
        log(f"[serve] {cfg.name} recovery summary [scope={scope}]: "
            f"failed_group=1 injected on every step; {len(healthy)} requests"
            f" / {ntok} tokens compared; mismatching requests: {bad} "
            f"({verdict})")
        if bad:
            raise AssertionError(f"{cfg.name} scope {scope}: {verdict}")
        if eng.plans is not None and (eng.plans.misses or eng2.plans.misses):
            raise AssertionError("compiled plans missed a shape")
        dec = st_h[1:] + st_i[1:]  # steps after the admission step
        wall = sum(st_h) + sum(st_i)
        per_step = {name: sorted(set(ln_h[name][1:] + ln_i[name][1:]))
                    for name in ln_h}
        results[scope] = dict(
            decode_calls=eng.decode_calls + eng2.decode_calls,
            step_ms=1e3 * sum(dec) / len(dec),
            tok_s=2 * ntok / wall,
            first_step_ms=1e3 * (st_h[0] + st_i[0]) / 2,
            launches_per_decode_step=per_step,
            launches_first_step={n: v[0] for n, v in ln_h.items()})
        log(f"[serve] {cfg.name} scope={scope}: decode_calls "
            f"{results[scope]['decode_calls']}, mean decode-step "
            f"{results[scope]['step_ms']:.3f} ms, admission+first step "
            f"{results[scope]['first_step_ms']:.3f} ms, "
            f"{results[scope]['tok_s']:.1f} tokens/s; kernel launches per "
            f"decode step {per_step} (admission step "
            f"{results[scope]['launches_first_step']}); first output "
            f"{healthy[0].tolist()}")
        del eng, eng2
        free_cuda()
    serve_s = time.perf_counter() - t_serve
    counts = {k["name"]: count(k) for k in kernels}
    # the GEMMs' second route: the CUDA-core kernel, which no packed
    # (serving) call may reach
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] {cfg.name} kernel launches over the {2 * len(scopes)} "
        f"waves: {counts}; CUDA-core GEMM route {core}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; {serve_s:.1f} s")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"{cfg.name} path")
    if any(core.values()):
        raise AssertionError(f"packed GEMMs of the {cfg.name} path reached "
                             f"the CUDA-core kernel: {core}")
    return counts, core, results, _breakdown(dev, cfg, params, base)


def _breakdown(dev, cfg, params, base):
    """After the path's waves: the unprotected baseline (ft_mode none) and a
    profiler window over two decode steps at scope all, for PERF.md's
    "where the time goes". A measurement, not a check: if the profiler
    cannot trace the card, the share is reported as not measured."""
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, ServeConfig(**dict(base, ft_mode="none")), params,
                      device=dev)
    _, st, _ = _wave(eng, cfg, None, [])
    none_ms = 1e3 * sum(st[1:]) / len(st[1:])
    log(f"[serve] {cfg.name} ft_mode=none: mean decode-step {none_ms:.3f} "
        f"ms, admission+first step {1e3 * st[0]:.3f} ms")
    del eng
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
    finally:
        del eng
        free_cuda()
    busy = sum(r[0] for r in rows) / 1e3
    rows.sort(reverse=True)
    log(f"[profile] {cfg.name} scope=all, 2 decode steps: wall "
        f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (1e3 * wall):.1f}%; idle "
        f"{100 - 100 * busy / (1e3 * wall):.1f}%)")
    for dev_us, key, count in rows[:8]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:160]}")
    return dict(step_ms=none_ms, profile_wall_ms=1e3 * wall, busy_ms=busy)


# ------------------------------------------------------- serve-admission --

def admission_lengths(seed):
    """The wave's prompt lengths from ``seed``: one in each bucket's range
    of the geometric set (within [len_lo, len_hi]), the rest log-uniform
    over [len_lo, len_hi], shuffled."""
    import numpy as np

    from repro_torch.serve.engine import geometric_buckets

    rng = np.random.default_rng(seed)
    lo, hi = ADMIT["len_lo"], ADMIT["len_hi"]
    out, prev = [], 0
    for b in geometric_buckets(SERVE["max_seq"]):
        a, z = max(lo, prev + 1), min(b, hi)
        if a <= z:
            out.append(int(rng.integers(a, z + 1)))
        prev = b
    while len(out) < ADMIT["requests"]:
        out.append(int(np.exp(rng.uniform(np.log(lo), np.log(hi + 1)))))
    rng.shuffle(out)
    return out


def _recording_engine():
    """A ServeEngine that keeps, per request, the logits row of each of its
    head projections (its greedy tokens' logits), on the card."""
    from repro_torch.serve.engine import ServeEngine

    class Recording(ServeEngine):
        _landing = None

        def _land(self, p, failed_group, src, src_rows):
            self._landing = p
            try:
                super()._land(p, failed_group, src, src_rows)
            finally:
                self._landing = None

        def _head_logits(self, h, mask, failed_group, ft_fn):
            logits = super()._head_logits(h, mask, failed_group, ft_fn)
            if self._landing is not None:
                reqs = [r for _, r in self._landing["reqs"]]
            else:
                reqs = [s and s["req"] for s in self.slots]
            for row, req in enumerate(reqs):
                if req is not None:
                    self.logits_by_rid.setdefault(req.rid, []).append(
                        logits[row].clone())
            return logits

    return Recording


def _admit_wave(eng, cfg, lengths, failed_group):
    """Serve the admission wave (seeded prompts of ``lengths``, all
    submitted at once); returns (tokens by rid, stats)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(len(lengths))
    reqs = [Request(rid=r, prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new=ADMIT["max_new"])
            for r, n in enumerate(lengths)]
    t0 = time.perf_counter()
    for rq in reqs:
        eng.submit(rq)
    # per step: ms, whether it ran a prefill call, and whether admission
    # was still pending (a request queued or mid-prefill) when it began
    steps = []
    while not eng.idle():
        before = eng.prefill_calls
        pending = bool(eng.queue or eng._inflight)
        t = time.perf_counter()
        eng.step(failed_group=failed_group)
        torch.cuda.synchronize()
        steps.append((1e3 * (time.perf_counter() - t),
                      eng.prefill_calls > before, pending))
        if len(steps) > 50 * ADMIT["requests"]:
            raise AssertionError("admission wave failed to drain")
    wall = time.perf_counter() - t0
    outs = {r.rid: np.asarray(r.out) for r in reqs}
    for rid, o in outs.items():
        if o.shape != (ADMIT["max_new"],) or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: bad output {o}")
    ttft = np.array([1e3 * (r.t_first - r.t_submit) for r in reqs])
    m = eng.metrics
    def mean(sel):
        ms = [t for t, pf, pend in steps if sel(pf, pend)]
        return float(np.mean(ms)) if ms else None

    stats = dict(
        steps=len(steps), admit_steps=sum(pf for _, pf, _ in steps),
        # steps that ran a prefill call; every step while admission was
        # pending; the steps after the last admission
        admit_step_ms=mean(lambda pf, pend: pf),
        during_step_ms=mean(lambda pf, pend: pend),
        after_step_ms=mean(lambda pf, pend: not pend),
        max_step_ms=max(t for t, _, _ in steps),
        step_ms=[round(t, 3) for t, _, _ in steps],
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p95_ms=float(np.percentile(ttft, 95)),
        tok_s=sum(len(o) for o in outs.values()) / wall, wall_s=wall,
        prefill_calls=eng.prefill_calls, decode_calls=eng.decode_calls,
        misses=eng.plans.misses if eng.plans is not None else 0,
        **{k: m[k] for k in ("refill_admissions", "landings",
                             "packed_tokens", "packed_calls",
                             "packed_batches_peak", "recycled",
                             "zero_flushes", "merged_zero_rows",
                             "merged_landings")},
        # a batched row copy or fill is one launch per cache tensor
        cache_tensors=sum(1 for _ in _leaves(eng.cache)))
    if stats["misses"]:
        raise AssertionError(f"compiled plans missed {stats['misses']} "
                             f"shapes")
    return outs, stats


def _mode_pair(a, b, name):
    """Tokens of two healthy admission modes (outs, logits by rid): how
    many agree, and the near-tie rule: per request, the logits of the
    shared prefix agree within LOGIT_TOL of the largest |logit| and the
    first differing token is a near-tie in both modes."""
    import numpy as np

    (oa, la), (ob, lb) = a, b
    agree = total = parted = 0
    worst = 0.0
    for rid in oa:
        ta, tb = oa[rid], ob[rid]
        total += len(ta)
        diff = np.nonzero(ta != tb)[0]
        upto = len(ta) if not len(diff) else diff[0] + 1
        agree += int((ta == tb).sum())
        for t in range(upto):
            xa, xb = la[rid][t].float(), lb[rid][t].float()
            scale = float(xa.abs().max())
            worst = max(worst, float((xa - xb).abs().max()) / scale)
        if len(diff):
            t = diff[0]
            xa, xb = la[rid][t].float(), lb[rid][t].float()
            ga = float(xa.max() - xa[int(tb[t])]) / abs(float(xa.max()))
            gb = float(xb.max() - xb[int(ta[t])]) / abs(float(xb.max()))
            if ga > NEAR_TIE or gb > NEAR_TIE:
                raise AssertionError(
                    f"{name}: request {rid} parts at token {t} ({ta[t]} vs "
                    f"{tb[t]}) with gaps {ga:.4f} / {gb:.4f} > near-tie "
                    f"{NEAR_TIE}")
            parted += 1
    if worst > LOGIT_TOL:
        raise AssertionError(f"{name}: shared-prefix logits differ by "
                             f"{worst:.4f} of the largest |logit| > "
                             f"{LOGIT_TOL}")
    return dict(agree=agree, total=total, parted_at_near_ties=parted,
                max_logit_diff=worst)


def _admission_drill(dev, cfg, params):
    """Once, chunked admission at scope all: a cancel in each state
    (queued, mid-prefill, decoding) and one deadline shed; the engine then
    serves another request and ends with every slot free and no plan
    miss."""
    import numpy as np

    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import DeadlineExceeded

    now = [0.0]
    eng = ServeEngine(cfg, ServeConfig(
        max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
        ft_mode="entangle", ft_M=SERVE["ft_M"], ft_scope="all",
        clock=lambda: now[0], **ADMIT_MODES["chunked"]), params, device=dev)
    rng = np.random.default_rng(1)

    def req(rid, n, **kw):
        return Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), max_new=ADMIT["max_new"], **kw)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"admission drill: {what}")

    hq = eng.submit(req(0, 20))
    hq.cancel()
    check(hq.status == "cancelled" and not eng.queue and list(hq) == [],
          "cancel while queued")
    hp = eng.submit(req(1, SERVE["max_seq"] - ADMIT["max_new"] - 8))
    eng.step()
    check(hp.status == "prefill", f"status {hp.status} after one chunk")
    hp.cancel()
    check(hp.status == "cancelled" and not eng._reserved,
          "cancel mid-prefill")
    hd = eng.submit(req(2, 20))
    while hd.status != "decoding":
        eng.step()
    eng.step()
    hd.cancel()
    check(hd.status == "cancelled"
          and 1 <= len(hd.req.out) < ADMIT["max_new"], "cancel decoding")
    hs = eng.submit(req(3, 20, deadline_ms=10.0))
    now[0] = 1.0
    pre = eng.prefill_calls
    eng.step()
    check(hs.status == "shed" and eng.prefill_calls == pre, "shed")
    try:
        list(hs)
        check(False, "a shed handle streamed without raising")
    except DeadlineExceeded:
        pass
    ok = eng.submit(req(4, 40))
    check(len(ok.result().out) == ADMIT["max_new"], "the next request")
    check(eng.idle() and all(s is None for s in eng.slots), "slots free")
    check(eng.metrics["cancelled"] == 3 and eng.metrics["shed"] == 1,
          f"metrics {eng.metrics}")
    check(eng.plans.misses == 0, "plan misses")
    log(f"[serve-admission] {cfg.name} drill: cancel queued / mid-prefill "
        f"/ decoding ({len(hd.req.out)} tokens kept) and one deadline shed "
        f"(DeadlineExceeded, no prefill spent); the next request served; "
        f"misses 0")
    del eng
    free_cuda()


def phase_serve_admission(dev, kernels, path_kernels, cfg, params, modes,
                          scopes, smi, seed, drill):
    """The rest of the serving engine on the card: per admission mode and
    scope, the 24-request wave healthy and with failed_group=1 (EXACT
    ROLL-FORWARD (serve-admission)), misses 0; the healthy modes compared
    pairwise (llama) under the near-tie rule; the drill once. Every
    kernel's count is set to 0 just before and read just after; each of
    ``path_kernels`` must have launched. Returns (counts, record)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    lengths = admission_lengths(seed)
    Recording = _recording_engine()
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    per, healthy = {}, {}
    for scope in scopes:
        for mode in modes:
            scfg = ServeConfig(max_batch=SERVE["max_batch"],
                               max_seq=SERVE["max_seq"], ft_mode="entangle",
                               ft_M=SERVE["ft_M"], ft_scope=scope,
                               **ADMIT_MODES[mode])
            eng = Recording(cfg, scfg, params, device=dev)
            eng.logits_by_rid = {}
            outs, st = _admit_wave(eng, cfg, lengths, None)
            healthy[scope, mode] = (outs, eng.logits_by_rid)
            # the injected wave runs on a warm replica of the healthy one:
            # its census, plans and quantized weights, none redone
            warm = eng.warm_state()
            del eng
            inj, st_i = _admit_wave(ServeEngine(cfg, scfg, params,
                                                device=dev, warm=warm),
                                    cfg, lengths, 1)
            del warm
            bad = sum(not np.array_equal(outs[r], inj[r]) for r in outs)
            verdict = ("EXACT ROLL-FORWARD (serve-admission)" if bad == 0
                       else "RECOVERY FAILED")
            log(f"[serve-admission] {cfg.name} mode={mode} scope={scope}: "
                f"failed_group=1 injected on every step; {len(outs)} "
                f"requests / {sum(len(v) for v in outs.values())} tokens "
                f"compared; mismatching requests: {bad} ({verdict}); "
                f"misses 0")
            if bad:
                raise AssertionError(f"{cfg.name} {mode} {scope}: {verdict}")
            per[f"{mode}/{scope}"] = dict(healthy=st, injected=st_i)
            log(f"[serve-admission] {cfg.name} mode={mode} scope={scope} "
                f"({smi}): {st['steps']} steps; mean step ms while "
                f"admitting {st['during_step_ms']}, after the last "
                f"admission {st['after_step_ms']}; with a prefill call "
                f"{st['admit_step_ms']} over {st['admit_steps']} steps "
                f"(max step {st['max_step_ms']:.3f}); TTFT p50 "
                f"{st['ttft_p50_ms']:.3f}"
                f" / p95 {st['ttft_p95_ms']:.3f} ms; {st['tok_s']:.2f} "
                f"tokens/s; prefill calls {st['prefill_calls']}, "
                f"refill_admissions {st['refill_admissions']}, landings "
                f"{st['landings']}, packed tokens per packed call "
                f"{st['packed_tokens'] / max(1, st['packed_calls']):.2f} "
                f"(peak {st['packed_batches_peak']} batches); recycled "
                f"{st['recycled']} slots: {st['zero_flushes']} batched "
                f"fills + {st['merged_zero_rows']} rows in "
                f"{st['merged_landings']} landing copies, i.e. "
                f"{(st['zero_flushes'] + st['merged_landings']) * st['cache_tensors']}"
                f" launches where one fill per recycled slot takes "
                f"{st['recycled'] * st['cache_tensors']}")
            free_cuda()
    pairs = {}
    for scope in scopes:
        for i, ma in enumerate(modes):
            for mb in modes[i + 1:]:
                name = f"{ma} vs {mb} scope={scope}"
                if cfg.moe:
                    # expert capacity is a function of a program's token
                    # count: modes of other program shapes drop other
                    # tokens, by design, so only the agreement is shown
                    oa, ob = healthy[scope, ma][0], healthy[scope, mb][0]
                    pairs[name] = dict(
                        agree=int(sum((oa[r] == ob[r]).sum() for r in oa)),
                        total=int(sum(len(v) for v in oa.values())),
                        rule="none (MoE capacity)")
                else:
                    pairs[name] = _mode_pair(healthy[scope, ma],
                                             healthy[scope, mb], name)
                log(f"[serve-admission] {cfg.name} {name}: "
                    f"{pairs[name]['agree']} of {pairs[name]['total']} "
                    f"tokens agree; {pairs[name]}")
    del healthy
    free_cuda()
    if drill:
        _admission_drill(dev, cfg, params)
    torch.cuda.synchronize()
    counts = {k["name"]: count(k) for k in kernels}
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    peak = torch.cuda.max_memory_allocated(dev)
    secs = time.perf_counter() - t0
    log(f"[serve-admission] {cfg.name} kernel launches over the path: "
        f"{counts}; CUDA-core GEMM route {core}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; {secs:.1f} s ({smi})")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"{cfg.name} serve-admission path")
    if any(core.values()):
        raise AssertionError(f"packed GEMMs reached the CUDA-core kernel: "
                             f"{core}")
    return counts, dict(lengths=lengths, modes=per, pairs=pairs,
                        max_memory_allocated=peak, seconds=secs)


# ------------------------------------------------------------------ train --

def _train_configs():
    """(model config, TrainConfig, DataConfig) of the training path: the
    entangled sync on the kernel codec, as ``examples/train_lm.py`` runs
    the reference's (with its codec flag set to the kernels)."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = model_config(LLAMA)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                          total_steps=TRAIN["steps"]),
        grad_sync="entangle", grad_codec="kernel", ft_M=TRAIN["ft_M"],
        max_seq=TRAIN["seq"])
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                      batch_size=TRAIN["batch"])
    return cfg, tcfg, dcfg


def _batch(dcfg, step, dev):
    import torch

    from repro_torch.data.synthetic import SyntheticLM

    return {k: torch.from_numpy(v).to(dev)
            for k, v in SyntheticLM(dcfg).batch(step).items()}


def phase_train(dev, kernels, path_kernels, n_params):
    """``train_loop`` on full-width llama3.2-1b: TRAIN["steps"] steps with
    block 1 of the entangled sync fail-stopped at TRAIN["fail_step"], then
    the final blocking checkpoint into a temporary directory (deleted
    afterwards). Every kernel's count is set to 0 just before and read just
    after; each of ``path_kernels`` must have launched, and the losses
    must be finite. Returns (state, counts, summary)."""
    import numpy as np
    import torch

    from repro_torch.train.trainer import LoopConfig, train_loop

    cfg, tcfg, dcfg = _train_configs()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    need = 3 * 4 * n_params  # float32 params and both moments
    free = shutil.disk_usage(ckpt_dir).free
    log(f"[train] {LLAMA} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.4f} G "
        f"params; batch {TRAIN['batch']} x seq {TRAIN['seq']}; grad_sync "
        f"entangle (M={tcfg.ft_M}), codec {tcfg.grad_codec}; fail-stop of "
        f"block 1 at step {TRAIN['fail_step']}; checkpoint "
        f"{need / 1e9:.2f} GB into {ckpt_dir} ({free / 1e9:.1f} GB free)")
    if free < 1.1 * need:
        raise RuntimeError(f"the disk under {ckpt_dir} cannot hold the "
                           f"{need / 1e9:.2f} GB checkpoint")
    loop = LoopConfig(total_steps=TRAIN["steps"],
                      ckpt_every=TRAIN["steps"] + 1, ckpt_dir=ckpt_dir,
                      log_every=1, fail_block_at_step=TRAIN["fail_step"])
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        state, losses = train_loop(cfg, tcfg, dcfg, loop, log=log,
                                   device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k["name"]: count(k) for k in kernels}
        files = list(pathlib.Path(ckpt_dir).rglob("*.npy"))
        ckpt_bytes = sum(f.stat().st_size for f in files)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {n: c / TRAIN["steps"] for n, c in counts.items()}
    log(f"[train] train_loop: {TRAIN['steps']} steps + final checkpoint in "
        f"{secs:.1f} s; losses {[float(x) for x in losses]}; kernel "
        f"launches {counts} ({per_step} per step); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; checkpoint {len(files)} leaves, "
        f"{ckpt_bytes / 1e9:.3f} GB on disk (deleted)")
    if len(losses) != TRAIN["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"training losses bad: {losses}")
    if ckpt_bytes < need:
        raise AssertionError(f"the checkpoint holds {ckpt_bytes} bytes, "
                             f"less than the state's {need}")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"training path")
    return state, counts, dict(loop_s=secs, losses=[float(x) for x in losses],
                               peak_gib=peak / 2**30,
                               launches_per_step=per_step)


def train_rollforward(dev, state):
    """EXACT ROLL-FORWARD (train): ONE backward at full width (two
    backwards need not agree bit for bit: the embedding's backward
    accumulates with atomics), its gradients synced healthy and with each
    block failed; every synced leaf must be bit-identical, the kernel codec
    must equal the plain codec, and the AdamW update from the healthy and
    the failed sync must give the same state."""
    import dataclasses as dc

    import torch

    from repro_torch.train.train_step import (apply_grads, loss_and_grads,
                                              sync_grads)
    from repro_torch.tree import leaves

    cfg, tcfg, dcfg = _train_configs()
    batch = _batch(dcfg, TRAIN["steps"], dev)
    loss, grads = loss_and_grads(cfg, state["params"], batch)
    with torch.no_grad():
        healthy, _ = sync_grads(grads, tcfg)
        plain, _ = sync_grads(grads, dc.replace(tcfg, grad_codec="plain"))
        n = len(leaves(healthy))
        bad = sum(not torch.equal(a, b)
                  for a, b in zip(leaves(healthy), leaves(plain)))
        del plain
        if bad:
            raise AssertionError(f"kernel codec != plain codec on {bad} of "
                                 f"{n} synced leaves")
        failed1 = None
        for fb in range(tcfg.ft_M):
            synced, diag = sync_grads(grads, tcfg, fb)
            bad = sum(not torch.equal(a, b)
                      for a, b in zip(leaves(healthy), leaves(synced)))
            if bad or diag["ne_failed"] != fb:
                raise AssertionError(f"failed block {fb}: {bad} of {n} "
                                     f"synced leaves differ (RECOVERY "
                                     f"FAILED)")
            if fb == 1:
                failed1 = synced
            del synced
        del grads
    new_h = apply_grads(state, healthy, cfg, tcfg)
    new_f = apply_grads(state, failed1, cfg, tcfg)
    bad = sum(not torch.equal(a, b)
              for a, b in zip(leaves(new_h), leaves(new_f)))
    del new_h, new_f, healthy, failed1
    free_cuda()
    if bad:
        raise AssertionError(f"updated state differs on {bad} leaves")
    log(f"[train] {LLAMA} recovery summary: one backward (loss "
        f"{loss.item():.4f}), {n} gradient leaves synced healthy and with "
        f"failed_block 0, 1, 2, 3 on the kernel codec: every synced leaf "
        f"bit-identical, kernel codec == plain codec, AdamW update from "
        f"block 1 failed == healthy (EXACT ROLL-FORWARD (train))")


def train_timings(dev, state):
    """Mean train-step time per gradient sync (host clock around steps
    that end in a synchronize, after TRAIN["warm_steps"] each), then the
    device time of one entangled sync on the kernel codec and the device
    idle share of one such step, from profiler windows."""
    import dataclasses as dc

    import torch

    from repro_torch.train.train_step import (loss_and_grads, make_train_step,
                                              sync_grads)

    cfg, tcfg, dcfg = _train_configs()
    batch = _batch(dcfg, 0, dev)
    out = {}
    for sync, codec in (("spmd", "plain"), ("entangle", "plain"),
                        ("entangle", "kernel"), ("checksum", "plain")):
        step = make_train_step(cfg, dc.replace(tcfg, grad_sync=sync,
                                               grad_codec=codec))
        for _ in range(TRAIN["warm_steps"]):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(TRAIN["timed_steps"]):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        key = sync if sync != "entangle" else f"entangle/{codec}"
        out[key] = 1e3 * sum(times) / len(times)
        log(f"[train] step time, grad_sync {key}: mean "
            f"{out[key]:.3f} ms over {len(times)} steps "
            f"({', '.join(f'{1e3 * t:.3f}' for t in times)} ms)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def busy(prof, match=None):
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (match is None or match in e.key)) / 1e3

    def count(prof, match):
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and match in e.key)

    _, grads = loss_and_grads(cfg, state["params"], batch)
    torch.cuda.synchronize()
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        sync_grads(grads, tcfg)
        torch.cuda.synchronize()
    out["sync_device_ms"] = busy(prof)
    out["sync_codec_kernels_ms"] = busy(prof, "::entangle_kernel<") + busy(
        prof, "::disentangle_kernel<")
    # a trace can lose events: the sync launches one entangle and one
    # disentangle per gradient leaf, so their counts show whether it did
    out["sync_codec_launches_traced"] = (count(prof, "::entangle_kernel<"),
                                         count(prof, "::disentangle_kernel<"))
    del grads
    step = make_train_step(cfg, tcfg)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    out["step_wall_ms"], out["step_busy_ms"] = wall, busy(prof)
    out["step_codec_launches_traced"] = (
        count(prof, "::entangle_kernel<"),
        count(prof, "::disentangle_kernel<"))
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    log(f"[profile] one entangled sync (kernel codec) of the full-width "
        f"gradients: device {out['sync_device_ms']:.3f} ms, of which the "
        f"entangle + disentangle kernels {out['sync_codec_kernels_ms']:.3f} "
        f"ms (traced launches {out['sync_codec_launches_traced']})")
    log(f"[profile] one train step (entangle/kernel) under the profiler: "
        f"wall {wall:.3f} ms, device busy {out['step_busy_ms']:.3f} ms (idle "
        f"{100 - 100 * out['step_busy_ms'] / wall:.1f}% of the profiled wall, "
        f"{100 - 100 * out['step_busy_ms'] / out['entangle/kernel']:.1f}% of "
        f"the unprofiled mean step; traced codec launches "
        f"{out['step_codec_launches_traced']})")
    for dev_us, key, count in rows[:10]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:160]}")
    del state
    free_cuda()
    return out


def codec_timings(dev):
    """The entangle and disentangle kernels, their plain versions and their
    bounds at the largest gradient leaf of full-width llama3.2-1b (an MLP
    gate / up stack, 16 x 2048 x 8192 words, as the sync's [4, n/4]
    blocks); device time from a CUDA graph's replay and, for the kernel,
    per launch from a profiler trace. The bound counts each input byte read
    once and each output byte written once: the entangle reads all M rows,
    the disentangle M-1 of them."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import disentangle as kdis
    from repro_torch.kernels import entangle as kent

    cfg = model_config(LLAMA)
    plan = make_plan(TRAIN["ft_M"], 32)
    M, n = plan.M, cfg.n_layers * cfg.d_model * cfg.d_ff // plan.M
    gen = torch.Generator(device=dev).manual_seed(17)
    c = _rand(gen, -2**31, 2**31, (M, n), dev)
    eps = kent.entangle_cuda(c, plan)
    rows = {}
    for name, kern, plain, match, nbytes in (
            ("entangle", lambda i: kent.entangle_cuda(c, plan),
             lambda i: kent.entangle_plain(c, plan), "::entangle_kernel<",
             2 * M * n * 4),
            ("disentangle", lambda i: kdis.disentangle_cuda(eps, plan, 1),
             lambda i: kdis.disentangle_plain(eps, plan, 1),
             "::disentangle_kernel<", (2 * M - 1) * n * 4)):
        ms = _graph_ms(kern, 20)
        traced_ms = _device_ms(kern, 20, match=match, per=match)
        plain_ms = _graph_ms(plain, 5)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        rows[name] = dict(shape=[M, n], ms=ms, kernel_only_ms=traced_ms,
                          plain_ms=plain_ms,
                          bound_ms=bound, bound_by="bytes", bytes=nbytes,
                          gb_s=nbytes / ms / 1e6)
        log(f"[timing] {name} [{M}, {n}] int32 (plan M={M}, l={plan.l}, "
            f"{plan.temp}{', r=1' if name == 'disentangle' else ''}): "
            f"kernel {ms:.4f} ms ({rows[name]['gb_s']:.0f} GB/s; per traced "
            f"launch {_ms(traced_ms)}), plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes: "
            f"{nbytes / 1e9:.3f} GB at 3.35 TB/s), {ms / bound:.2f}x bound; "
            f"no single PyTorch call computes this function")
    del c, eps
    free_cuda()
    return rows


# ----------------------------------------------------------- stream conv --

def check_conv(dev, checkers):
    """The plain and the entangled conv kernels and the checksum kernel
    against their plain versions on full-range int32 words: ragged small
    shapes at K_f = 1, 2, 4, 100 and 4500 under every plan (M = 3..8,
    dual-word at w=32, int32 at w=16), both modes, packed and unpacked taps,
    every failed stream, plus the poison check; the depthwise model shape
    [M=4, B=8, D=8192, T=512], K_f = 4 (the Mamba conv1d of
    falcon-mamba-7b) under the int32 and the dual-word plan; the checksum
    at ragged widths for M = 1..9."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import checksum as kcks
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels.codec import pack_int8

    chk_c, chk_e = checkers["conv1d_causal"], checkers["entangled_conv1d"]
    chk_s = checkers["checksum"]
    gen = torch.Generator(device=dev).manual_seed(2024)
    n0 = (chk_c.n, chk_e.n, chk_s.n)
    for (B, D, T, kf) in CONV_SHAPES:
        x = _rand(gen, -2**31, 2**31, (B, D, T), dev)
        w = _rand(gen, -2**31, 2**31, (D, kf), dev)
        chk_c.equal(kconv.conv1d_causal_cuda(x, w),
                    kconv.conv1d_causal_plain(x, w),
                    f"conv1d [{B},{D},{T}] K_f={kf}")
    for plan in _all_plans():
        for (B, D, T, kf) in CONV_SHAPES:
            x = _rand(gen, -2**31, 2**31, (plan.M, B, D, T), dev)
            w32 = _rand(gen, -2**31, 2**31, (D, kf), dev)
            wp = pack_int8(_rand(gen, -128, 128, (D, kf), dev), axis=0)
            what = (f"plan(M={plan.M},l={plan.l},{plan.temp}) [{B},{D},{T}] "
                    f"K_f={kf}")
            for packed, w in ((False, w32), (True, wp)):
                chk_e.sweep(x, w, plan, packed, what, GROUPED_MODES)
            chk_e.poison(x, wp, plan, True, what)
    log(f"[kernels] conv1d_causal / entangled_conv1d ragged shapes (K_f "
        f"{sorted({s[3] for s in CONV_SHAPES})}): {chk_c.n - n0[0]} / "
        f"{chk_e.n - n0[1]} kernel-vs-plain comparisons bit-identical; poison "
        f"check passed")
    n0 = (chk_c.n, chk_e.n)
    B, D, T, kf = DEPTHWISE
    x = _rand(gen, -2**31, 2**31, (4, B, D, T), dev)
    w = _rand(gen, -2**31, 2**31, (D, kf), dev)
    chk_c.equal(kconv.conv1d_causal_cuda(x[0], w),
                kconv.conv1d_causal_plain(x[0], w), f"conv1d {DEPTHWISE}")
    wp = pack_int8(_rand(gen, -128, 128, (D, kf), dev), axis=0)
    for plan in (make_plan(4, 32), make_plan(4, 16)):
        what = f"depthwise [4, {B}, {D}, {T}] K_f={kf} plan {plan.temp}"
        for packed, ww in ((False, w), (True, wp)):
            chk_e.sweep(x, ww, plan, packed, what, GROUPED_MODES)
        chk_e.poison(x, wp, plan, True, what)
    del x, w, wp
    free_cuda()
    log(f"[kernels] depthwise model shape [4, {B}, {D}, {T}], K_f = {kf}: "
        f"{chk_c.n - n0[0]} / {chk_e.n - n0[1]} comparisons bit-identical; "
        f"poison check passed")
    n0 = chk_s.n
    for m in range(1, 10):
        for n in (1, 3, 1031, 65537):
            c = _rand(gen, -2**31, 2**31, (m, n), dev)
            chk_s.equal(kcks.checksum_cuda(c), kcks.checksum_plain(c),
                        f"checksum [{m},{n}]")
    log(f"[kernels] checksum ragged widths, M = 1..9: {chk_s.n - n0} "
        f"comparisons bit-identical")


def stream_inputs(dev):
    """{(M, K): (c [M, N_in], g [K])} of the stream-conv configuration at
    M in STREAM_MS: int32 samples within the eq. (13) budget as
    ``benchmarks/fig2_conv_throughput.py`` sizes them (|c| below
    max_output_magnitude // (4 K_max) - 1, capped at 4096) and taps in
    [-4, 4), from a seeded generator."""
    import torch

    from repro_torch.configs.stream_conv import CONFIG
    from repro_torch.core.plan import make_plan

    out = {}
    for M in STREAM_MS:
        plan = make_plan(M, CONFIG.w)
        lim = min(max(plan.max_output_magnitude
                      // (max(CONFIG.kernel_sizes) * 4) - 1, 2), 1 << 12)
        gen = torch.Generator(device=dev).manual_seed(M)
        c = _rand(gen, -lim, lim, (M, CONFIG.n_in), dev)
        for K in CONFIG.kernel_sizes:
            out[(M, K)] = (c, _rand(gen, -4, 4, (K,), dev))
        log(f"[stream-conv] M={M}: {CONFIG.n_in} int32 samples per stream in "
            f"[-{lim}, {lim}), taps in [-4, 4); plan l={plan.l}, "
            f"{plan.temp}, max_output_magnitude {plan.max_output_magnitude}")
    return out


def _padded(c, K):
    """The streams as the full conv's causal input [S, T]: K - 1 zeros on
    the right (T = N_in + K - 1)."""
    import torch

    return torch.nn.functional.pad(c, (0, K - 1))


def check_stream_shapes(dev, checkers, inputs):
    """Each conv kernel against its plain version at the stream-conv shapes
    (not counted as the path's launches): the conv over the M streams and
    over the M+1 of the checksum family, the entangled conv over [M, 1, 1,
    T] unfused and fused for every failed stream (the plain fused version is
    the plain unfused one disentangled, computed once), the checksum of the
    M streams. Returns {(M, K): the true conv outputs [M, T]}, the plain
    version's."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import checksum as kcks
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import entangled_conv1d as kecv
    from repro_torch.kernels.codec import disentangle_block

    chk_c, chk_e = checkers["conv1d_causal"], checkers["entangled_conv1d"]
    chk_s = checkers["checksum"]
    truth = {}
    n0 = (chk_c.n, chk_e.n, chk_s.n)
    t0 = time.perf_counter()
    for (M, K), (c, g) in inputs.items():
        plan = make_plan(M, 32)
        taps = torch.flip(g, (0,))[None]
        cs = torch.cat([c, kcks.checksum_plain(c)[None]])
        xs = _padded(cs, K)[:, None]
        chk_s.equal(kcks.checksum_cuda(c), cs[M], f"checksum [{M},{c.shape[1]}]")
        want = kconv.conv1d_causal_plain(xs, taps)
        what = f"stream conv M={M} K={K}"
        chk_c.equal(kconv.conv1d_causal_cuda(xs, taps), want, what + " (M+1)")
        chk_c.equal(kconv.conv1d_causal_cuda(xs[:M].contiguous(), taps),
                    want[:M], what)
        truth[(M, K)] = want[:M, 0]
        x4 = xs[:M, None].contiguous()
        delta = kecv.entangled_conv1d_plain(x4, taps, plan)
        chk_e.equal(kecv.entangled_conv1d_cuda(x4, taps, plan), delta,
                    what + " entangled")
        for r in range(M):
            chk_e.equal(kecv.entangled_conv1d_cuda(
                x4, taps, plan, fuse_epilogue=True, failed=r),
                disentangle_block(delta, plan, r), f"{what} fused r={r}")
        del cs, xs, want, x4, delta
        free_cuda()
    log(f"[kernels] stream-conv shapes (M {STREAM_MS} x K "
        f"{sorted({k for _, k in inputs})}, T = N_in + K - 1): "
        f"{chk_c.n - n0[0]} / {chk_e.n - n0[1]} / {chk_s.n - n0[2]} conv / "
        f"entangled conv / checksum comparisons bit-identical "
        f"({time.perf_counter() - t0:.1f} s)")
    return truth


FAMILIES = ("none", "entangle", "checksum", "mr")


def _failures(mode, M):
    return [None] + list(range(M + (mode == "checksum")))


def _protected_all(op, c, g, M, want, what):
    """run_protected(op) under every family and failed stream: each
    recovery equals ``want``, and ``none`` under a failure gives ``want``
    with the failed stream poisoned and recovered=False. Returns the number
    of runs."""
    import torch

    from repro_torch.core.failstop import GARBAGE, FTConfig, run_protected

    n = 0
    for mode in FAMILIES:
        for failed in _failures(mode, M):
            out, rep = run_protected(op, c, g, FTConfig(mode=mode, M=M),
                                     failed=failed)
            n += 1
            if mode == "none" and failed is not None:
                ok = (not rep.recovered and bool((out[failed] == GARBAGE).all())
                      and torch.equal(torch.cat([out[:failed],
                                                 out[failed + 1:]]),
                                      torch.cat([want[:failed],
                                                 want[failed + 1:]])))
            else:
                ok = rep.recovered and torch.equal(out, want)
            if not ok:
                raise AssertionError(f"{what}: family {mode}, failed stream "
                                     f"{failed}: RECOVERY FAILED")
    return n


def _other_ops(dev, M):
    """The other LSB ops at ``examples/failstop_demo.py``'s stream length
    2^16 (circconv at 4096: the reference's builds an [N, N] index matrix),
    its value ranges, seeded: {op: (c, g)} on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(M)
    n = 1 << 16
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)  # noqa: E731
    c = t(rng.integers(-50, 50, size=(M, n)).astype(np.int32))
    return {
        "scale": (c, t(np.int32(9))), "add": (c, t(np.int32(-3))),
        "sub": (c, t(np.int32(7))),
        "dot": (c, t(rng.integers(-4, 4, (n,)).astype(np.int32))),
        "outer": (c, t(rng.integers(-4, 4, (7,)).astype(np.int32))),
        "xcorr": (c, t(rng.integers(-10, 10, (33,)).astype(np.int32))),
        "circconv": (c[:, :4096].contiguous(),
                     t(rng.integers(-4, 4, (33,)).astype(np.int32))),
        "permute": (c, t(rng.permutation(n))), "identity": (c, None)}


def phase_stream_conv(dev, kernels, path_kernels, inputs, truth):
    """The stream-conv path: the paper's Fig. 2 configuration through the
    fail-stop engine. Per (M, K): ``run_protected("conv", ...)`` under every
    family and failed stream, and the fused entangled conv of the op API
    for every failed stream, each equal to the failure-intolerant conv bit
    for bit (EXACT ROLL-FORWARD (stream conv)); then every other LSB op
    under every family and failed stream at the demo's size, its
    failure-intolerant output equal to the plain versions' on the CPU.
    Every kernel's count is set to 0 just before and read just after; each
    of ``path_kernels`` must have launched. Returns the counts."""
    import torch

    from repro_torch.core.failstop import FTConfig, run_protected
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import ops

    reset_counts(kernels)
    t0 = time.perf_counter()
    for (M, K), (c, g) in inputs.items():
        want = truth[(M, K)]
        runs = _protected_all("conv", c, g, M, want, f"conv M={M} K={K}")
        plan = make_plan(M, 32)
        x4 = _padded(c, K)[:, None, None]
        taps = torch.flip(g, (0,))[None]
        for r in range(M):
            out = ops.entangled_conv1d(x4, taps, plan, fuse_epilogue=True,
                                       failed=r)
            if not torch.equal(out[:, 0, 0], want):
                raise AssertionError(f"fused entangled conv M={M} K={K} "
                                     f"failed={r}: RECOVERY FAILED")
        log(f"[stream-conv] M={M} K={K}: run_protected('conv') under "
            f"{'/'.join(FAMILIES)} with every failed stream ({runs} runs) and "
            f"the fused entangled conv with each of the {M} streams failed "
            f"== the failure-intolerant conv [{M}, {want.shape[1]}] bit for "
            f"bit (EXACT ROLL-FORWARD (stream conv))")
    conv_s = time.perf_counter() - t0
    for M in STREAM_MS:
        runs = 0
        others = _other_ops(dev, M)
        for op, (c, g) in others.items():
            want, _ = run_protected(op, c, g, FTConfig(mode="none", M=M))
            ref, _ = run_protected(op, c.cpu(), None if g is None else g.cpu(),
                                   FTConfig(mode="none", M=M))
            if not torch.equal(want.cpu(), ref):
                raise AssertionError(f"{op} M={M}: card != plain versions "
                                     f"on the CPU")
            runs += _protected_all(op, c, g, M, want, f"{op} M={M}")
        log(f"[stream-conv] M={M}: the other {len(others)} LSB "
            f"ops under every family and failed stream ({runs} runs) recover "
            f"exactly; failure-intolerant outputs == the plain versions' on "
            f"the CPU")
    torch.cuda.synchronize()
    counts = {k["name"]: count(k) for k in kernels}
    log(f"[stream-conv] kernel launches on the path: {counts}; conv part "
        f"{conv_s:.1f} s, all {time.perf_counter() - t0:.1f} s")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"stream-conv path")
    return counts


def _pct(t, base):
    return 100 * (t / base - 1)


def _int32_macs_per_s(dev):
    """The card's peak int32 multiply-add rate (CUDA cores)."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * INT32_LANES_PER_SM * BOOST_HZ


def _causal_macs(T, K):
    """Multiply-adds of one causal conv row of length T with K taps: the
    K(K-1)/2 products that fall on the implicit left zero padding are not
    part of the work."""
    return T * K - K * (K - 1) // 2


def stream_timings(dev, inputs):
    """Fig. 2 on the card: per (M, K), the device time of one call (CUDA
    graph replay) of the failure-intolerant conv (``run_protected`` mode
    none) and of each protected family without a failure, as the paper
    measures them: the entangled three-pass (entangle kernel + conv +
    disentangle kernel), the fused entangled conv of the op API (M-1
    streams computed), the checksum family (sum kernel + conv over M+1
    streams) and dual modular redundancy (2M streams); the entangle and
    checksum families again with stream 1 failed (poison and recovery
    included); and the conv kernel alone against its MAC bound. Returns
    (table rows, summary)."""
    import torch

    from repro_torch.core.failstop import FTConfig, run_protected
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import ops

    mac_s = _int32_macs_per_s(dev)
    table = []
    for (M, K), (c, g) in inputs.items():
        plan = make_plan(M, 32)
        x3 = _padded(c, K)[:, None]
        taps = torch.flip(g, (0,))[None]
        T = x3.shape[-1]
        iters = 20 if K <= 1000 else 8

        def prot(mode, failed=None):
            cfg = FTConfig(mode=mode, M=M)
            return lambda i: run_protected("conv", c, g, cfg, failed=failed)

        fns = dict(
            conventional=prot("none"), entangle=prot("entangle"),
            fused=lambda i: ops.entangled_conv1d(
                _padded(c, K)[:, None, None], taps, plan, fuse_epilogue=True),
            checksum=prot("checksum"), mr=prot("mr"),
            entangle_failed=prot("entangle", 1),
            checksum_failed=prot("checksum", 1),
            conv_kernel=lambda i: ops.conv1d_causal(x3, taps))
        row = dict(M=M, K=K, T=T, **{f"{n}_ms": _graph_ms(fn, iters)
                                     for n, fn in fns.items()})
        row["conv_bound_ms"] = 1e3 * M * _causal_macs(T, K) / mac_s
        base = row["conventional_ms"]
        for n in fns:
            if n not in ("conventional", "conv_kernel"):
                row[f"{n}_pct"] = _pct(row[f"{n}_ms"], base)
        table.append(row)
        log(f"[fig2] M={M} K={K}: conventional {base:.4f} ms (conv kernel "
            f"{row['conv_kernel_ms']:.4f} ms, MAC bound "
            f"{row['conv_bound_ms']:.4f} ms); entangle three-pass "
            f"{row['entangle_ms']:.4f} ms ({row['entangle_pct']:+.2f}%), "
            f"fused {row['fused_ms']:.4f} ms ({row['fused_pct']:+.2f}%), "
            f"checksum {row['checksum_ms']:.4f} ms "
            f"({row['checksum_pct']:+.2f}%), mr {row['mr_ms']:.4f} ms "
            f"({row['mr_pct']:+.2f}%); with stream 1 failed: entangle "
            f"{row['entangle_failed_pct']:+.2f}%, checksum "
            f"{row['checksum_failed_pct']:+.2f}%")
    mean = lambda key: sum(r[key] for r in table) / len(table)  # noqa: E731
    summary = {k: mean(k) for k in (
        "entangle_pct", "fused_pct", "checksum_pct", "mr_pct",
        "entangle_failed_pct", "checksum_failed_pct")}
    summary["checksum_over_entangle"] = (
        summary["checksum_pct"] / summary["entangle_pct"]
        if summary["entangle_pct"] else None)
    ratio = summary["checksum_over_entangle"]
    log(f"[fig2] fig2_summary: mean_entangle_pct="
        f"{summary['entangle_pct']:.2f}; mean_fused_pct="
        f"{summary['fused_pct']:.2f}; mean_checksum_pct="
        f"{summary['checksum_pct']:.2f}; mean_mr_pct="
        f"{summary['mr_pct']:.2f}; ratio="
        f"{'n/a' if ratio is None else f'{ratio:.1f}x'} (paper: entangle "
        f"1.8-2.8%, checksum 9-14x more); with stream 1 failed: entangle "
        f"{summary['entangle_failed_pct']:.2f}%, checksum "
        f"{summary['checksum_failed_pct']:.2f}%")
    return table, summary


def stream_kernel_rows(dev, inputs):
    """Kernel, plain version, bound and library call of the three new
    kernels: first at the largest stream-conv shape (M = 8, K = 4500) — the
    conv over [8, 1, T], the fused entangled conv over [8, 1, 1, T] with
    stream 1 failed (M-1 streams computed), the checksum of [8, N_in]
    (inputs rotated through copies that exceed the L2) — then both convs at
    the depthwise model shape. The conv's library call is
    ``torch.nn.functional.conv1d`` in float64 on the left-padded input
    (exact below 2^53, as the paper's IPP ippsConv_64f baseline; depthwise:
    ``groups=D``), held equal to the kernel; the checksum's is
    ``torch.sum(c, 0, dtype=torch.int32)``. Returns {kernel: [rows]}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import checksum as kcks
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import entangled_conv1d as kecv

    mac_s = _int32_macs_per_s(dev)
    M, K = max(inputs)
    c, g = inputs[(M, K)]
    plan = make_plan(M, 32)
    x = _padded(c, K)[:, None].contiguous()
    taps = torch.flip(g, (0,))[None].contiguous()
    T = x.shape[-1]
    # the checksum's input rotates through copies that exceed the L2, as
    # the path finds it cold
    cs = [c.clone() for _ in range(-(-2 * L2_BYTES // (4 * c.numel())))]
    B, D, Td, kf = DEPTHWISE
    gen = torch.Generator(device=dev).manual_seed(5)
    xdw = _rand(gen, -2**31, 2**31, (4, B, D, Td), dev)
    wdw = _rand(gen, -2**31, 2**31, (D, kf), dev)
    lim = 2**13  # depthwise inputs whose conv fits int32 (float64 compares)
    xdl = _rand(gen, -lim, lim, (B, D, Td), dev)
    wdl = _rand(gen, -lim, lim, (D, kf), dev)

    def lib_conv(xx, ww):
        """float64 conv1d on the left-padded input, checked against the
        kernel; returns the call to time."""
        xd = F.pad(xx.double(), (ww.shape[1] - 1, 0))
        wd = ww.double()[:, None]
        call = lambda i: F.conv1d(xd, wd, groups=ww.shape[0])  # noqa: E731
        if not torch.equal(call(0).to(torch.int64),
                           kconv.conv1d_causal_cuda(xx, ww).to(torch.int64)):
            raise AssertionError("float64 conv1d != conv kernel")
        return call

    def econv(xx, ww, pl):
        """(kernel, plain) calls of the fused entangled conv, stream 1
        failed."""
        kw = dict(fuse_epilogue=True, failed=1)
        return (lambda i: kecv.entangled_conv1d_cuda(xx, ww, pl, **kw),
                lambda i: kecv.entangled_conv1d_plain(xx, ww, pl, **kw))
    cases = [
        ("conv1d_causal", [list(x.shape), list(taps.shape)],
         lambda i: kconv.conv1d_causal_cuda(x, taps),
         lambda i: kconv.conv1d_causal_plain(x, taps), lib_conv(x, taps),
         M * _causal_macs(T, K), 4 * (2 * M * T + K)),
        ("entangled_conv1d", [[M, 1, 1, T], list(taps.shape)],
         *econv(x[:, None], taps, plan), None,
         (M - 1) * _causal_macs(T, K), 4 * (2 * M * T + K)),
        ("checksum", [list(c.shape)],
         lambda i: kcks.checksum_cuda(cs[i % len(cs)]),
         lambda i: kcks.checksum_plain(cs[i % len(cs)]),
         lambda i: torch.sum(cs[i % len(cs)], 0, dtype=torch.int32), 0,
         4 * (M + 1) * c.shape[1]),
        ("conv1d_causal", [[B, D, Td], [D, kf]],
         lambda i: kconv.conv1d_causal_cuda(xdl, wdl),
         lambda i: kconv.conv1d_causal_plain(xdl, wdl), lib_conv(xdl, wdl),
         B * D * _causal_macs(Td, kf), 4 * (2 * B * D * Td + D * kf)),
        ("entangled_conv1d", [[4, B, D, Td], [D, kf]],
         *econv(xdw, wdw, make_plan(4, 32)), None,
         3 * B * D * _causal_macs(Td, kf),
         4 * (2 * 4 * B * D * Td + D * kf))]
    rows = {}
    for name, shape, kern, plain, lib, macs, nbytes in cases:
        big = macs > 1e10  # the stream-conv filters: few, long calls
        ms = _graph_ms(kern, 10 if big else 50)
        plain_ms = _graph_ms(plain, 1 if big else 10)
        lib_ms = None if lib is None else _graph_ms(lib, 3 if big else 10)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * macs / mac_s
        row = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes_ms=t_bytes, ops_ms=t_ops)
        rows.setdefault(name, []).append(row)
        log(f"[timing] {name} {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
            f"{t_bytes:.4f} ms, int32 MACs {t_ops:.4f} ms), "
            f"{ms / row['bound_ms']:.2f}x bound")
    del cases, x, cs, xdw, wdw, xdl, wdl
    free_cuda()
    return rows


def run_stream_conv(dev, kernels):
    """The stream-conv path: kernel checks (ragged, depthwise and the
    stream shapes), the path itself, and its Fig. 2 timings."""
    t0 = time.perf_counter()
    by_name = {k["name"]: k["checker"] for k in kernels}
    check_conv(dev, by_name)
    inputs = stream_inputs(dev)
    truth = check_stream_shapes(dev, by_name, inputs)
    counts = phase_stream_conv(
        dev, kernels, ["conv1d_causal", "entangled_conv1d", "checksum",
                       "entangle", "disentangle"], inputs, truth)
    del truth
    free_cuda()
    table, summary = stream_timings(dev, inputs)
    rows = stream_kernel_rows(dev, inputs)
    del inputs
    free_cuda()
    log(f"[stream-conv] checks, path and timings: "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(counts=counts, fig2=table, fig2_summary=summary, rows=rows)


# ---------------------------------------------------------------- timings --

def _device_ms(fn, iters, match=None, per=None):
    """Mean device time of ``fn(i)`` in ms (None when the trace recorded
    no matching event): the summed duration of the
    device-side events (kernels, fills, copies) that ``iters`` calls
    launch, from a ``torch.profiler`` trace — the host's launch gaps
    between calls are not counted. ``match`` keeps only events whose name
    contains it (the hand-written kernel alone). ``per`` names an event
    that each call launches exactly once (the hand-written kernel): the sum
    is then divided by that event's recorded count, not by ``iters``,
    because a trace can lose events (one run recorded 14 of 20 launches of
    a kernel), and a lost launch would otherwise read as a faster one."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events
             if match is None or match in e.key)
    if us <= 0:  # a trace that lost every event measures nothing
        log(f"[timing] not measured: the profiler recorded no device time "
            f"matching {match!r} among {[e.key for e in events]}")
        return None
    if per is None:
        return us / 1e3 / iters
    calls = sum(e.count for e in events if per in e.key)
    if calls != iters:
        log(f"[timing] the trace holds {calls} of {iters} launches of "
            f"{per!r}; the mean is taken over the recorded ones")
    return us / 1e3 / calls


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def _graph_ms(fn, iters):
    """Mean device time of ``fn(i)`` in ms: ``iters`` calls captured in one
    CUDA graph (after warm-up on a side stream, as capture requires), one
    replay timed between CUDA events. Every launch is counted (a trace can
    lose some, see :func:`_device_ms`) and the host's launch gaps are not
    (a replay issues the whole graph at once), so it measures the plain
    versions' many small ops and the kernels alike."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    free_cuda()
    return start.elapsed_time(end) / iters


def _timing_row(dev, site, c, gs, plan, fns, plain_fn, macs, nbytes,
                wbytes, iters):
    """Both GEMM kernels (``fns``: route -> launch function), the plain
    version and the bounds of one shape; ``gs`` holds enough weight copies
    to exceed the L2. The kernels are timed in turns (CUDA-core, s8, s8,
    CUDA-core) in one call. Bounds: the bytes (each input read once, the
    output written once, at 3.35 TB/s); the CUDA-core kernel's int32 MACs
    of the M-1 computed streams; the s8 kernel's 4 limb MACs per int32
    MAC at 1,979 TOP/s (2 operations per MAC)."""
    kw = dict(fuse_epilogue=True, failed=1, packed=True)
    copies = len(gs)

    def kernel(fn):
        return lambda i: fn(c, gs[i % copies], plan, **kw)

    times = {route: [] for route in fns}
    for route in ("cuda_core", "s8", "s8", "cuda_core"):
        times[route].append(_graph_ms(kernel(fns[route]), iters))
    # the kernel alone from a trace ("emm_kernel" matches both kernels'
    # names; a window runs one route)
    alone = {route: _device_ms(kernel(fns[route]), iters, match="emm_kernel",
                               per=name)
             for route, name in (("s8", "emm_kernel_s8<"),
                                 ("cuda_core", "emm_kernel<"))}
    plain_ms = _graph_ms(lambda i: plain_fn(c, gs[i % copies], plan, **kw),
                         max(3, iters // 5))
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_int32 = 1e3 * macs / _int32_macs_per_s(dev)
    t_s8 = 1e3 * 2 * 4 * macs / INT8_TENSOR_OPS_PER_S
    ms = sum(times["s8"]) / 2
    ms_core = sum(times["cuda_core"]) / 2
    row = dict(site=site, shape=list(c.shape) + [list(gs[0].shape)], ms=ms,
               ms_turns=times["s8"], kernel_only_ms=alone["s8"],
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_s8),
               bound_by="bytes" if t_bytes >= t_s8 else "operations",
               bytes_ms=t_bytes, int32_macs_ms=t_int32, s8_limb_macs_ms=t_s8,
               weight_copies=copies, weight_bytes=wbytes,
               cuda_core=dict(ms=ms_core, ms_turns=times["cuda_core"],
                              kernel_only_ms=alone["cuda_core"],
                              bound_ms=max(t_bytes, t_int32),
                              bound_by="bytes" if t_bytes >= t_int32
                              else "operations"))
    log(f"[timing] {site} c{list(c.shape)} x g{list(gs[0].shape)} packed: "
        f"s8 kernel {ms:.4f} ms (turns {times['s8'][0]:.4f} / "
        f"{times['s8'][1]:.4f}; alone {_ms(alone['s8'])}), CUDA-core kernel "
        f"{ms_core:.4f} ms (turns {times['cuda_core'][0]:.4f} / "
        f"{times['cuda_core'][1]:.4f}; alone {_ms(alone['cuda_core'])}), "
        f"plain {plain_ms:.4f} ms; bounds: bytes {t_bytes:.4f} ms, int32 "
        f"MACs of the M-1 streams {t_int32:.4f} ms, s8 limb MACs "
        f"{t_s8:.4f} ms; s8 {ms / row['bound_ms']:.2f}x its bound "
        f"({row['bound_by']}), CUDA-core "
        f"{ms_core / row['cuda_core']['bound_ms']:.2f}x its bound; no single "
        f"PyTorch call computes this function")
    return row


def decode_occupancy(E, top_k, tokens, seed):
    """The experts that ``tokens`` decode tokens reach, each routed to
    ``top_k`` distinct experts drawn from ``seed``: a bool mask [E]."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    occ = torch.zeros(E, dtype=torch.bool)
    for _ in range(tokens):
        occ[torch.randperm(E, generator=gen)[:top_k]] = True
    return occ


def phase_timings(dev):
    """Both GEMM kernels at the llama decode head and largest MLP shapes,
    and the grouped kernels at the deepseek decode MoE shapes with every
    expert occupied and at decode occupancy (8 tokens x top-6 experts from
    the seed; the other experts' rows zero, as the dispatch leaves them,
    so the bound counts only the occupied experts' weights). Weights are
    rotated through enough copies to exceed the L2, as the decode loop
    finds them cold."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels import entangled_matmul_grouped as emmg
    from repro_torch.kernels.codec import pack_int8

    plan = make_plan(SERVE["ft_M"], 32)
    M = plan.M
    gen = torch.Generator(device=dev).manual_seed(7)
    gsz = SERVE["max_batch"] // M
    rows = {"entangled_matmul": [], "entangled_matmul_grouped": []}
    cfg = model_config(LLAMA)
    dense_fns = dict(s8=emm.entangled_matmul_cuda,
                     cuda_core=emm.entangled_matmul_cuda_core)
    for site, (B, K, N) in (("head", (gsz, cfg.d_model, cfg.vocab_size)),
                            ("mlp.down", (gsz, cfg.d_ff, cfg.d_model)),
                            ("mlp.gate/up", (gsz, cfg.d_model, cfg.d_ff))):
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (M, B, K), dev)
        wbytes = (K // 4) * N * 4
        gs = [pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
              for _ in range(max(1, -(-2 * L2_BYTES // wbytes)))]
        rows["entangled_matmul"].append(_timing_row(
            dev, f"{LLAMA} {site}", c, gs, plan, dense_fns,
            emm.entangled_matmul_plain, macs=(M - 1) * B * K * N,
            nbytes=4 * (M * B * K + (K // 4) * N + M * B * N), wbytes=wbytes,
            iters=20 if N > 100_000 else 50))
        del c, gs
        free_cuda()
    cfg = model_config(DEEPSEEK)
    E, F, D = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    from repro_torch.models.layers import _moe_capacity

    Cg = -(-_moe_capacity(SERVE["max_batch"], cfg) // M)  # decode rows
    occ = decode_occupancy(E, cfg.moe.top_k, SERVE["max_batch"], seed=7)
    n_occ = int(occ.sum())
    grouped_fns = dict(s8=emmg.entangled_matmul_grouped_cuda,
                       cuda_core=emmg.entangled_matmul_grouped_cuda_core)
    for site, (K, N), occupied in (
            ("moe.gate/up", (D, F), E), ("moe.down", (F, D), E),
            (f"moe.gate/up at decode occupancy ({n_occ} of {E} experts)",
             (D, F), n_occ)):
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (M, E, Cg, K), dev)
        if occupied < E:
            c[:, ~occ.to(dev)] = 0
        wbytes = occupied * (K // 4) * N * 4
        gs = [pack_int8(_rand(gen, -127, 128, (E, K, N), dev), axis=1)
              for _ in range(max(1, -(-2 * L2_BYTES // (E * K * N))))]
        rows["entangled_matmul_grouped"].append(_timing_row(
            dev, f"{DEEPSEEK} decode {site}", c, gs, plan, grouped_fns,
            emmg.entangled_matmul_grouped_plain,
            macs=(M - 1) * occupied * Cg * K * N,
            nbytes=4 * (M * E * Cg * K + occupied * (K // 4) * N
                        + M * E * Cg * N),
            wbytes=wbytes, iters=50))
        del c, gs
        free_cuda()
    return rows


# ------------------------------------------------------------------- main --

def run_path(dev, kernels, arch, path_kernels, scopes, admission, smi,
             seed):
    """One serving path: init, the census shapes' kernel checks, the
    serving waves, then the serve-admission path (``admission``: (modes,
    scopes, drill)). Frees the model before returning."""
    cfg, model, params = init_model(dev, arch)
    dense, grouped = main_path_shapes(cfg, params, dev)
    by_name = {k["name"]: k for k in kernels}
    check_dense(dev, by_name["entangled_matmul"]["checker"], dense,
                ragged=arch == LLAMA)
    if grouped:
        check_grouped(dev, by_name["entangled_matmul_grouped"]["checker"],
                      grouped)
    counts, core, results, breakdown = phase_serve(
        dev, kernels, path_kernels, cfg, model, params, scopes)
    modes, admit_scopes, drill = admission
    admit_counts, admit = phase_serve_admission(
        dev, kernels, path_kernels, cfg, params, modes, admit_scopes, smi,
        seed, drill)
    del params, model
    free_cuda()
    return dict(counts=counts, core_counts=core, results=results,
                breakdown=breakdown, admission_counts=admit_counts,
                admission=admit,
                n_dense_shapes=len(dense), n_grouped_shapes=len(grouped))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve-admission wave's prompt lengths")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import checksum as kcks
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import disentangle as kdis
    from repro_torch.kernels import entangle as kent
    from repro_torch.kernels import entangled_conv1d as kecv
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels import entangled_matmul_grouped as emmg

    s8_src = "src/repro_torch/kernels/csrc/entangled_matmul_s8.cu"
    core_src = "src/repro_torch/kernels/csrc/entangled_matmul.cu"
    codec_src = "src/repro_torch/kernels/csrc/codec_pass.cu"
    conv_src = "src/repro_torch/kernels/csrc/conv1d.cu"
    # the GEMMs' main route is the s8 tensor-core kernel (every packed
    # call); their second, the CUDA-core kernel (unpacked weights)
    gemm_builds = [(s8_src, emm.build_s8), (core_src, emm.build)]
    gemm_counters = ["launches_s8", "launches_cuda_core"]
    kernels = [
        dict(name="entangled_matmul", module=emm, route="cuda",
             source=s8_src, core_source=core_src, builds=gemm_builds,
             counters=gemm_counters,
             replaces="src/repro/kernels/entangled_matmul.py:102",
             checker=Checker(emm.entangled_matmul_cuda_core,
                             emm.entangled_matmul_plain,
                             s8_fn=emm.entangled_matmul_cuda)),
        dict(name="entangled_matmul_grouped", module=emmg, route="cuda",
             source=s8_src, core_source=core_src, builds=gemm_builds,
             counters=gemm_counters,
             replaces="src/repro/kernels/entangled_matmul_grouped.py:77",
             checker=Checker(emmg.entangled_matmul_grouped_cuda_core,
                             emmg.entangled_matmul_grouped_plain,
                             s8_fn=emmg.entangled_matmul_grouped_cuda)),
        dict(name="disentangle", module=kdis, route="cuda", source=codec_src,
             replaces="src/repro/kernels/disentangle.py:32",
             checker=Checker()),
        dict(name="entangle", module=kent, route="cuda", source=codec_src,
             replaces="src/repro/kernels/entangle.py:26",
             checker=Checker()),
        dict(name="entangled_conv1d", module=kecv, route="cuda",
             source=conv_src,
             replaces="src/repro/kernels/entangled_conv1d.py:68",
             checker=Checker(kecv.entangled_conv1d_cuda,
                             kecv.entangled_conv1d_plain)),
        dict(name="conv1d_causal", module=kconv, route="cuda",
             source=conv_src, replaces="src/repro/kernels/conv1d.py:51",
             checker=Checker()),
        dict(name="checksum", module=kcks, route="cuda", source=codec_src,
             replaces="src/repro/kernels/checksum.py:22",
             checker=Checker())]
    for k in kernels:
        k.setdefault("builds", [(k["source"], k["module"].build)])
        k.setdefault("counters", ["launches"])
    by_name = {k["name"]: k for k in kernels}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_all = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    phase_build(kernels)
    paths = {
        LLAMA: run_path(dev, kernels, LLAMA, ["entangled_matmul"],
                        ("head", "all"),
                        (tuple(ADMIT_MODES), ("head", "all"), True), smi,
                        args.seed),
        DEEPSEEK: run_path(dev, kernels, DEEPSEEK,
                           ["entangled_matmul", "entangled_matmul_grouped"],
                           ("moe", "all"), (("chunked", "packed"), ("all",),
                                            False), smi, args.seed),
    }
    grad_shapes = llama_grad_shapes(dev)
    check_codec(dev, {n: by_name[n]["checker"]
                      for n in ("entangle", "disentangle")}, grad_shapes)
    n_params = sum(n * len(v) for n, v in grad_shapes.items())
    state, train_counts, train = phase_train(
        dev, kernels, ["entangle", "disentangle"], n_params)
    train_rollforward(dev, state)
    train["timings"] = train_timings(dev, state)
    del state
    free_cuda()
    stream = run_stream_conv(dev, kernels)
    rows = phase_timings(dev)
    rows.update(codec_timings(dev))
    rows.update(stream.pop("rows"))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    train_path = f"{LLAMA} train"
    record = dict(kernels=[])
    for k in kernels:
        name, chk = k["name"], k["checker"]
        by_path = {a: p["counts"][name] for a, p in paths.items()}
        by_path.update({f"{a} serve-admission": p["admission_counts"][name]
                        for a, p in paths.items()})
        by_path[train_path] = train_counts[name]
        by_path["stream-conv"] = stream["counts"][name]
        if name in ("entangled_conv1d", "conv1d_causal", "checksum"):
            head = rows[name][0]
            extra = dict(launches=stream["counts"][name],
                         timings=rows[name])
        elif name in ("entangle", "disentangle"):
            head = rows[name]
            extra = dict(launches=train_counts[name],
                         launches_per_train_step=train["launches_per_step"][
                             name], timings=[head])
        else:
            head = rows[name][0]
            core = head["cuda_core"]
            core_by_path = {a: p["core_counts"][name]
                            for a, p in paths.items()}
            extra = dict(
                # the deepseek serving path launches both GEMM kernels
                launches=paths[DEEPSEEK]["counts"][name],
                launches_by_route={"s8": dict(by_path),
                                   "cuda_core": core_by_path},
                launches_per_decode_step={
                    a: {s: r["launches_per_decode_step"][name]
                        for s, r in p["results"].items()}
                    for a, p in paths.items()},
                cuda_core=dict(
                    source=k["core_source"],
                    launches=paths[DEEPSEEK]["core_counts"][name],
                    max_abs_err=chk.worst_by_route.get("cuda_core", 0),
                    comparisons=chk.n_by_route.get("cuda_core", 0),
                    ms=core["ms"], bound_ms=core["bound_ms"],
                    bound_by=core["bound_by"]),
                timings=rows[name])
        main_route = "s8" if "core_source" in k else "cuda"
        record["kernels"].append(dict(
            name=name, route=k["route"], source=k["source"],
            replaces=k["replaces"], launches=extra.pop("launches"),
            launches_by_path=by_path,
            max_abs_err=chk.worst_by_route.get(main_route, 0),
            comparisons=chk.n_by_route.get(main_route, 0), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head.get("library_ms"),
            shape=head["shape"], **extra))
    record["serve_admission"] = {a: p["admission"] for a, p in paths.items()}
    record["train"] = train
    record["stream_conv"] = stream
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
