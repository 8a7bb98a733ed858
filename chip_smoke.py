#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

It drives the port's serving paths and its training paths, each at its
model's published widths with random weights from a seeded
``torch.Generator``: llama3.2-1b (dense decoder) served cut to 4 of its 16
layers, served by a 4-replica fleet, and trained at all 16 (and across 2
ranks at 8); deepseek-v2-lite-16b (MLA attention, a
dense first layer and 64-expert top-6 MoE layers; cut to 2 of its 27
layers, the dense first layer and one MoE layer: its float32 masters and
int8 copies at all 27 layers do not fit one 80 GB card, and 8, then 4,
layers took the script past its time limit on a slow host) served, and
trained cut to 2 layers, also served across 2 ranks on the one card
with llama3.2-1b; qwen2-7b (qkv bias), minitron-8b (ungated relu2 MLP)
and granite-20b (MQA, ungated gelu MLP) served cut to a quarter of their
depth, 7 of 28, 8 of 32 and 5 of 52 layers (granite's 52 hold about 20.3
G parameters, 81 GB of float32 masters alone); falcon-mamba-7b (Mamba-1)
served cut to 2 of its 64 layers and recurrentgemma-2b (RG-LRU and
rolling-window MQA) to 3 of 26, and trained cut to 1 and 6 layers;
internvl2-2b (24 layers
behind 256 patch embeddings) and whisper-small (12 encoder and 12 decoder
layers over 1500 frames) whole; deepseek-v3-671b (MLA with a low-rank Q,
256-expert top-8 sigmoid MoE, the MTP block) served with bf16 masters, cut
to 4 of its 61 layers (the 3 published dense layers and 1 MoE layer); the
library's examples and SDC detection; and the
paper's own experiment, the Fig. 2 stream convolution
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
               16-request wave (prompt lengths from ``--seed`` in 5..240,
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
  3s. serve-mesh — right after the two serving paths: one engine split
               across 2 ranks spawned on the one card over gloo
               (``chip_smoke.py --dist-worker R --dist-phase
               serve-mesh``), 4 of the 8 slots a rank: each rank holds both
               GEMMs against their plain versions at the shapes its engine
               sends them (its census of the wave's bucket at scope all,
               the head at its own rows), sets the counts to 0, serves the
               8-request wave with llama3.2-1b (4 layers; scopes head and
               all) and deepseek-v2-lite-16b (2 layers; moe and all),
               healthy and with ``failed_group=1``, and reads the counts;
               meanwhile this process serves the same waves through a
               one-rank engine (llama) and through one process of 2 MoE
               dispatch groups (deepseek, a stand-in mesh). Every rank's
               tokens must equal those bit for bit and roll forward
               (EXACT ROLL-FORWARD (serve-mesh)), with no plan miss, the
               s8 GEMM (and deepseek's grouped one) launched on every rank
               and the CUDA-core route never;
  3a. autotune — right after the serving paths: the launch
               parameters of the kernels (``blocks``) swept over every
               candidate of ``kernels/autotune.py::candidates_for`` at the
               shapes furthest from their bounds (llama's mlp.down and
               head, recurrentgemma's MQA k / v and qkv.gate, v3's q_a,
               deepseek-v2-lite's grouped moe.gate/up at decode
               occupancy, the entangle and disentangle passes at [4,
               67,108,864], the conv at the stream and the depthwise
               shape), every candidate held bit for bit against the plain
               version, the rule's and the winner's times beside the
               bound; llama3.2-1b served with ``blocks="auto"`` from an
               empty user cache over the shipped seed
               (``kernels/pretuned/cuda_sm90.json``, made by
               ``chip_autotune_seed.py``): 0 sweeps, EXACT ROLL-FORWARD
               (autotune) with ``failed_group=1`` on a warm replica,
               tokens equal to ``blocks=None``'s; ``launch.serve
               --blocks '{"bb": 1, "splits": 2}'`` on the card, the head
               GEMM's last launch carrying them; after the train phase,
               the roofline shares: ``launch/op_cost.py`` on the meta
               device over one llama decode step at scope all and one
               train step at the train phase's shape, over the measured
               step times (``mfu`` against 989 TFLOP/s bf16, the int8
               share against 1,979 TOP/s, the HBM share against 3.35
               TB/s);
  3c. fleet — llama3.2-1b on 4 warm replicas (scope all,
               ``failed_group=1`` on every step), 16 requests (prompt
               lengths from ``--seed`` in 5..128, buckets 8..128 under
               max_seq 256, 16 new tokens); replica 2 is fail-stopped at
               the first step it holds a decoding request, and every
               request must finish with the tokens of a healthy
               single-engine run in the same call (EXACT ROLL-FORWARD
               (fleet)), with replay, prefix resume and recompute each
               taken, plan misses 0 and no weight quantized after the
               first replica; the same wave with no kill; then the
               last-replica drill (one replica under autoscaling, killed,
               revived by a warm spawn). Prints the time to recover (ms
               from the kill until every migrated request streamed its
               next token), fleet tokens/s with and without the kill, the
               fleet steps and the migration counts;
  3d. dense-decoders — qwen2-7b, minitron-8b, granite-20b (7, 8, 5
               layers),
               one at a time: every (site, shape) of the engine's startup
               census at scope all and the vocab head held against the
               plain version on the s8 route (granite's N = 128
               included); the 8-request wave at ft_mode none and at
               entangle / all, healthy and with ``failed_group=1`` (EXACT
               ROLL-FORWARD); decode-step ms against none in the same
               call, s8 launches per decode step, ``max_memory_allocated``;
  3e. recurrent — falcon-mamba-7b (2 of 64 layers) and
               recurrentgemma-2b (3 of 26) at published widths, one at a
               time: the census shapes of
               every admission mode at scope all, the vocab head and the
               model's own quantized head held against the plain version on
               the s8 route; the 8-request wave at ft_mode none and at
               entangle / head and all, healthy and with
               ``failed_group=1`` (EXACT ROLL-FORWARD (recurrent)); chunked
               (32, refill) and token-packed (4 rows of 32) admission of 12
               requests (prompt lengths from ``--seed`` in 5..240) at scope
               all, healthy and injected, the modes compared under the
               near-tie rule; for recurrentgemma one request of 2200
               prompt tokens (chunked, ``max_seq`` 4096) and 16 new ones,
               healthy and injected, so that its 2048-token rolling buffer
               wraps in prefill and in decode; decode-step ms against none,
               s8 launches per decode step, ``max_memory_allocated`` and a
               profiler window of 2 decode steps at scope all;
  3f. families — internvl2-2b and whisper-small at published widths,
               nothing cut: internvl's census shapes at scope all, the
               vocab head and its own quantized head (92553 columns) held
               against the plain version on both routes; its 8-request
               wave at scopes head and all, healthy and with
               ``failed_group=1`` (EXACT ROLL-FORWARD (vlm)), and at
               ft_mode none; 8 rows of 256 seeded patch embeddings and
               8-token prompts through ``prefill``, 8 ``decode_hidden``
               steps and the protected head at head and all, healthy and
               injected (EXACT ROLL-FORWARD (vlm)); a profiler window;
               whisper's head (51865 columns) likewise, the engine's
               refusals on the card, 8 rows of 1500 seeded frames and
               8-token prompts through ``prefill``, then 16 steps of
               ``decode_hidden`` with the bf16 head and with the
               protected head, healthy and injected (EXACT ROLL-FORWARD
               (encdec)); ``entangled_chain`` (two feasible chains at M =
               8, one falling back per hop at M = 4) with every stream
               failed in turn, equal to healthy and to the plain version;
               decode-step ms, the encoder's ms, s8 launches per step,
               ``max_memory_allocated``; the s8 kernel's time at the two
               odd-width heads against its bytes bound;
  3g. serve-v3 — deepseek-v3-671b with bf16 masters: the 8-request wave
               at scopes moe and all, healthy and with ``failed_group=1``
               on a warm replica (EXACT ROLL-FORWARD (serve-v3)), the MTP
               block never quantized, ``ft_mode none`` and a profiler
               window of 2 decode steps at scope all; launches per decode
               step, decode-step ms, init and engine-startup seconds,
               ``max_memory_allocated``; then, with the model freed,
               every census shape at scope all and the 129280-column head
               held against the plain versions on both GEMM routes
               (packed, the serving plan); before that, on the same
               params, serve-v3-absorb: the absorbed MLA decode
               (``mla_absorb=True``) through the same waves (EXACT
               ROLL-FORWARD (serve-v3-absorb), the naive path's s8
               launches per decode step), ``ft_mode none``, a profiler
               window, and each of 4 decode steps' logits against the
               naive decode's on one cache along its MoE routes (max |delta|
               < 0.5, cosine > 0.999), with step ms and peak memory both
               ways;
  4. train   — ``train_loop`` trains full-width llama3.2-1b with the
               entangled gradient sync on the kernel codec (a fail-stopped
               block at one step) and writes its final checkpoint; the
               losses must be finite. EXACT ROLL-FORWARD (train): one
               backward, synced healthy and with each of blocks 0-3 failed,
               every synced leaf and the updated state bit-identical.
               Remat and the streamed CE at the same shape: ``remat``
               'full' and 'dots' give the plain step's loss and every
               gradient bit for bit, the streamed CE's gradient w.r.t.
               the logits lies within CE_GRAD_TOL of the naive CE's, its
               non-target entries within CE_NONTARGET_RTOL elementwise (a
               planted fault, the softmax term doubled, must break it), the
               step within the reference's streamed-vs-naive bounds and
               each step's gradients the model's backward of its CE's, bit
               for bit, with each setting's step ms and peak memory. Then
               train-variants: one step with float32 and one with bf16
               AdamW moments from the phase's state (losses, the updated
               params' largest relative difference, the moments' bytes and
               peak memory), the bf16 moments through ``CheckpointManager``
               and back bit for bit, and ``forward_train`` with the bf16
               norm apply against the float32 apply (argmax agreement >
               0.95); dist: ``ft_grad_sync`` over a one-rank NCCL group on
               one backward's gradients equal to ``axis_name=None`` bit for
               bit with each block failed (EXACT ROLL-FORWARD (dist)), then
               4 ranks spawned on the one card over gloo (``chip_smoke.py
               --dist-worker``), their syncs bit-identical to one another
               and to the single-process oracle on the card for every
               failed block, and the sync's ms at world size 1 and 4. Then
               the mean step time per gradient sync and a profiler window;
  4m. train-mesh — training across ranks: llama3.2-1b at published
               widths cut to 8 of its 16 layers (two ranks' training
               state on one card), global batch 4 x 512, entangled sync on
               the kernel codec, 3 steps with block 1 fail-stopped at step
               1. First the codec kernels against their plain versions at
               every gradient-leaf size of that depth and the one-process
               loop here (its losses and grad norms kept on the host);
               then 2 ranks spawned on the one card over gloo
               (``chip_smoke.py --dist-worker R --dist-phase train-mesh``)
               each run ``train_loop`` under ``axis_rules`` of the (2, 1)
               data x model mesh, 2 rows a rank, with every kernel's count
               set to 0 just before and read just after: losses, grad norms
               and params after every step bit-identical across the ranks,
               rank 0's step within the train tests' tolerances of the
               one-process step from the same state, the losses within
               TRAIN_MESH's of the one-process loop, EXACT ROLL-FORWARD
               (train-mesh) on each rank's summed gradient at the fail
               step (healthy and blocks 0-3), one entangle and one
               disentangle launch per gradient leaf and step on each
               rank, the final checkpoint written by rank 0 alone and
               restored on both to the final state bit for bit; step ms
               beside the one-process step, the gloo sum's ms a step,
               ``max_memory_allocated`` per rank;
  4b. train-families — deepseek-v2-lite-16b (MLA + MoE; 2 of 27 layers:
               the dense first layer and one MoE layer), falcon-mamba-7b
               (Mamba-1; 1 of 64) and recurrentgemma-2b (RG-LRU + local
               attention; 6 of 26, two whole units) at published widths,
               one at a time, each as phase 4: ``train_loop`` with block 1
               fail-stopped at step 2 (no final checkpoint: phases 4 and
               4m write and restore theirs), launches of the
               entangle / disentangle kernels per step, EXACT ROLL-FORWARD
               (train-moe / train-ssm / train-hybrid) on one backward, step
               ms per gradient sync (spmd, checksum, entangle on the
               kernel codec), ``max_memory_allocated`` and a profiler
               window; then the blocked attention's backward at T = S =
               2048 with llama3.2-1b's heads, causal, against autograd
               through the materialized scores;
  5. stream-conv — the conv and entangled conv kernels, each on both
               routes (the s8 tensor cores and the CUDA cores), and the
               checksum kernel held against their plain versions (ragged
               shapes at K_f 1..4609, the s8 route's edges, every plan,
               mode, packing and failed stream; the depthwise model shape
               [4, 8, 8192, 512]; the stream-conv shapes); then the path:
               ``run_protected("conv")`` under none / entangle / checksum /
               mr with every failed stream, and the fused entangled conv
               with every failed stream, must equal the failure-intolerant
               conv bit for bit (EXACT ROLL-FORWARD (stream conv)) per
               (M, K), every other LSB op must recover exactly at the
               demo's size, and the s8 route of both convs must have
               launched; then the Fig. 2 overheads of each family against
               the conventional conv on the card, and both conv routes
               timed in turns against the bound;
  5b. library — ``examples/failstop_demo`` and ``examples/serve_lm`` of
               the port on the card with the reference examples' verdicts,
               and ``sdc.detect`` / ``localize`` on card tensors held to
               the same calls on the CPU;
  6. timings — each kernel, its plain version and its bound at its
               main-path shapes (the dense GEMM also at the recurrent
               families' new shapes, and at the odd-width heads in
               3f), after warm-up: device time per call from the replay
               of a CUDA graph of many calls, and the kernel's
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
import functools
import gc
import json
import math
import os
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
# llama3.2-1b served at published widths cut to 4 of its 16 layers in
# every serving path (serve, serve-admission, serve-mesh, autotune's cold
# start, the fleet); its training paths keep their own depths. The served
# depth went 16 -> 4, deepseek's 4 -> 2, the dense decoders' to half and
# the recurrent families' to a quarter, the admission wave 24 -> 16
# requests, the timed train steps 2 + 5 -> 1 + 3 a sync, and phase 4b's
# loops lost their final checkpoints (35 GB of writes; phase 4 and
# train-mesh still write and restore theirs) after the script ran past
# its 1200 s limit on a slow host with the train-mesh phase (1034.7 s on
# another, 688.4 s at the first cuts on a fast one)
LLAMA_SERVE_LAYERS = 4
# the dense first layer and 1 MoE layer of 27 at published widths: 8
# layers took the script past 1200 s on a slow host (1209.3 s), then 4
DEEPSEEK_LAYERS = 2
SERVE = dict(max_batch=8, ft_M=4, max_seq=256, requests=8, prompt_len=8,
             max_new=8)
# the fleet path: llama3.2-1b on 4 replicas of the serving geometry above,
# 16 requests (prompt lengths from --seed in [5, 128]) of 16 new tokens,
# the buckets 8 .. 128 under max_seq 256 (so that a prefix can outgrow the
# largest bucket and recompute), one whole-bucket prefill call per step;
# then the last-replica drill over the first 8 requests
FLEET = dict(replicas=4, requests=16, max_new=16, max_prompt=128,
             buckets=(8, 16, 32, 64, 128), drill_requests=8)
# the other dense decoders at published widths: arch -> layers kept (None:
# all). granite-20b's 52 layers hold about 20.3 G parameters, 81 GB of
# float32 masters alone; 20 layers (8.2 G) leave room for the int8 copies
# and the plain versions' operands on one 80 GB card. Each cut to half its
# published depth (qwen2-7b 28 -> 14, minitron-8b 32 -> 16, granite-20b
# 20 -> 10) after the script took 1181.5 s on a slow host with the
# serve-mesh phase, and to a quarter (7, 8, 5) after it ran past 1200 s
# with the train-mesh phase
DECODERS = {"qwen2-7b": 7, "minitron-8b": 8, "granite-20b": 5}
# the recurrent families at published widths: the 8-request
# wave at none / head / all; chunked (32, refill) and token-packed (4 rows
# of 32) admission of REC_REQUESTS seeded prompts in [5, 240] at scope
# all; for recurrentgemma one LONG request past its 2048-token window,
# chunked, so that the rolling buffer wraps in prefill and in decode
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-2b")
# served depth cuts of the recurrent phase: falcon-mamba at 8 of its 64
# layers (its eager scan sets the phase's time; 64 -> 32 saved about 54 s
# of the script's 1200 and funded the perf-variant and distribution
# phases; 32 -> 16 brought a slow host back under the limit; 16 -> 8 and
# recurrentgemma 26 -> 12 (four whole (rglru, rglru, local_attn) units;
# its 2200-token request's 69 chunks run every recurrent layer's scan
# step by step) after the script took 1181.5 s on a slow host with the
# serve-mesh phase; 8 -> 2 and 12 -> 3, one whole unit, after it ran
# past 1200 s with the train-mesh phase)
RECURRENT_LAYERS = {"falcon-mamba-7b": 2, "recurrentgemma-2b": 3}
REC_REQUESTS = 12
REC_MODES = ("chunked", "packed")
LONG = dict(prompt=2200, max_new=16, max_seq=4096, bucket=2208, chunk=32)
# the encoder-decoder and vision-language families at published widths,
# nothing cut: internvl2-2b serves the 8-request wave through the engine
# and runs 8 rows of PREFIX["patches"] seeded patch embeddings and
# 8-token prompts through prefill, PREFIX["steps"] decode_hidden steps and
# the protected head; whisper-small runs 8 rows of its 1500 frames and
# 8-token prompts through prefill, WHISPER["steps"] decode_hidden steps and
# the protected head (the engine refuses it, as the reference's does)
VLM = "internvl2-2b"
ENCDEC = "whisper-small"
PREFIX = dict(patches=256, max_seq=512, steps=8)
WHISPER = dict(max_seq=448, steps=16)
# entangled_chain over the serving batch's rows, (M, widths): two feasible
# chains at M = 8 (64 -> 64 -> 32, one extraction after 2 hops; 4 -> 4 ->
# 2 -> 16, 3 hops, the middle one in mode "chain") and one that falls back
# per hop (M = 4, llama's mlp 2048 -> 8192 -> 2048)
CHAINS = ((8, (64, 64, 32)), (8, (4, 4, 2, 16)), (4, (2048, 8192, 2048)))
# the serve-admission path: the same engine geometry with every bucket of
# the geometric set (8 .. 256), a 16-request wave of seeded prompt lengths
# in [5, 240] (one in every bucket, the rest log-uniform) and the four
# admission modes, each healthy and with failed_group=1 at scopes head and
# all (deepseek: chunked and packed at scope all)
ADMIT = dict(requests=16, len_lo=5, len_hi=240, max_new=8, chunk=32,
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
TRAIN = dict(batch=4, seq=512, ft_M=4, steps=4, fail_step=2, warm_steps=1,
             timed_steps=3)
# phase 4b: the other trainable families at published widths, each cut in
# depth to what its training state (float32 params, gradients and two
# AdamW moments, 16 bytes per param, and the out-of-place update) leaves
# room for on one 80 GB card: deepseek-v2-lite-16b's dense first layer and
# one MoE layer of 27 (3 MoE layers, 2.255 G params, until a slow host
# took the script past 1200 s: their 27 GB checkpoint alone took 62.4 s),
# recurrentgemma-2b 6 of 26, two
# (rglru, rglru, local_attn) units (1.169 G); falcon-mamba-7b 1 of 64:
# memory allows 4, but its scan's eager steps (2.9 s a step at 4 layers)
# took the phase to 392 s on the H100, past its share of the script's
# time limit, and 2 layers (2.4 s a step on a slow host) took the script
# to 1181.5 s with the serve-mesh phase
TRAIN_FAMILIES = {DEEPSEEK: 2, "falcon-mamba-7b": 1, "recurrentgemma-2b": 6}
# deepseek-v3-671b at published widths cut to the shallowest depth that
# keeps its published first_dense_layers=3: 3 dense layers and 1 MoE layer
# of 61, bf16 masters (float32 masters and scope all's int8 copies would
# take about 77 GB of the 80)
V3 = "deepseek-v3-671b"
V3_LAYERS = 4
# the absorbed MLA decode (mla_absorb) on the same v3 params: per decode
# step its logits against the naive decode's on the same cache, ABSORB
# steps after a prompt of ABSORB_PROMPT tokens in every slot; the bounds are
# tests/test_perf_variants.py's (max |delta| < 0.5, cosine > 0.999)
ABSORB = dict(prompt=16, steps=4, max_diff=0.5, cos=0.999)
# the training variants at TRAIN's shape: bf16 AdamW moments (one step
# each way from the phase's state, the bf16 moments through the
# checkpoint) and the bf16 norm apply (argmax agreement with the float32
# apply above the reference test's 0.95)
NORM_AGREE = 0.95
# the distribution phase: the sync over a one-rank NCCL group (llama's
# full-width gradient leaves), and DIST_WORLD ranks spawned on the one card
# over gloo, each with seeded gradient leaves of one decoder layer of
# llama's at its published widths (:func:`_dist_shapes`); the one-rank
# sync is also timed on those leaves, so that the two world sizes compare
DIST_WORLD = 4
DIST_FAILED = (None, 0, 1, 2, 3)
# the serving path across ranks: MESH_WORLD ranks spawned on the one card
# over gloo, each holding SERVE["max_batch"] / MESH_WORLD slots of one
# engine; each arch with its protected scopes (deepseek at DEEPSEEK_LAYERS)
MESH_WORLD = 2
MESH_PATHS = ((LLAMA, ("head", "all")), (DEEPSEEK, ("moe", "all")))
# training across ranks: TRAIN_MESH["world"] ranks spawned on the one card
# over gloo train llama3.2-1b at published widths cut to "layers" of its
# 16 (each rank holds the whole training state: 0.749 G params at 8
# layers, 16 bytes a param with the out-of-place AdamW update, about 20 GB
# a rank; 16 layers took 36.38 GiB in the one-process train phase) on a
# global batch of "batch" x "seq", "steps" steps with block 1 fail-stopped
# at "fail_step". Tolerances: a step against the one-process step from the
# same state, the train tests' (tests/test_torch_train_mesh.py): loss
# LOSS_ATOL, grad norm GNORM_REL, the summed gradient within "grad_rel" of
# one process's, normwise a leaf (the ranks' bf16 weight gradients are
# rounded before their float32 sum, one process rounds its whole sum
# once), params within 2·lr + 1e-6 everywhere, and, after the first step,
# within lr · "near_rel" for all but "off_share" of them. The first
# step's share is printed, not held: AdamW's first update is
# g / (|g| + eps), and at lr 1e-3 the tied 128256-row head's gradients lie
# near eps, where a gradient rounded 2^-8 apart moves the update by up to
# lr · 2^-10 and a sum that cancels (two ranks' partials of opposite sign)
# by more: on the H100, 8.9% of the params parted by more than 1e-6 and
# 1.38% by more than lr / 64, 0.18% and 0.004% at the next steps, where
# the moments smooth the update (PERF.md §6). (The CPU tests' lr is
# 9.6e-5, where the first step holds to 1e-6.) The losses against the
# one-process loop: LOSS_ATOL at the first step (the same params),
# "loop_loss_atol" later (the loops part by the rounding of each step's
# gradient)
TRAIN_MESH = dict(world=2, layers=8, batch=4, seq=512, steps=3, fail_step=1,
                  loss_atol=1e-4, gnorm_rel=2e-3, loop_loss_atol=1e-3,
                  grad_rel=2.0 ** -6, off_share=0.01, near_rel=2.0 ** -6)
# the library path: SDC detection over M streams of this many columns, and
# the kernels its examples and SDC calls must launch
LIB_SDC_N = 1 << 20
LIB_KERNELS = ("entangled_matmul", "entangle", "disentangle",
               "conv1d_causal", "checksum")
# remat and the streamed CE on the card, at TRAIN's shape: one warm-up and
# this many timed forward + backward steps per setting; the absolute bounds
# are tests/test_torch_loss.py's (CE_* on the CE alone, NAIVE_* on the
# step). At this shape a non-target d loss / d logit is ~4e-9, below
# CE_GRAD_TOL, so the CE's non-target entries are also held elementwise
# relative to the naive CE's: float32 roundoff of a logsumexp near 12
# gives a few 1e-6 (CPU, vocab 128256), the softmax term doubled gives 1
REMAT_CHECK = dict(timed_steps=2)
CE_LOSS_TOL = 1e-5
CE_GRAD_TOL = 1e-6
CE_NONTARGET_RTOL = 1e-4
NAIVE_LOSS_TOL = 1e-4
NAIVE_GRAD_TOL = 1e-3
# the blocked attention's backward on the card: llama3.2-1b's heads at T =
# S = 2048, past the materialization limit of 2048**2 / 4 scores
FLASH_CHECK = dict(batch=2, T=2048)
# the AdamW updates of the roll-forward check run on slices of a leaf this
# long (elements), so that the largest expert stack's two updates fit
# beside the state and two synced gradient trees
UPDATE_SLICE = 1 << 26
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
# the s8 conv route's edges (B, D, T, K_f): T one short of its 512-output
# tile at K_f = its 64-output row block, T one past its 3072-output tile at
# K_f one past the row block, K_f one past its 4608-tap chunk
S8_EDGE_SHAPES = [(1, 1, 511, 64), (2, 1, 3073, 65), (1, 1, 2000, 4609)]
CONV_ROUTES = ("cuda_core", "s8")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def count(k, route: int = 0) -> int:
    """Launches of kernel ``k`` on its main route (``route`` 1: the second
    route of a GEMM, its CUDA-core kernel; a conv's counters are all its
    launches, then its s8 and its CUDA-core route's)."""
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


def _packed_weights(gen, E, K, N, dev):
    """Random int8 expert weights [E, K, N] in [-127, 127], packed 4 per
    int32 word along K ([E, ceil(K/4), N]), drawn and packed one expert at
    a time (packing a whole 256-expert stack at once takes its int64
    temporaries, several times the stack)."""
    import torch

    from repro_torch.kernels.codec import pack_int8

    out = torch.empty((E, -(-K // 4), N), dtype=torch.int32, device=dev)
    for e in range(E):
        out[e] = pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
    return out


class Checker:
    """Kernel-vs-plain comparisons of one kernel (and, for a GEMM, its
    poison checks); keeps the largest |kernel - plain| seen (0 when all
    agree) and the count, per route. ``cuda_fn``/``plain_fn`` are the
    GEMM's pair for ``compare``; a GEMM's ``s8_fn`` (its wrapper, which
    sends packed calls to the s8 tensor-core kernel) is held against the
    same plain result on every packed call, beside ``cuda_fn`` (its
    CUDA-core kernel, called directly). ``route_fns`` ({route: fn}) holds
    a kernel with routes that all take every call (the convs) against the
    plain result on each. The codec passes call ``equal`` with their own
    results."""

    def __init__(self, cuda_fn=None, plain_fn=None, s8_fn=None,
                 route_fns=None):
        self.cuda_fn, self.plain_fn, self.s8_fn = cuda_fn, plain_fn, s8_fn
        self.route_fns = route_fns  # {route: fn}, every route on any call
        self.worst_by_route, self.n_by_route = {}, {}

    @property
    def worst(self):
        return max(self.worst_by_route.values(), default=0)

    @property
    def n(self):
        return sum(self.n_by_route.values())

    def spawn(self):
        """A new checker over the same functions, with no comparisons yet
        (to read one part's worst error); :meth:`absorb` folds it back."""
        return Checker(self.cuda_fn, self.plain_fn, s8_fn=self.s8_fn,
                       route_fns=self.route_fns)

    def absorb(self, other):
        for route, err in other.worst_by_route.items():
            self.worst_by_route[route] = max(
                self.worst_by_route.get(route, 0), err)
            self.n_by_route[route] = (self.n_by_route.get(route, 0)
                                      + other.n_by_route[route])

    def routes(self, packed):
        """(route, launch function) of each kernel that takes the call."""
        if self.route_fns is not None:
            return list(self.route_fns.items())
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


def check_grouped(dev, chk, shapes, ragged=True, full_range=True):
    """The grouped kernel: ragged small shapes for every plan (when
    ``ragged``), then the main path's ``shapes`` (a list of ``(E, Cg, K,
    N, sites)``) under the serving plan (dual-word), both modes, every
    failed stream, packed int8 weights on both routes; with
    ``full_range`` also under an int32 plan and with unpacked full-range
    int32 weights (the CUDA-core route). The poison check on every
    shape."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget

    gen = torch.Generator(device=dev).manual_seed(4321)
    if ragged:
        _check_grouped_ragged(dev, chk, gen)
    n0 = chk.n
    plans = [make_plan(SERVE["ft_M"], 32)]
    if full_range:
        plans.append(make_plan(SERVE["ft_M"], 16))
    for (E, Cg, K, N, site) in shapes:
        for plan in plans:
            bud = activation_budget(plan, K)
            c = _rand(gen, -bud, bud + 1, (plan.M, E, Cg, K), dev)
            gp = _packed_weights(gen, E, K, N, dev)
            what = f"{site} [{plan.M},{E},{Cg},{K}]x[{E},{K // 4},{N}]"
            chk.sweep(c, gp, plan, True, what + f" {plan.temp}",
                      GROUPED_MODES)
            chk.poison(c, gp, plan, True, what)
            del gp
            if full_range:
                g32 = _rand(gen, -2**31, 2**31, (E, K, N), dev)
                chk.sweep(c, g32, plan, False, what + f" {plan.temp}",
                          GROUPED_MODES)
                del g32
            del c
            torch.cuda.empty_cache()
    log(f"[kernels] entangled_matmul_grouped full-width shapes: "
        f"{len(shapes)} main-path shapes x {len(plans)} plans, "
        f"{chk.n - n0} comparisons bit-identical; poison check passed")


def _check_grouped_ragged(dev, chk, gen):
    """The grouped kernel at ragged small shapes under every plan, and
    packed at K = DEEP_K (split-K past one limb product)."""
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels.codec import pack_int8

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


def check_codec(dev, checkers, grad_shapes, ragged=True,
                what=f"full-width {LLAMA}"):
    """The entangle and disentangle passes against their plain versions:
    ragged widths under every plan of Table I (M = 3..8; dual-word at w=32,
    int32 at w=16) and every r (unless ``ragged`` is False), then every
    gradient leaf of ``grad_shapes`` ({numel: names}, of ``what``) as the
    sync blocks it, ``[M, ceil(n / M)]`` under the training plan, every r;
    the poison check (row r overwritten by GARBAGE) everywhere. Full-range
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
    for plan in plans if ragged else ():
        for n in (1, 2, 3, 1023, 1025, 65537):
            one(plan, n, f"plan(M={plan.M},l={plan.l},{plan.temp}) N={n}")
    if ragged:
        log(f"[kernels] entangle / disentangle ragged widths: {len(plans)} "
            f"plans x 6 widths, {chk_e.n - n0[0]} / {chk_d.n - n0[1]} "
            f"comparisons bit-identical; poison check passed")
    n0 = (chk_e.n, chk_d.n)
    plan = make_plan(TRAIN["ft_M"], 32)
    for n, names in sorted(grad_shapes.items()):
        one(plan, -(-n // plan.M), f"grad {names[0]} ({len(names)} leaves)")
        free_cuda()
    n_leaves = sum(map(len, grad_shapes.values()))
    log(f"[kernels] entangle / disentangle at the {len(grad_shapes)} "
        f"gradient-leaf sizes of {what} ({n_leaves} "
        f"leaves, [{plan.M}, ceil(n/{plan.M})], plan(M={plan.M},l={plan.l},"
        f"{plan.temp})): {chk_e.n - n0[0]} / {chk_d.n - n0[1]} comparisons "
        f"bit-identical; poison check passed")


# ------------------------------------------------------------------ serve --

def model_config(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == DEEPSEEK:
        cfg = dataclasses.replace(cfg, n_layers=DEEPSEEK_LAYERS)
    if arch == V3:
        cfg = dataclasses.replace(cfg, n_layers=V3_LAYERS)
    if DECODERS.get(arch):
        cfg = dataclasses.replace(cfg, n_layers=DECODERS[arch])
    if arch in RECURRENT_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=RECURRENT_LAYERS[arch])
    return cfg


def served_config(arch):
    """The config a serving path runs: :func:`model_config`, llama3.2-1b
    cut to LLAMA_SERVE_LAYERS."""
    cfg = model_config(arch)
    if arch == LLAMA:
        cfg = dataclasses.replace(cfg, n_layers=LLAMA_SERVE_LAYERS)
    return cfg


def init_model(dev, arch, max_seq=SERVE["max_seq"]):
    """The served config (:func:`served_config`) with
    random weights from a seeded ``torch.Generator`` (``max_seq`` rows of
    learned positions where the model has them); returns (cfg, model,
    params)."""
    import torch

    from repro_torch.models.api import get_model

    cfg = served_config(arch)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        max_seq=max_seq, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    extra = ""
    if cfg.moe:
        extra = (f", MLA kv_lora {cfg.mla.kv_lora_rank}, {cfg.moe.n_experts}"
                 f" experts top-{cfg.moe.top_k} (d_ff {cfg.moe.d_ff_expert},"
                 f" {cfg.moe.n_shared} shared), dense first layer d_ff "
                 f"{cfg.d_ff}")
    if cfg.ssm:
        extra = (f", d_inner {cfg.ssm.expand * cfg.d_model}, d_state "
                 f"{cfg.ssm.d_state}, d_conv {cfg.ssm.d_conv}")
    if cfg.rglru:
        extra = (f", lru width {cfg.rglru.lru_width}, local window "
                 f"{cfg.local_window}, head_dim {cfg.resolved_head_dim}")
    if cfg.encoder:
        extra = (f", encoder {cfg.encoder.n_layers} layers over "
                 f"{cfg.encoder.n_frames} frames, layernorm, learned "
                 f"positions ({max_seq})")
    if cfg.vision:
        extra = f", {cfg.vision.n_patches} patch embeddings (stub frontend)"
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


def census_shapes(cfg, census):
    """The entangled-GEMM shapes of a protected-site census (a set of
    (site, shape)): dense ``(B, K, N, sites)``, the vocab head first
    (decode and admission both send it max_batch / M rows per group), and
    grouped ``(E, Cg, K, N, sites)`` from the census's 5-tuples."""
    dense = {(SERVE["max_batch"] // SERVE["ft_M"], cfg.d_model,
              cfg.vocab_size): ["head"]}
    grouped = {}
    for site, shape in sorted(census):
        d = dense if len(shape) == 4 else grouped
        if site not in d.setdefault(shape[1:], []):
            d[shape[1:]].append(site)
    flat = lambda d: [(*k, "/".join(v)) for k, v in sorted(d.items())]  # noqa: E731
    return flat(dense), flat(grouped)


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
    new = {m: len(c - census["whole"]) for m, c in census.items()
           if m != "whole"}
    log(f"[kernels] {cfg.name} census at scope all: whole-bucket "
        f"{len(census['whole'])} (site, shape) entries; entries the "
        f"chunked and packed ([{ADMIT['budget'] // ADMIT['chunk']}, "
        f"{ADMIT['chunk']}]) censuses add: {new}")
    return census_shapes(cfg, set().union(*census.values()))


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


def _breakdown(dev, cfg, params, base, tag="serve"):
    """After the path's waves: the unprotected baseline (ft_mode none) and a
    profiler window over two decode steps at scope all, for PERF.md's
    "where the time goes"; ``tag`` prefixes the baseline's line. If the
    profiler cannot trace the card, the share is reported as not measured;
    an engine step or kernel that fails inside the window raises like
    anywhere else."""
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, ServeConfig(**dict(base, ft_mode="none")), params,
                      device=dev)
    _, st, _ = _wave(eng, cfg, None, [])
    none_ms = 1e3 * sum(st[1:]) / len(st[1:])
    log(f"[{tag}] {cfg.name} ft_mode=none: mean decode-step {none_ms:.3f} "
        f"ms, admission+first step {1e3 * st[0]:.3f} ms")
    del eng
    eng = ServeEngine(cfg, ServeConfig(**dict(base, ft_scope="all")), params,
                      device=dev)
    _wave_submit(eng, cfg)
    eng.step()  # admission + first decode, outside the window
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # only the profiler's own start and reading may fail softly: a failed
    # engine step or kernel inside the window raises
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as err:
        log(f"[profile] not measured: {err}")
        prof = None
    t0 = time.perf_counter()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng
    free_cuda()
    if prof is None:
        return dict(step_ms=none_ms)
    rows = []  # device-side events only (kernels, memsets, copies)
    try:
        prof.stop()
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
    log(f"[profile] {cfg.name} scope=all, 2 decode steps: wall "
        f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (1e3 * wall):.1f}%; idle "
        f"{100 - 100 * busy / (1e3 * wall):.1f}%)")
    for dev_us, key, count in rows[:8]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:160]}")
    return dict(step_ms=none_ms, profile_wall_ms=1e3 * wall, busy_ms=busy)


# ------------------------------------------------------- serve-admission --

def admission_lengths(seed, n=ADMIT["requests"]):
    """The wave's ``n`` prompt lengths from ``seed``: one in each bucket's
    range of the geometric set (within [len_lo, len_hi]), the rest
    log-uniform over [len_lo, len_hi], shuffled."""
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
    while len(out) < n:
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
    scope, the 16-request wave healthy and with failed_group=1 (EXACT
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


# ------------------------------------------------------------------ fleet --

def fleet_lengths(seed):
    """The fleet wave's 16 prompt lengths from ``seed``, in [5, 128].
    Least-loaded dispatch deals the requests round-robin, so replica 2
    holds requests 2, 6, 10 and 14; their lengths make its fail-stop take
    every recovery path: 2 and 6 share bucket 128 and land first (one
    prefill call per step), 2 short enough to prefix-resume and 6 at 127
    or 128, which with its two tokens outgrows the bucket and recomputes;
    10 and 14, in smaller buckets, are still queued in the replica at the
    kill and replay. The other twelve are free in [5, 128]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = [int(rng.integers(5, FLEET["max_prompt"] + 1))
           for _ in range(FLEET["requests"])]
    out[2] = int(rng.integers(65, 121))
    out[6] = int(rng.integers(127, 129))
    out[10], out[14] = (int(v) for v in rng.integers(5, 65, size=2))
    return out


def _fleet_requests(cfg, lengths):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(len(lengths))
    return [Request(rid=r, prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new=FLEET["max_new"])
            for r, n in enumerate(lengths)]


def _fleet_wave(fleet, reqs, failed_group, kill=None):
    """Drive a fleet over ``reqs`` (all submitted at once). ``kill``
    ("first" or "last"): fail-stop, before the first step at which it
    holds a decoding request, replica 2 or the last live replica. Returns
    stats: wall, steps, tokens/s and, with a kill, the replica killed, the
    kill step, the migrated requests' token counts at the kill and the ms
    until each has streamed its next token (the time to recover)."""
    import torch

    t0 = time.perf_counter()
    for rq in reqs:
        fleet.submit(rq)
    st = dict(steps=0)
    victim, pending, t_kill = None, None, None
    while not fleet.idle():
        if kill and victim is None:
            live = [r for r, rep in fleet.replicas.items() if rep.live]
            target = 2 if kill == "first" else live[-1]
            held = [rec for rec in fleet.router.records.values()
                    if rec.replica == target]
            if any(rec.shadow.status == "decoding" for rec in held):
                victim = target
                pending = {id(rec.req): len(rec.toks) for rec in held}
                st.update(killed=victim, kill_step=fleet.steps,
                          held={rec.req.rid: dict(
                              prompt=len(rec.req.prompt), toks=len(rec.toks),
                              status=rec.shadow.status) for rec in held})
                t_kill = time.perf_counter()
                fleet.kill_replica(victim)
        fleet.step(failed_group=failed_group)
        torch.cuda.synchronize()
        st["steps"] += 1
        if pending:
            done = [k for k, n in pending.items()
                    if k not in fleet.router.records
                    or len(fleet.router.records[k].toks) > n]
            for k in done:
                del pending[k]
            if not pending:
                st["recover_ms"] = 1e3 * (time.perf_counter() - t_kill)
                st["recover_steps"] = fleet.steps - st["kill_step"]
        if st["steps"] > 50 * FLEET["max_new"]:
            raise AssertionError("fleet wave failed to drain")
    st["wall_s"] = time.perf_counter() - t0
    st["tokens"] = sum(len(r.out) for r in reqs)
    st["tok_s"] = st["tokens"] / st["wall_s"]
    if kill and victim is None:
        raise AssertionError("the kill never found a decoding request")
    return st


def _check_fleet_tokens(reqs, want, what):
    import numpy as np

    bad = [r.rid for r in reqs if r.status != "done"
           or not np.array_equal(np.asarray(r.out), want[r.rid])]
    verdict = "EXACT ROLL-FORWARD (fleet)" if not bad else "RECOVERY FAILED"
    log(f"[fleet] {what}: {len(reqs)} requests / "
        f"{sum(len(r.out) for r in reqs)} tokens against the no-failure "
        f"single engine; mismatching requests: {len(bad)} ({verdict})")
    if bad:
        raise AssertionError(f"fleet {what}: requests {bad} differ from the "
                             f"no-failure run")


def phase_fleet(dev, kernels, smi, seed, checked):
    """The multi-replica fleet on llama3.2-1b at published widths: 4 warm
    replicas at scope all with failed_group=1 on every step; replica 2
    fail-stopped at the first step it holds a decoding request; every
    request's tokens equal the no-failure single engine's (healthy, in the
    same call), replay / prefix resume / recompute each taken, plans.misses
    0, no weight quantized after the first replica; the same wave with no
    kill for the tokens/s; then the last-replica drill (one replica under
    autoscaling, killed, revived by a spawn). Every kernel's count is set
    to 0 just before the fleet waves and read just after; the dense GEMM
    must have launched (s8 route only). ``checked`` is llama's main-path
    dense shapes, already held against the plain version; any shape of the
    fleet's own census outside them is held against it here first."""
    import numpy as np
    import torch

    from repro_torch.ft import quantize
    from repro_torch.serve import (Fleet, FleetConfig, ScalingPolicy,
                                   ServeConfig, ServeEngine)

    cfg, _, params = init_model(dev, LLAMA)
    scfg = ServeConfig(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                       ft_mode="entangle", ft_M=SERVE["ft_M"], ft_scope="all",
                       prefill_buckets=FLEET["buckets"],
                       prefill_chunk=FLEET["buckets"][-1])
    lengths = fleet_lengths(seed)
    torch.cuda.reset_peak_memory_stats(dev)
    # the oracle: one engine, no failure of any kind
    wq0 = quantize.TRACE_STATS["weight_quantize_calls"]
    eng = ServeEngine(cfg, scfg, params, device=dev)
    startup_wq = quantize.TRACE_STATS["weight_quantize_calls"] - wq0
    oracle = _fleet_requests(cfg, lengths)
    for rq in oracle:
        eng.submit(rq)
    eng.run_to_completion(max_steps=50 * FLEET["max_new"])
    want = {r.rid: np.asarray(r.out) for r in oracle}
    if any(len(v) != FLEET["max_new"] for v in want.values()):
        raise AssertionError("the no-failure run did not complete")
    # the replicas share this engine's config, so its census is theirs
    shapes, _ = census_shapes(cfg, eng.protected_census)
    del eng
    free_cuda()
    seen = {s[:3] for s in checked}
    missing = [s for s in shapes if s[:3] not in seen]
    if missing:
        check_dense(dev, next(k["checker"] for k in kernels
                              if k["name"] == "entangled_matmul"),
                    missing, ragged=False)
    log(f"[fleet] census at buckets {FLEET['buckets']}: {len(shapes)} "
        f"(rows, K, N) shapes with the head, {len(shapes) - len(missing)} "
        f"among llama's checked main-path shapes; the other {len(missing)} "
        f"held against the plain version here: {[s[:3] for s in missing]}")

    reset_counts(kernels)
    wq0 = quantize.TRACE_STATS["weight_quantize_calls"]
    fleet = Fleet(cfg, scfg, params, FleetConfig(
        replicas=FLEET["replicas"], device=dev))
    wq_fleet = quantize.TRACE_STATS["weight_quantize_calls"] - wq0
    if wq_fleet != startup_wq:
        raise AssertionError(f"{FLEET['replicas']} replicas made {wq_fleet} "
                             f"weight-quantize calls, one engine's startup "
                             f"makes {startup_wq}")
    reqs = _fleet_requests(cfg, lengths)
    st = _fleet_wave(fleet, reqs, 1, kill="first")
    m = fleet.fleet_metrics()
    _check_fleet_tokens(reqs, want, f"kill replica {st['killed']} at fleet "
                        f"step {st['kill_step']}, failed_group=1 on every "
                        f"step")
    mig = {k: m[f"router_{k}"] for k in ("migrated", "replayed",
                                         "resume_prefix", "resume_recompute")}
    misses = fleet._warm["plans"].misses
    log(f"[fleet] replica {st['killed']} held {st['held']} at the kill; "
        f"migrations {mig}; failed {m['failed']}; plans.misses {misses}; "
        f"weight-quantize calls {wq_fleet} for {FLEET['replicas']} replicas "
        f"(one engine's startup: {startup_wq})")
    for k in ("replayed", "resume_prefix", "resume_recompute"):
        if mig[k] < 1:
            raise AssertionError(f"the fleet drill took no {k}: {mig}")
    if misses or m["failed"] != 1:
        raise AssertionError(f"misses {misses}, failed {m['failed']}")
    del fleet
    free_cuda()

    fleet = Fleet(cfg, scfg, params, FleetConfig(
        replicas=FLEET["replicas"], device=dev))
    reqs = _fleet_requests(cfg, lengths)
    st_nokill = _fleet_wave(fleet, reqs, 1)
    _check_fleet_tokens(reqs, want, "no kill, failed_group=1 on every step")
    del fleet
    free_cuda()

    # the last replica: one replica under autoscaling, killed; the policy
    # revives the pool with a warm spawn
    n = FLEET["drill_requests"]
    pol = ScalingPolicy(min_replicas=1, max_replicas=2, scale_up_depth=99,
                        decide_every=1)
    wq0 = quantize.TRACE_STATS["weight_quantize_calls"]
    fleet = Fleet(cfg, scfg, params, FleetConfig(replicas=1, policy=pol,
                                                 device=dev))
    wq_first = quantize.TRACE_STATS["weight_quantize_calls"] - wq0
    reqs = _fleet_requests(cfg, lengths)[:n]
    st_last = _fleet_wave(fleet, reqs, 1, kill="last")
    wq_drill = quantize.TRACE_STATS["weight_quantize_calls"] - wq0
    m_last = fleet.fleet_metrics()
    _check_fleet_tokens(reqs, want, f"last replica killed at fleet step "
                        f"{st_last['kill_step']}, revived by autoscaling")
    log(f"[fleet] last-replica drill: spawned {m_last['spawned']}, failed "
        f"{m_last['failed']}, migrations {m_last['router_migrated']}; "
        f"weight-quantize calls {wq_drill} (the first replica's "
        f"{wq_first}); plans.misses {fleet._warm['plans'].misses}")
    if (m_last["spawned"] < 2 or m_last["failed"] != 1 or wq_drill != wq_first
            or fleet._warm["plans"].misses):
        raise AssertionError(f"last-replica drill: {m_last}")
    del fleet
    torch.cuda.synchronize()
    counts = {k["name"]: count(k) for k in kernels}
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[fleet] {cfg.name} x {FLEET['replicas']} replicas ({smi}): time to "
        f"recover {st['recover_ms']:.3f} ms ({st['recover_steps']} fleet "
        f"steps from the kill until every migrated request streamed its next "
        f"token); fleet tokens/s {st['tok_s']:.2f} with the kill "
        f"({st['steps']} fleet steps, {st['wall_s']:.3f} s) and "
        f"{st_nokill['tok_s']:.2f} without ({st_nokill['steps']} fleet "
        f"steps, {st_nokill['wall_s']:.3f} s); last-replica drill: time to "
        f"recover {st_last['recover_ms']:.3f} ms, {st_last['steps']} steps")
    log(f"[fleet] kernel launches over the fleet waves: {counts}; CUDA-core "
        f"GEMM route {core}; max_memory_allocated {peak / 2**30:.2f} GiB")
    if counts["entangled_matmul"] <= 0:
        raise AssertionError("the fleet path never launched the dense GEMM")
    if any(core.values()):
        raise AssertionError(f"packed GEMMs reached the CUDA-core kernel: "
                             f"{core}")
    del params
    free_cuda()
    return counts, dict(lengths=lengths, kill=st, no_kill=st_nokill,
                        last_replica=st_last, migrations=mig,
                        weight_quantize_calls=wq_fleet,
                        max_memory_allocated=peak)


# --------------------------------------------------------- dense-decoders --

def phase_decoders(dev, kernels, smi):
    """qwen2-7b, minitron-8b and granite-20b (cut as DECODERS says), one at
    a time at published widths: the engine's startup census at scope all,
    every (site, shape) and the vocab head held against the plain version
    on the s8 route; the 8-request wave at ft_mode none and at entangle /
    all, healthy and with failed_group=1 on a warm replica (EXACT
    ROLL-FORWARD, equal tokens); decode-step ms, s8 launches per decode
    step and max_memory_allocated. Every kernel's count is set to 0 just
    before each arch's waves and read just after. Returns (counts by arch,
    record)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    chk = next(k["checker"] for k in kernels
               if k["name"] == "entangled_matmul")
    out, counts_by = {}, {}
    for arch in DECODERS:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg, _, params = init_model(dev, arch)
        base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                    ft_M=SERVE["ft_M"])
        scfg = ServeConfig(ft_mode="entangle", ft_scope="all", **base)
        eng = ServeEngine(cfg, scfg, params, device=dev)
        shapes, _ = census_shapes(cfg, eng.protected_census)
        warm = eng.warm_state()
        del eng
        free_cuda()
        arch_chk = chk.spawn()
        check_dense(dev, arch_chk, shapes, ragged=False)
        chk.absorb(arch_chk)
        narrow = sorted({(K, N) for _, K, N, _ in shapes if N < 256})
        log(f"[dense-decoders] {arch}: {len(warm['census'])} census "
            f"entries at scope all, {len(shapes)} (rows, K, N) shapes with "
            f"the head; {arch_chk.n} kernel-vs-plain comparisons, max_abs_err"
            f" by route {arch_chk.worst_by_route}; narrower than one "
            f"256-column tile: {narrow}")

        reset_counts(kernels)
        res = {}
        for name, kw, fg in (("none", dict(ft_mode="none"), None),
                             ("entangle", dict(ft_mode="entangle",
                                               ft_scope="all"), None),
                             ("entangle failed_group=1",
                              dict(ft_mode="entangle", ft_scope="all"), 1)):
            sc = ServeConfig(**kw, **base)
            e = ServeEngine(cfg, sc, params, device=dev,
                            warm=warm if kw["ft_mode"] == "entangle" else None)
            outs, steps, launched = _wave(e, cfg, fg, kernels)
            if e.plans is not None and e.plans.misses:
                raise AssertionError(f"{arch} {name}: plan misses")
            res[name] = dict(outs=outs, step_ms=1e3 * float(np.mean(steps[1:])),
                             first_step_ms=1e3 * steps[0],
                             per_decode_step={k: sorted(set(v[1:])) for k, v
                                              in launched.items()})
            del e
            free_cuda()
        healthy, injected = (res["entangle"]["outs"],
                             res["entangle failed_group=1"]["outs"])
        bad = sum(not np.array_equal(healthy[r], injected[r])
                  for r in healthy)
        verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
        log(f"[dense-decoders] {arch} recovery summary [scope=all]: "
            f"failed_group=1 injected on every step; {len(healthy)} requests "
            f"/ {sum(len(v) for v in healthy.values())} tokens compared; "
            f"mismatching requests: {bad} ({verdict})")
        if bad:
            raise AssertionError(f"{arch}: {verdict}")
        counts = {k["name"]: count(k) for k in kernels}
        core = {k["name"]: count(k, 1) for k in kernels
                if len(k["counters"]) > 1}
        if counts["entangled_matmul"] <= 0 or any(core.values()):
            raise AssertionError(f"{arch}: s8 launches {counts}, CUDA-core "
                                 f"{core}")
        peak = torch.cuda.max_memory_allocated(dev)
        secs = time.perf_counter() - t0
        rec = dict(
            n_layers=cfg.n_layers, census_shapes=len(shapes),
            step_ms={n: r["step_ms"] for n, r in res.items()},
            first_step_ms={n: r["first_step_ms"] for n, r in res.items()},
            launches_per_decode_step={n: r["per_decode_step"]
                                      for n, r in res.items()},
            max_memory_allocated=peak, seconds=secs)
        s8_steps = {n: r["per_decode_step"]["entangled_matmul"]
                    for n, r in res.items()}
        log(f"[dense-decoders] {arch} ({cfg.n_layers} layers; {smi}): mean "
            f"decode-step ms {rec['step_ms']} (admission + first step "
            f"{rec['first_step_ms']}); s8 launches per decode step "
            f"{s8_steps}; kernel launches {counts}; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; {secs:.1f} s")
        out[arch], counts_by[arch] = rec, counts
        del params, warm
        free_cuda()
    return counts_by, out


# -------------------------------------------------------------- recurrent --

def _long_request(dev, cfg, params, failed_group, warm):
    """recurrentgemma's long request: LONG["prompt"] seeded tokens under
    chunked prefill (one bucket, LONG["bucket"]) and LONG["max_new"] new
    tokens at scope all; returns (tokens, engine, seconds)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    scfg = ServeConfig(max_batch=SERVE["max_batch"], max_seq=LONG["max_seq"],
                       ft_mode="entangle", ft_M=SERVE["ft_M"],
                       ft_scope="all", prefill_buckets=(LONG["bucket"],),
                       prefill_chunk=LONG["chunk"])
    eng = ServeEngine(cfg, scfg, params, device=dev, warm=warm)
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, LONG["prompt"]).astype(np.int32)
    t0 = time.perf_counter()
    h = eng.submit(Request(rid=0, prompt=prompt, max_new=LONG["max_new"]))
    eng.run_to_completion(failed_group=failed_group)
    torch.cuda.synchronize()
    out = np.asarray(h.req.out)
    if out.shape != (LONG["max_new"],) or eng.plans.misses:
        raise AssertionError(f"long request: output {out}, misses "
                             f"{eng.plans.misses}")
    return out, eng, time.perf_counter() - t0


def phase_recurrent(dev, kernels, smi, seed):
    """falcon-mamba-7b (cut to RECURRENT_LAYERS) and recurrentgemma-2b,
    one at a time at published widths: the engine's startup census at scope all in
    every admission mode, every (site, shape) and the vocab head held
    against the plain version on the s8 route (and the real tied / untied
    head, quantized once, at the head's shape); the 8-request wave at
    ft_mode none and at entangle head and all, healthy and with
    failed_group=1 (EXACT ROLL-FORWARD (recurrent)); chunked and packed
    admission of a seeded 12-request wave at scope all, healthy and
    injected, the modes compared under the near-tie rule; for
    recurrentgemma the long request past its window, healthy and
    injected; decode-step ms against none in the same call, s8 launches
    per decode step, max_memory_allocated and a profiler window. Every
    kernel's count is set to 0 just before each arch's serving waves and
    read just after. Returns (counts by arch, record)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    emm_k = next(k for k in kernels if k["name"] == "entangled_matmul")
    chk = emm_k["checker"]
    lengths = admission_lengths(seed, REC_REQUESTS)
    Recording = _recording_engine()
    out, counts_by = {}, {}
    for arch in RECURRENT:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg, model, params = init_model(dev, arch)
        shapes, _ = main_path_shapes(cfg, params, dev)
        arch_chk = chk.spawn()
        check_dense(dev, arch_chk, shapes, ragged=False)
        _check_model_head(dev, arch_chk, cfg, model, params,
                          f"{arch} model head")
        chk.absorb(arch_chk)
        narrow = sorted({(K, N) for _, K, N, _ in shapes if N < 256})
        log(f"[recurrent] {arch}: {len(shapes)} (rows, K, N) shapes of the "
            f"census at scope all (every admission mode) with the head, and "
            f"the model's own quantized head: {arch_chk.n} kernel-vs-plain "
            f"comparisons, max_abs_err by route {arch_chk.worst_by_route}; "
            f"narrower than one 256-column tile: {narrow}; shapes "
            f"{[s[:3] for s in shapes]}")
        free_cuda()

        reset_counts(kernels)
        base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                    ft_M=SERVE["ft_M"])
        res = {}
        for scope in ("head", "all"):
            scfg = ServeConfig(ft_mode="entangle", ft_scope=scope, **base)
            e = ServeEngine(cfg, scfg, params, device=dev)
            healthy, st_h, ln_h = _wave(e, cfg, None, kernels)
            warm = e.warm_state()
            del e
            e = ServeEngine(cfg, scfg, params, device=dev, warm=warm)
            injected, st_i, ln_i = _wave(e, cfg, 1, kernels)
            if e.plans is not None and e.plans.misses:
                raise AssertionError(f"{arch} scope {scope}: plan misses")
            del e, warm
            free_cuda()
            bad = sum(not np.array_equal(healthy[r], injected[r])
                      for r in healthy)
            verdict = ("EXACT ROLL-FORWARD (recurrent)" if bad == 0
                       else "RECOVERY FAILED")
            log(f"[recurrent] {arch} recovery summary [scope={scope}]: "
                f"failed_group=1 injected on every step; {len(healthy)} "
                f"requests / {sum(len(v) for v in healthy.values())} tokens "
                f"compared; mismatching requests: {bad} ({verdict})")
            if bad:
                raise AssertionError(f"{arch} scope {scope}: {verdict}")
            dec = st_h[1:] + st_i[1:]
            res[scope] = dict(
                step_ms=1e3 * float(np.mean(dec)),
                first_step_ms=1e3 * (st_h[0] + st_i[0]) / 2,
                per_decode_step={k: sorted(set(v[1:] + ln_i[k][1:]))
                                 for k, v in ln_h.items()})
        torch.cuda.synchronize()
        wave_counts = {k["name"]: count(k) for k in kernels}

        # chunked and packed admission at scope all, healthy and injected
        admit, healthy_modes = {}, {}
        for mode in REC_MODES:
            scfg = ServeConfig(ft_mode="entangle", ft_scope="all",
                               **base, **ADMIT_MODES[mode])
            e = Recording(cfg, scfg, params, device=dev)
            e.logits_by_rid = {}
            outs, st = _admit_wave(e, cfg, lengths, None)
            healthy_modes[mode] = (outs, e.logits_by_rid)
            warm = e.warm_state()
            del e
            inj, st_i = _admit_wave(ServeEngine(cfg, scfg, params,
                                                device=dev, warm=warm),
                                    cfg, lengths, 1)
            del warm
            free_cuda()
            bad = sum(not np.array_equal(outs[r], inj[r]) for r in outs)
            verdict = ("EXACT ROLL-FORWARD (recurrent)" if bad == 0
                       else "RECOVERY FAILED")
            log(f"[recurrent] {arch} mode={mode} scope=all: failed_group=1 "
                f"injected on every step; {len(outs)} requests (prompts "
                f"{min(lengths)}..{max(lengths)}) / "
                f"{sum(len(v) for v in outs.values())} tokens compared; "
                f"mismatching requests: {bad} ({verdict}); misses 0; "
                f"{st['steps']} steps, {st['prefill_calls']} prefill calls, "
                f"wave {st['wall_s']:.2f} s, TTFT p50 {st['ttft_p50_ms']:.1f}"
                f" ms, {st['tok_s']:.2f} tokens/s ({smi})")
            if bad:
                raise AssertionError(f"{arch} {mode}: {verdict}")
            admit[mode] = dict(healthy=st, injected=st_i)
        pair = _mode_pair(healthy_modes["chunked"], healthy_modes["packed"],
                          f"{arch} chunked vs packed")
        log(f"[recurrent] {arch} chunked vs packed scope=all: "
            f"{pair['agree']} of {pair['total']} tokens agree; {pair}")
        del healthy_modes
        free_cuda()

        long = None
        if cfg.local_window:
            toks, e, secs = _long_request(dev, cfg, params, None, None)
            warm = e.warm_state()
            del e
            toks_i, e, secs_i = _long_request(dev, cfg, params, 1, warm)
            del e, warm
            free_cuda()
            ok = np.array_equal(toks, toks_i)
            verdict = ("EXACT ROLL-FORWARD (recurrent)" if ok
                       else "RECOVERY FAILED")
            log(f"[recurrent] {arch} long request: {LONG['prompt']} prompt "
                f"tokens (window {cfg.local_window}, chunks of "
                f"{LONG['chunk']}), {LONG['max_new']} new at scope all; "
                f"healthy {secs:.2f} s, failed_group=1 {secs_i:.2f} s; "
                f"tokens {toks.tolist()} ({verdict})")
            if not ok:
                raise AssertionError(f"{arch} long request: {verdict}")
            long = dict(prompt=LONG["prompt"], healthy_s=secs,
                        injected_s=secs_i)
        torch.cuda.synchronize()
        counts = {k["name"]: count(k) for k in kernels}
        core = {k["name"]: count(k, 1) for k in kernels
                if len(k["counters"]) > 1}
        if counts["entangled_matmul"] <= 0 or any(core.values()):
            raise AssertionError(f"{arch}: s8 launches {counts}, CUDA-core "
                                 f"{core}")
        bd = _breakdown(dev, cfg, params, dict(base, ft_mode="entangle"),
                        tag="recurrent")
        peak = torch.cuda.max_memory_allocated(dev)
        secs = time.perf_counter() - t0
        s8_steps = {n: r["per_decode_step"]["entangled_matmul"]
                    for n, r in res.items()}
        rec = dict(n_layers=cfg.n_layers, census_shapes=len(shapes),
                   step_ms=dict({n: r["step_ms"] for n, r in res.items()},
                                none=bd["step_ms"]),
                   first_step_ms={n: r["first_step_ms"]
                                  for n, r in res.items()},
                   s8_launches_per_decode_step=s8_steps,
                   wave_counts=wave_counts, admission=admit, mode_pair=pair,
                   long=long, profile=bd, max_memory_allocated=peak,
                   seconds=secs)
        log(f"[recurrent] {arch} ({cfg.n_layers} layers; {smi}): mean "
            f"decode-step ms {rec['step_ms']} (admission + first step "
            f"{rec['first_step_ms']}); s8 launches per decode step "
            f"{s8_steps}; kernel launches {counts}; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB; {secs:.1f} s")
        out[arch], counts_by[arch] = rec, counts
        del params, model
        free_cuda()
    return counts_by, out


# --------------------------------------------------------------- families --

def _check_model_head(dev, chk, cfg, model, params, what):
    """The model's own head (the tied embedding's transpose where tied),
    quantized once from a contiguous copy of the [D, V] matrix as the
    engine does, held against the plain version in every mode on both
    routes, at the serving batch's rows per group."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.ft.quantize import quantize_weight_stacked

    plan = make_plan(SERVE["ft_M"], 32)
    hq = quantize_weight_stacked(
        model.head_weights(params, cfg).contiguous()[None],
        packed=True)["w"][0]
    bud = activation_budget(plan, cfg.d_model)
    gen = torch.Generator(device=dev).manual_seed(99)
    c = _rand(gen, -bud, bud + 1, (plan.M, SERVE["max_batch"]
                                   // SERVE["ft_M"], cfg.d_model), dev)
    chk.sweep(c, hq, plan, True, what, DENSE_MODES)
    del hq, c
    free_cuda()


def _snapshot(cache):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), cache)


def _restore(cache, snap):
    from repro_torch.tree import tree_map

    tree_map(lambda t, s: t.copy_(s), cache, snap)


def _decode_run(model, cfg, params, cache, tok, pos0, steps, head, ftx,
                failed_group, kernels):
    """``steps`` greedy steps from ``tok`` [B, 1] at positions ``pos0``
    [B] + t: ``decode_hidden`` (with ``ftx`` failed at ``failed_group``
    when given), then the protected head ``head`` = (wq, scale, plan)
    failed at ``failed_group`` (``ft_logits_decode``), or the plain bf16
    head when ``head`` is None. Returns (tokens [B, steps], step seconds,
    s8 launches per step)."""
    import numpy as np
    import torch

    from repro_torch.ft.heads import ft_logits_decode

    emm_k = next(k for k in kernels if k["name"] == "entangled_matmul")
    ctx = None if ftx is None else ftx.with_failed(failed_group)
    out, secs, s8 = [], [], []
    for t in range(steps):
        before = count(emm_k)
        t0 = time.perf_counter()
        h, cache = model.decode_hidden(params, tok, cache, pos0 + t, cfg,
                                       ft=ctx)
        if head is None:
            logits = model.head_project(params, h, cfg)
        else:
            logits = ft_logits_decode(h, head[0], head[1], plan=head[2],
                                      failed_group=failed_group)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        s8.append(count(emm_k) - before)
        out.append(tok[:, 0])
    toks = torch.stack(out, 1).cpu().numpy()
    if not np.isfinite(logits.float().cpu().numpy()).all() \
            or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: bad decode output {toks}")
    return toks, secs, s8


def _protected_head(cfg, model, params):
    """(packed int8 head, scale, plan) as the engine makes them."""
    from repro_torch.core.plan import make_plan
    from repro_torch.ft.heads import quantize_head
    from repro_torch.kernels.codec import pack_int8

    hq, scale = quantize_head(model.head_weights(params, cfg))
    return pack_int8(hq, axis=0), scale, make_plan(SERVE["ft_M"], 32)


def _rollforward(runs, tag, what):
    """Log and check one EXACT ROLL-FORWARD (``tag``) verdict: ``runs``
    maps a run's name to its tokens; every run must equal the first."""
    import numpy as np

    names = list(runs)
    base = runs[names[0]]
    bad = [n for n in names[1:] if not np.array_equal(runs[n], base)]
    verdict = f"EXACT ROLL-FORWARD ({tag})" if not bad else "RECOVERY FAILED"
    log(f"[families] {what}: {base.shape[0]} rows x {base.shape[1]} tokens;"
        f" runs {names} against {names[0]!r}; mismatching runs {bad} "
        f"({verdict})")
    if bad:
        raise AssertionError(f"{what}: {verdict}")


def _vlm_path(dev, kernels, smi, chk):
    """internvl2-2b: census shapes and heads against the plain version;
    the engine's wave at head and all, healthy and injected, and none;
    the 256-patch prefix path at head and all; a profiler window."""
    import numpy as np
    import torch

    from repro_torch.ft import FTContext, PlanRegistry, prepare_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model, params = init_model(dev, VLM)
    shapes, _ = main_path_shapes(cfg, params, dev)
    arch_chk = chk.spawn()
    check_dense(dev, arch_chk, shapes, ragged=False)
    _check_model_head(dev, arch_chk, cfg, model, params, f"{VLM} model head")
    chk.absorb(arch_chk)
    log(f"[families] {VLM}: {len(shapes)} (rows, K, N) shapes of the census "
        f"at scope all (every admission mode) with the head, and the "
        f"model's own quantized head: {arch_chk.n} kernel-vs-plain "
        f"comparisons, max_abs_err by route {arch_chk.worst_by_route}")

    reset_counts(kernels)
    base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                ft_M=SERVE["ft_M"])
    wave = {}
    for scope in ("head", "all"):
        scfg = ServeConfig(ft_mode="entangle", ft_scope=scope, **base)
        e = ServeEngine(cfg, scfg, params, device=dev)
        healthy, st_h, ln_h = _wave(e, cfg, None, kernels)
        warm = e.warm_state()
        del e
        e = ServeEngine(cfg, scfg, params, device=dev, warm=warm)
        injected, st_i, ln_i = _wave(e, cfg, 1, kernels)
        if e.plans is not None and e.plans.misses:
            raise AssertionError(f"{VLM} scope {scope}: plan misses")
        del e, warm
        free_cuda()
        _rollforward({"healthy": np.stack(list(healthy.values())),
                      "failed_group=1": np.stack(list(injected.values()))},
                     "vlm", f"{VLM} engine wave, scope={scope}, "
                     f"failed_group=1 on every step")
        wave[scope] = dict(
            step_ms=1e3 * float(np.mean(st_h[1:] + st_i[1:])),
            s8_per_decode_step=sorted(set(ln_h["entangled_matmul"][1:]
                                          + ln_i["entangled_matmul"][1:])))

    # the prefix path: prefill of 256 patch embeddings and 8 tokens, then
    # decode_hidden and the protected head at positions P + T + t
    B, P = SERVE["max_batch"], PREFIX["patches"]
    gen = torch.Generator(device=dev).manual_seed(3)
    patches = torch.randn((B, P, cfg.d_model), generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, SERVE["prompt_len"]),
                            generator=gen, device=dev)
    cache = model.init_cache(cfg, B, PREFIX["max_seq"], device=dev)
    t1 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts,
                                           "patch_embeds": patches}, cfg,
                                  cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    if logits.shape != (B, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{VLM} prefix prefill: bad logits")
    tok0 = logits.argmax(-1, keepdim=True)
    pos0 = torch.full((B,), P + SERVE["prompt_len"], device=dev)
    snap = _snapshot(cache)
    head = _protected_head(cfg, model, params)
    ft_params = prepare_params(params, scope="all")
    prefix = {}
    for scope in ("head", "all"):
        ftx = (None if scope == "head" else
               FTContext(registry=PlanRegistry(head[2]), scope="all"))
        p = params if scope == "head" else ft_params
        runs, ms, s8 = {}, [], []
        for fg in (None, 1):
            _restore(cache, snap)
            runs[f"failed_group={fg}"], secs, per_step = _decode_run(
                model, cfg, p, cache, tok0, pos0, PREFIX["steps"], head, ftx,
                fg, kernels)
            ms += secs[1:]
            s8 += per_step
        _rollforward(runs, "vlm", f"{VLM} prefix path, {P} patch embeddings "
                     f"+ {SERVE['prompt_len']} tokens, scope={scope}, "
                     f"failed_group=1 on every step")
        prefix[scope] = dict(step_ms=1e3 * float(np.mean(ms)),
                             s8_per_decode_step=sorted(set(s8)))
    del cache, snap, ft_params, head
    free_cuda()
    torch.cuda.synchronize()
    counts = {k["name"]: count(k) for k in kernels}
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    if counts["entangled_matmul"] <= 0 or any(core.values()):
        raise AssertionError(f"{VLM}: s8 launches {counts}, CUDA-core "
                             f"{core}")
    bd = _breakdown(dev, cfg, params, dict(base, ft_mode="entangle"),
                    tag="families")
    peak = torch.cuda.max_memory_allocated(dev)
    rec = dict(census_shapes=len(shapes),
               step_ms=dict({s: r["step_ms"] for s, r in wave.items()},
                            none=bd["step_ms"]),
               s8_launches_per_decode_step={
                   s: r["s8_per_decode_step"] for s, r in wave.items()},
               prefix=dict(prefill_s=prefill_s, **prefix), profile=bd,
               max_memory_allocated=peak,
               seconds=time.perf_counter() - t0)
    log(f"[families] {VLM} ({cfg.n_layers} layers; {smi}): engine decode-"
        f"step ms {rec['step_ms']}, s8 launches per decode step "
        f"{rec['s8_launches_per_decode_step']}; prefix path: prefill of "
        f"{B} x ({P} + {SERVE['prompt_len']}) {1e3 * prefill_s:.3f} ms, "
        f"decode-step ms and s8 launches per step {prefix}; kernel "
        f"launches {counts}; max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"{rec['seconds']:.1f} s")
    del params, model
    free_cuda()
    return counts, rec


def _encdec_path(dev, kernels, smi, chk):
    """whisper-small: its head against the plain version; the engine's
    refusals; prefill of 8 rows of 1500 frames and 8-token prompts, then
    16 decode steps with the bf16 head (ft none) and with the protected
    head, healthy and with failed_group=1 on every step."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model, params = init_model(dev, ENCDEC, max_seq=WHISPER["max_seq"])
    shapes, _ = census_shapes(cfg, set())  # scope head: the head alone
    arch_chk = chk.spawn()
    check_dense(dev, arch_chk, shapes, ragged=False)
    _check_model_head(dev, arch_chk, cfg, model, params,
                      f"{ENCDEC} model head")
    chk.absorb(arch_chk)
    log(f"[families] {ENCDEC}: the head {shapes} and the model's own "
        f"quantized head: {arch_chk.n} kernel-vs-plain comparisons, "
        f"max_abs_err by route {arch_chk.worst_by_route}")

    kw = dict(max_batch=SERVE["max_batch"], max_seq=WHISPER["max_seq"],
              ft_mode="entangle", ft_M=SERVE["ft_M"])
    refusals = {}
    try:
        ServeEngine(cfg, ServeConfig(ft_scope="all", **kw), params,
                    device=dev)
    except ValueError as err:
        refusals["scope all"] = f"ValueError: {err}"
    eng = ServeEngine(cfg, ServeConfig(ft_scope="head", **kw), params,
                      device=dev)
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                       max_new=2))
    try:
        eng.step()
    except NotImplementedError as err:
        refusals["scope head step"] = f"NotImplementedError: {err}"
    del eng
    free_cuda()
    log(f"[families] {ENCDEC} engine on the card, as the reference's: "
        f"{refusals}")
    if len(refusals) != 2:
        raise AssertionError(f"{ENCDEC}: the engine did not refuse: "
                             f"{refusals}")

    reset_counts(kernels)
    B = SERVE["max_batch"]
    gen = torch.Generator(device=dev).manual_seed(4)
    frames = torch.randn((B, cfg.encoder.n_frames, cfg.d_model),
                         generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, SERVE["prompt_len"]),
                            generator=gen, device=dev)
    cache = model.init_cache(cfg, B, WHISPER["max_seq"], device=dev)
    t1 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts,
                                           "frames": frames}, cfg, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    enc = api._encode(params, frames, cfg)
    torch.cuda.synchronize()
    encoder_ms = 1e3 * (time.perf_counter() - t1)
    if logits.shape != (B, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or \
            not torch.isfinite(enc.float()).all():
        raise AssertionError(f"{ENCDEC} prefill: bad output")
    del enc
    tok0 = logits.argmax(-1, keepdim=True)
    pos0 = torch.full((B,), SERVE["prompt_len"], device=dev)
    snap = _snapshot(cache)
    head = _protected_head(cfg, model, params)
    runs, ms, s8 = {}, {}, {}
    # a warm-up run first (not kept), so that no timed run pays the first
    # calls' set-up
    for name, h, fg in (("warm-up", head, None), ("none", None, None),
                        ("head", head, None),
                        ("head failed_group=1", head, 1)):
        _restore(cache, snap)
        runs[name], secs, s8[name] = _decode_run(
            model, cfg, params, cache, tok0, pos0, WHISPER["steps"], h, None,
            fg, kernels)
        ms[name] = 1e3 * float(np.mean(secs[1:]))
    for d in (runs, ms, s8):
        del d["warm-up"]
    _rollforward({n: runs[n] for n in ("head", "head failed_group=1")},
                 "encdec", f"{ENCDEC} {B} rows x {cfg.encoder.n_frames} "
                 f"frames + {SERVE['prompt_len']} tokens, scope=head, "
                 f"failed_group=1 on every step")
    agree = int((runs["none"] == runs["head"]).sum())
    del cache, snap, head
    torch.cuda.synchronize()
    counts = {k["name"]: count(k) for k in kernels}
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    s8_steps = {n: sorted(set(v)) for n, v in s8.items()}
    if counts["entangled_matmul"] <= 0 or any(core.values()) or \
            s8_steps["head"] != [1]:
        raise AssertionError(f"{ENCDEC}: s8 launches {counts} ({s8_steps} "
                             f"per step), CUDA-core {core}")
    peak = torch.cuda.max_memory_allocated(dev)
    rec = dict(prefill_s=prefill_s, encoder_ms=encoder_ms, step_ms=ms,
               s8_launches_per_decode_step=s8_steps,
               tokens_agree_none_vs_head=agree, refusals=refusals,
               max_memory_allocated=peak, seconds=time.perf_counter() - t0)
    log(f"[families] {ENCDEC} ({cfg.n_layers} + {cfg.encoder.n_layers} "
        f"layers; {smi}): prefill of {B} x {cfg.encoder.n_frames} frames + "
        f"{SERVE['prompt_len']} tokens {1e3 * prefill_s:.3f} ms, encoder "
        f"alone {encoder_ms:.3f} ms; decode-step ms {ms}; s8 launches per "
        f"decode step {s8_steps}; greedy tokens bf16 head vs protected "
        f"head: {agree} of {runs['none'].size} agree; kernel launches "
        f"{counts}; max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"{rec['seconds']:.1f} s")
    del params, model
    free_cuda()
    return counts, rec


def _chain_path(dev, kernels):
    """``entangled_chain`` over the serving batch's rows (CHAINS): healthy,
    with every stream failed in turn (each must equal the healthy run bit
    for bit), and on CPU copies through the plain versions (equal too)."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft import (chain_budget, entangled_chain,
                                quantize_weight_stacked)

    reset_counts(kernels)
    emm_k = next(k for k in kernels if k["name"] == "entangled_matmul")
    gen = torch.Generator(device=dev).manual_seed(5)
    rec = []
    for M, dims in CHAINS:
        plan = make_plan(M, 32)
        x = torch.randn((SERVE["max_batch"], dims[0]), generator=gen,
                        device=dev)
        ws = []
        for k, n in zip(dims[:-1], dims[1:]):
            q8 = quantize_weight_stacked(torch.randn(
                (1, k, n), generator=gen, device=dev), packed=True)
            ws.append((q8["w"][0], q8["scale"][0]))
        budget = chain_budget(plan, dims[:-1])
        before = count(emm_k)
        healthy = entangled_chain(x, ws, plan=plan)
        per_call = count(emm_k) - before
        plain = entangled_chain(x.cpu(), [(w.cpu(), s.cpu()) for w, s in ws],
                                plan=plan)
        torch.cuda.synchronize()
        if not torch.equal(healthy.cpu(), plain):
            raise AssertionError(f"entangled_chain M={M} {dims}: kernel "
                                 f"!= plain")
        bad = [r for r in range(M) if not torch.equal(
            entangled_chain(x, ws, plan=plan, failed_group=r), healthy)]
        verdict = "EXACT ROLL-FORWARD (chain)" if not bad else \
            "RECOVERY FAILED"
        how = ("one entangle, one extraction" if budget >= 1
               else "infeasible: one extraction per hop")
        log(f"[families] entangled_chain M={M} widths {dims}: chain budget "
            f"{budget} ({how}), {per_call} s8 launches per call; equal to "
            f"the plain version on the CPU; every failed stream 0..{M - 1} "
            f"against healthy: mismatching {bad} ({verdict})")
        if bad:
            raise AssertionError(f"entangled_chain M={M} {dims}: {verdict}")
        rec.append(dict(M=M, widths=list(dims), budget=budget,
                        s8_launches_per_call=per_call))
    counts = {k["name"]: count(k) for k in kernels}
    if counts["entangled_matmul"] <= 0:
        raise AssertionError(f"entangled_chain: launches {counts}")
    return counts, rec


def _odd_head_rows(dev):
    """The s8 kernel (and the CUDA-core one, in turns) at the two odd-width
    heads, internvl2-2b [2048 x 92553] and whisper-small [768 x 51865],
    at decode rows: their rows of packed weights are not 16-byte aligned,
    so the kernel takes its ragged path of 4-byte copies."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels.codec import pack_int8

    plan = make_plan(SERVE["ft_M"], 32)
    M, B = plan.M, SERVE["max_batch"] // SERVE["ft_M"]
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for arch in (VLM, ENCDEC):
        cfg = model_config(arch)
        K, N = cfg.d_model, cfg.vocab_size
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (M, B, K), dev)
        wbytes = (K // 4) * N * 4
        gs = [pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
              for _ in range(max(1, -(-2 * L2_BYTES // wbytes)))]
        rows.append(_timing_row(
            dev, f"{arch} head (N = {N}, ragged)", c, gs, plan,
            dict(s8=emm.entangled_matmul_cuda,
                 cuda_core=emm.entangled_matmul_cuda_core),
            emm.entangled_matmul_plain, macs=(M - 1) * B * K * N,
            nbytes=4 * (M * B * K + (K // 4) * N + M * B * N),
            wbytes=wbytes, iters=20))
        del c, gs
        free_cuda()
    return rows


def phase_families(dev, kernels, smi):
    """internvl2-2b and whisper-small at published widths, nothing cut,
    and ``entangled_chain``, each a path whose kernel counts are set to 0
    just before it and read just after; then the s8 kernel's time at the
    two odd-width heads. Returns (counts by path, record, timing rows)."""
    t0 = time.perf_counter()
    chk = next(k["checker"] for k in kernels
               if k["name"] == "entangled_matmul")
    counts, rec = {}, {}
    counts[f"{VLM} families"], rec[VLM] = _vlm_path(dev, kernels, smi, chk)
    counts[f"{ENCDEC} families"], rec[ENCDEC] = _encdec_path(
        dev, kernels, smi, chk)
    counts["entangled_chain"], rec["entangled_chain"] = _chain_path(
        dev, kernels)
    rows = _odd_head_rows(dev)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[families] phase {rec['seconds']:.1f} s")
    return counts, rec, rows


# --------------------------------------------------------------- serve-v3 --

def _has_q8(tree) -> bool:
    if isinstance(tree, dict):
        return any(k.endswith("q8") or _has_q8(v) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return any(_has_q8(v) for v in tree)
    return False


def phase_serve_v3(dev, kernels, smi):
    """deepseek-v3-671b at published widths cut to V3_LAYERS layers (the 3
    published dense layers and 1 MoE layer of 256 experts, top-8, sigmoid
    gating; MLA with the low-rank Q; the MTP block built and never
    quantized), with bf16 masters (``init(master_dtype=torch.bfloat16)``):
    the 8-request wave at scopes moe and all, healthy and with
    ``failed_group=1`` on a warm replica (EXACT ROLL-FORWARD (serve-v3)),
    then ``ft_mode none`` and a profiler window of 2 decode steps at scope
    all. Kernel counts are set to 0 just before the waves and read just
    after; both GEMMs must have launched, on their s8 route only. Then,
    with the model freed, every (site, shape) of the scope-all census and
    the head held bit for bit against the plain versions on both routes
    (packed weights, the serving plan). Returns (counts, record)."""
    import numpy as np
    import torch

    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.tree import leaves_with_path

    t_phase = time.perf_counter()
    cfg = model_config(V3)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        max_seq=SERVE["max_seq"], device=dev,
                        master_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat = leaves_with_path(params)
    n = sum(t.numel() for _, t in flat)
    n_mtp = sum(t.numel() for p, t in flat if p.startswith("['mtp']"))
    n_bytes = sum(t.numel() * t.element_size() for _, t in flat)
    n32 = sum(t.numel() for _, t in flat if t.dtype == torch.float32)
    del flat
    init_peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve-v3] {V3} published widths, {_depth(cfg, V3)} (the "
        f"shallowest cut that keeps the published first_dense_layers="
        f"{cfg.moe.first_dense_layers}): d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}, MLA q_lora {cfg.mla.q_lora_rank} kv_lora "
        f"{cfg.mla.kv_lora_rank}, dense d_ff {cfg.d_ff}, {cfg.moe.n_experts}"
        f" experts top-{cfg.moe.top_k} ({cfg.moe.gating}, d_ff "
        f"{cfg.moe.d_ff_expert}, {cfg.moe.n_shared} shared), vocab "
        f"{cfg.vocab_size}, MTP block; {n / 1e9:.3f} G params "
        f"({n_mtp / 1e9:.3f} G in mtp), bf16 masters {n_bytes / 1e9:.2f} GB "
        f"({n32} float32 norm elements); random init {init_s:.1f} s; "
        f"max_memory_allocated {init_peak / 2**30:.2f} GiB ({smi})")
    cache = model.init_cache(cfg, 2, 16, device=dev)
    h, _ = model.prefill_chunk(
        params, torch.randint(0, cfg.vocab_size, (2, 8), device=dev), cfg,
        cache, pos0=0, lengths=torch.tensor([8, 5], device=dev))
    if h.shape != (2, 8, cfg.d_model) or not torch.isfinite(h.float()).all():
        raise AssertionError(f"v3 prefill hidden states bad: {h.shape}")
    del cache, h
    base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                ft_mode="entangle", ft_M=SERVE["ft_M"])
    reset_counts(kernels)
    results, census = {}, None
    for scope in ("moe", "all"):
        scfg = ServeConfig(ft_scope=scope, **base)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, scfg, params, device=dev)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        if _has_q8(eng.ft_params["mtp"]):
            raise AssertionError("prepare_params quantized the MTP block")
        healthy, st_h, ln_h = _wave(eng, cfg, None, kernels)
        eng2 = ServeEngine(cfg, scfg, params, device=dev,
                           warm=eng.warm_state())
        injected, st_i, ln_i = _wave(eng2, cfg, 1, kernels)
        bad = sum(not np.array_equal(healthy[r], injected[r])
                  for r in healthy)
        ntok = sum(len(v) for v in healthy.values())
        verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
        log(f"[serve-v3] {V3} recovery summary [scope={scope}]: "
            f"failed_group=1 injected on every step; {len(healthy)} requests "
            f"/ {ntok} tokens compared; mismatching requests: {bad} "
            f"({verdict} (serve-v3))")
        if bad:
            raise AssertionError(f"{V3} scope {scope}: {verdict}")
        if eng.plans.misses:
            raise AssertionError("compiled plans missed a shape")
        dec = st_h[1:] + st_i[1:]
        per_step = {name: sorted(set(ln_h[name][1:] + ln_i[name][1:]))
                    for name in ln_h}
        results[scope] = dict(
            step_ms=1e3 * sum(dec) / len(dec), prepare_s=prepare_s,
            first_step_ms=1e3 * (st_h[0] + st_i[0]) / 2,
            tok_s=2 * ntok / (sum(st_h) + sum(st_i)),
            launches_per_decode_step=per_step,
            launches_first_step={k: v[0] for k, v in ln_h.items()})
        log(f"[serve-v3] {V3} scope={scope}: engine startup (census, plans, "
            f"int8 copies) {prepare_s:.2f} s; mean decode-step "
            f"{results[scope]['step_ms']:.3f} ms, admission+first step "
            f"{results[scope]['first_step_ms']:.3f} ms, "
            f"{results[scope]['tok_s']:.1f} tokens/s; kernel launches per "
            f"decode step {per_step} (admission step "
            f"{results[scope]['launches_first_step']}); first output "
            f"{healthy[0].tolist()} ({smi})")
        if scope == "all":
            census = set(eng.protected_census)
        del eng, eng2
        free_cuda()
    counts = {k["name"]: count(k) for k in kernels}
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve-v3] {V3} kernel launches over the 4 waves: {counts}; "
        f"CUDA-core GEMM route {core}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({smi})")
    for name in ("entangled_matmul", "entangled_matmul_grouped"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"{V3} path")
    if any(core.values()):
        raise AssertionError(f"packed GEMMs of the {V3} path reached the "
                             f"CUDA-core kernel: {core}")
    breakdown = _breakdown(dev, cfg, params, base, tag="serve-v3")
    absorb = v3_absorb(dev, kernels, smi, cfg, model, params, base, results)
    del params, model
    free_cuda()
    t0 = time.perf_counter()
    dense, grouped = census_shapes(cfg, census)
    by_name = {k["name"]: k for k in kernels}
    errs = {}
    for name, fn, shapes in (
            ("entangled_matmul", check_dense, dense),
            ("entangled_matmul_grouped", check_grouped, grouped)):
        chk = by_name[name]["checker"].spawn()
        kw = dict(full_range=False) if fn is check_grouped else {}
        fn(dev, chk, shapes, ragged=False, **kw)
        errs[name] = dict(max_abs_err=dict(chk.worst_by_route),
                          comparisons=dict(chk.n_by_route))
        by_name[name]["checker"].absorb(chk)
    check_s = time.perf_counter() - t0
    kn = sorted({(K, N, sites) for _, K, N, sites in dense})
    ekn = sorted({(E, K, N, sites) for E, _, K, N, sites in grouped})
    log(f"[serve-v3] {V3} census at scope all: {len(census)} (site, shape) "
        f"entries -> {len(dense)} dense shapes with the {cfg.vocab_size}-"
        f"column head ((K, N): {kn}; rows per group "
        f"{sorted({k[0] for k in dense})}) and {len(grouped)} grouped "
        f"shapes ((E, K, N): {ekn}; rows per group per expert "
        f"{sorted({k[1] for k in grouped})}), held against the plain "
        f"versions in {check_s:.1f} s: {errs}")
    rec = dict(layers=V3_LAYERS, n_params=n, n_params_mtp=n_mtp,
               master_bytes=n_bytes, init_s=init_s, peak_gib=peak / 2**30,
               scopes=results, breakdown=breakdown, census_check=errs,
               census_check_s=check_s, n_dense_shapes=len(dense),
               n_grouped_shapes=len(grouped), absorb=absorb,
               seconds=time.perf_counter() - t_phase)
    log(f"[serve-v3] phase {rec['seconds']:.1f} s")
    return counts, rec


def v3_absorb(dev, kernels, smi, cfg, model, params, base, naive):
    """[serve-v3-absorb]: deepseek-v3 on the same params with the absorbed
    MLA decode (``mla_absorb=True``; prefill stays naive): the 8-request
    wave at scopes moe and all, healthy and with ``failed_group=1`` on a
    warm replica (EXACT ROLL-FORWARD (serve-v3-absorb)), with the naive
    path's s8 launches per decode step (``naive``: its results by scope);
    kernel counts set to 0 just before the waves and read just after. Then
    ``ft_mode none`` and a profiler window (:func:`_breakdown`), and the
    per-step logits against the naive decode's (:func:`_absorb_logits`).
    Returns the record, with the path's counts."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    cfg_a = dataclasses.replace(cfg, mla_absorb=True)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    results = {}
    for scope in ("moe", "all"):
        scfg = ServeConfig(ft_scope=scope, **base)
        eng = ServeEngine(cfg_a, scfg, params, device=dev)
        healthy, st_h, ln_h = _wave(eng, cfg_a, None, kernels)
        eng2 = ServeEngine(cfg_a, scfg, params, device=dev,
                           warm=eng.warm_state())
        injected, st_i, ln_i = _wave(eng2, cfg_a, 1, kernels)
        bad = sum(not np.array_equal(healthy[r], injected[r])
                  for r in healthy)
        ntok = sum(len(v) for v in healthy.values())
        verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
        log(f"[serve-v3-absorb] {V3} recovery summary [scope={scope}]: "
            f"failed_group=1 injected on every step; {len(healthy)} requests "
            f"/ {ntok} tokens compared; mismatching requests: {bad} "
            f"({verdict} (serve-v3-absorb))")
        if bad:
            raise AssertionError(f"{V3} absorbed, scope {scope}: {verdict}")
        if eng.plans.misses or eng2.plans.misses:
            raise AssertionError("compiled plans missed a shape")
        per_step = {name: sorted(set(ln_h[name][1:] + ln_i[name][1:]))
                    for name in ln_h}
        want = naive[scope]["launches_per_decode_step"]
        if per_step != want:
            raise AssertionError(f"absorbed decode launches {per_step} per "
                                 f"step, the naive path {want}")
        dec = st_h[1:] + st_i[1:]
        results[scope] = dict(step_ms=1e3 * sum(dec) / len(dec),
                              naive_step_ms=naive[scope]["step_ms"],
                              launches_per_decode_step=per_step)
        log(f"[serve-v3-absorb] {V3} scope={scope}: mean decode-step "
            f"{results[scope]['step_ms']:.3f} ms (naive "
            f"{results[scope]['naive_step_ms']:.3f} ms); kernel launches per "
            f"decode step {per_step}, the naive path's; first output "
            f"{healthy[0].tolist()} ({smi})")
        del eng, eng2
        free_cuda()
    counts = {k["name"]: count(k) for k in kernels}
    core = {k["name"]: count(k, 1) for k in kernels
            if len(k["counters"]) > 1}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve-v3-absorb] {V3} kernel launches over the 4 waves: {counts};"
        f" CUDA-core GEMM route {core}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({smi})")
    for name in ("entangled_matmul", "entangled_matmul_grouped"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"absorbed {V3} path")
    if any(core.values()):
        raise AssertionError(f"packed GEMMs of the absorbed {V3} path "
                             f"reached the CUDA-core kernel: {core}")
    breakdown = _breakdown(dev, cfg_a, params, base, tag="serve-v3-absorb")
    logits = _absorb_logits(dev, cfg, cfg_a, model, params, smi)
    rec = dict(counts=counts, scopes=results, breakdown=breakdown,
               peak_gib=peak / 2**30, logits=logits,
               seconds=time.perf_counter() - t_phase)
    log(f"[serve-v3-absorb] phase {rec['seconds']:.1f} s")
    return rec


def _absorb_logits(dev, cfg, cfg_a, model, params, smi):
    """The absorbed decode's logits against the naive decode's through the
    model API, as tests/test_perf_variants.py holds them: a prompt of
    ABSORB["prompt"] seeded tokens in each of SERVE["max_batch"] slots,
    prefilled once, then ABSORB["steps"] naive decode steps; before each,
    the absorbed decode runs on a copy of the same cache. Per step max
    |delta| < ABSORB["max_diff"] and cosine > ABSORB["cos"], with each
    step's host ms and its peak memory above the memory held before it.

    As in the reference test no expert drops a token
    (``capacity_factor=1e9``), and, as the CPU tests do, the absorbed step
    is driven along the naive step's MoE routes (its own gate
    probabilities at them): at v3's 256 experts a router near-tie decided
    the other way would part the two far more than the attention does. How
    many token routes the absorbed step would have taken otherwise, and
    the largest top-k gap among them, are printed."""
    import torch

    from repro_torch.models import layers as TL
    from repro_torch.tree import tree_map

    cfg, cfg_a = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=1e9)) for c in (cfg, cfg_a))
    saved, routes, parted = TL._top_k, [], []

    def recording(probs, k):
        vals, idx = saved(probs, k)
        routes.append(idx)
        return vals, idx

    def forcing(probs, k):
        vals, idx = saved(probs, k + 1)
        ids = routes.pop(0)
        differ = (idx[..., :k].sort(-1).values != ids.sort(-1).values).any(-1)
        gap = vals[..., k - 1] - vals[..., k]
        parted.append((int(differ.sum()), float(gap[differ].max())
                       if bool(differ.any()) else 0.0))
        return torch.gather(probs, -1, ids), ids

    B, P = SERVE["max_batch"], ABSORB["prompt"]
    toks = torch.randint(0, cfg.vocab_size, (B, P + ABSORB["steps"]),
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    steps = []
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks[:, :P]}, cfg,
                                     model.init_cache(cfg, B, SERVE["max_seq"],
                                                      device=dev))
            for t in range(P, P + ABSORB["steps"]):
                copy = tree_map(torch.clone, cache)
                out = {}
                for name, c, route in (("naive", cfg, recording),
                                       ("absorbed", cfg_a, forcing)):
                    TL._top_k = route
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    logits, _ = model.decode_step(
                        params, toks[:, t:t + 1],
                        cache if name == "naive" else copy, t, c)
                    torch.cuda.synchronize()
                    out[name] = (logits.float(),
                                 1e3 * (time.perf_counter() - t0),
                                 torch.cuda.max_memory_allocated(dev) - held)
                del copy
                a, b = out["absorbed"][0], out["naive"][0]
                diff = float((a - b).abs().max())
                cos = float((a * b).sum() / (a.norm() * b.norm()))
                agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
                n_parted = sum(n for n, _ in parted)
                gap = max([g for _, g in parted], default=0.0)
                parted.clear()
                steps.append(dict(
                    pos=t, max_abs_diff=diff, cos=cos, argmax_agree=agree,
                    routes_parted=n_parted, parted_max_gap=gap,
                    ms={k: v[1] for k, v in out.items()},
                    peak_over_held_gib={k: v[2] / 2**30
                                        for k, v in out.items()}))
                log(f"[serve-v3-absorb] {V3} decode step at position {t}, "
                    f"{B} slots, one cache: absorbed vs naive logits max "
                    f"|delta| {diff:.6f}, cosine {cos:.7f}, argmax agreement "
                    f"{agree:.3f} (token routes the absorbed step would part"
                    f" from: {n_parted}, largest top-k gap among them "
                    f"{gap:.3e}); step ms naive {out['naive'][1]:.3f} / "
                    f"absorbed {out['absorbed'][1]:.3f}; peak above held "
                    f"memory naive {out['naive'][2] / 2**30:.3f} / absorbed "
                    f"{out['absorbed'][2] / 2**30:.3f} GiB ({smi})")
                if not diff < ABSORB["max_diff"] or not cos > ABSORB["cos"]:
                    raise AssertionError(f"absorbed decode at position {t}: "
                                         f"max |delta| {diff}, cosine {cos}")
    finally:
        TL._top_k = saved
    return steps


# ---------------------------------------------------------------- library --

def phase_library(dev, kernels, smi):
    """The library's examples on the card (``failstop_demo``: every LSB op
    under the three recovery families, the overhead, SDC and the entangled
    shard store; ``serve_lm``: batched against per-slot serving, the
    entangled head under every failed group, ``ft_logits``, the deadline
    drill), each verdict printed as the reference's examples print it;
    then ``sdc.detect`` / ``localize`` on card tensors of LIB_SDC_N columns
    held to the same calls on the CPU, with the disentangle kernel's
    launches. Counts set to 0 just before and read just after. Returns
    (counts, record)."""
    import contextlib
    import io

    import torch

    from repro_torch.core import entangle, make_plan, sdc
    from repro_torch.examples import failstop_demo, serve_lm

    t_phase = time.perf_counter()
    want = {
        failstop_demo: [
            "[sdc] silent corruption detected at position [100], blamed "
            "stream 2 (truth: 2)",
            "[storage] token shard group survived a lost file"],
        serve_lm: [
            "outputs bit-identical",
            "bit-identical under a fail-stop in any of the 4 request groups",
            "standalone ft_logits: exact under any single-group fail-stop",
            "deadline drill: group 2 missed the deadline"]}
    reset_counts(kernels)
    rec = {}
    for mod, lines in want.items():
        name = mod.__name__.rsplit(".", 1)[1]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--device", str(dev)])
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"[library] {name}: {line}")
        rows = [ln.split() for ln in out.splitlines()
                if ln.split()[:1] in (["scale"], ["add"], ["conv"], ["dot"],
                                      ["permute"])]
        missing = [w for w in lines if w not in out]
        if missing or (mod is failstop_demo and (
                len(rows) != 15 or any(r[2] != "True" for r in rows))):
            raise AssertionError(f"{name} on the card: verdicts missing "
                                 f"{missing}")
        rec[name] = dict(seconds=time.perf_counter() - t0)
    plan = make_plan(4, 32)
    gen = torch.Generator(device=dev).manual_seed(11)
    c = _rand(gen, -1000, 1000, (plan.M, LIB_SDC_N), dev)
    delta = entangle(c, plan)
    hits = []
    dis = next(k for k in kernels if k["name"] == "disentangle")
    for j, pos, mag in ((0, 17, 1), (2, LIB_SDC_N // 3, 123456789),
                        (3, LIB_SDC_N - 1, 255), (1, 5, 1 << 15)):
        bad = delta.clone()
        bad[j, pos] += mag
        before = count(dis)
        det, loc = sdc.detect(bad, plan), sdc.localize(bad, plan)
        torch.cuda.synchronize()
        launched = count(dis) - before
        cpu = bad.cpu()
        if not (torch.equal(det.cpu(), sdc.detect(cpu, plan))
                and torch.equal(loc.cpu(), sdc.localize(cpu, plan))):
            raise AssertionError("sdc on the card != sdc on the CPU")
        if not (bool(det[pos]) and int(det.sum()) == 1
                and launched == 3 * plan.M):
            raise AssertionError(f"sdc missed the corruption at {pos} "
                                 f"({launched} disentangle launches)")
        hits.append(int(loc[pos]) == j)
    counts = {k["name"]: count(k) for k in kernels}
    log(f"[library] sdc.detect / localize on [{plan.M}, {LIB_SDC_N}] card "
        f"tensors with one corrupted position each of 4 times: masks and "
        f"blame equal to the CPU's, every corruption detected, "
        f"{sum(hits)}/4 blamed on the corrupted stream, {3 * plan.M} "
        f"disentangle kernel launches per detect + localize; kernel "
        f"launches over the library path {counts} ({smi})")
    for name in LIB_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"library path")
    rec.update(sdc_blamed=sum(hits), counts=counts,
               seconds=time.perf_counter() - t_phase)
    log(f"[library] phase {rec['seconds']:.1f} s")
    return counts, rec


# ------------------------------------------------------------------ train --

def _train_configs(arch=LLAMA):
    """(model config, TrainConfig, DataConfig) of a training path: the
    entangled sync on the kernel codec, as ``examples/train_lm.py`` runs
    the reference's (with its codec flag set to the kernels); the
    families of phase 4b cut to TRAIN_FAMILIES' depths."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = model_config(arch)
    if arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_FAMILIES[arch])
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


def _n_params(cfg) -> int:
    """The model's parameter count, from shapes alone (fake tensors: no
    memory is taken)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.api import get_model

    with FakeTensorMode():
        params = get_model(cfg).init(torch.Generator(), cfg, TRAIN["seq"],
                                     device="cpu")
        return sum(t.numel() for t in _leaves(params))


def _depth(cfg, arch) -> str:
    from repro_torch.configs import get_config

    full = get_config(arch).n_layers
    return (f"{cfg.n_layers} of {full} layers" if cfg.n_layers != full
            else f"{cfg.n_layers} layers")


def phase_train(dev, kernels, path_kernels, arch=LLAMA, tag="train",
                ckpt=True):
    """``train_loop`` on ``arch`` at published widths: TRAIN["steps"] steps
    with block 1 of the entangled sync fail-stopped at
    TRAIN["fail_step"], then (with ``ckpt``) the loop's final blocking
    checkpoint into a temporary directory (deleted afterwards). Every
    kernel's count is set to 0 just before and read just after; each of
    ``path_kernels`` must have launched, and the losses must be finite.
    Returns (state, counts, summary)."""
    import numpy as np
    import torch

    from repro_torch.train.trainer import LoopConfig, train_loop

    cfg, tcfg, dcfg = _train_configs(arch)
    n_params = _n_params(cfg)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_") if ckpt else None
    need = 3 * 4 * n_params if ckpt else 0  # float32 params, both moments
    free = shutil.disk_usage(ckpt_dir).free if ckpt else 0
    where = (f"checkpoint {need / 1e9:.2f} GB into {ckpt_dir} "
             f"({free / 1e9:.1f} GB free)" if ckpt else "no checkpoint")
    log(f"[{tag}] {arch} published widths, {_depth(cfg, arch)} "
        f"({cfg.family}), d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.4f} G params; batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']}; grad_sync entangle (M={tcfg.ft_M}), codec "
        f"{tcfg.grad_codec}; fail-stop of block 1 at step "
        f"{TRAIN['fail_step']}; {where}")
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
        files = (list(pathlib.Path(ckpt_dir).rglob("*.npy")) if ckpt
                 else [])
        ckpt_bytes = sum(f.stat().st_size for f in files)
    finally:
        if ckpt:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {n: c / TRAIN["steps"] for n, c in counts.items()}
    on_disk = (f"; checkpoint {len(files)} leaves, {ckpt_bytes / 1e9:.3f} "
               f"GB on disk (deleted)" if ckpt else "")
    log(f"[{tag}] {arch} train_loop: {TRAIN['steps']} steps"
        f"{' + final checkpoint' if ckpt else ''} in {secs:.1f} s; losses "
        f"{[float(x) for x in losses]}; kernel launches {counts} "
        f"({per_step} per step); max_memory_allocated {peak / 2**30:.2f} "
        f"GiB{on_disk}")
    if len(losses) != TRAIN["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"training losses bad: {losses}")
    if ckpt_bytes < need:
        raise AssertionError(f"the checkpoint holds {ckpt_bytes} bytes, "
                             f"less than the state's {need}")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"training path of {arch}")
    return state, counts, dict(loop_s=secs, losses=[float(x) for x in losses],
                               n_params=n_params, layers=cfg.n_layers,
                               peak_gib=peak / 2**30,
                               launches_per_step=per_step)


def _updates_equal(state, grads_a, grads_b, cfg, tcfg) -> int:
    """The number of leaves on which the AdamW updates of ``state`` by two
    gradient trees differ. The update is elementwise, its learning rate
    and bias corrections from the step alone (as in ``apply_grads``), so
    it runs on slices of at most UPDATE_SLICE elements of a leaf at a
    time: two updated states never coexist on the card."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    lr_cfg = adamw.effective_lr_config(tcfg.adamw, cfg.d_model)
    opt, bad = state["opt"], 0
    with torch.no_grad():
        for p, m, v, ga, gb in zip(leaves(state["params"]), leaves(opt["m"]),
                                   leaves(opt["v"]), leaves(grads_a),
                                   leaves(grads_b)):
            flat = [t.reshape(-1) for t in (p, m, v, ga, gb)]
            differ = False
            for i in range(0, flat[0].numel(), UPDATE_SLICE):
                p_, m_, v_, ga_, gb_ = (t[i:i + UPDATE_SLICE] for t in flat)
                one = [adamw.update({"x": g}, {"m": {"x": m_}, "v": {"x": v_}},
                                    {"x": p_}, state["step"], lr_cfg)
                       for g in (ga_, gb_)]
                differ |= any(not torch.equal(a, b) for a, b in
                              zip(leaves(one[0]), leaves(one[1])))
                del one
            bad += differ
    return bad


def train_rollforward(dev, state, arch=LLAMA, tag="train"):
    """EXACT ROLL-FORWARD (train): ONE backward at published widths (two
    backwards need not agree bit for bit: the embedding's backward
    accumulates with atomics), its gradients synced healthy and with each
    block failed; every synced leaf must be bit-identical, the kernel codec
    must equal the plain codec, and the AdamW update from the healthy and
    the block-1-failed sync must give the same state."""
    import dataclasses as dc

    import torch

    from repro_torch.train.train_step import loss_and_grads, sync_grads
    from repro_torch.tree import leaves

    cfg, tcfg, dcfg = _train_configs(arch)
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
    bad = _updates_equal(state, healthy, failed1, cfg, tcfg)
    del healthy, failed1
    free_cuda()
    if bad:
        raise AssertionError(f"updated state differs on {bad} leaves")
    what = "train" if arch == LLAMA else f"train-{cfg.family}"
    log(f"[{tag}] {arch} recovery summary: one backward (loss "
        f"{loss.item():.4f}), {n} gradient leaves synced healthy and with "
        f"failed_block 0, 1, 2, 3 on the kernel codec: every synced leaf "
        f"bit-identical, kernel codec == plain codec, AdamW update from "
        f"block 1 failed == healthy (EXACT ROLL-FORWARD ({what}))")


def train_remat_checks(dev, params, smi, arch=LLAMA, tag="train"):
    """Remat and the streamed CE on the card, at the training shape
    (TRAIN's batch x seq), as tests/test_torch_loss.py holds them on the
    CPU: ``loss_and_grads`` with ``remat='full'`` and ``'dots'`` must give
    the plain step's loss and every gradient bit for bit; with
    ``loss_impl='streamed'`` the step's loss and gradients must lie within
    the reference's streamed-vs-naive bounds (NAIVE_LOSS_TOL,
    NAIVE_GRAD_TOL). Those absolute bounds do not separate a wrong
    backward at this shape, so the step is also split at the logits: the
    streamed CE's gradient w.r.t. the full-width logits must lie within
    CE_GRAD_TOL of the naive CE's and its non-target entries within
    CE_NONTARGET_RTOL of them elementwise (the loss within CE_LOSS_TOL),
    and each step's gradients must equal, bit for bit, the model's
    backward of its own CE's gradient w.r.t. the logits. A planted fault,
    the CE with its softmax term doubled (the naive CE plus the mean
    logsumexp), must break CE_NONTARGET_RTOL in the same run. The
    normwise per-leaf difference of the streamed and the faulty step from
    the plain one is printed beside them: float32 rounding of the logits'
    gradient alone moves it (checked on the CPU), so it bounds nothing.
    Prints each setting's step ms (host clock around a synchronized
    forward + backward, mean of TIMED_STEPS after one warm-up) and its
    ``max_memory_allocated`` above what was allocated before it, with the
    card's name and power limit. Returns the record."""
    import dataclasses as dc

    import torch

    from repro_torch.models import get_model, lm_loss
    from repro_torch.models.loss import streamed_lm_ce
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves, unflatten

    cfg, _, dcfg = _train_configs(arch)
    batch = _batch(dcfg, 0, dev)
    settings = {"plain": cfg, "remat=full": dc.replace(cfg, remat="full"),
                "remat=dots": dc.replace(cfg, remat="dots"),
                "loss_impl=streamed": dc.replace(cfg, loss_impl="streamed")}
    rec, steps = {}, {}
    for name, c in settings.items():
        times = []
        for i in range(1 + REMAT_CHECK["timed_steps"]):
            grads = None  # the previous step's, before the next backward
            free_cuda()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(c, params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated(dev) - before
        base = steps.get("plain")
        if base is None:
            bad, what = [], "reference step"
        elif name.startswith("remat"):
            bad = [i for i, (a, b) in enumerate(zip(leaves(grads),
                                                    leaves(base[1])))
                   if not torch.equal(a, b)]
            if not torch.equal(loss, base[0]):
                bad.append("loss")
            what = "loss and every gradient bit-identical to the plain step"
        else:
            gerr = max(float((a - b).abs().max()) for a, b in
                       zip(leaves(grads), leaves(base[1])))
            lerr = abs(loss.item() - base[0].item())
            bad = ([] if lerr < NAIVE_LOSS_TOL and gerr <= NAIVE_GRAD_TOL
                   else ["step"])
            what = (f"step loss within {lerr:.3g} (bound {NAIVE_LOSS_TOL}), "
                    f"gradients within {gerr:.3g} (bound {NAIVE_GRAD_TOL})")
        ms = 1e3 * sum(times[1:]) / len(times[1:])
        rec[name] = dict(step_ms=ms, peak_gib=peak / 2**30,
                         loss=loss.item(), mismatches=len(bad))
        log(f"[{tag}] {arch} {name}: forward + backward at batch "
            f"{TRAIN['batch']} x seq {TRAIN['seq']} mean {ms:.3f} ms over "
            f"{len(times) - 1} steps, max_memory_allocated +{peak / 2**30:.2f}"
            f" GiB; {what}; {len(bad)} mismatches ({smi})")
        if bad:
            raise AssertionError(f"{name} on the card differs from the plain "
                                 f"step at leaves {bad[:8]}")
        if name in ("plain", "loss_impl=streamed"):
            steps[name] = (loss, grads)
        del grads
    mask = batch.get("loss_mask", torch.ones_like(batch["tokens"]))
    m1 = mask[:, 1:].to(torch.float32)

    def fault(x):  # the naive CE with its softmax term doubled
        lse = torch.logsumexp(x[:, :-1].to(torch.float32), dim=-1)
        return (lm_loss(x, batch, cfg)
                + (lse * m1).sum() / torch.clamp(m1.sum(), min=1.0))

    # one forward kept for the model's backward of each CE's own gradient
    # w.r.t. the full-width logits
    lv = [t.detach().requires_grad_() for t in leaves(params)]
    logits = get_model(cfg).forward_train(unflatten(params, lv), batch, cfg)
    out = {}
    for name, fn in (("naive", lambda x: lm_loss(x, batch, cfg)),
                     ("streamed", lambda x: streamed_lm_ce(
                         x, batch["tokens"], mask, shift=1)),
                     ("fault", fault)):
        x = logits.detach().clone().requires_grad_()
        loss = fn(x)
        out[name] = (loss.detach(), torch.autograd.grad(loss, x)[0])
        del x
    naive = out["naive"][1]
    target = torch.zeros(naive.shape, dtype=torch.bool, device=dev)
    target[:, :-1].scatter_(-1, batch["tokens"][:, 1:, None].to(torch.int64),
                            True)

    def nontarget_rel(g):  # max |g - naive| / |naive| off the targets
        err = (g - naive).abs().masked_fill_(target, 0)
        return float((err / naive.abs().clamp_min(
            torch.finfo(torch.float32).tiny)).max())

    lerr = abs(out["naive"][0].item() - out["streamed"][0].item())
    gerr = float((naive - out["streamed"][1]).abs().max())
    nrel = nontarget_rel(out["streamed"][1])
    fault_ce = nontarget_rel(out["fault"][1])
    ntmax = float(naive.masked_fill(target, 0).abs().max())
    del naive, target
    unequal, normwise = {}, {}
    for name, key in (("naive", "plain"), ("streamed", "loss_impl=streamed"),
                      ("fault", None)):
        g = torch.autograd.grad(logits, lv, out[name][1],
                                retain_graph=name != "fault")
        if key is not None:
            unequal[name] = sum(not torch.equal(a, b) for a, b in
                                zip(g, leaves(steps[key][1])))
        if name != "naive":
            normwise[name] = _leaf_rel(g, steps["plain"][1])
        del g
    del out, logits, lv, steps
    free_cuda()
    log(f"[{tag}] {arch} streamed CE at the full-width logits "
        f"[{TRAIN['batch']}, {TRAIN['seq']}, {cfg.vocab_size}]: loss within "
        f"{lerr:.3g} of the naive CE's (CE_LOSS_TOL {CE_LOSS_TOL}), d loss / "
        f"d logits within {gerr:.3g} (CE_GRAD_TOL atol {CE_GRAD_TOL}), the "
        f"non-target entries (largest {ntmax:.3g}) within {nrel:.3g} "
        f"elementwise "
        f"relative (CE_NONTARGET_RTOL {CE_NONTARGET_RTOL}); the planted "
        f"fault (softmax term doubled) reads {fault_ce:.3g} there; the "
        f"plain and the streamed steps' gradients equal the model's backward"
        f" of their CE's d loss / d logits but at {unequal['naive']} / "
        f"{unequal['streamed']} leaves; normwise per leaf from the plain "
        f"step: streamed {normwise['streamed']:.3g}, planted fault "
        f"{normwise['fault']:.3g} ({smi})")
    if lerr >= CE_LOSS_TOL or gerr > CE_GRAD_TOL or nrel > CE_NONTARGET_RTOL:
        raise AssertionError("the streamed CE on the card is outside "
                             "CE_LOSS_TOL / CE_GRAD_TOL / CE_NONTARGET_RTOL "
                             "of the naive CE")
    if any(unequal.values()):
        raise AssertionError(f"a step's gradients are not the model's "
                             f"backward of its CE's gradient: {unequal}")
    if fault_ce <= CE_NONTARGET_RTOL:
        raise AssertionError("a CE with its softmax term doubled passes "
                             "CE_NONTARGET_RTOL at this shape")
    rec["ce_logits"] = dict(loss_err=lerr, grad_err=gerr, nontarget_rel=nrel,
                            nontarget_max=ntmax, fault_nontarget_rel=fault_ce,
                            step_normwise=normwise)
    return rec


def train_variants(dev, state, smi, arch=LLAMA, tag="train-variants"):
    """[train-variants]: the reference's training perf variants at TRAIN's
    shape from the phase's own state. bf16 AdamW moments: one train step
    with float32 moments and one with the state's moments cast to
    bfloat16 (``AdamWConfig(state_dtype='bfloat16')``), from the same
    params and batch: the losses, the largest relative difference of the
    updated params, the moments' bytes and each step's peak memory above
    the memory held before it; the bf16 moments after their step saved
    through ``CheckpointManager`` (into a temporary directory, deleted
    after) and restored, bit for bit. The bf16 norm apply
    (``norm_f32=False``): one ``forward_train`` batch against the float32
    apply, max |delta| and argmax agreement (above NORM_AGREE). Returns the
    record."""
    import dataclasses as dc

    import torch

    from repro_torch.models.api import get_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import leaves, tree_map

    t_phase = time.perf_counter()
    cfg, tcfg, dcfg = _train_configs(arch)
    batch = _batch(dcfg, TRAIN["steps"] + 1, dev)
    tcfg_b = dc.replace(tcfg, adamw=dc.replace(tcfg.adamw,
                                               state_dtype="bfloat16"))
    runs, params_after = {}, {}
    for name, tc in (("float32", tcfg), ("bfloat16", tcfg_b)):
        st = state if name == "float32" else dict(
            state, opt=tree_map(lambda t: t.to(torch.bfloat16),
                                state["opt"]))
        moment_bytes = sum(t.numel() * t.element_size()
                           for t in leaves(st["opt"]))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        new, m = make_train_step(cfg, tc)(st, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        runs[name] = dict(loss=loss, moment_gb=moment_bytes / 1e9,
                          step_s=time.perf_counter() - t0,
                          peak_over_held_gib=(torch.cuda.max_memory_allocated(
                              dev) - held) / 2**30)
        params_after[name] = new["params"]
        if name == "bfloat16":
            moments = new["opt"]
        del new, st, m
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(leaves(params_after["bfloat16"]),
                              leaves(params_after["float32"])))
    del params_after
    free_cuda()
    log(f"[{tag}] {arch} one step each from the train state: float32 "
        f"moments {runs['float32']['moment_gb']:.3f} GB, loss "
        f"{runs['float32']['loss']:.6f}, peak above held memory "
        f"{runs['float32']['peak_over_held_gib']:.2f} GiB; bfloat16 moments "
        f"{runs['bfloat16']['moment_gb']:.3f} GB, loss "
        f"{runs['bfloat16']['loss']:.6f}, peak above held memory "
        f"{runs['bfloat16']['peak_over_held_gib']:.2f} GiB; largest relative "
        f"difference of the updated params {rel:.3e} ({smi})")
    if not all(math.isfinite(r["loss"]) for r in runs.values()):
        raise AssertionError(f"train-variant losses bad: {runs}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        need = sum(t.numel() * 2 for t in leaves(moments))
        if shutil.disk_usage(ckpt_dir).free < 1.1 * need:
            raise RuntimeError(f"the disk under {ckpt_dir} cannot hold the "
                               f"{need / 1e9:.2f} GB of bf16 moments")
        mgr = CheckpointManager(ckpt_dir)
        t0 = time.perf_counter()
        mgr.save(moments, 1, blocking=True)
        save_s = time.perf_counter() - t0
        man = json.loads((pathlib.Path(ckpt_dir) / "step_00000001"
                          / "manifest.json").read_text())
        n_bf16 = sum(e["dtype"] == "bfloat16" for e in man["leaves"])
        t0 = time.perf_counter()
        back, _ = mgr.restore(moments)
        restore_s = time.perf_counter() - t0
        bad = sum(b.dtype != torch.bfloat16 or not torch.equal(a, b)
                  for a, b in zip(leaves(moments), leaves(back)))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[{tag}] {arch} bf16 moments through CheckpointManager: "
        f"{len(man['leaves'])} leaves ({n_bf16} with manifest dtype "
        f"bfloat16), {need / 1e9:.3f} GB written in {save_s:.1f} s, restored "
        f"in {restore_s:.1f} s; leaves differing {bad} (restored bit for "
        f"bit: {bad == 0})")
    if bad or n_bf16 != len(man["leaves"]):
        raise AssertionError(f"bf16 moments: {bad} leaves came back "
                             f"different, {n_bf16} bfloat16 entries")
    del moments, back
    free_cuda()
    model = get_model(cfg)
    with torch.no_grad():
        f32 = model.forward_train(state["params"], batch, cfg).float()
        b16 = model.forward_train(state["params"], batch,
                                  dc.replace(cfg, norm_f32=False)).float()
    diff = float((f32 - b16).abs().max())
    agree = float((f32.argmax(-1) == b16.argmax(-1)).float().mean())
    del f32, b16
    free_cuda()
    log(f"[{tag}] {arch} forward_train with the bf16 norm apply against "
        f"the float32 apply: max |delta| {diff:.6f}, argmax agreement "
        f"{agree:.4f} (bound > {NORM_AGREE})")
    if not agree > NORM_AGREE:
        raise AssertionError(f"bf16 norm apply: argmax agreement {agree}")
    rec = dict(steps=runs, params_rel_diff=rel, ckpt_gb=need / 1e9,
               ckpt_save_s=save_s, ckpt_restore_s=restore_s,
               norm_max_abs_diff=diff, norm_argmax_agree=agree,
               seconds=time.perf_counter() - t_phase)
    log(f"[{tag}] phase {rec['seconds']:.1f} s")
    return rec


def _dist_shapes() -> dict:
    """The [dist] phase's gradient leaves, by path: one decoder layer of
    LLAMA at its published widths (layer 0 of every stacked leaf: the
    attention and MLP weights and their norms, 60.8 M elements) and the
    final norm; shapes from fake tensors (no memory is taken)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.api import get_model
    from repro_torch.tree import leaves_with_path

    cfg = model_config(LLAMA)
    with FakeTensorMode():
        params = get_model(cfg).init(torch.Generator(), cfg, TRAIN["seq"],
                                     device="cpu")
        return {path: tuple(t.shape[1:]) if path.startswith("['stack']")
                else tuple(t.shape)
                for path, t in leaves_with_path(params)
                if path.startswith("['stack']") or "final_norm" in path}


def _dist_grads(dev, rank, shapes):
    """Rank ``rank``'s seeded gradient leaves of ``shapes``, on ``dev``;
    each rank's at another magnitude."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    return {n: torch.randn(s, generator=gen, device=dev) * 10.0 ** (rank - 2)
            for n, s in shapes.items()}


def _sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _fb(fb) -> str:
    return "none" if fb is None else str(fb)


def _dist_cmd(rank: int, d: pathlib.Path) -> list:
    """The command of one rank of the [dist] phase's gloo group."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker",
            str(rank), "--dist-dir", str(d)]


def dist_worker(rank: int, d: pathlib.Path, dev) -> int:
    """One rank of the [dist] phase's gloo group (``chip_smoke.py
    --dist-worker RANK --dist-dir D``, on ``cuda:0``): joins through the
    file store ``D/store``, syncs its seeded gradient leaves with
    ``ft_grad_sync`` across the group on the kernel codec (the kernels on
    ``dev``) for every failed block, and writes the results' SHA-256, its
    kernels' launches (every kernel's, counted from 0 just before the
    checked syncs and read just after them) and the sync's ms to
    ``D/rank<RANK>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.collectives import ft_grad_sync

    kernels = kernel_table()
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=DIST_WORLD)
    try:
        grads = _dist_grads(dev, rank, _dist_shapes())
        group = dist.group.WORLD
        out = {"hashes": {}}
        reset_counts(kernels)
        for fb in DIST_FAILED:
            got, _ = ft_grad_sync(grads, axis_name=group,
                                  n_replicas=DIST_WORLD, failed_block=fb,
                                  codec="kernel")
            out["hashes"][_fb(fb)] = {n: _sha(t) for n, t in got.items()}
        out["launches"] = {k["name"]: count(k) for k in kernels}
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            ft_grad_sync(grads, axis_name=group, n_replicas=DIST_WORLD,
                         codec="kernel")
        torch.cuda.synchronize()
        out["sync_ms"] = 1e3 * (time.perf_counter() - t0) / 3
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_dist(dev, kernels, state, smi):
    """[dist]: the cross-replica gradient sum over ``torch.distributed``.
    (1) A one-rank NCCL group on ``dev``: ``ft_grad_sync`` over it on the
    kernel codec, on one backward's full-width llama gradient leaves, must
    equal ``axis_name=None`` bit for bit, healthy and with each block
    failed, and every failed block the healthy sync (EXACT ROLL-FORWARD
    (dist)); every kernel's count set to 0 just before and read just
    after. (2) DIST_WORLD ranks spawned on the one card over gloo
    (:func:`dist_worker`): each rank's results, for every failed block,
    must be bit-identical to every other rank's and to the single-process
    oracle on the card (the ranks' entangled blocks summed mod 2^32, then
    disentangled, through the kernels); every kernel's launches in the
    ranks, summed. The sync's ms and ns per element at world size 1 (on
    llama's whole gradient, and on the ranks' leaves) and at DIST_WORLD
    (the ranks' leaves: :func:`_dist_shapes`). Returns (counts by path,
    record)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.fixed_point import pow2_scale
    from repro_torch.core.plan import make_plan
    from repro_torch.dist.collectives import _to_blocks, ft_grad_sync
    from repro_torch.kernels import ops as kops
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg, tcfg, dcfg = _train_configs(LLAMA)
    _, grads = loss_and_grads(cfg, state["params"],
                              _batch(dcfg, TRAIN["steps"], dev))
    kw = dict(n_replicas=1, M=tcfg.ft_M, codec="kernel")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        group = dist.group.WORLD
        reset_counts(kernels)
        bad_none, bad_fb = 0, 0
        with torch.no_grad():
            healthy, _ = ft_grad_sync(grads, axis_name=group, **kw)
            for fb in DIST_FAILED:
                want, _ = ft_grad_sync(grads, axis_name=None,
                                       failed_block=fb, **kw)
                got, _ = ft_grad_sync(grads, axis_name=group,
                                      failed_block=fb, **kw)
                bad_none += sum(not torch.equal(a, b)
                                for a, b in zip(leaves(got), leaves(want)))
                bad_fb += sum(not torch.equal(a, b)
                              for a, b in zip(leaves(got), leaves(healthy)))
                del want, got
            counts = {k["name"]: count(k) for k in kernels}
            shapes = _dist_shapes()
            layer = _dist_grads(dev, 0, shapes)
            ms = {"axis_name None, whole gradient": _event_ms(
                lambda: ft_grad_sync(grads, axis_name=None, **kw), 3),
                "nccl world 1, whole gradient": _event_ms(
                lambda: ft_grad_sync(grads, axis_name=group, **kw), 3),
                "nccl world 1, one layer": _event_ms(
                lambda: ft_grad_sync(layer, axis_name=group, **kw), 3)}
    finally:
        dist.destroy_process_group()
    n = len(leaves(healthy))
    n_whole = sum(t.numel() for t in leaves(grads))
    n_layer = sum(math.prod(s) for s in shapes.values())
    del healthy, grads, layer
    free_cuda()
    verdict = ("EXACT ROLL-FORWARD" if bad_fb == 0 and bad_none == 0
               else "RECOVERY FAILED")
    log(f"[dist] {LLAMA} one backward's {n} gradient leaves synced over a "
        f"one-rank NCCL group on the kernel codec, failed_block "
        f"{list(DIST_FAILED)}: leaves differing from axis_name=None "
        f"{bad_none}, from the healthy sync {bad_fb} ({verdict} (dist)); "
        f"kernel launches {counts}; sync ms {ms} ({smi})")
    if bad_none or bad_fb:
        raise AssertionError(f"one-rank NCCL sync: {verdict}")
    for name in ("entangle", "disentangle"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"one-rank NCCL sync")

    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(_dist_cmd(r, d), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(DIST_WORLD)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        spawn_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode:
                raise AssertionError(f"dist rank {r} exited {p.returncode}:"
                                     f"\n{logs[r][-4000:]}")
        outs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(DIST_WORLD)]
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(d, ignore_errors=True)
    plan = make_plan(tcfg.ft_M, 32)
    ranks = [_dist_grads(dev, r, shapes) for r in range(DIST_WORLD)]
    want = {}
    with torch.no_grad():
        for name, shape in shapes.items():
            blocks = [_to_blocks(g[name].reshape(-1), plan.M)[0]
                      for g in ranks]
            amax = torch.stack([b.abs().amax() for b in blocks]).amax()
            scale = pow2_scale(amax, plan.max_output_magnitude, DIST_WORLD)
            total = sum(kops.entangle(torch.round(b * scale).to(torch.int32),
                                      plan).to(torch.int64) for b in blocks)
            eps = ((total + 2**31) % 2**32 - 2**31).to(torch.int32)
            rec = kops.disentangle(eps, plan).to(torch.float32) / (
                scale * DIST_WORLD)
            want[name] = _sha(rec.reshape(-1)[:math.prod(shape)])
    del ranks
    free_cuda()
    bad = sum(o["hashes"][_fb(fb)][name] != want[name]
              for o in outs for fb in DIST_FAILED for name in shapes)
    launches = {k["name"]: sum(o["launches"][k["name"]] for o in outs)
                for k in kernels}
    ms[f"gloo world {DIST_WORLD}, one layer"] = max(o["sync_ms"]
                                                    for o in outs)
    verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
    log(f"[dist] {DIST_WORLD} ranks spawned on {torch.cuda.get_device_name(0)}"
        f" over gloo (CUDA tensors reduced by gloo itself), {len(shapes)} "
        f"leaves of one {LLAMA} layer ({n_layer} elements a rank), "
        f"failed_block {list(DIST_FAILED)}: results differing "
        f"from the single-process oracle on the card (sum mod 2^32 of the "
        f"ranks' entangled blocks, then disentangled) {bad} of "
        f"{DIST_WORLD * len(DIST_FAILED) * len(shapes)}, so bit-identical"
        f" on every rank and failed block: {bad == 0} ({verdict} (dist)); "
        f"kernel launches in the ranks {launches}; {spawn_s:.1f} s for the "
        f"ranks")
    if bad:
        raise AssertionError(f"{DIST_WORLD}-rank gloo sync: {verdict}")
    for name in ("entangle", "disentangle"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"{DIST_WORLD}-rank sync")
    elements = {k: n_layer if k.endswith("one layer") else n_whole
                for k in ms}
    ns = {k: 1e6 * t / elements[k] for k, t in ms.items()}
    rec = dict(one_rank_leaves=n, sync_ms=ms, sync_elements=elements,
               sync_ns_per_element=ns, spawn_s=spawn_s,
               launches={"nccl world 1": counts,
                         f"gloo world {DIST_WORLD}": launches},
               seconds=time.perf_counter() - t_phase)
    log(f"[dist] sync ms {ms}; elements {elements}; ns per element {ns}; "
        f"phase {rec['seconds']:.1f} s ({smi})")
    return {"dist nccl world 1": counts,
            f"dist gloo world {DIST_WORLD}": launches}, rec


def _mesh_cmd(rank: int, d: pathlib.Path) -> list:
    """The command of one rank of the [serve-mesh] phase's gloo group."""
    return _dist_cmd(rank, d) + ["--dist-phase", "serve-mesh"]


def _mesh_scfg(scope):
    from repro_torch.serve.engine import ServeConfig

    return ServeConfig(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                       ft_mode="entangle", ft_M=SERVE["ft_M"],
                       ft_scope=scope)


def _mesh_waves(dev, arch, scopes, kernels, rank_shapes=None):
    """Serve the 8-request wave with ``arch`` per scope, healthy and with
    ``failed_group=1``; returns ({f"{scope}/{fg}": tokens lists}, step
    ms by wave, plan misses, the engine's slots). With ``rank_shapes``
    (a rank), the GEMMs are first held against their plain versions at the
    rank's census shapes (``rank_shapes(cfg, eng)`` gives them), and every
    kernel's count is set to 0 just before the waves."""
    from repro_torch.serve.engine import ServeEngine

    cfg, _, params = init_model(dev, arch)
    if rank_shapes is not None:  # the census of the wave's one bucket
        eng = ServeEngine(cfg, dataclasses.replace(
            _mesh_scfg(scopes[-1]), prefill_buckets=(SERVE["prompt_len"],)),
            params, device=dev)
        rank_shapes(cfg, eng)
        del eng
        free_cuda()
        reset_counts(kernels)
    toks, ms, misses = {}, {}, 0
    for scope in scopes:
        for fg in (None, 1):
            eng = ServeEngine(cfg, _mesh_scfg(scope), params, device=dev)
            outs, steps, _ = _wave(eng, cfg, fg, kernels)
            key = f"{scope}/{_fb(fg)}"
            toks[key] = {str(r): o.tolist() for r, o in outs.items()}
            ms[key] = 1e3 * sum(steps[1:]) / max(len(steps) - 1, 1)
            misses += eng.plans.misses if eng.plans is not None else 0
            slots = [eng.slot_lo, eng.slot_hi]
            del eng
            free_cuda()
    del params
    free_cuda()
    return toks, ms, misses, slots


def mesh_worker(rank: int, d: pathlib.Path, dev) -> int:
    """One rank of the [serve-mesh] phase's gloo group (``chip_smoke.py
    --dist-worker RANK --dist-dir D --dist-phase serve-mesh``, on
    ``cuda:0``): per path of MESH_PATHS, holds both GEMMs against their
    plain versions at the shapes its own engine sends them (its census at
    scope all and the head at its rows), sets every count to 0, serves the
    waves through one engine split across the ranks, and reads every
    count; writes tokens, launches by route, step ms and the checks to
    ``D/rank<RANK>.json``."""
    import torch
    import torch.distributed as dist

    kernels = kernel_table()
    by_name = {k["name"]: k for k in kernels}
    chk = {n: by_name[n]["checker"].spawn()
           for n in ("entangled_matmul", "entangled_matmul_grouped")}
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=MESH_WORLD)

    def rank_shapes(cfg, eng):
        # this rank's head rows (its slots, padded to M) and its census
        dense, grouped = census_shapes(cfg, eng.protected_census)
        M = SERVE["ft_M"]
        head = (-(-(eng.slot_hi - eng.slot_lo) // M), cfg.d_model,
                cfg.vocab_size, "head")
        dense = [head] + [s for s in dense if s[-1] != "head"]
        check_dense(dev, chk["entangled_matmul"], dense, ragged=False)
        if grouped:
            check_grouped(dev, chk["entangled_matmul_grouped"], grouped,
                          ragged=False, full_range=False)
        out.setdefault("shapes", {})[cfg.name] = dict(
            dense=[list(s[:3]) for s in dense],
            grouped=[list(s[:4]) for s in grouped])

    out = {"paths": {}}
    try:
        for arch, scopes in MESH_PATHS:
            t0 = time.perf_counter()
            toks, ms, misses, slots = _mesh_waves(dev, arch, scopes, kernels,
                                                  rank_shapes)
            out["paths"][arch] = dict(
                tokens=toks, step_ms=ms, misses=misses, slots=slots,
                launches={k["name"]: count(k) for k in kernels},
                core={k["name"]: count(k, 1) for k in kernels
                      if len(k["counters"]) > 1},
                seconds=time.perf_counter() - t0)
        out["max_abs_err"] = {n: c.worst for n, c in chk.items()}
        out["comparisons"] = {n: c.n for n, c in chk.items()}
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_serve_mesh(dev, kernels, smi):
    """[serve-mesh]: the engine's ``serve_mesh`` path. MESH_WORLD ranks are
    spawned on the one card over gloo (:func:`mesh_worker`); each holds
    SERVE["max_batch"] / MESH_WORLD slots of one engine and serves the
    8-request wave per scope of MESH_PATHS, healthy and with
    ``failed_group=1``, after holding both GEMMs against their plain
    versions at its own shapes. Meanwhile this process serves the same
    waves as oracles: llama through a one-rank engine, deepseek through
    one process of MESH_WORLD dispatch groups (a stand-in mesh). Every
    rank's tokens must equal the oracle's bit for bit, every injected
    wave its healthy wave's (EXACT ROLL-FORWARD (serve-mesh)), no plan
    may miss, and each rank must have launched the s8 GEMM (and, for
    deepseek, the grouped one) and never the CUDA-core route. Returns
    (counts by path, record)."""
    import contextlib

    from repro_torch.dist.sharding import StandInMesh, axis_rules

    t_phase = time.perf_counter()
    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    procs = []
    try:
        procs = [subprocess.Popen(_mesh_cmd(r, d), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(MESH_WORLD)]
        oracle, oracle_ms = {}, {}
        for arch, scopes in MESH_PATHS:
            ctx = (axis_rules(StandInMesh({"data": MESH_WORLD}))
                   if arch == DEEPSEEK else contextlib.nullcontext())
            with ctx:
                oracle[arch], oracle_ms[arch], misses, _ = _mesh_waves(
                    dev, arch, scopes, kernels)
            if misses:
                raise AssertionError(f"{arch} oracle: plan misses {misses}")
        logs = [p.communicate(timeout=900)[0] for p in procs]
        for r, p in enumerate(procs):
            if p.returncode:
                raise AssertionError(f"serve-mesh rank {r} exited "
                                     f"{p.returncode}:\n{logs[r][-4000:]}")
        outs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(MESH_WORLD)]
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(d, ignore_errors=True)
    counts, rec = {}, dict(paths={}, oracle_step_ms=oracle_ms)
    for arch, scopes in MESH_PATHS:
        what = ("a one-rank engine in this process" if arch == LLAMA else
                f"one process of {MESH_WORLD} dispatch groups")
        for r, o in enumerate(outs):
            got = o["paths"][arch]
            bad_oracle = sum(got["tokens"][w] != oracle[arch][w]
                             for w in oracle[arch])
            bad_fg = sum(got["tokens"][f"{s}/1"] != got["tokens"][f"{s}/none"]
                         for s in scopes)
            verdict = ("EXACT ROLL-FORWARD" if bad_fg == 0 and bad_oracle == 0
                       else "RECOVERY FAILED")
            log(f"[serve-mesh] {arch} rank {r} of {MESH_WORLD} (slots "
                f"{got['slots']}, gloo on {smi.split(',')[0]}): scopes "
                f"{list(scopes)} healthy and failed_group=1; waves differing "
                f"from {what} {bad_oracle} of {len(oracle[arch])}, injected "
                f"from healthy {bad_fg} ({verdict} (serve-mesh)); plan misses "
                f"{got['misses']}; s8 GEMM launches {got['launches']}; "
                f"CUDA-core route {got['core']}; decode-step ms "
                f"{got['step_ms']} ({smi})")
            if bad_oracle or bad_fg or got["misses"]:
                raise AssertionError(f"serve-mesh {arch} rank {r}: {verdict}"
                                     f", plan misses {got['misses']}")
            need = ["entangled_matmul"] + (["entangled_matmul_grouped"]
                                           if arch == DEEPSEEK else [])
            for name in need:
                if got["launches"][name] <= 0:
                    raise AssertionError(f"kernel {name} was never launched "
                                         f"by rank {r}'s {arch} path")
            if any(got["core"].values()):
                raise AssertionError(f"rank {r}'s {arch} path reached the "
                                     f"CUDA-core GEMM: {got['core']}")
            counts[f"serve-mesh {arch} rank {r}"] = got["launches"]
        rec["paths"][arch] = dict(
            ranks=[o["paths"][arch] for o in outs],
            oracle=what)
    rec["max_abs_err"] = {n: max(o["max_abs_err"][n] for o in outs)
                          for n in outs[0]["max_abs_err"]}
    rec["comparisons"] = {n: sum(o["comparisons"][n] for o in outs)
                          for n in outs[0]["comparisons"]}
    rec["shapes"] = outs[0]["shapes"]
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[serve-mesh] each rank's GEMMs held against their plain versions "
        f"at its own shapes {rec['shapes']}: max |kernel - plain| "
        f"{rec['max_abs_err']} over {rec['comparisons']} comparisons; "
        f"phase {rec['seconds']:.1f} s ({smi})")
    if any(rec["max_abs_err"].values()):
        raise AssertionError("serve-mesh: a GEMM differs from its plain "
                             "version")
    return counts, rec


# ------------------------------------------------------------- train-mesh --

def _train_mesh_cmd(rank: int, d: pathlib.Path) -> list:
    """The command of one rank of the [train-mesh] phase's gloo group."""
    return _dist_cmd(rank, d) + ["--dist-phase", "train-mesh"]


def _train_mesh_configs(ckpt_dir):
    """(model config, TrainConfig, DataConfig, LoopConfig) of the
    train-mesh path: llama3.2-1b at TRAIN_MESH's depth, batch and steps,
    the entangled sync on the kernel codec, and an LR schedule over
    exactly the loop's steps (``train_loop`` keeps it as it is); the final
    checkpoint alone, into ``ckpt_dir``."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import LoopConfig

    tm = TRAIN_MESH
    cfg = dataclasses.replace(model_config(LLAMA), n_layers=tm["layers"])
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=tm["steps"]),
        grad_sync="entangle", grad_codec="kernel", ft_M=TRAIN["ft_M"],
        max_seq=tm["seq"])
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=tm["seq"],
                      batch_size=tm["batch"])
    loop = LoopConfig(total_steps=tm["steps"], ckpt_every=tm["steps"] + 1,
                      ckpt_dir=str(ckpt_dir), log_every=1,
                      fail_block_at_step=tm["fail_step"])
    return cfg, tcfg, dcfg, loop


def _grad_shapes(cfg) -> dict:
    """{numel: leaf names} of every gradient leaf of ``cfg``'s params, from
    fake tensors (no memory is taken)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.api import get_model
    from repro_torch.tree import leaves_with_path

    out = {}
    with FakeTensorMode():
        params = get_model(cfg).init(torch.Generator(), cfg, TRAIN["seq"],
                                     device="cpu")
        for path, t in leaves_with_path(params):
            out.setdefault(t.numel(), []).append(
                f"{path}{list(t.shape)}".replace("'", ""))
    return out


def _digest(tree) -> str:
    """A fingerprint of every bit of a tree's float32 tensors, computed on
    their device a slice at a time: per leaf the sum of its 32-bit words
    and their sum weighted by position (mod 65521, plus 1)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in _leaves(tree):
        words = t.detach().reshape(-1).view(torch.int32)
        plain = weighted = 0
        for i in range(0, words.numel(), UPDATE_SLICE):
            w = words[i:i + UPDATE_SLICE].to(torch.int64)
            pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
            plain += int(w.sum())
            weighted += int((w * pos).sum())
        h.update(f"{plain},{weighted};".encode())
    return h.hexdigest()


def _grad_rel(grads, one_grads) -> float:
    """The largest normwise difference ``|g - g1| / |g1|`` of a leaf
    between two gradient trees."""
    import torch

    with torch.no_grad():
        return max((torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b)).item()
                   for a, b in zip(_leaves(grads), _leaves(one_grads)))


def _step_diff(new, metrics, one, one_metrics, grad_rel, lr) -> dict:
    """How far a step's result is from the one-process step's from the
    same state: loss and grad-norm differences, the gradients' largest
    normwise difference a leaf (``grad_rel``), the params' largest
    difference over lr, and how many params lie past lr ·
    TRAIN_MESH["near_rel"] and past 1e-6."""
    import torch

    thr = lr * TRAIN_MESH["near_rel"]
    worst = off = off_abs = n = 0
    with torch.no_grad():
        for a, b in zip(_leaves(new["params"]), _leaves(one["params"])):
            dd = (a - b).abs()
            worst = max(worst, dd.max().item())
            off += int((dd > thr).sum())
            off_abs += int((dd > 1e-6).sum())
            n += dd.numel()
    return dict(loss=abs(float(metrics["loss"]) - float(one_metrics["loss"])),
                grad_norm_rel=abs(float(metrics["grad_norm"])
                                  / float(one_metrics["grad_norm"]) - 1),
                grad_rel=grad_rel, max_over_lr=worst / lr, threshold=thr,
                off=off, off_1e6=off_abs, n=n)


def train_mesh_worker(rank: int, d: pathlib.Path, dev) -> int:
    """One rank of the [train-mesh] phase's gloo group (``chip_smoke.py
    --dist-worker RANK --dist-dir D --dist-phase train-mesh``, on
    ``cuda:0``): joins through the file store ``D/store``, waits for
    ``D/go`` (the one-process loop has freed the card), and runs
    ``train_loop`` under ``axis_rules(make_local_mesh())``, every kernel's
    count set to 0 just before and read just after; then restores the
    final checkpoint. Writes ``D/rank<RANK>.json``. Wrappers record, per
    step, its ms, loss, grad norm, params' fingerprint and launches; on
    rank 0, the one-process step from the same state (under a stand-in
    mesh: no split, no sum) and how far the step lies from it; the gloo
    sum's and the initial broadcast's ms; at the fail step, the summed
    gradient synced healthy and with each block failed; the checkpoint
    writes. The launches of those comparisons are taken out of the
    counts."""
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import (StandInMesh, axis_rules,
                                           current_mesh, mesh_shape)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.train import trainer as TR
    from repro_torch.train.checkpoint import CheckpointManager

    tm = TRAIN_MESH
    kernels = kernel_table()
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}",
                            rank=rank, world_size=tm["world"])
    cfg, tcfg, dcfg, loop = _train_mesh_configs(d / "ckpt")
    lr_cfg = adamw.effective_lr_config(tcfg.adamw, cfg.d_model)
    out = dict(steps=[], sum_ms=[], writes=[], log=[])
    excluded = {k["name"]: 0 for k in kernels}
    # the data-parallel step's summed gradient, until rank 0's one-process
    # step's sync holds it against its own (and drops it before that
    # step's AdamW update: the card holds two ranks' training states)
    held = dict(summed=None, grad_rel=None)

    def counts():
        return {k["name"]: count(k) for k in kernels}

    @contextlib.contextmanager
    def not_counted():
        before = counts()
        yield
        for n, c in counts().items():
            excluded[n] += c - before[n]

    make, sync, sum_over = TR.make_train_step, TS.sync_grads, TS._sum_over
    bcast, write = TR.broadcast_state, CheckpointManager._write

    def sync_checked(grads, tcfg_, failed_block=None):
        if TS.data_shard()[0] is not None:
            held["summed"] = grads
        elif held["summed"] is not None:
            held["grad_rel"] = _grad_rel(held["summed"], grads)
            held["summed"] = None
        got = sync(grads, tcfg_, failed_block)
        if failed_block is not None and TS.data_shard()[0] is not None:
            with not_counted(), torch.no_grad():
                healthy = list(_leaves(sync(grads, tcfg_)[0]))
                bad = {}
                for fb in range(tcfg_.ft_M):
                    other = (got[0] if fb == failed_block
                             else sync(grads, tcfg_, fb)[0])
                    bad[str(fb)] = sum(not torch.equal(a, b) for a, b in
                                       zip(healthy, _leaves(other)))
                    del other
                del healthy
            out["rollforward"] = dict(bad=bad,
                                      leaves=len(list(_leaves(grads))),
                                      step=len(out["steps"]))
        return got

    def timed_sum(group, loss, grads):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = sum_over(group, loss, grads)
        torch.cuda.synchronize(dev)
        out["sum_ms"].append(1e3 * (time.perf_counter() - t0))
        return got

    def timed_bcast(state):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = bcast(state)
        torch.cuda.synchronize(dev)
        out["broadcast_ms"] = 1e3 * (time.perf_counter() - t0)
        return got

    def counted_write(self, host_state, step):
        out["writes"].append(step)
        return write(self, host_state, step)

    def make_checked(cfg_, tcfg_, failed_block=None):
        step = make(cfg_, tcfg_, failed_block=failed_block)

        def run(state, batch):
            lr = adamw.schedule(lr_cfg, state["step"]).item()
            before, ex0 = counts(), dict(excluded)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            new, m = step(state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            entry = dict(
                ms=ms, loss=loss, grad_norm=gnorm, lr=lr,
                failed_block=failed_block, params=_digest(new["params"]),
                on_device=all(t.device == dev for t in _leaves(new)),
                launches={n: c - before[n] - (excluded[n] - ex0[n])
                          for n, c in counts().items()})
            if rank == 0:
                with not_counted(), axis_rules(StandInMesh(
                        mesh_shape(current_mesh()))):
                    one, om = make(cfg_, tcfg_, failed_block=failed_block)(
                        state, batch)
                    entry["one"] = _step_diff(new, m, one, om,
                                              held["grad_rel"], lr)
                    del one, om
            held["summed"] = None
            out["steps"].append(entry)
            return new, m

        return run

    TR.make_train_step, TS.sync_grads, TS._sum_over = (make_checked,
                                                       sync_checked,
                                                       timed_sum)
    TR.broadcast_state, CheckpointManager._write = timed_bcast, counted_write
    try:
        while not (d / "go").exists():
            time.sleep(0.1)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(kernels)
        t0 = time.perf_counter()
        with axis_rules(make_local_mesh()):
            state, losses = TR.train_loop(cfg, tcfg, dcfg, loop,
                                          log=out["log"].append, device=dev)
        torch.cuda.synchronize(dev)
        out["loop_s"] = time.perf_counter() - t0
        out["launches"] = {n: c - excluded[n] for n, c in counts().items()}
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["losses"] = [float(x) for x in losses]
        t0 = time.perf_counter()
        back, step = CheckpointManager(loop.ckpt_dir).restore(state)
        out["restored"] = dict(step=step, seconds=time.perf_counter() - t0,
                               equal=all(torch.equal(a, b) for a, b in zip(
                                   _leaves(back), _leaves(state))))
        del back, state
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        TR.make_train_step, TS.sync_grads, TS._sum_over = make, sync, sum_over
        TR.broadcast_state, CheckpointManager._write = bcast, write
        dist.destroy_process_group()
    return 0


def phase_train_mesh(dev, kernels, smi):
    """[train-mesh]: training across ranks (see the module docstring,
    phase 4m). Holds the codec kernels against their plain versions at
    this depth's gradient-leaf sizes, runs the one-process loop here (its
    losses, grad norms and step ms kept on the host, its state freed),
    then TRAIN_MESH["world"] ranks on the one card over gloo
    (:func:`train_mesh_worker`), and checks them. Returns (counts by
    path, record)."""
    import numpy as np
    import torch

    from repro_torch.train.train_step import init_state, make_train_step

    tm = TRAIN_MESH
    t_phase = time.perf_counter()
    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_mesh_"))
    procs = []
    try:
        cfg, tcfg, dcfg, loop = _train_mesh_configs(d / "ckpt")
        n_params = _n_params(cfg)
        need = 3 * 4 * n_params  # float32 params and both moments
        free = shutil.disk_usage(d).free
        log(f"[train-mesh] {LLAMA} published widths, {_depth(cfg, LLAMA)}, "
            f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
            f"{n_params / 1e9:.4f} G params; global batch {tm['batch']} x "
            f"seq {tm['seq']} over {tm['world']} ranks ("
            f"{tm['batch'] // tm['world']} rows a rank) sharing the card "
            f"over gloo; grad_sync entangle (M={tcfg.ft_M}), codec "
            f"{tcfg.grad_codec}; {tm['steps']} steps, block 1 fail-stopped "
            f"at step {tm['fail_step']}; final checkpoint "
            f"{need / 1e9:.2f} GB into {d} ({free / 1e9:.1f} GB free); "
            f"this process holds {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
            f" GiB of the card ({torch.cuda.memory_reserved(dev) / 2**30:.2f}"
            f" reserved)")
        if free < 1.1 * need:
            raise RuntimeError(f"the disk under {d} cannot hold the "
                               f"{need / 1e9:.2f} GB checkpoint")
        # expandable segments: two ranks' states and rank 0's one-process
        # step share the card, so the ranks must not strand free memory
        env = dict(os.environ,
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        procs = [subprocess.Popen(_train_mesh_cmd(r, d), env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(tm["world"])]
        shapes = _grad_shapes(cfg)
        n_leaves = sum(map(len, shapes.values()))
        by_name = {k["name"]: k for k in kernels}
        check_codec(dev, {n: by_name[n]["checker"]
                          for n in ("entangle", "disentangle")}, shapes,
                    ragged=False, what=f"{LLAMA} at {cfg.n_layers} layers")
        # the one-process loop: train_loop's steps, without its checkpoint
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_state(torch.Generator(device=dev).manual_seed(loop.seed),
                           cfg, tcfg, dev)
        steps = {None: make_train_step(cfg, tcfg),
                 1: make_train_step(cfg, tcfg, failed_block=1)}
        oracle = []
        for i in range(tm["steps"]):
            batch = _batch(dcfg, i, dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = steps[1 if i == tm["fail_step"] else None](state,
                                                                  batch)
            loss = float(m["loss"])
            torch.cuda.synchronize(dev)
            oracle.append(dict(ms=1e3 * (time.perf_counter() - t0),
                               loss=loss, grad_norm=float(m["grad_norm"])))
        one_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del state, steps, m, batch
        free_cuda()
        (d / "go").touch()
        logs = [p.communicate(timeout=900)[0] for p in procs]
        for r, p in enumerate(procs):
            if p.returncode:
                raise AssertionError(f"train-mesh rank {r} exited "
                                     f"{p.returncode}:\n{logs[r][-4000:]}")
        outs = [json.loads((d / f"rank{r}.json").read_text())
                for r in range(tm["world"])]
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(d, ignore_errors=True)
    r0 = outs[0]
    fails = []
    # the ranks against each other, bit for bit
    for r, o in enumerate(outs[1:], 1):
        for i, (a, b) in enumerate(zip(r0["steps"], o["steps"])):
            for key in ("loss", "grad_norm", "params", "launches"):
                if a[key] != b[key]:
                    fails.append(f"step {i}: rank {r}'s {key} differs from "
                                 f"rank 0's")
    lines = []
    for i, (st, orc) in enumerate(zip(r0["steps"], oracle)):
        one, first = st["one"], i == 0
        loop_tol = tm["loss_atol"] if first else tm["loop_loss_atol"]
        d_loop = abs(st["loss"] - orc["loss"])
        gn_loop = abs(st["grad_norm"] / orc["grad_norm"] - 1)
        share_ok = first or one["off"] <= tm["off_share"] * one["n"]
        held = ("printed, not held at the first step" if first
                else f"<= {tm['off_share']:.0%}")
        ok = (one["loss"] < tm["loss_atol"]
              and one["grad_norm_rel"] < tm["gnorm_rel"]
              and one["grad_rel"] <= tm["grad_rel"]
              and one["max_over_lr"] * st["lr"] <= 2 * st["lr"] + 1e-6
              and share_ok and d_loop < loop_tol
              and (not first or gn_loop < tm["gnorm_rel"]))
        lines.append(
            f"step {i} (lr {st['lr']:.3e}{', block 1 failed' if st['failed_block'] is not None else ''}): "
            f"loss {st['loss']:.6f}, against the one-process step from the "
            f"same state |dloss| {one['loss']:.2e} (< {tm['loss_atol']}), "
            f"grad norm rel {one['grad_norm_rel']:.2e} (< "
            f"{tm['gnorm_rel']}), summed gradient rel {one['grad_rel']:.2e} "
            f"a leaf at most (<= {tm['grad_rel']:.2e}), params max |d| "
            f"{one['max_over_lr']:.3f} lr (<= 2 lr + 1e-6), past "
            f"lr/{1 / tm['near_rel']:.0f} = {one['threshold']:.2e}: "
            f"{one['off']} of {one['n']} ({held}; past 1e-6: "
            f"{one['off_1e6']}); "
            f"against the one-process loop |dloss| {d_loop:.2e} (< "
            f"{loop_tol}){f', grad norm rel {gn_loop:.2e}' if first else ''}"
            f" -> {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fails.append(f"step {i} out of tolerance")
    for line in lines:
        log(f"[train-mesh] {line}")
    counts = {}
    for r, o in enumerate(outs):
        rf = o.get("rollforward")
        exact = rf is not None and not any(rf["bad"].values())
        per_step = [(s["launches"]["entangle"], s["launches"]["disentangle"])
                    for s in o["steps"]]
        log(f"[train-mesh] rank {r} of {tm['world']}: the summed gradient of "
            f"step {rf and rf['step']} ({rf and rf['leaves']} leaves) synced "
            f"healthy and with failed_block 0, 1, 2, 3 on the kernel codec: "
            f"leaves differing from healthy {rf and rf['bad']} ("
            f"{'EXACT ROLL-FORWARD' if exact else 'RECOVERY FAILED'} "
            f"(train-mesh)); entangle / disentangle launches per step "
            f"{per_step} (gradient leaves {n_leaves}); losses {o['losses']};"
            f" checkpoint writes {o['writes']}, restored step "
            f"{o['restored']['step']} equal to the final state: "
            f"{o['restored']['equal']} ({o['restored']['seconds']:.1f} s)")
        if not exact:
            fails.append(f"rank {r}: RECOVERY FAILED {rf}")
        if any(p != (n_leaves, n_leaves) for p in per_step):
            fails.append(f"rank {r}: codec launches per step {per_step}, "
                         f"not {n_leaves} each")
        other = {n: c for n, c in o["launches"].items()
                 if n not in ("entangle", "disentangle") and c}
        if other or not all(s["on_device"] for s in o["steps"]):
            fails.append(f"rank {r}: launches {other} or state off the card")
        if o["writes"] != ([tm["steps"]] if r == 0 else []):
            fails.append(f"rank {r} wrote checkpoints {o['writes']}")
        if not (o["restored"]["equal"]
                and o["restored"]["step"] == tm["steps"]):
            fails.append(f"rank {r}: restored {o['restored']}")
        if not np.isfinite(o["losses"]).all():
            fails.append(f"rank {r}: losses {o['losses']}")
        counts[f"train-mesh rank {r}"] = o["launches"]
    rank_ms = [s["ms"] for s in r0["steps"]]
    rec = dict(
        layers=cfg.n_layers, n_params=n_params, oracle=oracle,
        one_process_peak_gib=one_peak, tolerances=dict(tm), lines=lines,
        ranks=[dict(steps=o["steps"], losses=o["losses"],
                    sum_ms=o["sum_ms"], broadcast_ms=o["broadcast_ms"],
                    loop_s=o["loop_s"], peak_gib=o["peak_gib"],
                    launches=o["launches"], rollforward=o["rollforward"],
                    writes=o["writes"], restored=o["restored"])
               for o in outs],
        seconds=time.perf_counter() - t_phase)
    log(f"[train-mesh] step ms: rank 0 {[round(x, 3) for x in rank_ms]} "
        f"(rank 1 {[round(s['ms'], 3) for s in outs[1]['steps']]}; its "
        f"first step includes the ranks' first gloo sums), one process "
        f"{[round(o['ms'], 3) for o in oracle]}: the ranks share one card "
        f"and one host, so no speed-up can show; the gloo sum of the "
        f"gradients (float32, {n_params * 4 / 1e9:.2f} GB) ms per step "
        f"{[[round(x, 1) for x in o['sum_ms']] for o in outs]}; the initial "
        f"broadcast of the state {[round(o['broadcast_ms'], 1) for o in outs]}"
        f" ms; train_loop {[round(o['loop_s'], 1) for o in outs]} s; "
        f"max_memory_allocated per rank "
        f"{[round(o['peak_gib'], 2) for o in outs]} GiB (rank 0's holds "
        f"its one-process step's state too), one process "
        f"{one_peak:.2f} GiB; phase {rec['seconds']:.1f} s ({smi})")
    if fails:
        raise AssertionError("train-mesh: " + "; ".join(fails))
    return counts, rec


def _leaf_rel(grads, ref) -> float:
    """Largest normwise relative difference ``|g - r| / |r|`` over the
    leaves of two gradient trees (a leaf whose reference is all zero must
    be zero too)."""
    import torch

    from repro_torch.tree import leaves

    worst = 0.0
    for g, r in zip(leaves(grads), leaves(ref)):
        g, r = g.to(torch.float32), r.to(torch.float32)
        num, den = float(torch.linalg.vector_norm(g - r)), float(
            torch.linalg.vector_norm(r))
        worst = max(worst, num / den if den else (0.0 if num == 0
                                                  else float("inf")))
    return worst


def train_timings(dev, held, arch=LLAMA, tag="train",
                  syncs=(("spmd", "plain"), ("entangle", "plain"),
                         ("entangle", "kernel"), ("checksum", "plain"))):
    """Mean train-step time per gradient sync (host clock around steps
    that end in a synchronize, after TRAIN["warm_steps"] each), then the
    device time of one entangled sync on the kernel codec and the device
    idle share of one such step, from profiler windows. ``held`` is a
    one-element list holding the train state, which is taken out of it:
    each step then holds the only reference to the state it replaces, as
    in ``train_loop`` (a caller's reference would keep a third state on
    the card)."""
    import dataclasses as dc

    import torch

    from repro_torch.train.train_step import (loss_and_grads, make_train_step,
                                              sync_grads)

    state = held.pop()
    cfg, tcfg, dcfg = _train_configs(arch)
    batch = _batch(dcfg, 0, dev)
    out = {}
    for sync, codec in syncs:
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
        log(f"[{tag}] {arch} step time, grad_sync {key}: mean "
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
    out["top_ops"] = [dict(ms=us / 1e3, op=key[:160], count=n)
                      for us, key, n in rows[:10]]
    log(f"[profile] {arch}: one entangled sync (kernel codec) of the "
        f"gradients: device {out['sync_device_ms']:.3f} ms, of which the "
        f"entangle + disentangle kernels {out['sync_codec_kernels_ms']:.3f} "
        f"ms (traced launches {out['sync_codec_launches_traced']})")
    log(f"[profile] {arch}: one train step (entangle/kernel) under the "
        f"profiler: wall {wall:.3f} ms, device busy {out['step_busy_ms']:.3f}"
        f" ms (idle {100 - 100 * out['step_busy_ms'] / wall:.1f}% of the "
        f"profiled wall, "
        f"{100 - 100 * out['step_busy_ms'] / out['entangle/kernel']:.1f}% of "
        f"the unprofiled mean step; traced codec launches "
        f"{out['step_codec_launches_traced']})")
    for r in out["top_ops"]:
        log(f"[profile]   {r['ms']:9.3f} ms  x{r['count']:<5d} {r['op']}")
    del state
    free_cuda()
    return out


def flash_backward_check(dev):
    """The blocked attention's backward on the card at T = S =
    FLASH_CHECK["T"] with llama3.2-1b's heads (32 query heads on 8 KV
    heads of 64), causal, bfloat16 q / k / v as the models give them:
    out, dq, dk and dv against autograd through the materialized scores
    on the same inputs, within the CPU test's tolerances
    (tests/test_torch_loss.py: out within 2e-6, the bfloat16 gradients
    within one bf16 ulp). Device ms of each forward + backward from CUDA
    events."""
    import torch

    from repro_torch.models import attention_core as AC

    B, T = FLASH_CHECK["batch"], FLASH_CHECK["T"]
    cfg = model_config(LLAMA)
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // Hkv
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               .requires_grad_() for s in ((B, Hkv, G, T, hd),
                                           (B, Hkv, T, hd), (B, Hkv, T, hd)))
    dout = torch.randn((B, Hkv, G, T, hd), generator=gen, device=dev)
    scale = 1 / hd ** 0.5
    ok = AC._mask(AC.MaskInfo("causal"), T, T, dev)

    def blocked():
        out = AC.attend(q, k, v, kind="causal")
        return (out,) + torch.autograd.grad(out, (q, k, v), dout)

    def materialized():
        out = AC._softmax_block(q, k, v, ok, scale)
        return (out,) + torch.autograd.grad(out, (q, k, v), dout)

    assert T * T > AC.FLASH_THRESHOLD ** 2 // 4  # the blocked path
    res, ms = {}, {}
    for name, fn in (("blocked", blocked), ("materialized", materialized),
                     ("blocked", blocked), ("materialized", materialized)):
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res[name] = fn()
        end.record()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append(start.elapsed_time(end))
        ms[name + "_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    (o, *g), (wo, *wg) = res["blocked"], res["materialized"]
    out_err = (o - wo).abs().max().item()
    errs = []
    for a, b in zip(g, wg):
        a, b = a.float(), b.float()
        errs.append(((a - b).abs() - 2 ** -7 * (1 + b.abs())).max().item())
    del res, o, wo, g, wg, q, k, v, dout
    free_cuda()
    log(f"[train-families] flash backward on the card: [{B}, {Hkv}, {G}, "
        f"{T}, {hd}] bf16 causal; out max |err| {out_err:.3e} (tolerance "
        f"2e-6); dq / dk / dv excess over one bf16 ulp "
        f"{', '.join(f'{e:.3e}' for e in errs)} (must be <= 0); forward + "
        f"backward ms, blocked {ms['blocked']} vs materialized "
        f"{ms['materialized']}; peak {ms['blocked_peak_gib']:.2f} / "
        f"{ms['materialized_peak_gib']:.2f} GiB")
    if out_err > 2e-6 or max(errs) > 0:
        raise AssertionError("the blocked attention's backward disagrees "
                             "with the materialized path on the card")
    return dict(shape=[B, Hkv, G, T, hd], out_max_abs_err=out_err,
                grad_excess_over_ulp=errs, ms=ms)


def phase_train_families(dev, kernels):
    """Phase 4b: each family of TRAIN_FAMILIES trained at published widths
    cut to its depth, one at a time (its memory freed before the next):
    ``train_loop`` with a fail-stopped block and no final checkpoint
    (phases 4 and 4m write and restore theirs; :func:`phase_train`), EXACT
    ROLL-FORWARD (train-<family>) on one backward
    (:func:`train_rollforward`), the step ms per gradient sync (spmd,
    checksum, entangle on the kernel codec) and a profiler window
    (:func:`train_timings`); then the blocked attention's backward on the
    card (:func:`flash_backward_check`). Returns (counts by arch,
    record)."""
    t0 = time.perf_counter()
    counts, rec = {}, {}
    for arch in TRAIN_FAMILIES:
        state, counts[arch], rec[arch] = phase_train(
            dev, kernels, ["entangle", "disentangle"], arch,
            tag="train-families", ckpt=False)
        train_rollforward(dev, state, arch, tag="train-families")
        held = [state]
        del state
        rec[arch]["timings"] = train_timings(
            dev, held, arch, tag="train-families",
            syncs=(("spmd", "plain"), ("checksum", "plain"),
                   ("entangle", "kernel")))
        free_cuda()
    rec["flash_backward"] = flash_backward_check(dev)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[train-families] phase {rec['seconds']:.1f} s")
    return counts, rec


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
    """The plain and the entangled conv kernels, each on both routes (s8
    and CUDA cores), and the checksum kernel against their plain versions
    on full-range int32 words: ragged small shapes at K_f = 1, 2, 4, 100
    and 4500 under every plan (M = 3..8, dual-word at w=32, int32 at
    w=16), both modes, packed and unpacked taps, every failed stream, plus
    the poison check; the s8 route's edges (S8_EDGE_SHAPES) under M = 8;
    the depthwise model shape [M=4, B=8, D=8192, T=512], K_f = 4 (the
    Mamba conv1d of falcon-mamba-7b) under the int32 and the dual-word
    plan; the checksum at ragged widths for M = 1..9."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import checksum as kcks
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels.codec import pack_int8

    chk_c, chk_e = checkers["conv1d_causal"], checkers["entangled_conv1d"]
    chk_s = checkers["checksum"]
    gen = torch.Generator(device=dev).manual_seed(2024)
    n0 = (chk_c.n, chk_e.n, chk_s.n)
    for (B, D, T, kf) in CONV_SHAPES + S8_EDGE_SHAPES:
        x = _rand(gen, -2**31, 2**31, (B, D, T), dev)
        for lo in (-2**31, -128):  # full-range and one-byte taps
            w = _rand(gen, lo, -lo, (D, kf), dev)
            want = kconv.conv1d_causal_plain(x, w)
            for route in CONV_ROUTES:
                chk_c.equal(kconv.conv1d_causal_cuda(x, w, route=route), want,
                            f"conv1d [{B},{D},{T}] K_f={kf} taps in "
                            f"[{lo}, {-lo})", route)
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
    for plan in (make_plan(8, 32),):
        for (B, D, T, kf) in S8_EDGE_SHAPES:
            x = _rand(gen, -2**31, 2**31, (plan.M, B, D, T), dev)
            w32 = _rand(gen, -2**31, 2**31, (D, kf), dev)
            wp = pack_int8(_rand(gen, -128, 128, (D, kf), dev), axis=0)
            what = f"s8 edge plan(M={plan.M}) [{B},{D},{T}] K_f={kf}"
            for packed, w in ((False, w32), (True, wp)):
                chk_e.sweep(x, w, plan, packed, what, GROUPED_MODES)
            chk_e.poison(x, w32, plan, False, what)
    log(f"[kernels] conv1d_causal / entangled_conv1d ragged shapes (K_f "
        f"{sorted({s[3] for s in CONV_SHAPES})}) and the s8 route's edges "
        f"{S8_EDGE_SHAPES}, both routes each: {chk_c.n - n0[0]} / "
        f"{chk_e.n - n0[1]} kernel-vs-plain comparisons bit-identical; poison "
        f"check passed")
    n0 = (chk_c.n, chk_e.n)
    B, D, T, kf = DEPTHWISE
    x = _rand(gen, -2**31, 2**31, (4, B, D, T), dev)
    w = _rand(gen, -2**31, 2**31, (D, kf), dev)
    want = kconv.conv1d_causal_plain(x[0], w)
    for route in CONV_ROUTES:
        chk_c.equal(kconv.conv1d_causal_cuda(x[0], w, route=route), want,
                    f"conv1d {DEPTHWISE}", route)
    wp = pack_int8(_rand(gen, -128, 128, (D, kf), dev), axis=0)
    for plan in (make_plan(4, 32), make_plan(4, 16)):
        what = f"depthwise [4, {B}, {D}, {T}] K_f={kf} plan {plan.temp}"
        for packed, ww in ((False, w), (True, wp)):
            chk_e.sweep(x, ww, plan, packed, what, GROUPED_MODES)
        chk_e.poison(x, wp, plan, True, what)
    del x, w, wp
    free_cuda()
    log(f"[kernels] depthwise model shape [4, {B}, {D}, {T}], K_f = {kf}, "
        f"both routes: {chk_c.n - n0[0]} / {chk_e.n - n0[1]} comparisons "
        f"bit-identical; poison check passed")
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
    """Each conv kernel on both routes against its plain version at the
    stream-conv shapes (not counted as the path's launches): the conv over
    the M streams and over the M+1 of the checksum family, the entangled
    conv over [M, 1, 1, T] unfused and fused for every failed stream (the
    plain fused version is the plain unfused one disentangled, computed
    once), the checksum of the M streams. Returns {(M, K): the true conv
    outputs [M, T]}, the plain version's."""
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
        x4 = xs[:M, None].contiguous()
        delta = kecv.entangled_conv1d_plain(x4, taps, plan)
        for route in CONV_ROUTES:
            chk_c.equal(kconv.conv1d_causal_cuda(xs, taps, route=route), want,
                        what + " (M+1)", route)
            chk_c.equal(kconv.conv1d_causal_cuda(xs[:M].contiguous(), taps,
                                                 route=route),
                        want[:M], what, route)
            chk_e.equal(kecv.entangled_conv1d_cuda(x4, taps, plan,
                                                   route=route), delta,
                        what + " entangled", route)
            for r in range(M):
                chk_e.equal(kecv.entangled_conv1d_cuda(
                    x4, taps, plan, fuse_epilogue=True, failed=r, route=route),
                    disentangle_block(delta, plan, r), f"{what} fused r={r}",
                    route)
        truth[(M, K)] = want[:M, 0]
        del cs, xs, want, x4, delta
        free_cuda()
    log(f"[kernels] stream-conv shapes (M {STREAM_MS} x K "
        f"{sorted({k for _, k in inputs})}, T = N_in + K - 1), both conv "
        f"routes: {chk_c.n - n0[0]} / {chk_e.n - n0[1]} / {chk_s.n - n0[2]} "
        f"conv / entangled conv / checksum comparisons bit-identical "
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
    by_route = {k["name"]: {"s8": count(k, 1), "cuda_core": count(k, 2)}
                for k in kernels if k["counters"][0] == "launches"
                and len(k["counters"]) == 3}
    log(f"[stream-conv] kernel launches on the path: {counts}; the convs' "
        f"by route: {by_route}; conv part {conv_s:.1f} s, all "
        f"{time.perf_counter() - t0:.1f} s")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 f"stream-conv path")
    for name, per in by_route.items():
        if per["s8"] <= 0:
            raise AssertionError(f"the s8 route of {name} was never launched "
                                 f"by the stream-conv path")
    return counts, by_route


def _pct(t, base):
    return 100 * (t / base - 1)


def _int32_macs_per_s(dev):
    """The card's peak int32 multiply-add rate (CUDA cores)."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * INT32_LANES_PER_SM * BOOST_HZ


def _causal_macs(T, K):
    """Multiply-adds of one causal conv row of length T with K taps: output
    t takes min(t + 1, K) of them (the products that fall on the implicit
    left zero padding are not part of the work)."""
    if K >= T:
        return T * (T + 1) // 2
    return T * K - K * (K - 1) // 2


# limb products per multiply-add of the s8 route, by the tap limbs the taps
# need (u + v <= 3 of four u8 data limbs and v + 1 s8 tap limbs)
LIMB_PRODUCTS = {1: 4, 2: 7, 3: 9, 4: 10}


def tap_limbs_needed(w) -> int:
    """The balanced signed byte limbs of the int32 taps ``w`` that are not
    all zero: 1 for taps in [-128, 128), up to 4 (the s8 route's rule)."""
    import torch

    t = w.to(torch.int64).flatten()
    need = 1
    for v in range(4):
        b = ((t + 128) & 0xFF) - 128  # the signed low byte
        if v > 0 and bool((b != 0).any()):
            need = v + 1
        t = (t - b) >> 8
    return need


def conv_bound(dev, macs, nbytes, nv):
    """The bound of a conv call, the same for both routes: max(bytes at
    3.35 TB/s, min(int32 MACs on the CUDA cores, limb-product MACs x 2 at
    1,979 TOP/s)); ``nv`` tap limbs give LIMB_PRODUCTS[nv] limb products
    per MAC. Returns a dict of the bound and its terms (ms)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_int32 = 1e3 * macs / _int32_macs_per_s(dev)
    t_limb = 1e3 * 2 * LIMB_PRODUCTS[nv] * macs / INT8_TENSOR_OPS_PER_S
    t_ops = min(t_int32, t_limb)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, int32_macs_ms=t_int32, limb_ms=t_limb,
                limb_products=LIMB_PRODUCTS[nv])


def _bound_text(b) -> str:
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
            f"{b['bytes_ms']:.4f}, int32 MACs {b['int32_macs_ms']:.4f}, "
            f"{b['limb_products']} limb products {b['limb_ms']:.4f} ms)")


def stream_timings(dev, inputs):
    """Fig. 2 on the card: per (M, K), the device time of one call (CUDA
    graph replay) of the failure-intolerant conv (``run_protected`` mode
    none) and of each protected family without a failure, as the paper
    measures them: the entangled three-pass (entangle kernel + conv +
    disentangle kernel), the fused entangled conv of the op API (M-1
    streams computed), the checksum family (sum kernel + conv over M+1
    streams) and dual modular redundancy (2M streams); the entangle and
    checksum families again with stream 1 failed (poison and recovery
    included); and the routed conv kernel alone against its bound
    (:func:`conv_bound`). Returns (table rows, summary)."""
    import torch

    from repro_torch.core.failstop import FTConfig, run_protected
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import ops

    from repro_torch.kernels import conv1d as kconv

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
        bound = conv_bound(dev, M * _causal_macs(T, K), 4 * (2 * M * T + K),
                           tap_limbs_needed(g))
        row["conv_route"] = kconv.route_for(K, T)
        row["conv_bound"] = bound
        row["conv_bound_ms"] = bound["bound_ms"]
        base = row["conventional_ms"]
        for n in fns:
            if n not in ("conventional", "conv_kernel"):
                row[f"{n}_pct"] = _pct(row[f"{n}_ms"], base)
        table.append(row)
        log(f"[fig2] M={M} K={K}: conventional {base:.4f} ms (conv kernel, "
            f"route {row['conv_route']}, {row['conv_kernel_ms']:.4f} ms, "
            f"{row['conv_kernel_ms'] / bound['bound_ms']:.2f}x its "
            f"{_bound_text(bound)}); entangle three-pass "
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


def _turns(fns, iters, order=("cuda_core", "s8", "s8", "cuda_core")):
    """Device ms of each route's call, timed in turns (by default
    cuda_core, s8, s8, cuda_core) in CUDA graphs: {route: [ms, ...]}."""
    times = {route: [] for route in fns}
    for route in order:
        times[route].append(_graph_ms(fns[route], iters))
    return times


def stream_kernel_rows(dev, inputs):
    """Both routes of both convs (timed in turns), their plain versions, the
    bound of :func:`conv_bound` and the library call, and the checksum
    kernel: first at the largest stream-conv shape (M = 8, K = 4500) — the
    conv over [8, 1, T], the fused entangled conv over [8, 1, 1, T] with
    stream 1 failed (M-1 streams computed), the checksum of [8, N_in]
    (inputs rotated through copies that exceed the L2) — then both convs at
    the depthwise model shape. A row's ``ms`` is the route that
    ``route=None`` takes there. The conv's library call is
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

    def conv(xx, ww):
        """({route: kernel call}, plain call) of the conv."""
        return ({r: (lambda i, r=r: kconv.conv1d_causal_cuda(xx, ww, route=r))
                 for r in CONV_ROUTES},
                lambda i: kconv.conv1d_causal_plain(xx, ww))

    def econv(xx, ww, pl):
        """({route: kernel call}, plain call) of the fused entangled conv,
        stream 1 failed."""
        kw = dict(fuse_epilogue=True, failed=1)
        return ({r: (lambda i, r=r: kecv.entangled_conv1d_cuda(
                    xx, ww, pl, route=r, **kw)) for r in CONV_ROUTES},
                lambda i: kecv.entangled_conv1d_plain(xx, ww, pl, **kw))
    cases = [
        ("conv1d_causal", [list(x.shape), list(taps.shape)], *conv(x, taps),
         lib_conv(x, taps), M * _causal_macs(T, K), 4 * (2 * M * T + K),
         taps, T),
        ("entangled_conv1d", [[M, 1, 1, T], list(taps.shape)],
         *econv(x[:, None], taps, plan), None,
         (M - 1) * _causal_macs(T, K), 4 * (2 * M * T + K), taps, T),
        ("conv1d_causal", [[B, D, Td], [D, kf]], *conv(xdl, wdl),
         lib_conv(xdl, wdl), B * D * _causal_macs(Td, kf),
         4 * (2 * B * D * Td + D * kf), wdl, Td),
        ("entangled_conv1d", [[4, B, D, Td], [D, kf]],
         *econv(xdw, wdw, make_plan(4, 32)), None,
         3 * B * D * _causal_macs(Td, kf),
         4 * (2 * 4 * B * D * Td + D * kf), wdw, Td)]
    rows = {}
    for name, shape, kerns, plain, lib, macs, nbytes, w, tt in cases:
        big = macs > 1e10  # the stream-conv filters: few, long calls
        turns = _turns(kerns, 10 if big else 50)
        plain_ms = _graph_ms(plain, 1 if big else 10)
        lib_ms = None if lib is None else _graph_ms(lib, 3 if big else 10)
        bound = conv_bound(dev, macs, nbytes, tap_limbs_needed(w))
        route = kconv.route_for(w.shape[-1], tt,
                                name == "entangled_conv1d")
        by_route = {r: dict(ms=sum(t) / 2, ms_turns=t,
                            x_bound=sum(t) / 2 / bound["bound_ms"])
                    for r, t in turns.items()}
        row = dict(shape=shape, route=route, ms=by_route[route]["ms"],
                   by_route=by_route, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound)
        rows.setdefault(name, []).append(row)
        log(f"[timing] {name} {shape}: s8 {by_route['s8']['ms']:.4f} ms "
            f"(turns {turns['s8'][0]:.4f} / {turns['s8'][1]:.4f}; "
            f"{by_route['s8']['x_bound']:.2f}x bound), CUDA-core "
            f"{by_route['cuda_core']['ms']:.4f} ms (turns "
            f"{turns['cuda_core'][0]:.4f} / {turns['cuda_core'][1]:.4f}; "
            f"{by_route['cuda_core']['x_bound']:.2f}x bound), route=None "
            f"takes {route}; plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
            f"{_bound_text(bound)}")
    name, shape = "checksum", [list(c.shape)]
    ms = _graph_ms(lambda i: kcks.checksum_cuda(cs[i % len(cs)]), 50)
    plain_ms = _graph_ms(lambda i: kcks.checksum_plain(cs[i % len(cs)]), 10)
    lib_ms = _graph_ms(
        lambda i: torch.sum(cs[i % len(cs)], 0, dtype=torch.int32), 10)
    t_bytes = 1e3 * 4 * (M + 1) * c.shape[1] / HBM_BYTES_PER_S
    rows[name] = [dict(shape=shape, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=t_bytes, bound_by="bytes",
                       bytes_ms=t_bytes)]
    log(f"[timing] {name} {shape}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {t_bytes:.4f} ms "
        f"(bytes), {ms / t_bytes:.2f}x bound")
    del cases, x, cs, xdw, wdw, xdl, wdl
    free_cuda()
    return rows


def run_stream_conv(dev, kernels):
    """The stream-conv path: kernel checks (ragged, depthwise and the
    stream shapes), the path itself, its Fig. 2 timings and both conv
    routes' kernel rows."""
    t0 = time.perf_counter()
    by_name = {k["name"]: k["checker"] for k in kernels}
    check_conv(dev, by_name)
    inputs = stream_inputs(dev)
    truth = check_stream_shapes(dev, by_name, inputs)
    counts, by_route = phase_stream_conv(
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
    return dict(counts=counts, counts_by_route=by_route, fig2=table,
                fig2_summary=summary, rows=rows)


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


def _event_ms(fn, iters):
    """Mean device time of ``fn()`` in ms between CUDA events around
    ``iters`` calls, after one warm-up call; for calls whose temporaries
    are too large to capture several of in a CUDA graph's private pool."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timing_row(dev, site, c, gs, plan, fns, plain_fn, macs, nbytes,
                wbytes, iters, plain_graph=True):
    """Both GEMM kernels (``fns``: route -> launch function), the plain
    version and the bounds of one shape; ``gs`` holds enough weight copies
    to exceed the L2. The kernels are timed in turns (CUDA-core, s8, s8,
    CUDA-core) in one call. Bounds: the bytes (each input read once, the
    output written once, at 3.35 TB/s); the CUDA-core kernel's int32 MACs
    of the M-1 computed streams; the s8 kernel's 4 limb MACs per int32
    MAC at 1,979 TOP/s (2 operations per MAC). With ``plain_graph``
    False the plain version is timed between CUDA events (two calls), not
    in a CUDA graph."""
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
    if plain_graph:
        plain_ms = _graph_ms(
            lambda i: plain_fn(c, gs[i % copies], plan, **kw),
            max(3, iters // 5))
    else:
        free_cuda()
        plain_ms = _event_ms(lambda: plain_fn(c, gs[0], plan, **kw), 2)
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
    then at the recurrent families' new decode shapes (falcon-mamba's
    in_proj, out_proj and head, recurrentgemma's in_gate / in_x, MQA k /
    v, MLP and tied head) and deepseek-v3's (head, low-rank q_a / q,
    out.o, dense MLP), and the grouped kernels at the deepseek-v2-lite and
    deepseek-v3 decode MoE shapes with every expert occupied and at decode
    occupancy (8 tokens x top-6 / top-8 experts from the seed; the other
    experts' rows zero, as the dispatch leaves them, so the bound counts
    only the occupied experts' weights). Weights are
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
    fm, rg = model_config(RECURRENT[0]), model_config(RECURRENT[1])
    fm_di = fm.ssm.expand * fm.d_model
    rg_kv = rg.n_kv_heads * rg.resolved_head_dim
    v3 = model_config(V3)
    v3_qk = v3.mla.qk_nope_head_dim + v3.mla.qk_rope_head_dim
    for site, (B, K, N) in (
            (f"{LLAMA} head", (gsz, cfg.d_model, cfg.vocab_size)),
            (f"{LLAMA} mlp.down", (gsz, cfg.d_ff, cfg.d_model)),
            (f"{LLAMA} mlp.gate/up", (gsz, cfg.d_model, cfg.d_ff)),
            (f"{fm.name} qkv.in", (gsz, fm.d_model, 2 * fm_di)),
            (f"{fm.name} out.o", (gsz, fm_di, fm.d_model)),
            (f"{fm.name} head", (gsz, fm.d_model, fm.vocab_size)),
            (f"{rg.name} qkv.gate/in", (gsz, rg.d_model,
                                        rg.rglru.lru_width)),
            (f"{rg.name} qkv.k/v", (gsz, rg.d_model, rg_kv)),
            (f"{rg.name} mlp.gate/up", (gsz, rg.d_model, rg.d_ff)),
            (f"{rg.name} tied head", (gsz, rg.d_model, rg.vocab_size)),
            (f"{V3} head", (gsz, v3.d_model, v3.vocab_size)),
            (f"{V3} qkv.q_a", (gsz, v3.d_model, v3.mla.q_lora_rank)),
            (f"{V3} qkv.q", (gsz, v3.mla.q_lora_rank, v3.n_heads * v3_qk)),
            (f"{V3} out.o", (gsz, v3.n_heads * v3.mla.v_head_dim,
                             v3.d_model)),
            (f"{V3} mlp.gate/up", (gsz, v3.d_model, v3.d_ff)),
            (f"{V3} mlp.down", (gsz, v3.d_ff, v3.d_model))):
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (M, B, K), dev)
        wbytes = (K // 4) * N * 4
        gs = [pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
              for _ in range(max(1, -(-2 * L2_BYTES // wbytes)))]
        rows["entangled_matmul"].append(_timing_row(
            dev, site, c, gs, plan, dense_fns,
            emm.entangled_matmul_plain, macs=(M - 1) * B * K * N,
            nbytes=4 * (M * B * K + (K // 4) * N + M * B * N), wbytes=wbytes,
            iters=20 if N > 100_000 else 50))
        del c, gs
        free_cuda()
    from repro_torch.models.layers import _moe_capacity

    grouped_fns = dict(s8=emmg.entangled_matmul_grouped_cuda,
                       cuda_core=emmg.entangled_matmul_grouped_cuda_core)
    # v3's plain version takes ~50 GB of temporaries per call (its 256
    # experts' weights as float64): timed between events, not in a graph
    for arch, both_full, iters in ((DEEPSEEK, False, 50), (V3, True, 15)):
        cfg = model_config(arch)
        E, F, D = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
        Cg = -(-_moe_capacity(SERVE["max_batch"], cfg) // M)  # decode rows
        occ = decode_occupancy(E, cfg.moe.top_k, SERVE["max_batch"], seed=7)
        n_occ = int(occ.sum())
        at_occ = f"at decode occupancy ({n_occ} of {E} experts)"
        shapes = [("moe.gate/up", (D, F), E), ("moe.down", (F, D), E),
                  (f"moe.gate/up {at_occ}", (D, F), n_occ)]
        if both_full:
            shapes.append((f"moe.down {at_occ}", (F, D), n_occ))
        for site, (K, N), occupied in shapes:
            bud = activation_budget(plan, K)
            c = _rand(gen, -bud, bud + 1, (M, E, Cg, K), dev)
            if occupied < E:
                c[:, ~occ.to(dev)] = 0
            wbytes = occupied * (K // 4) * N * 4
            gs = [_packed_weights(gen, E, K, N, dev)
                  for _ in range(max(1, -(-2 * L2_BYTES // (E * K * N))))]
            rows["entangled_matmul_grouped"].append(_timing_row(
                dev, f"{arch} decode {site}", c, gs, plan, grouped_fns,
                emmg.entangled_matmul_grouped_plain,
                macs=(M - 1) * occupied * Cg * K * N,
                nbytes=4 * (M * E * Cg * K + occupied * (K // 4) * N
                            + M * E * Cg * N),
                wbytes=wbytes, iters=iters, plain_graph=arch != V3))
            del c, gs
            free_cuda()
    return rows


# --------------------------------------------------------------- autotune --

# the [autotune] phase's calls per printed time (CUDA-graph replay; the
# codec pass's 1 GB outputs are timed between events instead)
AUTOTUNE_ITERS = 50
# the launch parameters the launcher's dict sets on the head GEMM
LAUNCHER_BLOCKS = {"bb": 1, "splits": 2}
# the codec passes' swept width: the largest llama gradient leaf's
AUTOTUNE_CODEC_N = 1 << 26


def _sweep(dev, smi, site, op, call, want, sig, flags, bound, graph=True):
    """One shape of the sweep: every candidate of ``candidates_for`` at the
    signature ``sig`` (the rule's first) held bit for bit against the plain version's ``want``,
    then ``tune`` on a fresh cache that reads no seed, and the rule and the
    winner re-timed in a CUDA graph of AUTOTUNE_ITERS calls
    (``call(blocks, i)`` rotates weight copies by i) or, ``graph`` False,
    between events. Returns the row."""
    import itertools

    import torch

    from repro_torch.kernels import autotune as at

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cands = at.candidates_for(op, sms=sms, **at.sig_dims(op, sig, flags))
    for cand in cands:
        if not torch.equal(call(cand, 0), want):
            raise AssertionError(f"[autotune] {site}: candidate {cand} "
                                 f"differs from the plain version")
    cache = at.AutotuneCache(None, seeds=False)
    it = itertools.count()
    won = at.tune(op, sig, "cuda_sm90",
                  lambda b: (lambda: call(b, next(it))), candidates=cands,
                  flags=flags, cache=cache)

    def timed(b):
        if graph:
            return _graph_ms(lambda i: call(b, i), AUTOTUNE_ITERS)
        return _event_ms(lambda: call(b, next(it)), 10)

    rule_ms = timed(cands[0])
    won_ms = rule_ms if won == cands[0] else timed(won)
    sweep = cache.reports[at.cache_key(op, sig, "cuda_sm90", flags)]
    log(f"[autotune] {site}: {len(cands)} candidates, each bit-identical to "
        f"the plain version; rule {cands[0]} {rule_ms:.4f} ms, winner {won} "
        f"{won_ms:.4f} ms ({rule_ms / won_ms:.2f}x the winner), bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}): rule "
        f"{rule_ms / bound['bound_ms']:.2f}x, winner "
        f"{won_ms / bound['bound_ms']:.2f}x; {smi}")
    return dict(site=site, op=op, candidates=len(cands), rule=cands[0],
                rule_ms=rule_ms, winner=won, winner_ms=won_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                sweep_ms=[[c, t] for c, t in sweep])


def _gemm_bound(M, occupied, Cg, K, N, E=1):
    """The packed GEMM's bound: bytes (each input once, the output once) at
    3.35 TB/s against the s8 kernel's 4 limb MACs per int32 MAC of the
    M-1 computed streams at 1,979 TOP/s, as the [timing] rows."""
    nbytes = 4 * (M * E * Cg * K + occupied * (K // 4) * N + M * E * Cg * N)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_s8 = 1e3 * 2 * 4 * (M - 1) * occupied * Cg * K * N / INT8_TENSOR_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_s8),
                bound_by="bytes" if t_bytes >= t_s8 else "operations")


def autotune_sweeps(dev, smi):
    """The shapes furthest from their bounds (PERF.md §6) swept over every
    launch parameter the kernel takes: the dense GEMM at llama's mlp.down
    and head, recurrentgemma's MQA k / v (N = 256) and qkv.gate, v3's
    q_a (seeded operands of its shape), the grouped GEMM at
    deepseek-v2-lite's decode moe.gate/up at decode occupancy, the
    entangle and disentangle passes at [4, 67,108,864], and the conv at
    the stream and the depthwise shape. Decode GEMMs: M = 4, 2 rows per
    group, packed, fused, failed = 1, weights rotated through copies past
    the L2."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft.quantize import activation_budget
    from repro_torch.kernels import checksum as kcks  # noqa: F401
    from repro_torch.kernels import conv1d as kconv
    from repro_torch.kernels import disentangle as kdis
    from repro_torch.kernels import entangle as kent
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.kernels import entangled_matmul_grouped as emmg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.codec import pack_int8
    from repro_torch.models.layers import _moe_capacity

    plan = make_plan(SERVE["ft_M"], 32)
    M, B = plan.M, SERVE["max_batch"] // plan.M
    gen = torch.Generator(device=dev).manual_seed(11)
    kw = dict(fuse_epilogue=True, failed=1, packed=True)
    flags = kops._matmul_flags(plan, True, True)
    llama, rg = model_config(LLAMA), model_config(RECURRENT[1])
    v3 = model_config(V3)
    rows = []
    for site, (K, N) in (
            (f"{LLAMA} mlp.down", (llama.d_ff, llama.d_model)),
            (f"{LLAMA} head", (llama.d_model, llama.vocab_size)),
            (f"{rg.name} qkv.k/v", (rg.d_model,
                                    rg.n_kv_heads * rg.resolved_head_dim)),
            (f"{rg.name} qkv.gate", (rg.d_model, rg.rglru.lru_width)),
            (f"{V3} qkv.q_a", (v3.d_model, v3.mla.q_lora_rank))):
        bud = activation_budget(plan, K)
        c = _rand(gen, -bud, bud + 1, (M, B, K), dev)
        gs = [pack_int8(_rand(gen, -127, 128, (K, N), dev), axis=0)
              for _ in range(max(1, -(-2 * L2_BYTES // (K * N))))]
        want = emm.entangled_matmul_plain(c, gs[0], plan, **kw)
        rows.append(_sweep(
            dev, smi, f"{site} decode [{M},{B},{K}] x [{K // 4},{N}]",
            "entangled_matmul",
            lambda b, i: kops.entangled_matmul(c, gs[i % len(gs)], plan,
                                               blocks=b, **kw),
            want, (M, B, K, N), flags, _gemm_bound(M, 1, B, K, N)))
        del c, gs, want
        free_cuda()
    cfg = model_config(DEEPSEEK)
    E, F, D = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    Cg = -(-_moe_capacity(SERVE["max_batch"], cfg) // M)
    occ = decode_occupancy(E, cfg.moe.top_k, SERVE["max_batch"], seed=7)
    bud = activation_budget(plan, D)
    c = _rand(gen, -bud, bud + 1, (M, E, Cg, D), dev)
    c[:, ~occ.to(dev)] = 0
    gs = [_packed_weights(gen, E, D, F, dev)
          for _ in range(max(1, -(-2 * L2_BYTES // (E * D * F))))]
    want = emmg.entangled_matmul_grouped_plain(c, gs[0], plan, **kw)
    rows.append(_sweep(
        dev, smi, f"{DEEPSEEK} decode moe.gate/up [{M},{E},{Cg},{D}] x "
        f"[{E},{D // 4},{F}] at decode occupancy ({int(occ.sum())} of {E} "
        f"experts)", "entangled_matmul_grouped",
        lambda b, i: kops.entangled_matmul_grouped(c, gs[i % len(gs)], plan,
                                                   blocks=b, **kw),
        want, (M, E, Cg, D, F), flags,
        _gemm_bound(M, int(occ.sum()), Cg, D, F, E=E)))
    del c, gs, want
    free_cuda()
    n = AUTOTUNE_CODEC_N
    x = _rand(gen, -2**31, 2**31 - 1, (M, n), dev)
    # each input byte read once, each output byte written once, as
    # codec_timings counts them: the disentangle never reads row r
    for op, call, plain, words in (
            ("entangle", lambda b, i: kops.entangle(x, plan, blocks=b),
             lambda: kent.entangle_plain(x, plan), 2 * M * n),
            ("disentangle",
             lambda b, i: kops.disentangle(x, plan, failed=1, blocks=b),
             lambda: kdis.disentangle_plain(x, plan, 1), (2 * M - 1) * n)):
        codec_bound = dict(bound_ms=1e3 * 4 * words / HBM_BYTES_PER_S,
                           bound_by="bytes")
        rows.append(_sweep(dev, smi, f"{op} [{M}, {n}]", op, call, plain(),
                           (M, n), kops._plan_flags(plan), codec_bound,
                           graph=False))
        free_cuda()
    del x
    free_cuda()
    inputs = stream_inputs(dev)
    c, g = inputs[(max(STREAM_MS), 4500)]
    xs = _padded(c, 4500)[:, None, :].contiguous()  # [B = 8, D = 1, T]
    w = g[None, :].contiguous()
    Bd, Dd, Td, Kd = DEPTHWISE
    xd = _rand(gen, -2**31, 2**31 - 1, (Bd, Dd, Td), dev)
    wd = _rand(gen, -2**13, 2**13, (Dd, Kd), dev)
    for site, xx, ww in (
            (f"conv1d stream [{xs.shape[0]}, 1, {xs.shape[-1]}] x [1, 4500]",
             xs, w),
            (f"conv1d depthwise [{Bd}, {Dd}, {Td}] x [{Dd}, {Kd}]", xd, wd)):
        B_, D_, T_ = xx.shape
        macs = B_ * D_ * _causal_macs(T_, ww.shape[-1])
        rows.append(_sweep(
            dev, smi, site, "conv1d_causal",
            lambda b, i, xx=xx, ww=ww: kops.conv1d_causal(xx, ww, blocks=b),
            kconv.conv1d_causal_plain(xx, ww), (B_, D_, T_, ww.shape[-1]), (),
            conv_bound(dev, macs, 4 * (2 * xx.numel() + ww.numel()),
                       tap_limbs_needed(ww))))
    del inputs, c, g, xs, w, xd, wd
    free_cuda()
    return rows


def autotune_cold_start(dev, kernels, smi):
    """llama3.2-1b at published widths served with ``blocks="auto"`` at
    scope all from an empty user cache over the shipped seed
    (``pretuned/cuda_sm90.json``): the engine must start with 0 sweeps and
    > 0 hits, serve the wave healthy and with failed_group=1 (on a warm
    replica, which sweeps nothing) with equal tokens, and give the tokens
    of the blocks=None engine. Counts are set to 0 before the auto
    engines' waves and read after. Returns (counts, record)."""
    import numpy as np

    from repro_torch.kernels import autotune as at
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, _, params = init_model(dev, LLAMA)
    base = dict(max_batch=SERVE["max_batch"], max_seq=SERVE["max_seq"],
                ft_mode="entangle", ft_M=SERVE["ft_M"], ft_scope="all")
    eng = ServeEngine(cfg, ServeConfig(**base), params, device=dev)
    want, _, _ = _wave(eng, cfg, None, kernels)
    del eng
    free_cuda()
    tmp = tempfile.mkdtemp(prefix="autotune-")
    try:
        at.reset_cache(str(pathlib.Path(tmp) / "autotune.json"))
        reset_counts(kernels)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, ServeConfig(blocks="auto", **base), params,
                          device=dev)
        startup_s = time.perf_counter() - t0
        st0 = at.stats()
        if st0["sweeps"] != 0 or st0["hits"] <= 0:
            raise AssertionError(f"[autotune] the cold start swept: {st0}")
        healthy, st_h, _ = _wave(eng, cfg, None, kernels)
        eng2 = ServeEngine(cfg, ServeConfig(blocks="auto", **base), params,
                           device=dev, warm=eng.warm_state())
        injected, _, _ = _wave(eng2, cfg, 1, kernels)
        counts = {k["name"]: count(k) for k in kernels}
        st = at.stats()
        winners = eng.census.get("head_gemm")
        del eng, eng2
    finally:
        at.reset_cache(None)
        shutil.rmtree(tmp, ignore_errors=True)
    bad = sum(not np.array_equal(healthy[r], injected[r]) for r in healthy)
    differ = sum(not np.array_equal(healthy[r], want[r]) for r in healthy)
    verdict = "EXACT ROLL-FORWARD" if bad == 0 else "RECOVERY FAILED"
    log(f"[autotune] {cfg.name} blocks=auto from the seed, scope all: "
        f"startup {startup_s:.1f} s with {st0['sweeps']} sweeps and "
        f"{st0['hits']} hits ({st0['keys']} seeded keys); head-GEMM winners "
        f"{winners}; recovery summary: failed_group=1 injected on every "
        f"step (warm replica); {len(healthy)} requests compared; "
        f"mismatching requests: {bad} ({verdict} (autotune)); tokens equal "
        f"to blocks=None's: {len(healthy) - differ} of {len(healthy)}; "
        f"after the waves {st['sweeps']} sweeps, {st['hits']} hits; "
        f"launches {counts}; {smi}")
    if bad or differ or st["sweeps"]:
        raise AssertionError(f"[autotune] cold start: {verdict}, {differ} "
                             f"requests differ from blocks=None, "
                             f"{st['sweeps']} sweeps")
    if counts["entangled_matmul"] <= 0:
        raise AssertionError("[autotune] the auto engines launched no GEMM")
    del params
    free_cuda()
    return counts, dict(startup_s=startup_s, stats_at_start=st0,
                        stats_after=st, head_winners=str(winners),
                        step_ms=1e3 * float(np.mean(st_h[1:])))


def autotune_launcher(kernels, smi):
    """``launch.serve`` on the card (llama3.2-1b at published widths, scope
    head, 4 requests of 4 new tokens) with ``--blocks`` a JSON dict: the
    head GEMM's last launch must carry its bb and splits. Counts are set
    to 0 before and read after. Returns (counts, record)."""
    from repro_torch.kernels import entangled_matmul as emm
    from repro_torch.launch import serve as launch_serve

    reset_counts(kernels)
    emm.last_launch.clear()
    launch_serve.main(["--arch", LLAMA, "--ft-mode", "entangle",
                       "--requests", "4", "--max-new", "4",
                       "--blocks", json.dumps(LAUNCHER_BLOCKS)])
    counts = {k["name"]: count(k) for k in kernels}
    got = {k: emm.last_launch.get(k) for k in LAUNCHER_BLOCKS}
    log(f"[autotune] launch.serve --blocks '{json.dumps(LAUNCHER_BLOCKS)}': "
        f"the head GEMM's last launch {dict(emm.last_launch)}; launches "
        f"{counts}; {smi}")
    if got != LAUNCHER_BLOCKS or counts["entangled_matmul"] <= 0:
        raise AssertionError(f"[autotune] the launcher's blocks did not "
                             f"reach the kernel: {got}")
    free_cuda()
    return counts, dict(blocks=LAUNCHER_BLOCKS,
                        last_launch=dict(emm.last_launch))


def phase_autotune(dev, kernels, smi):
    """[autotune]: the sweeps, the cold start from the seed and the
    launcher's dict (the roofline shares come after the train phase,
    :func:`roofline_shares`). Returns (counts by path, record)."""
    t0 = time.perf_counter()
    rows = autotune_sweeps(dev, smi)
    cold_counts, cold = autotune_cold_start(dev, kernels, smi)
    launcher_counts, launcher = autotune_launcher(kernels, smi)
    secs = time.perf_counter() - t0
    log(f"[autotune] phase {secs:.1f} s")
    return ({"autotune": cold_counts, "autotune launcher": launcher_counts},
            dict(sweeps=rows, cold_start=cold, launcher=launcher,
                 seconds=secs))


def roofline_shares(dev, smi, decode_ms, train_ms):
    """``op_cost`` on the meta device over one llama3.2-1b decode step at
    scope all (8 slots, the engine's packed int8 copies, the head through
    ``ft_logits_decode``) and one train step at the train phase's shape
    (entangled sync on the kernel codec), each divided by the step time the
    serve and train phases measured: the bf16 share (``mfu``, against
    989 TFLOP/s), the int8 share of the kernels' integer operations
    (1,979 TOP/s) and the HBM share of the bytes (op_cost's unfused
    upper bound, 3.35 TB/s)."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.ft import FTContext, PlanRegistry, prepare_params
    from repro_torch.ft.heads import ft_logits_decode, quantize_head
    from repro_torch.kernels.codec import pack_int8
    from repro_torch.launch import input_specs as isp
    from repro_torch.launch import op_cost
    from repro_torch.launch.roofline import HBM_BW, PEAK_BF16, PEAK_INT8
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.train.train_step import make_train_step

    meta = isp.META
    cfg = served_config(LLAMA)
    model = get_model(cfg)
    B, S = SERVE["max_batch"], SERVE["max_seq"]
    plan = make_plan(SERVE["ft_M"], 32)
    p = isp.params_specs(cfg, S)
    ftp = prepare_params(p, scope="all")
    head_q, w_scale = quantize_head(model.head_weights(p, cfg))
    head_q = pack_int8(head_q, axis=0)
    ftx = FTContext(registry=PlanRegistry(plan), scope="all")
    cache = model.init_cache(cfg, B, S, device=meta)
    tok = torch.zeros((B, 1), dtype=torch.int64, device=meta)
    pos = torch.zeros((B,), dtype=torch.int64, device=meta)

    def decode():
        h, _ = model.decode_hidden(ftp, tok, cache, pos, cfg, ft=ftx)
        return ft_logits_decode(h.float(), head_q, w_scale,
                                plan=plan).argmax(-1)

    _, dc = op_cost.count(decode)
    tcfg_cfg, tcfg, dcfg = _train_configs(LLAMA)
    tp = isp.params_specs(tcfg_cfg, TRAIN["seq"])
    state = {"params": tp, "opt": adamw_mod.init(tp, tcfg.adamw),
             "step": torch.zeros((), dtype=torch.int32, device=meta)}
    batch = {k: torch.zeros((TRAIN["batch"], TRAIN["seq"]), dtype=dt,
                            device=meta)
             for k, dt in (("tokens", torch.int64),
                           ("loss_mask", torch.int32))}
    _, tc = op_cost.count(make_train_step(tcfg_cfg, tcfg), state, batch)
    out = {}
    for name, cost, ms in (("decode", dc, decode_ms), ("train", tc,
                                                        train_ms)):
        s = ms / 1e3
        moved = cost.bytes + cost.kernel_bytes
        out[name] = dict(step_ms=ms, flops=cost.flops, int_ops=cost.int_ops,
                         bytes=moved, mfu=cost.flops / (s * PEAK_BF16),
                         int8_share=cost.int_ops / (s * PEAK_INT8),
                         hbm_share=moved / (s * HBM_BW))
        log(f"[autotune] roofline, one {cfg.name} {name} step "
            f"({'scope all, 8 slots' if name == 'decode' else 'batch 4 x seq 512, entangle/kernel'}): "
            f"op_cost {cost.flops / 1e9:.3f} GFLOP bf16/float, "
            f"{cost.int_ops / 1e9:.3f} G kernel int ops, {moved / 1e9:.3f} GB "
            f"(unfused bound) over the measured {ms:.3f} ms: mfu "
            f"{out[name]['mfu']:.5f}, int8 share {out[name]['int8_share']:.5f}, "
            f"HBM share {out[name]['hbm_share']:.5f}; {smi}")
    return out


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
                admission=admit, dense=dense,
                n_dense_shapes=len(dense), n_grouped_shapes=len(grouped))


def kernel_table():
    """Every kernel of the port: its module, route, source, builds, launch
    counters (per route), the TPU kernel it replaces and its checker."""
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
    # the convs' counters: all launches (the main count), then per route
    conv_counters = ["launches", "launches_s8", "launches_cuda_core"]
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
             source=conv_src, counters=conv_counters,
             replaces="src/repro/kernels/entangled_conv1d.py:68",
             checker=Checker(plain_fn=kecv.entangled_conv1d_plain,
                             route_fns={r: functools.partial(
                                 kecv.entangled_conv1d_cuda, route=r)
                                 for r in CONV_ROUTES})),
        dict(name="conv1d_causal", module=kconv, route="cuda",
             source=conv_src, counters=conv_counters,
             replaces="src/repro/kernels/conv1d.py:51",
             checker=Checker()),
        dict(name="checksum", module=kcks, route="cuda", source=codec_src,
             replaces="src/repro/kernels/checksum.py:22",
             checker=Checker())]
    for k in kernels:
        k.setdefault("builds", [(k["source"], k["module"].build)])
        k.setdefault("counters", ["launches"])
    return kernels


# the spawned ranks of the phases across ranks, by --dist-phase
WORKERS = {"dist": "dist_worker", "serve-mesh": "mesh_worker",
           "train-mesh": "train_mesh_worker"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve-admission wave's prompt lengths")
    ap.add_argument("--dist-worker", type=int, default=None,
                    help=argparse.SUPPRESS)  # a rank of the [dist] phase
    ap.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-phase", default="dist",
                    choices=tuple(WORKERS), help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.dist_worker is not None:
        torch.cuda.set_device(0)
        return globals()[WORKERS[args.dist_phase]](
            args.dist_worker, pathlib.Path(args.dist_dir),
            torch.device("cuda", 0))
    kernels = kernel_table()
    by_name = {k["name"]: k for k in kernels}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_all = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    last = [t_all]

    def lap(name):
        # each path's share of the script's time limit, for depth cuts
        now = time.perf_counter()
        log(f"[time] {name}: {now - last[0]:.1f} s (at {now - t_all:.1f} s)")
        last[0] = now

    phase_build(kernels)
    lap("build")
    paths = {LLAMA: run_path(dev, kernels, LLAMA, ["entangled_matmul"],
                             ("head", "all"),
                             (tuple(ADMIT_MODES), ("head", "all"), True),
                             smi, args.seed)}
    lap(LLAMA)
    paths[DEEPSEEK] = run_path(
        dev, kernels, DEEPSEEK, ["entangled_matmul",
                                 "entangled_matmul_grouped"],
        ("moe", "all"), (("chunked", "packed"), ("all",), False), smi,
        args.seed)
    lap(DEEPSEEK)
    mesh_counts, serve_mesh = phase_serve_mesh(dev, kernels, smi)
    lap("serve-mesh")
    autotune_counts, autotune = phase_autotune(dev, kernels, smi)
    lap("autotune")
    fleet_counts, fleet = phase_fleet(dev, kernels, smi, args.seed,
                                      paths[LLAMA]["dense"])
    lap("fleet")
    decoder_counts, decoders = phase_decoders(dev, kernels, smi)
    lap("dense-decoders")
    recurrent_counts, recurrent = phase_recurrent(dev, kernels, smi,
                                                  args.seed)
    lap("recurrent")
    family_counts, families, family_rows = phase_families(dev, kernels, smi)
    lap("families")
    v3_counts, serve_v3 = phase_serve_v3(dev, kernels, smi)
    lap("serve-v3")
    grad_shapes = llama_grad_shapes(dev)
    check_codec(dev, {n: by_name[n]["checker"]
                      for n in ("entangle", "disentangle")}, grad_shapes)
    state, train_counts, train = phase_train(
        dev, kernels, ["entangle", "disentangle"])
    train_rollforward(dev, state)
    train["remat"] = train_remat_checks(dev, state["params"], smi)
    train["variants"] = train_variants(dev, state, smi)
    lap("train")
    dist_counts, dist_rec = phase_dist(dev, kernels, state, smi)
    lap("dist")
    held = [state]
    del state
    train["timings"] = train_timings(dev, held)
    free_cuda()
    autotune["roofline"] = roofline_shares(
        dev, smi, paths[LLAMA]["results"]["all"]["step_ms"],
        train["timings"]["entangle/kernel"])
    lap("train timings, roofline")
    train_mesh_counts, train_mesh = phase_train_mesh(dev, kernels, smi)
    lap("train-mesh")
    tf_counts, train_families = phase_train_families(dev, kernels)
    lap("train-families")
    stream = run_stream_conv(dev, kernels)
    lap("stream-conv")
    lib_counts, library = phase_library(dev, kernels, smi)
    lap("library")
    rows = phase_timings(dev)
    rows.update(codec_timings(dev))
    lap("timings")
    rows.update(stream.pop("rows"))
    rows["entangled_matmul"] += family_rows
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    train_path = f"{LLAMA} train"
    # the s8 launches per decode step of the families' paths
    family_steps = {
        f"{VLM} families": dict(
            families[VLM]["s8_launches_per_decode_step"],
            **{f"prefix {sc}": families[VLM]["prefix"][sc][
                "s8_per_decode_step"] for sc in ("head", "all")}),
        f"{ENCDEC} families": families[ENCDEC][
            "s8_launches_per_decode_step"]}
    record = dict(kernels=[])
    for k in kernels:
        name, chk = k["name"], k["checker"]
        by_path = {a: p["counts"][name] for a, p in paths.items()}
        by_path.update({f"{a} serve-admission": p["admission_counts"][name]
                        for a, p in paths.items()})
        by_path["fleet"] = fleet_counts[name]
        by_path.update({f"{a} dense-decoders": c[name]
                        for a, c in decoder_counts.items()})
        by_path.update({f"{a} recurrent": c[name]
                        for a, c in recurrent_counts.items()})
        by_path.update({a: c[name] for a, c in family_counts.items()})
        by_path[train_path] = train_counts[name]
        by_path.update({f"{a} train-families": c[name]
                        for a, c in tf_counts.items()})
        by_path["stream-conv"] = stream["counts"][name]
        by_path[V3] = v3_counts[name]
        by_path[f"{V3} absorb"] = serve_v3["absorb"]["counts"][name]
        by_path.update({a: c[name] for a, c in dist_counts.items()})
        by_path.update({a: c[name] for a, c in mesh_counts.items()})
        by_path.update({a: c[name] for a, c in train_mesh_counts.items()})
        by_path["library"] = lib_counts[name]
        by_path.update({a: c[name] for a, c in autotune_counts.items()})
        if name in ("entangled_conv1d", "conv1d_causal"):
            # the stream shape's row; route=None takes s8 there
            head = rows[name][0]
            core = head["by_route"]["cuda_core"]
            extra = dict(
                launches=stream["counts"][name],
                launches_by_route={
                    "s8": stream["counts_by_route"][name]["s8"],
                    "cuda_core": stream["counts_by_route"][name][
                        "cuda_core"]},
                max_abs_err_by_route=dict(chk.worst_by_route),
                cuda_core=dict(source=k["source"], ms=core["ms"],
                               bound_ms=head["bound_ms"],
                               bound_by=head["bound_by"]),
                timings=rows[name])
        elif name == "checksum":
            head = rows[name][0]
            extra = dict(launches=stream["counts"][name],
                         timings=rows[name])
        elif name in ("entangle", "disentangle"):
            head = rows[name]
            extra = dict(launches=train_counts[name],
                         launches_per_train_step=dict(
                             {LLAMA: train["launches_per_step"][name],
                              f"{LLAMA} train-mesh (each rank)": [
                                  st["launches"][name] for st in
                                  train_mesh["ranks"][0]["steps"]]},
                             **{a: train_families[a]["launches_per_step"][
                                 name] for a in TRAIN_FAMILIES}),
                         timings=[head])
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
                launches_per_decode_step=dict({
                    a: {s: r["launches_per_decode_step"][name]
                        for s, r in p["results"].items()}
                    for a, p in paths.items()}, **{
                    f"{a} dense-decoders": {
                        w: per[name] for w, per in
                        r["launches_per_decode_step"].items()}
                    for a, r in decoders.items()}, **{
                    f"{a} recurrent": r["s8_launches_per_decode_step"]
                    for a, r in recurrent.items()
                    if name == "entangled_matmul"},
                    **{V3: {s: r["launches_per_decode_step"][name]
                            for s, r in serve_v3["scopes"].items()}},
                    **{f"{V3} absorb": {
                        s: r["launches_per_decode_step"][name]
                        for s, r in serve_v3["absorb"]["scopes"].items()}},
                    **(family_steps if name == "entangled_matmul" else {})),
                cuda_core=dict(
                    source=k["core_source"],
                    launches=paths[DEEPSEEK]["core_counts"][name],
                    max_abs_err=chk.worst_by_route.get("cuda_core", 0),
                    comparisons=chk.n_by_route.get("cuda_core", 0),
                    ms=core["ms"], bound_ms=core["bound_ms"],
                    bound_by=core["bound_by"]),
                timings=rows[name])
        if "core_source" in k:  # a GEMM: its s8 route's comparisons
            err = chk.worst_by_route.get("s8", 0)
            n_cmp = chk.n_by_route.get("s8", 0)
        else:  # every route's
            err, n_cmp = chk.worst, chk.n
        record["kernels"].append(dict(
            name=name, route=k["route"], source=k["source"],
            replaces=k["replaces"], launches=extra.pop("launches"),
            launches_by_path=by_path,
            max_abs_err=err, comparisons=n_cmp, ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head.get("library_ms"),
            shape=head["shape"], **extra))
    record["serve_admission"] = {a: p["admission"] for a, p in paths.items()}
    record["fleet"] = fleet
    record["dense_decoders"] = decoders
    record["recurrent"] = recurrent
    record["families"] = families
    record["train"] = train
    record["train_families"] = train_families
    record["stream_conv"] = stream
    record["serve_v3"] = serve_v3
    record["dist"] = dist_rec
    record["serve_mesh"] = serve_mesh
    record["train_mesh"] = train_mesh
    record["library"] = library
    record["autotune"] = autotune
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
