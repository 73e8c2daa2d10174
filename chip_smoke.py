#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card: build the CUDA
kernels, hold each against its plain PyTorch version at the shapes of the
serving path (the attention kernels also at the heads of every config the
card serves, the W8A8 GEMM at every (K, N) of each served model; the W8A8
GEMM also in its serving form, which quantizes x in
its own launch, bit for bit against the row quantizer then the GEMM; the
paged attention kernels also bit for bit against their contiguous twins on
the gathered window, up to 40,960 positions; decode attention also across
its split-KV segments, windowed == full) and of the train
route (the causal flash kernel, its backward too), then serve the
full-width qwen3-0.6b (random weights from a seed, INT8 PTQ) through the
continuous-batching engine, with a contiguous KV pool and with a paged KV
arena and its prefix cache, and check every request against serial decode;
then run the HQP compression path at full width (Fisher pass, conditional
pruning, compaction, PTQ) through the causal flash kernel, hold the masked
model against the compacted one, and serve the pruned artifact, contiguous
and paged, against serial decode; then train the full-width model on the
quickstart's Markov corpus (AdamW, a checkpoint restored and replayed bit
for bit), let Algorithm 1 decide on it until it rejects a step, save the
INT8 artifact, load it back and serve it, contiguous and paged; then
sample and serve self-speculatively (the seed-0 INT8 artifact drafts, its
bf16 parent verifies on B4/B6, contiguous and paged, with copy-on-write;
the trained pair too), each against serial decode of the verifier whose
one-token steps take the prefill route, bit for bit, with B3 held against
B4 at one query; then the service plane: the HTTP/SSE front door in
process (streams equal to serial decode, an injected fault failing only
its dispatch's requests, a deadline expiring mid-prefill, a disconnect,
429 infeasible and saturated, /metrics, a drain, all CUDA work on the
pump thread), a speculative dispatch fault with a slot mid-prefill, and
the launcher's ``serve --engine --http`` on the trained artifact in a
subprocess, drained by SIGTERM; then profile a steady decode dispatch
and a prefill chunk (where their time goes on the card); last, the
paper's own experiment: HQP on ResNet-18 and MobileNetV3-Small at full
width (train, Fisher, the Q8 / P50 / HQP table with latencies measured by
CUDA-graph replay and modeled on the H100), the card's forward held
against the CPU's and the masked model against the compacted one; then
the MoE family at full width with its depth cut: phi3.5-moe compressed by
the launcher (Fisher on the flash kernel, Algorithm 1 with the expert
family, per-expert INT8 PTQ), masked == compacted also with an expert cut
from every layer, the artifact saved and loaded, served contiguous and
paged (every expert's W8A8 launch counted a step) and speculatively, each
against serial decode, its decode step profiled; arctic (128 experts and
a dense residual MLP) PTQ'd and served; granite-3-8b, stablelm-1.6b and
command-r-35b at full width, PTQ'd and served against serial decode; last,
the hybrid family: jamba's smoke model on the card against the CPU, then
jamba at full width with its first 5 layers (INT8, drawn a layer at a
time) served contiguous and paged (every W8A8 launch counted a step), the
shared-head load with no prefix cache kept (a recurrent pattern), sampled,
and profiled, and one layer compressed (Fisher, Algorithm 1 with the
Mamba channel family; masked == compacted, also with a quarter of the
Mamba channels cut by hand), that cut model's artifact saved, loaded and
served, each against serial decode; last, the xLSTM family: its smoke
model on the card against the CPU, then xlstm-1.3b at its published
width and depth (INT8, drawn a layer at a time) served contiguous and
paged (an empty KV arena: no layer attends), sampled and profiled, and
compressed at full depth (Fisher, Algorithm 1 with the mLSTM head family;
masked == compacted, also with one head cut from every mLSTM layer), that
cut model's artifact saved, loaded and served, each against serial
decode; then the MoE, hybrid and xLSTM families trained at full width;
last, the frontend configs at their published depth and width:
phi-3-vision-4.2b (576 patch embeddings, hd 96) compressed by the
launcher and musicgen-medium (256 frame embeddings) trained 10 steps, each
served in lockstep from seeded random embeddings (each request alone ==
its row, chunked prefill == whole), with B1 timed at the frontend
linear's products beside ``torch._int_mm``; the kernel phases hold B3-B7's
hd-96 instances too.

Before the serving phases, both static-analysis planes run on the card
(``phase_static``): the dispatch plane's declared hot paths of smoke-size
engines traced eagerly and under CUDA-graph capture, each captured graph's
memcpy and memset nodes held under a KV leaf's bytes, the retrace
workloads, and the AST lint of the serving modules and CI scripts; any
violation fails the run.

The engine runs each decode dispatch and prefill chunk as a CUDA graph,
captured at a key's second use and replayed after; each main serve load
runs SERVE_RUNS times on one engine (a variant of one VARIANT_RUNS), and
its ``[serve]`` lines show the cold (first) and the warm (last) run;
``[graphs]`` sums the captures, replays and eager dispatches of each
layout; the ``[profile]`` phases profile replayed dispatches and show the
eager first use beside them.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero on any failure, and when
there is no card or no ``src/repro_torch`` beside this file. The last line
of standard output is ``{"ok": true, "device": {...}}``; the line before it
is the ``kernels`` JSON (times, bounds, launches on the serving run). A
kernel's ``ms`` is its device time per launch, free of host overhead: CUDA
events around replays of a CUDA graph that captured a run of its wrapper's
launches (``device_ms``); ``plain_ms`` and ``library_ms`` are timed the
same way, and ``wrapper_ms`` is the host-issued rate of the wrapper.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import gc
import itertools
import json
import math
import os
import pathlib
import signal
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
CHIP = None     # repro_torch.roofline.hardware.H100_SXM, set by main()
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_CHUNK, SERVE_STEPS = 4, 256, 16, 4
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 6, 48, 32
SERVE_PAGE = 16             # page size of the paged serve phase
SERVE_RUNS = 3              # runs of each serve load on one engine: the
                            # first cold (captures), the last warm (replays)
# runs of a load that varies a layout's main one (bf16 KV, a shared head,
# long prompts; the speculative and the families' paged loads, the trained
# pair): one, which already captures and replays every key it meets twice
VARIANT_RUNS = 1
SHARED_HEAD, SHARED_N = 64, 4   # shared-prompt load: head tokens, requests
# long-prompt load: one prompt that decodes across the first split-KV
# segment boundary (256), one past it, at a larger max_seq
LONG_PROMPTS, LONG_NEW, LONG_MAX_SEQ = (250, 300), 16, 512
PAGE_SIZES = (16, 32, 48, 256)  # paged kernel checks
PROFILE_TICKS = 5           # decode dispatches timed in the profile phase
PROFILE_TOP = 8             # kernels by device ms printed of a profile
PREFILL_PROFILE_PROMPT = 4 * SERVE_CHUNK   # prompt of the prefill profile
GRAPH_CALLS, GRAPH_REPLAYS = 20, 10   # device timing: calls a graph, replays

# Attention tolerance, |kernel - plain| <= ATOL + RTOL * |plain|: the plain
# version rounds p to bf16 before PV (relative error <= 2^-9 per term), the
# kernel keeps p in f32; both round the output to bf16 (2^-9 relative); the
# f32 sums run in another order. With unit-normal q, k, v (|v| <~ 5) that
# stays under 2e-2.
ATTN_ATOL, ATTN_RTOL = 3e-2, 3e-2
# Card vs CPU plain path on the smoke model, f32 logits of magnitude <~ 1:
# attention differs as above, which can move an int8 activation code by one.
E2E_ATOL = 5e-2
# The same on the train route (bf16 hidden states of magnitude <~ 4 after
# two layers; cuBLAS and the CPU round each bf16 product at their own
# places, one ulp a layer) and its mean cross-entropy.
TRAIN_HIDDEN_ATOL, TRAIN_LOSS_RTOL = 6.25e-2, 1e-3
# Flash kernel: the log-sum-exp is f32 on both sides, summed in another
# order (|lse| <~ 10); each gradient (bf16, from bf16 p in the kernel's PV
# against f32 p in the plain version) within 2 % of its largest magnitude.
LSE_ATOL, GRAD_FRAC = 1e-4, 2e-2
# Flash and prefill output row by row, ||kernel - plain|| / ||plain|| over
# each (batch, query, head) row: both round the output to bf16 (2^-9
# relative each); for PV the plain versions round the normalized p to
# bf16, B7 the unnormalized p, B4/B6 keep p to ~16 bits (two bf16 terms),
# which averages out over the row. At long S or W a row is the mean of
# many v rows (|o| ~ 0.05), where ATTN_ATOL alone would pass a PV-side
# fault of several percent; this holds every row to 1 %.
ATTN_ROW_REL = 1e-2
# Masked vs compacted model, each layer's attention and FFN output fed the
# same input: cuBLAS sums the products that lose pruned terms (wo, down)
# over fewer terms in another order, and both round to bf16 (2^-9 relative
# each). A compaction fault that misaligns a layer's units changes that
# output wholesale. (The final hidden states compound 28 layers' roundings
# on random weights: 2.6 % apart on a sound per-layer cut of qwen3-0.6b on
# an H100, against 36 % with the planted fault.)
SUBLAYER_REL = 2e-2
# The launcher's calibration batch and HQP run at full width.
CALIB_B, CALIB_S, PRUNE_STEPS = 2, 32, 3
# the heads (Hq, Hkv, hd) of the other configs the card serves:
# phi3.5-moe and granite (G 4), arctic (G 7), command-r (G 8), all at hd
# 128, and stablelm (G 1, hd 64)
ARCH_HEADS = ((32, 8, 128), (56, 8, 128), (64, 8, 128), (32, 32, 64))
# B4/B6 at other head groupings and widths than the model's (Hq, Hkv, hd):
# G = 1, 3 and 4, hd 16 (the smoke config) and 128 (the published
# Qwen3-0.6B), and ARCH_HEADS
PREFILL_HEADS = ((8, 8, 64), (12, 4, 64), (16, 4, 64), (16, 8, 16),
                 (16, 8, 128)) + ARCH_HEADS
# B4/B6 timed at the serve chunk (16 queries at 37 against a 64-position
# window), a late chunk of a long prompt (16 at 240 against 256) and a
# whole 256-token prompt (serial_decode's prefill): (Sq, start, W)
PREFILL_TIMED = ((SERVE_CHUNK, 37, 64), (SERVE_CHUNK, 240, 256),
                 (256, 0, 256))
# B7 at the train route's shapes: the quickstart's batch (64 x 33) and the
# train launcher's default (--seq 64: S 65), checked and timed; and at
# phi3.5-moe's heads on the calibration batch (its Fisher pass and evals)
TRAIN_FLASH_SHAPES = ((64, 33, 16, 8, 64), (8, 65, 16, 8, 64))
FLASH_SHAPES = ((CALIB_B, CALIB_S, 16, 8, 64), (1, 2048, 16, 8, 64),
                (1, 1000, 16, 8, 64), (2, 256, 8, 8, 64),
                (2, 256, 16, 8, 128), (CALIB_B, CALIB_S, 32, 8, 128)
                ) + TRAIN_FLASH_SHAPES     # (B, S, Hq, Hkv, hd)
# The train phase: the quickstart's corpus, batch and lr at full width, for
# TRAIN_STEPS; a checkpoint RESUME_BACK steps before the end is restored
# and replayed to the end, which must equal the uninterrupted run bit for
# bit; the trained model must reach TRAIN_ACC_MIN next-token accuracy (the
# chain's ceiling is 0.9) before Algorithm 1 decides on it
TRAIN_STEPS, TRAIN_LR, RESUME_BACK, TRAIN_ACC_MIN = 60, 3e-3, 10, 0.5
# B3/B5 checked at these windows, and at other head groupings and widths
# than the model's: those of B4/B6 (B5: ARCH_HEADS), and G = 16 (the
# kernel's most, one m16 tile)
DECODE_WINDOWS = (16, 64, 256, 1024, 4096)
DECODE_HEADS = ((16, 8, 64),) + PREFILL_HEADS + ((16, 1, 64),)
# B3/B5 timed beyond the serve shape, every slot at W - 1: (W, bytes of KV
# the calls rotate through; 0: one set, already past the 50 MB L2)
DECODE_TIMED = ((4096, 100_000_000), (32768, 0))
B5_LONG = 40960      # qwen3-0.6b's max_seq_len: 2,560 pages of 16 a slot
# B6 past the 2,048 table entries it once held in shared memory: SERVE_CHUNK
# queries at these starts of a B5_LONG-position paged window (windows past
# 32,768 positions), checked, and the first one timed
B6_LONG_STARTS = (B5_LONG - SERVE_CHUNK, 33000)
PRUNED_REQUESTS, PRUNED_NEW = 4, 16        # serve load of the pruned artifact
# the service phase: queue depth beyond the slots, the decode dispatch the
# injected fault hits, a prompt whose deadline expires mid-prefill, the
# tokens of each request of the saturating load, and the seconds the
# launcher's subprocess may take to listen and to drain
SERVICE_QUEUE, SERVICE_FAULT_AT = 4, 3
SERVICE_LONG, SERVICE_DEADLINE_S = 240, 0.05
SERVICE_SAT_NEW, SERVICE_SUBPROCESS_S = 96, 300
HANG_S = 1140               # the script's own limit, inside the 1200 s a run has
# the cost model (roofline/cost.py): no step can beat its own lower bound, so
# a measured time under the bound by more than this share means the count is
# wrong; the dry-run phase's archs (one per family), run in a subprocess on
# the meta device beside the card's phases
ROOFLINE_SHARE_MAX = 1.05
DRYRUN_ARCHS = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
                "xlstm-1.3b")
DRYRUN_VARIANTS = ("baseline", "hqp")
# the paper's experiment (phase_cnn): the JAX package's CLI sizes (steps,
# train / val / calib images, Δ_ax) at the published widths; a short
# training run and a batch for the card == CPU and masked == compacted
# checks, whose logits (and new BN statistics) must agree within CNN_REL of
# their largest magnitude: f32 on both sides (TF32 off), cuDNN's conv
# algorithms summing in other orders than the CPU's over ~20 layers, ~1e-6
# apart on an H100 (a misplaced channel or pad moves them wholesale); the
# baseline must reach CNN_ACC_MIN
CNN_STEPS, CNN_TRAIN, CNN_VAL, CNN_CALIB, CNN_DELTA = 400, 6000, 2000, 1000, 0.015
CNN_WIDTH = 1.0
CNN_PARITY_STEPS, CNN_PARITY_BATCH, CNN_REL, CNN_ACC_MIN = 20, 16, 1e-4, 0.5
CNN_PROFILE_TOP = 6
# speculative serving (phase_spec): the staggered load's first
# SPEC_REQUESTS requests (one more than the slots, so a slot is reused);
# drafts a cycle, cycles a dispatch; the sampled loads' temperature, top-k
# and seed; the copy-on-write load's prompt length (whole pages of
# SERVE_PAGE); B4/B6 at the verify shape, q (SERVE_SLOTS, SPEC_K + 1, 16,
# 64) at these per-slot starts; B3 against B4 at Sq = 1 at these starts
# (one 64-position tile, two, and two split-KV segments)
SPEC_REQUESTS, SPEC_K, SPEC_CYCLES = SERVE_SLOTS + 1, 4, 1
# of those, the requests held to the decode-route serial decode too (C6's
# report), and the requests of the sampled plain-engine loads
SPEC_ROUTE_REQUESTS, SPEC_SAMPLED_REQUESTS = 2, 3
SPEC_SAMPLING = dict(temperature=0.8, top_k=50, seed=7)
COW_PROMPT = 64
SPEC_VERIFY_STARTS = (37, 60, 100, 201)
B3_B4_STARTS = (63, 100, 300)
# where the decode-route serial decode (B3 steps) first leaves the
# prefill-route one (B4 steps), the verifier's top two logits must lie
# within twice the card's logit tolerance: a near tie the two kernels'
# roundings break apart, not a fault
SPEC_TIE_GAP = 2 * E2E_ATOL
# the kernels of each serving layout; the W8A8 linears quantize x in the
# GEMM's launch, so B2 and the int8-x form of B1 stay for parity checks and
# must not launch while serving
DENSE, UNFUSED = ("int8_matmul_quant",), ("quantize_rowwise", "int8_matmul")
CONTIGUOUS = ("decode_attention", "prefill_attention")
PAGED = ("paged_decode_attention", "paged_prefill_attention")
# The MoE phase: phi3.5-moe compressed and served at full width with its
# depth cut to MOE_LAYERS (2.86 B params; all 32 layers, 42 B, do not fit
# one card), then arctic at full width and ARCTIC_LAYERS (one layer is 27.2
# GB in bf16: PTQ only, no Fisher pass); MOE_NEW tokens a request of the
# staggered load. The dense archs' phase: each at full width with its
# depth cut to DENSE_LAYERS and its full vocabulary, INT8 PTQ, ARCH_REQUESTS
# staggered requests of ARCH_NEW tokens. Each load runs ARCH_RUNS times on
# one engine: the first cold (eager first uses), the second captures what
# the first saw once, the last replays only (warm).
MOE_ARCH, ARCTIC_ARCH = "phi3.5-moe-42b-a6.6b", "arctic-480b"
MOE_LAYERS, ARCTIC_LAYERS, DENSE_LAYERS = 2, 1, 2
DENSE_ARCHS = ("granite-3-8b", "stablelm-1.6b", "command-r-35b")
MOE_NEW, ARCH_REQUESTS, ARCH_NEW, ARCH_RUNS = 16, 4, 8, 3
# The hybrid phase: jamba at full width, its depth cut to the published
# stack's first HYBRID_LAYERS layers (Mamba at 0-3, attention at 4, MoE on
# 1 and 3: 24.05 B params, ~48 GB in bf16, so INT8 PTQ only, a layer at a
# time), HYBRID_REQUESTS staggered requests of HYBRID_NEW tokens, the
# contiguous load HYBRID_RUNS times on one engine (paged VARIANT_RUNS);
# and compressed (Fisher, Algorithm 1) at HYBRID_HQP_LAYERS deep (a Mamba
# layer and a dense MLP, 2.10 B params: the deepest cut whose Fisher pass
# fits one card, two layers reach 12.2 B).
# HYBRID_B1 is B1's launches a decode step at 5 layers: 4 Mamba layers x 2,
# 3 dense MLPs x 3, 2 MoE layers x 16 experts x 3, attention's 4.
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LAYERS, HYBRID_HQP_LAYERS, HYBRID_B1 = 5, 1, 117
HYBRID_REQUESTS, HYBRID_NEW, HYBRID_RUNS = 4, 16, 3
# The xLSTM phase: xlstm-1.3b at its published width and depth (48 layers,
# 42 mLSTM and 6 sLSTM, 2.02 B params: INT8 PTQ a layer at a time), served
# on XLSTM_REQUESTS staggered requests of XLSTM_NEW tokens, the contiguous
# load XLSTM_RUNS times on one engine (paged VARIANT_RUNS), and
# compressed at full depth (Fisher, Algorithm 1 with the mlstm_heads
# family; the sLSTM layers are not pruned). Its prompts are about
# XLSTM_PROMPT tokens long (11-21: one or two prefill chunks), the
# profile's too: the mLSTM steps a prompt position by position, ~40
# kernels a position and layer. The one-run loads (sampled, the cut
# artifact) take the first XLSTM_ONE_RUN requests. XLSTM_B1 is B1's
# launches a decode step: 42 mLSTM x 2 (in_proj, out_proj) + 6 sLSTM
# x 2 (up, down). XLSTM_STATE_REL bounds the smoke model's mLSTM state C,
# card against CPU, over its largest magnitude.
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_B1, XLSTM_REQUESTS, XLSTM_NEW, XLSTM_RUNS = 96, 4, 8, 3
XLSTM_PROMPT, XLSTM_ONE_RUN = SERVE_CHUNK, 1
XLSTM_STATE_REL = 3e-2
# The family training phase: each family at its published width, trained
# FAMILY_STEPS AdamW steps with the capacity factor's drops (the train
# launcher's moe_no_drop=False) on FAMILY_BATCH rows of FAMILY_SEQ tokens
# of the quickstart's DATA_VOCAB corpus; the last FAMILY_RESUME steps
# replayed from a copy in host memory. (arch, layers on the card or None
# for the published depth, moment dtype, B7 launches a step, lr):
# phi3.5-moe at 2 of 32 layers (2.87 B params) with INT8 moments, the
# reference launcher's choice for a large model; jamba's first layer (a
# Mamba layer and a dense MLP, 2.10 B params; a second layer is a 9.66 B
# param MoE layer); xlstm-1.3b at all 48 layers (2.02 B params). The lr is
# the train launcher's 3e-3 for xlstm-1.3b: at AdamWConfig's 3e-4 its 10
# steps stay in the phase where its gradient, grown through the 48 blocks
# and clipped to a norm of 1, lies under AdamW's eps in the output table
# (tests/test_torch_train_depth.py: the reference's too). It is 3e-4 for
# the other two: at 3e-3 phi3.5-moe's loss climbs from its second step,
# with INT8 moments and with f32 alike, and jamba's spikes to 2.3 x its
# start (ROADMAP's known gaps; scripts/train_families_probe.py measures
# it). Each family must lower its CE on the first batch, taken without
# drops before the first step and after the last, by FAMILY_FALL of it.
FAMILY_TRAIN = ((MOE_ARCH, MOE_LAYERS, "int8", MOE_LAYERS, 3e-4),
                (HYBRID_ARCH, HYBRID_HQP_LAYERS, "f32", 0, 3e-4),
                (XLSTM_ARCH, None, "f32", 0, 3e-3))
FAMILY_STEPS, FAMILY_RESUME, FAMILY_BATCH, FAMILY_SEQ = 10, 1, 8, 64
FAMILY_FALL = 5e-2
# B7 at phi3.5-moe's train shape (the batch above, 32 heads of 128, 8 kv)
PHI_TRAIN_FLASH = (FAMILY_BATCH, FAMILY_SEQ, 32, 8, 128)
# Smoke width, card against CPU: the loss (with the auxiliary losses)
# within TRAIN_LOSS_RTOL, each auxiliary loss within FAMILY_AUX_RTOL, the
# gradient values pooled over every leaf: a value is off when it lies more
# than GRAD_FRAC of its leaf's largest from the CPU's, and at most
# FAMILY_MOE_OFF of them may be off with experts (routing is discrete: a
# token a hair from the next expert takes another one on the other
# device's ulps), FAMILY_XLSTM_OFF without; and each leaf on its own within
# FAMILY_LEAF_REL of its norm (L2), the norm at least FAMILY_LEAF_FLOOR of
# the largest leaf's (the CPU tests' bounds against the reference,
# tests/_torch_train_common.py)
FAMILY_AUX_RTOL, FAMILY_MOE_OFF, FAMILY_XLSTM_OFF = 2e-2, 5e-2, 2e-3
FAMILY_LEAF_REL, FAMILY_LEAF_FLOOR = 5e-2, 1e-4
# The frontend phase: phi-3-vision-4.2b and musicgen-medium at their
# published depth and width, each prepending its frontend's embeddings
# (576 patches, 256 frames) to the tokens. phi-3-vision: seeded bf16
# init, then the launcher's build_artifact with FRONT_PRUNE_STEPS
# conditional step (its Fisher pass and evals on B7 at hd 96); musicgen:
# FAMILY_STEPS AdamW steps (f32 moments, lr FRONT_LR) on FAMILY_BATCH rows
# of its frames and FAMILY_SEQ tokens, then INT8 PTQ. Each INT8 model
# serves FRONT_REQUESTS requests in one lockstep batch (INT8 KV, seeded
# random embeddings, FRONT_PROMPT-token prompts, FRONT_NEW new tokens, the
# arch's FRONT_MAX_SEQ), held row for row against batch-1 runs, and its
# prefill of the embeddings and the first FRONT_CHUNK tokens, then the
# rest, against the whole prefill; the launcher's ``serve.main`` runs the
# arch (bf16, one request of FRONT_MAIN_PROMPT tokens, FRONT_MAIN_NEW new).
FRONT_ARCHS = ("phi-3-vision-4.2b", "musicgen-medium")
FRONT_PRUNE_STEPS, FRONT_LR = 1, 3e-4
FRONT_REQUESTS, FRONT_PROMPT, FRONT_NEW, FRONT_CHUNK = 4, 32, 16, 16
FRONT_MAX_SEQ = {FRONT_ARCHS[0]: 640, FRONT_ARCHS[1]: 512}
FRONT_MAIN_PROMPT, FRONT_MAIN_NEW = 8, 4
# B3-B7's hd-96 instances at phi-3-vision's heads (Hq, Hkv, hd), G 1: B3
# and B5 against an HD96_W window, B4 and B6 at HD96_PREFILL (queries,
# start) against it, B7 at the Fisher pass's shape (the calibration batch's
# 2 rows of 576 patches and 32 tokens)
PHI_HEADS = (32, 32, 96)
HD96_W = 640
HD96_PREFILL = ((576 + CALIB_S, 0), (SERVE_CHUNK, 600))
HD96_FLASH = (CALIB_B, 576 + CALIB_S) + PHI_HEADS
# B1 at the frontend linear's products (M, K, N): phi-3-vision's
# FRONT_REQUESTS requests of 576 patches, its calibration batch's 2 rows,
# musicgen's FRONT_REQUESTS requests of 256 frames
FRONT_GEMMS = ((FRONT_REQUESTS * 576, 3072, 3072), (CALIB_B * 576, 3072, 3072),
               (FRONT_REQUESTS * 256, 1536, 1536))
# B1's checked shapes: M, then (K, N): the model's four (wk/wv, wq/wo,
# gate/up, down), then a per-layer cut's ragged d_ff 3,035 and 7 kv heads
GEMM_M = (1, 4, 13, 16, 17, 64)
GEMM_KN = ((1024, 512), (1024, 1024), (1024, 3072), (3072, 1024),
           (3035, 1024), (1024, 3035), (1024, 448))


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", file=sys.stderr)
    sys.exit(1)


def device_ms(fn, calls: int = GRAPH_CALLS) -> float:
    """Device time per call, free of host overhead: CUDA events around
    GRAPH_REPLAYS replays of a CUDA graph that captured ``calls`` calls of
    ``fn`` (each a wrapper's launch on the current stream, or a plain
    version's or a library call's kernels). ``fn`` runs three times on a side
    stream first (kernel builds, workspaces, shared-memory attributes,
    allocator pools), as capture requires."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (GRAPH_REPLAYS * calls)


def timed(kernel, plain, library=None, calls: int = GRAPH_CALLS) -> dict:
    """A kernel's device time (``ms``), its wrapper's time on the host's
    launch rate (``wrapper_ms``), and the device times of its plain version
    and of the library call, all from ``device_ms`` but the wrapper's."""
    return dict(ms=device_ms(kernel, calls), wrapper_ms=time_ms(kernel),
                plain_ms=device_ms(plain, calls),
                library_ms=None if library is None
                else device_ms(library, calls))


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """CUDA events around ``iters`` back-to-back calls from the host: for a
    wrapper, the rate at which the host issues it (checks, allocation,
    ctypes), which hides a kernel of a few microseconds."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / CHIP.hbm_bw * 1e3
    t_ops = n_ops / (CHIP.peak_int8 if kind == "int8" else CHIP.peak_bf16) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def phase_quantize(dev, report):
    import torch
    from repro_torch.kernels import quantize as kq, ref
    err = 0.0
    for m in (4, 7, 16):
        for k in (1024, 3072):
            x = torch.randn(m, k, device=dev).to(torch.bfloat16) * 3
            x[m // 2] = 0                               # an all-zero row
            q, s = kq.quantize_rowwise(x)
            qr, sr = ref.quantize_ref(x)
            torch.cuda.synchronize()
            if not (torch.equal(q, qr) and torch.equal(s, sr)):
                fail(f"quantize_rowwise ({m}, {k}) differs from plain")
            err = max(err, (q.float() - qr.float()).abs().max().item(),
                      (s - sr).abs().max().item())
    m, k = SERVE_SLOTS, 1024
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    b, by = bound(m * k * 3 + m * 4, 0, "bf16")
    report["quantize_rowwise"] = dict(
        max_abs_err=err, bound_ms=b, bound_by=by,
        **timed(lambda: kq.quantize_rowwise(x), lambda: ref.quantize_ref(x)),
        shape=f"x ({m}, {k}) bf16")


def _gemm_bound(m, k, n, x_bytes=1):
    """x (int8 with its f32 scales, or bf16), w_q, w_scale and out moved
    once; 2·M·N·K int8 operations."""
    x = m * k + m * 4 if x_bytes == 1 else m * k * 2
    return bound(x + k * n + n * 4 + m * n * 2, 2 * m * n * k, "int8")


def _b2_then_b1(x, w_q, w_scale, plain=False):
    """B2 then B1 (or their plain versions): x's codes and scales, then the
    product."""
    from repro_torch.kernels import int8_matmul as km, quantize as kq, ref
    x_q, x_scale = (ref.quantize_ref if plain else kq.quantize_rowwise)(x)
    return (ref.int8_matmul_ref if plain else km.int8_matmul)(
        x_q, w_q, x_scale, w_scale)


def _b1_case(dev, m, k, n):
    """B1 at (m, k) x (k, n) on random codes, bit for bit against its plain
    version; then its serving form on a bf16 x with an all-zero row: its
    codes and scales equal to the plain quantizer's, its output to B2 then
    B1 and to the plain versions. Returns (B1's max |err|, the serving
    form's, B1's plan, the serving form's plan)."""
    import torch
    from repro_torch.kernels import int8_matmul as km, ref
    gen = lambda *shape: torch.randint(-127, 128, shape, device=dev,
                                       dtype=torch.int8)
    xq, wq = gen(m, k), gen(k, n)
    xs = torch.rand(m, device=dev) * 0.05 + 1e-3
    ws = torch.rand(n, device=dev) * 0.05 + 1e-3
    plan = km.gemm_plan(m, n, k, wq.data_ptr(), xq.data_ptr())
    out = km.int8_matmul(xq, wq, xs, ws)
    want = ref.int8_matmul_ref(xq, wq, xs, ws)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        fail(f"int8_matmul M={m} K={k} N={n} ({plan}) differs from plain")
    err = (out.float() - want.float()).abs().max().item()
    x = (torch.randn(m, k, device=dev) * 3).to(torch.bfloat16)
    x[m // 2] = 0
    plan_q = km.gemm_plan(m, n, k, wq.data_ptr(), x.data_ptr(), x_bytes=2)
    out_q = torch.empty(m, k, dtype=torch.int8, device=dev)
    out_s = torch.empty(m, dtype=torch.float32, device=dev)
    out = km.int8_matmul_quant(x, wq, ws, out_q, out_s)
    want_q, want_s = ref.quantize_ref(x)
    want = _b2_then_b1(x, wq, ws, plain=True)
    what = f"int8_matmul_quant M={m} K={k} N={n} ({plan_q})"
    _equal(out_q, want_q, what + " codes vs plain quantize")
    _equal(out_s, want_s, what + " scales vs plain quantize")
    _equal(out, _b2_then_b1(x, wq, ws), what + " vs B2 then B1")
    _equal(out, want, what + " vs plain")
    return (err, (out.float() - want.float()).abs().max().item(), plan,
            plan_q)


def phase_int8_matmul(dev, report):
    """B1 bit for bit against its plain version at every M the serving path
    and the tiling meet (1 and 4 slots, 13, one 16-row tile, past it, four
    tiles) on the model's four (K, N), the ragged ones of a per-layer cut
    (d_ff 3,035, 7 kv heads) and two N that take the 8- and 4-byte copies:
    every copy width and a range of split-K factors. Its serving form,
    which quantizes a bf16 x in the same launch, at the same shapes: its
    output equal to B2 then B1 (kernels and plain versions), its codes and
    scales equal to the plain quantizer's, with 16-byte and element loads
    of x. The split-K workspace must be zero again after them. Then the
    device time of each decode and prefill-chunk shape, weights rotated
    through > 50 MB so that, as in a decode step, each launch reads its
    weight from device memory: B1, the fused form, and B2 + B1."""
    import torch
    from repro_torch.kernels import int8_matmul as km, ref
    gen = lambda *shape: torch.randint(-127, 128, shape, device=dev,
                                       dtype=torch.int8)
    b2_b1 = _b2_then_b1
    plain = lambda *a: _b2_then_b1(*a, plain=True)
    err = err_q = 0.0
    seen, seen_q = set(), set()
    shapes = [(m, k, n) for m in GEMM_M for k, n in GEMM_KN]
    shapes += [(m, 1024, n) for m in (4, 16) for n in (1000, 1012)]
    for m, k, n in shapes:
        e, e_q, plan, plan_q = _b1_case(dev, m, k, n)
        err, err_q = max(err, e), max(err_q, e_q)
        seen.add((plan.vec, plan.x_vec, plan.split))
        seen_q.add((plan_q.vec, plan_q.x_vec, plan_q.split))
    # exact ties: rows whose scale is 1 (absmax 127) or 1/2 (63.5), so that
    # x / scale lands on half-integers, which round to even; a few in one
    # row (the kernel's list of chunks near a tie) and in every chunk of
    # 16 rows (more than the list holds)
    for m, n_ties in ((SERVE_SLOTS, 3), (SERVE_CHUNK, None)):
        k, n = 1024, 512
        x = torch.randint(-126, 126, (m, k), device=dev).float()
        x[:, 0] = 127
        x[1] = x[1] / 2
        x[1, 0] = 63.5
        if n_ties is None:
            x[:, 1:] += 0.5
            x[1, 1:] -= 0.25
        else:
            x[0, 1:1 + n_ties] += 0.5
        x = x.to(torch.bfloat16)
        wq, ws = gen(k, n), torch.rand(n, device=dev) * 0.05 + 1e-3
        out_q = torch.empty(m, k, dtype=torch.int8, device=dev)
        out_s = torch.empty(m, dtype=torch.float32, device=dev)
        out = km.int8_matmul_quant(x, wq, ws, out_q, out_s)
        what = f"int8_matmul_quant M={m} with exact ties"
        want_q, want_s = ref.quantize_ref(x)
        _equal(out_q, want_q, what + " codes vs plain quantize")
        _equal(out_s, want_s, what + " scales vs plain quantize")
        _equal(out, plain(x, wq, ws), what + " vs plain")
        _equal(out, b2_b1(x, wq, ws), what + " vs B2 then B1")
    widths = {v for v, _, _ in seen}
    if widths != {16, 8, 4, 1} or {xv for _, xv, _ in seen} != {4, 1}:
        fail(f"int8_matmul: copy widths checked {sorted(widths)}")
    if ({v for v, _, _ in seen_q} != widths
            or {xv for _, xv, _ in seen_q} != {16, 2}):
        fail(f"int8_matmul_quant: copy / x widths checked {sorted(seen_q)}")
    _, ws_left = _scratch(dev)
    if ws_left:
        fail(f"int8_matmul: split-K workspace not reset ({ws_left})")
    splits = sorted({sp for _, _, sp in seen})
    print(f"[kernel] int8_matmul bit-identical at {len(shapes)} shapes: copy "
          f"widths {sorted(widths)}, split-K factors {splits}")
    print(f"[kernel] int8_matmul_quant at the same {len(shapes)} shapes and "
          f"on exact ties: output equal to B2 then B1 and to the plain "
          f"versions, codes and scales equal to the plain quantizer's; x "
          f"loads of "
          f"{sorted({xv for _, xv, _ in seen_q})} bytes, split-K factors "
          f"{sorted({sp for _, _, sp in seen_q})}")

    def rotating(m, k, n):
        """B1, its plain version, the fused form, its plain version and
        B2 + B1, each call on the next of as many weights as pass 60 MB."""
        xq = gen(m, k)
        xs = torch.rand(m, device=dev) * 0.05
        ws = torch.rand(n, device=dev) * 0.05
        x = torch.randn(m, k, device=dev).to(torch.bfloat16)
        weights = [gen(k, n) for _ in range(max(2, -(-60_000_000 // (k * n))))]
        it = iter(range(10 ** 9))
        pick = lambda: weights[next(it) % len(weights)]
        return dict(
            b1=lambda: km.int8_matmul(xq, pick(), xs, ws),
            b1_plain=lambda: ref.int8_matmul_ref(xq, pick(), xs, ws),
            fused=lambda: km.int8_matmul_quant(x, pick(), ws),
            fused_plain=lambda: plain(x, pick(), ws),
            b2_b1=lambda: b2_b1(x, pick(), ws), calls=len(weights))

    per_shape, per_shape_q = {}, {}
    for m in (SERVE_SLOTS, SERVE_CHUNK):
        for k, n in GEMM_KN[:4]:
            f = rotating(m, k, n)
            label = f"({m}, {k}) x ({k}, {n})"
            b, by = _gemm_bound(m, k, n)
            per_shape[label] = dict(
                ms=device_ms(f["b1"], f["calls"]), bound_ms=b, bound_by=by,
                plan=str(km.gemm_plan(m, n, k)))
            b, by = _gemm_bound(m, k, n, x_bytes=2)
            per_shape_q[label] = dict(
                ms=device_ms(f["fused"], f["calls"]),
                b2_b1_ms=device_ms(f["b2_b1"], f["calls"]), bound_ms=b,
                bound_by=by, plan=str(km.gemm_plan(m, n, k, x_bytes=2)))
    m, k, n = SERVE_SLOTS, 1024, 3072            # decode's gate/up shape
    f = rotating(m, k, n)
    # torch._int_mm needs M > 16: no library call at decode's M
    b, by = _gemm_bound(m, k, n)
    report["int8_matmul"] = dict(
        max_abs_err=err, bound_ms=b, bound_by=by,
        **timed(f["b1"], f["b1_plain"], calls=f["calls"]),
        shape=f"({m}, {k}) x ({k}, {n}) int8", shapes=per_shape)
    b, by = _gemm_bound(m, k, n, x_bytes=2)
    report["int8_matmul_quant"] = dict(
        max_abs_err=err_q, bound_ms=b, bound_by=by,
        **timed(f["fused"], f["fused_plain"], calls=f["calls"]),
        b2_b1_ms=device_ms(f["b2_b1"], f["calls"]),
        shape=f"x ({m}, {k}) bf16 x ({k}, {n}) int8", shapes=per_shape_q)


def _kv(dev, b, w, hkv, hd, quantized):
    import torch
    from repro_torch.models.attention import _quant_kv
    k = torch.randn(b, w, hkv, hd, device=dev).to(torch.bfloat16)
    v = torch.randn(b, w, hkv, hd, device=dev).to(torch.bfloat16)
    if not quantized:
        return k, v, None, None
    (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
    return kq, vq, ks, vs


def _attn_err(out, want, what):
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite output")
    d = (out.float() - want.float()).abs()
    if not (d <= ATTN_ATOL + ATTN_RTOL * want.float().abs()).all():
        fail(f"{what}: max |kernel - plain| = {d.max().item():.4g} over the "
             f"stated tolerance")
    return d.max().item()


def _attn_rows(out, want, what):
    """The worst ||kernel - plain|| / ||plain|| over the output rows; fails
    over ATTN_ROW_REL."""
    rows = ((out.float() - want.float()).norm(dim=-1)
            / want.float().norm(dim=-1)).max().item()
    if not rows <= ATTN_ROW_REL:
        fail(f"{what}: a row of the output {rows:.4g} off the plain "
             f"version's, over {ATTN_ROW_REL}")
    return rows


def _attn_check(out, want, what, errs):
    """B3-B6 against the plain version: the elementwise tolerance and every
    row within ATTN_ROW_REL. ``errs`` keeps the largest |err| and the worst
    row seen."""
    errs[0] = max(errs[0], _attn_err(out, want, what))
    errs[1] = max(errs[1], _attn_rows(out, want, what))


def _sdpa(q, k, v, start, sq):
    """scaled_dot_product_attention on GQA heads expanded to Hq, with the
    per-row causal mask: the library yardstick for bf16 attention (a call
    to time; the expansion is made once, outside it)."""
    import torch
    import torch.nn.functional as F
    b, w, hkv, hd = k.shape
    g = q.shape[2] // hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    lim = start[:, None] + torch.arange(sq, device=q.device)[None]
    mask = (torch.arange(w, device=q.device)[None, None]
            <= lim[..., None])[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _decode_starts(w, seg):
    """Six slots: at 0, around the first segment boundary, at the window's
    last position and past it (which sees the whole window)."""
    return [0, seg - 1, seg, seg + 1, w - 1, w + 5]


def _decode_bound(b, w, quantized, n_table=0, hq=16, hkv=8, hd=64):
    """q, out and start moved once; each slot's w visible positions of KV
    (with their scales, INT8) and its table entries (paged) read once;
    4·hd operations per (query head, visible position)."""
    n_kv = b * w * hkv * hd
    io = b * hq * hd * 2 * 2 + b * 4 + n_table * 4
    kv = n_kv * 2 + b * w * hkv * 4 * 2 if quantized else n_kv * 2 * 2
    return bound(kv + io, 4 * b * hq * hd * w, "int8" if quantized else "bf16")


def _rotating(fns):
    """One call that runs the next of ``fns`` each time, in turn."""
    it = itertools.count()
    return lambda: fns[next(it) % len(fns)]()


def _decode_times(dev, w, rotate_bytes=0, page_size=None,
                  heads=(16, 8, 64)):
    """B3 (or B5, through pages of ``page_size``) at q (4, Hq, hd) of
    ``heads`` (Hq, Hkv, hd), every slot at w - 1 against a w-position
    window: device ms of the kernel and of its plain version with INT8 and
    with bf16 KV, SDPA's on the bf16 KV (paged: on the gathered window,
    the gather not timed), and the bounds. With ``rotate_bytes``, each call
    takes the next of as many KV sets as hold that many bytes, so that a
    launch reads its KV from device memory and not from the 50 MB L2."""
    import torch
    from repro_torch.kernels import decode_attention as kd, ref
    from repro_torch.kernels.kv_layout import page_count, window_pages
    b, (hq, hkv, hd) = SERVE_SLOTS, heads
    q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
    start = torch.full((b,), w - 1, dtype=torch.int32, device=dev)
    out = {}
    for quantized in (True, False):
        per_set = b * w * hkv * (hd * 2 + 8 if quantized else hd * 4)
        n_sets = max(1, -(-rotate_bytes // per_set))
        kern, plain, lib = [], [], []
        for _ in range(n_sets):
            if page_size is None:
                kv = _kv(dev, b, w, hkv, hd, quantized)
                kern.append(lambda kv=kv: kd.decode_attention(q, *kv, start))
                plain.append(lambda kv=kv: ref.decode_attention_ref(q, *kv,
                                                                    start))
            else:
                arena, table = _paged_case(dev, page_size, quantized,
                                           [w - 1] * b, hkv=hkv, hd=hd,
                                           max_seq=w)
                idx = window_pages(table, page_size, w).contiguous()
                kern.append(lambda a=arena, i=idx: kd.paged_decode_attention(
                    q, *a, start, i))
                plain.append(lambda a=arena, i=idx:
                             ref.paged_decode_attention_ref(q, *a, start, i))
                kv = _gathered(arena, idx)
            if not quantized:
                lib.append(_sdpa(q[:, None], kv[0], kv[1], start, 1))
        n_table = 0 if page_size is None else b * page_count(w, page_size)
        b_ms, by = _decode_bound(b, w, quantized, n_table, hq, hkv, hd)
        calls = n_sets * max(1, GRAPH_CALLS // n_sets)
        r = out["int8" if quantized else "bf16"] = dict(
            bound_ms=b_ms, bound_by=by,
            **timed(_rotating(kern), _rotating(plain),
                    _rotating(lib) if lib else None, calls=calls))
        if n_sets > 1:
            r["kv_sets"] = n_sets
        if page_size is not None and not quantized:
            r["library"] = "SDPA on the gathered window, gather not timed"
    return out


def _decode_timed_shapes(dev, page_size=None):
    """``_decode_times`` at the serve shape (a 64-position window), then at
    DECODE_TIMED, keyed by shape."""
    b, hq, hkv, hd = SERVE_SLOTS, 16, 8, 64
    times = {}
    for w, rot in ((64, 0),) + DECODE_TIMED:
        kv = (f"KV ({b}, {w}, {hkv}, {hd})" if page_size is None
              else f"window {w}")
        label = (f"q ({b}, {hq}, {hd}) at {w - 1} vs {kv}"
                 + (f", KV rotated through {rot // 10**6} MB" if rot else ""))
        times[label] = _decode_times(dev, w, rot, page_size)
    return times


def phase_decode(dev, report):
    """B3 against its plain version (the tolerance, and every output row
    within ATTN_ROW_REL) at windows of DECODE_WINDOWS, slots at 0, around
    the first segment boundary, at W - 1 and past W, at the DECODE_HEADS
    groupings and widths; windowed == full bit for bit against a
    4,096-position buffer (up to four live segments); the split-KV tickets
    back at zero; then the device times at the serve shape and at
    DECODE_TIMED."""
    import torch
    from repro_torch.kernels import decode_attention as kd, ref
    errs = [0.0, 0.0]
    for quantized in (False, True):
        for hq, hkv, hd in DECODE_HEADS:
            for w in DECODE_WINDOWS:
                starts = _decode_starts(w, kd.SEG)
                k, v, ks, vs = _kv(dev, len(starts), w, hkv, hd, quantized)
                q = torch.randn(len(starts), hq, hd, device=dev).to(
                    torch.bfloat16)
                start = torch.tensor(starts, dtype=torch.int32, device=dev)
                _attn_check(kd.decode_attention(q, k, v, ks, vs, start),
                            ref.decode_attention_ref(q, k, v, ks, vs, start),
                            f"decode Hq={hq} Hkv={hkv} hd={hd} W={w} "
                            f"int8={quantized}", errs)
        # windowed == full: slots against a prefix of a longer buffer
        b, hq, hkv, hd = SERVE_SLOTS, 16, 8, 64
        full_w = DECODE_WINDOWS[-1]
        k, v, ks, vs = _kv(dev, b, full_w, hkv, hd, quantized)
        q = torch.randn(b, hq, hd, device=dev).to(torch.bfloat16)
        for w in DECODE_WINDOWS[:-1]:
            start = torch.tensor([0, min(kd.SEG, w - 1), w // 3, w - 1],
                                 dtype=torch.int32, device=dev)
            win = lambda t: None if t is None else t[:, :w]
            _equal(kd.decode_attention(q, win(k), win(v), win(ks), win(vs),
                                       start),
                   kd.decode_attention(q, k, v, ks, vs, start),
                   f"decode W={w} int8={quantized} vs the {full_w}-position "
                   f"buffer")
    _tickets_back(dev, "decode_attention")
    report["decode_attention"] = _attn_report(errs, _decode_timed_shapes(dev),
                                              "")


def _scratch(dev):
    """The split-K (B1) and split-KV (B3/B5) workspaces of ``dev``: their
    pointers, and the count of nonzero elements where the kernels must find
    zeros between launches (all of B1's, B3/B5's tickets)."""
    from repro_torch.kernels import decode_attention as kd, int8_matmul as km
    bufs = ([(w, w) for w in km.WORKSPACES.made(dev)]
            + [(w, w[:kd.TICKETS]) for w in kd.WORKSPACES.made(dev)])
    return ([w.data_ptr() for w, _ in bufs],
            sum(int(z.count_nonzero().item()) for _, z in bufs))


def _tickets_back(dev, what):
    """The multi-segment checks made a split-KV workspace and left its
    tickets at zero."""
    from repro_torch.kernels import decode_attention as kd
    _, left = _scratch(dev)
    if not kd.WORKSPACES.made(dev) or left:
        fail(f"{what}: split-KV workspace missing or its tickets not reset "
             f"({left} nonzero)")


def _prefill_bound(sq, st, w, quantized, n_table=0, hq=16, hkv=8, hd=64):
    """q, out and start moved once; the KV prefix the chunk sees (with its
    scales, INT8) and the table prefix (paged) read once; 4·hd operations
    per visible causal (query, key) pair. ``st``: one row's start, or a
    list of per-row starts."""
    starts = st if isinstance(st, (list, tuple)) else [st]
    visible = sum(min(s + i, w - 1) + 1 for s in starts for i in range(sq))
    seen = sum(min(s + sq, w) for s in starts) * hkv
    io = len(starts) * (sq * hq * hd * 2 * 2 + 4) + n_table * 4
    kv = seen * hd * 2 + seen * 4 * 2 if quantized else seen * hd * 2 * 2
    return bound(kv + io, 4 * hq * hd * visible,
                 "int8" if quantized else "bf16")


def _prefill_times(dev, sq, st, w, page_size=None, heads=(16, 8, 64)):
    """B4 (or B6, through pages of ``page_size``) at q (1, sq, Hq, hd) of
    ``heads`` (Hq, Hkv, hd) from position st against a w-position window:
    device ms of the kernel and of its plain version with INT8 and with
    bf16 KV, SDPA's on the bf16 KV (paged: on the gathered window, the
    gather not timed), and the bounds."""
    import torch
    from repro_torch.kernels import prefill_attention as kp, ref
    from repro_torch.kernels.kv_layout import window_pages
    hq, hkv, hd = heads
    q = torch.randn(1, sq, hq, hd, device=dev).to(torch.bfloat16)
    start = torch.full((1,), st, dtype=torch.int32, device=dev)
    out = {}
    for quantized in (True, False):
        if page_size is None:
            kv = _kv(dev, 1, w, hkv, hd, quantized)
            n_table = 0
            kern = lambda: kp.prefill_attention(q, *kv, start)
            plain = lambda: ref.cached_attention_ref(q, *kv, start)
        else:
            arena, table = _paged_case(dev, page_size, quantized,
                                       [st + sq - 1], hkv=hkv, hd=hd,
                                       max_seq=max(w, 256))
            idx = window_pages(table, page_size, w).contiguous()
            kv = _gathered(arena, idx)
            n_table = idx.numel()
            kern = lambda: kp.paged_prefill_attention(q, *arena, start, idx)
            plain = lambda: ref.paged_prefill_attention_ref(q, *arena, start,
                                                            idx)
        b_ms, by = _prefill_bound(sq, st, w, quantized, n_table, hq, hkv, hd)
        sdpa = None if quantized else _sdpa(q, kv[0], kv[1], start, sq)
        r = out["int8" if quantized else "bf16"] = dict(
            bound_ms=b_ms, bound_by=by, **timed(kern, plain, sdpa))
        if page_size is not None and not quantized:
            r["library"] = "SDPA on the gathered window, gather not timed"
    return out


def _attn_report(errs, times, layout):
    """The kernels-line entry of B3-B6: the serve shape's INT8 times at the
    top, its bf16 ones under ``bf16_kv``, the longer shapes under
    ``shapes``."""
    (label, serve), *longer = times.items()
    return dict(max_abs_err=errs[0], max_row_rel=errs[1], **serve["int8"],
                bf16_kv=serve["bf16"], shape=f"{label}, INT8 KV{layout}",
                shapes={k: v for k, v in longer})


def phase_prefill(dev, report):
    """B4 against its plain version (the tolerance, and every output row
    within ATTN_ROW_REL) at ragged chunks, per-slot starts, queries past the
    window's end and the PREFILL_HEADS groupings and widths; chunked ==
    whole-prompt prefill bit for bit against one KV tile (53 tokens) and
    against four (200); then the device times at PREFILL_TIMED."""
    import torch
    from repro_torch.kernels import prefill_attention as kp, ref
    hq, hkv, hd = 16, 8, 64
    errs = [0.0, 0.0]
    for quantized in (False, True):
        for sq in (16, 5, 1):
            for st in (0, 16, 37):
                w = -(-(st + sq) // 16) * 16
                k, v, ks, vs = _kv(dev, 2, w, hkv, hd, quantized)
                q = torch.randn(2, sq, hq, hd, device=dev).to(torch.bfloat16)
                start = torch.tensor([st, 0], dtype=torch.int32, device=dev)
                _attn_check(kp.prefill_attention(q, k, v, ks, vs, start),
                               ref.cached_attention_ref(q, k, v, ks, vs,
                                                        start),
                               f"prefill Sq={sq} start={st} int8={quantized}",
                               errs)
        # queries at or past the window's end see the whole window
        for st, sq, w in ((15, 5, 16), (40, 3, 32)):
            k, v, ks, vs = _kv(dev, 2, w, hkv, hd, quantized)
            q = torch.randn(2, sq, hq, hd, device=dev).to(torch.bfloat16)
            start = torch.tensor([st, w - 2], dtype=torch.int32, device=dev)
            _attn_check(
                kp.prefill_attention(q, k, v, ks, vs, start),
                ref.cached_attention_ref(q, k, v, ks, vs, start),
                f"prefill W={w} start={st} past the window int8={quantized}",
                errs)
        # other head groupings and widths
        for hq_, hkv_, hd_ in PREFILL_HEADS:
            for sq, st, w in ((16, 37, 64), (5, 200, 256), (53, 0, 64)):
                k, v, ks, vs = _kv(dev, 2, w, hkv_, hd_, quantized)
                q = torch.randn(2, sq, hq_, hd_, device=dev).to(
                    torch.bfloat16)
                start = torch.tensor([st, 0], dtype=torch.int32, device=dev)
                _attn_check(
                    kp.prefill_attention(q, k, v, ks, vs, start),
                    ref.cached_attention_ref(q, k, v, ks, vs, start),
                    f"prefill Hq={hq_} Hkv={hkv_} hd={hd_} Sq={sq} "
                    f"start={st} int8={quantized}", errs)
        # chunk == whole on the kernel itself: a prompt in chunks of 16,
        # each against its own 16-bucketed window
        for n, w in ((53, 64), (200, 256)):
            k, v, ks, vs = _kv(dev, 1, w, hkv, hd, quantized)
            q = torch.randn(1, n, hq, hd, device=dev).to(torch.bfloat16)
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            whole = kp.prefill_attention(q, k, v, ks, vs, zero)
            win = lambda t, c: None if t is None else t[:, :c]
            for lo in range(0, n, 16):
                hi = min(n, lo + 16)
                c = -(-hi // 16) * 16
                part = kp.prefill_attention(
                    q[:, lo:hi].contiguous(), win(k, c), win(v, c),
                    win(ks, c), win(vs, c),
                    torch.full((1,), lo, dtype=torch.int32, device=dev))
                _equal(part, whole[:, lo:hi],
                       f"prefill chunk [{lo}, {hi}) of {n} int8={quantized} "
                       f"vs whole-prompt prefill")
    times = {f"q (1, {sq}, {hq}, {hd}) at {st} vs KV (1, {w}, {hkv}, {hd})":
             _prefill_times(dev, sq, st, w) for sq, st, w in PREFILL_TIMED}
    report["prefill_attention"] = _attn_report(errs, times, "")


# ------------------------------------------------------------ paged kernels
def _paged_case(dev, ps, quantized, limits, hkv=8, hd=64, max_seq=256):
    """A paged arena whose pages sit in a random physical order, and a
    (B, max_pages) table: row r maps the pages covering positions
    0..limits[r]; its other entries point at the trash page 0, which holds
    random values like every other page."""
    import torch
    from repro_torch.kernels.kv_layout import page_count
    max_pages = page_count(max_seq, ps)
    n_pages = 1 + len(limits) * max_pages
    k, v, ks, vs = _kv(dev, n_pages, ps, hkv, hd, quantized)
    perm = (torch.randperm(n_pages - 1) + 1).tolist()
    table = torch.zeros(len(limits), max_pages, dtype=torch.int32)
    for r, lim in enumerate(limits):
        n = min(page_count(lim + 1, ps), max_pages)
        table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return (k, v, ks, vs), table.to(dev)


def _gathered(arena, idx):
    from repro_torch.kernels.kv_layout import gather_pages
    return [None if t is None else gather_pages(t, idx) for t in arena]


def _equal(a, b, what):
    import torch
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        d = (a.float() - b.float()).abs().max().item()
        fail(f"{what}: not bitwise equal (max |diff| {d:.4g})")


def phase_paged_decode(dev, report):
    """B5 against its plain version (as B3) and bit for bit against B3 on
    the gathered window, at pages of PAGE_SIZES, windows of 64 and 1,024
    positions, B3's starts, and the model's heads and ARCH_HEADS; then INT8 at B5_LONG positions in pages of
    SERVE_PAGE, a table longer than the 2,048 entries B5 once held in
    shared memory; the tickets back at zero; then the device times as B3's
    through pages of SERVE_PAGE."""
    import torch
    from repro_torch.kernels import decode_attention as kd, ref
    from repro_torch.kernels.kv_layout import window_pages
    hq, hkv, hd = 16, 8, 64
    errs = [0.0, 0.0]
    for quantized in (False, True):
        for ps in PAGE_SIZES:
            for (hq_, hkv_, hd_), window in itertools.product(
                    ((hq, hkv, hd),) + ARCH_HEADS, (64, 1024)):
                starts = _decode_starts(window, kd.SEG)
                arena, table = _paged_case(dev, ps, quantized, starts,
                                           hkv=hkv_, hd=hd_,
                                           max_seq=window + kd.SEG)
                idx = window_pages(table, ps, window).contiguous()
                start = torch.tensor(starts, dtype=torch.int32, device=dev)
                q = torch.randn(len(starts), hq_, hd_, device=dev).to(
                    torch.bfloat16)
                what = (f"paged decode page={ps} Hq={hq_} Hkv={hkv_} "
                        f"hd={hd_} W={window} int8={quantized}")
                out = kd.paged_decode_attention(q, *arena, start, idx)
                _attn_check(out, ref.paged_decode_attention_ref(
                    q, *arena, start, idx), what, errs)
                _equal(out, kd.decode_attention(q, *_gathered(arena, idx),
                                                start), what + " vs B3")
    w, ps = B5_LONG, SERVE_PAGE
    starts = [w - 1, w - 1000, 33000, kd.SEG]
    arena, table = _paged_case(dev, ps, True, starts, max_seq=w)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    q = torch.randn(len(starts), hq, hd, device=dev).to(torch.bfloat16)
    what = f"paged decode page={ps} W={w} ({table.shape[1]} pages) int8=True"
    out = kd.paged_decode_attention(q, *arena, start, table)
    _attn_check(out, ref.paged_decode_attention_ref(q, *arena, start, table),
                what, errs)
    _equal(out, kd.decode_attention(q, *_gathered(arena, table), start),
           what + " vs B3")
    print(f"[kernel] {what}: within tolerance of the plain version, equal "
          f"to B3 on the gathered window")
    del arena, table, out
    _tickets_back(dev, "paged_decode_attention")
    report["paged_decode_attention"] = _attn_report(
        errs, _decode_timed_shapes(dev, SERVE_PAGE),
        f" arena, pages of {SERVE_PAGE}")


def phase_paged_prefill(dev, report):
    """B6 against its plain version (as B4) and bit for bit against B4 on
    the gathered window, at pages of PAGE_SIZES, ragged chunks and the
    PREFILL_HEADS groupings and widths; chunked == whole-prompt prefill
    against one KV tile and against four; then a chunk at each of
    B6_LONG_STARTS of a B5_LONG-position window in pages of SERVE_PAGE, a
    table longer than the 2,048 entries B6 once held in shared memory,
    INT8 and bf16 KV; then the device times at PREFILL_TIMED and at the
    first long start through pages of SERVE_PAGE."""
    import torch
    from repro_torch.kernels import prefill_attention as kp, ref
    from repro_torch.kernels.kv_layout import page_count, window_pages
    b, hq, hkv, hd = SERVE_SLOTS, 16, 8, 64
    errs = [0.0, 0.0]
    for quantized in (False, True):
        for ps in PAGE_SIZES:
            heads = [(hq, hkv, hd, sq) for sq in (16, 5, 1)]
            heads += [(hq_, hkv_, hd_, 16) for hq_, hkv_, hd_ in PREFILL_HEADS]
            for hq_, hkv_, hd_, sq in heads:
                starts = [0, 16, 37, 200 - sq]
                window = -(-(max(starts) + sq) // 16) * 16
                arena, table = _paged_case(
                    dev, ps, quantized, [s + sq - 1 for s in starts],
                    hkv=hkv_, hd=hd_)
                idx = window_pages(table, ps, window).contiguous()
                start = torch.tensor(starts, dtype=torch.int32, device=dev)
                q = torch.randn(b, sq, hq_, hd_, device=dev).to(
                    torch.bfloat16)
                what = (f"paged prefill page={ps} Hq={hq_} Hkv={hkv_} "
                        f"hd={hd_} Sq={sq} int8={quantized}")
                out = kp.paged_prefill_attention(q, *arena, start, idx)
                _attn_check(out, ref.paged_prefill_attention_ref(
                    q, *arena, start, idx), what, errs)
                _equal(out, kp.prefill_attention(q, *_gathered(arena, idx),
                                                 start), what + " vs B4")
            # chunk == whole: a prompt in chunks of 16, each chunk against
            # the page-rounded window the engine would give it
            for n, w in ((53, 64), (200, 256)):
                arena, table = _paged_case(dev, ps, quantized, [n - 1])
                q = torch.randn(1, n, hq, hd, device=dev).to(torch.bfloat16)
                zero = torch.zeros(1, dtype=torch.int32, device=dev)
                whole = kp.paged_prefill_attention(
                    q, *arena, zero, window_pages(table, ps, w).contiguous())
                for lo in range(0, n, 16):
                    hi = min(n, lo + 16)
                    c = page_count(-(-hi // 16) * 16, ps) * ps
                    part = kp.paged_prefill_attention(
                        q[:, lo:hi].contiguous(), *arena,
                        torch.full((1,), lo, dtype=torch.int32, device=dev),
                        window_pages(table, ps, c).contiguous())
                    _equal(part, whole[:, lo:hi],
                           f"paged prefill page={ps} chunk [{lo}, {hi}) of "
                           f"{n} int8={quantized} vs whole prompt")
    w, ps, sq = B5_LONG, SERVE_PAGE, SERVE_CHUNK
    for quantized in (True, False):
        arena, table = _paged_case(dev, ps, quantized,
                                   [st + sq - 1 for st in B6_LONG_STARTS],
                                   max_seq=w)
        start = torch.tensor(B6_LONG_STARTS, dtype=torch.int32, device=dev)
        q = torch.randn(len(B6_LONG_STARTS), sq, hq, hd, device=dev).to(
            torch.bfloat16)
        what = (f"paged prefill page={ps} W={w} ({table.shape[1]} pages) "
                f"Sq={sq} at {B6_LONG_STARTS} int8={quantized}")
        out = kp.paged_prefill_attention(q, *arena, start, table)
        _attn_check(out, ref.paged_prefill_attention_ref(
            q, *arena, start, table), what, errs)
        _equal(out, kp.prefill_attention(q, *_gathered(arena, table), start),
               what + " vs B4")
        print(f"[kernel] {what}: within tolerance of the plain version, "
              f"equal to B4 on the gathered window")
        del arena, table, out
    timed_shapes = PREFILL_TIMED + ((sq, B6_LONG_STARTS[0], w),)
    times = {f"q (1, {sq}, {hq}, {hd}) at {st} vs window {w}":
             _prefill_times(dev, sq, st, w, SERVE_PAGE)
             for sq, st, w in timed_shapes}
    report["paged_prefill_attention"] = _attn_report(
        errs, times, f" arena, pages of {SERVE_PAGE}")


# ------------------------------------------------------------ flash (train)
def _flash_case(dev, b, s, hq, hkv, hd):
    import torch
    return [torch.randn(b, s, h, hd, device=dev).to(torch.bfloat16)
            for h in (hq, hkv, hkv)]


def _flash_bound(b, s, hq, hkv, hd):
    """q, k, v, out and lse moved once; 4·hd operations per visible causal
    (query, key) pair, s(s+1)/2 of them per (batch, head)."""
    n_bytes = b * s * (2 * hq + 2 * hkv) * hd * 2 + b * hq * s * 4
    return bound(n_bytes, 4 * hd * b * hq * s * (s + 1) // 2, "bf16")


def _sdpa_causal(q, k, v):
    """scaled_dot_product_attention(is_causal=True) on K/V expanded to Hq
    heads: the library yardstick of the flash kernel (a call to time; the
    expansion is made once, outside it)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)


def phase_flash(dev, report):
    """The causal flash kernel (B7) against its plain version: output and
    log-sum-exp at the calibration shape, a long S, a ragged S, G = 1, hd
    128 and the train route's shapes (timed too); q read through strides;
    the backward (autograd through the kernel's Function) against autograd
    through the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as kf, ref
    err = row_rel = 0.0
    for b, s, hq, hkv, hd in FLASH_SHAPES:
        what = f"flash B={b} S={s} Hq={hq} Hkv={hkv} hd={hd}"
        q, k, v = _flash_case(dev, b, s, hq, hkv, hd)
        out, lse = kf.flash_attention_fwd(q, k, v)
        want, want_lse = ref.flash_attention_lse_ref(q, k, v)
        err = max(err, _attn_err(out, want, what))
        row_rel = max(row_rel, _attn_rows(out, want, what))
        d = (lse - want_lse).abs().max().item()
        if not d <= LSE_ATOL:
            fail(f"{what}: max |lse - plain| = {d:.4g} over {LSE_ATOL}")
        # q with its heads outermost, read through its strides
        qs = q.transpose(1, 2).contiguous().transpose(1, 2)
        _equal(kf.flash_attention_fwd(qs, k, v)[0], out, what + " strided q")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        d_out = torch.randn_like(out)
        got = torch.autograd.grad(kf.flash_attention(*leaves), leaves, d_out)
        plain = torch.autograd.grad(ref.flash_attention_ref(*leaves), leaves,
                                    d_out)
        torch.cuda.synchronize()
        for name, g, w in zip("qkv", got, plain):
            if not torch.isfinite(g.float()).all():
                fail(f"{what}: non-finite d{name}")
            e = (g.float() - w.float()).abs().max().item()
            top = w.float().abs().max().item()
            if e > GRAD_FRAC * top:
                fail(f"{what}: d{name} max |kernel - plain| {e:.4g} over "
                     f"{GRAD_FRAC} x {top:.4g}")
    timing = {}
    for b, s, hq, hkv, hd in FLASH_SHAPES[:2]:
        q, k, v = _flash_case(dev, b, s, hq, hkv, hd)
        b_ms, by = _flash_bound(b, s, hq, hkv, hd)
        timing[(b, s)] = dict(
            bound_ms=b_ms, bound_by=by,
            **timed(lambda: kf.flash_attention_fwd(q, k, v),
                    lambda: ref.flash_attention_lse_ref(q, k, v),
                    _sdpa_causal(q, k, v), calls=10),
            shape=f"q ({b}, {s}, {hq}, {hd}) vs k/v ({b}, {s}, {hkv}, "
                  f"{hd}) bf16")
    main, long = timing.values()
    train = {}
    for b, s, hq, hkv, hd in TRAIN_FLASH_SHAPES:
        q, k, v = _flash_case(dev, b, s, hq, hkv, hd)
        b_ms, by = _flash_bound(b, s, hq, hkv, hd)
        train[f"q ({b}, {s}, {hq}, {hd}) vs k/v ({b}, {s}, {hkv}, {hd}) "
              f"bf16"] = dict(
            bound_ms=b_ms, bound_by=by,
            **timed(lambda: kf.flash_attention_fwd(q, k, v),
                    lambda: ref.flash_attention_lse_ref(q, k, v),
                    _sdpa_causal(q, k, v), calls=10))
    report["flash_attention"] = dict(max_abs_err=err, max_row_rel=row_rel,
                                     **main, long_s=long,
                                     train_shapes=train)


def phase_hd96(dev, report):
    """B3-B7's hd-96 instances at phi-3-vision's heads (PHI_HEADS, G 1)
    against their plain versions, at the limits in force (the elementwise
    tolerance, every output row within ATTN_ROW_REL): B3 and B5 against an
    HD96_W window, slots at 0, around the first segment boundary, at W - 1
    and past W, B5 through pages of SERVE_PAGE equal to B3 on the gathered
    window; B4 and B6 at HD96_PREFILL, B6 equal to B4 on the gathered
    window, and B4's chunks equal to its whole prefill; B7 at HD96_FLASH,
    its log-sum-exp and backward too; INT8 and bf16 KV. Each timed from
    CUDA-graph replays beside its bound and, where one call computes the
    same function (bf16 KV; B7), SDPA's (``_decode_times``,
    ``_prefill_times``); into each kernel's ``hd96``."""
    import torch
    from repro_torch.kernels import (decode_attention as kd,
                                     flash_attention as kf,
                                     prefill_attention as kp, ref)
    from repro_torch.kernels.kv_layout import window_pages
    hq, hkv, hd = PHI_HEADS
    w, ps = HD96_W, SERVE_PAGE
    errs = {n: [0.0, 0.0] for n in ("decode_attention", "prefill_attention",
                                    "paged_decode_attention",
                                    "paged_prefill_attention")}
    for quantized in (True, False):
        starts = _decode_starts(w, kd.SEG)
        k, v, ks, vs = _kv(dev, len(starts), w, hkv, hd, quantized)
        q = torch.randn(len(starts), hq, hd, device=dev).to(torch.bfloat16)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        what = f"decode hd 96 Hq={hq} Hkv={hkv} W={w} int8={quantized}"
        _attn_check(kd.decode_attention(q, k, v, ks, vs, start),
                    ref.decode_attention_ref(q, k, v, ks, vs, start), what,
                    errs["decode_attention"])
        arena, table = _paged_case(dev, ps, quantized, starts, hkv=hkv, hd=hd,
                                   max_seq=w + kd.SEG)
        idx = window_pages(table, ps, w).contiguous()
        out = kd.paged_decode_attention(q, *arena, start, idx)
        _attn_check(out, ref.paged_decode_attention_ref(q, *arena, start,
                                                         idx),
                    "paged " + what, errs["paged_decode_attention"])
        _equal(out, kd.decode_attention(q, *_gathered(arena, idx), start),
               "paged " + what + " vs B3")
        for sq, st in HD96_PREFILL:
            starts = [st, 0]
            k, v, ks, vs = _kv(dev, 2, w, hkv, hd, quantized)
            q = torch.randn(2, sq, hq, hd, device=dev).to(torch.bfloat16)
            start = torch.tensor(starts, dtype=torch.int32, device=dev)
            what = (f"prefill hd 96 Hq={hq} Hkv={hkv} Sq={sq} start={st} "
                    f"W={w} int8={quantized}")
            _attn_check(kp.prefill_attention(q, k, v, ks, vs, start),
                        ref.cached_attention_ref(q, k, v, ks, vs, start),
                        what, errs["prefill_attention"])
            arena, table = _paged_case(dev, ps, quantized,
                                       [x + sq - 1 for x in starts], hkv=hkv,
                                       hd=hd, max_seq=w)
            idx = window_pages(table, ps, w).contiguous()
            out = kp.paged_prefill_attention(q, *arena, start, idx)
            _attn_check(out, ref.paged_prefill_attention_ref(
                q, *arena, start, idx), "paged " + what,
                errs["paged_prefill_attention"])
            _equal(out, kp.prefill_attention(q, *_gathered(arena, idx),
                                             start),
                   "paged " + what + " vs B4")
            if st:
                continue
            # chunks at absolute tiles == the whole prefill (slot 1, from 0)
            one = [None if t is None else t[1:] for t in (k, v, ks, vs)]
            whole = kp.prefill_attention(q[1:], *one, start[1:])
            for lo, hi in ((0, 16), (16, 304), (304, sq)):
                part = kp.prefill_attention(
                    q[1:, lo:hi].contiguous(), *one,
                    torch.full((1,), lo, dtype=torch.int32, device=dev))
                _equal(part, whole[:, lo:hi],
                       f"{what}: chunk [{lo}, {hi}) vs whole prefill")
    kv_label = f"KV ({SERVE_SLOTS}, {w}, {hkv}, {hd})"
    times = {
        "decode_attention": {
            f"q ({SERVE_SLOTS}, {hq}, {hd}) at {w - 1} vs {kv_label}":
            _decode_times(dev, w, heads=PHI_HEADS)},
        "paged_decode_attention": {
            f"q ({SERVE_SLOTS}, {hq}, {hd}) at {w - 1} vs window {w}":
            _decode_times(dev, w, page_size=ps, heads=PHI_HEADS)},
        "prefill_attention": {
            f"q (1, {sq}, {hq}, {hd}) at {st} vs KV (1, {w}, {hkv}, {hd})":
            _prefill_times(dev, sq, st, w, heads=PHI_HEADS)
            for sq, st in HD96_PREFILL},
        "paged_prefill_attention": {
            f"q (1, {sq}, {hq}, {hd}) at {st} vs window {w}":
            _prefill_times(dev, sq, st, w, ps, heads=PHI_HEADS)
            for sq, st in HD96_PREFILL}}
    for name, e in errs.items():
        report[name]["hd96"] = dict(max_abs_err=e[0], max_row_rel=e[1],
                                    shapes=times[name])
        for shape, t in times[name].items():
            for kv_name, o in t.items():
                print(f"[kernel] {name} hd 96 at {shape}, {kv_name} KV: "
                      + _times(o))
        print(f"[kernel] {name} hd 96: max |err| {e[0]:.3g}, worst row "
              f"{e[1]:.4g} (limit {ATTN_ROW_REL})")
    # B7
    b, s, hq, hkv, hd = HD96_FLASH
    what = f"flash hd 96 B={b} S={s} Hq={hq} Hkv={hkv}"
    q, k, v = _flash_case(dev, b, s, hq, hkv, hd)
    out, lse = kf.flash_attention_fwd(q, k, v)
    want, want_lse = ref.flash_attention_lse_ref(q, k, v)
    err, rel = _attn_err(out, want, what), _attn_rows(out, want, what)
    d = (lse - want_lse).abs().max().item()
    if not d <= LSE_ATOL:
        fail(f"{what}: max |lse - plain| = {d:.4g} over {LSE_ATOL}")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    d_out = torch.randn_like(out)
    got = torch.autograd.grad(kf.flash_attention(*leaves), leaves, d_out)
    plain = torch.autograd.grad(ref.flash_attention_ref(*leaves), leaves,
                                d_out)
    for name, g, wt in zip("qkv", got, plain):
        e = (g.float() - wt.float()).abs().max().item()
        top = wt.float().abs().max().item()
        if not (torch.isfinite(g.float()).all() and e <= GRAD_FRAC * top):
            fail(f"{what}: d{name} max |kernel - plain| {e:.4g} over "
                 f"{GRAD_FRAC} x {top:.4g}")
    b_ms, by = _flash_bound(b, s, hq, hkv, hd)
    t = dict(bound_ms=b_ms, bound_by=by, max_abs_err=err, max_row_rel=rel,
             **timed(lambda: kf.flash_attention_fwd(q, k, v),
                     lambda: ref.flash_attention_lse_ref(q, k, v),
                     _sdpa_causal(q, k, v), calls=10))
    shape = f"q ({b}, {s}, {hq}, {hd}) vs k/v ({b}, {s}, {hkv}, {hd}) bf16"
    report["flash_attention"]["hd96"] = dict(t, shape=shape)
    print(f"[kernel] flash_attention hd 96 at {shape}: " + _times(t)
          + f", max |err| {err:.3g}, worst row {rel:.4g}, lse and backward "
          f"within their limits")


# ------------------------------------------------------------------ serving
def phase_small_e2e(dev):
    """The smoke model on the card against the same model on the CPU (the
    plain versions): prefill + 8 decode steps, teacher-forced, INT8 KV; and
    the train route's hidden states and loss on the FP weights."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.models import lm
    from repro_torch.weights import to_device
    cfg = configs.get_smoke_config("qwen3-0.6b")
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device="cpu"))
    gpu_params = to_device(params, dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    states = {d: lm.init_decode_state(cfg, 2, 64, params=p, quantized_kv=True,
                                      device=d)
              for d, p in (("cpu", params), (dev, gpu_params))}
    toks, err = prompt, 0.0
    for step in range(9):
        out = {}
        for d, p in (("cpu", params), (dev, gpu_params)):
            out[d], states[d] = lm.decode_step(
                p, cfg, states[d], toks.to(d),
                route="prefill" if step == 0 else "decode")
        a, b = out["cpu"], out[dev].cpu()
        if a.shape != b.shape or not torch.isfinite(b).all():
            fail(f"smoke model step {step}: bad logits {tuple(b.shape)}")
        real = slice(0, cfg.vocab_size)
        err = max(err, (a[..., real] - b[..., real]).abs().max().item())
        toks = a[:, -1].argmax(-1)[:, None]
    if err > E2E_ATOL:
        fail(f"smoke model card vs CPU: max |logit diff| {err:.4g}")
    # the train route: the flash kernel on the card, the chunked online
    # softmax on the CPU, on the FP weights
    fp = lm.init_params(cfg, seed=0, device="cpu")
    gpu_fp = to_device(fp, dev)
    batch = {"tokens": prompt}
    h_cpu = lm.forward(fp, cfg, batch)
    h_dev = lm.forward(gpu_fp, cfg, {"tokens": prompt.to(dev)}).cpu()
    if not torch.isfinite(h_dev.float()).all():
        fail("smoke model train route: non-finite hidden states")
    h_err = (h_cpu.float() - h_dev.float()).abs().max().item()
    loss_cpu = lm.loss_fn(fp, cfg, batch).item()
    loss_dev = lm.loss_fn(gpu_fp, cfg, {"tokens": prompt.to(dev)}).item()
    if (h_err > TRAIN_HIDDEN_ATOL
            or abs(loss_dev - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu)):
        fail(f"smoke model train route card vs CPU: max |hidden diff| "
             f"{h_err:.4g}, loss {loss_dev:.6f} vs {loss_cpu:.6f}")
    return err, h_err, loss_dev, loss_cpu


def phase_static(dev, card):
    """Both static-analysis planes on the card: the dispatch plane over the
    KV matrix and the speculative cell at smoke size (every declared hot
    path traced eagerly and under capture, each captured graph's dump
    read for arena-sized memcpy and memset nodes, the retrace workloads),
    then the AST lint of the port's serving modules and CI scripts. A
    ``[static]`` line per plane; any violation fails the run."""
    import torch
    from repro_torch.analysis import astlint, dispatch_checks, render
    t0 = time.monotonic()
    lines = []
    found = dispatch_checks.run_dispatch_plane(device=dev, log=lines.append)
    torch.cuda.synchronize()
    t_dispatch = time.monotonic() - t0
    for line in lines:
        print(f"[static] {line}  [{card}]")
    print(f"[static] dispatch plane: {len(found)} violations in "
          f"{t_dispatch:.1f} s  [{card}]")
    t1 = time.monotonic()
    lint = astlint.lint_tree(ROOT)
    print(f"[static] ast plane: {len(lint)} violations over "
          f"{len(astlint.default_targets(ROOT))} files in "
          f"{time.monotonic() - t1:.1f} s")
    if found or lint:
        fail("static checks:\n" + render(found + lint))


GRAPH_STATS = ("graphs_captured", "graph_replays", "eager_dispatches",
               "capture_s")


def _int8_linears(params):
    """The INT8 linears of every block: attention, Mamba and mLSTM
    (in_proj and out_proj), sLSTM (up and down), MLP and MoE experts."""
    from repro_torch.compress.qtypes import QuantizedLinear
    return [v for blk in params["blocks"]
            for part in ("attn", "mamba", "mlstm", "slstm", "mlp", "moe")
            if part in blk
            for v in blk[part].values() if isinstance(v, QuantizedLinear)]


def _n_linears(params) -> int:
    """The W8A8 launches a forward runs: one fused B1 launch a linear, and
    one an expert of each of an MoE layer's INT8 projections."""
    return sum((v.w_q.shape[0] if v.w_q.ndim == 3 else 1)
               for v in _int8_linears(params))


def _b1_model_shapes(dev, trees, what, tag, card, ms=GEMM_M) -> None:
    """B1 and its serving form (``_b1_case``) at every (K, N) of the INT8
    linears of ``trees`` (an expert's (K, N) once), at every M of ``ms``:
    by default GEMM_M, the rows the engine gives B1 (a decode step's, a
    prefill chunk's, a verify's SERVE_SLOTS x (SPEC_K + 1)) and one past
    16-row tiles; a caller whose path gives other M passes them. The
    split-K workspace must be zero again after them."""
    shapes = sorted({tuple(v.w_q.shape[-2:]) for t in trees
                     for v in _int8_linears(t)})
    splits = set()
    for m in ms:
        for k, n in shapes:
            splits.update(p.split for p in _b1_case(dev, m, k, n)[2:])
    _, ws_left = _scratch(dev)
    if ws_left:
        fail(f"{what}: split-K workspace not reset ({ws_left})")
    print(f"[{tag}] int8_matmul and int8_matmul_quant bit-identical to their "
          f"plain versions at {what}'s (K, N) {shapes} x M {list(ms)}, "
          f"split-K factors {sorted(splits)}  [{card}]")


# serial decode's tokens, decoded once for each (params, config, prompt,
# length, options): the loads that serve the same params on the same
# requests (contiguous and paged, the service phase's load) share one
# oracle. An entry holds weak references to the params' tensors and their
# version counters, so it serves only while every tensor is the same
# object, unchanged in place, and keeps no tensor alive.
_ORACLES = {}


def oracle_decode(params, cfg, prompt, max_new_tokens, **kw):
    """``serial_decode(params, cfg, prompt, max_new_tokens, **kw)``, from
    ``_ORACLES`` when the same params gave it before."""
    import weakref
    from repro_torch import tree
    from repro_torch.serving import serial_decode
    leaves = tree.leaves(params)
    key = (id(params), repr(cfg), tuple(int(t) for t in prompt),
           max_new_tokens, repr(sorted(kw.items())))
    hit = _ORACLES.get(key)
    if hit is not None and len(hit[0]) == len(leaves) and all(
            ref() is t and v == t._version
            for (ref, v), t in zip(hit[0], leaves)):
        return list(hit[1])
    toks = serial_decode(params, cfg, prompt, max_new_tokens, **kw)
    _ORACLES[key] = ([(weakref.ref(t), t._version) for t in leaves], toks)
    return list(toks)


def serve_once(params, cfg, dev, kernels, reqs, must, must_not,
               arrivals_s=None, arrival_ticks=None, max_seq=SERVE_MAX_SEQ,
               split_kv=False, runs=SERVE_RUNS, sampling=None, want=None,
               expect=None, **engine_kw):
    """The load run ``runs`` times on one engine, which captures each
    dispatch key's CUDA graph at its second use and replays it after: the
    first run is cold (first uses eager, captures), the last warm. Each run
    starts from launch counts at 0 and, paged, an empty prefix cache (so
    every run does the same work). In every run each request must equal
    serial decode token for token; every kernel in ``must`` must have
    launched and none in ``must_not``, and the launch counts must be the
    device's: one fused B1 launch a W8A8 linear of each decode step and
    prefill chunk, one decode attend an attention layer a step and one
    prefill attend an attention layer a chunk; the B1 split-K and B3/B5
    split-KV workspaces must neither move nor be left nonzero where the
    kernels must find zeros
    (``_scratch``). With ``split_kv`` every run must also have written
    split-KV records (B3/B5 folded several segments): they are zeroed before
    it and read after it. The load must replay graphs, and its graph keys
    stay within the engine's bounds (the reference's lowering bounds).
    ``sampling`` draws tokens in the engine and in serial decode alike.
    ``want`` replaces serial decode as the tokens each request must give
    (a None entry checks nothing), and ``expect(delta, attend)`` the
    launches a run must count (``spec_expect`` for a speculative engine).
    Returns (one dict a run: summary, launches, stats deltas, each
    request's tokens; engine)."""
    import torch
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.serving import Engine, SchedulerConfig, summarize_results
    qkv = engine_kw.get("quantized_kv", False)
    eng = Engine(params, cfg, n_slots=SERVE_SLOTS, max_seq=max_seq,
                 sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                       decode_steps=SERVE_STEPS),
                 device=dev, sampling=sampling, **engine_kw)
    what = (f"int8_kv={qkv} page_size={engine_kw.get('page_size')}"
            + ("" if sampling is None else f" {sampling}")
            + (" speculative" if eng.spec is not None else ""))
    if want is None:
        want = [oracle_decode(params, cfg, r.prompt, r.max_new_tokens,
                              max_seq=max_seq, quantized_kv=qkv, device=dev,
                              sampling=sampling)
                for r in reqs]
    paged = engine_kw.get("page_size") is not None
    attend = ("paged_" if paged else "") + "%s_attention"
    n_lin = _n_linears(params)
    n_attn = cfg.pattern.count("attn")
    if expect is None:
        def expect(d, attend):
            steps, chunks = d["device_steps"], d["prefill_ticks"]
            return {"int8_matmul_quant": n_lin * (steps + chunks),
                    attend % "decode": n_attn * steps,
                    attend % "prefill": n_attn * chunks}
    out = []
    for run in range(runs):
        if eng.prefix is not None:
            eng.prefix.clear()
        workspaces, _ = _scratch(dev)
        records = (kd.WORKSPACES.made(dev)[-1][kd.TICKETS:] if split_kv
                   else None)
        if split_kv:
            records.zero_()
        before = dict(eng.stats)
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.monotonic()
        results = eng.run(reqs, arrivals_s=arrivals_s,
                          arrival_ticks=arrival_ticks)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: kern.launches for name, kern in kernels.items()}
        delta = {k: eng.stats[k] - before[k] for k in
                 ("device_steps", "host_syncs", "prefill_ticks",
                  "decode_ticks", "prefill_tokens", "prefix_hits",
                  "spec_cycles", "accepted_tokens", "drafted_tokens",
                  "cow_copies", *GRAPH_STATS)}
        where = f"{what} run {run + 1}"
        if split_kv and not records.count_nonzero().item():
            fail(f"{where}: no split-KV record written: the decode windows "
                 f"never spanned two segments")
        # the B1 and B3/B5 workspaces: made by the kernel checks, kept by
        # the run
        ptrs, left = _scratch(dev)
        if ptrs != workspaces or left:
            fail(f"{where}: a split-K or split-KV workspace moved or was "
                 f"left nonzero by the serving run")
        if len(results) != len(reqs):
            fail(f"{where}: engine finished {len(results)} of {len(reqs)} "
                 f"requests")
        for i, res in sorted(results.items()):
            if len(res.tokens) != reqs[i].max_new_tokens or not all(
                    0 <= t < cfg.vocab_size for t in res.tokens):
                fail(f"{where} request {i}: bad tokens {res.tokens}")
            if want[i] is not None and res.tokens != want[i]:
                fail(f"{where} request {i}: engine tokens differ from serial "
                     f"decode\n engine {res.tokens}\n serial {want[i]}")
        idle = [name for name in must if launches[name] == 0]
        if idle:
            fail(f"{where}: kernels never launched on the serving run: "
                 f"{idle}")
        stray = [name for name in must_not if launches[name]]
        if stray:
            fail(f"{where}: kernels off this serving path launched: {stray}")
        off = {n: (launches[n], c) for n, c in expect(delta, attend).items()
               if launches[n] != c}
        if off:
            fail(f"{where}: launches (counted, the device's) {off} over "
                 f"{delta['device_steps']} device steps, "
                 f"{delta['spec_cycles']} speculative cycles and "
                 f"{delta['prefill_ticks']} prefill chunks")
        out.append({"summary": summarize_results(results, wall),
                    "launches": launches, **delta,
                    "tokens": [results[i].tokens for i in range(len(reqs))]})
    graphs = eng.graphs
    over = {k: (len(v), graphs.bounds[k]) for k, v in graphs.keys.items()
            if len(v) > graphs.bounds[k]}
    if over or eng.stats["graphs_captured"] > sum(graphs.bounds.values()):
        fail(f"{what}: graph keys past their bounds {over}, "
             f"{eng.stats['graphs_captured']} captured")
    if not out[-1]["graph_replays"]:
        fail(f"{what}: the last run replayed no CUDA graph")
    return out, eng


def serve_line(runs, eng, label, card, graph_totals, tag="[serve]"):
    """The first and the last run of a load (``_run_name``: the last is
    "warm" when it only replayed); adds the load's graph stats to its
    layout's totals."""
    for i in sorted({0, len(runs) - 1}):
        name, r = _run_name(runs, i), runs[i]
        sm = r["summary"]
        print(f"{tag} {label}, {name} run ({i + 1} of "
              f"{len(runs)}): {sm['n_requests']} requests, "
              f"{sm['out_tokens']} tokens, {sm['tokens_per_s']:.2f} "
              f"tok/s, TTFT p50 {sm['ttft_p50_ms']:.1f} ms, latency p50 "
              f"{sm['latency_p50_ms']:.1f} ms, {r['device_steps']} device "
              f"steps / {r['host_syncs']} host syncs, graphs "
              f"{r['graphs_captured']} captured / {r['graph_replays']} "
              f"replays / {r['eager_dispatches']} eager dispatches, "
              f"engine == serial on all requests, launches "
              f"{r['launches']}  [{card}]")
    layout = "paged" if eng.paged else "contiguous"
    tot = graph_totals.setdefault(layout, dict.fromkeys(
        ("loads", *GRAPH_STATS, "pool_bytes_max"), 0))
    tot["loads"] += 1
    for k in GRAPH_STATS:
        tot[k] += eng.stats[k]
    tot["pool_bytes_max"] = max(tot["pool_bytes_max"],
                                eng.stats["graph_pool_bytes"])
    bound = {k: f"{len(v)} of {eng.graphs.bounds[k]}"
             for k, v in eng.graphs.keys.items()}
    print(f"{tag} {label}: graph keys {bound}, capture "
          f"{eng.stats['capture_s']:.3f} s, graph pool "
          f"{eng.stats['graph_pool_bytes']} B  [{card}]")


def _per_layer_ranking(ranked, drops):
    """A ranking over ``ranked``'s families that drops, in family i, its
    ``drops(i, spec)`` lowest-S units in the Fisher order of ``ranked``;
    returns it with its drop count."""
    import numpy as np
    from repro_torch.core.pruning import RankedUnits
    spec_idx, unit_idx = [], []
    for i, spec in enumerate(ranked.specs):
        d = drops(i, spec)
        spec_idx += [i] * d
        unit_idx += ranked.unit_idx[ranked.spec_idx == i][:d].tolist()
    n = len(unit_idx)
    return RankedUnits(ranked.specs, np.asarray(spec_idx),
                       np.asarray(unit_idx), np.zeros(n, np.float32)), n


def _sublayer_rel(cfg, masked, other, batch):
    """The worst relative difference, ||masked - other|| / ||masked||, of a
    layer's mixer (attention, Mamba, mLSTM or sLSTM) or FFN output between
    two models, both fed the masked model's input to that layer (the loop
    of ``lm.forward``). Layer by layer, no layer compounds another's
    roundings."""
    import torch
    from repro_torch.models import attention as A, layers as L, lm, ssm
    from repro_torch.models import xlstm
    tokens = batch["tokens"]
    x = L.embed_lookup(masked["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    worst = 0.0

    def mixer(p, h):
        if "attn" in p:
            return A.attention_forward(p["attn"], cfg, h, positions,
                                       route=A.TRAIN)
        if "mamba" in p:
            return ssm.mamba_forward(p["mamba"], cfg, h,
                                     batch_invariant=False)[0]
        kind = "mlstm" if "mlstm" in p else "slstm"
        return getattr(xlstm, f"{kind}_forward")(
            p[kind], cfg, h, batch_invariant=False)[0]
    for pm, po in zip(masked["blocks"], other["blocks"]):
        h = L.rmsnorm(x, pm["norm1"], cfg.norm_eps, batch_invariant=False)
        am, ao = (mixer(p, h) for p in (pm, po))
        x = x + am
        outs = [(am, ao)]
        if "norm2" in pm:                   # an xLSTM block has no FFN
            h = L.rmsnorm(x, pm["norm2"], cfg.norm_eps,
                          batch_invariant=False)
            fm, fo = (lm.ffn(p, cfg, h, batch_invariant=False)
                      for p in (pm, po))
            x = x + fm
            outs.append((fm, fo))
        for m, o in outs:
            m, o = m.float(), o.float()
            if not o.isfinite().all():
                return float("inf")
            worst = max(worst, ((m - o).norm() / m.norm()).item())
    return worst


def _misalign_ffn(params, layer):
    """A planted compaction fault: ``layer``'s FFN down rows one unit off
    from its gate/up columns (an MoE layer's: each expert's down weights
    those of the expert before it)."""
    blocks = list(params["blocks"])
    b = blocks[layer]
    part = "moe" if "moe" in b else "mlp"
    down = {**b[part]["down"], "w": b[part]["down"]["w"].roll(1, 0)}
    blocks[layer] = {**b, part: {**b[part], "down": down}}
    return {**params, "blocks": blocks}


def _misalign_mlstm(params, layer):
    """A planted compaction fault for the xLSTM family: ``layer``'s mLSTM
    out_proj rows half a head off from the head rows that feed them."""
    blocks = list(params["blocks"])
    b = blocks[layer]
    hd = b["mlstm"]["wq"].shape[-1]
    out = {"w": b["mlstm"]["out_proj"]["w"].roll(hd // 2, 0)}
    blocks[layer] = {**b, "mlstm": {**b["mlstm"], "out_proj": out}}
    return {**params, "blocks": blocks}


def _ffn_width(blk) -> int:
    """A layer's FFN units: d_ff columns, or an MoE layer's experts (an
    xLSTM block has none)."""
    if "moe" in blk:
        return blk["moe"]["up"]["w"].shape[0]
    return blk["mlp"]["up"]["w"].shape[1] if "mlp" in blk else 0


def _mixer_width(blk, cfg) -> int:
    """A layer's mixer units: KV heads, a Mamba layer's channels, or an
    mLSTM layer's heads (an sLSTM layer's d_model: it is not pruned)."""
    if "attn" in blk:
        return blk["attn"]["wk"]["w"].shape[1] // cfg.resolved_head_dim
    if "mlstm" in blk:
        return blk["mlstm"]["wq"].shape[0]
    if "slstm" in blk:
        return cfg.d_model
    return blk["mamba"]["conv_w"].shape[-1]


def _mask_vs_compact(cfg, masked, compact, batch, what, card,
                     misalign=_misalign_ffn):
    """The masked model and the compacted one compute the same function:
    the same accuracy on the calibration batch, and each layer's mixer
    and FFN outputs within SUBLAYER_REL of each other. The same check must
    refuse the compacted model with a planted fault (``misalign``: one
    layer's FFN down rows, or its mLSTM out_proj rows, misaligned). Returns
    the accuracy."""
    from repro_torch.train.train_step import make_eval_step
    ev = make_eval_step(cfg)
    acc_masked, acc_compact = float(ev(masked, batch)), float(ev(compact,
                                                                 batch))
    rel = _sublayer_rel(cfg, masked, compact, batch)
    rel_fault = _sublayer_rel(cfg, masked,
                              misalign(compact, cfg.n_layers // 2), batch)
    widths = sorted({(_mixer_width(b, cfg), _ffn_width(b))
                     for b in compact["blocks"]})
    unit = ("experts" if any("moe" in b for b in compact["blocks"])
            else "d_ff")
    names = {"attn": "kv heads", "mamba": "mamba channels",
             "mlstm": "mlstm heads", "slstm": "slstm d_model"}
    mixer = "/".join(sorted({names[k] for b in compact["blocks"]
                             for k in names if k in b}))
    planted = ("FFN down" if misalign is _misalign_ffn
               else "mLSTM out_proj")
    print(f"[hqp] {what}, mask == compact: accuracy {acc_masked:.4f} "
          f"(masked) vs {acc_compact:.4f} (compacted); worst layer "
          f"output |masked - compacted| / |masked| {rel:.4g} (limit "
          f"{SUBLAYER_REL}), "
          f"{rel_fault:.4g} with layer {cfg.n_layers // 2}'s {planted} rows "
          f"misaligned; compacted ({mixer}, {unit}) {widths} of "
          f"({_mixer_width(masked['blocks'][0], cfg)}, "
          f"{_ffn_width(masked['blocks'][0])})  [{card}]")
    if acc_masked != acc_compact:
        fail(f"{what}: masked accuracy {acc_masked}, compacted "
             f"{acc_compact}")
    if not rel <= SUBLAYER_REL:
        fail(f"{what}: a compacted layer's output {rel:.4g} off the masked "
             f"model's, over {SUBLAYER_REL}")
    if not rel_fault > SUBLAYER_REL:
        fail(f"{what}: the mask == compact check passes a planted fault "
             f"({rel_fault:.4g} <= {SUBLAYER_REL})")
    return acc_masked


def phase_compress(cfg, dev, kernels, card):
    """The launcher's HQP pipeline at full width on the card, from launch
    counts at 0: a one-batch Fisher pass and PRUNE_STEPS conditional prune
    steps (each forward through the flash kernel, 28 launches), compaction
    and PTQ. The masked model and the compacted one must compute the same
    function (``_mask_vs_compact``).

    On random weights the Fisher ranking drops no unit of the first layers
    in 15 %, so the uniform keep count leaves every width whole. A second
    artifact, cut from the same ranking per layer (1-2 KV heads and
    37 + 3·layer FFN columns each), gives ragged widths: Hkv 7 of 8 and
    d_ff 3035 of 3072. Returns (the launcher's manifest, its INT8 params,
    the per-layer cut's INT8 params, the flash kernel's launches)."""
    import torch
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.core import pruning as pr
    from repro_torch.launch.serve import _calib_batch, build_artifact
    from repro_torch.models import lm
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    art = build_artifact(params, cfg, PRUNE_STEPS, log=print)
    wall = time.monotonic() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    m, sec = art.manifest, art.seconds
    print(m.summary())
    n_forward = 1 + len(sec["evals"])          # the Fisher pass + each eval
    print(f"[hqp] {cfg.name} full width, random weights (seed 0), batch "
          f"({CALIB_B}, {CALIB_S}): {wall:.2f} s in all; Fisher "
          f"{sec['fisher']:.3f} s, evals "
          f"{', '.join(f'{t:.3f}' for t in sec['evals'])} s (baseline, then "
          f"one a prune step), compact {sec['compact']:.3f} s, PTQ "
          f"{sec['ptq']:.3f} s; flash kernel launches "
          f"{launches['flash_attention']} over {n_forward} forwards, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
    if launches["flash_attention"] != cfg.n_layers * n_forward:
        fail(f"compress: {launches['flash_attention']} flash launches, "
             f"expected {cfg.n_layers} x {n_forward}")
    stray = [n for n, c in launches.items()
             if c and n != "flash_attention"]
    if stray:
        fail(f"compress: serving kernels launched on the train route: "
             f"{stray}")
    if not m.pruned or not (len(m.history) == PRUNE_STEPS
                            or not m.history[-1]["accepted"]):
        fail(f"compress: {len(m.history)} conditional steps, the last "
             f"accepted, of {PRUNE_STEPS}")
    batch = _calib_batch(cfg, CALIB_B, CALIB_S, device=dev)
    res = art.prune
    acc = _mask_vs_compact(cfg, res.params_sparse, res.params_compact, batch,
                           "launcher's artifact", card)
    if acc != m.a_final:
        fail(f"compress: masked accuracy {acc}, the pipeline's {m.a_final}")

    kv_heads = lambda g: 1 + g % 2
    ranked, n = _per_layer_ranking(res.ranked, lambda i, spec: (
        kv_heads(i // 2) if spec.kind == "kv_head" else 37 + 3 * (i // 2)))
    manifest, deploy = m, art.params
    del art, res                             # free the FP trees
    masked = pr.apply_prune_masks(params, ranked, n)
    compact = pr.compact_params(masked, ranked, n)
    del params
    _mask_vs_compact(cfg, masked, compact, batch, "per-layer cut", card)
    return (manifest, deploy, quantize_lm_params(compact),
            launches["flash_attention"])


def _differ(a, b) -> list:
    """Indices of the leaves of two trees of one structure whose shape,
    dtype or bits differ (bits: -0.0 is not 0.0, a NaN equals its bits)."""
    import torch
    from repro_torch import tree

    def bits(t):
        if not t.is_floating_point():
            return t
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return [f"{len(la)} leaves vs {len(lb)}"]
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(bits(x), bits(y))]


def phase_train(cfg, dev, kernels, card):
    """Train, then compress once and serve many, at full width on the card,
    through the port's entry points (``launch/quickstart.py``'s corpus,
    ``make_train_step``, ``launch/checkpoint.py``, ``compress``):

    - TRAIN_STEPS AdamW steps (f32 moments) on the quickstart's corpus, from
      launch counts at 0: 28 B7 launches a step and no serving kernel;
    - a checkpoint RESUME_BACK steps before the end, restored and replayed
      on the same batches: params and moments equal to the uninterrupted
      run bit for bit;
    - the Fisher pass over the quickstart's 4 calibration batches and
      Algorithm 1 at its Δ_ax on the validation set: the baseline at least
      TRAIN_ACC_MIN, a history ending in a REJECT, every accepted drop
      within Δ_ax, 28 B7 launches a forward; then INT8 PTQ;
    - the artifact saved and loaded back (arrays bit-equal, manifest
      equal), served contiguous and paged with INT8 KV (``serve_once``:
      engine == serial, graphs replayed) on prompts from the validation
      set, every token equal to serial decode of the in-memory artifact.
    Returns (the serve runs as (runs, engine, label), the B7 launches of
    the training steps, the trained pair for ``phase_spec``: the trained
    bf16 params, the loaded artifact's params, the served requests; and
    the directory holding the saved artifact, ``<dir>/artifact``, which
    ``phase_service`` serves and the caller removes)."""
    import tempfile

    import torch
    from repro_torch.compress.artifact import compress
    from repro_torch.launch import checkpoint as ckpt
    from repro_torch.launch import quickstart as qs
    from repro_torch.models import lm
    from repro_torch.serving import Request, serial_decode
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    sec = {}

    def clock(stage, t0):
        torch.cuda.synchronize()
        sec[stage] = sec.get(stage, 0.0) + time.monotonic() - t0

    def counts_zero():
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0

    def launched():
        return {name: kern.launches for name, kern in kernels.items()}

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    data, val = qs.corpus(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm.init_params(cfg, seed=0, device=dev)
    ocfg = AdamWConfig(lr=TRAIN_LR)
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg)
    batches = qs.train_batches(data, TRAIN_STEPS, dev)
    clock("init", t0)
    resume_at = TRAIN_STEPS - RESUME_BACK
    losses = {}
    counts_zero()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.monotonic()
        for i, batch in enumerate(batches):
            if i == resume_at:
                clock("train", t0)
                t0 = time.monotonic()
                ckpt.save(tmp, i, (params, opt))
                clock("checkpoint save", t0)
                t0 = time.monotonic()
            params, opt, m = step(params, opt, batch)
            if i % 60 == 0 or i == TRAIN_STEPS - 1:
                losses[i] = float(m["loss"])
                print(f"[train] step {i} loss {losses[i]:.4f}")
        clock("train", t0)
        train_launches = launched()
        peak = torch.cuda.max_memory_allocated(dev)
        if not all(math.isfinite(v) for v in losses.values()):
            fail(f"train: non-finite loss {losses}")
        if train_launches["flash_attention"] != cfg.n_layers * TRAIN_STEPS:
            fail(f"train: {train_launches['flash_attention']} flash "
                 f"launches over {TRAIN_STEPS} steps, expected "
                 f"{cfg.n_layers} a step")
        stray = [n for n, c in train_launches.items()
                 if c and n != "flash_attention"]
        if stray:
            fail(f"train: serving kernels launched: {stray}")
        ckpt_bytes = sum(f.stat().st_size for f in
                         pathlib.Path(tmp).rglob("*") if f.is_file())
        t0 = time.monotonic()
        (p2, o2), meta = ckpt.restore(tmp, (params, opt))
        clock("checkpoint restore", t0)
        t0 = time.monotonic()
        for batch in batches[meta["step"]:]:
            p2, o2, _ = step(p2, o2, batch)
        clock("resume replay", t0)
        bad = _differ((params, opt), (p2, o2))
        del p2, o2
    if bad:
        fail(f"resume from step {resume_at}: {len(bad)} leaves of params "
             f"and moments differ from the uninterrupted run's (first "
             f"{bad[:5]})")
    roofline_check(
        f"{cfg.name} train step, batch {qs.BATCH} x {qs.SEQ}, AdamW f32 "
        f"moments (measured: the mean synchronised step)",
        lambda where: step(*(((params, opt, batches[0]) if where == "cuda"
                              else _meta((params, opt, batches[0]))))),
        1e3 * sec["train"] / TRAIN_STEPS, card)
    del opt, batches
    train_s = sec["train"]
    tokens_per_step = qs.BATCH * qs.SEQ
    print(f"[train] {cfg.name} full width, batch {qs.BATCH} x {qs.SEQ}, "
          f"AdamW f32 moments, lr {TRAIN_LR}: {TRAIN_STEPS} steps in "
          f"{train_s:.3f} s, {1e3 * train_s / TRAIN_STEPS:.2f} ms a step "
          f"(synchronised), {tokens_per_step * TRAIN_STEPS / train_s:.0f} "
          f"tokens/s, peak device memory {peak / 2**30:.2f} GiB; loss "
          f"{json.dumps(losses)}; flash launches "
          f"{train_launches['flash_attention']} ({cfg.n_layers} a step)  "
          f"[{card}]")
    print(f"[train] resume: checkpoint of step {resume_at} ({ckpt_bytes} B "
          f"on disk) saved in {sec['checkpoint save']:.2f} s, restored in "
          f"{sec['checkpoint restore']:.2f} s, {RESUME_BACK} steps replayed "
          f"in {sec['resume replay']:.2f} s: params and moments equal to "
          f"the uninterrupted run bit for bit  [{card}]")

    # ---- Algorithm 1 deciding on the trained model, then INT8 PTQ
    counts_zero()
    t0 = time.monotonic()
    sq = qs.fisher(cfg, params, data, dev)
    clock("fisher", t0)
    accuracy = qs.accuracy_fn(cfg, val, dev)
    evals = []

    def eval_fn(p):
        t0 = time.monotonic()
        acc = accuracy(p)
        evals.append(time.monotonic() - t0)
        return acc

    t0 = time.monotonic()
    art = compress(params, cfg, sq_grads=sq, eval_fn=eval_fn, hqp=qs.HQP,
                   log=print)
    clock("compress", t0)
    hqp_launches = launched()
    del sq
    m, hist = art.manifest, art.manifest.history
    n_val = len(val.seqs) // qs.BATCH
    n_forward = qs.N_CALIB + n_val * len(evals)
    if hqp_launches["flash_attention"] != cfg.n_layers * n_forward:
        fail(f"trained compress: {hqp_launches['flash_attention']} flash "
             f"launches, expected {cfg.n_layers} x {n_forward} forwards")
    if m.a_baseline < TRAIN_ACC_MIN:
        fail(f"trained model: baseline accuracy {m.a_baseline:.4f} under "
             f"{TRAIN_ACC_MIN}")
    if not hist or hist[-1]["accepted"]:
        fail(f"trained compress: the history does not end in a REJECT "
             f"({len(hist)} steps)")
    over = [h for h in hist if h["accepted"]
            and not h["drop"] <= qs.HQP.delta_ax]
    if over or not all(h["accepted"] for h in hist[:-1]):
        fail(f"trained compress: accepted steps over Δ_ax {over}")
    t0 = time.monotonic()
    a_int8 = accuracy(art.params)
    clock("int8 eval", t0)
    print(m.summary())
    print(f"[hqp] trained {cfg.name}: baseline accuracy {m.a_baseline:.4f}"
          f" (ceiling {data.best_acc}); history (θ, accuracy, drop, "
          f"decision) "
          + ", ".join(f"({h['theta']:.2f}, {h['accuracy']:.4f}, "
                      f"{h['drop']:+.4f}, "
                      f"{'ACCEPT' if h['accepted'] else 'REJECT'})"
                      for h in hist)
          + f"; kept θ {m.theta:.2%} at accuracy {m.a_final:.4f}; INT8 "
          f"accuracy {a_int8:.4f} (drop {m.a_baseline - a_int8:+.4f}); "
          f"bytes {m.bytes_before} -> {m.bytes_after}; Fisher "
          f"{sec['fisher']:.3f} s, evals "
          f"{', '.join(f'{t:.3f}' for t in evals)} s, compact "
          f"{art.seconds['compact']:.3f} s, PTQ {art.seconds['ptq']:.3f} s; "
          f"flash launches {hqp_launches['flash_attention']} over "
          f"{n_forward} forwards  [{card}]")

    # ---- compress once, serve many; the artifact stays on disk for
    # phase_service's launcher (the caller removes it)
    art_dir = tempfile.mkdtemp(dir=scratch)
    t0 = time.monotonic()
    path = ckpt.save_artifact(f"{art_dir}/artifact", art)
    clock("artifact save", t0)
    art_bytes = sum(f.stat().st_size for f in
                    pathlib.Path(path).rglob("*") if f.is_file())
    t0 = time.monotonic()
    loaded = ckpt.load_artifact(path, device=dev)
    clock("artifact load", t0)
    if loaded.manifest != m:
        fail("artifact: the loaded manifest differs from the saved one")
    bad = _differ(art.params, loaded.params)
    if bad:
        fail(f"artifact: {len(bad)} arrays differ after save and load "
             f"(first {bad[:5]})")
    print(f"[artifact] {art_bytes} B saved in {sec['artifact save']:.2f} s, "
          f"loaded in {sec['artifact load']:.2f} s: arrays bit-equal, "
          f"manifest equal  [{card}]")
    reqs = [Request(prompt=val.seqs[i, :16 + 4 * i].tolist(),
                    max_new_tokens=PRUNED_NEW)
            for i in range(PRUNED_REQUESTS)]
    arrivals = [0.02 * i for i in range(PRUNED_REQUESTS)]
    in_memory = [serial_decode(art.params, cfg, r.prompt, r.max_new_tokens,
                               max_seq=SERVE_MAX_SEQ, quantized_kv=True,
                               device=dev) for r in reqs]
    served = []
    for page_size, must, must_not in (
            (None, DENSE + CONTIGUOUS, PAGED + UNFUSED),
            (SERVE_PAGE, DENSE + PAGED, CONTIGUOUS + UNFUSED)):
        t0 = time.monotonic()
        # the loaded arrays are the in-memory ones bit for bit (above), so
        # serial decode of the in-memory artifact is the loaded one's too
        runs, eng = serve_once(loaded.params, cfg, dev, kernels, reqs, must,
                               must_not, arrivals_s=arrivals, runs=1,
                               want=in_memory, quantized_kv=True,
                               page_size=page_size)
        clock("serve", t0)
        if runs[0]["tokens"] != in_memory:
            fail(f"loaded artifact, page_size {page_size}: tokens differ "
                 f"from serial decode of the in-memory artifact")
        served.append((runs, eng, f"trained HQP artifact (θ={m.theta:.1%}),"
                       f" saved and loaded, kv=int8"
                       + (f" page={page_size}" if page_size
                          else " contiguous")))
    # the continuations follow the chain the model learned
    follow = [tok == val.succ[prev, 0]
              for r, toks in zip(reqs, in_memory)
              for prev, tok in zip([r.prompt[-1]] + toks[:-1], toks)]
    print(f"[serve] trained artifact: {sum(follow)} of {len(follow)} "
          f"generated tokens are the chain's most likely successor  "
          f"[{card}]")
    if sum(follow) < TRAIN_ACC_MIN * len(follow):
        fail(f"trained artifact: {sum(follow)} of {len(follow)} generated "
             f"tokens follow the chain")
    print(f"[train] stage seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sec.items())
          + f"  [{card}]")
    return (served, train_launches["flash_attention"],
            (params, loaded.params, reqs), art_dir)


def shared_prompt_load(cfg):
    """Request 0 is a SHARED_HEAD-token head plus a tail of 8; the other
    SHARED_N - 1 share the head, with distinct tails of 8-16 tokens, and
    arrive on the tick after request 0's prefill ends (its last chunk
    inserts the head into the prefix cache)."""
    import torch
    from repro_torch.serving import Request
    gen = torch.Generator().manual_seed(1)
    head = _tokens(cfg, SHARED_HEAD, gen)
    reqs = [Request(head + _tokens(cfg, 8 + (i * 5) % 9, gen),
                    max_new_tokens=SERVE_NEW) for i in range(SHARED_N)]
    first = -(-len(reqs[0].prompt) // SERVE_CHUNK)
    return reqs, [0] + [first] * (SHARED_N - 1)


def long_prompt_load(cfg):
    """LONG_PROMPTS-token random prompts of LONG_NEW new tokens each,
    arriving together."""
    import torch
    from repro_torch.serving import Request
    gen = torch.Generator().manual_seed(3)
    return [Request(_tokens(cfg, n, gen), max_new_tokens=LONG_NEW)
            for n in LONG_PROMPTS]


def _tokens(cfg, n, gen):
    import torch
    return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()


def _group(name: str, kernels) -> str:
    for k in kernels:
        if k + "_kernel" in name:       # the paged twins share the body
            return "paged_" + k if "PagedAddr" in name else k
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "cublas", "xmma", "nvjet")):
        return "cublas"
    return "torch_other"


def _graph_delta(eng, before) -> dict:
    return {k: eng.stats[k] - before[k] for k in GRAPH_STATS}


LAYOUTS = (("contiguous", None), ("paged", SERVE_PAGE))


def _meta(tree):
    """``tree``'s tensors as meta tensors of their shapes and dtypes (a
    ``QuantizedLinear``'s too): the same work, counted without values."""
    import torch
    from repro_torch.compress.qtypes import QuantizedLinear
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(_meta(tree.w_q), _meta(tree.scale), tree.bits)
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def roofline_check(what, run, measured_ms, card, tag="[roofline]"):
    """Count ``run(device)``'s work (``roofline/cost.py``) on the card and on
    the meta device: the two counts must be equal (flops, INT8 flops,
    bytes). Print the count, its lower bound on CHIP, the measured ms and
    their share; fail if the share passes ROOFLINE_SHARE_MAX."""
    import torch
    from repro_torch.roofline import cost
    counts = {}
    for where in ("cuda", "meta"):
        t0 = time.monotonic()
        with cost.record() as c:
            run(where)
            if where == "cuda":
                torch.cuda.synchronize()
        counts[where] = (c, time.monotonic() - t0)
    c, m = counts["cuda"][0], counts["meta"][0]
    if c.counts() != m.counts():
        fail(f"{what}: the card's count {c.counts()} differs from the meta "
             f"device's {m.counts()}")
    terms = cost.roofline_terms(c, CHIP)
    bound_ms = terms["step_time_lower_bound_s"] * 1e3
    share = bound_ms / measured_ms
    print(f"{tag} {what}: flops {c.flops} (INT8 {c.int8_dot_flops}), bytes "
          f"{c.bytes}, {sum(c.ops.values())} ops counted; lower bound "
          f"{bound_ms:.5f} ms on {CHIP.name} ({terms['dominant']}; compute "
          f"{terms['t_compute'] * 1e3:.5f}, memory "
          f"{terms['t_memory'] * 1e3:.5f} ms), measured {measured_ms:.5f} "
          f"ms, share {share:.4f}; card count == meta count (counted in "
          f"{counts['cuda'][1]:.2f} s and {counts['meta'][1]:.2f} s)  "
          f"[{card}]")
    if share > ROOFLINE_SHARE_MAX:
        fail(f"{what}: the measured {measured_ms:.5f} ms beats the lower "
             f"bound {bound_ms:.5f} ms (share {share:.3f} > "
             f"{ROOFLINE_SHARE_MAX}): the count is wrong")
    return {"flops": c.flops, "int8_dot_flops": c.int8_dot_flops,
            "bytes": c.bytes, "bound_ms": bound_ms,
            "measured_ms": measured_ms, "share": share}


def _serve_state(params, cfg, where, rows, pos, quantized_kv=True):
    """A decode state of ``rows`` slots at position ``pos`` on ``where``,
    sized from ``params``, as the engine's pool."""
    from repro_torch.models import lm
    st = lm.init_decode_state(cfg, rows, SERVE_MAX_SEQ, params,
                              per_slot_pos=True, quantized_kv=quantized_kv,
                              device=where)
    st["pos"].fill_(pos)
    return st


def roofline_serving(params, cfg, decode_ms, chunk_ms, card, tag):
    """The counted work of the profiled steady decode step (SERVE_SLOTS
    slots past SERVE_PROMPT, INT8 KV) and of the timed prefill chunk (the
    second SERVE_CHUNK of one slot), each at the smallest window the
    profile's engine gave them, on the card and on the meta device."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    sched = Scheduler(SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                      decode_steps=SERVE_STEPS))
    meta = _meta(params)

    def decode(where):
        p = params if where == "cuda" else meta
        st = _serve_state(p, cfg, where, SERVE_SLOTS, SERVE_PROMPT)
        tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=where)
        lm.decode_step(p, cfg, st, tok, route="decode",
                       window=sched.visible_window(
                           SERVE_PROMPT + SERVE_STEPS, SERVE_MAX_SEQ))

    def chunk(where):
        p = params if where == "cuda" else meta
        st = _serve_state(p, cfg, where, 1, SERVE_CHUNK)
        tok = torch.zeros((1, SERVE_CHUNK), dtype=torch.long, device=where)
        lm.decode_step(p, cfg, st, tok, route="prefill",
                       window=sched.visible_window(2 * SERVE_CHUNK,
                                                   SERVE_MAX_SEQ))
    return {"decode_step": roofline_check(
                f"{cfg.name} INT8 decode step, {SERVE_SLOTS} slots at "
                f"{SERVE_PROMPT}, INT8 KV (eager; measured: the replayed "
                f"step)", decode, decode_ms, card, tag),
            "prefill_chunk": roofline_check(
                f"{cfg.name} INT8 prefill chunk, {SERVE_CHUNK} queries at "
                f"{SERVE_CHUNK}, INT8 KV (eager; measured: the replayed "
                f"chunk's host ms)", chunk, chunk_ms, card, tag)}


def dryrun_start():
    """The dry-run phase, started in a subprocess on the meta device (CPU
    only: it launches nothing on the card): DRYRUN_ARCHS at every shape,
    baseline and hqp, on the 1x1 plan of this card. Returns the process;
    ``dryrun_finish`` reads it."""
    code = (
        "import sys, json, time, torch\n"
        "t0 = time.monotonic()\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.configs import LM_SHAPES\n"
        f"for arch in {list(DRYRUN_ARCHS)!r}:\n"
        "    for shape in LM_SHAPES:\n"
        f"        for variant in {list(DRYRUN_VARIANTS)!r}:\n"
        "            rec = dryrun.run_cell(arch, shape.name, '1x1', variant,\n"
        "                                  device='cuda', save=True)\n"
        "            print('RECORD ' + json.dumps(rec, default=str),\n"
        "                  flush=True)\n"
        "print(f'ELAPSED {time.monotonic() - t0:.1f}', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    # files, not pipes: nothing reads the output until the phase ends
    out = open(ROOT / "build" / "dryrun_stdout.txt", "w+")
    err = open(ROOT / "build" / "dryrun_stderr.txt", "w+")
    def child():
        _die_with_parent()
        os.nice(19)         # the card's phases' host work goes first

    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=out, stderr=err, text=True,
                            preexec_fn=child)


def dryrun_finish(proc, card):
    """Wait for the dry-run subprocess; a line per cell with its dominant
    term and ``fits_one_card``; fail if a cell errored or the process
    did."""
    t0 = time.monotonic()
    try:
        proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("dry run: the subprocess did not finish in 300 s")
    out = (ROOT / "build" / "dryrun_stdout.txt").read_text()
    err = (ROOT / "build" / "dryrun_stderr.txt").read_text()
    if proc.returncode:
        fail(f"dry run: the subprocess exited {proc.returncode}: "
             f"{err[-2000:]}")
    recs = [json.loads(line[len("RECORD "):]) for line in out.splitlines()
            if line.startswith("RECORD ")]
    want = len(DRYRUN_ARCHS) * 4 * len(DRYRUN_VARIANTS)
    if len(recs) != want:
        fail(f"dry run: {len(recs)} records of {want}")
    for r in recs:
        if r["status"] == "error":
            fail(f"dry run {r['cell']}: {r['error']}")
        if r["status"] == "skipped":
            print(f"[dryrun] {r['cell']}: skipped ({r['reason']})")
            continue
        rf, mem = r["roofline"], r["memory"]
        print(f"[dryrun] {r['cell']}: dominant {rf['dominant']}, lower "
              f"bound {rf['step_time_lower_bound_s']:.6g} s (compute "
              f"{rf['t_compute']:.6g}, memory {rf['t_memory']:.6g}), flops "
              f"{rf['hlo_flops_per_device']} (INT8 "
              f"{rf['hlo_int8_flops_per_device']}), model flops "
              f"{rf['model_flops']}, arguments {mem['argument_bytes']} B + "
              f"peak live {mem['temp_bytes']} B, fits_one_card "
              f"{mem['fits_one_card']} (on {CHIP.name}, {CHIP.hbm_bytes:.0f} "
              f"B), traced in {r['trace_s']} s  [{card}]")
    took = [line.split()[1] for line in out.splitlines()
            if line.startswith("ELAPSED ")]
    print(f"[dryrun] {len(recs)} cells "
          f"({sum(r['status'] == 'ok' for r in recs)} traced) in a "
          f"subprocess on the meta device: {took[0] if took else '?'} s "
          f"of its own beside the card's phases, "
          f"{time.monotonic() - t0:.1f} s waited for  [{card}]")


def phase_profile(params, cfg, dev, kernels, prompt_len=SERVE_PROMPT,
                  layouts=LAYOUTS, prof_ticks=1):
    """Where a steady decode dispatch's time goes, contiguous against paged
    (pages of SERVE_PAGE; ``layouts``): SERVE_SLOTS requests of
    ``prompt_len`` tokens, all decoding, INT8 KV, one engine per layout on
    the same prompts, in two passes over the same
    positions. In each pass, after one warming tick, PROFILE_TICKS
    dispatches of each are timed on the host clock (each ends in the
    engine's one host sync), the two layouts taking turns in the order C P P
    C ..., so a drift of the shared host lands on both. The first pass is
    cold: a window's first dispatch runs eagerly and its second captures,
    and the eager ones are reported as the first use. The second pass (the
    same requests once the first finished, prefix cache cleared) must
    replay every timed dispatch, which the engine's stats show; then
    ``prof_ticks`` more replayed dispatches of each run under
    torch.profiler, whose device
    kernel time is summed by group. Device busy over the unprofiled host
    wall gives the idle share (``_per``)."""
    import torch
    from repro_torch.serving import Engine, Request, SchedulerConfig
    rng = torch.Generator().manual_seed(0)
    prompts = [_tokens(cfg, prompt_len, rng) for _ in range(SERVE_SLOTS)]
    # the first token comes from prefill; then the warming, timed and
    # profiled dispatches, after which every request is done
    n_new = 1 + (1 + PROFILE_TICKS + prof_ticks) * SERVE_STEPS
    engines = {}
    for layout, page_size in layouts:
        engines[layout] = Engine(
            params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
            sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                  decode_steps=SERVE_STEPS),
            quantized_kv=True, device=dev, page_size=page_size)

    def tick(eng):
        eng.step()
        torch.cuda.synchronize(dev)

    steps = PROFILE_TICKS * SERVE_STEPS
    order = list(engines)
    passes = {}
    for name in ("cold", "warm"):
        for eng in engines.values():
            if eng.prefix is not None:
                eng.prefix.clear()
            for prompt in prompts:
                eng.submit(Request(prompt, n_new))
            while any(slot.stage != "decode" for slot in eng.slots):
                tick(eng)
            tick(eng)                                   # warm the decode path
        ticks = {layout: [] for layout in engines}
        launches = {layout: dict.fromkeys(kernels, 0) for layout in engines}
        for i in range(PROFILE_TICKS):
            for layout in (order if i % 2 == 0 else order[::-1]):
                eng = engines[layout]
                for kern in kernels.values():
                    kern.launches = 0
                before = dict(eng.stats)
                t0 = time.monotonic()
                tick(eng)
                ticks[layout].append((time.monotonic() - t0,
                                      _graph_delta(eng, before)))
                for n, kern in kernels.items():
                    launches[layout][n] += kern.launches
        passes[name] = ticks, launches
        if name == "warm":
            break
        for eng in engines.values():
            while eng.has_work:
                tick(eng)
    out = {}
    for layout, eng in engines.items():
        warm, launches = passes["warm"][0][layout], passes["warm"][1][layout]
        if any(d["graph_replays"] != 1 or d["eager_dispatches"]
               or d["graphs_captured"] for _, d in warm):
            fail(f"profile {layout}: a timed warm dispatch was not a graph "
                 f"replay: {[d for _, d in warm]}")
        cold = passes["cold"][0][layout]
        eager = [t for t, d in cold if d["eager_dispatches"]]
        captured = [t for t, d in cold if d["graphs_captured"]]
        before = dict(eng.stats)
        prof_steps = prof_ticks * SERVE_STEPS
        prof = _profiled(lambda: [tick(eng) for _ in range(prof_ticks)],
                         kernels)
        if _graph_delta(eng, before)["graph_replays"] != prof_ticks:
            fail(f"profile {layout}: the profiled dispatches were not all "
                 f"replays")
        step_ms = sum(t for t, _ in warm) / steps * 1e3
        out[layout] = {
            "replayed": True,
            "decode_step_ms": step_ms,
            "tokens_per_s": SERVE_SLOTS / step_ms * 1e3,
            "eager_first_use_step_ms": (sum(eager) / len(eager)
                                        / SERVE_STEPS * 1e3
                                        if eager else None),
            "capture_dispatch_ms": (sum(captured) / len(captured) * 1e3
                                    if captured else None),
            "cold_pass": {k: sum(d[k] for _, d in cold)
                          for k in GRAPH_STATS},
            "port_launches_per_step": {n: c / steps for n, c
                                       in launches.items()},
            **_per(prof, prof_steps, "step", step_ms),
        }
    return out


def _profiled(run, kernels):
    """``run`` under torch.profiler: the host wall ms around it, the number
    of device kernels and their device ms summed by group (each port
    kernel a group, 0 where it did not run). Prints the PROFILE_TOP
    kernels by device ms."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        wall_ms = (time.monotonic() - t0) * 1e3
    groups, n_kernels, by_name = dict.fromkeys(kernels, 0.0), 0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms = evt.time_range.elapsed_us() / 1e3
            g = _group(evt.name, kernels)
            groups[g] = groups.get(g, 0.0) + ms
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
            n_kernels += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    print("[profile] top device kernels (ms in the profiled run): "
          + "; ".join(f"{n[:70]} {ms:.4f}" for n, ms in top))
    return dict(wall_ms=wall_ms, n_kernels=n_kernels, groups=groups)


def _per(prof, n, unit, host_ms):
    """A ``_profiled`` result per ``unit`` (n of them). The idle share is
    the device busy ms a unit over ``host_ms``, the host wall ms a unit
    timed without the profiler: its tracing stretches a replayed graph
    (the profiled wall is ~10x the unprofiled one a decode step), while
    the kernels' own durations stay those of the eager runs."""
    busy_ms = sum(prof["groups"].values())
    return {
        f"profiled_device_kernels_per_{unit}": prof["n_kernels"] / n,
        f"profiled_wall_ms_per_{unit}": prof["wall_ms"] / n,
        f"device_busy_ms_per_{unit}": busy_ms / n,
        "device_idle_share": (1 - busy_ms / n / host_ms if busy_ms
                              else None),
        f"device_ms_per_{unit}_by_group": {
            g: v / n for g, v in sorted(prof["groups"].items())},
    }


def phase_profile_prefill(params, cfg, dev, kernels):
    """Where a full-width prefill chunk's time goes: one request with a
    PREFILL_PROFILE_PROMPT-token prompt, INT8 KV, chunks of SERVE_CHUNK,
    contiguous and paged (pages of SERVE_PAGE), run three times through
    slot 0 (prefix cache cleared between). The first pass runs each chunk's
    key eagerly (its second chunk timed on the host clock as the first
    use), the second captures; the third must replay all four chunks: its
    second is timed on the host clock and its last two run under
    torch.profiler, whose device kernel time is summed by group (B4/B6 are
    ``prefill_attention`` / ``paged_prefill_attention``). Device busy over
    the unprofiled host wall gives the idle share (``_per``)."""
    import torch
    from repro_torch.serving import Engine, Request, SchedulerConfig
    prompt = _tokens(cfg, PREFILL_PROFILE_PROMPT,
                     torch.Generator().manual_seed(2))
    out = {}
    for layout, page_size in (("contiguous", None), ("paged", SERVE_PAGE)):
        eng = Engine(params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                     sched=SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                                           decode_steps=SERVE_STEPS),
                     quantized_kv=True, device=dev, page_size=page_size)

        def tick():
            eng.step()
            torch.cuda.synchronize(dev)

        def timed_tick():
            t0 = time.monotonic()
            tick()
            return (time.monotonic() - t0) * 1e3

        for name in ("eager", "capture", "replay"):
            if eng.prefix is not None:
                eng.prefix.clear()
            eng.submit(Request(prompt, 8))
            before = dict(eng.stats)
            tick()
            host_ms = timed_tick()
            if name == "eager":
                eager_ms = host_ms
            if name != "replay":
                while eng.has_work:
                    tick()
        for kern in kernels.values():
            kern.launches = 0
        prof = _profiled(lambda: [tick() for _ in range(2)], kernels)
        kern = "paged_prefill_attention" if page_size else "prefill_attention"
        graphs = _graph_delta(eng, before)
        chunks = eng.stats["prefill_ticks"] - before["prefill_ticks"]
        decodes = eng.stats["decode_ticks"] - before["decode_ticks"]
        if (chunks != 4 or decodes or graphs["graph_replays"] != 4
                or graphs["eager_dispatches"] or graphs["graphs_captured"]
                or kernels[kern].launches != 2 * cfg.n_layers):
            fail(f"prefill profile {layout}: {chunks} prefill ticks, "
                 f"{decodes} decode ticks, graphs {graphs}, "
                 f"{kernels[kern].launches} {kern} launches in the profiled "
                 f"two; expected 4, 0, 4 replays and "
                 f"{2 * cfg.n_layers}")
        out[layout] = {
            "replayed": True,
            "chunk_host_ms": host_ms,
            "eager_first_use_chunk_host_ms": eager_ms,
            "port_launches_per_chunk": {n: k.launches / 2
                                        for n, k in kernels.items()},
            **_per(prof, 2, "chunk", host_ms),
        }
        while eng.has_work:
            tick()
    return out


def _times(o) -> str:
    lib = ("n/a" if o["library_ms"] is None else
           f"({o.get('library', 'SDPA')}) {o['library_ms']:.5f}")
    return (f"kernel {o['ms']:.5f} ms (device), wrapper {o['wrapper_ms']:.4f} "
            f"ms, plain {o['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{o['bound_ms']:.6f} ms ({o['bound_by']})")


# ------------------------------------------------------------ speculative
def _first_diff(a, b) -> int:
    return next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _top2_gap(params, cfg, prompt, tokens, dev) -> float:
    """The gap between the top two real-vocab logits after ``prompt`` and
    ``tokens``: whole-prompt prefill, then one-token steps on the prefill
    route (the speculative oracle's path)."""
    import torch
    from repro_torch.models import lm
    state = lm.init_decode_state(cfg, 1, SERVE_MAX_SEQ, params=params,
                                 device=dev)
    logits, state = lm.decode_step(params, cfg, state,
                                   torch.tensor([prompt], device=dev),
                                   route="prefill")
    for tok in tokens:
        logits, state = lm.decode_step(params, cfg, state,
                                       torch.tensor([[tok]], device=dev),
                                       route="prefill")
    top = torch.topk(logits[0, -1, :cfg.vocab_size], 2).values
    return (top[0] - top[1]).item()


def spec_expect(cfg, drafter):
    """The launches of a speculative run (``serve_once``'s ``expect``): a
    prefill chunk runs both pools' prefill attends and the drafter's W8A8
    linears (the bf16 verifier has none); a cycle runs the healing chunk's
    and the verify's prefill attends, k - 1 drafter decode attends and the
    drafter's linears k times (``device_steps`` counts k + 1 a cycle,
    ``spec_cycles`` the cycles)."""
    n_lin = _n_linears(drafter)

    def expect(d, attend):
        chunks, cycles, steps = (d["prefill_ticks"], d["spec_cycles"],
                                 d["device_steps"])
        return {"int8_matmul_quant": n_lin * (chunks + steps - cycles),
                attend % "decode": cfg.n_layers * (steps - 2 * cycles),
                attend % "prefill": cfg.n_layers * 2 * (chunks + cycles)}
    return expect


def serve_spec(verifier, drafter, cfg, dev, kernels, reqs, must, must_not,
               want, runs, **kw):
    """``serve_once`` through the speculative engine: ``verifier`` the
    bf16 params with bf16 KV, ``drafter`` the INT8 artifact with INT8 KV,
    k SPEC_K, SPEC_CYCLES cycles a dispatch; each request must give
    ``want``."""
    return serve_once(verifier, cfg, dev, kernels, reqs, must, must_not,
                      runs=runs, want=want, expect=spec_expect(cfg, drafter),
                      draft_params=drafter, spec_k=SPEC_K,
                      spec_cycles=SPEC_CYCLES, **kw)


def _run_name(runs, i) -> str:
    """"cold" for a load's first run of several, "warm" for its last when
    that one captured nothing (only replays and no eager first use),
    "last" when it still captured, "one" for a single run."""
    if len(runs) == 1:
        return "one"
    if i == 0:
        return "cold"
    r = runs[i]
    return ("warm" if not r["graphs_captured"] and not r["eager_dispatches"]
            else "last")


def _spec_line(runs, eng, label, card):
    for i in sorted({0, len(runs) - 1}):
        name = _run_name(runs, i)
        r = runs[i]
        sm = r["summary"]
        acc = r["accepted_tokens"] / max(r["drafted_tokens"], 1)
        print(f"[spec] {label}, {name} run ({i + 1} of {len(runs)}): "
              f"{sm['n_requests']} requests, {sm['out_tokens']} tokens, "
              f"{sm['tokens_per_s']:.2f} tok/s, TTFT p50 "
              f"{sm['ttft_p50_ms']:.1f} ms, latency p50 "
              f"{sm['latency_p50_ms']:.1f} ms, acceptance {acc:.4f} "
              f"({r['accepted_tokens']} of {r['drafted_tokens']} drafts), "
              f"{r['spec_cycles']} cycles, {r['device_steps']} device steps "
              f"/ {r['host_syncs']} host syncs, graphs "
              f"{r['graphs_captured']} captured / {r['graph_replays']} "
              f"replays / {r['eager_dispatches']} eager dispatches, "
              f"copy-on-write {r['cow_copies']}, launches "
              f"{ {n: c for n, c in r['launches'].items() if c} }  [{card}]")
    keys = {k: f"{len(v)} of {eng.graphs.bounds[k]}"
            for k, v in eng.graphs.keys.items()}
    print(f"[spec] {label}: graph keys {keys} ({sorted(eng.graphs.keys['spec'])}"
          f"), capture {eng.stats['capture_s']:.3f} s, graph pool "
          f"{eng.stats['graph_pool_bytes']} B  [{card}]")


def cow_load(cfg):
    """Two different COW_PROMPT-token prompts (whole pages of SERVE_PAGE)
    at tick 0, and the first again once both prefills ended: each first
    speculative dispatch's healing chunk writes into its prompt's last
    page, which the prefix cache holds."""
    import torch
    from repro_torch.serving import Request
    gen = torch.Generator().manual_seed(5)
    a, b = _tokens(cfg, COW_PROMPT, gen), _tokens(cfg, COW_PROMPT, gen)
    reqs = [Request(p, max_new_tokens=SERVE_NEW) for p in (a, b, a)]
    return reqs, [0, 0, 2 * COW_PROMPT // SERVE_CHUNK + 2]


def _b3_vs_b4(dev, card):
    """B3 and B4 on the same single query (Sq = 1) at the serve shape,
    SERVE_SLOTS slots at one start, INT8 and bf16 KV: max |diff| and
    whether they agree bit for bit (the speculative verify takes B4 where
    a serial decode step takes B3)."""
    import torch
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import prefill_attention as kp
    found = {}
    for quantized in (True, False):
        for st in B3_B4_STARTS:
            w = -(-(st + 1) // 16) * 16
            kv = _kv(dev, SERVE_SLOTS, w, 8, 64, quantized)
            q = torch.randn(SERVE_SLOTS, 1, 16, 64, device=dev).to(
                torch.bfloat16)
            start = torch.full((SERVE_SLOTS,), st, dtype=torch.int32,
                               device=dev)
            b3 = kd.decode_attention(q[:, 0], *kv, start)
            b4 = kp.prefill_attention(q, *kv, start)[:, 0]
            torch.cuda.synchronize()
            diff = (b3.float() - b4.float()).abs().max().item()
            key = f"{'int8' if quantized else 'bf16'} KV, start {st}, W {w}"
            found[key] = {"max_abs_diff": diff,
                          "bitwise_equal": bool(torch.equal(b3, b4))}
            print(f"[spec] B3 vs B4 at Sq = 1, q ({SERVE_SLOTS}, 16, 64), "
                  f"{key}: max |diff| {diff:.4g}, bitwise equal "
                  f"{found[key]['bitwise_equal']}  [{card}]")
    return found


def _verify_shape(dev, report, card):
    """B4 and B6 (pages of SERVE_PAGE) at the verify shape: q (SERVE_SLOTS,
    SPEC_K + 1, 16, 64) at the per-slot SPEC_VERIFY_STARTS, bf16 KV,
    against the plain version within the attention tolerances, B6 bit for
    bit against B4 on the gathered window; device times beside the plain
    version's, SDPA's and the bound, under ``verify_shape`` in the kernel's
    report entry."""
    import torch
    from repro_torch.kernels import prefill_attention as kp, ref
    from repro_torch.kernels.kv_layout import window_pages
    sq, starts = SPEC_K + 1, list(SPEC_VERIFY_STARTS)
    w = -(-(max(starts) + sq) // 16) * 16
    q = torch.randn(len(starts), sq, 16, 64, device=dev).to(torch.bfloat16)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    shape = (f"q ({len(starts)}, {sq}, 16, 64) at starts {starts} vs "
             f"(KV {w} positions, 8, 64), bf16 KV")
    kv = _kv(dev, len(starts), w, 8, 64, False)
    arena, table = _paged_case(dev, SERVE_PAGE, False,
                               [s + sq - 1 for s in starts],
                               max_seq=SERVE_MAX_SEQ)
    idx = window_pages(table, SERVE_PAGE, w).contiguous()
    gathered = _gathered(arena, idx)
    cases = {
        "prefill_attention": (
            lambda: kp.prefill_attention(q, *kv, start),
            lambda: ref.cached_attention_ref(q, *kv, start),
            _sdpa(q, kv[0], kv[1], start, sq), 0),
        "paged_prefill_attention": (
            lambda: kp.paged_prefill_attention(q, *arena, start, idx),
            lambda: ref.paged_prefill_attention_ref(q, *arena, start, idx),
            _sdpa(q, gathered[0], gathered[1], start, sq), idx.numel())}
    for name, (kern, plain, sdpa, n_table) in cases.items():
        errs = [0.0, 0.0]
        _attn_check(kern(), plain(), f"{name} at the verify shape", errs)
        b_ms, by = _prefill_bound(sq, starts, w, False, n_table)
        r = report[name]["verify_shape"] = dict(
            shape=shape + (f", pages of {SERVE_PAGE}" if n_table else ""),
            max_abs_err=errs[0], max_row_rel=errs[1], bound_ms=b_ms,
            bound_by=by, **timed(kern, plain, sdpa))
        print(f"[spec] {name} at the verify shape, {r['shape']}: "
              + _times(r) + f", max |err| {errs[0]:.3g}, worst row "
              f"{errs[1]:.4g}  [{card}]")
    _equal(cases["paged_prefill_attention"][0](),
           kp.prefill_attention(q, *gathered, start),
           "B6 vs B4 on the gathered window at the verify shape")


def phase_spec(cfg, dev, kernels, drafter, trained, report, card):
    """Sampling and self-speculative serving at full width, on the
    engine's CUDA graphs:

    - greedy speculative serving of the staggered load's first
      SPEC_REQUESTS requests, contiguous (SERVE_RUNS runs on one engine)
      and paged (VARIANT_RUNS): the verifier the bf16 seed-0 parent with
      bf16 KV, the drafter its INT8 PTQ artifact (``drafter``) with INT8
      KV, k SPEC_K, SPEC_CYCLES cycle a dispatch; every output equals
      serial decode of the verifier whose one-token steps take the prefill
      route, bit for bit (the verify pass is B4/B6).
      Against the decode-route serial decode (B3's steps) of the first
      SPEC_ROUTE_REQUESTS requests, those that differ are printed with the
      step and the verifier's top-two gap there, which must stay within
      SPEC_TIE_GAP;
    - copy-on-write: ``cow_load``, paged, one run: at least one page
      copied, engine == oracle, the allocator consistent and no page left
      once the prefix cache is cleared;
    - sampling (SPEC_SAMPLING): the plain engine on ``drafter`` equals
      sampled serial decode on the first SPEC_SAMPLED_REQUESTS requests,
      contiguous and paged, one run each; a sampled
      speculative run of those requests repeated on one engine (tick arrivals, so both runs
      schedule alike) gives the same tokens, whose first equals sampled
      serial decode's;
    - the trained pair: ``trained`` (the trained bf16 params, their HQP
      artifact, its validation requests), VARIANT_RUNS greedy runs,
      contiguous, against the prefill-route serial decode of the trained
      params: the acceptance of a real HQP drafter;
    - B3 against B4 at Sq = 1, and B4/B6 at the verify shape.
    Returns the phase's seconds."""
    import torch
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import lm
    from repro_torch.serving import SamplingConfig
    t_phase = time.monotonic()
    _b3_vs_b4(dev, card)
    _verify_shape(dev, report, card)
    verifier = lm.init_params(cfg, seed=0, device=dev)
    reqs, arrivals = synth_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT,
                                    SERVE_NEW)
    reqs, arrivals = reqs[:SPEC_REQUESTS], arrivals[:SPEC_REQUESTS]

    def serial(params, r, route, n=None, **kw):
        return oracle_decode(params, cfg, r.prompt, n or r.max_new_tokens,
                             max_seq=SERVE_MAX_SEQ, device=dev, route=route,
                             **kw)

    t0 = time.monotonic()
    oracle = [serial(verifier, r, "prefill") for r in reqs]
    decode_route = [serial(verifier, r, "decode")
                    for r in reqs[:SPEC_ROUTE_REQUESTS]]
    serial_s = time.monotonic() - t0
    differ = []
    for i, (a, b) in enumerate(zip(oracle, decode_route)):
        if a != b:
            t = _first_diff(a, b)
            gap = _top2_gap(verifier, cfg, reqs[i].prompt, a[:t], dev)
            differ.append((i, t, gap))
            if gap > SPEC_TIE_GAP:
                fail(f"request {i}: the decode-route serial decode leaves "
                     f"the prefill-route one at step {t}, where the "
                     f"verifier's top-two gap {gap:.4g} exceeds "
                     f"{SPEC_TIE_GAP}")
    print(f"[spec] oracle: serial decode of the bf16 verifier with its "
          f"one-token steps on the prefill route (B4); the decode-route "
          f"serial decode (B3) differs on {len(differ)} of "
          f"{len(decode_route)} requests" + "".join(f"; request {i} from step {t}, top-two gap "
                                f"{g:.4g}" for i, t, g in differ)
          + f" (limit {SPEC_TIE_GAP}); {len(oracle) + len(decode_route)} "
          f"serial decodes in "
          f"{serial_s:.2f} s  [{card}]")

    for page_size, must, must_not in (
            (None, DENSE + CONTIGUOUS, PAGED + UNFUSED),
            (SERVE_PAGE, DENSE + PAGED, CONTIGUOUS + UNFUSED)):
        runs, eng = serve_spec(verifier, drafter, cfg, dev, kernels, reqs,
                               must, must_not, oracle,
                               VARIANT_RUNS if page_size else SERVE_RUNS,
                               arrivals_s=arrivals, page_size=page_size)
        _spec_line(runs, eng, f"greedy k={SPEC_K} cycles={SPEC_CYCLES}, "
                   f"bf16 verifier (bf16 KV), INT8 drafter (INT8 KV), "
                   + (f"paged page={page_size}" if page_size
                      else "contiguous")
                   + ", engine == prefill-route serial decode", card)
        del eng

    cow, ticks = cow_load(cfg)
    cow_oracle = [serial(verifier, r, "prefill") for r in cow]
    runs, eng = serve_spec(verifier, drafter, cfg, dev, kernels, cow,
                           DENSE + PAGED, CONTIGUOUS + UNFUSED, cow_oracle, 1,
                           arrival_ticks=ticks, page_size=SERVE_PAGE)
    if runs[0]["cow_copies"] < 1:
        fail("copy-on-write load: no page copied")
    eng.alloc.check()
    eng.prefix.clear()
    if eng.alloc.pages_in_use:
        fail(f"copy-on-write load: {eng.alloc.pages_in_use} pages leaked")
    _spec_line(runs, eng, f"copy-on-write, prompts of {COW_PROMPT} tokens "
               f"(whole pages of {SERVE_PAGE}) and a repeat, paged; no page "
               f"left after clearing the prefix cache", card)
    del eng

    scfg = SamplingConfig(**SPEC_SAMPLING)
    for page_size, must, must_not in (
            (None, DENSE + CONTIGUOUS, PAGED + UNFUSED),
            (SERVE_PAGE, DENSE + PAGED, CONTIGUOUS + UNFUSED)):
        n = SPEC_SAMPLED_REQUESTS
        runs, eng = serve_once(drafter, cfg, dev, kernels, reqs[:n], must,
                               must_not, arrivals_s=arrivals[:n], runs=1,
                               sampling=scfg, quantized_kv=True,
                               page_size=page_size)
        r = runs[0]
        sm = r["summary"]
        print(f"[spec] sampled {scfg}, plain INT8 engine, "
              + (f"paged page={page_size}" if page_size else "contiguous")
              + f", one run: {sm['tokens_per_s']:.2f} tok/s, TTFT p50 "
              f"{sm['ttft_p50_ms']:.1f} ms, engine == sampled serial decode"
              f" on all requests, graphs {r['graphs_captured']} captured / "
              f"{r['graph_replays']} replays / {r['eager_dispatches']} "
              f"eager, launches "
              f"{ {n: c for n, c in r['launches'].items() if c} }  [{card}]")
        del eng
    sreqs = reqs[:SPEC_SAMPLED_REQUESTS]
    spec_ticks = [2 * i for i in range(len(sreqs))]
    runs, eng = serve_spec(verifier, drafter, cfg, dev, kernels, sreqs,
                           DENSE + CONTIGUOUS, PAGED + UNFUSED,
                           [None] * len(sreqs), 2, arrival_ticks=spec_ticks,
                           sampling=scfg)
    if runs[0]["tokens"] != runs[1]["tokens"]:
        fail("sampled speculative serving: the repeated run gave other "
             "tokens")
    # the first token is drawn before serial decode's first step
    first = [serial(verifier, r, "prefill", 1, sampling=scfg)[0]
             for r in sreqs]
    if [t[0] for t in runs[0]["tokens"]] != first:
        fail("sampled speculative serving: first tokens differ from sampled "
             "serial decode's")
    _spec_line(runs, eng, f"sampled {scfg}, speculative k={SPEC_K}, "
               f"contiguous, arrivals every 2 ticks; the repeat gave the "
               f"same tokens", card)
    del eng, verifier

    tparent, tdraft, treqs = trained
    toracle = [serial(tparent, r, "prefill") for r in treqs]
    runs, eng = serve_spec(tparent, tdraft, cfg, dev, kernels, treqs,
                           DENSE + CONTIGUOUS, PAGED + UNFUSED, toracle,
                           VARIANT_RUNS, arrival_ticks=[0] * len(treqs))
    _spec_line(runs, eng, f"trained pair: the trained bf16 model verifies, "
               f"its trained HQP artifact drafts, {len(treqs)} validation "
               f"prompts, contiguous, engine == prefill-route serial "
               f"decode", card)
    del eng
    torch.cuda.synchronize()
    took = time.monotonic() - t_phase
    print(f"[spec] phase seconds {took:.1f}  [{card}]")
    return took


# ------------------------------------------------------------- service phase
class _Door:
    """An ``HttpFrontDoor`` whose event loop runs on a thread of its own, so
    the script's main thread is a client: it touches no tensor while the
    door is up, and the door's pump thread does all CUDA work."""

    def __init__(self, svc):
        import asyncio
        from repro_torch.serving import HttpFrontDoor
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="door-loop", daemon=True)
        self.thread.start()
        self.door = HttpFrontDoor(svc, host="127.0.0.1", port=0)
        self._call(self.door.start())
        self.port = self.door.port

    def _call(self, coro, timeout=600):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stop(self, drain=True) -> None:
        self._call(self.door.stop(drain=drain))
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()


def _http(port, method, path, body=None, timeout=600):
    """One HTTP/1.1 exchange over a plain socket, read to the server's
    close: (status line, headers, payload, seconds from the send to the
    first ``event: token``, or None)."""
    import socket
    data = b"" if body is None else json.dumps(body).encode()
    t0 = time.monotonic()
    first, buf = None, b""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-"
                  f"Length: {len(data)}\r\n\r\n".encode() + data)
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
            if first is None and b"event: token" in buf:
                first = time.monotonic() - t0
    head, _, payload = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(x.split(": ", 1) for x in lines[1:] if ": " in x)
    return lines[0], headers, payload, first


def _generate(port, prompt, max_new, **extra) -> dict:
    """POST /v1/generate. A 200 gives its tokens (their indices must run
    0, 1, ...), its terminal events and the client's TTFT; any other status
    its JSON body."""
    status, headers, payload, first = _http(
        port, "POST", "/v1/generate",
        {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new,
         **extra})
    if not status.startswith("HTTP/1.1 200"):
        return {"status": status, "headers": headers,
                "body": json.loads(payload)}
    events = []
    for block in payload.decode().strip().split("\n\n"):
        d = dict(line.split(": ", 1) for line in block.splitlines())
        events.append((d["event"], json.loads(d["data"])))
    toks = [d for name, d in events if name == "token"]
    if [d["index"] for d in toks] != list(range(len(toks))):
        fail(f"SSE stream: token indices {[d['index'] for d in toks]}")
    return {"status": status, "tokens": [d["token"] for d in toks],
            "ends": [(name, d) for name, d in events if name != "token"],
            "ttft_s": first}


def _stats(port) -> dict:
    status, _, payload, _ = _http(port, "GET", "/stats")
    if not status.startswith("HTTP/1.1 200"):
        fail(f"GET /stats: {status}")
    return json.loads(payload)


def _wait_stats(port, pred, what, timeout=120) -> dict:
    t0 = time.monotonic()
    while True:
        st = _stats(port)
        if pred(st):
            return st
        if time.monotonic() - t0 > timeout:
            fail(f"service: {what} not reached in {timeout} s: {st}")
        time.sleep(0.005)


class _Clients:
    """Client threads, the i-th calling ``fn(*args[i])`` after
    ``delays[i]`` seconds; ``join`` returns their results in order. They
    are daemons, so a failed check exits the script even while a stream
    is open."""

    def __init__(self, fn, args, delays=None):
        self.out, self.errs = [None] * len(args), []

        def run(i):
            try:
                if delays:
                    time.sleep(delays[i])
                self.out[i] = fn(*args[i])
            except BaseException as e:   # fail()'s SystemExit too:
                self.errs.append(e)      # join raises it again
        self.threads = [threading.Thread(target=run, args=(i,), daemon=True)
                        for i in range(len(args))]
        for t in self.threads:
            t.start()

    def join(self, timeout=600) -> list:
        for t in self.threads:
            t.join(timeout)
        if any(t.is_alive() for t in self.threads):
            fail("service: a client thread did not finish")
        if self.errs:
            raise self.errs[0]
        return self.out


def _one_end(r, reason, n, what):
    """A 200 stream with exactly one terminal event: ``done`` with
    ``reason`` and ``n`` tokens (or ``error``)."""
    name = "error" if reason == "error" else "done"
    if not r["status"].startswith("HTTP/1.1 200") or len(r["ends"]) != 1 \
            or r["ends"][0][0] != name \
            or r["ends"][0][1]["finish_reason"] != reason \
            or r["ends"][0][1]["n_tokens"] != n or len(r["tokens"]) != n:
        fail(f"service {what}: expected one '{name}' ({reason}, {n} tokens),"
             f" got {r}")


def _die_with_parent() -> None:
    """In a child before it runs: SIGTERM when this script dies, however
    it dies (Linux ``prctl(PR_SET_PDEATHSIG)``)."""
    import ctypes
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)


def _interleaving_scheduler(sched_cfg):
    """A scheduler that alternates decode dispatches with prefill chunks
    while both are due, so a speculative dispatch runs with a slot
    mid-prefill (the port's policy gives prefill priority)."""
    from repro_torch.serving.scheduler import DECODE, Action, Scheduler

    class Interleave(Scheduler):
        flip = False

        def next_action(self, prefilling, decoding):
            self.flip = not self.flip
            if decoding and (self.flip or not prefilling):
                return Action(DECODE, slots=tuple(sorted(decoding)))
            return super().next_action(prefilling, ())
    return Interleave(sched_cfg)


def phase_service(cfg, dev, kernels, params, artifact, card):
    """The service plane at full width on the card (``serving.service``):

    An in-process ``HttpFrontDoor`` on 127.0.0.1 over a paged (pages of
    SERVE_PAGE, no prefix cache, so pages return to 0) INT8-KV engine of
    ``params`` (the seed-0 INT8 PTQ), SERVE_SLOTS slots, max_seq
    SERVE_MAX_SEQ, queue depth SERVICE_QUEUE, with deadline-feasibility
    admission. Before the door is up the load runs through ``Engine.run``
    SERVE_RUNS times on the same engine (eager first uses, captures, then
    replays), equal to serial decode.
    Then, with launch counts at 0 and every dispatch recorded (all must run
    on the pump thread), over plain sockets:
    - a warm-up request; a SERVICE_LONG-token prompt whose deadline
      (SERVICE_DEADLINE_S) expires mid-prefill; a client that disconnects
      after 2 tokens: both slots and their pages freed;
    - the staggered load from 6 client threads: every stream equals serial
      decode and ``Engine.run``, one ``done`` each;
    - the load again with the SERVICE_FAULT_AT-th decode dispatch faulted
      (a key that would have replayed): exactly that dispatch's requests
      end with ``event: error``, the others equal serial, /stats counts the
      faults with no page in use, and a request after it equals serial;
    - admission: a 0.0001 s deadline gets 429 ``infeasible`` with its
      Retry-After; n_slots + queue depth requests in flight, then one more
      gets 429 ``saturated``;
    - /metrics parses (``telemetry.parse_exposition``) with every family
      of ``schema.metric_names()``; then ``stop(drain=True)`` with 4
      requests in flight completes all of them.
    Then a speculative engine (the bf16 seed-0 parent verifies, ``params``
    drafts, k SPEC_K, contiguous) whose scheduler interleaves decode with
    prefill: one injected ``spec`` dispatch fault while a slot is
    mid-prefill; the dispatch's requests fail, both pools' positions equal
    the host mirror, and the survivors equal the prefill-route serial
    decode of the verifier (ROADMAP C6). Last, the launcher's real entry
    point in a subprocess, ``serve --engine --http --port 0`` on the saved
    trained artifact (``artifact``: its directory, its loaded params, the
    validation requests): one SSE request equal to serial decode of the
    artifact, then SIGTERM: "drained cleanly", exit 0.
    Returns the launches of the door's session."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import lm
    from repro_torch.serving import (AdmissionController, Engine, Request,
                                     SchedulerConfig, Service, ServiceConfig,
                                     faults, serial_decode,
                                     summarize_results)
    from repro_torch.serving.engine import DECODE, FREE, PREFILL
    from repro_torch.telemetry import parse_exposition, schema
    t_phase = time.monotonic()
    reqs, arrivals = synth_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT,
                                    SERVE_NEW)
    want = [oracle_decode(params, cfg, r.prompt, r.max_new_tokens,
                          max_seq=SERVE_MAX_SEQ, quantized_kv=True,
                          device=dev, sampling=None) for r in reqs]
    sched = SchedulerConfig(prefill_chunk=SERVE_CHUNK,
                            decode_steps=SERVE_STEPS)
    eng = Engine(params, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                 sched=sched, quantized_kv=True, page_size=SERVE_PAGE,
                 prefix_cache=False, device=dev)
    direct = []
    for run in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.run(reqs, arrivals_s=arrivals)
        torch.cuda.synchronize()
        direct.append(summarize_results(res, time.monotonic() - t0))
        if [res[i].tokens for i in range(len(reqs))] != want:
            fail(f"service: Engine.run run {run + 1} differs from serial "
                 f"decode")
    dispatches = []
    base = eng.graphs.run

    def record(kind, key, body):
        dispatches.append((threading.get_ident(), kind, [
            int(s.prompt.size) for s in eng.slots if s.stage == PREFILL]))
        return base(kind, key, body)
    eng.graphs.run = record
    svc = Service(eng, ServiceConfig(queue_depth=SERVICE_QUEUE),
                  admission=AdmissionController())
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    door = _Door(svc)
    port = door.port
    r = _generate(port, [3, 1, 4, 1, 5, 9], 2)
    _one_end(r, "length", 2, "warm-up")
    # ---- check 3: a deadline that expires mid-prefill, a disconnect
    st0 = _stats(port)
    long_prompt = np.random.RandomState(5).randint(
        0, cfg.vocab_size, SERVICE_LONG).tolist()
    r = _generate(port, long_prompt, 8, deadline_s=SERVICE_DEADLINE_S)
    _one_end(r, "deadline", 0, "deadline")
    chunks = sum(1 for _, kind, pre in list(dispatches)
                 if kind == "prefill" and SERVICE_LONG in pre)
    if not 0 < chunks < -(-SERVICE_LONG // SERVE_CHUNK):
        fail(f"service deadline: {chunks} chunks of the "
             f"{SERVICE_LONG}-token prompt ran: not mid-prefill")
    seen = faults.http_disconnect_mid_stream(
        "127.0.0.1", port, {"prompt": reqs[0].prompt, "max_new_tokens": 150},
        after_tokens=2)
    st = _wait_stats(port, lambda s: (
        s["service"]["cancelled"] == st0["service"]["cancelled"] + 1
        and s["slots_active"] == 0 and s["engine"]["pages_in_use"] == 0),
        "the disconnected request's slot and pages freed")
    if st["service"]["expired"] != st0["service"]["expired"] + 1 or \
            st["engine"]["cancelled"] != st0["engine"]["cancelled"] + 2:
        fail(f"service: expiry and disconnect not counted: {st}")
    print(f"[service] deadline {SERVICE_DEADLINE_S} s on a {SERVICE_LONG}-"
          f"token prompt expired after {chunks} of "
          f"{-(-SERVICE_LONG // SERVE_CHUNK)} chunks; a client gone after "
          f"{seen} tokens cancelled: slots and pages freed  [{card}]")
    # ---- check 1: the staggered load over HTTP
    t0 = time.monotonic()
    outs = _Clients(lambda r_: _generate(port, r_.prompt, r_.max_new_tokens),
                    [(r_,) for r_ in reqs], delays=arrivals).join()
    wall = time.monotonic() - t0
    for i, o in enumerate(outs):
        _one_end(o, "length", SERVE_NEW, f"stream {i}")
        if o["tokens"] != want[i]:
            fail(f"service stream {i}: tokens differ from serial decode and "
                 f"Engine.run\n http   {o['tokens']}\n serial {want[i]}")
    http_tps = sum(len(o["tokens"]) for o in outs) / wall
    ttft = sorted(o["ttft_s"] for o in outs)
    # ---- check 2: a decode fault at a replayed dispatch, a load in flight
    st0 = _stats(port)
    h = faults.inject_decode_fault(eng, at=SERVICE_FAULT_AT)
    injected, at_fault = eng.graphs.run, []

    def outer(kind, key, body):      # sees the faulting call too
        if kind in faults.DECODE_KINDS:
            at_fault.append(((kind, key) in eng.graphs._graphs, {
                tuple(s.prompt.tolist()) for s in eng.slots
                if s.stage == DECODE}))
        return injected(kind, key, body)
    eng.graphs.run = outer
    outs = _Clients(lambda r_: _generate(port, r_.prompt, r_.max_new_tokens),
                    [(r_,) for r_ in reqs], delays=arrivals).join()
    eng.graphs.run = injected
    h.restore()
    replayed, batch = at_fault[SERVICE_FAULT_AT - 1]
    if h.fired != 1 or not replayed:
        fail(f"service fault: fired {h.fired}, at a captured key: "
             f"{replayed}")
    errored = {i for i, o in enumerate(outs)
               if o["ends"] and o["ends"][0][0] == "error"}
    if {tuple(reqs[i].prompt) for i in errored} != batch or not errored:
        fail(f"service fault: requests {sorted(errored)} ended in error, "
             f"the faulted dispatch held {len(batch)}")
    for i, o in enumerate(outs):
        if i in errored:
            if len(o["ends"]) != 1 or \
                    o["ends"][0][1]["finish_reason"] != "error":
                fail(f"service fault: stream {i} ends {o['ends']}")
        else:
            _one_end(o, "length", SERVE_NEW, f"fault load {i}")
            if o["tokens"] != want[i]:
                fail(f"service fault: survivor {i} differs from serial")
    st = _wait_stats(port, lambda s: s["slots_active"] == 0,
                     "the fault load drained")
    n_err = len(errored)
    if (st["service"]["faults"] - st0["service"]["faults"],
            st["engine"]["faults"] - st0["engine"]["faults"],
            st["engine"]["pages_in_use"]) != (n_err, n_err, 0):
        fail(f"service fault: /stats {st} after {n_err} errored")
    r = _generate(port, reqs[0].prompt, SERVE_NEW)
    if r["tokens"] != want[0]:
        fail("service: the request after the fault differs from serial")
    print(f"[service] decode fault at dispatch {SERVICE_FAULT_AT} (a "
          f"captured key): {n_err} of {len(reqs)} requests ended with event: "
          f"error (that dispatch's), the rest and a request after it equal "
          f"serial decode; faults {n_err}, pages_in_use 0  [{card}]")
    # ---- check 4: admission
    r = _generate(port, reqs[1].prompt, SERVE_NEW, deadline_s=0.0001)
    if not r["status"].startswith("HTTP/1.1 429") or \
            r["body"].get("error") != "infeasible" or \
            "retry_after_s" not in r["body"] or \
            "Retry-After" not in r["headers"]:
        fail(f"service: a 0.0001 s deadline was not shed infeasible: {r}")
    infeasible = r["body"]
    st0 = _stats(port)
    cap = SERVE_SLOTS + SERVICE_QUEUE
    sat = _Clients(lambda r_: _generate(port, r_.prompt, SERVICE_SAT_NEW),
                   [(reqs[i % len(reqs)],) for i in range(cap)])
    _wait_stats(port, lambda s: s["slots_active"] + s["queued"] == cap
                and s["service"]["submitted"]
                == st0["service"]["submitted"] + cap,
                f"{cap} requests in flight")
    r = _generate(port, reqs[2].prompt, 4)
    if not r["status"].startswith("HTTP/1.1 429") or \
            r["body"].get("error") != "saturated":
        fail(f"service: request {cap + 1} was not shed saturated: {r}")
    for i, o in enumerate(sat.join()):
        _one_end(o, "length", SERVICE_SAT_NEW, f"saturating load {i}")
    print(f"[service] admission: deadline 0.0001 s -> 429 {infeasible}; "
          f"{cap} in flight -> 429 {r['body']}  [{card}]")
    # ---- check 7: metrics
    status, headers, payload, _ = _http(port, "GET", "/metrics")
    parsed = parse_exposition(payload.decode())
    missing = set(schema.metric_names()) - set(parsed["types"])
    if not status.startswith("HTTP/1.1 200") or missing:
        fail(f"service /metrics: {status}, families missing {missing}")
    # ---- check 6: drain with requests in flight
    st0 = _stats(port)
    drain = _Clients(lambda r_: _generate(port, r_.prompt, SERVE_NEW),
                     [(r_,) for r_ in reqs[:4]])
    _wait_stats(port, lambda s: s["service"]["submitted"]
                == st0["service"]["submitted"] + 4, "4 requests admitted")
    t_stop = time.monotonic()
    door.stop(drain=True)
    stop_s = time.monotonic() - t_stop
    for i, o in enumerate(drain.join()):
        _one_end(o, "length", SERVE_NEW, f"drained {i}")
        if o["tokens"] != want[i]:
            fail(f"service drain: request {i} differs from serial")
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    pump = door.door._pump_thread.ident
    threads = {t for t, _, _ in dispatches}
    if threads != {pump} or door.door.pump_error is not None:
        fail(f"service: dispatches ran on threads {threads}, the pump is "
             f"{pump}; pump error {door.door.pump_error!r}")
    idle = [n for n in DENSE + PAGED if not launches[n]]
    stray = [n for n in CONTIGUOUS + UNFUSED if launches[n]]
    if idle or stray:
        fail(f"service: kernels idle {idle}, stray {stray}: {launches}")
    # mean and median (a bucket's upper edge) of each phase: the means
    # carry the session's eager first uses and captures, the medians the
    # replays
    phases = {p: (h.sum / h.count * 1e3, h.quantile(0.5) * 1e3)
              for p, h in svc._phase_hists.items() if h.count}
    s = svc.stats
    print(f"[service] HTTP front door, paged INT8 KV page {SERVE_PAGE}, "
          f"{SERVE_SLOTS} slots, queue {SERVICE_QUEUE}: staggered load "
          f"{http_tps:.2f} tok/s over HTTP against Engine.run "
          f"{direct[-1]['tokens_per_s']:.2f} warm (run {SERVE_RUNS} of "
          f"{SERVE_RUNS}; cold {direct[0]['tokens_per_s']:.2f}), client "
          f"TTFT p50 {ttft[(len(ttft) - 1) // 2] * 1e3:.1f} ms (Engine.run "
          f"warm {direct[-1]['ttft_p50_ms']:.1f}); step phases ms, mean / "
          f"median bucket "
          + ", ".join(f"{p} {m:.3f} / {q:.3g}"
                      for p, (m, q) in phases.items())
          + f"; faults {s['faults']}, shed {s['shed']} (infeasible "
          f"{s['shed_infeasible']}), expired {s['expired']}, cancelled "
          f"{s['cancelled']}, completed {s['completed']}; {len(dispatches)} "
          f"dispatches, all on the pump thread; drain {stop_s:.2f} s; "
          f"launches {launches}  [{card}]")
    # ---- check 5: a speculative dispatch fault with a slot mid-prefill
    verifier = lm.init_params(cfg, seed=0, device=dev)
    seng = Engine(verifier, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                  sched=sched, device=dev, draft_params=params,
                  spec_k=SPEC_K, spec_cycles=SPEC_CYCLES)
    seng.scheduler = _interleaving_scheduler(sched)
    mid = np.random.RandomState(6).randint(0, cfg.vocab_size, 120).tolist()
    sreqs = [Request(prompt=reqs[0].prompt, max_new_tokens=24),
             Request(prompt=reqs[1].prompt, max_new_tokens=24),
             Request(prompt=mid, max_new_tokens=16),
             Request(prompt=reqs[2].prompt, max_new_tokens=16)]
    oracle = {i: serial_decode(verifier, cfg, sreqs[i].prompt,
                               sreqs[i].max_new_tokens, max_seq=SERVE_MAX_SEQ,
                               device=dev, route="prefill") for i in (2, 3)}
    inner, fired = seng.graphs.run, []

    def inject(kind, key, body):
        if kind == "spec" and not fired and any(
                sl.stage == PREFILL for sl in seng.slots):
            fired.append({sl.result.uid for sl in seng.slots
                          if sl.stage == DECODE})
            raise faults.InjectedFault("injected: spec dispatch")
        return inner(kind, key, body)
    seng.graphs.run = inject
    absorb, mirror = seng._absorb_fault, []

    def checked():
        absorb()
        mirror.append([(name, sl.idx) for sl in seng.slots
                       if sl.stage != FREE
                       for name, pool in (("verifier", seng.pool),
                                          ("drafter", seng.draft_pool))
                       if int(pool["pos"][sl.idx]) != seng._host_pos(sl)])
    seng._absorb_fault = checked
    sres = seng.run(sreqs, arrival_ticks=[0, 0, 6, 60])
    errored = {sres[i].uid for i in sres if sres[i].finish_reason == "error"}
    if len(fired) != 1 or errored != fired[0] or mirror != [[]]:
        fail(f"service spec fault: fired {fired}, errored {errored}, "
             f"positions off the mirror {mirror}")
    for i, toks in oracle.items():
        if sres[i].tokens != toks:
            fail(f"service spec fault: survivor {i} differs from the "
                 f"prefill-route serial decode of the verifier")
    print(f"[service] speculative (k {SPEC_K}, contiguous, interleaved "
          f"scheduler): a spec dispatch fault with a slot mid-prefill failed "
          f"its {len(errored)} requests; both pools' positions equal the "
          f"host mirror; the survivor mid-prefill and a later request equal "
          f"the prefill-route serial decode  [{card}]")
    del seng, verifier
    # ---- check 8: the launcher's serve --engine --http in a subprocess
    art_dir, art_params, treqs = artifact
    treq = treqs[0]
    art_want = serial_decode(art_params, cfg, treq.prompt,
                             treq.max_new_tokens, max_seq=SERVE_MAX_SEQ,
                             quantized_kv=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--engine",
         "--http", "--port", "0", "--page-size", str(SERVE_PAGE),
         "--no-prefix-cache", "--max-seq", str(SERVE_MAX_SEQ),
         "--load-artifact", f"{art_dir}/artifact", "--watchdog-s", "120"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=_die_with_parent)
    lines, listening = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                listening.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not listening.wait(SERVICE_SUBPROCESS_S):
            fail("serve --http: not listening in time:\n" + "".join(lines))
        sub_port = int(next(x for x in lines if "listening on" in x)
                       .split("http://127.0.0.1:")[1].split()[0])
        ready_s = time.monotonic() - t0
        r = _generate(sub_port, treq.prompt, treq.max_new_tokens)
        _one_end(r, "length", treq.max_new_tokens, "serve --http")
        proc.send_signal(signal.SIGTERM)
        proc.wait(SERVICE_SUBPROCESS_S)
        reader.join(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    out = "".join(lines)
    if proc.returncode != 0 or "drained cleanly" not in out:
        fail(f"serve --http: exit {proc.returncode}\n{out}")
    if r["tokens"] != art_want:
        fail(f"serve --http: tokens differ from serial decode of the "
             f"artifact\n http   {r['tokens']}\n serial {art_want}")
    print(f"[service] serve --engine --http --load-artifact (the trained "
          f"artifact, pages of {SERVE_PAGE}): listening after "
          f"{ready_s:.1f} s, one SSE request equal to serial decode of the "
          f"artifact, SIGTERM -> drained cleanly, exit 0; "
          + " | ".join(x.strip() for x in lines if x.startswith("[http]"))
          + f"  [{card}]")
    print(f"[service] phase {time.monotonic() - t_phase:.1f} s  [{card}]")
    # the engines here are cyclic garbage (a Service and its engine, the
    # wrappers that record their dispatches): free their device memory now
    del eng, svc, door
    gc.collect()
    return launches


# ------------------------------------------------------------------ CNN
def _cnn_max_rel(got, want) -> float:
    """max |got - want| over the largest |want| (``got`` on the card,
    ``want`` on the CPU); for a tree of BN statistics, each layer's worst,
    the mean's difference over the layer's largest standard deviation (a
    batch mean near 0 is a sum that cancels: its rounding is relative to
    the activations' scale, not to itself)."""
    if isinstance(want, dict) and set(want) == {"mean", "var"}:
        var = want["var"].abs().max()
        return max(float((got["mean"].cpu() - want["mean"]).abs().max()
                         / var.sqrt()),
                   float((got["var"].cpu() - want["var"]).abs().max() / var))
    if isinstance(want, dict):
        return max(_cnn_max_rel(got[k], want[k]) for k in want)
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _cnn_parity(arch, dev, table, card) -> None:
    """The card's forward == the port's CPU forward of the same variables,
    eval and train (logits, and the train mode's new stats); masked ==
    compacted logits on
    the card at the HQP run's n_drop."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_cnn_config
    from repro_torch.core import pruning as pr
    from repro_torch.core import sensitivity as sens
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.models import cnn
    from repro_torch.repro_exp import cnn_experiment as exp
    cfg = dataclasses.replace(get_cnn_config(arch), width_mult=CNN_WIDTH)
    v = exp.train_cnn(cfg, SyntheticImages(CNN_PARITY_STEPS * 128, seed=0),
                      steps=CNN_PARITY_STEPS, log=lambda s: None, device=dev)
    v_cpu = tree.map_(lambda t: t.cpu(), v)
    x = torch.from_numpy(SyntheticImages(CNN_PARITY_BATCH, seed=7).images)
    errs = {}
    with torch.no_grad():
        for train in (False, True):
            mode = "train" if train else "eval"
            got = cnn.cnn_apply(cfg, v, x.to(dev), train)
            want = cnn.cnn_apply(cfg, v_cpu, x, train)
            errs[f"{mode} logits"] = _cnn_max_rel(got[0], want[0])
            if train:      # in eval mode the stats pass through unchanged
                errs[f"{mode} stats"] = _cnn_max_rel(got[1], want[1])
    n_drop = max([h["n_drop"] for h in table["hqp_history"]
                  if h["accepted"]], default=0)
    sq = exp.fisher_for(cfg, v, SyntheticImages(200, seed=200))
    ranked = pr.rank_units(sens.cnn_prune_groups(cfg, v), sq)
    masked = pr.apply_prune_masks(v, ranked, n_drop)
    compact = pr.compact_params(masked, ranked, n_drop)
    with torch.no_grad():
        errs["masked vs compacted logits"] = _cnn_max_rel(
            cnn.cnn_apply(cfg, compact, x.to(dev))[0],
            cnn.cnn_apply(cfg, masked, x.to(dev))[0].cpu())
    _cnn_profile(arch, cfg, v, dev, card)
    bad = {k: e for k, e in errs.items() if not e <= CNN_REL}
    print(f"[cnn] {arch} width {CNN_WIDTH} ({CNN_PARITY_STEPS} training steps, "
          f"{CNN_PARITY_BATCH} images): card vs CPU, max |diff| / max |CPU| "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" (limit {CNN_REL}; masked vs compacted at n_drop {n_drop} of "
          f"{ranked.total}, on the card)  [{card}]")
    if bad:
        fail(f"cnn {arch}: beyond {CNN_REL}: {bad}")


def _cnn_profile(arch, cfg, v, dev, card) -> None:
    """Where an eager batch-64 eval forward's device time goes: the
    kernels' device ms by name (the top CNN_PROFILE_TOP), their count, the
    busy ms against the host's wall ms (the idle share)."""
    import torch
    from repro_torch.models import cnn
    x = torch.randn(64, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    x = x.to(dev)
    with torch.no_grad():
        cnn.cnn_apply(cfg, v, x)
        torch.cuda.synchronize(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            cnn.cnn_apply(cfg, v, x)
            torch.cuda.synchronize(dev)
            wall_ms = (time.monotonic() - t0) * 1e3
    by_name, n = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
            n += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:CNN_PROFILE_TOP]
    print(f"[cnn] {arch} profile, eager eval forward at batch 64: {n} "
          f"kernels, device busy {busy:.4f} ms of {wall_ms:.4f} ms wall "
          f"(idle {max(0.0, 1 - busy / wall_ms):.1%}); top: "
          + "; ".join(f"{name[:70]} {ms:.4f} ms" for name, ms in top)
          + f"  [{card}]")


def phase_cnn(dev, card) -> dict:
    """The paper's experiment, ``run_experiment`` for both archs at
    CNN_WIDTH and the JAX package's CLI sizes, then card == CPU and masked ==
    compacted on each; the gates: baseline accuracy >= CNN_ACC_MIN, every
    accepted Algorithm 1 step within Δ_ax, the history ending in a REJECT
    or at max_steps, the Q8 row's size the simulated INT8 count, every
    number finite. Returns the tables."""
    import dataclasses
    import torch
    from repro_torch.compress import quantize as cq
    from repro_torch.configs import get_cnn_config
    from repro_torch.models import cnn
    from repro_torch.repro_exp import cnn_experiment as exp
    t_phase = time.monotonic()
    gc.collect()
    tables = {}
    for arch in ("mobilenetv3s", "resnet18"):
        t0 = time.monotonic()
        table = exp.run_experiment(
            arch, delta_ax=CNN_DELTA, train_steps=CNN_STEPS, n_train=CNN_TRAIN,
            n_val=CNN_VAL, n_calib=CNN_CALIB, width=CNN_WIDTH,
            log=lambda s: None,
            device=dev)
        took = time.monotonic() - t0
        tables[arch] = table
        rows, hist = table["rows"], table["hqp_history"]
        for r in rows:
            sp_meas = table["speedups_measured"][r["method"]]
            sp_mod = table["speedups_modeled"][r["method"]]
            print(f"[cnn] {arch} {r['method']}: acc {r['accuracy']:.4f}, "
                  f"drop {r['drop']:+.4f}, size {r['size_bytes']} B "
                  f"(reduction {r['size_reduction']:.4f}), θ "
                  f"{r['theta']:.4f}, measured {r['measured_ms']:.4f} ms "
                  f"(CUDA graph replay, batch 64) / eager "
                  f"{table['measured_eager_ms'][r['method']]:.4f} ms, modeled "
                  f"{r['modeled_ms']:.6f} ms on H100_SXM; speedup measured "
                  f"{sp_meas:.3f}x, modeled {sp_mod:.3f}x; compliant "
                  f"{r['compliant']}  [{card}]")
        last = hist[-1] if hist else None
        print(f"[cnn] {arch} Algorithm 1: {len(hist)} steps, "
              f"{sum(h['accepted'] for h in hist)} accepted, ended "
              + ("REJECT" if last and not last["accepted"] else "ACCEPT")
              + f" at θ {last['theta'] if last else 0:.4f}; θ by family "
              + json.dumps({k: round(t, 4) for k, t in
                            table["hqp_sparsity_by_family"].items()}))
        print(f"[cnn] {arch} stage seconds: "
              + ", ".join(f"{k} {t:.2f}" for k, t in table["seconds"].items())
              + f"; run_experiment {took:.1f} s  [{card}]")
        cfg = dataclasses.replace(get_cnn_config(arch), width_mult=CNN_WIDTH)
        sim = cq.simulated_int8_bytes(cnn.cnn_init(
            cfg, torch.Generator().manual_seed(0), device="meta"))
        nums = [v for r in rows for k, v in r.items()
                if k not in ("method", "compliant")]
        nums += list(table["speedups_measured"].values())
        nums += list(table["speedups_modeled"].values())
        nums += list(table["measured_eager_ms"].values())
        if table["baseline_accuracy"] < CNN_ACC_MIN:
            fail(f"cnn {arch}: baseline accuracy "
                 f"{table['baseline_accuracy']} < {CNN_ACC_MIN}")
        over = [h for h in hist if h["accepted"] and h["drop"] > CNN_DELTA]
        if over:
            fail(f"cnn {arch}: accepted steps beyond Δ_ax: {over}")
        if not hist or (last["accepted"]
                        and len(hist) < exp.ALGORITHM1.max_steps):
            fail(f"cnn {arch}: Algorithm 1 ended neither in a REJECT nor at "
                 f"max_steps: {hist}")
        if rows[1]["size_bytes"] != sim:
            fail(f"cnn {arch}: Q8 size {rows[1]['size_bytes']} B, the "
                 f"simulated INT8 count is {sim} B")
        if not all(math.isfinite(x) for x in nums):
            fail(f"cnn {arch}: a number is not finite: {rows}")
        _cnn_parity(arch, dev, table, card)
    print(f"[cnn] phase_cnn {time.monotonic() - t_phase:.1f} s  [{card}]")
    return tables

# ------------------------------------------------------------------ MoE
def _cut(arch, n_layers):
    """``arch``'s published config with its depth cut to ``n_layers``."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), n_layers=n_layers)


def _shape_line(cfg, full_layers) -> str:
    from repro_torch.models import lm, ssm
    moe, s = cfg.moe, getattr(cfg, "ssm", None)
    return (f"d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv "
            f"heads (G {cfg.n_heads // cfg.n_kv_heads}), hd "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
            + (f"{moe.n_experts} experts top-{moe.experts_per_token}"
               + (" + a dense residual MLP" if moe.dense_residual else "")
               + ", " if moe else "")
            + (f"Mamba d_state {s.d_state}, d_conv {s.d_conv}, expand "
               f"{s.expand} (d_in {s.expand * cfg.d_model}), dt_rank "
               f"{ssm.dt_rank(cfg)}, pattern "
               f"{''.join(k[0] for k in cfg.pattern)} (a = attention, m = "
               f"Mamba), MoE on layers "
               f"{[i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]}, "
               if s else "")
            + f"vocab {cfg.vocab_size} padded to {lm.padded_vocab(cfg)}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'}; depth cut from "
            f"{full_layers} to {cfg.n_layers} layers")


def _n_params(params) -> int:
    from repro_torch import tree
    return sum(t.numel() for t in tree.leaves(params))


def _free() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _moe_split_ms(params, cfg, dev, n_tokens):
    """Device ms (CUDA-graph replays) of layer 0's MoE at ``n_tokens``
    rows: the whole layer (``moe_tokens``: router, softmax, top-k sort, the
    dispatch buffer's scatter, the experts, the combine) and its
    experts alone (``expert_ffn`` over an (E, n_tokens, d) buffer: the B1
    launches and the SwiGLU's elementwise ops). Their difference is the
    dispatch's own time."""
    import torch
    from repro_torch.models import moe as M
    p = params["blocks"][0]["moe"]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n_tokens, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    xb = torch.randn(M.n_experts(p), n_tokens, cfg.d_model, generator=gen,
                     device=dev).to(torch.bfloat16)
    k = cfg.moe.experts_per_token
    layer = device_ms(lambda: M.moe_tokens(x, p, k), calls=4)
    experts = device_ms(lambda: M.expert_ffn(xb, p), calls=4)
    return {"moe_layer_ms": layer, "experts_ms": experts,
            "dispatch_ms": layer - experts}


def _moe_kernel_times(dev, cfg, report, card):
    """B1 at an expert's decode product (the no-drop buffer's SERVE_SLOTS
    rows, d_model x d_ff and back), and B3/B4 at the MoE config's heads
    (hd 128, G 4) against an INT8 KV window of SERVE_MAX_SEQ: device ms of
    the kernel, its plain version and its bound, into ``report`` under
    ``moe_shapes``."""
    import torch
    from repro_torch.kernels import (decode_attention as kd,
                                     int8_matmul as km,
                                     prefill_attention as kp, ref)
    b, hq, hkv, hd = SERVE_SLOTS, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    w = SERVE_MAX_SEQ
    for k_dim, n_dim in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
        x = torch.randn(b, k_dim, device=dev).to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (k_dim, n_dim), dtype=torch.int8,
                            device=dev)
        sc = torch.rand(n_dim, device=dev) * 1e-2
        def plain(x=x, w_q=w_q, sc=sc):
            x_q, x_s = ref.quantize_ref(x)
            return ref.int8_matmul_ref(x_q, w_q, x_s, sc)
        if not torch.equal(km.int8_matmul_quant(x, w_q, sc), plain()):
            fail(f"B1 at an expert's ({b}, {k_dim}) x ({k_dim}, {n_dim}) "
                 f"differs from its plain version")
        t = timed(lambda x=x, w_q=w_q, sc=sc: km.int8_matmul_quant(x, w_q,
                                                                   sc),
                  plain)
        b_ms, by = bound(b * k_dim * 2 + k_dim * n_dim + n_dim * 4
                         + b * n_dim * 2, 2 * b * k_dim * n_dim, "int8")
        shape = f"x ({b}, {k_dim}) bf16 x w ({k_dim}, {n_dim}) int8"
        report["int8_matmul_quant"].setdefault("moe_shapes", {})[shape] = \
            dict(t, bound_ms=b_ms, bound_by=by)
        print(f"[moe] B1 at an expert's decode product {shape}: "
              + _times(dict(t, bound_ms=b_ms, bound_by=by)) + f"  [{card}]")
    k, v, k_s, v_s = _kv(dev, b, w, hkv, hd, True)
    for name, sq, start in (("decode_attention", 1, w - 1),
                            ("prefill_attention", SERVE_CHUNK,
                             w - SERVE_CHUNK)):
        q = torch.randn(b, sq, hq, hd, device=dev).to(torch.bfloat16)
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        if sq == 1:
            kern = lambda: kd.decode_attention(q[:, 0], k, v, k_s, v_s, st)
            plain = lambda: ref.decode_attention_ref(q[:, 0], k, v, k_s,
                                                     v_s, st)
            b_ms, by = _decode_bound(b, w, True, 0, hq, hkv, hd)
        else:
            kern = lambda: kp.prefill_attention(q, k, v, k_s, v_s, st)
            plain = lambda: ref.cached_attention_ref(q, k, v, k_s, v_s, st)
            b_ms, by = _prefill_bound(sq, start, w, True, 0, hq, hkv, hd)
        errs = [0.0, 0.0]
        _attn_check(kern(), plain(), f"{name} at the MoE heads", errs)
        t = dict(timed(kern, plain), bound_ms=b_ms, bound_by=by)
        shape = (f"q ({b}, {sq}, {hq}, {hd}) at {start} vs INT8 KV "
                 f"({b}, {w}, {hkv}, {hd})")
        report[name].setdefault("moe_shapes", {})[shape] = t
        print(f"[moe] {name} at {shape}: " + _times(t)
              + f", max |err| {errs[0]:.3g}, worst row {errs[1]:.3g}  "
              f"[{card}]")


def phase_moe(dev, kernels, report, card):
    """The MoE family on the card, through the launcher's entry points:

    1. phi3.5-moe at full width, MOE_LAYERS deep: seeded init, the
       launcher's ``build_artifact`` (a Fisher pass on B7, PRUNE_STEPS
       conditional steps with the expert family, compaction, per-expert
       INT8 PTQ); the masked model == the compacted one;
    2. C7's case: one expert cut from every layer by hand (the lowest-S
       of each layer in the Fisher ranking; on random weights Algorithm 1's
       steps may never reach an expert), masked == compacted, the router
       bias compacted with its columns;
    3. the artifact saved and loaded, bit-equal, its stacked
       JAX-layout shapes checked;
    4. served on the staggered load, INT8 KV, contiguous and paged (pages
       of SERVE_PAGE), ARCH_RUNS runs each: engine == serial decode, B1
       launched ``n_layers x (4 + 3 E)`` times a decode step (the no-drop
       buffer: every expert runs every step), never B2 or the int8-x B1;
    5. greedy speculative serving, the bf16 parent verifying its INT8 PTQ
       (k SPEC_K), == the prefill-route serial decode of the parent;
    6. a steady decode dispatch profiled (``phase_profile``), and the MoE
       layer's dispatch apart from its experts (``_moe_split_ms``);
    7. arctic at full width, ARCTIC_LAYERS deep, PTQ only, 4 requests
       contiguous: engine == serial decode.
    B1 and its serving form are held against their plain versions at
    every (K, N) the phi artifact, its INT8 PTQ and arctic give them.
    Returns the launches of the phi artifact's cold runs (B5/B6 from the
    paged one, the rest from the contiguous one), the Fisher pass's flash
    launches added."""
    import torch
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.core import pruning as pr
    from repro_torch.launch.checkpoint import load_artifact, save_artifact
    from repro_torch.launch.serve import (_calib_batch, build_artifact,
                                          synth_requests)
    from repro_torch.models import lm
    from repro_torch.serving import serial_decode
    from repro_torch.weights import stack_blocks
    t_phase = time.monotonic()
    totals = {}
    cfg = _cut(MOE_ARCH, MOE_LAYERS)
    e, k = cfg.moe.n_experts, cfg.moe.experts_per_token
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[moe] {cfg.name}: {_shape_line(cfg, 32)}: "
          f"{_n_params(params) / 1e9:.3f} B params, seeded init "
          f"{time.monotonic() - t0:.2f} s  [{card}]")
    _moe_kernel_times(dev, cfg, report, card)

    # 1. the launcher's HQP pipeline, from launch counts at 0
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    art = build_artifact(params, cfg, PRUNE_STEPS, log=print)
    wall = time.monotonic() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    m, sec = art.manifest, art.seconds
    print(m.summary())
    n_forward = 1 + len(sec["evals"])
    theta = {f: m.theta_by_family[f] for f in sorted(m.theta_by_family)}
    print(f"[moe] compress: θ by family {json.dumps(theta)}; {wall:.2f} s in "
          f"all (Fisher {sec['fisher']:.3f} s, evals "
          f"{', '.join(f'{t:.3f}' for t in sec['evals'])}, compact "
          f"{sec['compact']:.3f}, PTQ {sec['ptq']:.3f}); flash launches "
          f"{launches['flash_attention']} over {n_forward} forwards; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          f" GiB  [{card}]")
    if launches["flash_attention"] != cfg.n_layers * n_forward:
        fail(f"moe compress: {launches['flash_attention']} flash launches, "
             f"expected {cfg.n_layers} x {n_forward}")
    stray = [n for n, c in launches.items() if c and n != "flash_attention"]
    if stray:
        fail(f"moe compress: serving kernels on the train route: {stray}")
    if any(f"L{i}/experts" not in theta for i in range(cfg.n_layers)):
        fail(f"moe compress: no expert family in {sorted(theta)}")
    if not m.pruned or not (len(m.history) == PRUNE_STEPS
                            or not m.history[-1]["accepted"]):
        fail(f"moe compress: {len(m.history)} conditional steps of "
             f"{PRUNE_STEPS}, the last accepted")
    batch = _calib_batch(cfg, CALIB_B, CALIB_S, device=dev)
    res = art.prune
    _mask_vs_compact(cfg, res.params_sparse, res.params_compact, batch,
                     f"{cfg.name} launcher's artifact", card)

    # 2. C7's case: an expert out of every layer
    ranked, n = _per_layer_ranking(
        res.ranked, lambda i, spec: int(spec.kind == "expert"))
    art.prune = res = None
    masked = pr.apply_prune_masks(params, ranked, n)
    compact = pr.compact_params(masked, ranked, n)
    for i, blk in enumerate(compact["blocks"]):
        r = blk["moe"]["router"]
        if r["w"].shape[-1] != e - 1 or r["b"].shape != (e - 1,):
            fail(f"C7's case: layer {i}'s router {tuple(r['w'].shape)} / "
                 f"{tuple(r['b'].shape)}, expected {e - 1} experts")
    _mask_vs_compact(cfg, masked, compact, batch,
                     "one expert cut from every layer (C7's case)", card)
    del masked, compact
    _free()

    # 3. save, load, load again
    art_dir = ROOT / "build" / "moe_artifact"
    shutil.rmtree(art_dir, ignore_errors=True)
    try:
        t0 = time.monotonic()
        save_artifact(str(art_dir), art)
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        loads = [load_artifact(str(art_dir), device=dev)]
        load_s = time.monotonic() - t0
    finally:
        size = sum(f.stat().st_size for f in art_dir.rglob("*")
                   if f.is_file()) if art_dir.exists() else 0
        shutil.rmtree(art_dir, ignore_errors=True)
    for i, loaded in enumerate(loads):
        bad = _differ(loaded.params, art.params)
        if bad or loaded.manifest.asdict() != m.asdict():
            fail(f"moe artifact load {i + 1}: leaves {bad[:5]} differ")
    e_art = art.params["blocks"][0]["moe"]["gate"].w_q.shape[0]
    st = stack_blocks({"blocks": loads[0].params["blocks"]})["blocks"][0]
    want = {"gate": (cfg.n_layers, e_art, cfg.d_model, cfg.d_ff),
            "down": (cfg.n_layers, e_art, cfg.d_ff, cfg.d_model)}
    got = {name: tuple(st["moe"][name].w_q.shape) for name in want}
    if (got != want or tuple(st["moe"]["gate"].scale.shape)
            != (cfg.n_layers, e_art, cfg.d_ff)
            or tuple(st["moe"]["router"]["b"].shape) != (cfg.n_layers,
                                                         e_art)):
        fail(f"moe artifact: stacked JAX-layout shapes {got}, expected "
             f"{want}")
    del loads, st
    print(f"[moe] artifact: {size / 1e9:.3f} GB on disk, saved in "
          f"{save_s:.2f} s, loaded in {load_s:.2f} s, bit-equal to the "
          f"artifact in memory; stacked JAX layout: expert "
          f"codes {got['gate']}, scales {(cfg.n_layers, e_art, cfg.d_ff)}  "
          f"[{card}]")

    # 4. serve the artifact, contiguous and paged
    drafter = quantize_lm_params(params)
    _b1_model_shapes(dev, (art.params, drafter),
                     f"{cfg.name}'s artifact and INT8 PTQ", "moe", card)
    reqs, arrivals = synth_requests(cfg, PRUNED_REQUESTS, SERVE_PROMPT,
                                    MOE_NEW)
    n_lin = _n_linears(art.params)
    if n_lin != cfg.n_layers * (4 + 3 * e_art):
        fail(f"moe: {n_lin} W8A8 launches a forward, expected "
             f"{cfg.n_layers} x (4 + 3 x {e_art})")
    # each kernel's count from the cold run of the layout that launches it
    moe_launches = {}
    for page_size, must, must_not in (
            (None, DENSE + CONTIGUOUS, PAGED + UNFUSED),
            (SERVE_PAGE, DENSE + PAGED, CONTIGUOUS + UNFUSED)):
        runs, eng = serve_once(art.params, cfg, dev, kernels, reqs, must,
                               must_not, arrivals_s=arrivals, runs=ARCH_RUNS,
                               quantized_kv=True, page_size=page_size)
        cold = runs[0]["launches"]
        moe_launches.update(cold if page_size is None
                            else {name: cold[name] for name in PAGED})
        serve_line(runs, eng, f"{cfg.name} HQP artifact, kv=int8 "
                   + (f"page={page_size}" if page_size else "contiguous"),
                   card, totals, tag="[moe]")
        del eng
    moe_launches["flash_attention"] = launches["flash_attention"]
    print(f"[moe] B1 launches a decode step and a prefill chunk: {n_lin} = "
          f"{cfg.n_layers} layers x (4 attention + {e_art} experts x 3); "
          f"no B2 and no int8-x B1 launch on any serving run  [{card}]")

    # 5. greedy speculative: the bf16 parent verifies its INT8 PTQ
    t0 = time.monotonic()
    oracle = [serial_decode(params, cfg, r.prompt, r.max_new_tokens,
                            max_seq=SERVE_MAX_SEQ, device=dev,
                            route="prefill") for r in reqs]
    oracle_s = time.monotonic() - t0
    runs, eng = serve_spec(params, drafter, cfg, dev, kernels, reqs,
                           DENSE + CONTIGUOUS, PAGED + UNFUSED, oracle, 1,
                           arrivals_s=arrivals)
    _spec_line(runs, eng, f"{cfg.name} greedy k={SPEC_K}, bf16 verifier "
               f"(bf16 KV), its INT8 PTQ drafting (INT8 KV), contiguous, "
               f"engine == prefill-route serial decode ({len(reqs)} serial "
               f"decodes in {oracle_s:.2f} s)", card)
    del eng, drafter, params
    _free()

    # 6. where a steady decode dispatch's time goes
    for layout, prof in phase_profile(art.params, cfg, dev, kernels).items():
        print(f"[moe] profile: steady decode, {cfg.name}, INT8 KV, "
              f"{SERVE_SLOTS} slots, {layout}, replayed CUDA graphs: "
              f"{json.dumps(prof)}  [{card}]")
    split = _moe_split_ms(art.params, cfg, dev, SERVE_SLOTS)
    print(f"[moe] MoE layer at a decode step's {SERVE_SLOTS} tokens, CUDA-"
          f"graph replays, device ms: whole layer {split['moe_layer_ms']:.5f}"
          f", experts (B1 x {3 * e_art} + SwiGLU) {split['experts_ms']:.5f}, "
          f"dispatch (router, softmax, top-k sort, scatter, combine) "
          f"{split['dispatch_ms']:.5f}; a step runs {cfg.n_layers} such "
          f"layers  [{card}]")
    del art
    _free()

    # 7. arctic, one layer, PTQ only
    acfg = _cut(ARCTIC_ARCH, ARCTIC_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    aparams = quantize_lm_params(lm.init_params(acfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"[moe] {acfg.name}: {_shape_line(acfg, 35)}: "
          f"{_n_params(aparams) / 1e9:.3f} B params INT8, seeded init and "
          f"per-expert PTQ {time.monotonic() - t0:.2f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  "
          f"[{card}]")
    n_lin = _n_linears(aparams)
    if n_lin != acfg.n_layers * (4 + 3 * acfg.moe.n_experts + 3):
        fail(f"arctic: {n_lin} W8A8 launches a forward")
    _b1_model_shapes(dev, (aparams,), f"{acfg.name}'s INT8 PTQ", "moe", card)
    areqs, aarr = synth_requests(acfg, ARCH_REQUESTS, SERVE_PROMPT, ARCH_NEW)
    runs, eng = serve_once(aparams, acfg, dev, kernels, areqs,
                           DENSE + CONTIGUOUS, PAGED + UNFUSED,
                           arrivals_s=aarr, runs=ARCH_RUNS, quantized_kv=True)
    serve_line(runs, eng, f"{acfg.name} INT8 PTQ, kv=int8 contiguous, B1 "
               f"{n_lin} a step", card, totals, tag="[moe]")
    del eng, aparams
    _free()
    print(f"[moe] phase seconds {time.monotonic() - t_phase:.1f}  [{card}]")
    return moe_launches


def phase_dense_archs(dev, kernels, card):
    """granite-3-8b, stablelm-1.6b and command-r-35b at full width, each
    DENSE_LAYERS deep with its full vocabulary: seeded init, INT8 PTQ,
    ARCH_REQUESTS staggered requests of ARCH_NEW tokens, INT8 KV,
    contiguous, ARCH_RUNS runs on one engine, engine == serial decode;
    B3/B4 at hd 128 with G 4 (granite) and G 8 (command-r), and at hd 64
    with G 1 (stablelm), all held against their plain versions at these
    heads in the kernel phases (ARCH_HEADS), and B1 at each arch's (K, N)
    here. Returns each arch's launches on its cold run."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import lm
    t_phase = time.monotonic()
    totals, out = {}, {}
    for arch in DENSE_ARCHS:
        cfg = _cut(arch, DENSE_LAYERS)
        t0 = time.monotonic()
        params = quantize_lm_params(lm.init_params(cfg, seed=0, device=dev))
        torch.cuda.synchronize()
        print(f"[arch] {arch}: "
              f"{_shape_line(cfg, configs.get_config(arch).n_layers)}: "
              f"{_n_params(params) / 1e9:.3f} B params INT8, seeded init "
              f"and PTQ {time.monotonic() - t0:.2f} s  [{card}]")
        _b1_model_shapes(dev, (params,), f"{arch}'s INT8 PTQ", "arch", card)
        reqs, arrivals = synth_requests(cfg, ARCH_REQUESTS, SERVE_PROMPT,
                                        ARCH_NEW)
        runs, eng = serve_once(params, cfg, dev, kernels, reqs,
                               DENSE + CONTIGUOUS, PAGED + UNFUSED,
                               arrivals_s=arrivals, runs=ARCH_RUNS,
                               quantized_kv=True)
        serve_line(runs, eng, f"{arch} INT8 PTQ, kv=int8 contiguous", card,
                   totals, tag="[arch]")
        out[arch] = runs[0]["launches"]
        del eng, params
        _free()
    print(f"[arch] phase seconds {time.monotonic() - t_phase:.1f}  [{card}]")
    return out


def _cut_hybrid(n_layers):
    """jamba's published config, its depth cut to the published stack's
    first ``n_layers`` layers (the pattern cut with it)."""
    from repro_torch import configs
    from repro_torch.configs.jamba_1_5_large import _pattern
    return dataclasses.replace(configs.get_config(HYBRID_ARCH),
                               n_layers=n_layers,
                               block_pattern=_pattern(n_layers))


def _hybrid_param_counts(params, cfg):
    """(parameters, parameters active a token) of an INT8 tree, an INT8
    linear counted by its codes (its scales not): a token runs
    experts_per_token of an MoE layer's experts."""
    from repro_torch import tree
    total = (sum(v.numel() for v in tree.leaves(params))
             - sum(q.scale.numel() for q in _int8_linears(params)))
    experts = sum(q.w_q.numel() for b in params["blocks"] if "moe" in b
                  for name, q in b["moe"].items() if name != "router")
    m = cfg.moe
    return total, total - experts * (m.n_experts - m.experts_per_token) \
        // m.n_experts


def _b1_times(dev, params, report, card, tag):
    """B1's serving form at every (K, N) of a served model (the ``tag``
    phase's), on the model's own INT8 weights and a decode step's
    SERVE_SLOTS rows: bit for bit against its plain version, and device ms
    of the kernel, its plain version and its bound, into ``report`` under
    ``{tag}_shapes``. A weight under the 50 MB L2 stays there across the
    timed launches."""
    import torch
    from repro_torch.kernels import int8_matmul as km, ref
    lins = {}
    for q in _int8_linears(params):
        w_q = q.w_q if q.w_q.ndim == 2 else q.w_q[0]
        scale = q.scale if q.scale.ndim == 1 else q.scale[0]
        lins.setdefault(tuple(w_q.shape), (w_q, scale))
    gen = torch.Generator(device=dev).manual_seed(6)
    for (k_dim, n_dim), (w_q, sc) in sorted(lins.items()):
        x = torch.randn(SERVE_SLOTS, k_dim, generator=gen,
                        device=dev).to(torch.bfloat16)

        def plain(x=x, w_q=w_q, sc=sc):
            x_q, x_s = ref.quantize_ref(x)
            return ref.int8_matmul_ref(x_q, w_q, x_s, sc)
        if not torch.equal(km.int8_matmul_quant(x, w_q, sc), plain()):
            fail(f"B1 at the {tag} model's ({SERVE_SLOTS}, {k_dim}) x "
                 f"({k_dim}, {n_dim}) differs from its plain version")
        b = SERVE_SLOTS
        b_ms, by = bound(b * k_dim * 2 + k_dim * n_dim + n_dim * 4
                         + b * n_dim * 2, 2 * b * k_dim * n_dim, "int8")
        t = dict(timed(lambda x=x, w_q=w_q, sc=sc:
                       km.int8_matmul_quant(x, w_q, sc), plain),
                 bound_ms=b_ms, bound_by=by)
        shape = f"x ({b}, {k_dim}) bf16 x w ({k_dim}, {n_dim}) int8"
        report["int8_matmul_quant"].setdefault(f"{tag}_shapes", {})[
            shape] = t
        print(f"[{tag}] B1 at {shape} ({k_dim * n_dim / 1e6:.1f} MB of "
              f"weights): " + _times(t) + f"  [{card}]")


def _range_attribution(params, cfg, dev, kernels, ranges, tag,
                       prompt_len=SERVE_PROMPT):
    """Device ms of one eager decode step (SERVE_SLOTS rows at position
    ``prompt_len``, INT8 KV) by group, under torch.profiler with a range
    around each call of the functions of ``ranges`` ({group: (module,
    function name, calls a step)}): a kernel is B1 or an attention kernel
    by its name, else the group of the range that launched it, else the
    rest (embed, norms, what no range covers, the token pick). A replayed
    step runs the same kernels; its profile names them but cannot tell
    whose they are. Each kernel is counted once, by its device event. The
    phase fails if a range was entered another number of times than a
    step calls it, or owns no kernel."""
    import torch
    from repro_torch.models import lm
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, prompt_len + 1),
                         generator=gen).to(dev)
    state = lm.init_decode_state(cfg, SERVE_SLOTS, SERVE_MAX_SEQ,
                                 params=params, quantized_kv=True, device=dev)
    _, state = lm.decode_step(params, cfg, state, toks[:, :-1],
                              route="prefill")
    orig = {g: (mod, name, getattr(mod, name))
            for g, (mod, name, _) in ranges.items()}
    want = {g: n for g, (_, _, n) in ranges.items()}
    entered = dict.fromkeys(ranges, 0)
    prefix = tag + "::"

    def ranged(group, fn):
        def run(*args, **kw):
            entered[group] += 1
            with torch.profiler.record_function(prefix + group):
                return fn(*args, **kw)
        return run
    for g, (mod, name, fn) in orig.items():
        setattr(mod, name, ranged(g, fn))
    try:
        lm.decode_step(params, cfg, dict(state), toks[:, -1:],
                       route="decode")
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        entered.update(dict.fromkeys(ranges, 0))
        with torch.profiler.profile(activities=acts) as prof:
            lm.decode_step(params, cfg, dict(state), toks[:, -1:],
                           route="decode")
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in orig.values():
            setattr(mod, name, fn)
    # the device's kernels, once each (not the ranges' own device-side
    # spans); B1 (a ctypes launch, which the profiler ties to no op) and
    # attention by name, the rest by the range whose op launched them
    events = prof.events()
    device = {(e.name, e.time_range.start, e.time_range.end)
              for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(prefix)}
    groups = dict.fromkeys(("int8_matmul_quant (B1)", "attention",
                            *ranges), 0.0)
    for name, t0, t1 in device:
        g = _group(name, kernels)
        if g == "int8_matmul_quant":
            groups["int8_matmul_quant (B1)"] += (t1 - t0) / 1e3
        elif g in CONTIGUOUS + PAGED:
            groups["attention"] += (t1 - t0) / 1e3

    def walk(evt, owner):
        if evt.name.startswith(prefix):
            owner = evt.name[len(prefix):]
        if owner is not None:
            for k in evt.kernels:
                if _group(k.name, kernels) in ("torch_other", "cublas"):
                    groups[owner] += k.duration / 1e3
        for child in evt.cpu_children:
            walk(child, owner)
    for evt in events:
        if evt.cpu_parent is None:
            walk(evt, None)
    total = sum(t1 - t0 for _, t0, t1 in device) / 1e3
    groups["rest"] = total - sum(groups.values())
    # each range ran as often as the step calls it, and owns some kernels:
    # else their time would fall to the rest unseen
    empty = [g for g, n in want.items() if n and not groups[g] > 0]
    if (not total or groups["rest"] < 0 or empty or entered != want):
        fail(f"{tag} attribution: {groups} of the step's {total:.5f} ms "
             f"of kernels; ranges entered {entered}, calls a step {want}; "
             f"groups with no kernel {empty}")
    top = {}
    for name, t0, t1 in device:
        if _group(name, kernels) in ("cublas", "torch_other"):
            top[name[:60]] = top.get(name[:60], 0.0) + (t1 - t0) / 1e3
    groups["rest's largest kernels"] = dict(
        sorted(top.items(), key=lambda kv: -kv[1])[:3])
    return groups


def _hybrid_card_vs_cpu(dev, card):
    """The hybrid smoke model (a Mamba layer and an attention + MoE layer)
    on the card against the same model on the CPU (the plain versions),
    INT8 PTQ, INT8 KV: a 21-token prefill and 8 decode steps, teacher-
    forced, then the Mamba layer's recurrent state. Routing is discrete,
    so a token whose top-2 lies a hair from the next expert may take
    another one on the card: ``tests/test_system.py``'s MoE allowance (at
    most 5 % of the logits off by more than 0.15 + 0.15 |cpu|, the median
    difference under 0.05)."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.models import lm
    from repro_torch.weights import to_device
    cfg = configs.get_smoke_config(HYBRID_ARCH)
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device="cpu"))
    gpu_params = to_device(params, dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    states = {d: lm.init_decode_state(cfg, 2, 64, params=p, quantized_kv=True,
                                      device=d)
              for d, p in (("cpu", params), (dev, gpu_params))}
    toks, off, med, err = prompt, 0.0, 0.0, 0.0
    real = slice(0, cfg.vocab_size)
    for step in range(9):
        out = {}
        for d, p in (("cpu", params), (dev, gpu_params)):
            out[d], states[d] = lm.decode_step(
                p, cfg, states[d], toks.to(d),
                route="prefill" if step == 0 else "decode")
        a, b = out["cpu"][..., real], out[dev].cpu()[..., real]
        if a.shape != b.shape or not torch.isfinite(b).all():
            fail(f"hybrid smoke step {step}: bad logits {tuple(b.shape)}")
        diff = (a - b).abs()
        off = max(off, (diff > 0.15 + 0.15 * a.abs()).float().mean().item())
        med = max(med, diff.median().item())
        err = max(err, diff.max().item())
        toks = a[:, -1].argmax(-1)[:, None]
    h_cpu, h_dev = states["cpu"]["caches"][0]["h"], states[dev]["caches"][0]
    h_err = (h_cpu - h_dev["h"].cpu()).abs().max().item()
    print(f"[hybrid] smoke model, card vs CPU plain path, INT8: logits max "
          f"|diff| {err:.4g}, worst step's share off {off:.4g} (limit 0.05), "
          f"worst median |diff| {med:.4g} (limit 0.05); the Mamba state h "
          f"after 29 tokens max |diff| {h_err:.4g} (limit 3e-2)  [{card}]")
    if off > 0.05 or med >= 0.05 or not h_err <= 3e-2:
        fail("hybrid smoke model: card and CPU disagree")


def phase_hybrid(dev, kernels, report, card):
    """The hybrid family on the card, through the launcher's entry points:

    1. the smoke model, card against CPU (``_hybrid_card_vs_cpu``);
    2. jamba at full width, the published stack's first HYBRID_LAYERS
       layers, INT8 PTQ drawn a layer at a time; B1 and its serving form
       held bit for bit against plain at every (K, N) of the model, and timed
       there at a decode step's SERVE_SLOTS rows (``_b1_times``);
    3. served on the staggered load, INT8 KV, contiguous and paged (pages
       of SERVE_PAGE), HYBRID_RUNS and VARIANT_RUNS runs: engine ==
       serial decode, B1 launched HYBRID_B1 times a decode step, never
       B2 or the int8-x B1;
    4. the shared-head load, paged with the prefix cache requested: the
       engine keeps none for a recurrent pattern (ROADMAP C8), 0 prefix
       hits, every prompt token prefilled, == serial decode;
    5. one sampled run == sampled serial decode;
    6. a steady decode dispatch profiled (``phase_profile``), and one
       eager decode step's device time by group, the Mamba mixer and the
       MoE layer apart from B1 (``_range_attribution``);
    7. HQP at HYBRID_HQP_LAYERS deep: the launcher's ``build_artifact``
       (Fisher on the train route, PRUNE_STEPS conditional steps with the
       ``ffn`` and ``mamba_cols`` families), masked == compacted; a
       quarter of the Mamba channels cut by hand (Algorithm 1's steps on
       random weights need not reach them), masked == compacted; that cut
       model's INT8 artifact saved, loaded (bit-equal), and served
       contiguous and paged == serial decode, its pool sized from the
       compacted ``conv_w``.
    Returns the launches of the cold runs (B5/B6 from the paged one)."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.artifact import compress
    from repro_torch.core import pruning as pr
    from repro_torch.launch.checkpoint import load_artifact, save_artifact
    from repro_torch.launch.serve import (_calib_batch, build_artifact,
                                          synth_requests)
    from repro_torch.models import lm
    from repro_torch.serving import SamplingConfig
    from repro_torch.serving import state_pool as sp
    t_phase = time.monotonic()
    totals = {}
    _hybrid_card_vs_cpu(dev, card)

    # 2. full width, five layers, INT8 a layer at a time
    cfg = _cut_hybrid(HYBRID_LAYERS)
    full = configs.get_config(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm.init_params(cfg, seed=0, device=dev, quantized=True)
    torch.cuda.synchronize()
    total, active = _hybrid_param_counts(params, cfg)
    print(f"[hybrid] {cfg.name}: {_shape_line(cfg, full.n_layers)}: "
          f"{total / 1e9:.3f} B params ({active / 1e9:.3f} B active a "
          f"token) as cut, INT8; seeded init and PTQ a layer at a time "
          f"{time.monotonic() - t0:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
    kinds = [(k, cfg.is_moe_layer(i)) for i, k in enumerate(cfg.pattern)]
    want_lin = sum((2 if k == "mamba" else 4)
                   + (3 * cfg.moe.n_experts if moe else 3)
                   for k, moe in kinds)
    n_lin = _n_linears(params)
    if n_lin != want_lin or n_lin != HYBRID_B1:
        fail(f"hybrid: {n_lin} W8A8 launches a forward, expected "
             f"{want_lin} (HYBRID_B1 {HYBRID_B1})")
    _b1_model_shapes(dev, (params,), f"{cfg.name}'s INT8 PTQ", "hybrid",
                     card)
    _b1_times(dev, params, report, card, "hybrid")

    # 3. the staggered load, contiguous and paged
    reqs, arrivals = synth_requests(cfg, HYBRID_REQUESTS, SERVE_PROMPT,
                                    HYBRID_NEW)
    launches = {}
    for page_size, must, must_not in (
            (None, DENSE + CONTIGUOUS, PAGED + UNFUSED),
            (SERVE_PAGE, DENSE + PAGED, CONTIGUOUS + UNFUSED)):
        runs, eng = serve_once(params, cfg, dev, kernels, reqs, must,
                               must_not, arrivals_s=arrivals,
                               runs=VARIANT_RUNS if page_size
                               else HYBRID_RUNS, quantized_kv=True,
                               page_size=page_size)
        cold = runs[0]["launches"]
        launches.update(cold if page_size is None
                        else {name: cold[name] for name in PAGED})
        serve_line(runs, eng, f"{cfg.name} INT8 PTQ, kv=int8 "
                   + (f"page={page_size}" if page_size else "contiguous")
                   + f", recurrent state {_rec_bytes(eng.pool)} B beside "
                   f"{eng.stats['kv_bytes']} B of KV", card, totals,
                   tag="[hybrid]")
        del eng
    print(f"[hybrid] B1 launches a decode step and a prefill chunk: {n_lin}"
          f" = 4 Mamba layers x 2 + 3 dense MLPs x 3 + 2 MoE layers x "
          f"{cfg.moe.n_experts} experts x 3 + attention's 4; no B2 and no "
          f"int8-x B1 launch on any serving run  [{card}]")

    # 4. C8: the shared-head load keeps no prefix cache
    shared, ticks = shared_prompt_load(cfg)
    runs, eng = serve_once(params, cfg, dev, kernels, shared, DENSE + PAGED,
                           CONTIGUOUS + UNFUSED, arrival_ticks=ticks, runs=1,
                           quantized_kv=True, page_size=SERVE_PAGE,
                           prefix_cache=True)
    n_prompt = sum(len(r.prompt) for r in shared)
    if eng.prefix is not None or runs[0]["prefix_hits"] \
            or runs[0]["prefill_tokens"] != n_prompt:
        fail(f"hybrid shared-head load: prefix cache {eng.prefix}, "
             f"{runs[0]['prefix_hits']} hits, {runs[0]['prefill_tokens']} of "
             f"{n_prompt} prompt tokens prefilled")
    eng.alloc.check()
    if eng.alloc.pages_in_use:
        fail(f"hybrid shared-head load: {eng.alloc.pages_in_use} pages "
             f"left in use")
    serve_line(runs, eng, f"{cfg.name} paged, shared {SHARED_HEAD}-token "
               f"head, prefix cache requested: none kept (C8), 0 prefix "
               f"hits, {n_prompt} of {n_prompt} prompt tokens prefilled",
               card, totals, tag="[hybrid]")
    del eng

    # 5. sampled
    scfg = SamplingConfig(**SPEC_SAMPLING)
    runs, eng = serve_once(params, cfg, dev, kernels, reqs,
                           DENSE + CONTIGUOUS, PAGED + UNFUSED,
                           arrivals_s=arrivals, runs=1, quantized_kv=True,
                           sampling=scfg)
    serve_line(runs, eng, f"{cfg.name} sampled {SPEC_SAMPLING}, kv=int8 "
               f"contiguous, engine == sampled serial decode", card, totals,
               tag="[hybrid]")
    del eng

    # 6. where a steady decode dispatch's time goes
    for layout, prof in phase_profile(params, cfg, dev, kernels).items():
        print(f"[hybrid] profile: steady decode, {cfg.name}, INT8 KV, "
              f"{SERVE_SLOTS} slots, {layout}, replayed CUDA graphs: "
              f"{json.dumps(prof)}  [{card}]")
    from repro_torch.models import moe as M, ssm
    specs = lm.layer_specs(cfg)
    by = _range_attribution(params, cfg, dev, kernels, {
        "mamba_mixer": (ssm, "mamba_forward",
                        sum(kind == "mamba" for kind, _ in specs)),
        "moe (no B1)": (M, "moe_forward", sum(moe for _, moe in specs))},
        "hybrid")
    print(f"[hybrid] one eager decode step, {SERVE_SLOTS} rows, contiguous "
          f"INT8 KV, device ms by group (torch.profiler, kernels by name "
          f"and by the range that launched them): {json.dumps(by)}  "
          f"[{card}]")
    del params
    _free()

    # 7. HQP at one layer
    cfg1 = _cut_hybrid(HYBRID_HQP_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    params1 = lm.init_params(cfg1, seed=0, device=dev)
    print(f"[hybrid] {cfg1.name}: {_shape_line(cfg1, full.n_layers)}: "
          f"{_n_params(params1) / 1e9:.3f} B params bf16  [{card}]")
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    art = build_artifact(params1, cfg1, PRUNE_STEPS, log=print)
    wall = time.monotonic() - t0
    stray = {n: k.launches for n, k in kernels.items() if k.launches}
    if stray:
        fail(f"hybrid compress: port kernels launched on the train route "
             f"of a model with no attention layer: {stray}")
    m, sec = art.manifest, art.seconds
    theta = {f: m.theta_by_family[f] for f in sorted(m.theta_by_family)}
    print(m.summary())
    print(f"[hybrid] compress: θ by family {json.dumps(theta)}; {wall:.2f} s "
          f"in all (Fisher {sec['fisher']:.3f} s, evals "
          f"{', '.join(f'{t:.3f}' for t in sec['evals'])}, compact "
          f"{sec['compact']:.3f}, PTQ {sec['ptq']:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
    if set(theta) != {"L0/ffn", "L0/mamba_cols"}:
        fail(f"hybrid compress: families {sorted(theta)}")
    if not m.pruned or not (len(m.history) == PRUNE_STEPS
                            or not m.history[-1]["accepted"]):
        fail(f"hybrid compress: {len(m.history)} conditional steps of "
             f"{PRUNE_STEPS}, the last accepted")
    batch = _calib_batch(cfg1, CALIB_B, CALIB_S, device=dev)
    res = art.prune
    _mask_vs_compact(cfg1, res.params_sparse, res.params_compact, batch,
                     f"{cfg1.name} launcher's artifact", card)
    ranked, n = _per_layer_ranking(
        res.ranked, lambda i, spec: (spec.size // 4
                                     if spec.kind == "mamba_col" else 0))
    del art, res
    masked = pr.apply_prune_masks(params1, ranked, n)
    compact = pr.compact_params(masked, ranked, n)
    d_in = cfg1.ssm.expand * cfg1.d_model
    if compact["blocks"][0]["mamba"]["conv_w"].shape[-1] != d_in - d_in // 4:
        fail("hybrid: the hand cut did not remove a quarter of the Mamba "
             "channels")
    _mask_vs_compact(cfg1, masked, compact, batch,
                     f"a quarter of the Mamba channels cut ({d_in // 4} of "
                     f"{d_in})", card)
    del masked, params1
    cut = compress(compact, cfg1, log=print)
    del compact
    _free()
    art_dir = ROOT / "build" / "hybrid_artifact"
    shutil.rmtree(art_dir, ignore_errors=True)
    try:
        t0 = time.monotonic()
        save_artifact(str(art_dir), cut)
        save_s = time.monotonic() - t0
        loads = [load_artifact(str(art_dir), device=dev)]
    finally:
        size = sum(f.stat().st_size for f in art_dir.rglob("*")
                   if f.is_file()) if art_dir.exists() else 0
        shutil.rmtree(art_dir, ignore_errors=True)
    for i, loaded in enumerate(loads):
        bad = _differ(loaded.params, cut.params)
        if bad or loaded.manifest.asdict() != cut.manifest.asdict():
            fail(f"hybrid artifact load {i + 1}: leaves {bad[:5]} differ")
    served = loads[0].params
    del loads
    print(f"[hybrid] the cut model's INT8 artifact: {size / 1e9:.3f} GB on "
          f"disk, saved in {save_s:.2f} s, loaded bit-equal  "
          f"[{card}]")
    creqs, carr = synth_requests(cfg1, HYBRID_REQUESTS, SERVE_PROMPT,
                                 HYBRID_NEW)
    for page_size, must, must_not in (
            (None, DENSE, CONTIGUOUS + PAGED + UNFUSED),
            (SERVE_PAGE, DENSE, CONTIGUOUS + PAGED + UNFUSED)):
        runs, eng = serve_once(served, cfg1, dev, kernels, creqs, must,
                               must_not, arrivals_s=carr, runs=1,
                               quantized_kv=True, page_size=page_size)
        widths = {tuple(e["h"].shape) for e in eng.pool["caches"]
                  if not sp.is_kv_entry(e)}
        if widths != {(SERVE_SLOTS, d_in - d_in // 4, cfg1.ssm.d_state)}:
            fail(f"hybrid cut artifact: pool state {widths}")
        serve_line(runs, eng, f"{cfg1.name} cut artifact, kv=int8 "
                   + (f"page={page_size}" if page_size else "contiguous")
                   + f", pool state h {sorted(widths)[0]}", card, totals,
                   tag="[hybrid]")
        del eng
    del served, cut
    _free()
    print(f"[hybrid] phase seconds {time.monotonic() - t_phase:.1f}  "
          f"[{card}]")
    return launches


def _xlstm_card_vs_cpu(dev, card):
    """The xLSTM smoke model (an mLSTM and an sLSTM layer) on the card
    against the same model on the CPU (the plain versions), INT8 PTQ: a
    21-token prefill and 8 decode steps, teacher-forced, the logits within
    the hybrid phase's allowance (at most 5 % off by more than 0.15 + 0.15
    |cpu|, the median difference under 0.05), then the mLSTM state C after
    29 tokens within XLSTM_STATE_REL of its largest magnitude."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.models import lm
    from repro_torch.weights import to_device
    cfg = configs.get_smoke_config(XLSTM_ARCH)
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device="cpu"))
    gpu_params = to_device(params, dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    states = {d: lm.init_decode_state(cfg, 2, 64, params=p, device=d)
              for d, p in (("cpu", params), (dev, gpu_params))}
    toks, off, med, err = prompt, 0.0, 0.0, 0.0
    real = slice(0, cfg.vocab_size)
    for step in range(9):
        out = {}
        for d, p in (("cpu", params), (dev, gpu_params)):
            out[d], states[d] = lm.decode_step(
                p, cfg, states[d], toks.to(d),
                route="prefill" if step == 0 else "decode")
        a, b = out["cpu"][..., real], out[dev].cpu()[..., real]
        if a.shape != b.shape or not torch.isfinite(b).all():
            fail(f"xlstm smoke step {step}: bad logits {tuple(b.shape)}")
        diff = (a - b).abs()
        off = max(off, (diff > 0.15 + 0.15 * a.abs()).float().mean().item())
        med = max(med, diff.median().item())
        err = max(err, diff.max().item())
        toks = a[:, -1].argmax(-1)[:, None]
    c_cpu = states["cpu"]["caches"][0]["C"]
    c_dev = states[dev]["caches"][0]["C"].cpu()
    c_rel = ((c_cpu - c_dev).abs().max() / c_cpu.abs().max()).item()
    print(f"[xlstm] smoke model, card vs CPU plain path, INT8: logits max "
          f"|diff| {err:.4g}, worst step's share off {off:.4g} (limit 0.05), "
          f"worst median |diff| {med:.4g} (limit 0.05); the mLSTM state C "
          f"after 29 tokens max |diff| / max |C| {c_rel:.4g} (limit "
          f"{XLSTM_STATE_REL})  [{card}]")
    if off > 0.05 or med >= 0.05 or not c_rel <= XLSTM_STATE_REL:
        fail("xlstm smoke model: card and CPU disagree")


def phase_xlstm(dev, kernels, report, card):
    """The xLSTM family on the card, through the launcher's entry points:

    1. the smoke model, card against CPU (``_xlstm_card_vs_cpu``);
    2. xlstm-1.3b at its published width and depth, INT8 PTQ drawn a layer
       at a time; B1 and its serving form held bit for bit against plain
       at every (K, N) of the model, and timed there at a decode step's
       SERVE_SLOTS rows (``_b1_times``);
    3. served on the staggered load, contiguous and paged (pages of
       SERVE_PAGE: an empty KV arena, as the JAX package's engine runs this
       pattern), XLSTM_RUNS and VARIANT_RUNS runs: engine == serial
       decode, 0 prefix hits, no KV entry in the pool, B1 launched
       XLSTM_B1 times a decode step and a chunk, never an attention
       kernel, B2 or the int8-x B1;
    4. one sampled run of the load's first XLSTM_ONE_RUN requests ==
       sampled serial decode;
    5. a steady decode dispatch profiled (``phase_profile``, paged only,
       one profiled dispatch: the arena is empty, so the two layouts run
       the same kernels, and a paged prefill chunk's graph serves every
       slot), and one eager decode step's device time by group: the mLSTM
       and sLSTM blocks apart from B1, B1, the unembed
       (``_range_attribution``);
    6. HQP at full depth: the launcher's ``build_artifact`` (Fisher on the
       train route, PRUNE_STEPS conditional steps with the ``mlstm_heads``
       family); then one head cut from every mLSTM layer by hand, in the
       order of its Fisher ranking (Algorithm 1's steps on random weights
       need not cut a head from every layer of a period position, which
       compaction needs to shrink it), masked == compacted; that cut
       model's INT8 artifact served once (the load's first XLSTM_ONE_RUN
       requests) == serial decode, its pool sized from the compacted
       ``in_proj`` (its disk round trip is the CPU tests', in the JAX
       package's layout both ways).
    Returns the launches of the cold contiguous run."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.artifact import compress
    from repro_torch.core import pruning as pr
    from repro_torch.launch.serve import (_calib_batch, build_artifact,
                                          synth_requests)
    from repro_torch.models import lm, xlstm
    from repro_torch.serving import SamplingConfig
    from repro_torch.serving import state_pool as sp
    t_phase = time.monotonic()
    totals, stages = {}, {}

    def stage(name):
        stages[name] = time.monotonic() - t_phase - sum(stages.values())
    _xlstm_card_vs_cpu(dev, card)
    stage("card_vs_cpu")

    # 2. the published config, INT8 a layer at a time
    cfg = configs.get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm.init_params(cfg, seed=0, device=dev, quantized=True)
    torch.cuda.synchronize()
    hd = xlstm.head_width(cfg)
    print(f"[xlstm] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers ({cfg.pattern.count('mlstm')} mLSTM, "
          f"{cfg.pattern.count('slstm')} sLSTM, pattern "
          f"{''.join(k[0] for k in cfg.pattern[:8])}...), {cfg.n_heads} heads "
          f"of {hd} (mLSTM d_in {cfg.n_heads * hd}), sLSTM d_up "
          f"{int(cfg.xlstm.proj_factor_slstm * cfg.d_model)}, vocab "
          f"{cfg.vocab_size} padded to {lm.padded_vocab(cfg)}, untied; "
          f"published depth and width; {_n_params(params) / 1e9:.3f} B "
          f"params INT8 ({cfg.param_count() / 1e9:.3f} B by the config's "
          f"count); seeded init and PTQ a layer at a time "
          f"{time.monotonic() - t0:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
    n_lin = _n_linears(params)
    if n_lin != XLSTM_B1 or n_lin != 2 * cfg.n_layers:
        fail(f"xlstm: {n_lin} W8A8 launches a forward, expected "
             f"{XLSTM_B1}")
    _b1_model_shapes(dev, (params,), f"{cfg.name}'s INT8 PTQ", "xlstm",
                     card)
    _b1_times(dev, params, report, card, "xlstm")
    stage("init_and_b1")

    # 3. the staggered load, contiguous and paged
    reqs, arrivals = synth_requests(cfg, XLSTM_REQUESTS, XLSTM_PROMPT,
                                    XLSTM_NEW)
    launches, want = {}, None
    for page_size in (None, SERVE_PAGE):
        runs, eng = serve_once(params, cfg, dev, kernels, reqs, DENSE,
                               CONTIGUOUS + PAGED + UNFUSED,
                               arrivals_s=arrivals,
                               runs=VARIANT_RUNS if page_size else XLSTM_RUNS,
                               want=want, page_size=page_size)
        # serial decode of the same requests on the same weights: the
        # tokens the contiguous runs were held to, and now gave
        want = runs[0]["tokens"]
        if sp.kv_entries(eng.pool) or eng.stats["kv_bytes"] \
                or eng.prefix is not None \
                or any(r["prefix_hits"] for r in runs):
            fail(f"xlstm page_size={page_size}: KV entries "
                 f"{len(sp.kv_entries(eng.pool))}, kv_bytes "
                 f"{eng.stats['kv_bytes']}, prefix cache {eng.prefix}, hits "
                 f"{[r['prefix_hits'] for r in runs]}")
        if page_size is None:
            launches = runs[0]["launches"]
        per_slot = _rec_bytes(eng.pool) // SERVE_SLOTS
        serve_line(runs, eng, f"{cfg.name} INT8 PTQ, "
                   + (f"paged (page={page_size}, an empty KV arena)"
                      if page_size else "contiguous")
                   + f", recurrent state {per_slot} B a slot, 0 B of KV, 0 "
                   f"prefix hits", card, totals, tag="[xlstm]")
        del eng
    stage("serve")
    print(f"[xlstm] B1 launches a decode step and a prefill chunk: {n_lin} "
          f"= {cfg.pattern.count('mlstm')} mLSTM x 2 + "
          f"{cfg.pattern.count('slstm')} sLSTM x 2; no attention, B2 or "
          f"int8-x B1 launch on any serving run  [{card}]")

    # 4. sampled
    one, one_arr = reqs[:XLSTM_ONE_RUN], arrivals[:XLSTM_ONE_RUN]
    runs, eng = serve_once(params, cfg, dev, kernels, one, DENSE,
                           CONTIGUOUS + PAGED + UNFUSED, arrivals_s=one_arr,
                           runs=1,
                           sampling=SamplingConfig(**SPEC_SAMPLING))
    serve_line(runs, eng, f"{cfg.name} sampled {SPEC_SAMPLING}, "
               f"contiguous, engine == sampled serial decode", card, totals,
               tag="[xlstm]")
    del eng
    stage("sampled")

    # 5. where a steady decode dispatch's time goes
    for layout, prof in phase_profile(params, cfg, dev, kernels,
                                      XLSTM_PROMPT, LAYOUTS[1:], 1).items():
        print(f"[xlstm] profile: steady decode, {cfg.name}, "
              f"{SERVE_SLOTS} slots, {layout}, replayed CUDA graphs: "
              f"{json.dumps(prof)}  [{card}]")
    meta = _meta(params)

    def decode(where):
        p = params if where == "cuda" else meta
        st = _serve_state(p, cfg, where, SERVE_SLOTS, XLSTM_PROMPT)
        lm.decode_step(p, cfg, st, torch.zeros((SERVE_SLOTS, 1),
                                               dtype=torch.long,
                                               device=where),
                       window=SERVE_MAX_SEQ, route="decode")
    roofline_check(f"{cfg.name} INT8 decode step, {cfg.n_layers} layers, "
                   f"{SERVE_SLOTS} slots at {XLSTM_PROMPT} (eager; measured: "
                   f"the replayed paged step)", decode,
                   prof["decode_step_ms"], card)
    del meta
    by = _range_attribution(params, cfg, dev, kernels, {
        "mlstm (no B1)": (xlstm, "mlstm_forward", cfg.pattern.count("mlstm")),
        "slstm (no B1)": (xlstm, "slstm_forward", cfg.pattern.count("slstm")),
        "unembed": (lm, "logits_fn", 1)}, "xlstm", XLSTM_PROMPT)
    print(f"[xlstm] one eager decode step, {SERVE_SLOTS} rows, device ms by "
          f"group (torch.profiler, kernels by name and by the range that "
          f"launched them): {json.dumps(by)}  [{card}]")
    del params
    _free()
    stage("profile")

    # 6. HQP at full depth
    torch.cuda.reset_peak_memory_stats(dev)
    params1 = lm.init_params(cfg, seed=0, device=dev)
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    art = build_artifact(params1, cfg, PRUNE_STEPS, log=print)
    wall = time.monotonic() - t0
    stray = {n: k.launches for n, k in kernels.items() if k.launches}
    if stray:
        fail(f"xlstm compress: port kernels launched on the bf16 train "
             f"route: {stray}")
    m, sec = art.manifest, art.seconds
    theta = {f: m.theta_by_family[f] for f in sorted(m.theta_by_family)}
    print(m.summary())
    print(f"[xlstm] compress at full depth: θ by family {json.dumps(theta)}; "
          f"{wall:.2f} s in all (Fisher {sec['fisher']:.3f} s, evals "
          f"{', '.join(f'{t:.3f}' for t in sec['evals'])}, compact "
          f"{sec['compact']:.3f}, PTQ {sec['ptq']:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
    if not all(f.endswith("/mlstm_heads") for f in theta):
        fail(f"xlstm compress: families {sorted(theta)}")
    if not m.pruned or not (len(m.history) == PRUNE_STEPS
                            or not m.history[-1]["accepted"]):
        fail(f"xlstm compress: {len(m.history)} conditional steps of "
             f"{PRUNE_STEPS}, the last accepted")
    batch = _calib_batch(cfg, CALIB_B, CALIB_S, device=dev)
    ranked, n = _per_layer_ranking(art.prune.ranked, lambda i, spec: 1)
    del art
    _free()
    masked = pr.apply_prune_masks(params1, ranked, n)
    compact = pr.compact_params(masked, ranked, n)
    heads = {b["mlstm"]["wq"].shape[0] for b in compact["blocks"]
             if "mlstm" in b}
    if heads != {cfg.n_heads - 1}:
        fail(f"xlstm: the hand cut left mLSTM head counts {heads}")
    _mask_vs_compact(cfg, masked, compact, batch,
                     f"one mLSTM head of {cfg.n_heads} cut from every mLSTM "
                     f"layer", card, misalign=_misalign_mlstm)
    del masked, params1
    cut = compress(compact, cfg, log=print)
    del compact
    _free()
    runs, eng = serve_once(cut.params, cfg, dev, kernels, one, DENSE,
                           CONTIGUOUS + PAGED + UNFUSED, arrivals_s=one_arr,
                           runs=1)
    widths = {tuple(e["C"].shape) for e in eng.pool["caches"] if "C" in e}
    if widths != {(SERVE_SLOTS, cfg.n_heads - 1, hd, hd)}:
        fail(f"xlstm cut artifact: pool state C {widths}")
    serve_line(runs, eng, f"{cfg.name} cut artifact, contiguous, pool "
               f"state C {sorted(widths)[0]}", card, totals, tag="[xlstm]")
    del eng, cut
    _free()
    stage("hqp_and_cut_artifact")
    print(f"[xlstm] phase seconds {time.monotonic() - t_phase:.1f} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f")  [{card}]")
    return launches


# ------------------------------------------------------------- family train
def _grad_off_share(got, want):
    """Two gradient trees of one structure -> (the share of all values more
    than GRAD_FRAC of their leaf's largest |want| from ``want``, the worst
    leaf's ||got - want|| / ||want||, its index in leaf order): the norm
    at least FAMILY_LEAF_FLOOR of the largest leaf's."""
    from repro_torch import tree
    pairs = [(a.detach().float().cpu(), b.detach().float().cpu())
             for a, b in zip(tree.leaves(got), tree.leaves(want))]
    off = sum(int(((a - b).abs() > GRAD_FRAC * b.abs().max()).sum())
              for a, b in pairs)
    floor = FAMILY_LEAF_FLOOR * max(float(b.norm()) for _, b in pairs)
    errs = [float((a - b).norm()) / max(float(b.norm()), floor)
            for a, b in pairs]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return off / sum(b.numel() for _, b in pairs), errs[worst], worst


def _family_smoke(dev, card):
    """The three families' smoke configs, card against CPU (the plain
    versions): ``lm.loss_fn(with_aux=True)`` at the train capacity and its
    gradient (the bounds by FAMILY_AUX_RTOL); then 4 steps of
    ``make_train_step`` on the card with a checkpoint after 2 saved,
    restored and replayed: the same bits as the uninterrupted run."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.core.sensitivity import value_and_grad
    from repro_torch.launch import checkpoint as ckpt
    from repro_torch.launch.serve import _calib_batch
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import to_device
    for arch, _, state_dtype, _, _ in FAMILY_TRAIN:
        cfg = configs.get_smoke_config(arch)
        experts = cfg.moe is not None and cfg.moe.n_experts > 0
        params = lm.init_params(cfg, seed=0, device="cpu")
        tokens = _calib_batch(cfg, 2, 32, "cpu")["tokens"]
        fn = value_and_grad(lambda p, b: lm.loss_fn(
            p, cfg, b, with_aux=True, moe_no_drop=False), has_aux=True)
        (lc, ac), gc = fn(params, {"tokens": tokens})
        gpu = to_device(params, dev)
        (ld, ad), gd = fn(gpu, {"tokens": tokens.to(dev)})
        loss_rel = abs(float(ld) - float(lc)) / abs(float(lc))
        aux_rel = max((abs(float(ad[k]) - float(ac[k])) / abs(float(ac[k]))
                       for k in ac), default=0.0)
        share, leaf_rel, worst = _grad_off_share(gd, gc)
        limit = FAMILY_MOE_OFF if experts else FAMILY_XLSTM_OFF
        print(f"[train-family] {cfg.name}, card vs CPU plain path, batch 2 "
              f"x 32 with drops: loss {float(ld):.6f} vs {float(lc):.6f} "
              f"(rel {loss_rel:.3g}, limit {TRAIN_LOSS_RTOL}), aux worst rel "
              f"{aux_rel:.3g} (limit {FAMILY_AUX_RTOL}), gradient values "
              f"off {share:.5f} (limit {limit}), worst leaf (#{worst}) "
              f"{leaf_rel:.4g} of its norm (limit {FAMILY_LEAF_REL})  "
              f"[{card}]")
        if not (loss_rel <= TRAIN_LOSS_RTOL and aux_rel <= FAMILY_AUX_RTOL
                and share <= limit and leaf_rel <= FAMILY_LEAF_REL
                and sorted(ad) == sorted(ac) and bool(ad) == experts):
            fail(f"{cfg.name} smoke: card and CPU disagree")
        ocfg = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
        step = make_train_step(cfg, ocfg, moe_no_drop=False)
        gen = torch.Generator().manual_seed(2)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                            generator=gen).to(dev)}
                   for _ in range(4)]
        p, o = gpu, adamw_init(gpu, ocfg)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for i, b in enumerate(batches):
                if i == 2:
                    ckpt.save(tmp, 2, (p, o))
                p, o, _ = step(p, o, b)
            (p2, o2), meta = ckpt.restore(tmp, (gpu, adamw_init(gpu, ocfg)))
        for b in batches[meta["step"]:]:
            p2, o2, _ = step(p2, o2, b)
        bad = _differ((p, o), (p2, o2))
        if bad:
            fail(f"{cfg.name} smoke: resumed run differs in leaves "
                 f"{bad[:5]}")
        print(f"[train-family] {cfg.name}: {state_dtype} moments, a "
              f"checkpoint of step 2 saved, restored and replayed to 4 on "
              f"the card: params and moments equal to the uninterrupted "
              f"run bit for bit  [{card}]")


def _c12_on_card(dev, kernels, card):
    """ROADMAP C12 on the card: the smoke qwen3 and phi3.5-moe models
    compressed on C12's input (every kv head, every expert and MLP channel
    cut), compacted == masked, the artifact served by the engine equal to
    serial decode, contiguous and paged, with 0 KV bytes and no kernel
    launched; then each attend op handed 0 kv heads on the card refuses by
    name."""
    import torch
    from repro_torch import configs
    from repro_torch.compress.artifact import compress
    from repro_torch.core import sensitivity as sens
    from repro_torch.core.pipeline import HQPConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import _calib_batch
    from repro_torch.models import lm
    from repro_torch.serving import (Engine, Request, SchedulerConfig,
                                     serial_decode)
    for arch in ("qwen3-0.6b", MOE_ARCH):
        cfg = configs.get_smoke_config(arch)
        params = lm.init_params(cfg, seed=0, device=dev)
        batch = _calib_batch(cfg, 2, 32, dev)
        sq = sens.fisher_diag(sens.loss_grad_fn(
            lambda p, b: lm.loss_fn(p, cfg, b)), params, [batch])[0]
        art = compress(params, cfg, sq, lambda p: 1.0, HQPConfig(
            step_frac=0.5, max_steps=2, weight_granularity="channel"),
            log=lambda s: None)
        if set(art.manifest.theta_by_family.values()) != {1.0}:
            fail(f"C12 {cfg.name}: not every unit cut "
                 f"{art.manifest.theta_by_family}")
        hm = lm.forward(art.prune.params_sparse, cfg, batch)
        hc = lm.forward(art.prune.params_compact, cfg, batch)
        if not torch.equal(hm, hc):
            fail(f"C12 {cfg.name}: compacted != masked on the card")
        gen = torch.Generator().manual_seed(0)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist() for n in (5, 9, 3)]
        want = [serial_decode(art.params, cfg, p, 6, max_seq=64,
                              device=dev) for p in prompts]
        for page_size in (None, SERVE_PAGE):
            for kern in kernels.values():
                kern.launches = 0
            eng = Engine(art.params, cfg, n_slots=2, max_seq=64,
                         sched=SchedulerConfig(prefill_chunk=4), device=dev,
                         page_size=page_size)
            res = eng.run([Request(prompt=p, max_new_tokens=6)
                           for p in prompts], arrival_ticks=[0, 0, 3])
            torch.cuda.synchronize()
            got = [res[i].tokens for i in range(3)]
            stray = {n: k.launches for n, k in kernels.items()
                     if k.launches}
            if got != want or eng.stats["kv_bytes"] or stray:
                fail(f"C12 {cfg.name} page_size={page_size}: engine "
                     f"{got} vs serial {want}, kv_bytes "
                     f"{eng.stats['kv_bytes']}, launches {stray}")
        print(f"[c12] {cfg.name} smoke on C12's input: θ 100 % in every "
              f"family, compacted == masked bit for bit, the artifact "
              f"served contiguous and paged == serial decode ({want[0]}...),"
              f" 0 KV bytes, no kernel launched  [{card}]")
    q = torch.randn(2, 4, 0, 16, device=dev).to(torch.bfloat16)
    k = torch.zeros(2, 8, 0, 16, device=dev, dtype=torch.bfloat16)
    cache = {"k": k, "v": k.clone()}
    arena = {"k": torch.zeros(4, 4, 0, 16, device=dev, dtype=torch.bfloat16),
             "v": torch.zeros(4, 4, 0, 16, device=dev, dtype=torch.bfloat16)}
    pages = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=dev)
    calls = {"flash_attention": lambda: ops.flash_attention(q, k, k),
             "prefill_attention": lambda: ops.prefill_attention(q, cache, 0),
             "decode_attention": lambda: ops.decode_attention(q[:, :1],
                                                              cache, 3),
             "paged_prefill_attention": lambda: ops.prefill_attention(
                 q, arena, 0, pages=pages),
             "paged_decode_attention": lambda: ops.decode_attention(
                 q[:, :1], arena, 3, pages=pages)}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "0 kv heads" not in str(e):
                fail(f"C12 {name}: refused for another cause: {e}")
        else:
            fail(f"C12 {name}: 0 kv heads not refused on the card")
    torch.cuda.synchronize()
    print(f"[c12] B3-B7 on the card: each of {', '.join(calls)} refuses 0 "
          f"kv heads by name  [{card}]")


def _first_gradient(params, cfg, batch, ocfg):
    """The first step's gradient as AdamW takes it: (its global norm, the
    clip factor, the share of its values under ``ocfg.eps`` once clipped,
    that share in the output table), from the train route with drops."""
    import torch
    from repro_torch import tree
    from repro_torch.core.sensitivity import value_and_grad
    from repro_torch.models import lm
    g = value_and_grad(lambda p, b: lm.loss_fn(
        p, cfg, b, with_aux=True, moe_no_drop=False)[0])(params, batch)[1]
    out = lm.unembed_params(g, cfg)["table"]
    leaves = tree.leaves(g)
    norm = math.sqrt(sum(float(t.float().square().sum()) for t in leaves))
    clip = min(1.0, ocfg.grad_clip / max(norm, 1e-12))

    def under(t):
        return int((t.float().abs() * clip < ocfg.eps).sum())
    share = sum(under(t) for t in leaves) / sum(t.numel() for t in leaves)
    out_share = under(out) / out.numel()
    del g, leaves, out
    torch.cuda.synchronize()
    return norm, clip, share, out_share


def _train_family(arch, n_layers, state_dtype, flash_per_step, lr, dev,
                  kernels, card, gate=True, replay=True, moe_weights=None):
    """One family at full width: FAMILY_STEPS steps of ``make_train_step``
    at ``lr`` with the launcher's drops, from launch counts at 0 (B7
    ``flash_per_step`` times a step, no other kernel), every loss, aux and
    param finite; the CE on the first batch (no drops, no aux) before the
    first step and after the last, which must fall by FAMILY_FALL; the
    first gradient's norm, clip factor and share under eps
    (``_first_gradient``), printed; the last FAMILY_RESUME steps replayed
    from params and moments copied to host memory before them, equal to
    the uninterrupted run bit for bit; the share of (token, expert) pairs
    dropped in each MoE layer on the last batch. ``gate=False`` reports
    the learning gates' figures and non-finite values without failing on
    them, ``replay=False`` skips the replay, ``moe_weights`` replaces
    fields of ``cfg.moe`` (the aux losses' weights). A config with a
    frontend gets seeded random embeddings before each row. Returns the
    launches of the FAMILY_STEPS steps and the trained params."""
    import torch
    from repro_torch import configs, tree
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch.quickstart import DATA_VOCAB
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    full = configs.get_config(arch)
    cfg = (full if n_layers is None else _cut_hybrid(n_layers)
           if arch == HYBRID_ARCH else _cut(arch, n_layers))
    if moe_weights:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_weights))
    data = SyntheticTokens(min(cfg.vocab_size, DATA_VOCAB), FAMILY_SEQ,
                           FAMILY_BATCH * FAMILY_STEPS, seed=0,
                           determinism=0.9)
    it = data.batches(FAMILY_BATCH, seed=0)
    batches = [{"tokens": torch.as_tensor(next(it)["tokens"],
                                          dtype=torch.long, device=dev)}
               for _ in range(FAMILY_STEPS)]
    if cfg.n_frontend:
        gen = torch.Generator(device=dev).manual_seed(5)
        for batch in batches:
            batch["embeds"] = torch.randn(
                (FAMILY_BATCH, cfg.n_frontend, cfg.d_model), generator=gen,
                device=dev).to(torch.bfloat16)
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm.init_params(cfg, seed=0, device=dev)
    ocfg = AdamWConfig(lr=lr, state_dtype=state_dtype)
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg, moe_no_drop=False)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = _n_params(params)

    def first_ce(p):
        with torch.no_grad():
            return float(lm.loss_fn(p, cfg, batches[0]))
    gnorm, clip, under, out_under = _first_gradient(params, cfg, batches[0],
                                                    ocfg)
    ce_before = first_ce(params)
    resume_at = FAMILY_STEPS - FAMILY_RESUME
    for kern in kernels.values():
        kern.launches = 0
    losses, aux, ms = [], {}, []
    for i, batch in enumerate(batches):
        if replay and i == resume_at:   # page-locked: copied unstaged
            saved = tree.map_(lambda t: torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(t),
                (params, opt))
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.monotonic() - t0))
        losses.append(float(m["loss"]))
        for k, v in m.items():
            if k != "loss":
                aux.setdefault(k, []).append(float(v))
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    ce_after = first_ce(params)
    nonfinite = sum(int((~torch.isfinite(t)).sum())
                    for t in tree.leaves(params))
    print(f"[train-family] {cfg.name}: the first gradient at init: global "
          f"norm {gnorm:.6g}, clip factor {clip:.6g}, {under:.4f} of its "
          f"values under eps {ocfg.eps} once clipped ({out_under:.4f} of the "
          f"output table's); CE on the first batch {ce_before:.4f} before "
          f"the first step, {ce_after:.4f} after the last (lr {lr}); "
          f"{nonfinite} non-finite param values after it  [{card}]")
    if gate and (nonfinite or not all(math.isfinite(v) for v in (
            losses + sum(aux.values(), []) + [ce_before, ce_after]))):
        fail(f"train {cfg.name}: non-finite loss {losses}, aux {aux}, CE "
             f"{ce_before} -> {ce_after} or {nonfinite} param values")
    if gate and not ce_after <= (1 - FAMILY_FALL) * ce_before:
        fail(f"train {cfg.name}: the first batch's CE {ce_before:.4f} -> "
             f"{ce_after:.4f} fell by less than {FAMILY_FALL} of it")
    experts = any(moe for _, moe in lm.layer_specs(cfg))
    if experts != bool(aux):
        fail(f"train {cfg.name}: aux {sorted(aux)} with experts={experts}")
    want = {n: 0 for n in kernels}
    want["flash_attention"] = flash_per_step * FAMILY_STEPS
    if launches != want:
        fail(f"train {cfg.name}: launches {launches}, expected {want}")
    p, o = params, opt
    if replay:
        # the resume: the host copy back on the card beside the
        # uninterrupted run's result (at most 21 GB more than the training
        # peak), replayed
        t0 = time.monotonic()
        p, o = tree.map_(lambda t: t.to(dev), saved)
        del saved
        for batch in batches[resume_at:]:
            p, o, _ = step(p, o, batch)
        bad = _differ((params, opt), (p, o))
        torch.cuda.synchronize()
        resume_s = time.monotonic() - t0
        if bad:
            fail(f"train {cfg.name}: the replay of the last {FAMILY_RESUME} "
                 f"steps differs from the uninterrupted run in leaves "
                 f"{bad[:5]}")
    del params, opt
    # the share of pairs the capacity drops in each MoE layer
    drops = []
    if experts:
        plan = M.dispatch_plan

        def counted(idx, e, cap):
            slot, local, counts = plan(idx, e, cap)
            drops.append(1 - float(local.float().mean()))
            return slot, local, counts
        M.dispatch_plan = counted
        try:
            with torch.no_grad():
                lm.forward(p, cfg, batches[-1], moe_no_drop=False)
        finally:
            M.dispatch_plan = plan
    del o
    tokens = FAMILY_BATCH * FAMILY_SEQ
    steady = sum(ms[1:]) / (len(ms) - 1)
    layers = (f"{cfg.n_layers} of {full.n_layers} layers"
              if n_layers is not None else f"all {cfg.n_layers} layers")
    print(f"[train-family] {cfg.name} published width, {layers} "
          f"({', '.join(sorted(set(cfg.pattern)))}), {n_params / 1e9:.3f} B "
          f"params, AdamW {state_dtype} moments, lr {lr}, "
          f"{FAMILY_STEPS} steps of {FAMILY_BATCH} x {FAMILY_SEQ} tokens"
          + (f" after {cfg.n_frontend} random frontend embeddings"
             if cfg.n_frontend else "")
          + f" with the capacity factor's drops: init {init_s:.2f} s, first "
          f"step {ms[0]:.1f} ms, then {steady:.2f} ms a step "
          f"(synchronised), {1e3 * tokens / steady:.0f} tokens/s, peak "
          f"device memory {peak / 2**30:.2f} GiB; loss "
          f"{json.dumps([round(v, 4) for v in losses])}"
          + "".join(f"; {k} {json.dumps([float(f'{v:.4g}') for v in vs])}"
                    for k, vs in aux.items())
          + f"; B7 launches {launches['flash_attention']} ({flash_per_step} "
          f"a step), no other kernel  [{card}]")
    if experts:
        print(f"[train-family] {cfg.name}: (token, expert) pairs dropped at "
              f"capacity factor {cfg.moe.capacity_factor} (C = "
              f"{M.capacity(tokens, cfg)} of {tokens} tokens, "
              f"{cfg.moe.n_experts} experts, top-{cfg.moe.experts_per_token}"
              f", aux weights {cfg.moe.load_balance_loss} and "
              f"{cfg.moe.router_z_loss}) on the last batch, per MoE layer: "
              f"{json.dumps([round(d, 4) for d in drops])}  [{card}]")
    if replay:
        print(f"[train-family] {cfg.name}: the last {FAMILY_RESUME} steps "
              f"replayed from params and moments copied to host memory "
              f"before them, in {resume_s:.1f} s with the copy back: equal "
              f"to the uninterrupted run bit for bit  [{card}]")
    return launches, p


def phase_train_families(dev, kernels, report, card):
    """Training of the MoE, hybrid and xLSTM families on the card:

    1. B7 at phi3.5-moe's train shape (PHI_TRAIN_FLASH) checked against
       its plain version and timed beside SDPA and its bound (into
       ``flash_attention``'s ``train_shapes``);
    2. each of FAMILY_TRAIN at its published width (``_train_family``):
       the first batch's CE falling, finite losses, aux and params, B7
       launches, ms a step, tokens/s, peak memory, the drop share a MoE
       layer, a bit-for-bit replay;
    3. the smoke configs card == CPU and a checkpoint resume
       (``_family_smoke``);
    4. ROADMAP C12 on the card (``_c12_on_card``).
    Returns {kernel: {arch: launches over the FAMILY_STEPS steps}}."""
    import torch
    from repro_torch.kernels import flash_attention as kf, ref
    t_phase = time.monotonic()
    b, s, hq, hkv, hd = PHI_TRAIN_FLASH
    what = f"q ({b}, {s}, {hq}, {hd}) vs k/v ({b}, {s}, {hkv}, {hd}) bf16"
    q, k, v = _flash_case(dev, b, s, hq, hkv, hd)
    out, lse = kf.flash_attention_fwd(q, k, v)
    want, want_lse = ref.flash_attention_lse_ref(q, k, v)
    err = _attn_err(out, want, what)
    rel = _attn_rows(out, want, what)
    d = (lse - want_lse).abs().max().item()
    if not d <= LSE_ATOL:
        fail(f"{what}: max |lse - plain| = {d:.4g} over {LSE_ATOL}")
    b_ms, by = _flash_bound(b, s, hq, hkv, hd)
    t = dict(bound_ms=b_ms, bound_by=by, max_abs_err=err, max_row_rel=rel,
             **timed(lambda: kf.flash_attention_fwd(q, k, v),
                     lambda: ref.flash_attention_lse_ref(q, k, v),
                     _sdpa_causal(q, k, v), calls=10))
    report["flash_attention"]["train_shapes"][
        f"{what} (phi3.5-moe train)"] = t
    print(f"[kernel] flash_attention at {what} (phi3.5-moe's train shape): "
          + _times(t) + f", max |err| {err:.3g}, worst row {rel:.3g}  "
          f"[{card}]")
    del q, k, v, out, lse, want, want_lse
    stages = {"b7": time.monotonic() - t_phase}
    launches = {}
    for arch, n_layers, state_dtype, flash, lr in FAMILY_TRAIN:
        t0 = time.monotonic()
        launches[arch] = _train_family(arch, n_layers, state_dtype, flash,
                                       lr, dev, kernels, card)[0]
        _free()
        stages[arch] = time.monotonic() - t0
    t0 = time.monotonic()
    _family_smoke(dev, card)
    stages["smoke"] = time.monotonic() - t0
    t0 = time.monotonic()
    _c12_on_card(dev, kernels, card)
    torch.cuda.synchronize()
    stages["c12"] = time.monotonic() - t0
    print(f"[train-family] phase {time.monotonic() - t_phase:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f"  [{card}]")
    return {name: {arch: c[name] for arch, c in launches.items()}
            for name in kernels}


# ---------------------------------------------------------------- frontends
def _b1_frontend(dev, report, card):
    """B1 at the frontend linear's products (FRONT_GEMMS), bit for bit
    against its plain version, its serving form too (``_b1_case``); then
    device ms of B1 on int8 x beside its plain version and its bound, and
    beside ``torch._int_mm`` with the scale epilogue (the one library call
    that computes it, for M > 16), and of the serving form (bf16 x) beside
    its bound; into each kernel's ``frontend_shapes``. The weights (9.4 MB
    and 2.4 MB) stay in the 50 MB L2 across the timed launches."""
    import torch
    from repro_torch.kernels import int8_matmul as km, ref
    gen = lambda *shape: torch.randint(-127, 128, shape, device=dev,
                                       dtype=torch.int8)
    for m, k, n in FRONT_GEMMS:
        _b1_case(dev, m, k, n)
        xq, wq = gen(m, k), gen(k, n)
        xs = torch.rand(m, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, device=dev) * 0.05 + 1e-3
        x = torch.randn(m, k, device=dev).to(torch.bfloat16)

        def library():
            acc = torch._int_mm(xq, wq)
            return (acc.float() * xs[:, None] * ws[None]).to(torch.bfloat16)
        want = ref.int8_matmul_ref(xq, wq, xs, ws)
        got = library()
        torch.cuda.synchronize()
        d = ((got.float() - want.float()).abs()
             / want.float().abs().clamp_min(1e-30)).max().item()
        if not d <= 2 ** -7:           # one bf16 ulp: the epilogue's order
            fail(f"torch._int_mm at ({m}, {k}) x ({k}, {n}) is {d:.3g} off "
                 f"B1's plain version")
        label = f"({m}, {k}) x ({k}, {n})"
        b_ms, by = _gemm_bound(m, k, n)
        t = dict(bound_ms=b_ms, bound_by=by,
                 **timed(lambda: km.int8_matmul(xq, wq, xs, ws),
                         lambda: ref.int8_matmul_ref(xq, wq, xs, ws),
                         library, calls=10),
                 library="torch._int_mm + scale epilogue")
        report["int8_matmul"].setdefault("frontend_shapes", {})[label] = t
        b_q, by_q = _gemm_bound(m, k, n, x_bytes=2)
        tq = dict(ms=device_ms(lambda: km.int8_matmul_quant(x, wq, ws),
                               calls=10), bound_ms=b_q, bound_by=by_q)
        report["int8_matmul_quant"].setdefault("frontend_shapes", {})[
            label] = tq
        print(f"[frontend] B1 at {label} ({km.gemm_plan(m, n, k)}): "
              + _times(t) + f"; {t['ms'] / b_ms:.1f}x its bound, "
              f"{t['ms'] / t['library_ms']:.2f}x torch._int_mm; serving "
              f"form (bf16 x) {tq['ms']:.5f} ms, bound {b_q:.6f} ms "
              f"({by_q})  [{card}]")


def _front_rows(cfg) -> tuple:
    """GEMM_M and every M that ``_front_serve`` gives B1: the frontend
    linear's B·n_fr, a prefill's B·(n_fr + FRONT_PROMPT), the chunked
    prefill's B·(n_fr + FRONT_CHUNK) and B·(FRONT_PROMPT - FRONT_CHUNK), a
    decode step's B, for B 1 (a request alone) and FRONT_REQUESTS."""
    n_fr = cfg.n_frontend
    return tuple(sorted(set(GEMM_M) | {
        b * r for b in (1, FRONT_REQUESTS)
        for r in (1, n_fr, n_fr + FRONT_PROMPT, n_fr + FRONT_CHUNK,
                  FRONT_PROMPT - FRONT_CHUNK)}))


def _front_chunked(params, cfg, dev, prompts, emb, max_seq):
    """The last-position logits of a prefill of the embeddings ``emb`` and
    the first FRONT_CHUNK tokens of ``prompts``, then of the rest, INT8
    KV."""
    from repro_torch.models import lm
    state = lm.init_decode_state(cfg, prompts.shape[0], max_seq,
                                 params=params, quantized_kv=True, device=dev)
    _, state = lm.decode_step(params, cfg, state, prompts[:, :FRONT_CHUNK],
                              route="prefill", embeds=emb)
    logits, _ = lm.decode_step(params, cfg, state, prompts[:, FRONT_CHUNK:],
                               route="prefill")
    return logits[:, -1]


def _front_serve(params, cfg, dev, kernels, card, label):
    """An INT8 frontend model's lockstep serving on the card, through the
    launcher's ``serve.lockstep``: FRONT_REQUESTS requests, each seeded
    random embeddings and a FRONT_PROMPT-token prompt, FRONT_NEW greedy
    tokens, INT8 KV. Gates: each request run alone gives its row of the
    batch bit for bit; the batch's launches are B1 (serving form) once for
    the frontend and once a linear a position step, B4 once a layer, B3
    once a layer a decode step, nothing else; the prefill of the
    embeddings and the first FRONT_CHUNK tokens, then the rest, gives the
    whole prefill's last logits bit for bit; finite logits, tokens in the
    vocabulary; the engine refuses the config. Returns the batch's
    launches."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import Engine
    max_seq, n_fr = FRONT_MAX_SEQ[cfg.name], cfg.n_frontend
    gen = torch.Generator(device=dev).manual_seed(21)
    emb = torch.randn((FRONT_REQUESTS, n_fr, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (FRONT_REQUESTS, FRONT_PROMPT),
                            generator=torch.Generator().manual_seed(22)
                            ).to(dev)

    def run(rows):
        return serve.lockstep(params, cfg, prompts[rows], FRONT_NEW,
                              max_seq, True, dev, embeds=emb[rows])
    alone = [run(slice(i, i + 1)).tokens for i in range(FRONT_REQUESTS)]
    for kern in kernels.values():
        kern.launches = 0
    batch = run(slice(None))
    launches = {n: k.launches for n, k in kernels.items()}
    lin, layers = _n_linears(params), cfg.n_layers
    want = {n: 0 for n in kernels}
    want.update(int8_matmul_quant=1 + lin * FRONT_NEW,
                prefill_attention=layers,
                decode_attention=layers * (FRONT_NEW - 1))
    if launches != want:
        fail(f"{cfg.name} lockstep: launches {launches}, expected {want}")
    toks, first = batch.tokens, batch.first_logits
    if not (torch.isfinite(first).all() and 0 <= toks.min()
            and toks.max() < cfg.vocab_size):
        fail(f"{cfg.name} lockstep: non-finite logits or tokens {toks}")
    for i, row in enumerate(alone):
        if not (row[0] == toks[i]).all():
            fail(f"{cfg.name} lockstep: request {i} alone gives "
                 f"{row[0].tolist()}, in the batch {toks[i].tolist()}")
    _equal(_front_chunked(params, cfg, dev, prompts, emb, max_seq), first,
           f"{cfg.name}: prefill of the embeddings and {FRONT_CHUNK} tokens, "
           f"then {FRONT_PROMPT - FRONT_CHUNK}, vs the whole prefill (last "
           f"logits)")
    try:
        Engine(params, cfg, device=dev)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        fail(f"{cfg.name}: the engine took a frontend config")
    print(f"[frontend] {cfg.name} {label}, lockstep, INT8 KV: "
          f"{FRONT_REQUESTS} requests of {n_fr} random embeddings + "
          f"{FRONT_PROMPT} tokens, {FRONT_NEW} new, max_seq {max_seq}: "
          f"prefill {1e3 * batch.prefill_s:.1f} ms "
          f"({FRONT_REQUESTS * (n_fr + FRONT_PROMPT)} positions), decode "
          f"{FRONT_REQUESTS * (FRONT_NEW - 1) / batch.decode_s:.1f} tok/s "
          f"(eager, synchronised), KV {batch.kv_bytes} B; launches "
          f"{json.dumps({n: c for n, c in launches.items() if c})}; each "
          f"request alone == its row, bit for bit; chunked prefill == "
          f"whole; the engine refuses: {refusal!r}  [{card}]")
    return launches


def _front_main(cfg, card):
    """The launcher's ``serve.main`` on the arch's published config (bf16,
    zero embeddings, FRONT_MAIN_PROMPT tokens, FRONT_MAIN_NEW new): it
    returns one row of tokens in the vocabulary."""
    from repro_torch.launch import serve
    t0 = time.monotonic()
    out = serve.main(["--arch", cfg.name, "--batch", "1", "--prompt-len",
                      str(FRONT_MAIN_PROMPT), "--tokens",
                      str(FRONT_MAIN_NEW), "--max-seq",
                      str(FRONT_MAX_SEQ[cfg.name])])
    if out.shape != (1, FRONT_MAIN_NEW) or not (
            0 <= out.min() and out.max() < cfg.vocab_size):
        fail(f"serve.main --arch {cfg.name}: returned {out}")
    print(f"[frontend] serve.main --arch {cfg.name} (bf16, lockstep, 1 "
          f"request): {out[0].tolist()} in {time.monotonic() - t0:.1f} s  "
          f"[{card}]")
    _free()


def phase_frontends(dev, kernels, report, card):
    """The frontend configs on the card, at their published depth and
    width:

    1. B1 at the frontend linear's products (``_b1_frontend``);
    2. phi-3-vision-4.2b: seeded bf16 init, the launcher's
       ``build_artifact`` (the Fisher pass and FRONT_PRUNE_STEPS + 1
       evaluations on the train route, B7 at hd 96 once a layer a forward,
       no other kernel; compaction, PTQ, the frontend linear INT8 and in no
       pruning family), B1 at its (K, N) and every M the lockstep gives
       it (``_front_rows``); the artifact served
       (``_front_serve``), then ``serve.main`` (``_front_main``);
    3. musicgen-medium: FAMILY_STEPS AdamW steps (``_train_family``: the
       first batch's CE falling by FAMILY_FALL, finite losses and params,
       B7 once a layer a step), INT8 PTQ of the trained params, B1 at its
       (K, N) and the lockstep's M, served and ``serve.main`` likewise.
    Returns {kernel: {arch: {stage: launches}}}."""
    import torch
    from repro_torch import configs
    from repro_torch.compress import QuantizedLinear
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.launch.serve import build_artifact
    from repro_torch.models import lm
    t_phase = time.monotonic()
    stages, out = {}, {n: {} for n in kernels}

    def stage(name):
        stages[name] = time.monotonic() - t_phase - sum(stages.values())
    _b1_frontend(dev, report, card)
    stage("b1")

    cfg = configs.get_config(FRONT_ARCHS[0])
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[frontend] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded to {lm.padded_vocab(cfg)}, {cfg.n_frontend} "
          f"{cfg.frontend.kind} through a ({cfg.d_model}, {cfg.d_model}) "
          f"frontend linear; published depth and width; "
          f"{_n_params(params) / 1e9:.3f} B params "
          f"({cfg.param_count() / 1e9:.3f} B by the config's count, which "
          f"leaves out the frontend "
          f"linear); seeded bf16 init {time.monotonic() - t0:.2f} s  "
          f"[{card}]")
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.monotonic()
    art = build_artifact(params, cfg, FRONT_PRUNE_STEPS, log=print)
    wall = time.monotonic() - t0
    hqp = {n: k.launches for n, k in kernels.items()}
    m, sec = art.manifest, art.seconds
    n_forward = 1 + len(sec["evals"])
    print(m.summary())
    print(f"[frontend] {cfg.name} HQP (batch ({CALIB_B}, {cfg.n_frontend} + "
          f"{CALIB_S})): {wall:.2f} s in all; Fisher {sec['fisher']:.3f} s, "
          f"evals {', '.join(f'{t:.3f}' for t in sec['evals'])}, compact "
          f"{sec['compact']:.3f}, PTQ {sec['ptq']:.3f}; θ "
          f"{m.theta:.4f}, flash launches {hqp['flash_attention']} over "
          f"{n_forward} forwards; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
    want = {n: 0 for n in kernels}
    want["flash_attention"] = cfg.n_layers * n_forward
    if hqp != want:
        fail(f"{cfg.name} compress: launches {hqp}, expected {want}")
    if not (m.pruned and isinstance(art.params["frontend"], QuantizedLinear)
            and not any("frontend" in f for f in m.theta_by_family)):
        fail(f"{cfg.name} compress: pruned {m.pruned}, families "
             f"{sorted(m.theta_by_family)}, frontend "
             f"{type(art.params['frontend']).__name__}")
    int8 = art.params
    del art, params
    _free()
    stage(f"{cfg.name} hqp")
    _b1_model_shapes(dev, (int8,), f"{cfg.name}'s artifact", "frontend",
                     card, ms=_front_rows(cfg))
    serve_launches = _front_serve(int8, cfg, dev, kernels, card,
                                  f"HQP artifact (θ={m.theta:.1%})")
    del int8
    _free()
    _front_main(cfg, card)
    for n in kernels:
        out[n][cfg.name] = {"compress": hqp[n], "lockstep": serve_launches[n]}
    stage(f"{cfg.name} serve")

    cfg = configs.get_config(FRONT_ARCHS[1])
    train, trained = _train_family(cfg.name, None, "f32", cfg.n_layers,
                                   FRONT_LR, dev, kernels, card, replay=False)
    stage(f"{cfg.name} train")
    int8 = quantize_lm_params(trained)
    del trained
    _free()
    _b1_model_shapes(dev, (int8,), f"{cfg.name}'s INT8 PTQ", "frontend",
                     card, ms=_front_rows(cfg))
    serve_launches = _front_serve(int8, cfg, dev, kernels, card,
                                  f"trained {FAMILY_STEPS} steps, INT8 PTQ")
    del int8
    _free()
    _front_main(cfg, card)
    for n in kernels:
        out[n][cfg.name] = {"train": train[n], "lockstep": serve_launches[n]}
    stage(f"{cfg.name} serve")
    print(f"[frontend] phase seconds {time.monotonic() - t_phase:.1f} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f")  [{card}]")
    return out


def _rec_bytes(pool) -> int:
    from repro_torch.serving import state_pool as sp
    return sum(t.numel() * t.element_size() for e in pool["caches"]
               if not sp.is_kv_entry(e) for t in e.values())


def _six_digits(o):
    """``o`` with every float to six significant digits (far below the
    timings' run-to-run spread), so that the kernels line stays compact:
    a reader that keeps only the last 24,000 bytes of the output still
    gets it whole."""
    if isinstance(o, float):
        return float(f"{o:.6g}")
    if isinstance(o, dict):
        return {k: _six_digits(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_six_digits(v) for v in o]
    return o


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global CHIP
    from repro_torch.roofline.hardware import H100_SXM as CHIP
    # lines reach a pipe as they are printed, and a hang dumps every
    # thread's stack and exits nonzero before the 1200 s limit
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    t_start = time.monotonic()
    laps = {}

    def lap(name):
        """Wall seconds of the part of the run that ends here, printed as
        it ends (a run cut by HANG_S shows how far it got)."""
        laps[name] = time.monotonic() - t_start - sum(laps.values())
        print(f"[time] {name} {laps[name]:.1f} s, {sum(laps.values()):.1f} "
              f"s since the start")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["unknown"])[0]
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import build
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     int8_matmul, prefill_attention, quantize)
    t0 = time.monotonic()
    took = build.build()
    print(f"[build] {len(took)} libraries in {time.monotonic() - t0:.1f}s: "
          + ", ".join(f"{n} {s:.1f}s" for n, s in sorted(took.items())))
    for lib, log in sorted(build.logs.items()):
        print(f"[ptxas] {lib}: " + "; ".join(
            f"{k} {regs} registers, spill stores/loads {st}/{ld} B"
            for k, regs, st, ld in build.ptxas_summary(log)))
    kernels = {"quantize_rowwise": quantize.KERNEL,
               "int8_matmul": int8_matmul.KERNEL,
               "int8_matmul_quant": int8_matmul.QUANT_KERNEL,
               "decode_attention": decode_attention.KERNEL,
               "prefill_attention": prefill_attention.KERNEL,
               "paged_decode_attention": decode_attention.PAGED_KERNEL,
               "paged_prefill_attention": prefill_attention.PAGED_KERNEL,
               "flash_attention": flash_attention.KERNEL}
    lap("build")
    dryrun = dryrun_start()
    report = {}
    for phase in (phase_quantize, phase_int8_matmul, phase_decode,
                  phase_prefill, phase_paged_decode, phase_paged_prefill,
                  phase_flash, phase_hd96):
        phase(dev, report)
        lap(phase.__name__)
    for name, r in report.items():
        print(f"[kernel] {name} at {r['shape']}: " + _times(r)
              + f", max |err| {r['max_abs_err']:.3g}  [{card}]")
        if "max_row_rel" in r:
            print(f"[kernel] {name} output rows over its checked shapes: "
                  f"max ||kernel - plain|| / ||plain|| "
                  f"{r['max_row_rel']:.4g} (limit {ATTN_ROW_REL})  [{card}]")
        for shape, t in r.get("train_shapes", {}).items():
            print(f"[kernel] {name} at {shape} (train route): " + _times(t)
                  + f"  [{card}]")
        for key, label in (("bf16_kv", "with bf16 KV"), ("long_s", "")):
            if key in r:
                print(f"[kernel] {name} {label or 'at ' + r[key]['shape']}: "
                      + _times(r[key]) + f"  [{card}]")
        if "b2_b1_ms" in r:
            print(f"[kernel] {name} at {r['shape']}: B2 then B1 "
                  f"{r['b2_b1_ms']:.5f} ms (device)  [{card}]")
        for shape, o in r.get("shapes", {}).items():
            if "plan" in o:
                b2_b1 = (f", B2 then B1 {o['b2_b1_ms']:.5f} ms (device)"
                         if "b2_b1_ms" in o else "")
                print(f"[kernel] {name} at {shape}: kernel {o['ms']:.5f} ms "
                      f"(device){b2_b1}, bound {o['bound_ms']:.6f} ms "
                      f"({o['bound_by']}), {o['plan']}  [{card}]")
                continue
            for kv, t in o.items():
                print(f"[kernel] {name} at {shape}, {kv} KV: " + _times(t)
                      + f"  [{card}]")
    e2e, h_err, loss_dev, loss_cpu = phase_small_e2e(dev)
    print(f"[e2e] smoke model, card vs CPU plain path: max |logit diff| "
          f"{e2e:.4g}; train route max |hidden diff| {h_err:.4g}, loss "
          f"{loss_dev:.6f} (card) vs {loss_cpu:.6f} (CPU)")
    lap("small_e2e")
    phase_static(dev, card)
    lap("static")

    from repro_torch import configs
    from repro_torch.compress.quantize import quantize_lm_params
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import lm
    cfg = configs.get_config("qwen3-0.6b")
    t0 = time.monotonic()
    params = quantize_lm_params(lm.init_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {lm.padded_vocab(cfg)}), INT8 PTQ in "
          f"{time.monotonic() - t0:.1f}s")
    dense, unfused, contiguous, paged = DENSE, UNFUSED, CONTIGUOUS, PAGED
    reqs, arrivals = synth_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT,
                                    SERVE_NEW)

    graph_totals = {}

    def line(runs, eng, label):
        serve_line(runs, eng, label, card, graph_totals)

    main_launches = {}
    kv_bytes = None
    for quantized_kv in (True, False):
        # the bf16-KV variant: the first SERVE_SLOTS requests, once
        n = len(reqs) if quantized_kv else SERVE_SLOTS
        runs, eng = serve_once(
            params, cfg, dev, kernels, reqs[:n], dense + contiguous,
            paged + unfused, arrivals_s=arrivals[:n],
            quantized_kv=quantized_kv,
            runs=SERVE_RUNS if quantized_kv else VARIANT_RUNS)
        if quantized_kv:
            main_launches.update({k: runs[0]["launches"][k]
                                  for k in dense + contiguous + unfused})
            kv_bytes = eng.stats["kv_bytes"]
        line(runs, eng,
             f"contiguous kv={'int8' if quantized_kv else 'bf16'}")

    # the paged path: the same staggered load, then a shared-prompt load
    runs, eng = serve_once(
        params, cfg, dev, kernels, reqs, dense + paged, contiguous + unfused,
        arrivals_s=arrivals, quantized_kv=True, page_size=SERVE_PAGE)
    main_launches.update({k: runs[0]["launches"][k] for k in paged})
    line(runs, eng, f"paged kv=int8 page={SERVE_PAGE}")
    print(f"[serve] paged staggered load: pages_peak "
          f"{eng.stats['pages_peak']}, kv_bytes_peak "
          f"{eng.stats['kv_bytes_peak']} B against the contiguous pool's "
          f"{kv_bytes} B, prefix_hits {runs[0]['prefix_hits']} a run  "
          f"[{card}]")
    shared, ticks = shared_prompt_load(cfg)
    runs, eng = serve_once(
        params, cfg, dev, kernels, shared, dense + paged, contiguous + unfused,
        arrival_ticks=ticks, quantized_kv=True, page_size=SERVE_PAGE,
        runs=VARIANT_RUNS)
    line(runs, eng,
         f"paged kv=int8 page={SERVE_PAGE}, shared {SHARED_HEAD}-token head")
    st = eng.stats
    n_prompt = sum(len(r.prompt) for r in shared)
    want_prefill = n_prompt - (SHARED_N - 1) * SHARED_HEAD
    for i, r in enumerate(runs):
        if r["prefix_hits"] != SHARED_N - 1:
            fail(f"shared-prompt load run {i + 1}: {r['prefix_hits']} prefix "
                 f"hits, expected {SHARED_N - 1}")
        if r["prefill_tokens"] != want_prefill:
            fail(f"shared-prompt load run {i + 1}: {r['prefill_tokens']} "
                 f"prompt tokens prefilled, expected {want_prefill}")
    cached = len({p for v in eng.prefix._entries.values() for p in v})
    if eng.alloc.pages_in_use != cached:
        fail(f"shared-prompt load: {eng.alloc.pages_in_use} pages in use "
             f"after the run, the prefix cache holds {cached}")
    eng.alloc.check()
    eng.prefix.clear()
    if eng.alloc.pages_in_use != 0:
        fail(f"shared-prompt load: {eng.alloc.pages_in_use} pages leaked")
    print(f"[serve] shared-prompt load: prefix_hits {runs[0]['prefix_hits']}"
          f", prefill_tokens {runs[0]['prefill_tokens']} of {n_prompt} "
          f"(each of {len(runs)} runs), pages_peak {st['pages_peak']}, "
          f"kv_bytes_peak {st['kv_bytes_peak']} B against the contiguous "
          f"pool's {kv_bytes} B, {cached} pages cached after the last run, "
          f"0 after clearing the cache  [{card}]")

    # decode windows over two split-KV segments: B3/B5 fold them in the
    # launch through their workspace, and engine == serial still holds
    long_reqs = long_prompt_load(cfg)
    for page_size, must, must_not in (
            (None, dense + contiguous, paged + unfused),
            (SERVE_PAGE, dense + paged, contiguous + unfused)):
        runs, eng = serve_once(
            params, cfg, dev, kernels, long_reqs, must, must_not,
            max_seq=LONG_MAX_SEQ, split_kv=True, quantized_kv=True,
            page_size=page_size, runs=VARIANT_RUNS)
        line(runs, eng,
             f"prompts {'/'.join(map(str, LONG_PROMPTS))} + {LONG_NEW} "
             f"across split-KV segments, max_seq {LONG_MAX_SEQ}, kv=int8"
             + (f" page={page_size}" if page_size else " contiguous"))

    lap("serve")
    # the HQP path: compress at full width, then serve the pruned artifact
    manifest, pruned_params, ragged, main_launches["flash_attention"] = \
        phase_compress(cfg, dev, kernels, card)
    pruned_reqs, pruned_arrivals = synth_requests(
        cfg, PRUNED_REQUESTS, SERVE_PROMPT, PRUNED_NEW)
    for label, pruned in ((f"HQP artifact (θ={manifest.theta:.1%})",
                           pruned_params), ("per-layer cut, ragged", ragged)):
        for page_size, must, must_not in (
                (None, dense + contiguous, paged + unfused),
                (SERVE_PAGE, dense + paged, contiguous + unfused)):
            runs, eng = serve_once(
                pruned, cfg, dev, kernels, pruned_reqs, must, must_not,
                arrivals_s=pruned_arrivals, runs=1, quantized_kv=True,
                page_size=page_size)
            line(runs, eng, f"pruned {label}, kv=int8"
                 + (f" page={page_size}" if page_size else " contiguous"))
    del pruned_params, ragged
    lap("compress")

    # train, then compress once and serve many
    served, train_launches, trained, art_dir = phase_train(cfg, dev, kernels,
                                                           card)
    for runs, eng, label in served:
        line(runs, eng, label)
    del served
    lap("train")
    # seeded sampling and self-speculative serving
    phase_spec(cfg, dev, kernels, params, trained, report, card)
    lap("spec")
    # the service plane: the front door in process, then the launcher's
    # serve --engine --http on the saved trained artifact
    try:
        service_launches = phase_service(cfg, dev, kernels, params,
                                         (art_dir, *trained[1:]), card)
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    del trained
    lap("service")
    for layout, tot in graph_totals.items():
        print(f"[graphs] {layout}: {tot['loads']} serve loads, "
              f"{tot['graphs_captured']} graphs captured in "
              f"{tot['capture_s']:.3f} s, {tot['graph_replays']} replays, "
              f"{tot['eager_dispatches']} eager dispatches; largest graph "
              f"pool of one engine {tot['pool_bytes_max']} B  [{card}]")

    decode_profs = phase_profile(params, cfg, dev, kernels)
    for layout, prof in decode_profs.items():
        print(f"[profile] steady decode, INT8 KV, {SERVE_SLOTS} slots, "
              f"{layout}, replayed CUDA graphs (eager first use beside): "
              f"{json.dumps(prof)}  [{card}]")
    chunk_profs = phase_profile_prefill(params, cfg, dev, kernels)
    for layout, prof in chunk_profs.items():
        print(f"[profile] prefill chunk, {SERVE_CHUNK} queries at positions "
              f"{2 * SERVE_CHUNK}-{PREFILL_PROFILE_PROMPT - 1}, INT8 KV, "
              f"{layout}, replayed CUDA graphs (eager first use beside): "
              f"{json.dumps(prof)}  [{card}]")
    lap("profile")
    roofline_serving(params, cfg,
                     decode_profs["contiguous"]["decode_step_ms"],
                     chunk_profs["contiguous"]["chunk_host_ms"], card,
                     "[roofline]")
    lap("roofline_serving")

    # the paper's experiment: the CNNs run no Pallas kernel of the
    # reference, so no kernel of the port (cuDNN's convs and cuBLAS)
    phase_cnn(dev, card)
    lap("cnn")

    # the MoE family, then the other dense configs, at full width
    moe_launches = phase_moe(dev, kernels, report, card)
    lap("moe")
    arch_launches = phase_dense_archs(dev, kernels, card)
    lap("dense_archs")
    # the hybrid family: jamba's Mamba layers and recurrent slot state
    hybrid_launches = phase_hybrid(dev, kernels, report, card)
    lap("hybrid")
    # the xLSTM family at its published depth: no attention layer at all
    xlstm_launches = phase_xlstm(dev, kernels, report, card)
    lap("xlstm")
    # training of the MoE, hybrid and xLSTM families at full width
    family_launches = phase_train_families(dev, kernels, report, card)
    lap("train_families")
    # the frontend configs: phi-3-vision compressed, musicgen trained, both
    # served in lockstep from their prepended embeddings
    frontend_launches = phase_frontends(dev, kernels, report, card)
    lap("phase_frontends")
    dryrun_finish(dryrun, card)
    lap("dryrun_wait")
    print(f"[time] {sum(laps.values()):.1f} s in all, by part: "
          + json.dumps({k: round(v, 1) for k, v in laps.items()})
          + f"  [{card}]")

    replaces = {"quantize_rowwise": "quantize.py:27",
                "int8_matmul": "int8_matmul.py:44",
                "int8_matmul_quant": "int8_matmul.py:44",
                "decode_attention": "decode_attention.py:109",
                "prefill_attention": "prefill_attention.py:122",
                "paged_decode_attention": "decode_attention.py:155",
                "paged_prefill_attention": "prefill_attention.py:180",
                "flash_attention": "flash_attention.py:64"}
    entries = []
    for name, r in report.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kernels[name].source}.cu",
            "replaces": f"src/repro/kernels/{replaces[name]}",
            "launches": main_launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "service_launches": service_launches[name],
            **({"also_replaces": "src/repro/kernels/"
                                 + replaces["quantize_rowwise"]}
               if name == "int8_matmul_quant" else {}),
            **({"off_serving_path": "parity checks only: the serving path "
                                    "runs int8_matmul_quant"}
               if name in unfused else {}),
            **{k: r[k] for k in ("max_row_rel", "bf16_kv", "long_s",
                                 "train_shapes", "b2_b1_ms", "shapes",
                                 "verify_shape", "moe_shapes",
                                 "hybrid_shapes", "xlstm_shapes", "hd96",
                                 "frontend_shapes")
               if k in r},
            **({"train_launches": train_launches}
               if name == "flash_attention" else {}),
            "moe_launches": moe_launches[name],
            "hybrid_launches": hybrid_launches[name],
            "xlstm_launches": xlstm_launches[name],
            "family_train_launches": family_launches[name],
            "frontend_launches": frontend_launches[name],
            "dense_arch_launches": {a: c[name]
                                    for a, c in arch_launches.items()}})
    line = json.dumps({"kernels": _six_digits(entries)})
    print(f"[kernels] the kernels line below is {len(line)} bytes")
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
