#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases — any failure raises and the script exits non-zero:

1. build   compile the hand-written CUDA kernels from
           src/repro_torch/kernels/csrc with nvcc (sm_90a), one nvcc per
           source, all started together, and load them;
2. parity  each kernel against its plain torch version on the card. The
           mapping-eval kernels at the search path's shapes (llama3.2-3b
           graph: rows 4, M 80, T 320; B = 3; P in {64, 2048}; both grid
           orders; the shared-row route and the global-row route): bitwise,
           and both against the float64 numpy reference at 1e-5 relative;
           then at edge shapes on every route the plan allows (T not a
           multiple of 4 or of the staging tile, W > 8, T = W = C = 1, a
           B * P that no block divides, the longest T the shared route
           takes and one step past it): bitwise; and with a chip id and a
           sched index out of range: NaN at exactly that step, the plain
           version's bits before it, both routes alike. The attention
           kernels at the shapes of tests/test_kernels.py and at
           llama3.2-3b's (decode B 8, Hq 24, Hkv 8, D 128, S 1024, seeded
           lengths; flash B 2, L 512 and 2048 causal, and Lq 100 < Lk
           512), at phi-3-vision-4.2b's (Hq = Hkv = 32, D 96: decode B 8,
           S 1024; flash B 2, L 512 causal), at whisper-tiny's (Hq = Hkv
           = 6, D 64, not causal: flash at Lk 1,500 with Lq 1, 7, 64, 65
           and 1,500, B 2, and Lq 1 at B 8 with Lk 1,500 and 1,501;
           decode B 2, S 128, also at split edges) and, for flash, at every D
           in {32, 64, 96, 128}, causal and bidirectional, ragged L,
           L < 16 and Hq / Hkv of 1, 3 and 8: 2e-5 in float32 (the
           float32 flash kernel and the first float32 flash kernel both),
           2e-2 in bfloat16 (the bfloat16 tensor-core kernel also within
           2e-2 of the largest value); at flash's float32 serving shape
           the kernel's largest distance from the float64 reference at
           most F64_FACTOR x the plain version's; decode with a float32 q
           over a bfloat16
           cache at 2e-5 and a bfloat16 q over a float32 cache at 2e-2;
           every decode case against the plain version in one range and
           under the kernel's own split plan, at S 8192, at split-edge
           lengths (0, 1, a range boundary - 1, at and + 1, S, past S), S
           below one tile, S not a whole number of tiles, and a B * Hkv
           that fills the card (one range); and at MLA's absorbed decode
           (k and v one tensor): deepseek-v2-236b's B 8, Hq 128, Hkv 1,
           D 576 at S 1024 (seeded lengths and split edges) and S 8192, a
           rep that no head group divides (Hq 6), a GQA rep x D past what
           one block held before head groups (Hq 16, Hkv 2, D 576) and
           the reduced config's Hq 4, D 48.
           The SSD scan kernels at mamba2-2.7b's prefill shape (B 2, L 512,
           H 80, P 64, N 128), at the shapes of tests/test_kernels.py, at
           a ragged L (700), at L < 8 (5) and at the edges of their tiles
           (L 1, 63, 64, 65; N 1, 100, 256; P 5, 96, 100; H 81; B 3), their
           inputs strided slices of one fused projection (at N 1 and P 5
           not 16-byte aligned): y and the state within 1e-4 (float32)
           or 2e-2 (bfloat16) of the largest plain value, and at one
           small shape against the float64 sequential reference;
3. main    the search path: ``explore`` on the canonical llama3.2-3b
           prefill scenario with the default (fused) backend and then with
           ``kernel``: the same best score, each kernel launched, no plain
           path dispatched, every launch on the shared-row route, the best
           mapping re-priced on the card equal to the numpy oracle at 1e-4;
           then the golden goodput scenario
           (orca, joint co-search, the fold on the card) against
           tests/goldens/search_goldens.json; then the ``compare`` run:
           the paper's baselines on the canonical scenario at
           benchmarks/bench_compare.py's reduced budgets -- Gemini-style
           (numpy oracle), MOHaM-style (its GA priced on the card through
           the fused kernel, launches counted, no plain dispatch, its
           winner re-priced on the card within 1e-4 of the oracle) and
           SCAR-style on the Compass winner's hardware -- each with its
           latency, energy, EDP, MC and EDP reduction by the Compass
           ``explore`` result; then the fleet control plane over the
           search (``fleet_planned``): benchmarks/bench_serving.py's
           reduced fleet frontier -- at offered loads 0.5, 2 and 8
           requests per second, ``plan_scale_out`` of a 1-replica fleet
           (keep, re_search warm-started from the keep serve's search,
           add_replica) whose replicas price every rollout by a goodput
           mapping search (GA 16 x 6) through the fused kernel, every call
           on the shared-row route and none plain; the best action, its
           replicas, goodput per dollar and loads printed beside the JAX
           package's CPU record in BENCH_serving.json; then the
           population split over devices (``population_chunks``): the
           canonical graph's evaluator with ``device=[cuda:0] * 3``
           against one device for the dense, kernel and fused backends at
           P 64, 512, 4,096 and 1,000 (ragged), ``evaluate_population``
           and ``timing_matrix`` bit for bit, 3 launches a call instead
           of 1, and one fused ``search_mapping`` (GA 512 x 16) in 3
           chunks equal in encodings, scores and history to the unsplit
           one, with 3x its launches; the walls side by side;
4. serve   the serving path at the full width of llama3.2-3b (28 layers,
           seeded random float32 weights): ``ServingEngine`` serves 8
           requests (prompts of 64-512 tokens, 16 new tokens each) under
           vllm, orca and chunked_prefill, every decode through the decode
           kernel (28 launches per decode iteration, no plain dispatch);
           one more orca run under ``torch.profiler`` (device busy share,
           time in the decode kernel and in matrix products);
           one scheduler's token streams replayed with teacher forcing
           through ``impl="eager"`` and ``impl="kernel"`` (logits within
           1e-4 of the largest, argmax equal to the engine's token wherever
           the top-two gap exceeds that); then ``prefill`` of 2 prompts of
           512 tokens through the flash kernel (28 launches), its logits
           and caches against ``impl="eager"`` and against ``extend``;
           one more orca run with float32 weights over a bfloat16 cache
           (decode takes a float32 q); then the paged ``AsyncLLMService``
           (blocks of 16 tokens, full residency) on the same weights and
           requests under ``IterationClock`` for each scheduler: its
           admission log, batches and RequestTimings equal the plan bit
           for bit, 28 decode-kernel launches per decode iteration and no
           plain dispatch, and its greedy tokens the engine's run of the
           same scheduler (a stream may part from it only at a
           teacher-forced top-two gap under LOGIT_REL: the decode
           kernel's split plan follows the batch); one orca run under
           ``WallClock`` (wall, tokens / s, TTFT p50 / p99, the pools'
           bytes) and the profiler's device time of the paged gather and
           write-back per decode step; then the fleet control plane over
           the service (``fleet_measured``): a 1-replica fleet of
           ``MeasuredReplica``s (a fresh service per serve) on 8 requests,
           two of them decode-resident, equal to a direct serve bit for
           bit in schedule and priced timings, and a 2-replica round-robin
           fleet serving each request once, each replica equal to a direct
           serve of its sub-stream, 28 decode launches per decode
           iteration throughout. On the same weights, llama's int8 KV
           cache (``int8_cache``): a 2 x 512 ``prefill`` into an int8
           cache through the flash kernel (28 launches), every layer's
           int8 rows and scales bit for bit the host quantizer's on the
           float K/V the prefill gave it, then 16 greedy decode steps
           with no decode launch and no decode dispatch (the reference
           routes an int8 cache around the kernel), scales positive,
           logits finite, the cache (D + 4) / 4D of a float32 cache's
           bytes; the logit gap and the greedy tokens against the same
           tokens over a float32 cache printed, and the decode-step walls
           (medians of INT8_TIMED warm steps of each cache, in turns).
           Then scan over layers (``scanned``): the blocks' weights
           stacked once, ``prefill_scanned`` (28 flash launches) and 16
           ``decode_step_scanned`` steps (28 decode launches each) bit
           for bit ``prefill``'s and ``decode_step``'s logits and caches,
           in turns with them (where cuBLAS parts the two, the record
           names the layer, the tensor and the weights' alignments, and
           the gate is SCAN_REL of the largest logit); the stacked copy
           is freed. Then llama3.2-3b in bfloat16
           weights and cache: ``prefill`` of 2 x 2048 tokens through the
           bfloat16 flash kernel (28 launches) and eagerly, the kernel
           held to its plain version within 2e-2 of the largest value on
           each layer's own q/k/v, the end-to-end kernel-vs-eager logit
           gap and argmax agreement printed, its norms float32 (as the
           reference builds them) and its logits bit for bit those of a
           copy with the norms cast to bfloat16, the prefill under
           ``torch.profiler``; one orca engine run and one profiled.
           Then the same as for llama at the full width of mamba2-2.7b
           (64 layers,
           seeded random float32 weights), after llama's weights are
           freed: its engine runs launch NO kernel (prompts go through
           the eager chunked SSD of ``extend``, decode through the
           one-step recurrence, as in the JAX package), nor does one orca
           run of the paged service, whose tokens equal the engine's
           (its slot-state path); its ``prefill``
           goes through the SSD kernel (64 launches), each layer's SSD
           is held to the eager SSD within 1e-4 on the prefill's own
           activations, and its logits and states against
           ``impl="eager"`` and ``extend`` within SPREAD_FACTOR x the
           rounding spread measured in the run (see SPREAD_FACTOR); its
           ``prefill_scanned`` (64 SSD launches) and 4 scanned decode
           steps bit for bit the unscanned ones, as for llama. Last,
           phi-3-vision-4.2b at full width (32 layers, D 96, Hq = Hkv =
           32, seeded random float32 weights, its vision frontend a stub):
           ``prefill`` of 2 x 512 seeded embeddings through
           ``inputs_embeds`` (32 flash launches) and eagerly, logits and
           caches within 1e-4 of the largest; 16 teacher-forced decode
           steps from that cache (32 decode launches each) within 1e-4;
           one orca engine run through the kernels and one eagerly, their
           tokens equal or parted only at a near tie. Then
           deepseek-v2-236b (MLA + MoE) at full width, its depth cut from
           60 layers to 2 (9.15 B seeded random float32 parameters): each
           layer's decode kernel on its own q_eff and latent cache
           (captured in an eager decode step) within 2e-5 of its plain
           version; one orca engine run (prompts through ``extend``, 2
           decode launches per decode iteration, no plain dispatch); its
           streams teacher-forced at the engine's 8 lanes through the
           kernel and eagerly, logits within LOGIT_REL, a lane parting
           only at a printed MoE routing flip with a gate margin under
           ROUTE_MARGIN; one orca ``AsyncLLMService`` run under
           ``IterationClock``, admissions, batches and RequestTimings
           equal to the plan bit for bit, 2 launches per decode
           iteration. Last, whisper-tiny (encoder-decoder) at full width
           (4 encoder and 4 decoder blocks, seeded random float32
           weights, its audio frontend a stub): ``encode`` of 2 x 1,500
           seeded frames (4 flash launches), a 2 x 64 ``prefill`` against
           them (8: 4 causal self, 4 cross at Lq 64, Lk 1,500) and 16
           teacher-forced ``decode_step``s (4 decode and 4 flash, the
           cross-attention at Lq 1, a step), each within 1e-4 of the
           largest eager value (enc_out, logits); one orca engine run
           through the kernels and one eagerly against an enc_out of 8
           rows, their tokens equal;
5. train   training at llama3.2-3b's full width (3.21 B float32
           parameters, weights, gradients and AdamW's moments ~51 GB):
           first one step's gradients at 2 of its 28 layers held to a
           float64 copy of the same step (1e-4 of each leaf's largest
           |g|); at all 28 layers the loss's central difference along
           the gradient within 1e-3 of the gradient's norm;
           ``impl="kernel"`` under grad raises ``ValueError``; then, from
           one seeded init each, 4 ``make_train_step`` steps with remat
           on, on ``TokenStream`` seed 0 (2 x 512 tokens, warm-up 2),
           eager as the reference trains (no kernel launched, counted):
           at lr 1e-5 the losses finite, the last below the first and
           batch 0's loss lower after the steps; at tests/test_training.
           py's lr 2e-3 (which overshoots at this size) finite and
           recorded; the step walls and ``torch.cuda.max_memory_
           allocated``; then the training launcher
           (``train_launcher``): ``launch.train.main`` at qwen1.5-0.5b's
           full width, 4 steps with a checkpoint every 2, then a run that
           resumes from step 2's checkpoint, its losses bit for bit the
           first run's, no kernel launched; the step walls, peak memory
           and straggler count; last, the dry run (``dryrun``, host only,
           analytic): DRYRUN_CELLS on both production meshes on the meta
           device, each cell's argument GiB per device beside an H100's
           80 GB, its counted FLOPs and its roofline at the H100's rates;
6. examples the four examples' twins (``examples/*_torch.py``), each
           ``main`` run in-process at its JAX original's default arguments
           with every launch counter set to 0 just before it and read just
           after: quickstart (the search through ``mapping_eval_fused``),
           serve_llm (reduced qwen1.5-0.5b, engine and ``--service``,
           every decode iteration through ``decode_attention``), serve_llm
           ``--arch whisper-tiny`` (engine only; its ``encode`` and
           cross-attention through float32 ``flash_attention``),
           codesign_serving (search and engine) and train_small (demo-100m,
           137.8 M parameters, eager): each kernel on a twin's path
           launched, none of its dispatches plain, the attention kernels
           exactly as often as the run's own iteration stats say (decode
           once per layer of each iteration that decoded; flash once per
           encoder layer for ``encode`` and once per decoder layer of each
           such iteration and each prompt chunk); the first TWIN_HELD
           calls at each distinct shape a twin gives a kernel kept and held
           against the plain version on the same arguments after the run
           (mapping eval bit for bit, attention within ATTN_TOLS), and
           quickstart's result held against its ``--device cpu`` run (the
           best hardware exactly, its metrics within 1e-3). train_small runs
           TRAIN_SMALL_STEPS steps into a temporary directory (the
           example's checkpoint every 25 steps lands on step 25), then
           once more in the same directory, resuming from that checkpoint:
           the resumed steps' losses bit for bit the first run's. Last,
           ``python3 examples/quickstart_torch.py`` as a process of its
           own;
7. times   CUDA-event times of each kernel, its plain version and, for the
           attention kernels, ``torch.nn.functional.scaled_dot_product_
           attention`` on the same inputs, beside the least time the card
           could take for the same bytes (3.35 TB/s) or operations
           (67 TFLOP/s float32, 989 TFLOP/s bfloat16): the mapping-eval
           kernels at P in {64, 512, 2048, 4096} (with one (b, p) chain
           alone), the global-row and the shared-row route in turns (global,
           shared, shared, global) in both grid orders, each route's device
           time per call from ``torch.profiler`` and ns per step, the
           wrapper's host time per call, the plan (pairs per block, tile,
           shared bytes) and the blocks per SM of the occupancy calculator;
           decode at S in {1024, 8192} and at phi-3's D 96, rep 1,
           S 1024 (with its split plan, its
           device time per call from ``torch.profiler`` -- split and
           combine kernels summed -- and its host time per call over
           back-to-back calls, and the same two for the library call),
           flash at L in {512, 2048}, Lq 100 < Lk 512, phi-3's
           D 96, rep 1, L 512 and whisper's encoder (B 2, L 1,500,
           bidirectional) and cross-attention at decode (B 8, Lq 1,
           Lk 1,500), decode also at whisper's D 64, rep 1, S 128
           (float32 through the FMA kernel, in turns with the first float32
           kernel as well: first, new, new, first; bfloat16 through the
           tensor-core kernel; each kernel's device time per call from
           ``torch.profiler`` and the wrapper's host time per call; the
           float32 plan and its blocks per SM by the occupancy calculator),
           the SSD scan at L in {512, 4096} in both dtypes, its two
           kernels and the first version of the kernel (one block per
           (b, h, 64 columns of P) walking the chunks in series) in turns
           (serial, new, new, serial), with each one's device time per
           device kernel from ``torch.profiler`` and the wrapper's host
           time per call (no library call computes it); and MLA's decode
           (B 8, Hq 128, Hkv 1, D 576, k is v, S 1024 and 8192; a float32
           q over a float32 and over a bfloat16 latent, and bfloat16 over
           bfloat16) with its plan (heads per block, head groups, split,
           shared bytes, blocks per SM), in turns with the library call
           where it takes the types, beside the bound of the latent read
           once;
8. profile one hardware point's mapping search (the search path's GA)
           under ``torch.profiler``: wall, device busy time and share, and
           the kernels that take the device time.

``--phases build,parity`` runs a prefix of the phases only and then prints
no result line. The full run prints, last, the card's name and power limit,
one ``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "parity", "main", "serve", "train", "examples", "times",
          "profile")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bfloat16 tensor cores, dense
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = f"{CSRC}/mapping_eval.cu"
# search-path kernel -> the body of the TPU kernel it replaces
KERNELS = {
    "mapping_eval": "src/repro/kernels/mapping_eval.py:60",
    "mapping_eval_fused": "src/repro/kernels/mapping_eval.py:135",
}
# serving-path kernel -> (its source, the body of the TPU kernel it replaces)
ATTN_KERNELS = {
    "decode_attention": (f"{CSRC}/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:27"),
    "flash_attention": (f"{CSRC}/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:24"),
    "flash_attention_bf16": (f"{CSRC}/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:24"),
}
ATTN_TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
F64_FACTOR = 2.0   # float32 flash: distance from float64, of the plain's
# the Mamba-2 path's kernel: (its source, the body of the TPU kernel)
SSD_KERNEL = ("ssd_scan", f"{CSRC}/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:30")
SSD_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}   # of the largest value
# (B, L, H, P, N): the first is mamba2-2.7b's prefill of 2 x 512 tokens,
# then the shapes of tests/test_kernels.py, a ragged L and L < 8; then the
# edges of the kernels' tiles: L of 1, 63, 64 and 65 (one chunk, its edge,
# two chunks), N of 1 (B and C not 16-byte aligned in the fused row), 100
# and 256 (two state-row tiles), P of 5 (x not aligned), 96 and 100 (a
# ragged second column tile), H 81 and B 3
SSD_MAIN = (2, 512, 80, 64, 128)
SSD_PARITY = [SSD_MAIN, (1, 96, 2, 16, 8), (2, 70, 3, 8, 16),
              (1, 128, 1, 32, 32), (1, 700, 80, 64, 128), (2, 5, 80, 64, 128),
              (2, 1, 8, 64, 128), (2, 63, 8, 64, 128), (2, 64, 8, 64, 128),
              (2, 65, 8, 64, 128), (2, 200, 4, 64, 1), (2, 150, 4, 64, 100),
              (2, 300, 8, 64, 256), (2, 130, 8, 5, 128), (2, 130, 8, 96, 128),
              (2, 130, 8, 100, 128), (2, 130, 81, 64, 128),
              (3, 130, 8, 64, 128)]
SSD_TIMES = [SSD_MAIN, (2, 4096, 80, 64, 128)]
MAMBA_ARCH, MAMBA_LAYERS = "mamba2-2.7b", 64
MAIN_POP, MAIN_GENS = 512, 16
# population chunks: CHUNKS chunks on one card against the unsplit path,
# at each population (1,000 = 3 x 333 + 1: the last chunk padded), walls
# per call over CHUNK_REPS calls, in turns (each call ends on the host)
CHUNKS, CHUNK_POPS, CHUNK_REPS = 3, (64, 512, 4096, 1000), 3
# the fleet frontier of benchmarks/bench_serving.py (fleet_frontier_record)
# at the budgets of benchmarks/common.py (ga_config, fleet_budget): a
# ShareGPT stream of 12 requests (warm fraction 0.25, at most 8 new tokens,
# seed 0) over llama3.2-3b replicas of 2 slots on make_hardware(512, "L",
# tensor_parallel=8) with alternating WS / OS chiplets, each serve priced
# by a GA of 16 x 6 over 2 blocks; the SLOs at the 60th percentile of a
# latency pre-search at the middle rate
FLEET_RATES = (0.5, 2.0, 8.0)
FLEET_REQUESTS, FLEET_NEW_CAP, FLEET_WARM = 12, 8, 0.25
FLEET_SLOTS, FLEET_ITERS, FLEET_BLOCKS = 2, 2048, 2
FLEET_POP, FLEET_GENS, FLEET_SLO_PCT = 16, 6, 60
PHI_ARCH, PHI_LAYERS = "phi-3-vision-4.2b", 32
PHI_STEPS = 16                 # teacher-forced decode steps after prefill
# deepseek-v2-236b at full width, its depth cut from 60 layers to 2 (each
# MLA + MoE: 4.05 B parameters a layer, 9.15 B with embedding and head)
DEEPSEEK_ARCH, DEEPSEEK_FULL_LAYERS, DEEPSEEK_LAYERS = \
    "deepseek-v2-236b", 60, 2
ROUTE_MARGIN = 1e-5            # an MoE choice this close may flip
# whisper-tiny at full width (4 + 4 layers, 37.8 M parameters): 2 x 1,500
# seeded frames encoded, a 2 x 64-token prefill against them, then
# WHISPER_STEPS teacher-forced decode steps, over a cache of WHISPER_LEN
WHISPER_ARCH, WHISPER_PROMPT, WHISPER_STEPS, WHISPER_LEN = \
    "whisper-tiny", 64, 16, 128
# the train phase: llama3.2-3b at full width, TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ tokens from one seeded init under each of
# TRAIN_OPTS, with tests/test_training.py::test_loss_decreases's warm-up.
# AdamW's first steps move every weight by about the learning rate, and at
# 3.21 B random parameters that overshoots from lr 1e-4 up (a sweep of lr
# 1e-5 to 2e-3 on the card: PERF.md, PR 27); so the gated run (losses
# finite, the last below the first, and batch 0's loss lower after the
# steps) is at lr 1e-5, and the test's own lr 2e-3 runs too, its losses
# held finite and recorded. The gradients: at full depth against the
# loss's central difference along them (within DD_REL of their norm, at a
# step of DD_EPS in parameter norm), and at TRAIN_CHECK_LAYERS layers
# against a float64 copy of the same step (within GRAD_REL)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "llama3.2-3b", 4, 2, 512
TRAIN_OPTS = {"gated": dict(lr=1e-5, warmup_steps=2, total_steps=12),
              "test_loss_decreases": dict(lr=2e-3, warmup_steps=2,
                                          total_steps=12)}
TRAIN_CHECK_LAYERS, GRAD_REL = 2, 1e-4
# the training launcher (the JAX package's launcher's default arch) at full
# width: LAUNCH_STEPS steps with a checkpoint every LAUNCH_CKPT_EVERY, then
# a resume from the checkpoint of step LAUNCH_CKPT_EVERY
LAUNCH_ARCH, LAUNCH_STEPS, LAUNCH_CKPT_EVERY = "qwen1.5-0.5b", 4, 2
# the dry run's cells (arch, shape), each on both production meshes: every
# assigned arch's decode_32k (and long_500k where it has one), whisper-tiny's
# prefill_32k and train_4k, and qwen1.5-0.5b's train_4k -- ~40 s of tracing
# on the card's host; the whole set (64 cells, ~10 min) is
# ``python -m repro_torch.launch.dryrun --all --both-meshes``
DRYRUN_ARCHS = ("deepseek-v2-236b", "deepseek-moe-16b", "llama3.2-3b",
                "qwen1.5-0.5b", "qwen2-1.5b", "glm4-9b", "whisper-tiny",
                "jamba-v0.1-52b", "mamba2-2.7b", "phi-3-vision-4.2b")
DRYRUN_CELLS = [(a, "decode_32k") for a in DRYRUN_ARCHS] + [
    ("jamba-v0.1-52b", "long_500k"), ("mamba2-2.7b", "long_500k"),
    ("whisper-tiny", "prefill_32k"), ("whisper-tiny", "train_4k"),
    ("qwen1.5-0.5b", "train_4k")]
DD_EPS, DD_REL = 1e-3, 1e-3
# the examples' twins (examples/*_torch.py): each kernel its twin launches
# on the card, and train_small's steps (its checkpoint every 25 steps lands
# on step 25, and the resumed run repeats the steps after it)
EXAMPLE_KERNELS = {
    "quickstart": ("mapping_eval_fused",),
    "serve_llm": ("decode_attention",),
    "serve_llm_service": ("decode_attention",),
    "serve_llm_whisper": ("decode_attention", "flash_attention"),
    "codesign_serving": ("mapping_eval_fused", "decode_attention"),
    "train_small": (),
}
# the model each serving twin serves (reduced), and the calls per kernel,
# wrapper and distinct argument shapes that are kept and held against the
# plain version after the twin's run
EXAMPLE_ARCHS = {"serve_llm": "qwen1.5-0.5b",
                 "serve_llm_service": "qwen1.5-0.5b",
                 "serve_llm_whisper": "whisper-tiny",
                 "codesign_serving": "qwen2-1.5b"}
TWIN_HELD = 2
TRAIN_SMALL_STEPS = 27
SERVE_ARCH, SERVE_LAYERS = "llama3.2-3b", 28
SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_LEN = 8, 16, 1024
SERVE_CHUNK = 64
SERVE_BLOCK = 16               # the paged service's block length
SERVE_PERIOD_S = 0.05          # WallClock: seconds per arrival iteration
BF16_PROMPT = 2048             # the bfloat16 prefill: 2 prompts of 2048
INT8_STEPS = 16                # llama's greedy decode steps over int8
INT8_TIMED = 8                 # then timed steps of each cache, in turns
# greedy decode steps after the scanned prefill, per kernel of the model
SCAN_STEPS = {"flash_attention": 16, "ssd_scan": 4}
SCAN_REL = 1e-6                # scanned vs unscanned where cuBLAS parts
LOGIT_REL = 1e-4               # teacher-forced logits: of the largest |logit|
# A 64-layer random-weight Mamba-2 stack carries float32 rounding forward
# and grows it layer by layer, so two valid float32 evaluations of its
# logits (SSD at chunk 64 or 128) differ by far more than LOGIT_REL. The
# SSD kernel is held per layer to LOGIT_REL on the prefill's own
# activations; end to end, its logits and states are held to
# SPREAD_FACTOR x that chunk-64 vs chunk-128 spread, measured in the run.
SPREAD_FACTOR = 10.0
# attention shapes: (B, Hq, Hkv, S, D) for decode, (B, Hq, Hkv, Lq, Lk, D,
# causal) for flash; the first of each list is the serving path's
DECODE_MAIN = (8, 24, 8, 1024, 128)
FLASH_MAIN = (2, 24, 8, 512, 512, 128, True)
FLASH_BF16_MAIN = (2, 24, 8, 2048, 2048, 128, True)  # the bf16 prefill's
# phi-3-vision-4.2b's: D 96, Hq = Hkv = 32 (rep 1); flash at its 2 x 512
# prefill, decode at 8 lanes of the serve phase's max_len
FLASH_PHI = (2, 32, 32, 512, 512, 96, True)
DECODE_PHI = (8, 32, 32, 1024, 96)
# whisper-tiny's: D 64, Hq = Hkv = 6 (rep 1); flash at its encoder's
# bidirectional self-attention over 2 x 1,500 frames and at its
# cross-attention (not causal, Lk 1,500) from one decode token at 8 lanes;
# decode over the serve phase's 2 x 128-row cache
FLASH_WHISPER_ENC = (2, 6, 6, 1500, 1500, 64, False)
FLASH_WHISPER_CROSS = (8, 6, 6, 1, 1500, 64, False)
DECODE_WHISPER = (2, 6, 6, 128, 64)
# a sixth entry "edges" sets the lengths to 0, 1, a split boundary - 1, at
# and + 1, S and past S (in turn, as many as B takes) under the kernel's
# split plan; shapes below: the engine's width at S 1024, S 8192 with many
# ranges, S below one tile, S not a whole number of tiles with a wholly
# empty range, S 8192 with one range (B * Hkv fills the card)
DECODE_PARITY = [DECODE_MAIN, (2, 8, 2, 257, 64), (1, 4, 4, 96, 32),
                 (3, 4, 1, 130, 64), (8, 24, 8, 1024, 128, "edges"),
                 (7, 8, 2, 8192, 64, "edges"), (5, 6, 2, 20, 32, "edges"),
                 (6, 4, 1, 300, 64, "edges"), (8, 24, 8, 8192, 128),
                 (66, 32, 32, 8192, 32), DECODE_PHI, DECODE_WHISPER,
                 (2, 6, 6, 128, 64, "edges")]
# every D, causal and bidirectional, Lq < Lk, ragged L (not a multiple of
# the tiles), L < 16, and Hq / Hkv of 1, 3 and 8
FLASH_PARITY = [FLASH_MAIN, (1, 24, 8, 100, 512, 128, True),
                (1, 4, 4, 64, 64, 64, True), (2, 8, 2, 96, 160, 64, True),
                (1, 6, 3, 33, 57, 32, False), (1, 2, 1, 128, 128, 128, True),
                FLASH_BF16_MAIN, (1, 8, 8, 77, 77, 32, True),
                (1, 6, 2, 130, 200, 64, False),
                (2, 8, 1, 200, 333, 96, True), (1, 3, 1, 9, 9, 128, True),
                (1, 24, 8, 13, 13, 96, False), (1, 4, 4, 150, 150, 32, False),
                (1, 16, 2, 5, 70, 64, True), (1, 3, 3, 250, 250, 128, False),
                FLASH_PHI, FLASH_WHISPER_ENC, FLASH_WHISPER_CROSS,
                (2, 6, 6, 7, 1500, 64, False), (2, 6, 6, 64, 1500, 64, False),
                (2, 6, 6, 65, 1500, 64, False), (8, 6, 6, 1, 1501, 64, False)]
# MLA's absorbed decode: deepseek-v2-236b's 128 query heads over its one
# latent head at D 576 (kv_rank 512 + rope_dim 64), one tensor passed as k
# and v ("shared"), at the serve phase's 8 lanes; then S 8192, the split
# edges at S 1024, a rep no head group divides (6 = 4 + 2), a GQA rep x D
# just past what one block held before head groups (8 x 576) and the
# reduced config's shape (Hq 4, D 48)
DECODE_MLA = (8, 128, 1, 1024, 576, "shared")
DECODE_MLA_TIMES = [DECODE_MLA, (8, 128, 1, 8192, 576, "shared")]
DECODE_PARITY += DECODE_MLA_TIMES + [
    (8, 128, 1, 1024, 576, "shared", "edges"), (2, 6, 1, 96, 576, "shared"),
    (2, 16, 2, 100, 576, "shared"), (2, 4, 1, 96, 48, "shared")]
# the examples' twins (reduced models, D 32): serve_llm's engine at 4 slots
# over 128 rows (Hq = Hkv = 4; its service at buckets 1, 2 and 4),
# codesign's at 8 slots over 96 rows (Hkv 2); whisper-tiny's encoder over
# 4 x 16 frames, its cross-attention from 4 decode lanes and from one
# prompt chunk of 2 to 64 rows (not causal, Lk 16)
DECODE_PARITY += [(4, 4, 4, 128, 32), (4, 4, 4, 128, 32, "edges"),
                  (2, 4, 4, 128, 32), (1, 4, 4, 128, 32), (8, 4, 2, 96, 32),
                  (8, 4, 2, 96, 32, "edges")]
FLASH_PARITY += [(4, 4, 4, 16, 16, 32, False), (4, 4, 4, 1, 16, 32, False),
                 (1, 4, 4, 2, 16, 32, False), (1, 4, 4, 64, 16, 32, False)]
DECODE_TIMES = [DECODE_MAIN, (8, 24, 8, 8192, 128), DECODE_PHI,
                DECODE_WHISPER]
FLASH_TIMES = [FLASH_MAIN, (1, 24, 8, 100, 512, 128, True),
               FLASH_BF16_MAIN, FLASH_PHI, FLASH_WHISPER_ENC,
               FLASH_WHISPER_CROSS]
PARITY_POPS = (64, 2048)
TIME_POPS = (64, 512, 2048, 4096)
# mapping-eval edge shapes (B, P, T, W, C): T not a multiple of 4 (4-byte
# copies) nor of the tile, a ragged last tile with 16-byte copies, W > 8,
# T = W = C = 1, and a B * P that no block size divides; then the longest T
# the shared route takes and one step past it (global), at B 8, P 2
EDGE_SHAPES = [(2, 5, 322, 3, 4), (3, 9, 324, 8, 16), (2, 3, 65, 11, 3),
               (1, 1, 1, 1, 1), (3, 133, 40, 4, 5)]
CAP_SHAPE = (8, 2, 1, 2)               # B, P, W, C
BAD_CHIP_STEP, BAD_SCHED_STEP = 200, 77


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# shared set-up: the canonical scenario and the kernels' inputs
# --------------------------------------------------------------------------


def canonical_scenario():
    from repro_torch.configs import llm_spec
    from repro_torch.core.compass import Scenario
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.traces import SHAREGPT, sample_batches

    batches = sample_batches(SHAREGPT, "prefill", 8, 3, seed=0)
    return Scenario("llama3_2_3b_prefill", llm_spec("llama3.2-3b"),
                    target_tops=512,
                    stream=RequestStream.fixed_batches(batches), n_blocks=4)


def canonical_evaluator(scenario, device):
    """A group evaluator over the scenario's 3 batches on a hardware point
    whose llama3.2-3b graph is rows 4 x M 80 (TP 8, micro-batch 2)."""
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    hw = make_hardware(scenario.target_tops, tensor_parallel=8,
                       micro_batch_prefill=2)
    pairs = [get_graph_and_tables(scenario.spec, b, hw, 2, scenario.n_blocks)
             for b in scenario.rollout().batches]
    return GroupPopulationEvaluator([g for g, _ in pairs],
                                    [t for _, t in pairs], hw,
                                    backend="fused", device=device)


def kernel_inputs(ev, pop: int, seed: int) -> dict:
    import numpy as np

    from repro_torch.core.encoding import random_encoding

    rng = np.random.default_rng(seed)
    g = ev.graphs[0]
    encs = [random_encoding(rng, g.rows, g.n_cols, ev.hw.n_chiplets)
            for _ in range(pop)]
    return ev.pass_ab_inputs(encs)


def traffic(name: str, inp: dict) -> tuple[int, int]:
    """(bytes, float32 operations) the kernel's function needs: each input
    read once, each output written once; per (b, p, t) W + 1 maxes and
    one add."""
    n_batch, pop, n_flat = inp["t_proc"].shape
    t_len, width = inp["ppos"].shape[1:]
    n_chips = inp["n_chips"]
    idx_bytes = 4 * pop * t_len * (2 + width)          # chip + ppos (+sched)
    if name == "mapping_eval":
        in_bytes = 4 * n_batch * pop * t_len + 4 * pop * t_len * (1 + width)
    else:
        in_bytes = 4 * n_batch * pop * n_flat + idx_bytes
    out_bytes = 4 * n_batch * pop * (t_len + n_chips)
    ops = n_batch * pop * t_len * (width + 2)
    return in_bytes + out_bytes, ops


def bound(name: str, inp: dict) -> tuple[float, str]:
    nbytes, ops = traffic(name, inp)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def run_kernel(name: str, inp: dict, order: str, plain: bool = False,
               route: str | None = None):
    from repro_torch.kernels import mapping_eval as me

    a = (inp["chip"], inp["ppos"], inp["n_chips"])
    if name == "mapping_eval":
        tp = inp["gathered"]
        return (me.mapping_eval_plain(tp, *a) if plain
                else me.mapping_eval_cuda(tp, *a, order, route))
    tp, sched = inp["t_proc"], inp["sched_idx"]
    return (me.mapping_eval_fused_plain(tp, sched, *a) if plain
            else me.mapping_eval_fused_cuda(tp, sched, *a, order, route))


def edge_inputs(n_batch: int, pop: int, t_len: int, width: int,
                n_chips: int, seed: int, device) -> dict:
    """Seeded random mapping-eval inputs on the card: cost rows of L = T,
    a permutation sched per individual, random chips, and up to W random
    earlier predecessors per step (the rest the sentinel T)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t_proc = rng.uniform(0.1, 1.0, (n_batch, pop, t_len)).astype(np.float32)
    sched = rng.permuted(np.tile(np.arange(t_len), (pop, 1)), axis=1)
    chip = rng.integers(0, n_chips, (pop, t_len))
    steps = np.arange(t_len)[None, :, None]
    pos = np.floor(rng.random((pop, t_len, width)) * steps)
    live = np.arange(width)[None, None, :] < rng.integers(
        0, width + 1, (pop, t_len, 1))
    ppos = np.where(live & (steps > 0), pos, t_len)

    def i32(x):
        return torch.as_tensor(x.astype(np.int32), device=device)

    inp = {"t_proc": torch.as_tensor(t_proc, device=device),
           "sched_idx": i32(sched), "chip": i32(chip), "ppos": i32(ppos),
           "n_chips": n_chips}
    return with_gathered(inp)


def route_of(name: str, inp: dict) -> str:
    from repro_torch.kernels import mapping_eval as me

    return me.kernel_plan(inp["t_proc"], inp["chip"], inp["ppos"],
                          inp["n_chips"], name == "mapping_eval_fused").route


def with_gathered(inp: dict) -> dict:
    from repro_torch.kernels import mapping_eval as me

    return dict(inp, gathered=me.gather_sched(
        inp["t_proc"], inp["sched_idx"]).contiguous())


def decode_inputs(shape, dtype: str, seed: int) -> dict:
    """Seeded decode inputs on the card: q [B, Hq, D], caches
    [B, S, Hkv, D] (one tensor as k and v where the shape's flags say
    "shared"), lengths [B] in 1..S, or the split edges of DECODE_PARITY
    where they say "edges"."""
    import numpy as np
    import torch

    from repro_torch.kernels import decode_attention as da

    b, hq, hkv, s, d = shape[:5]
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def normal(*sh):
        return torch.as_tensor(rng.standard_normal(sh, dtype=np.float32),
                               device="cuda").to(dt)

    shared = "shared" in shape[5:]
    inp = {"q": normal(b, hq, d), "k": normal(b, s, hkv, d)}
    inp["v"] = inp["k"] if shared else normal(b, s, hkv, d)
    lengths = rng.integers(1, s + 1, size=b)
    if "edges" in shape[5:]:
        split_len = da.decode_plan(b, hq, hkv, s, d, dt, dt,
                                   da.sm_count("cuda"), shared).split_len
        edges = [0, 1, split_len - 1, split_len, split_len + 1, s, s + 9]
        lengths = np.array([edges[i % len(edges)] for i in range(b)])
    inp["lengths"] = torch.as_tensor(lengths, dtype=torch.int32,
                                     device="cuda")
    return inp


def flash_inputs(shape, dtype: str, seed: int) -> dict:
    """Seeded flash inputs on the card: q [B, Hq, Lq, D], k/v
    [B, Hkv, Lk, D]."""
    import numpy as np
    import torch

    b, hq, hkv, lq, lk, d, causal = shape
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def normal(*sh):
        return torch.as_tensor(rng.standard_normal(sh, dtype=np.float32),
                               device="cuda").to(dt)

    return {"q": normal(b, hq, lq, d), "k": normal(b, hkv, lk, d),
            "v": normal(b, hkv, lk, d), "causal": causal}


def run_attention(name: str, inp: dict, how: str):
    """One call of an attention kernel (``cuda``), its plain version
    (``plain``), the first float32 flash kernel (``first``, not on any path)
    or the PyTorch library call for the same function (``library``:
    ``scaled_dot_product_attention``, timed here only)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    q, k, v = inp["q"], inp["k"], inp["v"]
    if name == "decode_attention":
        lengths = inp["lengths"]
        if how == "cuda":
            return da.decode_attention_cuda(q, k, v, lengths)
        if how == "plain":
            return da.decode_attention_plain(q, k, v, lengths)
        if how == "plain_split":   # under the kernel's own split plan
            n_split = da.kernel_plan(q, k, v).n_split
            return da.decode_attention_plain(q, k, v, lengths,
                                             n_split=n_split)
        mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
    causal = inp["causal"]
    if how == "cuda":
        return fa.flash_attention_cuda(q, k, v, causal)
    if how == "first":         # the first float32 kernel, on no path
        return fa._flash_attention_f32_first_cuda(q, k, v, causal)
    if how == "plain":
        return fa.flash_attention_plain(q, k, v, causal)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def attention_bound(name: str, inp: dict) -> dict:
    """Bytes and operations the function needs on these inputs (each input
    read once, each output written once; decode reads only the live K/V
    rows, once where k and v are one tensor, flash does only the visible
    (query, key) pairs), and the least time the card could take for
    them."""
    q, k = inp["q"], inp["k"]
    item = q.element_size()
    if name == "decode_attention":
        b, hq, d = q.shape
        s, hkv = k.shape[1], k.shape[2]
        live = int(inp["lengths"].clamp(min=0, max=s).sum())
        reads = 1 if inp["v"] is k else 2
        nbytes = live * hkv * d * reads * k.element_size() \
            + 2 * q.numel() * item + 4 * b
        ops = 4 * hq * d * live
    else:
        b, hq, lq, d = q.shape
        hkv, lk = k.shape[1], k.shape[2]
        if inp["causal"]:
            off = lk - lq
            pairs = sum(min(lk, max(0, i + off + 1)) for i in range(lq))
        else:
            pairs = lq * lk
        nbytes = (2 * q.numel() + 2 * b * hkv * lk * d) * item
        ops = 4 * b * hq * d * pairs
    peak = F32_OPS_PER_S if q.dtype.itemsize == 4 else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_inputs(shape, dtype: str, seed: int) -> dict:
    """Seeded SSD inputs on the card, laid out as the Mamba-2 mixer hands
    them over: x [B, L, H, P], B and C [B, L, N] are slices of one fused
    [B, L, H P + 2 N] projection (strided views, no copy), dt [B, L, H] in
    (0.01, 0.2) and a [H] in (-2, -0.5) float32."""
    import numpy as np
    import torch

    b, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    fused = torch.as_tensor(
        rng.standard_normal((b, l, h * p + 2 * n), dtype=np.float32),
        device="cuda").to(getattr(torch, dtype))
    return {"x": fused[..., :h * p].reshape(b, l, h, p),
            "dt": torch.as_tensor(rng.uniform(0.01, 0.2, size=(b, l, h)),
                                  dtype=torch.float32, device="cuda"),
            "a": torch.as_tensor(-rng.uniform(0.5, 2.0, size=h),
                                 dtype=torch.float32, device="cuda"),
            "b": fused[..., h * p:h * p + n], "c": fused[..., h * p + n:]}


def run_ssd(inp: dict, how: str):
    """One call of the SSD kernels (``cuda``), of the first version of the
    kernel (``serial``, not on any path) or of the plain version."""
    from repro_torch.kernels import ssd_scan as ss

    args = (inp["x"], inp["dt"], inp["a"], inp["b"], inp["c"])
    fn = {"cuda": ss.ssd_scan_cuda, "serial": ss._ssd_scan_serial_cuda,
          "plain": ss.ssd_scan_plain}[how]
    return fn(*args)


def ssd_bound(inp: dict) -> dict:
    """Bytes (x, dt, B, C read once; y and the state written once) and
    operations of the chunked algorithm at the kernel's chunk Q (64, fewer
    than at the TPU's 128): per (b, h, chunk) 2 Q N P for the inter term,
    2 Q N P for the state update and 2 Q^2 P for the intra term, plus
    2 Q^2 N per (b, chunk) for C B^T; and the least time the card could
    take for them at the inputs' rate."""
    from repro_torch.kernels.ssd_scan import KERNEL_CHUNK as q

    x = inp["x"]
    b, l, h, p = x.shape
    n = inp["b"].shape[-1]
    item = x.element_size()
    chunks = -(-l // q)
    nbytes = (2 * x.numel() + 2 * b * l * n) * item \
        + 4 * (b * l * h + h) + 4 * b * h * n * p
    ops = b * h * chunks * (4 * q * n * p + 2 * q * q * p) \
        + b * chunks * 2 * q * q * n
    peak = F32_OPS_PER_S if item == 4 else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mapping_eval as me
    from repro_torch.kernels import ssd_scan as ss

    sources = ("mapping_eval.cu", "decode_attention.cu", "flash_attention.cu",
               "ssd_scan.cu")
    t0 = time.perf_counter()
    found = {src: build.library_path(src).exists() for src in sources}
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        libs = list(pool.map(build.compile_source, sources))
    for mod in (me, da, fa, ss):
        mod._lib()
    rec = {"phase": "build", "sources": [f"{CSRC}/{s}" for s in sources],
           "libraries": [lib.name for lib in libs],
           "compiled_now": [not found[s] for s in sources],
           # repro-lint: disable=RT006 -- host work: nvcc builds, no device work
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def _bitwise_both(inp: dict, label: str) -> dict:
    """Each mapping-eval kernel on each route its plan allows (the global
    route always) and each grid order against its plain version, bitwise.
    Returns the outputs by (kernel, route, order) and the largest error."""
    import torch

    from repro_torch.kernels import mapping_eval as me

    plain = {name: run_kernel(name, inp, "batch_major", plain=True)
             for name in KERNELS}
    outs, errs = {}, {name: 0.0 for name in KERNELS}
    for name in KERNELS:
        routes = ("shared", "global") if route_of(name, inp) == "shared" \
            else ("global",)
        for route, order in itertools.product(routes, me.GRID_ORDERS):
            end, free = run_kernel(name, inp, order, route=route)
            torch.cuda.synchronize()
            p_end, p_free = plain[name]
            err = max(float((end - p_end).abs().max()),
                      float((free - p_free).abs().max()))
            errs[name] = max(errs[name], err)
            check(torch.equal(end, p_end) and torch.equal(free, p_free),
                  f"{name} ({route}, {order}, {label}) differs from its "
                  f"plain version: max abs err {err}")
            outs[(name, route, order)] = (end, free)
    return outs, errs


def _parity_edges(device) -> dict:
    """The edge shapes, the shared route's cap and one step past it, and
    out-of-range indices."""
    import torch

    from repro_torch.kernels import mapping_eval as me

    errs = {name: 0.0 for name in KERNELS}
    cases = [(shape, None) for shape in EDGE_SHAPES]
    n_batch, pop, width, n_chips = CAP_SHAPE
    limits = me.device_limits(device)
    for name in KERNELS:
        fused = name == "mapping_eval_fused"
        lo, hi = 1, 1 << 20      # the longest shared-route T (L = T)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            ok = me.row_plan(n_batch, 1, mid, width, n_chips, mid, fused,
                             *limits).route == "shared"
            lo, hi = (mid, hi) if ok else (lo, mid - 1)
        cases += [((n_batch, pop, lo, width, n_chips), name),
                  ((n_batch, pop, lo + 1, width, n_chips), name)]
    for k, (shape, only) in enumerate(cases):
        inp = edge_inputs(*shape, seed=1000 + k, device=device)
        routes = {name: route_of(name, inp) for name in KERNELS}
        _, e = _bitwise_both(inp, f"edge {shape}")
        for name in KERNELS:
            errs[name] = max(errs[name], e[name])
        emit({"phase": "parity", "edge": list(shape), "cap_of": only,
              "routes": routes, "bitwise": True})
    # a chip id and a sched index out of range, at the search's widths
    inp = edge_inputs(3, 6, 320, 8, 16, seed=7, device=device)
    bad_chip, bad_sched = inp["chip"].clone(), inp["sched_idx"].clone()
    bad_chip[0, BAD_CHIP_STEP] = 16
    bad_sched[0, BAD_SCHED_STEP] = 320
    bad_sched[-1, BAD_SCHED_STEP] = -1
    # the unfused kernel keeps the valid gathered costs: its chip is bad
    bad = dict(inp, chip=bad_chip, sched_idx=bad_sched)
    for name in KERNELS:
        first = BAD_SCHED_STEP if name == "mapping_eval_fused" \
            else BAD_CHIP_STEP
        p_end, _ = run_kernel(name, inp, "batch_major", plain=True)
        got = {r: run_kernel(name, bad, "batch_major", route=r)[0]
               for r in ("shared", "global")}
        torch.cuda.synchronize()
        e_s, e_g = got["shared"], got["global"]
        check(torch.equal(e_s.isnan(), e_g.isnan())
              and torch.equal(e_s.nan_to_num(), e_g.nan_to_num()),
              f"{name}: the routes disagree on out-of-range input")
        check(bool(e_s[:, 0, BAD_CHIP_STEP].isnan().all())
              and bool(e_s[:, 0, first].isnan().all())
              and (first == BAD_CHIP_STEP
                   or bool(e_s[:, -1, first].isnan().all())),
              f"{name}: no NaN at an out-of-range step")
        check(torch.equal(e_s[:, 0, :first], p_end[:, 0, :first])
              and not e_s[:, 1:-1].isnan().any()
              and torch.equal(e_s[:, 1:-1], p_end[:, 1:-1]),
              f"{name}: out-of-range input changed a valid step")
        emit({"phase": "parity", "out_of_range": name, "nan_steps":
              sorted({BAD_CHIP_STEP, first}), "routes_agree": True})
    return errs


def phase_parity(ev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    errs = {name: 0.0 for name in KERNELS}
    for pop in PARITY_POPS:
        inp = with_gathered(kernel_inputs(ev, pop, seed=pop))
        n_batch, _, t_len = inp["gathered"].shape
        routes = {name: route_of(name, inp) for name in KERNELS}
        check(set(routes.values()) == {"shared"},
              f"the search's shape takes {routes}")
        outs, e = _bitwise_both(inp, f"P={pop}")
        for name in KERNELS:
            errs[name] = max(errs[name], e[name])
        ref_outs = list(outs.values())
        check(all(torch.equal(o[0], ref_outs[0][0])
                  and torch.equal(o[1], ref_outs[0][1]) for o in ref_outs),
              f"kernels, routes or grid orders disagree at P={pop}")
        # float64 numpy reference on a strided subset of individuals
        sel = np.arange(0, pop, max(1, pop // 32))
        sel_t = torch.as_tensor(sel, device=inp["chip"].device)
        host = {k: inp[k].index_select(1 if k in ("t_proc", "gathered")
                                       else 0, sel_t).cpu().numpy()
                for k in ("t_proc", "gathered", "sched_idx", "chip", "ppos")}
        e_end, e_free = ref.mapping_eval_fused_reference(
            host["t_proc"], host["sched_idx"], host["chip"], host["ppos"],
            inp["n_chips"])
        u_end, u_free = ref.mapping_eval_reference(
            host["gathered"], host["chip"], host["ppos"], inp["n_chips"])
        np.testing.assert_array_equal(e_end, u_end)
        for name in KERNELS:
            end, free = outs[(name, "shared", "batch_major")]
            np.testing.assert_allclose(
                end.index_select(1, sel_t).cpu().numpy(), e_end, rtol=1e-5)
            np.testing.assert_allclose(
                free.index_select(1, sel_t).cpu().numpy(), e_free, rtol=1e-5)
        emit({"phase": "parity", "B": n_batch, "P": pop, "T": t_len,
              "W": int(inp["ppos"].shape[-1]), "C": inp["n_chips"],
              "L": int(inp["t_proc"].shape[-1]), "routes": routes,
              "bitwise": True, "both_routes_bitwise": True,
              "ref_rtol": 1e-5, "ref_individuals": int(sel.size)})
    for name, e in _parity_edges(inp["chip"].device).items():
        errs[name] = max(errs[name], e)
    return errs

def attn_kernel(name: str, dtype: str) -> str:
    """The kernel (launch counter) that ``name`` reaches in ``dtype``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    if name == "flash_attention":
        return fa.KERNEL_OF[getattr(torch, dtype)]
    return name


# each attention kernel -> (its serving path's shape, dtype)
ATTN_MAIN = {"decode_attention": (DECODE_MAIN, "float32"),
             "flash_attention": (FLASH_MAIN, "float32"),
             "flash_attention_bf16": (FLASH_BF16_MAIN, "bfloat16")}


def phase_attention_parity() -> dict:
    """Each attention kernel against its plain version on the same inputs,
    and the decode kernel with q and caches of different types (float32
    weights over a bfloat16 cache, bfloat16 weights over a float32 one) at
    the tolerance of q's type; returns each kernel's error at its serving
    path's shape."""
    import torch

    errs = {}
    for name, shapes, make in (("decode_attention", DECODE_PARITY,
                                decode_inputs),
                               ("flash_attention", FLASH_PARITY,
                                flash_inputs)):
        for i, shape in enumerate(shapes):
            for dtype, tol in ATTN_TOLS.items():
                inp = make(shape, dtype, seed=i)
                got = run_attention(name, inp, "cuda")
                want = run_attention(name, inp, "plain")
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{name} {shape} {dtype}: {got.dtype} {tuple(got.shape)}"
                      f" vs {want.dtype} {tuple(want.shape)}")
                err = float((got.float() - want.float()).abs().max())
                largest = float(want.float().abs().max())
                kernel = attn_kernel(name, dtype)
                # the tensor-core kernel also within tol of the largest
                bound = min(tol, tol * largest) \
                    if kernel == "flash_attention_bf16" else tol
                check(torch.isfinite(got).all().item() and err <= bound,
                      f"{name} {shape} {dtype} differs from its plain "
                      f"version: max abs err {err} > {bound}")
                main = ATTN_MAIN[kernel] == (shape, dtype)
                if main:
                    errs[kernel] = err
                rec = {"phase": "parity", "kernel": kernel,
                       "shape": list(shape), "dtype": dtype,
                       "max_abs_err": err, "tol": bound, "largest": largest,
                       "serving_shape": main}
                if name == "decode_attention":
                    rec.update(_decode_split_parity(inp, got, tol))
                if kernel == "flash_attention":
                    rec["first_max_abs_err"] = _first_flash_parity(inp, want,
                                                                   tol)
                emit(rec)
    emit(_flash_float64_check())
    for q_dtype, kv_dtype in (("float32", "bfloat16"),
                              ("bfloat16", "float32")):
        tol = ATTN_TOLS[q_dtype]
        what = f"{q_dtype} q over a {kv_dtype} cache"
        for i, shape in enumerate(DECODE_PARITY):
            inp = decode_inputs(shape, kv_dtype, seed=i)
            inp["q"] = inp["q"].to(getattr(torch, q_dtype))
            got = run_attention("decode_attention", inp, "cuda")
            want = run_attention("decode_attention", inp, "plain")
            torch.cuda.synchronize()
            check(got.dtype == want.dtype == inp["q"].dtype,
                  f"decode_attention {shape} {what}: output {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            check(torch.isfinite(got).all().item() and err <= tol,
                  f"decode_attention {shape} {what} differs from its plain "
                  f"version: max abs err {err} > {tol}")
            emit({"phase": "parity", "kernel": "decode_attention",
                  "shape": list(shape), "dtype": what, "max_abs_err": err,
                  "tol": tol, **_decode_split_parity(inp, got, tol)})
    return errs


def _first_flash_parity(inp: dict, want, tol: float) -> float:
    """The first float32 flash kernel against the plain version's output
    ``want`` on the same inputs; returns its largest error."""
    import torch

    got = run_attention("flash_attention", inp, "first")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.isfinite(got).all().item() and err <= tol,
          f"the first float32 flash kernel at {tuple(inp['q'].shape)} "
          f"differs from its plain version: max abs err {err} > {tol}")
    return err


def _flash_float64_check() -> dict:
    """At FLASH_MAIN in float32: the largest distance of the flash kernel,
    the first float32 kernel and the plain version from the float64
    reference (``kernels/ref.py``); the kernel's may be at most
    F64_FACTOR x the plain version's."""
    from repro_torch.kernels import ref

    inp = flash_inputs(FLASH_MAIN, "float32", seed=0)
    arrays = [inp[key].cpu().numpy() for key in ("q", "k", "v")]
    want = ref.flash_attention_reference(*arrays, inp["causal"])
    dist = {how: float(abs(run_attention("flash_attention", inp, how)
                           .double().cpu().numpy() - want).max())
            for how in ("cuda", "first", "plain")}
    check(dist["cuda"] <= F64_FACTOR * dist["plain"],
          f"flash_attention at {FLASH_MAIN}: {dist['cuda']} from the float64 "
          f"reference, more than {F64_FACTOR} x the plain version's "
          f"{dist['plain']}")
    return {"phase": "parity", "kernel": "flash_attention",
            "shape": list(FLASH_MAIN), "dtype": "float32",
            "float64_max_abs_dist": dist, "factor": F64_FACTOR}


def _decode_split_parity(inp: dict, got, tol: float) -> dict:
    """The decode kernel's output ``got`` against its plain version under
    the kernel's own split plan (``max_abs_err`` above is against the plain
    version in one range)."""
    import torch

    from repro_torch.kernels import decode_attention as da

    plan = da.kernel_plan(inp["q"], inp["k"], inp["v"])
    want = run_attention("decode_attention", inp, "plain_split")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(got.dtype == want.dtype and err <= tol,
          f"decode_attention {tuple(inp['k'].shape)} differs from its plain "
          f"version under its split plan ({plan.n_split} x "
          f"{plan.split_len}): max abs err {err} > {tol}")
    return {"heads_per_block": plan.hpb, "head_groups": plan.n_hg,
            "n_split": plan.n_split, "split_len": plan.split_len,
            "lengths": inp["lengths"].tolist()[:8],
            "max_abs_err_split_plan": err}


def phase_ssd_parity() -> float:
    """The SSD kernels against their plain version on the same inputs (y
    and the final state within SSD_TOLS of the largest plain value), and at
    one small shape both against the float64 sequential reference;
    returns the largest float32 error at the prefill shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    err_main = None
    for i, shape in enumerate(SSD_PARITY):
        for dtype, tol in SSD_TOLS.items():
            inp = ssd_inputs(shape, dtype, seed=i)
            got = run_ssd(inp, "cuda")
            want = run_ssd(inp, "plain")
            torch.cuda.synchronize()
            errs = []
            for what, g, w in zip(("y", "state"), got, want):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"ssd_scan {shape} {dtype} {what}: {g.dtype} "
                      f"{tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
                err = float((g.float() - w.float()).abs().max())
                scale = float(w.float().abs().max())
                check(torch.isfinite(g).all().item() and err <= tol * scale,
                      f"ssd_scan {shape} {dtype} {what} differs from its "
                      f"plain version: max abs err {err} > {tol} x {scale}")
                errs.append(err)
            rec = {"phase": "parity", "kernel": "ssd_scan",
                   "shape": list(shape), "dtype": dtype,
                   "max_abs_err_y": errs[0], "max_abs_err_state": errs[1],
                   "tol_of_largest": tol, "prefill_shape": i == 0}
            if i == 1 and dtype == "float32":
                host = [t.float().cpu().numpy() for t in
                        (inp["x"], inp["dt"], inp["a"], inp["b"], inp["c"])]
                r_y, r_s = ref.ssd_reference(*host)
                for what, g, w in (("y", got[0], r_y), ("state", got[1], r_s)):
                    e = float(np.abs(g.float().cpu().numpy() - w).max())
                    check(e <= tol * float(np.abs(w).max()),
                          f"ssd_scan {shape} {what} vs the float64 "
                          f"reference: max abs err {e}")
                    rec[f"ref_err_{what}"] = e
            if i == 0 and dtype == "float32":
                err_main = max(errs)
            emit(rec)
    return err_main


def _explore_once(scenario, backend):
    import torch

    from repro_torch.core import timing
    from repro_torch.core.compass import explore
    from repro_torch.core.ga import GAConfig

    ga = GAConfig(population=MAIN_POP, generations=MAIN_GENS, seed=0)
    timing.clear_timing_backend_stats()            # counts to 0 just before
    t0 = time.perf_counter()
    res = explore(scenario, bo_iters=4, bo_init=3, ga_config=ga, seed=0,
                  timing_backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = timing.timing_backend_stats()          # read just after
    stats["routes"] = _me_routes()
    return res, wall, stats


def _me_routes() -> dict:
    from repro_torch.kernels import mapping_eval as me

    return me.route_counts()


def _oracle_agreement(scenario, res, device) -> float:
    """Re-price the best mapping on the card and return its largest
    relative gap to the numpy oracle's per-batch latency and energy."""
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    hw, batches = res.hardware, scenario.rollout().batches
    pairs = [get_graph_and_tables(scenario.spec, b, hw,
                                  scenario.micro_batch(hw, b),
                                  scenario.n_blocks) for b in batches]
    worst = 0.0
    for key, enc in res.mapping.encodings.items():
        idxs = [i for i, (g, _) in enumerate(pairs)
                if (g.rows, g.n_cols) == key]
        ev = GroupPopulationEvaluator([pairs[i][0] for i in idxs],
                                      [pairs[i][1] for i in idxs], hw,
                                      device=device)
        lat, en = ev.evaluate_population([enc])
        for j, i in enumerate(idxs):
            r = res.mapping.per_batch[i]
            worst = max(worst, abs(lat[j, 0] - r.latency_s) / r.latency_s,
                        abs(en[j, 0] - r.energy_j) / r.energy_j)
    return worst


def _golden_goodput(device) -> dict:
    """The golden ``search_goodput_stream`` case, on the card."""
    from repro_torch.core.compass import CoSearchConfig, Scenario, search_mapping
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.objectives import GoodputUnderSLO
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.traces import TraceDistribution
    from repro_torch.core.workload import LLMSpec

    spec = LLMSpec("tiny", 512, 8, 8, 64, 2048, 32000, 8)
    hw = make_hardware(64, "M", tensor_parallel=2)
    cfg = GAConfig(population=8, generations=4, seed=0)
    st = RequestStream("golden", trace=TraceDistribution(
        "small", mean_input=48, mean_output=12, max_len=256), rate=16.0,
        n_requests=32, warm_fraction=0.6, max_new_tokens_cap=6, seed=3)
    sc = Scenario("golden", spec, target_tops=64, stream=st,
                  scheduler="orca", n_blocks=1, max_stream_iters=32)
    ro = sc.rollout()
    mbs = [sc.micro_batch(hw, b) for b in ro.batches]
    kw = dict(objective=GoodputUnderSLO(ttft_slo_s=0.5, tpot_slo_s=0.1),
              n_blocks=1, stream_rollout=ro, device=device)
    one = search_mapping(spec, ro.batches, hw, mbs, cfg, **kw)
    fp = search_mapping(spec, ro.batches, hw, mbs, cfg,
                        co_search=CoSearchConfig(mode="fixed_point",
                                                 max_rounds=4), **kw)
    joint = search_mapping(spec, ro.batches, hw, mbs, cfg, co_search="joint",
                           **kw)
    warm = search_mapping(spec, ro.batches, hw, mbs, cfg,
                          co_search=CoSearchConfig(mode="joint", warm_from=fp,
                                                   warm_fraction=0.5), **kw)
    return {"one_sweep_score": one.score, "fixed_point_score": fp.score,
            "fixed_point_rounds": fp.rounds,
            "fixed_point_converged": fp.converged,
            "joint_score": joint.score, "joint_warm_score": warm.score,
            "n_groups": len(one.encodings), "n_batches": len(ro.batches)}


def _path_ok(stats: dict, kernel: str) -> None:
    """Only the kernel's CUDA path (and the oracle's final pricing) ran,
    every launch on the shared-row route."""
    disp = stats["dispatches"]
    check(stats["launches"][kernel] > 0, f"{kernel} was never launched")
    routes = stats.get("routes") or _me_routes()
    check(routes[f"{kernel}:shared"] == stats["launches"][kernel],
          f"{kernel} left the shared-row route: {routes}")
    check(set(disp) <= {f"{kernel}:cuda", "oracle"},
          f"unexpected dispatch paths {sorted(disp)}")


def phase_main(scenario, device) -> dict:
    from repro_torch.core import timing

    check(timing.get_timing_backend(None).name == "fused",
          "the default backend is not fused")
    runs, results = {}, {}
    for label, backend, kernel in (("fused", None, "mapping_eval_fused"),
                                   ("kernel", "kernel", "mapping_eval")):
        res, wall, stats = _explore_once(scenario, backend)
        results[label] = res
        _path_ok(stats, kernel)
        score = float(res.bo.best_score)
        check(math.isfinite(score) and score > 0, f"best score {score}")
        gap = _oracle_agreement(scenario, res, device)
        check(gap <= 1e-4, f"card vs numpy oracle gap {gap}")
        calls = stats["dispatches"][f"{kernel}:cuda"]
        runs[label] = {"best_score": score, "wall_s": wall,
                       "launches": stats["launches"][kernel],
                       "launches_by_route": {
                           r: stats["routes"][f"{kernel}:{r}"]
                           for r in ("shared", "global")},
                       "evaluator_calls": calls,
                       "launches_per_generation":
                           stats["launches"][kernel] / calls,
                       "points": len(res.bo.points),
                       "best_hw": {"spec": res.hardware.spec_name,
                                   "grid": list(res.hardware.grid)},
                       "oracle_gap": gap}
        emit({"phase": "main", "backend": label, "kernel": kernel,
              **runs[label], "dispatches": stats["dispatches"]})
    check(runs["fused"]["best_score"] == runs["kernel"]["best_score"],
          "fused and kernel backends found different best scores")

    with open(ROOT / "tests" / "goldens" / "search_goldens.json") as f:
        golden = json.load(f)["search_goodput_stream"]
    timing.clear_timing_backend_stats()
    got = _golden_goodput(None)
    stats = timing.timing_backend_stats()
    _path_ok(stats, "mapping_eval_fused")
    for key, want in golden["values"].items():
        have = got[key]
        if isinstance(want, (bool, int)):
            check(have == want, f"golden {key}: {have} != {want}")
        else:
            check(math.isfinite(have)
                  and abs(have - want) <= golden["rtol"] * abs(want),
                  f"golden {key}: {have} vs {want}")
    emit({"phase": "golden", "case": "search_goodput_stream", "values": got,
          "rtol": golden["rtol"], "launches": stats["launches"],
          "launches_by_route": _me_routes()})
    runs["compare"] = _compare(scenario, results["fused"], device)
    runs["fleet_planned"] = _fleet_planned(device)
    runs["population_chunks"] = _population_chunks(scenario, device)
    return runs


def _moham_oracle_gap(scenario, moh, device) -> float:
    """MOHaM's winner re-priced on the card by the population evaluator
    against the numpy oracle: the largest relative gap of its per-batch
    latency and energy, and of its score."""
    from repro_torch.core.baselines import _evaluate_on_test
    from repro_torch.core.compass import scenario_score
    from repro_torch.core.evaluator import CostTables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator
    from repro_torch.core.workload import build_execution_graph

    hw = moh.hardware
    _, _, oracle_lat = _evaluate_on_test(scenario, hw, moh.encodings, 1)
    worst, lat, en, b_lat = 0.0, 0.0, 0.0, []
    for batch, want in zip(scenario.batches(hw), oracle_lat):
        g = build_execution_graph(scenario.spec, batch, 1,
                                  tp=hw.tensor_parallel,
                                  n_blocks=scenario.n_blocks)
        ev = GroupPopulationEvaluator([g], [CostTables.build(g, hw)], hw,
                                      device=device)
        b_l, b_e = ev.evaluate_population([moh.encodings[(g.rows, g.n_cols)]])
        worst = max(worst, abs(b_l[0, 0] - want) / want)
        lat, en = lat + b_l[0, 0], en + b_e[0, 0]
        b_lat.append(b_l[0, 0])
    worst = max(worst, abs(en - moh.energy_j) / moh.energy_j)
    score = scenario_score(scenario, "edp_mc", lat, en, moh.mc_total, b_lat)
    return max(worst, abs(score - moh.score) / abs(moh.score))


def _scar_on(scenario, hw):
    """SCAR-style greedy mappings of every batch of the scenario on ``hw``
    (the Compass winner), priced by the numpy oracle."""
    from repro_torch.core.baselines import scar_style_mapping
    from repro_torch.core.compass import scenario_score
    from repro_torch.core.evaluator import CostTables, evaluate
    from repro_torch.core.hardware import monetary_cost
    from repro_torch.core.workload import build_execution_graph

    lat = en = 0.0
    b_lat = []
    for batch in scenario.batches(hw):
        g = build_execution_graph(scenario.spec, batch,
                                  scenario.micro_batch(hw, batch),
                                  tp=hw.tensor_parallel,
                                  n_blocks=scenario.n_blocks)
        tables = CostTables.build(g, hw)
        r = evaluate(g, scar_style_mapping(g, hw, tables), hw, tables)
        lat, en = lat + r.latency_s, en + r.energy_j
        b_lat.append(r.latency_s)
    mc = monetary_cost(hw)["mc_total"]
    return {"latency_s": lat, "energy_j": en, "mc_total": mc,
            "score": scenario_score(scenario, "edp_mc", lat, en, mc, b_lat)}


def _compare(scenario, compass, device) -> dict:
    """The paper's baselines on the canonical scenario at
    benchmarks/bench_compare.py's reduced budgets: Gemini-style (numpy
    oracle), MOHaM-style (its GA priced by the population evaluator on the
    card, through the fused kernel: launches counted, no plain dispatch,
    its winner re-priced on the card within 1e-4 of the oracle) and
    SCAR-style on the Compass winner's hardware; each one's EDP reduction
    by the Compass ``explore`` result (1 - Compass EDP / its EDP)."""
    import torch

    from repro_torch.core import timing
    from repro_torch.core.baselines import (
        gemini_style_search,
        moham_style_search,
    )
    from repro_torch.core.ga import GAConfig

    def row(lat, en, mc, score, wall):
        edp = lat * en
        return {"latency_s": lat, "energy_j": en, "edp": edp,
                "mc_total": mc, "score": score, "wall_s": wall,
                "edp_reduction": 1.0 - c_edp / edp,
                "edp_mc_reduction": 1.0 - c_edp * c.mc_total / (edp * mc)}

    c = compass.mapping
    c_edp = c.latency_s * c.energy_j
    rec = {"phase": "main", "run": "compare",
           "compass": {"latency_s": c.latency_s, "energy_j": c.energy_j,
                       "edp": c_edp, "mc_total": c.mc_total,
                       "score": c.score}}
    t0 = time.perf_counter()
    gem = gemini_style_search(scenario, sa_iters=60, grid_subsample=4)
    rec["gemini"] = row(gem.latency_s, gem.energy_j, gem.mc_total,
                        # repro-lint: disable=RT006 -- host work: the numpy oracle
                        gem.score, time.perf_counter() - t0)
    timing.clear_timing_backend_stats()            # counts to 0 just before
    t0 = time.perf_counter()
    moh = moham_style_search(scenario, generations=3, population=6,
                             ga_config=GAConfig(population=8, generations=3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = timing.timing_backend_stats()          # read just after
    stats["routes"] = _me_routes()
    _path_ok(stats, "mapping_eval_fused")
    gap = _moham_oracle_gap(scenario, moh, device)
    check(gap <= 1e-4, f"MOHaM: card vs numpy oracle gap {gap}")
    rec["moham"] = {**row(moh.latency_s, moh.energy_j, moh.mc_total,
                          moh.score, wall),
                    "launches": stats["launches"]["mapping_eval_fused"],
                    "launches_by_route": {
                        r: stats["routes"][f"mapping_eval_fused:{r}"]
                        for r in ("shared", "global")},
                    "dispatches": stats["dispatches"], "oracle_gap": gap}
    t0 = time.perf_counter()
    scar = _scar_on(scenario, compass.hardware)
    rec["scar"] = row(scar["latency_s"], scar["energy_j"], scar["mc_total"],
                      scar["score"], time.perf_counter() - t0)
    for name in ("gemini", "moham", "scar"):
        r = rec[name]
        check(all(math.isfinite(r[k]) and r[k] > 0
                  for k in ("latency_s", "energy_j", "mc_total")),
              f"{name}: {r}")
    rec["seconds"] = sum(rec[name]["wall_s"]
                         for name in ("gemini", "moham", "scar"))
    emit(rec)
    return rec


def _jax_fleet_record() -> dict:
    """The JAX package's CPU record of the same fleet frontier
    (BENCH_serving.json, ``fleet_frontier``) by rate, printed beside the
    port's for comparison only: that file predates the port."""
    with open(ROOT / "BENCH_serving.json") as f:
        rec = json.load(f)["fleet_frontier"]
    return {"objective": rec["objective"],
            "points": {p["rate"]: p for p in rec["points"]}}


def _fleet_planned(device) -> dict:
    """The fleet control plane over the search path: at each rate of
    FLEET_RATES, ``plan_scale_out`` of a 1-replica fleet (keep, re_search
    warm-started from the keep serve's ``MappingSearchOutput``, add_replica)
    whose replicas price every rollout by a ``compass_pricer`` goodput
    search on the card under the default (fused) backend. Every evaluator
    call reaches ``mapping_eval_fused`` on the shared-row route and nothing
    dispatches to a plain version. Prints per rate the best action, its
    replica count, goodput per dollar and loads, every option's score,
    the wall and the launches, beside the JAX package's CPU record."""
    import numpy as np
    import torch

    from repro_torch.configs import llm_spec
    from repro_torch.core import timing
    from repro_torch.core.compass import MappingSearchOutput, search_mapping
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.objectives import GoodputUnderSLO
    from repro_torch.core.streams import RequestStream, rollout
    from repro_torch.core.traces import SHAREGPT
    from repro_torch.core.workload import DECODE
    from repro_torch.fleet import (
        Fleet,
        PlannedReplica,
        compass_pricer,
        plan_scale_out,
    )
    from repro_torch.serving.scheduler import get_scheduler

    spec = llm_spec(SERVE_ARCH)
    hw = make_hardware(512, "L", tensor_parallel=8)
    hw = hw.replace(layout=tuple(["WS", "OS"] * (hw.n_chiplets // 2)))
    base = RequestStream("sharegpt-fleet", trace=SHAREGPT, rate=1.0,
                         n_requests=FLEET_REQUESTS, warm_fraction=FLEET_WARM,
                         max_new_tokens_cap=FLEET_NEW_CAP, seed=0)
    ga = GAConfig(population=FLEET_POP, generations=FLEET_GENS)
    t0 = time.perf_counter()
    mid = sorted(FLEET_RATES)[len(FLEET_RATES) // 2]
    pre_ro = rollout(base.with_rate(mid), get_scheduler("orca"),
                     max_slots=FLEET_SLOTS, max_iters=FLEET_ITERS)
    pre_mbs = [hw.micro_batch_decode if any(r.kind == DECODE for r in b)
               else hw.micro_batch_prefill for b in pre_ro.batches]
    pre = search_mapping(spec, pre_ro.batches, hw, pre_mbs, ga,
                         objective="latency", n_blocks=FLEET_BLOCKS,
                         device=device)
    pre_tim = pre_ro.timings(pre.batch_latencies)
    obj = GoodputUnderSLO(
        ttft_slo_s=float(np.percentile(pre_tim.cold_ttft_s, FLEET_SLO_PCT)),
        tpot_slo_s=float(np.percentile(pre_tim.tpot_s, FLEET_SLO_PCT)))
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0

    def replica(name="r0", warm_from=None):
        return PlannedReplica(
            pricer=compass_pricer(spec, hw, ga, objective=obj,
                                  n_blocks=FLEET_BLOCKS, warm_from=warm_from,
                                  device=device),
            scheduler="orca", max_slots=FLEET_SLOTS, max_iters=FLEET_ITERS,
            name=name)

    def re_search(rep, res):
        donor = res.meta["search_output"]
        check(isinstance(donor, MappingSearchOutput),
              f"re_search donor is a {type(donor).__name__}")
        return replica(f"{rep.name}'", donor)

    jax_rec = _jax_fleet_record()
    points = []
    for rate in FLEET_RATES:
        timing.clear_timing_backend_stats()        # counts to 0 just before
        t0 = time.perf_counter()
        dec = plan_scale_out(Fleet([replica()]), base, rate, objective=obj,
                             re_search=re_search)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = timing.timing_backend_stats()      # read just after
        stats["routes"] = _me_routes()
        _path_ok(stats, "mapping_eval_fused")
        best = dec.best
        check([o.action for o in dec.options]
              == ["keep", "re_search", "add_replica"]
              and math.isfinite(best.score) and best.score > 0
              and all(o.result.timings.finished.all() for o in dec.options),
              f"fleet at rate {rate}: {dec.record()}")
        searches = [r.meta for o in dec.options
                    for r in o.result.replica_results]
        point = {"rate": rate, "best_action": best.action,
                 "n_replicas": best.fleet.n_replicas,
                 "goodput_per_dollar": best.score,
                 "goodput_req_per_s": best.result.goodput(obj),
                 "mc_total": best.result.mc_total,
                 "loads": best.result.route.loads().tolist(),
                 "options": [{"action": o.action,
                              "n_replicas": o.fleet.n_replicas,
                              "goodput_per_dollar": o.score,
                              "truncated": o.result.truncated}
                             for o in dec.options],
                 "searches": len(searches),
                 "search_modes": [m["mode"] for m in searches],
                 "ga_evaluations": sum(m["ga_evaluations"]
                                       for m in searches),
                 "wall_s": wall,
                 "launches": stats["launches"]["mapping_eval_fused"],
                 "launches_by_route": {
                     r: stats["routes"][f"mapping_eval_fused:{r}"]
                     for r in ("shared", "global")},
                 "dispatches": stats["dispatches"],
                 "jax_cpu": jax_rec["points"].get(rate)}
        emit({"phase": "main", "run": "fleet_planned", **point})
        points.append(point)
    rec = {"slo": {"ttft_s": obj.ttft_slo_s, "tpot_s": obj.tpot_slo_s,
                   "percentile_of_latency_presearch": FLEET_SLO_PCT},
           "jax_cpu_objective": jax_rec["objective"],
           "presearch_wall_s": pre_wall, "points": points,
           "seconds": pre_wall + sum(p["wall_s"] for p in points)}
    emit({"phase": "main", "run": "fleet_planned_summary",
          **{k: v for k, v in rec.items() if k != "points"}})
    return rec


def _same_arrays(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))


def _population_chunks(scenario, device) -> dict:
    """The population split into CHUNKS chunks, all on this card
    (``device=[cuda:0] * CHUNKS``), against the unsplit path, on the
    canonical scenario's graph (B 3, rows 4, M 80): for the dense, kernel
    and fused backends at each of CHUNK_POPS, ``evaluate_population`` and
    ``timing_matrix`` equal bit for bit and CHUNKS launches a call instead
    of 1 (counts set to 0 just before, read just after); then one
    ``search_mapping`` (GA MAIN_POP x MAIN_GENS, fused) in CHUNKS chunks
    equal in encodings, scores and GA history to the unsplit search, with
    CHUNKS times its launches. The fused grid order is fixed for the
    record, so no autotune probe launches; the walls of each pair side by
    side."""
    import numpy as np
    import torch

    from repro_torch.core import timing
    from repro_torch.core.compass import search_mapping
    from repro_torch.core.encoding import random_encoding
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    kernels = {"dense": None, "kernel": "mapping_eval",
               "fused": "mapping_eval_fused"}
    chunked = [device] * CHUNKS
    base = canonical_evaluator(scenario, device)
    g = base.graphs[0]
    rng = np.random.default_rng(28)
    pops = {n: [random_encoding(rng, g.rows, g.n_cols, base.hw.n_chiplets)
                for _ in range(n)] for n in CHUNK_POPS}
    os.environ["REPRO_FUSED_GRID_ORDER"] = "batch_major"
    try:
        evals = []
        for backend, kernel in kernels.items():
            one, split = (GroupPopulationEvaluator(
                base.graphs, base.tables, base.hw, backend=backend,
                device=dev) for dev in (device, chunked))
            for n, encs in pops.items():
                a, b = one.evaluate_population(encs), \
                    split.evaluate_population(encs)
                ta, tb = one.timing_matrix(encs), split.timing_matrix(encs)
                fields = ("op_start_s", "op_end_s", "chip_free_s")
                same = _same_arrays(a, b) and _same_arrays(
                    [getattr(ta, f) for f in fields],
                    [getattr(tb, f) for f in fields])
                check(same, f"population chunks: {backend} at P {n} differ "
                            "from the unsplit path")
                counts = {}
                for label, ev in (("one", one), ("chunked", split)):
                    _, _, launches, _ = _counted(
                        lambda ev=ev: ev.evaluate_population(encs))
                    counts[label] = launches.get(kernel, 0) if kernel \
                        else sum(launches.values())
                check(counts == ({"one": 1, "chunked": CHUNKS} if kernel
                                 else {"one": 0, "chunked": 0}),
                      f"population chunks: {backend} at P {n} launched "
                      f"{counts}")
                walls = _in_turns(
                    {"one": lambda: one.evaluate_population(encs),
                     "chunked": lambda: split.evaluate_population(encs)},
                    CHUNK_REPS)
                evals.append({"backend": backend, "population": n,
                              "bitwise": same, "launches": counts,
                              "ms_per_call": walls})

        batches = scenario.rollout().batches
        hw = base.hw
        mbs = [scenario.micro_batch(hw, b) for b in batches]
        ga = GAConfig(population=MAIN_POP, generations=MAIN_GENS, seed=0)
        search = {}
        for label, dev in (("one", device), ("chunked", chunked)):
            timing.clear_timing_backend_stats()       # counts to 0 just before
            t0 = time.perf_counter()
            out = search_mapping(scenario.spec, batches, hw, mbs, ga,
                                 n_blocks=scenario.n_blocks,
                                 timing_backend="fused", device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = timing.timing_backend_stats()     # read just after
            search[label] = (out, wall, stats)
        (o1, w1, s1), (o2, w2, s2) = search["one"], search["chunked"]
        same = (o1.score == o2.score and o1.latency_s == o2.latency_s
                and o1.energy_j == o2.energy_j
                and [r.history for r in o1.ga_results]
                == [r.history for r in o2.ga_results]
                and all(np.array_equal(o1.encodings[k].segmentation,
                                       o2.encodings[k].segmentation)
                        and np.array_equal(o1.encodings[k].layer_to_chip,
                                           o2.encodings[k].layer_to_chip)
                        for k in o1.encodings))
        check(same, "population chunks: the chunked search_mapping differs")
        n1 = s1["launches"]["mapping_eval_fused"]
        n2 = s2["launches"]["mapping_eval_fused"]
        calls = s1["dispatches"]["mapping_eval_fused:cuda"]
        check(n1 == calls and n2 == CHUNKS * n1,
              f"population chunks: search launches {n1} / {n2} for {calls} "
              "evaluator calls")
    finally:
        os.environ.pop("REPRO_FUSED_GRID_ORDER", None)
    rec = {"phase": "main", "record": "population_chunks", "chunks": CHUNKS,
           "devices": [str(device)] * CHUNKS, "evaluator": evals,
           "search": {"population": MAIN_POP, "generations": MAIN_GENS,
                      "score": o1.score, "equal": same,
                      "evaluator_calls": calls,
                      "launches": {"one": n1, "chunked": n2},
                      "launches_per_call": {"one": n1 / calls,
                                            "chunked": n2 / calls},
                      "wall_s": {"one": w1, "chunked": w2}},
           "card": card_line()}
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# the serving path
# --------------------------------------------------------------------------


def _serve_requests(vocab: int):
    """8 requests, prompt lengths 64-512 and tokens from numpy seed 0,
    16 new tokens each, two arriving per iteration."""
    import numpy as np

    from repro_torch.serving import ServeRequest

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=SERVE_REQUESTS)
    return [ServeRequest(i, rng.integers(0, vocab, size=int(n)).tolist(),
                         SERVE_NEW, arrived_iter=i // 2)
            for i, n in enumerate(lens)]


def _sched(name: str):
    from repro_torch.serving import SCHEDULERS

    return (SCHEDULERS[name](chunk=SERVE_CHUNK)
            if name == "chunked_prefill" else SCHEDULERS[name]())


def _decode_dispatches(cfg, n_dec: int) -> dict:
    """The kernel dispatches an engine run must make: one decode-attention
    launch per attention layer and decode iteration. Prompts go through
    ``extend`` (eager attention, the eager chunked SSD) and decode through
    the one-step Mamba recurrence, so a Mamba layer dispatches nothing."""
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "attn")
    return {"decode_attention:cuda": n_dec * n_attn} if n_attn else {}


def _engine_run(params, cfg, arch: str, sched_name: str, device,
                cache_dtype=None, impl: str = "kernel") -> tuple[dict, dict]:
    """One ``ServingEngine.run`` (with the weights' dtype for its cache
    unless ``cache_dtype`` says otherwise; ``impl="eager"`` launches no
    kernel); returns its record and the token streams {rid: (prompt,
    generated)}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine, summarize

    sched = _sched(sched_name)
    weights = next(params.parameters()).dtype
    cache_dtype = cache_dtype or weights
    eng = ServingEngine(params, cfg, max_batch=SERVE_REQUESTS,
                        max_len=SERVE_MAX_LEN, impl=impl,
                        cache_dtype=cache_dtype, device=device)
    reqs = _serve_requests(cfg.vocab)
    torch.cuda.synchronize()
    ops.clear_dispatch_stats()                     # counts to 0 just before
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs, sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, disp = ops.launch_counts(), ops.dispatch_stats()  # just after
    del eng
    check(not res.truncated and len(res.finished) == SERVE_REQUESTS,
          f"{sched_name}: {len(res.finished)} of {SERVE_REQUESTS} requests "
          f"finished")
    check(all(len(r.generated) == SERVE_NEW for r in res.finished),
          f"{sched_name}: a request did not get {SERVE_NEW} tokens")
    n_dec = sum(1 for st in res.stats if st.n_decode)
    want = _decode_dispatches(cfg, n_dec) if impl == "kernel" else {}
    check(disp == want, f"{arch} {sched_name}: dispatch paths {disp}, "
          f"expected {want} ({n_dec} decode iterations)")
    check(all(n == want.get(f"{k}:cuda", 0) for k, n in launches.items()),
          f"{arch} {sched_name}: launches {launches}, expected {want}")
    summ = summarize(res.finished, res.stats)
    out_tokens = summ["output_tokens"]
    rec = {"phase": "serve", "run": "engine", "arch": arch, "impl": impl,
           "weights": str(weights).removeprefix("torch."),
           "cache": str(cache_dtype).removeprefix("torch."),
           "scheduler": sched_name, "wall_s": wall,
           "tokens_per_s": out_tokens / wall, "output_tokens": out_tokens,
           "prefill_tokens": sum(st.n_prefill_tokens for st in res.stats),
           "iterations": len(res.stats), "decode_iterations": n_dec,
           "engine_seconds": summ["total_seconds"],
           "mean_slots_used": summ["mean_slots_used"],
           "launches": launches, "dispatches": disp}
    emit(rec)
    return rec, {r.rid: (r.prompt, r.generated) for r in res.finished}


def _engine_profile(params, cfg, arch: str, device) -> dict:
    """One more orca run of the engine (its cache in the weights' dtype)
    under ``torch.profiler`` (its launches are not the path's count):
    device busy share, and the device time in the hand-written kernels, in
    matrix products and in the rest."""
    from repro_torch.serving import OrcaScheduler
    from repro_torch.serving.engine import ServingEngine

    weights = next(params.parameters()).dtype
    eng = ServingEngine(params, cfg, max_batch=SERVE_REQUESTS,
                        max_len=SERVE_MAX_LEN, cache_dtype=weights,
                        device=device)
    reqs = _serve_requests(cfg.vocab)
    prof, kern = _profiled(lambda: eng.run(reqs, OrcaScheduler()))
    del eng

    def device_ms(pred) -> float:
        return sum(_dev_us(e) for e in kern if pred(e.key.lower())) / 1e3

    rec = {"phase": "serve", "run": "profile", "arch": arch,
           "weights": str(weights).removeprefix("torch."),
           "scheduler": "orca", **prof,
           "hand_kernel_ms": {name: device_ms(lambda k, n=name: n in k)
                              for name in ("decode_attention",
                                           "flash_attention", "ssd_scan")},
           "gemm_ms": device_ms(lambda k: "gemm" in k or "xmma" in k
                                or "cutlass" in k or "nvjet" in k)}
    rec["other_device_ms"] = (prof["device_busy_ms"] - rec["gemm_ms"]
                              - sum(rec["hand_kernel_ms"].values()))
    emit(rec)
    return rec

def _forced_steps(params, cfg, state: dict, feed, device, tol: float,
                  what: str, lanes=None) -> dict:
    """Teacher forcing from ``state`` (``{"kernel": (logits, cache),
    "eager": (logits, cache)}``): at each step the kernel path's logits are
    within ``tol`` of the largest eager logit (on the lanes that
    ``lanes(step)`` keeps, where it is given: a [B] bool mask); then
    ``feed(step, eager_logits)`` gives the next token (None ends the run)
    and both paths take one ``decode_step``. A kernel step launches the
    decode kernel once per attention layer and nothing else, an eager step
    nothing; the counts are set to 0 just before the first step and read
    just after the last. Returns the eager logits of every step with the
    record's numbers."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import decode_step

    per_step = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    refs, worst, walls = [], 0.0, {"kernel": 0.0, "eager": 0.0}
    ops.clear_dispatch_stats()                     # counts to 0 just before
    ops.reset_launch_counts()
    while True:
        got, ref = state["kernel"][0], state["eager"][0]
        scale = float(ref.abs().max())
        diff = (got - ref).abs()
        if lanes is not None:
            diff = diff[lanes(len(refs))]
        err = float(diff.max()) if diff.numel() else 0.0
        check(torch.isfinite(got).all().item() and err <= tol * scale,
              f"{what} step {len(refs)}: kernel vs eager logits differ by "
              f"{err} > {tol} x {scale}")
        worst = max(worst, err / scale)
        refs.append(ref)
        tok = feed(len(refs) - 1, ref)
        if tok is None:
            break
        for impl in ("kernel", "eager"):
            before = ops.launch_counts()["decode_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state[impl] = decode_step(params, cfg, tok, state[impl][1],
                                      impl=impl, device=device)
            torch.cuda.synchronize()
            walls[impl] += time.perf_counter() - t0
            n = ops.launch_counts()["decode_attention"] - before
            check(n == (per_step if impl == "kernel" else 0),
                  f"{what} step {len(refs)} ({impl}): {n} decode launches")
    launches, disp = ops.launch_counts(), ops.dispatch_stats()  # just after
    steps = len(refs) - 1
    want = steps * per_step
    check(sum(launches.values()) == launches["decode_attention"] == want
          and disp == ({"decode_attention:cuda": want} if want else {}),
          f"{what}: launches {launches}, dispatches {disp}")
    return {"refs": refs, "steps": steps, "launches": launches,
            "dispatches": disp, "launches_per_step": per_step,
            "max_rel_logit_err": worst, "wall_s": walls}


def _replay(params, cfg, arch: str, streams: dict, device,
            tol: float = LOGIT_REL) -> dict:
    """Teacher forcing: each request's prompt through ``prefill`` and its
    generated tokens through ``decode_step``, once with ``impl="kernel"``
    and once with ``impl="eager"`` (:func:`_forced_steps`). At every step
    the two logits agree within ``tol`` of the largest, and the eager
    argmax is the engine's token wherever the eager top-two gap exceeds
    that tolerance."""
    import torch

    from repro_torch.models import init_cache, prefill

    worst, checked, skipped = 0.0, 0, 0
    t0 = time.perf_counter()
    for rid, (prompt, gen) in sorted(streams.items()):
        toks = torch.as_tensor([prompt], device=device)
        state = {}
        for impl in ("kernel", "eager"):
            cache = init_cache(cfg, 1, SERVE_MAX_LEN, torch.float32, device)
            state[impl] = prefill(params, cfg, toks, cache, impl=impl,
                                  device=device)
        run = _forced_steps(
            params, cfg, state,
            lambda j, ref, gen=gen: (torch.as_tensor([gen[j]], device=device)
                                     if j + 1 < len(gen) else None),
            device, tol, f"{arch} request {rid}")
        worst = max(worst, run["max_rel_logit_err"])
        for j, (ref, want) in enumerate(zip(run["refs"], gen)):
            ref = ref[0]
            top2 = torch.topk(ref, 2).values
            if float(top2[0] - top2[1]) > tol * float(ref.abs().max()):
                check(int(ref.argmax()) == want,
                      f"request {rid} step {j}: eager argmax "
                      f"{int(ref.argmax())} != engine token {want}")
                checked += 1
            else:
                skipped += 1
    torch.cuda.synchronize()
    rec = {"phase": "serve", "run": "teacher_forcing", "arch": arch,
           "requests": len(streams), "steps": checked + skipped,
           "argmax_checked": checked, "argmax_skipped_small_gap": skipped,
           "max_rel_logit_err": worst, "tol": tol,
           "wall_s": time.perf_counter() - t0}
    emit(rec)
    return rec


def _mamba_layer_check(params, cfg, toks, device) -> dict:
    """Along the eager prefill's own trajectory, every Mamba layer's mixer
    through the SSD kernel and through the eager SSD on the same input:
    outputs and final states within LOGIT_REL of the largest eager value
    (these launches are not the path's count). Beside it, a second eager
    trajectory whose SSD runs at the kernel's chunk of 64 instead of 128:
    the distance of its logits from the first is the spread that float32
    rounding alone opens through the depth."""
    import torch

    from repro_torch.kernels.ssd_scan import KERNEL_CHUNK, ssd_chunked
    from repro_torch.models import mamba2, transformer

    def eager_at(p, h, chunk):
        z, xs, b_mat, c_mat, dt = mamba2._split_proj(p, h, cfg)
        bsz, l, _ = h.shape
        heads, pdim = mamba2._heads(cfg)
        init = torch.zeros((bsz, heads, cfg.ssm_state, pdim), device=device)
        y, _ = ssd_chunked(xs.reshape(bsz, l, heads, pdim), dt,
                           -torch.exp(p.a_log), b_mat, c_mat, init, chunk)
        return mamba2._gate_out(p, y, z, h, cfg)

    worst = {"y": 0.0, "state": 0.0}
    with torch.no_grad():
        x = x64 = params.embed.e[toks]
        for blk in params.blocks:
            h = transformer._norm(cfg, blk.norm1, x)
            y_k, c_k = mamba2.mamba_prefill(blk.mamba, h, cfg, None,
                                            impl="kernel")
            y_e, c_e = mamba2.mamba_prefill(blk.mamba, h, cfg, None,
                                            impl="eager")
            for what, got, want in (("y", y_k, y_e),
                                    ("state", c_k["state"], c_e["state"])):
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                check(err <= LOGIT_REL * scale, f"ssd_scan on the prefill "
                      f"path: a layer's {what} differs from the eager SSD by "
                      f"{err} (largest {scale})")
                worst[what] = max(worst[what], err / scale)
            x = transformer._ffn_residual(blk, cfg, x + y_e)
            h64 = transformer._norm(cfg, blk.norm1, x64)
            x64 = transformer._ffn_residual(blk, cfg,
                                            x64 + eager_at(blk.mamba, h64,
                                                           KERNEL_CHUNK))
        last = [transformer._logits(params, cfg, transformer._norm(
            cfg, params.final_norm, v)[:, -1]) for v in (x, x64)]
    torch.cuda.synchronize()
    spread = float((last[0] - last[1]).abs().max() / last[0].abs().max())
    return {"max_rel_layer_err": worst, "eager_chunk_spread": spread}


def _prefill_errs(k_logits, k_cache, logits, cache, tol: float,
                  what: str) -> dict:
    """A prefill's logits and caches (K/V, or the Mamba state) on the
    kernel path against a reference path's: within ``tol`` of the largest
    reference value, the lengths equal. Returns the relative errors."""
    import torch

    scale = float(logits.abs().max())
    err = float((k_logits - logits).abs().max())
    check(torch.isfinite(k_logits).all().item() and err <= tol * scale,
          f"{what}: logits differ by {err} > {tol} x {scale}")
    c_err = 0.0
    for kc, rc in zip(k_cache, cache):
        check(torch.equal(kc["len"], rc["len"]), f"{what}: cache lengths")
        for key in sorted(set(kc) - {"len"}):
            e = float((kc[key] - rc[key]).abs().max())
            m = float(rc[key].abs().max())
            check(e <= tol * m,
                  f"{what}: cache {key} differs by {e} (largest {m})")
            c_err = max(c_err, e / m)
    return {"max_rel_logit_err": err / scale, "max_rel_cache_err": c_err}


def _prefill_check(params, cfg, arch: str, kernel: str, device,
                   embeds=None, first_call: bool = False) -> tuple:
    """``prefill`` of 2 prompts of 512 tokens through ``kernel`` (the flash
    kernel, or the SSD kernel of a Mamba model: one launch per layer),
    against ``impl="eager"`` and against ``extend`` from an empty cache:
    logits and caches (K/V, or the Mamba state) within LOGIT_REL of the
    largest reference value; for a Mamba model, within SPREAD_FACTOR x the
    rounding spread of :func:`_mamba_layer_check`, which also holds the
    kernel to LOGIT_REL layer by layer. With ``embeds`` (``[2, L,
    d_model]``) the prompts are embeddings passed as ``inputs_embeds``, and
    ``extend``, which takes tokens only, is left out. With ``first_call``
    each path first makes one call whose wall is recorded apart. Returns
    the record, whose ``tol`` the replay uses, and each path's (logits,
    cache)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import extend, init_cache, prefill

    if embeds is None:
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 512)),
                               device=device)
        args, kw, labels = (toks,), {}, ("kernel", "eager", "extend")
    else:
        args, kw, labels = (None,), {"inputs_embeds": embeds}, ("kernel",
                                                                "eager")
    prompt = args[0].shape[1] if embeds is None else embeds.shape[1]
    runs, first = {}, {}
    for label in labels:
        for cold in (True, False) if first_call else (False,):
            cache = init_cache(cfg, 2, SERVE_MAX_LEN, torch.float32, device)
            torch.cuda.synchronize()
            if label == "kernel" and not cold:
                ops.clear_dispatch_stats()         # counts to 0 just before
                ops.reset_launch_counts()
            t0 = time.perf_counter()
            if label == "extend":
                logits, cache = extend(params, cfg, *args, cache,
                                       impl="eager", device=device)
            else:
                logits, cache = prefill(params, cfg, *args, cache,
                                        impl=label, device=device, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if cold:
                first[label] = wall
                continue
            if label == "kernel":
                launches, disp = ops.launch_counts(), ops.dispatch_stats()
            runs[label] = (logits, cache, wall)
    want = cfg.n_layers
    check(launches[kernel] == want and sum(launches.values()) == want
          and disp == {f"{kernel}:cuda": want},
          f"{arch} prefill: launches {launches}, dispatches {disp}; "
          f"expected {want} {kernel}:cuda")
    tol, layers = LOGIT_REL, None
    if kernel == "ssd_scan":
        layers = _mamba_layer_check(params, cfg, args[0], device)
        tol = max(LOGIT_REL, SPREAD_FACTOR * layers["eager_chunk_spread"])
    k_logits, k_cache, _ = runs["kernel"]
    check(tuple(k_logits.shape) == (2, cfg.vocab),
          f"{arch} prefill logits: shape {tuple(k_logits.shape)}")
    errs = {label: _prefill_errs(k_logits, k_cache, *runs[label][:2], tol,
                                 f"{arch} prefill, kernel vs {label}")
            for label in labels[1:]}
    rec = {"phase": "serve", "run": "prefill", "arch": arch, "kernel": kernel,
           "inputs": "tokens" if embeds is None else "inputs_embeds",
           "batch": 2, "prompt": prompt,
           "wall_s": {label: runs[label][2] for label in runs},
           "first_call_wall_s": first or None,
           "tokens_per_s": {label: 2 * prompt / runs[label][2]
                            for label in runs},
           "launches": launches, "dispatches": disp, "vs": errs,
           "tol": tol, "per_layer": layers}
    emit(rec)
    return rec, {label: runs[label][:2] for label in ("kernel", "eager")}


@contextlib.contextmanager
def _recorded_quantizer():
    """The inputs of every call of the port's int8 quantizer
    (``repro_torch.models.attention._quantize_kv``) while the block runs,
    copied to the host in order."""
    from repro_torch.models import attention

    log, quantize = [], attention._quantize_kv

    def recorded(x):
        log.append(x.detach().to("cpu", copy=True))
        return quantize(x)

    attention._quantize_kv = recorded
    try:
        yield log
    finally:
        attention._quantize_kv = quantize


def _greedy_steps(params, cfg, logits, cache, impl: str, device, n: int,
                  feed=None) -> tuple:
    """``n`` decode steps from (logits, cache): each takes the argmax of
    the last logits, or ``feed[step]`` where given. Returns (every step's
    logits with the first, the tokens fed, cache)."""
    import torch

    from repro_torch.models import decode_step

    out, toks = [logits], []
    for step in range(n):
        tok = torch.argmax(out[-1], -1) if feed is None else feed[step]
        logits, cache = decode_step(params, cfg, tok, cache, impl=impl,
                                    device=device)
        out.append(logits)
        toks.append(tok)
    return out, toks, cache


def _step_walls_in_turns(params, cfg, runs: dict, device, n: int) -> dict:
    """``n`` greedy decode steps of each of ``runs`` (label -> [impl, last
    logits, cache], warm: each has stepped before), one step of each in
    turn, the order rotating every step. Returns label -> the median ms of
    its steps."""
    import statistics

    import torch

    from repro_torch.models import decode_step

    labels, walls = list(runs), {label: [] for label in runs}
    for step in range(n):
        for label in labels[step % len(labels):] + \
                labels[:step % len(labels)]:
            impl, logits, cache = runs[label]
            tok = torch.argmax(logits, -1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode_step(params, cfg, tok, cache, impl=impl,
                                        device=device)
            torch.cuda.synchronize()
            walls[label].append(1e3 * (time.perf_counter() - t0))
            runs[label] = [impl, logits, cache]
    return {label: statistics.median(w) for label, w in walls.items()}


def _int8_cache_record(params, cfg, arch: str, device) -> dict:
    """llama's int8 KV cache at full width: a 2 x 512 ``prefill`` through
    the flash kernel into an int8 cache (``dtype=torch.int8``; the
    environment variable is never set here), then INT8_STEPS greedy
    ``decode_step``s under ``impl="kernel"``, which over an int8 cache
    attend eagerly on the dequantized cache as the reference does: no
    decode launch and no decode dispatch. Every layer's int8 rows and
    scales equal, bit for bit, the quantizer run on the host on the float
    K/V the prefill gave it; the scales are positive, the logits finite,
    the cache (D + 4) / 4D of a float32 cache's bytes. Printed: the logit
    gap to the same tokens over a float32 cache and the greedy tokens that
    agree; then, with every cache warm, INT8_TIMED more steps of the int8
    cache and of the float32 cache under each impl, in turns, and the
    median wall of each."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import attention, init_cache, prefill

    d, n_layers = cfg.head_dim, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 512)), device=device)
    cache = init_cache(cfg, 2, SERVE_MAX_LEN, torch.int8, device)
    rows = [t for layer in cache for k, t in layer.items() if k != "len"]
    n_bytes = sum(t.numel() * t.element_size() for t in rows)
    f32_bytes = n_layers * 2 * 2 * SERVE_MAX_LEN * cfg.n_kv_heads * d * 4
    check(n_bytes * 4 * d == f32_bytes * (d + 4),
          f"{arch} int8 cache: {n_bytes} bytes against {f32_bytes}")
    with _recorded_quantizer() as seen:
        ops.clear_dispatch_stats()                 # counts to 0 just before
        ops.reset_launch_counts()
        logits, cache = prefill(params, cfg, toks, cache, impl="kernel",
                                device=device)
        torch.cuda.synchronize()
        pre_launches, pre_disp = ops.launch_counts(), ops.dispatch_stats()
    check(pre_launches["flash_attention"] == sum(pre_launches.values())
          == n_layers and pre_disp == {"flash_attention:cuda": n_layers},
          f"{arch} int8 prefill: launches {pre_launches}, {pre_disp}")
    check(len(seen) == 2 * n_layers, f"{len(seen)} quantizer calls")
    for i, layer in enumerate(cache):
        for j, key in enumerate(("k", "v")):
            q, sc = attention._quantize_kv(seen[2 * i + j])
            check(torch.equal(layer[key][:, :512].cpu(), q)
                  and torch.equal(layer[key + "_scale"][:, :512].cpu(), sc),
                  f"{arch} int8 prefill layer {i} {key}: not the host "
                  "quantizer's bits")
    del seen
    ops.clear_dispatch_stats()                     # counts to 0 just before
    ops.reset_launch_counts()
    got, fed, cache = _greedy_steps(params, cfg, logits, cache, "kernel",
                                    device, INT8_STEPS)
    launches, disp = ops.launch_counts(), ops.dispatch_stats()
    check(launches["decode_attention"] == 0
          and not any(k.startswith("decode_attention") for k in disp),
          f"{arch} int8 decode: launches {launches}, dispatches {disp}")
    live = 512 + INT8_STEPS
    check(all(bool((layer[k][:, :live] > 0).all()) for layer in cache
              for k in ("k_scale", "v_scale")), f"{arch} int8: a zero scale")
    check(all(bool(torch.isfinite(x).all()) for x in got),
          f"{arch} int8: logits not finite")
    runs = {"int8_cache": ["kernel", got[-1], cache]}
    ref = {}
    for impl in ("kernel", "eager"):
        c32 = init_cache(cfg, 2, SERVE_MAX_LEN, torch.float32, device)
        l32, c32 = prefill(params, cfg, toks, c32, impl=impl, device=device)
        ref[impl], _, c32 = _greedy_steps(params, cfg, l32, c32, impl,
                                          device, INT8_STEPS, feed=fed)
        runs[f"float32_cache_{impl}"] = [impl, ref[impl][-1], c32]
    del cache, c32
    ms = _step_walls_in_turns(params, cfg, runs, device, INT8_TIMED)
    del runs
    want = ref["kernel"]
    gap = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(got, want))
    same = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
               for a, b in zip(got, want))
    rec = {"phase": "serve", "run": "int8_cache", "arch": arch, "batch": 2,
           "prompt": 512, "max_len": SERVE_MAX_LEN, "steps": INT8_STEPS,
           "cache_bytes": n_bytes, "float32_cache_bytes": f32_bytes,
           "bytes_ratio": n_bytes / f32_bytes,
           "prefill_launches": pre_launches, "prefill_dispatches": pre_disp,
           "decode_launches": launches, "decode_dispatches": disp,
           "decode_route": "eager attention over the dequantized cache: "
                           "the reference skips the decode kernel for an "
                           "int8 cache (src/repro/models/attention.py:285, "
                           ":314)",
           "quantizer_vs_host": "bitwise, every layer's k and v",
           "max_rel_logit_gap_to_float32_cache": gap,
           "greedy_tokens_equal": f"{same} of {2 * (INT8_STEPS + 1)}",
           "ms_per_decode_step": ms,
           "ms_per_decode_step_is": f"the median of {INT8_TIMED} warm "
                                    "steps of each cache, in turns",
           "launches": {"flash_attention": pre_launches["flash_attention"]}}
    emit(rec)
    return rec


def _parting(params, sp, cache, slots, cfg) -> dict | None:
    """Where the unscanned and the scanned paths first part: the first
    layer whose cache differs, the tensor, and the 256-byte alignment of
    each of that layer's weights in both layouts (cuBLAS may pick another
    GEMM kernel at another alignment); None where the caches agree."""
    from repro_torch.models import unstack_cache

    p = sp.period
    for i, (a, b) in enumerate(zip(cache, unstack_cache(slots, cfg))):
        for key in sorted(a):
            if not bool((a[key] == b[key]).all()):
                blk = params.blocks[i]
                return {"layer": i, "tensor": key, "align_256": {
                    name: [w.data_ptr() % 256,
                           sp.slots[i % p][name][i // p].data_ptr() % 256]
                    for name, w in blk.named_parameters()}}
    return None


def _scanned_record(params, cfg, arch: str, kernel: str, device) -> dict:
    """Scan over layers at full width: ``stack_params`` copies the blocks'
    weights once into the stacked layout; ``prefill_scanned`` of the 2 x
    512 prompts under ``impl="kernel"`` launches ``kernel`` once per layer
    and equals ``prefill`` in logits and every cache tensor; then
    SCAN_STEPS greedy ``decode_step_scanned`` steps equal ``decode_step``'s
    logits at every step (decode launches once per attention layer a
    step) and its caches at the end. The contract is bit for bit; where
    the two part, the record names the layer, the tensor and the weights'
    alignments, and the gate is SCAN_REL of the largest |logit|. Both
    paths run in turns (prefill: unscanned, scanned, scanned, unscanned;
    decode: the order alternates each step); their walls are printed. The
    stacked copy is freed at the end."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import (
        decode_step,
        decode_step_scanned,
        init_cache,
        prefill,
        prefill_scanned,
        stack_cache,
        stack_params,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = stack_params(params, cfg)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    stacked_bytes = sum(t.numel() * t.element_size() for slot in sp.slots
                        for t in slot.values())
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 512)), device=device)
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    counted = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}

    def counts_of(fn, args: tuple, scanned: bool, want: dict):
        """``fn(*args)`` under ``impl="kernel"``, its wall and its launches
        and dispatches held to ``want``; a scanned call's are counted."""
        ops.clear_dispatch_stats()                 # counts to 0 just before
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, impl="kernel", device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, disp = ops.launch_counts(), ops.dispatch_stats()
        check({k: v for k, v in launches.items() if v} == want
              and disp == {f"{k}:cuda": v for k, v in want.items()},
              f"{arch} {'scanned' if scanned else 'unscanned'}: launches "
              f"{launches}, dispatches {disp}; expected {want}")
        if scanned:
            for k, v in want.items():
                counted[k] += v
        return out, wall

    walls = {"unscanned": [], "scanned": []}
    first = {}
    for scanned in (False, True, True, False):
        label = "scanned" if scanned else "unscanned"
        cache = init_cache(cfg, 2, SERVE_MAX_LEN, torch.float32, device)
        out, wall = counts_of(
            prefill_scanned if scanned else prefill,
            (sp, cfg, toks, stack_cache(cache, cfg)) if scanned
            else (params, cfg, toks, cache),
            scanned, {kernel: cfg.n_layers})
        walls[label].append(wall)
        first.setdefault(label, out)
        del out
    (u_logits, cache), (s_logits, slots) = first["unscanned"], \
        first["scanned"]
    scale = float(u_logits.abs().max())
    errs, parting = [], None

    def compare(u, s, what):
        nonlocal parting
        err = float((u - s).abs().max())
        if not torch.equal(u, s):
            parting = parting or _parting(params, sp, cache, slots, cfg)
            check(parting is not None and err <= SCAN_REL * scale,
                  f"{arch} {what}: scanned and unscanned logits part by "
                  f"{err} (largest {scale}); where: {parting}")
        errs.append(err / scale)

    compare(u_logits, s_logits, "prefill")
    check(_parting(params, sp, cache, slots, cfg) is None or parting,
          f"{arch} prefill: the caches part where the logits do not")
    per_step = {"decode_attention": n_attn} if n_attn else {}
    steps = SCAN_STEPS[kernel]
    ms = {"unscanned": 0.0, "scanned": 0.0}
    for step in range(steps):
        tok = torch.argmax(u_logits, -1)
        order = (False, True) if step % 2 == 0 else (True, False)
        for scanned in order:
            if scanned:
                (s_logits, slots), wall = counts_of(
                    decode_step_scanned, (sp, cfg, tok, slots), True,
                    per_step)
            else:
                (u_logits, cache), wall = counts_of(
                    decode_step, (params, cfg, tok, cache), False, per_step)
            ms["scanned" if scanned else "unscanned"] += 1e3 * wall / steps
        compare(u_logits, s_logits, f"decode step {step}")
    end = _parting(params, sp, cache, slots, cfg)
    check(end is None or parting is not None,
          f"{arch} decode: the caches part where the logits do not: {end}")
    rec = {"phase": "serve", "run": "scanned", "arch": arch,
           "kernel": kernel, "period": sp.period, "n_steps": sp.n_steps,
           "stacked_bytes": stacked_bytes, "stack_s": stack_s, "batch": 2,
           "prompt": 512, "decode_steps": steps,
           "bitwise": parting is None, "parting": parting,
           "max_rel_logit_err": max(errs),
           "prefill_wall_s": walls, "ms_per_decode_step": ms,
           "launches": counted}
    emit(rec)
    del sp, slots, cache
    torch.cuda.empty_cache()
    return rec


def _serve_arch(arch: str, n_layers: int, kernel: str, device) -> dict:
    """One model at full width with seeded float32 weights: the engine
    under the three schedulers, one profiled orca run, the teacher-forced
    replay of vllm's streams and the 2 x 512 ``prefill`` through
    ``kernel``; the weights are freed at the end."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import init_model

    cfg = get(arch).model
    check(cfg.n_layers == n_layers, f"{arch} has {cfg.n_layers} layers")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "serve", "run": "init", "arch": arch,
          "params": n_params, "bytes": 4 * n_params,
          "seconds": time.perf_counter() - t0})
    runs, by_sched = {}, {}
    for name in ("vllm", "orca", "chunked_prefill"):
        runs[name], by_sched[name] = _engine_run(params, cfg, arch, name,
                                                 device)
    streams, orca = by_sched["vllm"], by_sched["orca"]
    if kernel == "flash_attention":
        # float32 weights over a bfloat16 cache: decode takes a float32 q
        runs["orca_bf16_cache"], got = _engine_run(
            params, cfg, arch, "orca", device, cache_dtype=torch.bfloat16)
        same = sum(got[rid][1] == orca[rid][1] for rid in got)
        emit({"phase": "serve", "run": "bf16_cache_vs_f32_cache",
              "arch": arch, "requests": len(got),
              "same_tokens_as_float32_cache": same})
    service = _service_checks(params, cfg, arch, by_sched, device,
                              full=kernel == "flash_attention")
    fleet = (_fleet_measured(params, cfg, arch, device)
             if kernel == "flash_attention" else None)
    profile = _engine_profile(params, cfg, arch, device)
    pre, _ = _prefill_check(params, cfg, arch, kernel, device)
    replay = _replay(params, cfg, arch, streams, device, pre["tol"])
    int8 = (_int8_cache_record(params, cfg, arch, device)
            if kernel == "flash_attention" else None)
    scanned = _scanned_record(params, cfg, arch, kernel, device)
    del params
    torch.cuda.empty_cache()
    return {"engine": runs, "service": service, "profile": profile,
            "replay": replay, "prefill": pre, "fleet": fleet,
            "int8_cache": int8, "scanned": scanned}


def _service_run(params, cfg, arch: str, sched_name: str, device,
                 clock=None) -> tuple:
    """One ``AsyncLLMService`` serve of the phase's requests (float32 paged
    pools of SERVE_BLOCK-token blocks, full residency) under ``clock``
    (``IterationClock`` by default). Every request must finish with
    SERVE_NEW tokens, and the only dispatches are the decode kernel's, one
    per attention layer and decode iteration. Returns (result, service,
    record)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import AsyncLLMService, ServiceConfig

    svc = AsyncLLMService(params, cfg, ServiceConfig(
        max_batch=SERVE_REQUESTS, max_len=SERVE_MAX_LEN,
        block_len=SERVE_BLOCK), clock=clock, device=device)
    reqs = _serve_requests(cfg.vocab)
    torch.cuda.synchronize()
    ops.clear_dispatch_stats()                     # counts to 0 just before
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = svc.serve_sync(reqs, _sched(sched_name), stream_name="serve")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, disp = ops.launch_counts(), ops.dispatch_stats()  # just after
    check(not res.truncated and len(res.finished) == SERVE_REQUESTS
          and all(len(r.generated) == SERVE_NEW for r in res.finished),
          f"service {arch} {sched_name}: {len(res.finished)} of "
          f"{SERVE_REQUESTS} requests finished with {SERVE_NEW} tokens")
    n_dec = sum(1 for st in res.stats if st.n_decode)
    want = _decode_dispatches(cfg, n_dec)
    check(disp == want and all(n == want.get(f"{k}:cuda", 0)
                               for k, n in launches.items()),
          f"service {arch} {sched_name}: launches {launches}, dispatches "
          f"{disp}, expected {want} ({n_dec} decode iterations)")
    out_tokens = sum(len(r.generated) for r in res.finished)
    rec = {"phase": "serve", "run": "service", "arch": arch,
           "scheduler": sched_name,
           "clock": "wall" if clock is not None else "iteration",
           "wall_s": wall, "tokens_per_s": out_tokens / wall,
           "output_tokens": out_tokens, "iterations": len(res.stats),
           "decode_iterations": n_dec, "launches": launches,
           "dispatches": disp, "kv_resident_bytes": svc.kv.resident_bytes(),
           "prefill_entrypoints": res.counters["prefill_entrypoints"],
           "decode_entrypoints": res.counters["decode_entrypoints"]}
    return res, svc, rec


def _plan_parity(res, sched_name: str, vocab: int) -> None:
    """The measured schedule equals the planner's bit for bit: the
    admission log against ``plan_rollout``, and the batches, indices,
    token counts and priced ``RequestTimings`` against ``rollout`` of the
    same requests as a stream."""
    import numpy as np

    from repro_torch.core.streams import RequestStream, StreamRequest, rollout
    from repro_torch.serving import ServeRequest
    from repro_torch.serving.scheduler import plan_rollout

    reqs = _serve_requests(vocab)
    planned = []
    for it, plan in plan_rollout(
            [ServeRequest(r.rid, list(r.prompt), r.max_new_tokens,
                          arrived_iter=r.arrived_iter) for r in reqs],
            _sched(sched_name), SERVE_REQUESTS, 10_000):
        planned += [(q.rid, q.slot, it) for q, _ in plan.prefill
                    if q.prefilled == 0]
    check(res.admissions == planned,
          f"service {sched_name}: admissions {res.admissions} != {planned}")
    stream = RequestStream.from_requests(
        [StreamRequest(len(r.prompt), r.max_new_tokens, r.arrived_iter)
         for r in reqs], name="serve")
    ro = rollout(stream, _sched(sched_name), max_slots=SERVE_REQUESTS,
                 max_iters=10_000)
    got = res.rollout
    check(got.batches == ro.batches
          and all(np.array_equal(getattr(got, k), getattr(ro, k))
                  for k in ("arrival_b", "first_b", "done_b",
                            "n_new_tokens")),
          f"service {sched_name}: measured rollout differs from the plan")
    lat = np.linspace(0.01, 0.02, len(ro.batches))
    planned_t, measured_t = ro.timings(lat), res.timings(lat)
    check(all(np.array_equal(getattr(planned_t, k), getattr(measured_t, k))
              for k in ("ttft_s", "tpot_s", "finished"))
          and planned_t.makespan_s == measured_t.makespan_s,
          f"service {sched_name}: RequestTimings differ from the plan")


def _near_tie(params, cfg, prompt, prefix, pair, device) -> float:
    """Teacher forcing through ``prefill`` and ``decode_step`` (the kernel
    path at batch 1) up to the step after ``prefix``: that step's top-two
    logit gap over the largest |logit|, checked to be a near tie (under
    LOGIT_REL) between exactly the two tokens of ``pair``."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    cache = init_cache(cfg, 1, SERVE_MAX_LEN, torch.float32, device)
    logits, cache = prefill(params, cfg, torch.as_tensor([prompt],
                                                          device=device),
                            cache, device=device)
    for tok in prefix:
        logits, cache = decode_step(params, cfg,
                                    torch.as_tensor([tok], device=device),
                                    cache, device=device)
    top = torch.topk(logits[0], 2)
    gap = float((top.values[0] - top.values[1]) / logits[0].abs().max())
    check(gap <= LOGIT_REL and set(top.indices.tolist()) == set(pair),
          f"service vs engine tokens {pair} differ at a top-two gap of "
          f"{gap} of the largest logit (top two {top.indices.tolist()})")
    return gap


def _width_tie(params, cfg, prompt, prefix, pair, device) -> dict:
    """For a model whose decode launches no kernel (Mamba-2): the prompt
    through ``extend`` at batch 1, as the engine and the service both run
    it, then ``prefix`` teacher-forced through ``decode_step`` at once at
    batch 1 and at SERVE_REQUESTS (the engine's width; the row copied):
    ``spread``, the largest gap of row 0's logits between the two widths
    over the largest |logit| -- what the batch width alone changes, the
    service decoding at its bucket and the engine at ``max_batch``.
    At the step after ``prefix`` the top two tokens at the engine's width
    must be exactly ``pair`` and their gap within SPREAD_FACTOR x
    ``spread`` (which must not be 0)."""
    import torch

    from repro_torch.models import decode_step, extend, init_cache

    n, w = len(prompt), SERVE_REQUESTS
    toks = torch.zeros((1, 1 << max(0, n - 1).bit_length()),
                       dtype=torch.int64, device=device)
    toks[0, :n] = torch.as_tensor(prompt, device=device)
    cache = init_cache(cfg, 1, SERVE_MAX_LEN, torch.float32, device)
    logits, cache = extend(params, cfg, toks, cache, length=n, device=device)
    caches = {1: cache, w: [{k: v.expand(w, *v.shape[1:]).clone()
                             for k, v in layer.items()} for layer in cache]}
    out = {1: logits, w: logits.expand(w, -1)}
    spread = 0.0
    for tok in prefix:
        for b in (1, w):
            out[b], caches[b] = decode_step(
                params, cfg, torch.full((b,), tok, device=device), caches[b],
                device=device)
        spread = max(spread, float((out[1][0] - out[w][0]).abs().max()
                                   / out[w][0].abs().max()))
    top = {b: torch.topk(out[b][0], 2) for b in (1, w)}
    gap = {b: float((t.values[0] - t.values[1]) / out[b][0].abs().max())
           for b, t in top.items()}
    rec = {"spread": spread, "rel_top2_gap": gap[w],
           "rel_top2_gap_batch1": gap[1],
           "top2": top[w].indices.tolist(),
           "top2_batch1": top[1].indices.tolist()}
    check(spread > 0 and gap[w] <= SPREAD_FACTOR * spread
          and set(rec["top2"]) == set(pair),
          f"service vs engine tokens {pair} differ where the batch width "
          f"does not explain it: {rec}")
    return rec


def _gather_scatter_ms(svc, cfg, device, calls: int = 10) -> dict:
    """Device time per decode step of the service's paged gather (every
    block of SERVE_REQUESTS lanes' tables into the dense cache) and its
    write-back, from ``torch.profiler``, on the service's own pools at
    its decode bucket of SERVE_REQUESTS lanes."""
    import torch

    from repro_torch.models.paged import _scatter_decode, gather_paged_cache

    kv = svc.kv
    b, t = SERVE_REQUESTS, kv.blocks_per_seq
    tables = torch.arange(1, 1 + b * t, dtype=torch.int32,
                          device=device).reshape(b, t)
    lens = torch.as_tensor([len(r.prompt) for r in _serve_requests(cfg.vocab)],
                           dtype=torch.int32, device=device)
    slots = torch.arange(b, dtype=torch.int32, device=device)
    cache = gather_paged_cache(kv.pools, tables, lens, slots)

    def gather():
        for _ in range(calls):
            gather_paged_cache(kv.pools, tables, lens, slots)

    def scatter():
        for _ in range(calls):
            _scatter_decode(kv.pools, cache, tables, lens, slots,
                            kv.block_len)

    g, _ = _profiled(gather)
    w, _ = _profiled(scatter)
    moved = sum(v.numel() * v.element_size() for layer in cache
                for k, v in layer.items() if k != "len")
    return {"gather_device_ms_per_step": g["device_busy_ms"] / calls,
            "scatter_device_ms_per_step": w["device_busy_ms"] / calls,
            "gather_bytes_per_step": 2 * moved,
            "gather_bound_ms": 1e3 * 2 * moved / HBM_BYTES_PER_S}


def _service_checks(params, cfg, arch: str, engine: dict, device,
                    full: bool) -> dict:
    """The paged service on the phase's weights: under ``IterationClock``
    (vllm, orca and chunked_prefill when ``full``, else orca) the measured
    schedule equals the plan bit for bit and the greedy tokens equal the
    engine's run of the same scheduler. The service decodes at its bucket,
    the engine at ``max_batch``, so a stream may part from the engine's
    only where that explains it: with ``full`` (attention), at a
    teacher-forced near tie under LOGIT_REL (the decode kernel's split
    plan follows the batch); otherwise (Mamba-2, no kernel: the float32
    products' rounding follows the batch and 64 random layers amplify it)
    at a gap within SPREAD_FACTOR x the logit spread that the batch width
    alone opens (``_width_tie``). With ``full``, one orca run under
    ``WallClock`` (wall, tokens / s, TTFT percentiles) and the device time
    of the paged gather and write-back per decode step."""
    import numpy as np

    from repro_torch.serving import WallClock

    t_start = time.perf_counter()
    out = {}
    for name in (("vllm", "orca", "chunked_prefill") if full else ("orca",)):
        res, svc, rec = _service_run(params, cfg, arch, name, device)
        del svc
        _plan_parity(res, name, cfg.vocab)
        got = {r.rid: r.generated for r in res.finished}
        equal, ties = 0, []
        for rid, (prompt, want) in sorted(engine[name].items()):
            if got[rid] == want:
                equal += 1
                continue
            j = next(i for i, (a, b) in enumerate(zip(got[rid], want))
                     if a != b)
            pair = (want[j], got[rid][j])
            tie = ({"rel_top2_gap": _near_tie(params, cfg, prompt, want[:j],
                                              pair, device)} if full
                   else _width_tie(params, cfg, prompt, want[:j], pair,
                                   device))
            ties.append({"rid": rid, "step": j, **tie})
        rec.update(plan_parity=True, equal_streams=equal, near_ties=ties)
        emit(rec)
        out[name] = rec
    if full:
        res, svc, rec = _service_run(params, cfg, arch, "orca", device,
                                     clock=WallClock(SERVE_PERIOD_S))
        ttft = res.wall_timings().ttft_s
        rec.update(period_s=SERVE_PERIOD_S,
                   ttft_p50_s=float(np.percentile(ttft, 50)),
                   ttft_p99_s=float(np.percentile(ttft, 99)),
                   **_gather_scatter_ms(svc, cfg, device))
        del svc
        emit(rec)
        out["wall"] = rec
    # repro-lint: disable=RT006 -- every serve read its tokens back before the stop
    out["seconds"] = time.perf_counter() - t_start
    emit({"phase": "serve", "run": "service_seconds", "arch": arch,
          "seconds": out["seconds"]})
    return out


def _fleet_stream():
    """SERVE_REQUESTS requests of 64-512 prompt tokens (numpy seed 5) with
    SERVE_NEW new tokens each, two arriving per iteration; the fourth and
    the seventh arrive decode-resident with a context of their prompt's
    length."""
    import numpy as np

    from repro_torch.core.streams import RequestStream, StreamRequest

    lens = np.random.default_rng(5).integers(64, 513, size=SERVE_REQUESTS)
    return RequestStream.from_requests(
        [StreamRequest(int(n), SERVE_NEW, i // 2,
                       warm_context=int(n) if i in (3, 6) else 0)
         for i, n in enumerate(lens)], name="fleet-measured")


def _same_schedule(got, want) -> bool:
    import numpy as np

    return got.batches == want.batches and all(
        np.array_equal(getattr(got, k), getattr(want, k))
        for k in ("warm", "first_b", "done_b"))


def _fleet_measured(params, cfg, arch: str, device) -> dict:
    """The fleet control plane over the paged service: ``MeasuredReplica``s
    whose factory builds a fresh ``AsyncLLMService`` per serve (the serve
    phase's pools, orca, ``IterationClock``) on the loaded weights. A
    1-replica fleet's rollout equals a direct ``serve_sync`` of the unsplit
    stream, and priced with one common latency vector its merged timings
    equal the direct serve's, bit for bit; a 2-replica round-robin fleet
    serves every request exactly once, each replica's rollout that of a
    direct serve of its own sub-stream. Each fleet serve launches the
    decode kernel once per attention layer and decode iteration, with no
    plain dispatch; each factory's pools are freed before the next serve
    builds its own."""
    import numpy as np
    import torch

    from repro_torch.core.streams import merge_timings
    from repro_torch.core.workload import DECODE
    from repro_torch.fleet import Fleet, MeasuredReplica
    from repro_torch.kernels import ops
    from repro_torch.serving import AsyncLLMService, ServiceConfig
    from repro_torch.serving.scheduler import get_scheduler
    from repro_torch.serving.service import service_requests

    def make_service():
        return AsyncLLMService(params, cfg, ServiceConfig(
            max_batch=SERVE_REQUESTS, max_len=SERVE_MAX_LEN,
            block_len=SERVE_BLOCK), device=device)

    def direct(stream):
        return make_service().serve_sync(
            service_requests(stream, cfg.vocab), get_scheduler("orca"),
            stream_name=stream.name).rollout

    def serve(n_replicas):
        fleet = Fleet([MeasuredReplica(service=make_service, vocab=cfg.vocab,
                                       scheduler="orca", mc_total=1.0,
                                       name=f"m{i}")
                       for i in range(n_replicas)], policy="round_robin")
        torch.cuda.synchronize()
        ops.clear_dispatch_stats()                 # counts to 0 just before
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fr = fleet.serve(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, disp = ops.launch_counts(), ops.dispatch_stats()
        n_dec = sum(any(r.kind == DECODE for r in b)
                    for res in fr.replica_results for b in res.rollout.batches)
        want = _decode_dispatches(cfg, n_dec)
        check(disp == want and all(n == want.get(f"{k}:cuda", 0)
                                   for k, n in launches.items()),
              f"fleet of {n_replicas}: launches {launches}, dispatches "
              f"{disp}, expected {want} ({n_dec} decode iterations)")
        check(all(r.meta["unfinished"] == 0 for r in fr.replica_results)
              and fr.timings.finished.all(),
              f"fleet of {n_replicas}: a request did not finish")
        return fr, {"n_replicas": n_replicas, "wall_s": wall,
                    "loads": fr.route.loads().tolist(),
                    "decode_iterations": n_dec, "launches": launches,
                    "dispatches": disp,
                    "iterations": [r.meta["iterations"]
                                   for r in fr.replica_results],
                    "device_bytes_after": torch.cuda.memory_allocated(device)}

    stream = _fleet_stream()
    t_start = time.perf_counter()
    mem0 = torch.cuda.memory_allocated(device)
    one, rec_one = serve(1)
    ro = one.replica_results[0].rollout
    d_ro = direct(stream)
    check(_same_schedule(ro, d_ro), "1-replica fleet: its rollout differs "
          "from a direct serve of the unsplit stream")
    lat = np.linspace(0.01, 0.02, len(ro.batches))
    merged = merge_timings([ro.timings(lat)], one.route.indices,
                           stream.n_requests)
    dt = d_ro.timings(lat)
    check(all(np.array_equal(getattr(merged, k), getattr(dt, k))
              for k in ("ttft_s", "tpot_s", "finished", "warm"))
          and merged.makespan_s == dt.makespan_s,
          "1-replica fleet: merged timings differ from the direct serve's")
    two, rec_two = serve(2)
    served = np.sort(np.concatenate(two.route.indices))
    check(np.array_equal(served, np.arange(stream.n_requests)),
          f"2-replica fleet served {served.tolist()}")
    for res, sub in zip(two.replica_results, two.route.substreams):
        check(_same_schedule(res.rollout, direct(sub)),
              f"2-replica fleet: replica {res.replica}'s rollout differs "
              f"from a direct serve of its sub-stream")
    rec = {"phase": "serve", "run": "fleet_measured", "arch": arch,
           "requests": stream.n_requests,
           "warm_requests": int(d_ro.warm.sum()),
           "one_replica": {**rec_one, "rollout_equal_direct": True,
                           "merged_timings_equal_direct": True,
                           "batches": len(ro.batches)},
           "two_replicas": {**rec_two, "each_request_once": True,
                            "rollouts_equal_direct": True},
           "device_bytes_before": mem0,
           "device_bytes_end": torch.cuda.memory_allocated(device),
           "seconds": time.perf_counter() - t_start}
    emit(rec)
    return rec


def _bf16_layer_check(params, cfg, toks, device) -> dict:
    """Along the eager bfloat16 prefill's own trajectory, every layer's
    q/k/v through the bfloat16 flash kernel and through its plain version:
    within ATTN_TOLS["bfloat16"] of the largest plain value (these
    launches are not the path's count)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, transformer

    b, l = toks.shape
    tol = ATTN_TOLS["bfloat16"]
    worst = 0.0
    with torch.no_grad():
        rope = transformer._rope(cfg, max(cfg.max_seq, l), device)
        positions = torch.arange(l, device=device).expand(b, l)
        x = params.embed.e[toks]
        for blk in params.blocks:
            h = transformer._norm(cfg, blk.norm1, x)
            q, k, v, _ = attention._project_qkv(blk.attn, h, cfg, positions,
                                                rope)
            got = fa.flash_attention_cuda(q, k, v, True)
            want = fa.flash_attention_plain(q, k, v, True)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            check(torch.isfinite(got).all().item() and err <= tol * scale,
                  f"flash_attention_bf16 on the bf16 prefill path: a "
                  f"layer's output differs from its plain version by {err} "
                  f"(largest {scale})")
            worst = max(worst, err / scale)
            x = transformer._ffn_residual(
                blk, cfg, x + attention.attention_train(
                    blk.attn, h, cfg, positions, rope, impl="eager"))
    torch.cuda.synchronize()
    return {"max_rel_layer_err": worst, "tol_of_largest": tol}


def _bf16_norms_check(params, cfg, toks, logits, device) -> dict:
    """The bfloat16 model's block and final norms are float32, as the
    reference builds them, and at init (gain 1) its ``prefill`` logits
    equal bit for bit those of a copy with the norms cast to bfloat16 (the
    build before the norms were kept in float32)."""
    import copy

    import torch

    from repro_torch.models import init_cache, prefill

    norms = ("norm1", "norm2", "norm_x", "final_norm", "enc_norm")
    types = {str(p.dtype) for name, p in params.named_parameters()
             if name.rpartition(".")[0].rpartition(".")[2] in norms}
    cast = copy.deepcopy(params)
    for name, mod in cast.named_modules():
        if name.rpartition(".")[2] in norms:
            mod.to(torch.bfloat16)
    cache = init_cache(cfg, toks.shape[0], toks.shape[1], torch.bfloat16,
                       device)
    got, _ = prefill(cast, cfg, toks, cache, impl="kernel", device=device)
    del cast, cache
    torch.cuda.empty_cache()
    equal = torch.equal(got, logits)
    check(types == {"torch.float32"} and equal,
          f"bf16 model: norm types {types}; prefill logits with bfloat16 "
          f"norms equal to the float32 norms' bit for bit: {equal}")
    return {"norm_dtypes": sorted(types),
            "logits_equal_with_bfloat16_norms": equal}


def _serve_bf16(device) -> dict:
    """llama3.2-3b at full width and depth in bfloat16 weights and cache:
    ``prefill`` of 2 x BF16_PROMPT tokens through the bfloat16 flash kernel
    (one launch per layer) and eagerly, the kernel held to its plain
    version layer by layer on the prefill's own q/k/v, the end-to-end
    kernel-vs-eager gap printed; the prefill under ``torch.profiler``; one
    orca engine run and one profiled orca run."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, init_model, prefill

    arch = SERVE_ARCH
    cfg = get(arch).model
    check(cfg.n_layers == SERVE_LAYERS, f"{arch} has {cfg.n_layers} layers")
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, dtype=bf16, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "serve", "run": "init", "arch": arch, "weights": "bfloat16",
          "params": n_params, "bytes": 2 * n_params,
          "seconds": time.perf_counter() - t0})
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, BF16_PROMPT)), device=device)

    def run(impl):
        cache = init_cache(cfg, 2, BF16_PROMPT, bf16, device)
        return prefill(params, cfg, toks, cache, impl=impl, device=device)

    runs = {}
    for impl in ("kernel", "eager"):
        run(impl)                                  # warm
        torch.cuda.synchronize()
        if impl == "kernel":
            ops.clear_dispatch_stats()             # counts to 0 just before
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = run(impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if impl == "kernel":
            launches, disp = ops.launch_counts(), ops.dispatch_stats()
        runs[impl] = (logits, wall)
    want = cfg.n_layers
    check(launches["flash_attention_bf16"] == want
          and sum(launches.values()) == want
          and disp == {"flash_attention:cuda": want},
          f"bf16 prefill: launches {launches}, dispatches {disp}; expected "
          f"{want} flash_attention_bf16 launches")
    k_logits, e_logits = runs["kernel"][0].float(), runs["eager"][0].float()
    check(torch.isfinite(k_logits).all().item()
          and tuple(k_logits.shape) == (2, cfg.vocab),
          f"bf16 prefill logits: shape {tuple(k_logits.shape)}")
    norms = _bf16_norms_check(params, cfg, toks, runs["kernel"][0], device)
    layers = _bf16_layer_check(params, cfg, toks, device)
    prof, _ = _profiled(lambda: run("kernel"))
    pre = {"phase": "serve", "run": "prefill", "arch": arch,
           "weights": "bfloat16", "cache": "bfloat16",
           "kernel": "flash_attention_bf16", "batch": 2,
           "prompt": BF16_PROMPT,
           "wall_s": {impl: runs[impl][1] for impl in runs},
           "tokens_per_s": {impl: 2 * BF16_PROMPT / runs[impl][1]
                            for impl in runs},
           "launches": launches, "dispatches": disp,
           "kernel_vs_eager_max_rel_logit_err": float(
               (k_logits - e_logits).abs().max() / e_logits.abs().max()),
           "argmax_equal": int((k_logits.argmax(-1)
                                == e_logits.argmax(-1)).sum()),
           "per_layer": layers, "norms": norms, "profile": prof}
    emit(pre)
    engine, _ = _engine_run(params, cfg, arch, "orca", device)
    profile = _engine_profile(params, cfg, arch, device)
    del params
    torch.cuda.empty_cache()
    return {"prefill": pre, "engine": engine, "profile": profile}


def _serve_phi(device) -> dict:
    """phi-3-vision-4.2b at full width and depth with seeded random
    float32 weights, its vision frontend a stub: ``prefill`` of 2 x 512
    seeded patch embeddings (``inputs_embeds``) through the flash kernel at
    D 96, Hq = Hkv = 32, against the eager path; PHI_STEPS teacher-forced
    decode steps through the decode kernel from that cache, against the
    eager path; one orca engine run of the phase's token requests through
    the kernels and one eagerly, their tokens equal or parted only at a
    refereed near tie (``_near_tie``). The cold cost of the RoPE tables (a
    first call builds them for max_seq 131,072; later calls find them
    cached) is timed apart. The weights are freed at the end."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import init_model, param_count
    from repro_torch.models.layers import rope_freqs

    arch = get(PHI_ARCH)
    cfg = arch.model
    check(cfg.n_layers == PHI_LAYERS and cfg.head_dim == 96
          and cfg.n_heads == cfg.n_kv_heads == 32
          and arch.modality_stub == "vision",
          f"{PHI_ARCH}: {cfg}")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = param_count(params)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rope_freqs.__wrapped__(cfg.head_dim, cfg.max_seq, cfg.rope_theta, device)
    torch.cuda.synchronize()
    emit({"phase": "serve", "run": "init", "arch": PHI_ARCH,
          "params": n_params, "bytes": 4 * n_params, "seconds": init_s,
          "rope_tables_cold_s": time.perf_counter() - t0})
    gen = torch.Generator(device=device).manual_seed(3)
    embeds = 0.02 * torch.randn((2, 512, cfg.d_model), generator=gen,
                                device=device)
    pre, state = _prefill_check(params, cfg, PHI_ARCH, "flash_attention",
                                device, embeds=embeds, first_call=True)
    run = _forced_steps(
        params, cfg, state,
        lambda j, ref: ref.argmax(-1) if j < PHI_STEPS else None,
        device, LOGIT_REL, f"{PHI_ARCH} decode")
    del state
    check(run["steps"] == PHI_STEPS, f"{PHI_ARCH}: {run['steps']} steps")
    dec = {"phase": "serve", "run": "decode", "arch": PHI_ARCH, "batch": 2,
           "tol": LOGIT_REL,
           "ms_per_step": {k: 1e3 * v / PHI_STEPS
                           for k, v in run["wall_s"].items()},
           **{k: run[k] for k in ("steps", "launches", "dispatches",
                                  "launches_per_step", "max_rel_logit_err")}}
    emit(dec)
    engine, by_kernel = _engine_run(params, cfg, PHI_ARCH, "orca", device)
    eager, by_eager = _engine_run(params, cfg, PHI_ARCH, "orca", device,
                                  impl="eager")
    equal, ties = 0, []
    for rid, (prompt, want) in sorted(by_eager.items()):
        got = by_kernel[rid][1]
        if got == want:
            equal += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        ties.append({"rid": rid, "step": j, "rel_top2_gap": _near_tie(
            params, cfg, prompt, want[:j], (want[j], got[j]), device)})
    cmp = {"phase": "serve", "run": "engine_kernel_vs_eager", "arch": PHI_ARCH,
           "scheduler": "orca", "requests": len(by_eager),
           "equal_streams": equal, "near_ties": ties}
    emit(cmp)
    del params
    torch.cuda.empty_cache()
    return {"params": n_params, "prefill": pre, "decode": dec,
            "engine": engine, "engine_eager": eager, "tokens": cmp}


def _lane_state(params, cfg, streams: dict, impl: str, device):
    """The engine's lanes after prefill: one lane per request (in rid
    order) of a SERVE_REQUESTS-lane float32 cache, each prompt through
    ``extend`` in one chunk right-padded to its power-of-two bucket, as
    the engine's orca run prefills it; returns (last logits [B, vocab],
    cache)."""
    import torch

    from repro_torch.models import extend, init_cache

    cache = init_cache(cfg, SERVE_REQUESTS, SERVE_MAX_LEN, torch.float32,
                       device)
    logits = []
    for lane, rid in enumerate(sorted(streams)):
        prompt = streams[rid][0]
        toks = torch.zeros((1, 1 << max(0, len(prompt) - 1).bit_length()),
                           dtype=torch.long, device=device)
        toks[0, :len(prompt)] = torch.as_tensor(prompt, device=device)
        row = [{k: t[lane:lane + 1] for k, t in layer.items()}
               for layer in cache]
        out, row = extend(params, cfg, toks, row, impl=impl,
                          length=len(prompt), device=device)
        for layer, r in zip(cache, row):
            layer["len"][lane:lane + 1] = r["len"]
        logits.append(out)
    return torch.cat(logits), cache


@contextlib.contextmanager
def _recorded_routes():
    """Every MoE routing the port makes while the block runs, in order:
    (router softmax, top-k gates, expert gates, expert tokens) per call of
    ``repro_torch.models.moe.route``."""
    from repro_torch.models import moe

    log, route = [], moe.route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        log.append(out)
        return out

    moe.route = recorded
    try:
        yield log
    finally:
        moe.route = route


def _route_flips(kernel: list, eager: list, top_k: int) -> list:
    """Where the two paths' routings of one step differ: each token whose
    top-k experts differ (its margin: the k-th minus the (k+1)-th router
    gate, the smaller of the two paths'), and each expert whose chosen
    tokens with a nonzero gate differ (its margin: its C-th minus its
    (C+1)-th gate); with the tokens (lanes) each flip touches."""
    flips = []
    for layer, (a, b) in enumerate(zip(kernel, eager)):
        (ga, ma, _, ia), (gb, mb, _, ib) = (
            [t.cpu() for t in route] for route in (a, b))
        for t in ((ma > 0) != (mb > 0)).any(-1).nonzero().flatten().tolist():
            tops = [g[t].sort(descending=True).values for g in (ga, gb)]
            gaps = [float(v[top_k - 1] - v[top_k]) for v in tops]
            flips.append({"layer": layer, "kind": "token_choice",
                          "token": t, "experts": ((ma[t] > 0)
                                                  != (mb[t] > 0)).nonzero()
                          .flatten().tolist(), "margin": min(gaps),
                          "lanes": [t]})
        cap = ia.shape[1]
        for e in range(ia.shape[0]):
            got = {int(i) for i, g in zip(ia[e], ma.T[e][ia[e]]) if g > 0}
            want = {int(i) for i, g in zip(ib[e], mb.T[e][ib[e]]) if g > 0}
            if got == want:
                continue
            gaps = []
            for m in (ma, mb):
                col = m.T[e].sort(descending=True).values
                gaps.append(float(col[cap - 1] - col[cap])
                            if cap < col.numel() else float("inf"))
            flips.append({"layer": layer, "kind": "expert_choice",
                          "expert": e, "margin": min(gaps),
                          "lanes": sorted(got ^ want)})
    return flips


def _mla_layer_check(params, cfg, cache, tok, device) -> dict:
    """One eager ``decode_step`` from a copy of ``cache``, capturing each
    MLA layer's q_eff [B, 128, 576] and latent cache (one tensor as k and
    v) at its attention; on each, the decode kernel against its plain
    version, in one range and under the kernel's own plan, within
    ATTN_TOLS float32 (these launches are not the path's count)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import attention, decode_step

    caught, xla = [], attention._xla_decode

    def capture(q, k, v, lengths):
        caught.append((q.clone(), k.clone(), lengths.clone(), k is v))
        return xla(q, k, v, lengths)

    attention._xla_decode = capture
    try:
        decode_step(params, cfg, tok, [{k: t.clone() for k, t in c.items()}
                                       for c in cache], impl="eager",
                    device=device)
    finally:
        attention._xla_decode = xla
    tol, layers = ATTN_TOLS["float32"], []
    check(len(caught) == cfg.n_layers, f"{len(caught)} MLA layers caught")
    for i, (q, kv, lengths, same) in enumerate(caught):
        check(same and tuple(q.shape) == (SERVE_REQUESTS, cfg.n_heads,
                                          cfg.mla_kv_rank + cfg.mla_rope_dim),
              f"layer {i}: q {tuple(q.shape)}, k is v: {same}")
        plan = da.kernel_plan(q, kv, kv)
        got = da.decode_attention_cuda(q, kv, kv, lengths)
        one = da.decode_attention_plain(q, kv, kv, lengths)
        split = da.decode_attention_plain(q, kv, kv, lengths,
                                          n_split=plan.n_split)
        torch.cuda.synchronize()
        errs = [float((got - w).abs().max()) for w in (one, split)]
        check(max(errs) <= tol, f"{DEEPSEEK_ARCH} layer {i}: decode kernel "
              f"vs plain {errs} > {tol}")
        layers.append({"layer": i, "max_abs_err": errs[0],
                       "max_abs_err_split_plan": errs[1],
                       "largest": float(one.abs().max()),
                       "lengths": lengths.tolist(), "plan": plan._asdict()})
    rec = {"phase": "serve", "run": "layer_gate", "arch": DEEPSEEK_ARCH,
           "kernel": "decode_attention", "tol": tol, "layers": layers}
    emit(rec)
    return rec


def _serve_deepseek(device) -> dict:
    """deepseek-v2-236b at full width (MLA: 128 heads, kv_rank 512,
    rope_dim 64; MoE: 160 routed experts of 1536, 2 shared, top 6) with
    its depth cut to DEEPSEEK_LAYERS, seeded random float32 weights: each
    layer's decode kernel held to its plain version on the layer's own
    q_eff and latent (``_mla_layer_check``); one orca engine run (prompts
    through ``extend``, each decode iteration one decode launch per layer,
    no plain dispatch) and one more under ``torch.profiler``; its streams teacher-forced at the engine's lanes
    through ``impl="kernel"`` and ``"eager"`` within LOGIT_REL, a lane
    parting only where an MoE choice flipped between the paths at a gate
    margin under ROUTE_MARGIN (or through a lane that had); one orca
    ``AsyncLLMService`` run under ``IterationClock``, its schedule equal
    to the plan bit for bit. Its tokens are not compared with the
    engine's: MoE routing follows the batch, and the service decodes at
    buckets of 1-8 lanes. MLA's ``prefill`` (flash cannot take its
    shapes) runs nowhere here. The weights are freed at the end."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.models import init_model, param_count

    full = get(DEEPSEEK_ARCH).model
    check(full.n_layers == DEEPSEEK_FULL_LAYERS and full.attn_kind == "mla"
          and full.n_heads == 128
          and full.mla_kv_rank + full.mla_rope_dim == 576
          and full.moe.n_routed == 160 and full.moe_every == 1,
          f"{DEEPSEEK_ARCH}: {full}")
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = param_count(params)
    emit({"phase": "serve", "run": "init", "arch": DEEPSEEK_ARCH,
          "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
          "params": n_params, "bytes": 4 * n_params,
          "seconds": time.perf_counter() - t0})
    engine, streams = _engine_run(params, cfg, DEEPSEEK_ARCH, "orca", device)
    per_iter = engine["launches"]["decode_attention"] \
        / engine["decode_iterations"]
    check(per_iter == cfg.n_layers, f"{per_iter} decode launches per "
          f"decode iteration")
    profile = _engine_profile(params, cfg, DEEPSEEK_ARCH, device)

    state = {impl: _lane_state(params, cfg, streams, impl, device)
             for impl in ("kernel", "eager")}
    gen = [streams[rid][1] for rid in sorted(streams)]
    first = torch.as_tensor([g[0] for g in gen], device=device)
    gate = _mla_layer_check(params, cfg, state["eager"][1], first, device)
    parted, flips = set(), []
    with _recorded_routes() as log:
        def lanes(step):
            if step == 0:
                log.clear()
                return torch.ones(SERVE_REQUESTS, dtype=torch.bool,
                                  device=device)
            n = cfg.n_layers
            for f in _route_flips(log[-2 * n:-n], log[-n:], cfg.moe.top_k):
                excused = f["margin"] < ROUTE_MARGIN \
                    or parted & set(f["lanes"])
                check(excused, f"{DEEPSEEK_ARCH} step {step}: an MoE choice "
                      f"flipped at a margin of {f['margin']}: {f}")
                parted.update(f["lanes"])
                flips.append({"step": step, **f})
            keep = torch.ones(SERVE_REQUESTS, dtype=torch.bool)
            keep[sorted(parted)] = False
            return keep.to(device)

        run = _forced_steps(
            params, cfg, state,
            lambda j, ref: (torch.as_tensor([g[j] for g in gen],
                                            device=device)
                            if j + 1 < SERVE_NEW else None),
            device, LOGIT_REL, f"{DEEPSEEK_ARCH} replay", lanes=lanes)
    agree = sum(int(int(ref[lane].argmax()) == gen[lane][j])
                for j, ref in enumerate(run["refs"])
                for lane in range(SERVE_REQUESTS))
    replay = {"phase": "serve", "run": "teacher_forcing",
              "arch": DEEPSEEK_ARCH, "lanes": SERVE_REQUESTS,
              "tol": LOGIT_REL, "route_margin": ROUTE_MARGIN,
              "route_flips": flips, "parted_lanes": sorted(parted),
              "eager_argmax_equal_engine_token": agree,
              "tokens": SERVE_REQUESTS * len(run["refs"]),
              "ms_per_step": {k: 1e3 * v / max(1, run["steps"])
                              for k, v in run["wall_s"].items()},
              **{k: run[k] for k in ("steps", "launches", "dispatches",
                                     "launches_per_step",
                                     "max_rel_logit_err")}}
    emit(replay)
    del state
    res, svc, service = _service_run(params, cfg, DEEPSEEK_ARCH, "orca",
                                     device)
    del svc
    _plan_parity(res, "orca", cfg.vocab)
    service["plan_parity"] = "bitwise"
    service["launches_per_decode_iteration"] = \
        service["launches"]["decode_attention"] / service["decode_iterations"]
    check(service["launches_per_decode_iteration"] == cfg.n_layers,
          f"service: {service['launches_per_decode_iteration']} decode "
          f"launches per decode iteration")
    emit(service)
    del params
    torch.cuda.empty_cache()
    return {"params": n_params, "engine": engine, "profile": profile,
            "layer_gate": gate, "replay": replay, "service": service,
            "launches_per_decode_iteration": per_iter}


def _counted(fn):
    """``fn()`` with every launch counter and dispatch count set to 0 just
    before it and read just after: (its result, wall s, launches,
    dispatches)."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.clear_dispatch_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, ops.launch_counts(), ops.dispatch_stats()


def _only(launches: dict, disp: dict, want: dict, what: str) -> None:
    """The launches and dispatches are exactly ``want`` (kernel -> n)."""
    got = {k: n for k, n in launches.items() if n}
    want_disp = {f"{k}:cuda": n for k, n in want.items() if n}
    check(got == {k: n for k, n in want.items() if n} and disp == want_disp,
          f"{what}: launches {got}, dispatches {disp}; expected {want}")


def _whisper_engine(params, cfg, enc_out, impl: str, device) -> tuple:
    """One orca ``ServingEngine`` run of the phase's 8 requests against
    ``enc_out`` (one row per slot): a prompt through ``extend`` (its
    cross-attention through flash at Lq = the prompt, row 0 of enc_out,
    ROADMAP R5 a), each decode iteration through decode (self) and flash
    (cross, Lq 1) once per layer. Returns its record and the token
    streams."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(params, cfg, max_batch=SERVE_REQUESTS,
                        max_len=SERVE_MAX_LEN, impl=impl, device=device,
                        enc_out=enc_out)
    res, wall, launches, disp = _counted(
        lambda: eng.run(_serve_requests(cfg.vocab), _sched("orca")))
    del eng
    check(not res.truncated and len(res.finished) == SERVE_REQUESTS
          and all(len(r.generated) == SERVE_NEW for r in res.finished),
          f"{WHISPER_ARCH} engine ({impl}): {len(res.finished)} finished")
    n_dec = sum(1 for st in res.stats if st.n_decode)
    n = cfg.n_layers
    want = {"decode_attention": n * n_dec,
            "flash_attention": n * (n_dec + SERVE_REQUESTS)} \
        if impl == "kernel" else {}
    _only(launches, disp, want, f"{WHISPER_ARCH} engine ({impl})")
    out_tokens = sum(len(r.generated) for r in res.finished)
    rec = {"phase": "serve", "run": "engine", "arch": WHISPER_ARCH,
           "impl": impl, "scheduler": "orca", "wall_s": wall,
           "tokens_per_s": out_tokens / wall, "output_tokens": out_tokens,
           "iterations": len(res.stats), "decode_iterations": n_dec,
           "launches": launches, "dispatches": disp}
    emit(rec)
    return rec, {r.rid: r.generated for r in res.finished}


def _serve_whisper(device) -> dict:
    """whisper-tiny at full width (4 encoder and 4 decoder blocks, D 64,
    Hq = Hkv = 6, encoder_len 1,500) with seeded random float32 weights,
    its audio frontend a stub: ``encode`` of 2 x 1,500 seeded frames, a
    2 x WHISPER_PROMPT ``prefill`` against them and WHISPER_STEPS
    teacher-forced ``decode_step``s, each through the kernels against the
    eager path within LOGIT_REL of the largest value (enc_out, logits),
    each path's launches counted: 4 flash a call for ``encode``, 8 for
    ``prefill`` (4 causal self, 4 cross at Lq = 64, Lk = 1,500), 4 decode
    and 4 flash (cross at Lq 1) a decode step; then one orca engine run
    through the kernels and one eagerly against one enc_out of 8 rows,
    their tokens equal. The weights are freed at the end."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.models import (
        decode_step,
        encode,
        init_cache,
        init_model,
        param_count,
        prefill,
    )

    arch = get(WHISPER_ARCH)
    cfg = arch.model
    check(cfg.encoder_layers == cfg.n_layers == 4 and cfg.head_dim == 64
          and cfg.n_heads == cfg.n_kv_heads == 6 and cfg.encoder_len == 1500
          and cfg.cross_attention and arch.modality_stub == "audio",
          f"{WHISPER_ARCH}: {cfg}")
    t_run = time.perf_counter()
    params = init_model(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = param_count(params)
    emit({"phase": "serve", "run": "init", "arch": WHISPER_ARCH,
          "params": n_params, "bytes": 4 * n_params,
          "seconds": time.perf_counter() - t_run})
    n, n_enc = cfg.n_layers, cfg.encoder_layers
    gen = torch.Generator(device=device).manual_seed(5)
    frames = 0.02 * torch.randn((2, cfg.encoder_len, cfg.d_model),
                                generator=gen, device=device)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, WHISPER_PROMPT)), device=device)
    walls, errs, counts = {}, {}, {}
    state = {}
    for impl in ("kernel", "eager"):
        encode(params, cfg, frames, impl=impl, device=device)   # warm
        enc, walls[f"encode_{impl}"], launches, disp = _counted(
            lambda: encode(params, cfg, frames, impl=impl, device=device))
        _only(launches, disp, {"flash_attention": n_enc} if impl == "kernel"
              else {}, f"{WHISPER_ARCH} encode ({impl})")
        counts[f"encode_{impl}"] = launches
        cache = init_cache(cfg, 2, WHISPER_LEN, torch.float32, device)
        (logits, cache), walls[f"prefill_{impl}"], launches, disp = _counted(
            lambda: prefill(params, cfg, toks, cache, impl=impl,
                            device=device, enc_out=enc))
        _only(launches, disp, {"flash_attention": 2 * n}
              if impl == "kernel" else {}, f"{WHISPER_ARCH} prefill ({impl})")
        counts[f"prefill_{impl}"] = launches
        state[impl] = (enc, logits, cache)

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    errs["enc_out"] = rel(state["kernel"][0], state["eager"][0])
    errs["prefill_logits"] = rel(state["kernel"][1], state["eager"][1])
    step_errs, decode_launches = [], {"decode_attention": 0,
                                      "flash_attention": 0}
    walls["decode_kernel"] = walls["decode_eager"] = 0.0
    for step in range(WHISPER_STEPS):
        tok = state["eager"][1].argmax(-1)
        for impl in ("kernel", "eager"):
            enc, _, cache = state[impl]
            (logits, cache), wall, launches, disp = _counted(
                lambda: decode_step(params, cfg, tok, cache, impl=impl,
                                    device=device, enc_out=enc))
            want = {"decode_attention": n, "flash_attention": n} \
                if impl == "kernel" else {}
            _only(launches, disp, want,
                  f"{WHISPER_ARCH} decode step {step} ({impl})")
            if impl == "kernel":
                for k in decode_launches:
                    decode_launches[k] += launches[k]
            walls[f"decode_{impl}"] += wall
            state[impl] = (enc, logits, cache)
        step_errs.append(rel(state["kernel"][1], state["eager"][1]))
    errs["decode_logits"] = max(step_errs)
    for what, err in errs.items():
        check(err <= LOGIT_REL, f"{WHISPER_ARCH} {what}: kernel vs eager "
              f"{err} of the largest > {LOGIT_REL}")
    check(all(torch.isfinite(state[i][1]).all().item() for i in state),
          f"{WHISPER_ARCH}: non-finite logits")
    del state
    rec = {"phase": "serve", "run": "encoder_decoder", "arch": WHISPER_ARCH,
           "params": n_params, "frames": [2, cfg.encoder_len],
           "prompt": [2, WHISPER_PROMPT], "decode_steps": WHISPER_STEPS,
           "tol": LOGIT_REL, "max_rel_err": errs,
           "decode_max_rel_err_per_step": step_errs,
           "wall_s": walls,
           "ms_per_decode_step": {
               k: 1e3 * walls[f"decode_{k}"] / WHISPER_STEPS
               for k in ("kernel", "eager")},
           "launches": {**counts, "decode_kernel": decode_launches},
           "card": card_line()}
    emit(rec)
    gen = torch.Generator(device=device).manual_seed(6)
    frames = 0.02 * torch.randn((SERVE_REQUESTS, cfg.encoder_len,
                                 cfg.d_model), generator=gen, device=device)
    enc_out = encode(params, cfg, frames, impl="kernel", device=device)
    engine, got = _whisper_engine(params, cfg, enc_out, "kernel", device)
    eager, want = _whisper_engine(params, cfg, enc_out, "eager", device)
    equal = sum(got[rid] == want[rid] for rid in want)
    cmp = {"phase": "serve", "run": "engine_kernel_vs_eager",
           "arch": WHISPER_ARCH, "scheduler": "orca",
           "requests": len(want), "equal_streams": equal,
           "run_s": time.perf_counter() - t_run}
    emit(cmp)
    check(equal == len(want), f"{WHISPER_ARCH} engine: {equal} of "
          f"{len(want)} streams equal through the kernels and eagerly")
    del params, enc_out
    torch.cuda.empty_cache()
    return {"params": n_params, "paths": rec, "engine": engine,
            "engine_eager": eager, "tokens": cmp,
            "launches": {
                "flash_attention": counts["encode_kernel"]["flash_attention"]
                + counts["prefill_kernel"]["flash_attention"]
                + decode_launches["flash_attention"]
                + engine["launches"]["flash_attention"],
                "decode_attention": decode_launches["decode_attention"]
                + engine["launches"]["decode_attention"]}}


def phase_serve(device) -> dict:
    """The serving path at the full width of llama3.2-3b in float32 (and
    its float32-weights / bfloat16-cache engine run, and the measured
    fleet over its paged service), in bfloat16, then of mamba2-2.7b (whose
    engine runs launch no kernel: prompts go through the eager chunked SSD
    of ``extend``, decode through the one-step recurrence; only
    ``prefill`` reaches the SSD kernel), then of phi-3-vision-4.2b through
    ``inputs_embeds``, then of deepseek-v2-236b (MLA and MoE) at
    DEEPSEEK_LAYERS layers, then of whisper-tiny (encoder-decoder). The
    launch counts of the result line sum every run of the path: decode
    over llama's engine runs, the measured fleet's serves, llama's scanned
    decode steps, phi-3's decode steps and kernel engine run,
    deepseek-v2's engine run, replay and service, and whisper's decode
    steps and kernel engine run; flash over llama's and phi-3's float32
    prefills, llama's int8-cache prefill and its scanned prefills, and
    whisper's encode, prefill, decode steps and kernel engine run; the SSD
    scan over mamba2's prefill and its scanned prefills."""
    llama = _serve_arch(SERVE_ARCH, SERVE_LAYERS, "flash_attention", device)
    bf16 = _serve_bf16(device)
    mamba = _serve_arch(MAMBA_ARCH, MAMBA_LAYERS, "ssd_scan", device)
    phi = _serve_phi(device)
    deepseek = _serve_deepseek(device)
    whisper = _serve_whisper(device)
    fleet = llama["fleet"]
    return {"llama": llama, "llama_bf16": bf16, "mamba": mamba, "phi": phi,
            "deepseek": deepseek, "whisper": whisper,
            "launches": {
                "decode_attention":
                    sum(r["launches"]["decode_attention"]
                        for r in llama["engine"].values())
                    + sum(fleet[k]["launches"]["decode_attention"]
                          for k in ("one_replica", "two_replicas"))
                    + phi["decode"]["launches"]["decode_attention"]
                    + phi["engine"]["launches"]["decode_attention"]
                    + sum(deepseek[k]["launches"]["decode_attention"]
                          for k in ("engine", "replay", "service"))
                    + llama["scanned"]["launches"]["decode_attention"]
                    + whisper["launches"]["decode_attention"],
                "flash_attention":
                    llama["prefill"]["launches"]["flash_attention"]
                    + phi["prefill"]["launches"]["flash_attention"]
                    + llama["int8_cache"]["launches"]["flash_attention"]
                    + llama["scanned"]["launches"]["flash_attention"]
                    + whisper["launches"]["flash_attention"],
                "flash_attention_bf16":
                    bf16["prefill"]["launches"]["flash_attention_bf16"],
                "ssd_scan": mamba["prefill"]["launches"]["ssd_scan"]
                + mamba["scanned"]["launches"]["ssd_scan"]}}


def _train_grad_check(cfg, tcfg, tokens, device) -> dict:
    """One step's gradients (``loss_and_grads``, remat on) of the model
    cut to TRAIN_CHECK_LAYERS layers at full width, held to a float64 copy
    of the same weights on the same tokens: every leaf within GRAD_REL of
    its largest float64 |g|. (The float64 copy computes its norms, its
    attention softmax and the loss in float32, as the port does for every
    weight type.)"""
    import copy
    import dataclasses

    import torch

    from repro_torch.models import init_model
    from repro_torch.training.train_loop import loss_and_grads

    small = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    p32 = init_model(small, seed=1, device=device).requires_grad_(True)
    p64 = copy.deepcopy(p32).double()
    t0 = time.perf_counter()
    loss32, g32 = loss_and_grads(p32, small, tcfg, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss64, g64 = loss_and_grads(p64, small, tcfg, tokens)
    errs = {k: float((g32[k].double() - g).abs().max() / g.abs().max())
            for k, g in g64.items()}
    worst = max(errs, key=errs.get)
    rec = {"phase": "train", "run": "float64_gradients", "arch": TRAIN_ARCH,
           "layers": TRAIN_CHECK_LAYERS,
           "params": sum(p.numel() for p in p32.parameters()),
           "tokens": list(tokens.shape), "loss": float(loss32),
           "loss_float64": float(loss64), "tol": GRAD_REL,
           "max_rel_grad_err": errs[worst], "worst_leaf": worst,
           "float32_step_s": wall}
    emit(rec)
    check(all(torch.isfinite(g).all().item() for g in g32.values()),
          f"{TRAIN_ARCH} at {TRAIN_CHECK_LAYERS} layers: non-finite grads")
    check(errs[worst] <= GRAD_REL, f"{TRAIN_ARCH} at {TRAIN_CHECK_LAYERS} "
          f"layers: {worst}'s gradient {errs[worst]} of its largest from "
          f"the float64 copy's > {GRAD_REL}")
    del p32, p64, g32, g64
    torch.cuda.empty_cache()
    return rec


def _train_directional(cfg, tcfg, tokens, device) -> dict:
    """At full depth (seed-0 weights, remat on): the gradient g of the
    loss on ``tokens``, and the loss at the weights moved by +-DD_EPS along
    g / |g|; their central difference must be |g| within DD_REL."""
    import torch

    from repro_torch.models import init_model
    from repro_torch.training.optimizer import named_leaves
    from repro_torch.training.train_loop import loss_and_grads, loss_fn

    params = init_model(cfg, seed=0, device=device).requires_grad_(True)
    loss, grads = loss_and_grads(params, cfg, tcfg, tokens)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))
    leaves = named_leaves(params)
    moved = []
    with torch.no_grad():
        for sign in (1.0, -1.0):
            for k, p in leaves.items():
                p.add_(grads[k], alpha=sign * DD_EPS / norm)
            moved.append(float(loss_fn(params, cfg, tokens)))
            for k, p in leaves.items():
                p.add_(grads[k], alpha=-sign * DD_EPS / norm)
    del params, grads, leaves
    torch.cuda.empty_cache()
    slope = (moved[0] - moved[1]) / (2 * DD_EPS)
    rec = {"phase": "train", "run": "directional_derivative",
           "arch": TRAIN_ARCH, "layers": cfg.n_layers, "loss": float(loss),
           "grad_norm": norm, "eps": DD_EPS, "loss_plus": moved[0],
           "loss_minus": moved[1], "central_difference": slope,
           "rel_err": abs(slope / norm - 1), "tol": DD_REL}
    emit(rec)
    check(rec["rel_err"] <= DD_REL, f"{TRAIN_ARCH}: the loss's slope along "
          f"its gradient {slope} is not the gradient's norm {norm}")
    return rec


def _train_steps(cfg, tcfg, batches, device, label: str) -> dict:
    """TRAIN_STEPS ``make_train_step`` steps from the seed-0 init under
    ``tcfg``, the counts set to 0 just before and read just after (no
    kernel may launch: training is eager); the record, its losses finite.
    The model is freed at the end."""
    import dataclasses

    import torch

    from repro_torch.training.train_loop import (
        init_train_state,
        loss_fn,
        make_train_step,
    )

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, state = init_train_state(0, cfg, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, tcfg)
    losses, norms, lrs, walls = [], [], [], []

    def run():
        nonlocal params, state
        for tok in batches:
            t0 = time.perf_counter()
            params, state, stats = step(params, state, tok)
            losses.append(float(stats["loss"]))      # syncs
            walls.append(time.perf_counter() - t0)
            norms.append(float(stats["grad_norm"]))
            lrs.append(float(stats["lr"]))

    _, _, launches, disp = _counted(run)
    n_params = sum(p.numel() for p in params.parameters())
    with torch.no_grad():
        after = float(loss_fn(params, cfg, batches[0]))
    del params, state
    torch.cuda.empty_cache()
    _only(launches, disp, {}, f"{TRAIN_ARCH} training ({label})")
    rec = {"phase": "train", "run": "steps", "settings": label,
           "arch": TRAIN_ARCH, "params": n_params,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": tcfg.remat,
           "opt": dataclasses.asdict(tcfg.opt), "losses": losses,
           "batch0_loss_after": after,
           "grad_norms": norms, "lrs": lrs, "step_wall_s": walls,
           "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / w for w in walls],
           "init_s": init_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "launches": launches, "card": card_line()}
    emit(rec)
    check(all(math.isfinite(x) for x in losses + norms + [after]),
          f"{TRAIN_ARCH} training ({label}): losses {losses}, grad norms "
          f"{norms}")
    return rec


def phase_train(device) -> dict:
    """Training at llama3.2-3b's full width (28 layers, 3.21 B float32
    parameters; weights, gradients and AdamW's two moments ~51 GB), eager
    torch as the reference's training is: first the gradient check at
    TRAIN_CHECK_LAYERS layers (:func:`_train_grad_check`) and
    ``impl="kernel"`` under grad raising ``ValueError``; then, for each of
    TRAIN_OPTS, TRAIN_STEPS ``make_train_step`` steps with remat on, on
    ``TokenStream`` seed 0 (TRAIN_BATCH x TRAIN_SEQ tokens), from one
    seeded init (:func:`_train_steps`): the step walls and the peak of
    ``torch.cuda.max_memory_allocated``; under the gated settings the last
    loss below the first."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get
    from repro_torch.models import forward, init_model
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    cfg = get(TRAIN_ARCH).model
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batches = [torch.as_tensor(next(stream), device=device)
               for _ in range(TRAIN_STEPS)]
    tcfgs = {label: TrainConfig(remat=True, opt=AdamWConfig(**opt))
             for label, opt in TRAIN_OPTS.items()}
    grads = _train_grad_check(cfg, tcfgs["gated"], batches[0], device)
    slope = _train_directional(cfg, tcfgs["gated"], batches[0], device)
    one = dataclasses.replace(cfg, n_layers=1)
    small = init_model(one, seed=2, device=device).requires_grad_(True)
    try:
        forward(small, one, batches[0][:1, :8], impl="kernel", device=device)
        raised = False
    except ValueError:
        raised = True
    del small
    check(raised, "impl='kernel' under grad did not raise")
    runs = {label: _train_steps(cfg, tcfg, batches, device, label)
            for label, tcfg in tcfgs.items()}
    losses = runs["gated"]["losses"]
    check(losses[-1] < losses[0] and runs["gated"]["batch0_loss_after"]
          < losses[0], f"{TRAIN_ARCH} training: losses {losses}, batch 0 "
          f"after them {runs['gated']['batch0_loss_after']}: not lower")
    rec = {"phase": "train", "run": "summary", "arch": TRAIN_ARCH,
           "memory_left_by_serve": left, "kernel_under_grad_raises": raised,
           "losses": {k: r["losses"] for k, r in runs.items()},
           # repro-lint: disable=RT006 -- every step read its loss back before the stop
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    launcher = _train_launcher(device)
    dry = _dryrun_record()
    return {"steps": runs, "float64_gradients": grads,
            "directional_derivative": slope, "train_launcher": launcher,
            "dryrun": dry}


def _train_launcher(device) -> dict:
    """``launch.train.main`` at LAUNCH_ARCH's full width on its default
    device: LAUNCH_STEPS steps with ``--ckpt-every LAUNCH_CKPT_EVERY`` into
    a temporary directory, then a second run from a directory that holds
    only step LAUNCH_CKPT_EVERY's checkpoint, which resumes there: its
    losses equal the first run's bit for bit. No kernel launches (eager
    training, counted); the step walls, ``max_memory_allocated`` and the
    straggler count of each run."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as launch_train

    argv = ["--arch", LAUNCH_ARCH, "--steps", str(LAUNCH_STEPS),
            "--ckpt-every", str(LAUNCH_CKPT_EVERY)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    runs = {}
    try:
        first = os.path.join(tmp, "first")
        resumed = os.path.join(tmp, "resumed")
        for label, where in (("first", first), ("resumed", resumed)):
            if label == "resumed":
                os.makedirs(resumed)
                name = f"step_{LAUNCH_CKPT_EVERY:08d}.npz"
                for suffix in ("", ".json"):
                    shutil.copy(os.path.join(first, name + suffix), resumed)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            out, wall, launches, disp = _counted(
                lambda where=where: launch_train.main(argv + ["--ckpt-dir",
                                                              where]))
            _only(launches, disp, {}, f"the training launcher ({label})")
            runs[label] = dict(
                out, wall_s=wall,
                max_memory_allocated=torch.cuda.max_memory_allocated(device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = runs["first"], runs["resumed"]
    after = range(LAUNCH_CKPT_EVERY, LAUNCH_STEPS)
    same = b["start"] == LAUNCH_CKPT_EVERY and list(b["losses"]) == \
        list(after) and all(b["losses"][s] == a["losses"][s] for s in after)
    check(all(math.isfinite(x) for x in a["losses"].values()),
          f"launcher losses {a['losses']}")
    check(same, f"the resumed launcher's losses {b['losses']} are not the "
                f"first run's {a['losses']}")
    rec = {"phase": "train", "run": "train_launcher", "arch": LAUNCH_ARCH,
           "argv": argv, "resumed_equal": same,
           **{label: {"start": r["start"],
                      "losses": {str(k): v for k, v in r["losses"].items()},
                      "step_s": {str(k): v for k, v in r["step_s"].items()},
                      "straggler_steps": r["straggler_steps"],
                      "wall_s": r["wall_s"],
                      "max_memory_allocated": r["max_memory_allocated"]}
              for label, r in runs.items()},
           "card": card_line()}
    emit(rec)
    return rec


def _dryrun_record() -> dict:
    """The port's dry run (host only, no card work: meta tensors) over
    DRYRUN_CELLS on both production meshes, each cell with its roofline
    on the H100's rates. Analytic, not measured: the argument GiB per
    device beside an H100's 80 GB, the counted FLOPs, ``dominant`` and
    ``t_comp`` / ``t_mem``."""
    from repro_torch.configs import SHAPES, get
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    cells = []
    for arch_id, shape in DRYRUN_CELLS:
        for multi_pod in (False, True):
            r = roofline.analyse(dryrun.run_cell(
                get(arch_id), SHAPES[shape], multi_pod=multi_pod,
                verbose=False))
            cells.append({
                "arch": arch_id, "shape": shape, "mesh": r["mesh"],
                "argument_gib_per_device":
                    r["argument_bytes_per_device"] / 2**30,
                "fits_h100": r["argument_bytes_per_device"]
                    < dryrun.H100_BYTES,
                "counted_flops_per_device": r["flops_per_device"],
                "analytic_flops_per_device": r["flops_analytic_per_device"],
                "t_comp_ms": 1e3 * r["t_comp_s"],
                "t_mem_ms": 1e3 * r["t_mem_s"],
                "t_coll_ms": None if r["t_coll_s"] is None
                else 1e3 * r["t_coll_s"],
                "dominant": r["dominant"],
                "trace_s": r["trace_s"]})
    rec = {"phase": "train", "run": "dryrun", "analytic": True,
           # repro-lint: disable=RT006 -- host work: the dry run traces on the meta device
           "cells": cells, "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec

def _twin(name: str):
    """The module of ``examples/<name>_torch.py``."""
    import importlib.util

    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin_kernels() -> dict:
    """Each kernel a twin launches -> the module of its CUDA wrapper, the
    wrapper's name there, and its plain version on the wrapper's own
    (bound) arguments."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mapping_eval as me

    return {
        "mapping_eval_fused": (
            me, "mapping_eval_fused_cuda",
            lambda a: me.mapping_eval_fused_plain(
                a["t_proc"], a["sched_idx"], a["chip"], a["ppos"],
                a["n_chips"])),
        "decode_attention": (
            da, "decode_attention_cuda",
            lambda a: da.decode_attention_plain(
                a["q"], a["k_cache"], a["v_cache"], a["lengths"],
                a["scale"])),
        "flash_attention": (
            fa, "flash_attention_cuda",
            lambda a: fa.flash_attention_plain(a["q"], a["k"], a["v"],
                                               a["causal"], a["scale"]))}


def _arg_key(v):
    import torch

    return [list(v.shape), str(v.dtype)] if torch.is_tensor(v) else v


def _clone(v):
    import torch

    if torch.is_tensor(v):
        return v.detach().clone()
    return tuple(_clone(x) for x in v) if isinstance(v, tuple) else v


@contextlib.contextmanager
def _keeping_calls(kept: dict, extends: list):
    """While open, each twin kernel's CUDA wrapper runs as before, and its
    first TWIN_HELD calls at each distinct set of argument shapes (and
    non-tensor arguments) also keep clones of their arguments and result
    in ``kept[(kernel, shapes)]``, beside the count of calls; no launch of
    its own. Each prompt chunk the dense engine runs (``_extend``) appends
    to ``extends``."""
    import inspect

    from repro_torch.serving.engine import ServingEngine

    saved = []
    for name, (mod, attr, _) in _twin_kernels().items():
        fn = getattr(mod, attr)

        def keep(*args, _fn=fn, _sig=inspect.signature(fn), _name=name,
                 **kwargs):
            out = _fn(*args, **kwargs)
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            key = json.dumps({k: _arg_key(v)
                              for k, v in bound.arguments.items()})
            entry = kept.setdefault((_name, key), {"calls": 0, "held": []})
            entry["calls"] += 1
            if len(entry["held"]) < TWIN_HELD:
                entry["held"].append((
                    {k: _clone(v) for k, v in bound.arguments.items()},
                    _clone(out)))
            return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, keep)
    extend = ServingEngine._extend

    def counted_extend(self, *args, **kwargs):
        extends.append(1)
        return extend(self, *args, **kwargs)

    saved.append((ServingEngine, "_extend", extend))
    ServingEngine._extend = counted_extend
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _hold_kept(label: str, kept: dict, launches: dict) -> list:
    """Each kept call against its kernel's plain version on the kept
    arguments: mapping eval bit for bit, attention within ATTN_TOLS of
    q's type; the wrappers' calls summed per kernel equal its launches.
    Returns a record per kernel and shape."""
    import torch

    plains = {n: plain for n, (_, _, plain) in _twin_kernels().items()}
    recs, calls = [], {}
    for (name, key), entry in kept.items():
        calls[name] = calls.get(name, 0) + entry["calls"]
        err, tol = 0.0, 0.0
        for args, got in entry["held"]:
            want = plains[name](args)
            if name == "mapping_eval_fused":
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"examples {label}: mapping_eval_fused at {key} "
                      f"differs from its plain version")
                continue
            tol = ATTN_TOLS[str(args["q"].dtype).removeprefix("torch.")]
            e = float((got.float() - want.float()).abs().max())
            check(torch.isfinite(got).all().item() and e <= tol,
                  f"examples {label}: {name} at {key} differs from its "
                  f"plain version: max abs err {e} > {tol}")
            err = max(err, e)
        recs.append({"kernel": name, "args": json.loads(key),
                     "calls": entry["calls"], "held": len(entry["held"]),
                     "max_abs_err": err, "tol": tol})
    check(calls == {k: n for k, n in launches.items() if n},
          f"examples {label}: wrapper calls {calls}, launches {launches}")
    return recs


def _twin_launches(label: str, out, n_extend: int) -> dict:
    """Each kernel on a twin's path -> the launches its run must show,
    from the run's own iteration stats: decode attention once per layer of
    each iteration that decoded; flash once per encoder layer for the one
    ``encode``, and once per decoder layer (cross-attention) for each such
    iteration and each prompt chunk. None where the count is the search's
    own (at least one)."""
    from repro_torch.configs import all_archs

    want = dict.fromkeys(EXAMPLE_KERNELS[label])
    if label not in EXAMPLE_ARCHS:
        return want
    cfg = all_archs()[EXAMPLE_ARCHS[label]].reduced()
    decode_iters = (out["decode_iterations"] if label == "codesign_serving"
                    else sum(s["decode_iterations"] for s in out.values()))
    want["decode_attention"] = cfg.n_layers * decode_iters
    if "flash_attention" in want:
        want["flash_attention"] = cfg.encoder_layers \
            + cfg.n_layers * (decode_iters + n_extend)
    return want


def _run_twin(label: str, name: str, argv: list) -> dict:
    """``main(argv)`` of a twin with the launch counters set to 0 just
    before and read just after: each kernel of EXAMPLE_KERNELS[label]
    launched, as often as ``_twin_launches`` says where it says, and no
    other; its dispatches of the attention kernels that often and none
    plain (the search's final pricing by the numpy oracle is host work by
    design); every distinct call shape held against the plain version
    (``_hold_kept``)."""
    kept, extends = {}, []
    with _keeping_calls(kept, extends):
        out, wall, launches, disp = _counted(lambda: _twin(name).main(argv))
    got = {k: n for k, n in launches.items() if n}
    want = _twin_launches(label, out, len(extends))
    check(set(got) == set(want)
          and all(got[k] == n for k, n in want.items() if n is not None)
          and all(disp.get(f"{k}:cuda") == n for k, n in want.items()
                  if n is not None)
          and not any(d.endswith(":plain") for d in disp),
          f"examples {label}: launches {got}, dispatches {disp}; expected "
          f"{want} (None: at least one)")
    rec = {"phase": "examples", "twin": label, "argv": argv,
           "seconds": wall, "launches": got, "expected": want,
           "dispatches": disp, "prompt_chunks": len(extends),
           "held": _hold_kept(label, kept, launches)}
    emit(rec)
    return {**rec, "out": out}


def _quickstart_plain(card: dict) -> dict:
    """quickstart_torch on ``--device cpu`` (the kernel's plain version)
    against its card run ``card``: the best hardware exactly; latency,
    energy, MC, EDP and the BO history within 1e-3 relative (the search
    goldens' tolerance, which the CPU test holds against the JAX
    example)."""
    t0 = time.perf_counter()
    host = _twin("quickstart").main(["--device", "cpu"])
    hardware = ("spec", "grid", "ws", "os", "nop", "dram", "mb", "tp")
    numbers = [(k, card[k], host[k]) for k in (
        "latency_s", "energy_j", "mc", "edp")] + [
        (f"bo_history[{i}]", a, b) for i, (a, b) in enumerate(
            zip(card["bo_history"], host["bo_history"]))]
    check({k: card[k] for k in hardware} == {k: host[k] for k in hardware}
          and len(card["bo_history"]) == len(host["bo_history"])
          and all(math.isclose(a, b, rel_tol=1e-3) for _, a, b in numbers),
          f"examples quickstart: the card's {card} against the plain "
          f"version's {host}")
    rec = {"phase": "examples", "run": "quickstart_plain",
           "hardware_equal": True,
           "bit_for_bit": all(a == b for _, a, b in numbers),
           "max_rel_diff": max(abs(a - b) / abs(b) if b else abs(a)
                               for _, a, b in numbers),
           # repro-lint: disable=RT006 -- host work: the search on the CPU
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def _train_small_resume() -> dict:
    """train_small_torch for TRAIN_SMALL_STEPS steps into a temporary
    directory, then again in it: the second run resumes from the step-25
    checkpoint, and its steps' losses equal the first run's bit for bit."""
    import tempfile

    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--steps", str(TRAIN_SMALL_STEPS), "--ckpt-dir", ckpt]
        first = _run_twin("train_small", "train_small", argv)
        again = _run_twin("train_small", "train_small", argv)
    logs = {g["step"]: g["loss"] for g in first["out"]["logs"]}
    resumed = {g["step"]: g["loss"] for g in again["out"]["logs"]}
    check(first["out"]["resumed_from"] is None
          and again["out"]["resumed_from"] == 25
          and sorted(resumed) == list(range(25, TRAIN_SMALL_STEPS))
          and all(math.isfinite(v) for v in logs.values())
          and all(resumed[k] == logs[k] for k in resumed),
          f"train_small: resumed from {again['out']['resumed_from']}, "
          f"losses {resumed} against the uninterrupted run's {logs}")
    rec = {"phase": "examples", "run": "train_small_resume",
           "params": first["out"]["params"], "steps": TRAIN_SMALL_STEPS,
           "resumed_from": 25, "losses": logs, "resumed_losses": resumed,
           "bit_for_bit": True, "step_s": [g["sec"] for g in
                                          first["out"]["logs"]],
           "seconds": first["seconds"] + again["seconds"]}
    emit(rec)
    return rec


def phase_examples() -> dict:
    """The four examples' twins on the card at their JAX originals'
    default arguments (see the module docstring); the phase's seconds."""
    t0 = time.perf_counter()
    quick = _run_twin("quickstart", "quickstart", [])
    quick_plain = _quickstart_plain(quick["out"])
    serve = _run_twin("serve_llm", "serve_llm", [])
    service = _run_twin("serve_llm_service", "serve_llm", ["--service"])
    whisper = _run_twin("serve_llm_whisper", "serve_llm",
                        ["--arch", "whisper-tiny"])
    codesign = _run_twin("codesign_serving", "codesign_serving", [])
    for label, rec in (("serve_llm", serve), ("serve_llm_service", service),
                       ("serve_llm_whisper", whisper)):
        check(all(s["unfinished"] == 0 and s["output_tokens"] == 8 * 12
                  for s in rec["out"].values()),
              f"examples {label}: {rec['out']}")
    check(codesign["out"]["summary"]["unfinished"] == 0
          and math.isfinite(quick["out"]["edp"]),
          f"examples: codesign {codesign['out']}, quickstart "
          f"{quick['out']}")
    train = _train_small_resume()
    t_proc = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
        capture_output=True, text=True, timeout=600, cwd=ROOT, check=False)
    check(proc.returncode == 0 and "best hardware: spec=" in proc.stdout,
          f"examples/quickstart_torch.py as a process: exit "
          f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    rec = {"phase": "examples", "run": "summary",
           "quickstart": {k: quick["out"][k] for k in (
               "spec", "grid", "ws", "os", "mb", "tp", "latency_s",
               "energy_j", "mc", "edp")},
           "serve_llm_iterations": {
               label: {k: s["iterations"] for k, s in rec["out"].items()}
               for label, rec in (("engine", serve), ("service", service),
                                  ("whisper", whisper))},
           "codesign": {k: v for k, v in codesign["out"].items()
                        if k != "summary"},
           "quickstart_plain_bit_for_bit": quick_plain["bit_for_bit"],
           "train_small_params": train["params"],
           "standalone_quickstart_s": time.perf_counter() - t_proc,
           "phase_s": time.perf_counter() - t0}
    emit(rec)
    return rec


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _in_turns(fns: dict, reps: int) -> dict:
    """CUDA-event ms per call of each of two callables, timed in turns
    (a, b, b, a) and averaged."""
    a, b = fns
    order = (a, b, b, a)
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(_time_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in got.items()}


def _mapping_device_ms(name: str, inp: dict, order: str, route: str,
                       calls: int = 20) -> float | None:
    """Device time of one mapping-eval call from ``torch.profiler``."""
    def run():
        for _ in range(calls):
            run_kernel(name, inp, order, route=route)

    run()
    for _ in range(5):   # the profiler now and then records nothing
        _, kern = _profiled(run)
        mine = [e for e in kern if "mapping_eval" in e.key]
        if mine:
            return _device_ms_per_call(mine, calls)
    return None


def phase_times(ev, runs: dict) -> dict:
    from repro_torch.kernels import mapping_eval as me

    at_main = {}
    for pop in TIME_POPS:
        inp = with_gathered(kernel_inputs(ev, pop, seed=pop))
        one = with_gathered({k: (v[:1, :1].contiguous() if k == "t_proc"
                                 else v[:1].contiguous())
                             if hasattr(v, "shape") else v
                             for k, v in inp.items() if k != "gathered"})
        t_len = int(inp["chip"].shape[1])
        for name in KERNELS:
            fused = name == "mapping_eval_fused"
            routes = ("global", "shared")     # timed in turns: g, s, s, g
            by_route = {r: {} for r in routes}
            for order in me.GRID_ORDERS:
                got = _in_turns({r: lambda o=order, r=r: run_kernel(
                    name, inp, o, route=r) for r in routes}, 20)
                for r in routes:
                    by_route[r][order] = got[r]
            best = {r: min(v, key=v.get) for r, v in by_route.items()}
            ms = {r: by_route[r][best[r]] for r in routes}
            dev = {r: _mapping_device_ms(name, inp, best[r], r)
                   for r in routes}
            chain = _in_turns({r: lambda r=r: run_kernel(
                name, one, "batch_major", route=r) for r in routes}, 20)
            chain_dev = {r: _mapping_device_ms(name, one, "batch_major", r)
                         for r in routes}
            plan = me.kernel_plan(inp["t_proc"], inp["chip"], inp["ppos"],
                                  inp["n_chips"], fused)
            order = best["shared"]

            def per_step(x):
                return None if x is None else 1e6 * x / t_len

            rec = {
                "kernel": name, "B": int(inp["t_proc"].shape[0]), "P": pop,
                "T": t_len, "route": plan.route, "plan": plan._asdict(),
                "blocks_per_sm_occupancy": me.blocks_per_sm(
                    plan, fused, inp["t_proc"].device),
                "kernel_ms": ms["shared"], "grid_order": order,
                "kernel_ms_by_order": by_route["shared"],
                "device_ms": dev["shared"],
                "ns_per_step": per_step(dev["shared"]),
                "host_us_per_call": _host_us_per_call(
                    lambda: run_kernel(name, inp, order)),
                "global_ms": ms["global"],
                "global_ms_by_order": by_route["global"],
                "global_device_ms": dev["global"],
                "global_ns_per_step": per_step(dev["global"]),
                "single_pair_chain_ms": chain["shared"],
                "single_pair_device_ms": chain_dev["shared"],
                "single_pair_ns_per_step": per_step(chain_dev["shared"]),
                "global_single_pair_chain_ms": chain["global"],
                "global_single_pair_device_ms": chain_dev["global"],
                "global_single_pair_ns_per_step":
                    per_step(chain_dev["global"]),
                "plain_ms": _time_ms(
                    lambda: run_kernel(name, inp, order, plain=True), 3, 1),
                "library_ms": None,
            }
            rec["bound_ms"], rec["bound_by"] = bound(name, inp)
            rec["bytes"], rec["f32_ops"] = traffic(name, inp)
            label = "fused" if name == "mapping_eval_fused" else "kernel"
            rec["launches_per_generation"] = \
                runs[label]["launches_per_generation"]
            emit(rec)
            if pop == MAIN_POP:
                at_main[name] = rec
    return at_main


def phase_attention_times(serve: dict) -> dict:
    """CUDA-event times of each attention kernel, its plain version and the
    library call on the same inputs (library and kernel in turns: library,
    kernel, kernel, library; the float32 flash kernel also with the first
    float32 kernel in turns inside them: first, kernel, kernel, first),
    beside the bound. Flash adds the profiler's device time per call and
    the wrapper's host time per call of each kernel, and in float32 the
    plan and the occupancy calculator's blocks per SM. Returns the records
    at each kernel's serving path's shape (ATTN_MAIN)."""
    at_main = {}
    for name, shapes, make in (("decode_attention", DECODE_TIMES,
                                decode_inputs),
                               ("flash_attention", FLASH_TIMES,
                                flash_inputs)):
        for i, shape in enumerate(shapes):
            for dtype in ATTN_TOLS:
                kernel = attn_kernel(name, dtype)
                inp = make(shape, dtype, seed=100 + i)
                first = kernel == "flash_attention"
                order = ("library", "first", "cuda", "cuda", "first",
                         "library") if first else \
                    ("library", "cuda", "cuda", "library")
                t = {how: [] for how in order}
                for how in order:
                    t[how].append(_time_ms(
                        lambda how=how: run_attention(name, inp, how), 20))
                rec = {"kernel": kernel, "shape": list(shape), "dtype": dtype,
                       "kernel_ms": sum(t["cuda"]) / 2,
                       "library_ms": sum(t["library"]) / 2,
                       "kernel_ms_runs": t["cuda"],
                       "library_ms_runs": t["library"],
                       "plain_ms": _time_ms(
                           lambda: run_attention(name, inp, "plain"), 3, 1),
                       "launches_on_path": serve["launches"][kernel],
                       **attention_bound(name, inp)}
                rec["kernel_over_bound"] = rec["kernel_ms"] / rec["bound_ms"]
                rec["kernel_over_library"] = \
                    rec["kernel_ms"] / rec["library_ms"]
                if name == "decode_attention":
                    rec.update(_decode_costs(inp))
                else:
                    rec.update(_flash_costs(inp, kernel))
                if first:
                    rec["first_ms"] = sum(t["first"]) / 2
                    rec["first_ms_runs"] = t["first"]
                    rec["first_over_kernel"] = \
                        rec["first_ms"] / rec["kernel_ms"]
                emit(rec)
                if ATTN_MAIN[kernel] == (shape, dtype):
                    at_main[kernel] = rec
    return at_main


def phase_mla_decode_times(serve: dict) -> list:
    """MLA's decode at DECODE_MLA_TIMES (B 8, Hq 128, Hkv 1, D 576, k is
    v, seeded lengths; S 1024 and 8192): a float32 q over a float32 and
    over a bfloat16 latent, and bfloat16 over bfloat16; CUDA-event times of
    the kernel in turns with ``scaled_dot_product_attention`` (``enable_
    gqa``, the same lengths as a mask; library, kernel, kernel, library)
    where the library takes the inputs' types, and of the plain version,
    beside the bound (the live latent rows read once: sum(len) x 576 x
    itemsize at 3.35 TB/s, or the operations at the float32 rate, whichever
    is larger); the plan, the blocks per SM, the profiler's device time per
    call (split and combine summed) and the wrapper's host time per call."""
    import torch

    recs = []
    for i, shape in enumerate(DECODE_MLA_TIMES):
        for q_dtype, kv_dtype in (("float32", "float32"),
                                  ("float32", "bfloat16"),
                                  ("bfloat16", "bfloat16")):
            inp = decode_inputs(shape, kv_dtype, seed=300 + i)
            inp["q"] = inp["q"].to(getattr(torch, q_dtype))
            lib = q_dtype == kv_dtype
            order = ("library", "cuda", "cuda", "library") if lib \
                else ("cuda", "cuda")
            t = {how: [] for how in order}
            for how in order:
                t[how].append(_time_ms(
                    lambda how=how: run_attention("decode_attention", inp,
                                                  how), 20))
            rec = {"kernel": "decode_attention", "case": "mla",
                   "shape": list(shape), "q": q_dtype, "cache": kv_dtype,
                   "kernel_ms": sum(t["cuda"]) / 2,
                   "kernel_ms_runs": t["cuda"],
                   "library_ms": sum(t["library"]) / 2 if lib else None,
                   "library_ms_runs": t.get("library"),
                   "plain_ms": _time_ms(lambda: run_attention(
                       "decode_attention", inp, "plain"), 3, 1),
                   "launches_per_decode_iteration":
                       serve["deepseek"]["launches_per_decode_iteration"],
                   **attention_bound("decode_attention", inp),
                   **_decode_costs(inp)}
            rec["kernel_over_bound"] = rec["kernel_ms"] / rec["bound_ms"]
            if lib:
                rec["kernel_over_library"] = \
                    rec["kernel_ms"] / rec["library_ms"]
            emit(rec)
            recs.append(rec)
    return recs


# the device kernel each flash launcher runs
FLASH_DEVICE_KERNELS = {"flash_attention": {"cuda": "flash_attention_kernel",
                                            "first": "f32_first_kernel"},
                        "flash_attention_bf16": {
                            "cuda": "flash_attention_bf16_kernel"}}


def _flash_costs(inp: dict, kernel: str, calls: int = 10) -> dict:
    """Device ms per call from ``torch.profiler`` and the wrapper's host
    µs per call of each flash launcher of ``kernel`` (the float32 kernel
    and the first float32 kernel, or the bfloat16 kernel); for float32 the
    plan and the resident blocks per SM."""
    from repro_torch.kernels import flash_attention as fa

    rec = {}
    for how, key in FLASH_DEVICE_KERNELS[kernel].items():
        def run(how=how):
            for _ in range(calls):
                run_attention("flash_attention", inp, how)

        run()
        dev = None
        for _ in range(10):  # the profiler now and then records nothing
            _, kern = _profiled(run)
            mine = [e for e in kern if key in e.key]
            if mine:
                dev = _device_ms_per_call(mine, calls)
                break
        label = "" if how == "cuda" else f"{how}_"
        rec[f"{label}device_ms"] = dev
        rec[f"{label}host_us_per_call"] = _host_us_per_call(
            lambda how=how: run_attention("flash_attention", inp, how))
    if kernel == "flash_attention":
        q, k = inp["q"], inp["k"]
        b, hq, lq, d = q.shape
        plan = fa.flash_f32_plan(b, hq, k.shape[1], lq, k.shape[2], d)
        rec["plan"] = plan._asdict()
        rec["blocks_per_sm_occupancy"] = fa.f32_blocks_per_sm(d, q.device)
    return rec


def _host_us_per_call(fn, calls: int = 50) -> float:
    """Host time of one call over ``calls`` back-to-back calls with no sync
    between them (the launch path alone while the device keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / calls


def _device_ms_per_call(kern: list, calls: int) -> float:
    """Device time of one call from the profiler's records of ``calls``
    calls: each kernel's mean time x its launches per call. The mean holds
    where the profiler drops a record or two of a window."""
    return sum(_dev_us(e) / e.count * max(1, round(e.count / calls))
               for e in kern if e.count) / 1e3


def _decode_costs(inp: dict, calls: int = 20) -> dict:
    """The decode kernel's plan (head groups, split, shared bytes) and the
    occupancy calculator's blocks per SM, its device time per call from
    ``torch.profiler`` (the split and combine kernels summed) and its host
    time per call; the same two for the library call (every device kernel
    it runs) where it takes the inputs' types."""
    from repro_torch.kernels import decode_attention as da

    q, k = inp["q"], inp["k"]
    plan = da.kernel_plan(q, k, inp["v"])
    rec = {"n_split": plan.n_split, "split_len": plan.split_len,
           "plan": plan._asdict(), "blocks_per_sm_occupancy": da.blocks_per_sm(plan, q.dtype,
                                                       k.dtype, q.device)}
    hows = (("cuda", ""), ("library", "library_")) \
        if q.dtype == k.dtype else (("cuda", ""),)
    for how, key in hows:
        def run(how=how):
            for _ in range(calls):
                run_attention("decode_attention", inp, how)

        run()
        for _ in range(5):   # the profiler now and then records nothing
            _, kern = _profiled(run)
            mine = [e for e in kern if how == "library"
                    or "decode_attention" in e.key]
            if mine:
                break
        rec[f"{key}device_ms"] = \
            _device_ms_per_call(mine, calls) if mine else None
        rec[f"{key}device_kernels"] = {  # name: [records, mean ms]
            e.key[:60]: [e.count, _dev_us(e) / e.count / 1e3]
            for e in mine if e.count}
        rec[f"{key}host_us_per_call"] = _host_us_per_call(
            lambda how=how: run_attention("decode_attention", inp, how))
    return rec


# the device kernels each SSD launcher runs
SSD_DEVICE_KERNELS = {"cuda": ("ssd_state_kernel", "ssd_y_kernel"),
                      "serial": ("ssd_serial_kernel",)}


def _ssd_device(inp: dict, how: str, calls: int = 10) -> dict:
    """Device ms per call of each device kernel of one SSD launcher, from
    ``torch.profiler`` over ``calls`` calls; empty if the profiler missed
    one of them five times."""
    def run():
        for _ in range(calls):
            run_ssd(inp, how)

    run()
    for _ in range(5):   # the profiler now and then drops a kernel's records
        _, kern = _profiled(run)
        got = {e.key[:60]: _dev_us(e) / e.count / 1e3 for e in kern
               if "ssd_" in e.key and e.count}
        if all(any(name in k for k in got)
               for name in SSD_DEVICE_KERNELS[how]):
            return got
    return {}


def phase_ssd_times(serve: dict) -> dict:
    """CUDA-event times of the SSD kernels and of the first version of the
    kernel (in turns: serial, kernels, kernels, serial) and of the plain
    version, beside the bound, at mamba2-2.7b's widths for L in {512,
    4096}, in float32 and bfloat16; the profiler's device time of each
    device kernel and the wrapper's host time per call of both. No PyTorch
    call computes an SSD scan, so there is no library time. Returns the
    record at the prefill shape in float32."""
    from repro_torch.kernels import ssd_scan as ss

    at_main = None
    for i, shape in enumerate(SSD_TIMES):
        for dtype in SSD_TOLS:
            inp = ssd_inputs(shape, dtype, seed=200 + i)
            t = {how: [] for how in ("cuda", "serial")}
            for how in ("serial", "cuda", "cuda", "serial"):
                t[how].append(_time_ms(lambda how=how: run_ssd(inp, how), 20))
            dev = {how: _ssd_device(inp, how) for how in SSD_DEVICE_KERNELS}
            plan = ss.ssd_plan(*shape, inp["x"].element_size())
            rec = {"kernel": "ssd_scan", "shape": list(shape),
                   "dtype": dtype, "kernel_ms": sum(t["cuda"]) / 2,
                   "serial_ms": sum(t["serial"]) / 2,
                   "kernel_ms_runs": t["cuda"], "serial_ms_runs": t["serial"],
                   "device_ms": sum(dev["cuda"].values()) or None,
                   "device_kernels": dev["cuda"],
                   "serial_device_ms": sum(dev["serial"].values()) or None,
                   "host_us_per_call": _host_us_per_call(
                       lambda: run_ssd(inp, "cuda")),
                   "serial_host_us_per_call": _host_us_per_call(
                       lambda: run_ssd(inp, "serial")),
                   "plain_ms": _time_ms(lambda: run_ssd(inp, "plain"), 3, 1),
                   "plan": plan._asdict(), "library_ms": None,
                   "launches_on_path": serve["launches"]["ssd_scan"],
                   **ssd_bound(inp)}
            rec["kernel_over_bound"] = rec["kernel_ms"] / rec["bound_ms"]
            rec["serial_over_kernel"] = rec["serial_ms"] / rec["kernel_ms"]
            emit(rec)
            if i == 0 and dtype == "float32":
                at_main = rec
    return at_main


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0.0)


def _profiled(fn) -> tuple[dict, list]:
    """``fn()`` under ``torch.profiler``: wall, device busy time (the sum
    of CUDA kernel times: one stream, so no overlap), idle share
    (1 - busy / wall), launches and the kernels that take the most device
    time; and the profiler's per-kernel records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_dev_us(e) for e in kern) / 1e3
    top = sorted(kern, key=_dev_us, reverse=True)[:8]
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if kern else None,
           "kernel_launches": sum(e.count for e in kern),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": _dev_us(e) / 1e3} for e in top]}
    if not kern:
        rec["note"] = "the profiler saw no device time"
    return rec, kern


def phase_profile(scenario) -> dict:
    """One BO point's ``hardware_objective`` under ``torch.profiler``."""
    import numpy as np

    from repro_torch.core import timing
    from repro_torch.core.bo import random_point
    from repro_torch.core.compass import hardware_objective
    from repro_torch.core.ga import GAConfig

    point = random_point(np.random.default_rng(0), scenario.target_tops)
    ga = GAConfig(population=MAIN_POP, generations=MAIN_GENS, seed=0)
    hardware_objective(scenario, point, ga)        # warm: tables, probe
    timing.clear_timing_backend_stats()
    prof, _ = _profiled(lambda: hardware_objective(scenario, point, ga))
    calls = timing.timing_backend_stats()["dispatches"].get(
        "mapping_eval_fused:cuda", 0)
    rec = {"phase": "profile", **prof, "evaluator_calls": calls}
    emit(rec)
    return rec


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated prefix of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if phases != list(PHASES[:len(phases)]):
        ap.error(f"--phases must be a prefix of {','.join(PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing; run it from the root "
              "of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    for var in ("REPRO_TORCH_TIMING_BACKEND", "REPRO_FUSED_GRID_ORDER",
                "REPRO_VERIFY_MAPPINGS"):
        os.environ.pop(var, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    build_rec = phase_build()
    if "parity" not in phases:
        return 0
    scenario = canonical_scenario()
    ev = canonical_evaluator(scenario, device)
    errs = phase_parity(ev)
    errs.update(phase_attention_parity())
    errs["ssd_scan"] = phase_ssd_parity()
    if "main" not in phases:
        return 0
    runs = phase_main(scenario, device)
    if "serve" not in phases:
        return 0
    serve = phase_serve(device)
    if "train" not in phases:
        return 0
    phase_train(device)
    if "examples" not in phases:
        return 0
    phase_examples()
    if "times" not in phases:
        return 0
    at_main = phase_times(ev, runs)
    at_main.update(phase_attention_times(serve))
    phase_mla_decode_times(serve)
    at_main["ssd_scan"] = phase_ssd_times(serve)
    if "profile" not in phases:
        return 0
    phase_profile(scenario)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    check(not leaked, f"modules of JAX or the JAX package loaded: {leaked}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "build_seconds": build_rec["seconds"]})
    print(card_line(), flush=True)
    kernels = []
    for name, replaces in KERNELS.items():
        rec = at_main[name]
        label = "fused" if name == "mapping_eval_fused" else "kernel"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": runs[label]["launches"],
            "max_abs_err": errs[name], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    for name, (source, replaces) in ATTN_KERNELS.items():
        rec = at_main[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serve["launches"][name],
            "max_abs_err": errs[name], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    name, source, replaces = SSD_KERNEL
    rec = at_main[name]
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": serve["launches"][name],
        "max_abs_err": errs[name], "ms": rec["kernel_ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
