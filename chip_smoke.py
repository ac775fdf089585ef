#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's routing, serving and training paths, and
the paper's experiments, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit. It builds the port's kernels from `src/repro_torch/kernels/
csrc/` into `build/repro_torch/` (one `nvcc` per source, all started
together), then:

  1. prints the card (name, power limit) and the torch/CUDA versions,
     the build time, each kernel's registers, shared memory and spills
     (`-Xptxas -v`), the tensor-core instructions in the flash library
     and the replay kernels' step loops (`cuobjdump -sass`), and fails
     where ptxas serialised a flash instance's `wgmma`s or a dh = 256
     decode instance spills;
  2. holds every kernel against its plain PyTorch version on the card,
     at the shapes the routing path gives it, with the stated
     tolerances: the similarity kernel at every bucket of the 8..1024
     ladder, each timed beside its bound and the library call (and, up
     to 128, with every tile that could take it); the fused retrieve's
     two kernels (retrieve_topn: the similarity panel with the live-row
     mask; topn_merge: a radix select of each row's top-n) at n = 20 and
     past 128 neighbours (n = 129, 256, 512, the kernels' bound being
     512) at buckets 1024, 64 and 8, unsharded and over 4 shards on the
     card, bit for bit against the similarity kernel's panel at the
     plan's tile + stable sort and against their plain versions, timed
     (queued) beside their bounds, plain versions and library chains and
     beside the panel + stable sort, with three controls that must change
     the top-n rows (kernel 2 without the panel's last 4,096 columns;
     without the last shard; a kernel 2 built to give ties to the higher
     row); an EagleRouter(n_neighbors=512) routed through its graphs
     (its graph pools logged before and after the warm-up; no capture
     by traffic, choices equal to the eager and the panel route's), and
     513 refused; the route over them (retrieve + gather replay) at those
     buckets bit for bit against the panel route and against the plain
     version; the replay kernel on
     each of its routes (the select epilogue at Q = 1024 and 8, the
     gather route bit for bit against gather + kernel, the fit's whole
     262,144-step fold against float32 and float64 host folds, with a
     control that must fail), timed on the device over launches queued
     ahead of it (`queued_ms`);
  3. drives the main path at the paper's width (D = 1536, N = 20, K = 32,
     P = 0.5, the 10-model fleet) over a RouterBench-scale corpus:
     fit (196k records, C = 32768, R = 8), a RouteDispatcher over a
     DoubleBuffer whose route graphs are captured on the 8..1024 ladder
     for both replicas, ragged routing of the 10,500 test queries at
     several budgets, the AUC over the budget grid, and 3 rounds of
     online feedback (global fold, commit, route), then routes 1024
     queries through the kernels and through the plain versions and
     compares the choices;
  4. checks that every kernel of the path was launched in that run;
  5. times each kernel (CUDA events), its plain version, the library
     call where one exists, and the path's end-to-end latencies (route
     p50 through the graphs at every bucket, and without them at 8, 64
     and 1024), and profiles routes at buckets 8 and 1024 (and eagerly at
     1024): their device work must be the retrieve's two kernels, the
     replay and copies; then the graph phase of the routing path: ragged
     batches of 1..1499 queries with feedback committed between them,
     across both replicas and a grow of the DB (C = 32768 -> 65536),
     each batch's choices equal to the eager route's and the panel
     route's on the same state and to the plain version's but at ties,
     every capture a warmup's; then the capacity-sharded route
     (`drive_sharded`) over its own router, fitted with duplicate
     prompts on the rows that straddle every shard boundary: DB meshes
     of 1, 2 and 4 shards on the card beside the unsharded route, each
     shard's similarity panel against its plain version and the
     unsharded kernel's columns, routes at buckets 8, 64 and 1024 (the
     tie queries first) equal to the unsharded route's bit for bit
     before and after 3 feedback rounds, the replicas equal bit for bit,
     route p50 per bucket and mesh, no capture after warmup, a control
     (the merge kernel over the first of 2 shards' candidates) that must
     change the top-n rows, the composite at S = 1, 2, 4 against the
     panel route bit for bit and its plain version, timed beside the
     panel route, each mesh's route profiled (the retrieve's kernels, the
     replay and copies only), and the capacity prebaker
     across the grow C = 32768 -> 65536 on the 2-shard mesh with no hand
     warmup (no capture by traffic, the grown replicas the prebaked ones,
     the poll's stall and the first route on a grown replica);
     then the operational obs plane (`drive_obs_plane`) over a router of
     its own at the same width: the JAX package's obs gate (the loop of
     `benchmarks_torch.route_batch_bench.obs_gate`; 500 ragged
     batches of 1..256 queries, each routed with the plane off and fully
     on: spans, a decision record a request, the quality monitor, an
     exporter scraped by a thread; the paired-delta overhead at most 5%
     of the off-path p50, no capture after warmup, the trace, Prometheus
     text and decision JSONL parsed), its overhead at buckets 8, 64 and
     1024, the JAX quality gate (regret bit-equal to the oracle on 500
     routed windows, no drift alert on the stationary run, one at least
     after a +400 step, in the alert log too), and graph captures beside
     a thread scraping all six routes: a fresh replica's route ladder,
     and a ServingEngine(prebake=True) with the launcher's plane across
     a DB grow (no capture by traffic, choices equal to the eager
     route's);
  6. holds the two attention kernels against their plain versions in
     bf16, element by element, at the serving shapes of both head
     layouts (qwen3-8b: prefill B=8, S=1024, H=32, Hk=8, dh=128, decode
     B=16, T=2048; olmo-1b: B=13, H=Hk=16, S=1024, T=1056; each prefill
     also at a ragged S and with a window, each decode over an fp32
     cache with ragged lengths and against the last row of prefill; the
     decode also at phi3.5-moe's layout and over a full bf16 cache of
     8192 rows, and each decode layout captured in a CUDA graph whose
     three replays must equal the eager call bit for bit: the kernel's
     arrival counters reset themselves), checks that a control with one
     key dropped fails its bar (flash: floor scaled with rms(v), decode:
     fixed; derivations at the constants) by 10x or more, and times each
     beside SDPA (decode also over launches queued ahead of the device,
     `queued_ms`);
  7. drives the serving path at full width: a ServingEngine over the
     fleet ["olmo-1b", "qwen3-8b"] (full depth and width, random weights
     from a seed, bf16 compute, fp32 KV cache of 1056 rows) behind a
     router fitted at D = 1536, serving 64 requests in 4 serve() calls
     (prompts of 128..1024 tokens, 32 new tokens, budgets over [1, 10],
     25% of them compared and fed back; each model's static decode state
     sized at 16 rows, its decode graphs captured per row count), and
     checks that every kernel but the off-path similarity was launched
     in that run;
  8. runs a group of each model through prefill and 4 decode steps with
     the kernels (each call also held against its plain version on the
     same inputs), with the plain attend, and with a control that drops
     the newest key at every decode, and compares the calls, the logits
     and the tokens;
  9. times the time to first token and the decode step per model, eager
     and through its captured graph (wall, device and the replay's host
     cost), the serve() p50, peak memory, and profiles an eager and a
     replayed decode step of each model;
 10. drives the launcher (`repro_torch.launch.serve`): build_engine() at
     its defaults (reduced ARCH_IDS[:4]) serves 8 requests through
     serve() and 8 through `--admission`; holds whisper-large-v3's five
     attention call sites (encoder flash over 1500 frames, causal
     decoder flash, cross flash with S != S_kv, self decode, cross
     decode over 1500 rows) against their plain versions with controls
     and times them; runs `python -m repro_torch.launch.serve --db-shards
     1 --prebake` and with `--serve-obs 0 --alert-log PATH` (exit 0, the
     plane's URL line) at its defaults; then serves the launcher's
     default fleet at full width and depth (whisper-large-v3, olmo-1b, mamba2-780m, qwen3-8b,
     groups padded to 1024 tokens) behind one router: 2 serve() calls
     of 16 requests and 32 requests through an AdmissionQueue at
     Poisson arrivals of 20 req/s (windows of 16), after capturing every
     model's decode graphs for 1..16 rows: nothing captured in that run,
     every kernel and every whisper call site launched (replays credited
     per site), peak memory under 80 GB; then each model's greedy tokens
     through its graphs equal to the eager path's; a ServingEngine over a
     2-shard DB mesh with the prebaker, one with the launcher's obs plane
     (its /quality counts the 16 decisions, its six routes answer 200)
     and an unsharded one, over the same four models, give equal choices
     and tokens on the same 16 requests;
     whisper and mamba2 kernel path against plain path, their times and
     profiles.
 10b. the moe family (`drive_moe`): phi3.5-moe's two attention call
     sites (prefill B=8, S=1024, H=32, Hk=8, dh=128; decode over its
     cache of 1056 rows) against their plain versions with controls and
     timed; then phi3.5-moe at full width (d_model 4096, 16 experts of
     6400, top-2; 16 of its 32 layers, 42.1 GB in bf16) beside olmo-1b
     behind a router at D = 1536: decode graphs for 1..16 rows, 2
     serve() calls of 16 requests (phi answering a group in each), no
     capture, its call sites' launches counted, peak memory under 80
     GB; greedy tokens through the graphs equal to the eager path's;
     phi's kernel path against its plain path (the experts pinned to
     the kernel path's); one layer's MoE FFN in bf16 at 8 x 1024 tokens
     and 8 decode rows against fp32 within a derived bar, its dropped
     pairs equal to the host's count; TTFT, the decode step, profiles
     and the MoE FFN's share of them; the launcher with `--fleet 5`
     (reduced) in process, phi answering, and as the CLI.
 10c. the dense families (`drive_dense`): the attention call sites of
     internlm2-20b (H = 48, Hk = 8), gemma3-12b (dh = 256, H = 16, Hk =
     8; its local layers with their window of 1024, its global ones
     without) and llava-next-mistral-7b (a prefill of 2,880 image rows +
     1,024 tokens, a cache of 3,936 rows) against their plain versions
     with controls and timed, and a window that bites (flash at S =
     4096, decode over 4,096 rows, window 1024; the control the same
     call without the window); then each of the three at full width and
     full depth beside olmo-1b behind a router at D = 1536, one engine at
     a time: decode graphs for 1..16 rows, 2 serve() calls of 16
     requests (the model answering a group in each), no capture, its
     call sites' launches counted, peak memory under 80 GB; greedy
     tokens through the graphs equal to the eager path's; its kernel
     path against its plain path; TTFT, the decode step and a profile of
     a replayed step.
 10c'. the dry-run and gemma3's ring caches (`drive_dryrun_ring`):
     gemma3-12b with ring caches (`window_cache`, 1,024 slots a local
     layer) served as the dense phase serves it (its ring decode site
     held with a control, no capture, every site launched), its logits
     held to the full caches' on the same weights over a wrap; then
     gemma3-12b x long_500k executed once at full size (bf16 weights
     and caches, 8 global layers of 524,288 rows, 40 rings):
     decode_step at 524,287 through the kernels against the plain
     attend, every decode call held, both sites with a control, the
     allocator and the peaks against the dry-run's record of the combo,
     the step timed eagerly and through a captured graph; last, with the
     host to itself, `repro_torch.launch.dryrun --all` on the meta
     device (33 records ok, 7 skipped, none in error) and
     `benchmarks_torch.roofline` over it against the card's memory.
 10d. the last two families (`drive_hybrid_mla`): the attention call
     sites of zamba2-7b (dh = 112, H = Hk = 32: flash prefill and its
     self decode over the fp32 cache) and deepseek-v3's MLA prefill
     (flash at query/key width 192, value width 128, H = Hk = 128)
     against their plain versions with controls and timed; then zamba2-7b
     at full width and full depth (13 groups of 5 mamba2 blocks and the
     shared attention block, 3 tail blocks) and deepseek-v3 at full
     width and DEEPSEEK_LAYERS of its 61 layers (3 dense, 1 MoE), each
     beside olmo-1b as the dense phase serves its models (deepseek's
     absorbed decode is plain PyTorch: its decode has no kernel call);
     then the launcher with `--fleet 10` (reduced: every model of
     ARCH_IDS) in process and as the CLI.
 10e. training (`drive_training`; `training/loop.py`, `launch/train.py`):
     the attention kernels' wrappers refuse inputs that require grad;
     every family's reduced config in fp32, 5 steps of make_train_step
     on the card and on the CPU from the same weights and batches, the
     step-1 gradients and the ce / aux / mtp histories within their
     bars (TRAIN_GRAD_ATOL, TRAIN_METRIC_RTOL); olmo-1b at full width
     through `launch/train.py`'s main (bf16 compute, fp32 masters and
     AdamW state, remat on, batch 8 x seq 1024, 20 steps): a finite ce
     that descends, ms a step, tokens/s, the model FLOPs over the bf16
     peak, peak memory and a profile of one step; a checkpoint round
     trip on the card (bf16 moments, fp32 masters, the int32 step)
     bit-equal to the uninterrupted run; `examples_torch/train_small.py`
     for its 300 steps. The kernel counts, zeroed before the path, read
     0 after it: training's attention is the plain attend
     (`transformer.TRAIN_ATTENTION`), as the JAX train step
     differentiates the jnp `attend`.
 10f. the fleet meshes (`drive_mesh`; `launch/mesh.py`, `sharding.py`,
     the expert-parallel MoE, `training/loop.py` on a mesh): (a) olmo-1b
     at full width (batch 8 x 1024, bf16 compute, remat) under an NCCL
     world of one: 3 steps of make_train_step(mesh=) on a (1, 1) mesh
     against the same 3 steps without a mesh from the same weights, bit
     for bit (every collective is over a group of one), both timed; (b)
     the expert-parallel MoE with two gloo ranks on the one card (NCCL
     takes one rank a card): one phi3.5-moe layer at full width (E = 16,
     d = 4096, expert_ff = 6400, top-2) in bf16 over 8 x 1040 = 8,320
     tokens on a (data=1, model=2) mesh, y, aux and the gradients of x,
     the router and each rank's experts against one process's
     unsharded call (y within the MoE bar, MOE_SIGMAS; a control with
     the combine dropped must fail it by MESH_CONTROL_MIN), the gloo
     transfers counted and timed; (c) `repro_torch.launch.dryrun` on
     the fake backend for MESH_DRYRUN (processes of their own, side by
     side): each record's per-device argument bytes equal to the spec
     arithmetic (`sharding.local_bytes` over `dryrun.mesh_arguments`),
     its collective bytes and the roofline's dominant term logged. The
     kernel counts read 0 after the phase (none lies on these paths).
 11. the paper's experiments (`benchmarks_torch`) at the frozen regime
     (300 prompts per dataset, D = 64, seed 0): holds KNN's retrieve
     call (a dataset's ~90 test rows against the 1,470 win-rate rows,
     top-40; the fused retrieve's two kernels) against the reference
     backend and the similarity kernel's panel + stable sort and times
     it, Eagle's D = 64
     routes of the 630 test queries at every budget against the
     reference backend, and a captured MLP fit and a captured SVM fit
     against eager fits of 50 steps on the card; then runs Fig. 2 (both
     regimes), Table 3a (its timed fits must capture nothing), Fig. 3b
     and Fig. 4 as `python -m benchmarks_torch.run --quick` does, and
     checks that KNN's and Eagle's kernels were launched in that run.
     The similarity kernel is off the serving route since the fused
     retrieve: it is checked in phase 2, and its launches in the kernels
     line are the legacy retrieval's of phase 12.
 12. the router path's benchmarks and examples (`benchmarks_torch/
     {route_batch_bench,queue_bench,kernels_bench}.py`, `examples_torch/`)
     at their smoke sizes: the fused route against the legacy
     VectorDB.query path (choices equal), the ragged and sharded (S = 2,
     4) loops with no capture after warmup, the queue and quality gates,
     the kernel microbenchmarks, quickstart, online adaptation and
     serve_routed (8 requests, the live exporter walk-through).

Every CUDA graph is captured by `repro_torch.graphs` (counted process
wide); a failed capture raises. Any mismatch or exception exits
non-zero. The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON, and the one before that the card's name and power limit.
Everything measured is also written to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

sys.modules["jax"] = None           # the port must not need JAX

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# paper configuration and data scale
DIM, C_EXPECTED, R, M, N, P = 1536, 32768, 8, 10, 20, 0.5
N_PER_DATASET = 5000
PAIRS_PER_QUERY = 8
FEEDBACK_ROUNDS, FEEDBACK_PROMPTS = 3, 50     # 50 prompts x 8 = 400 records
# the serving slice: the fleet at full width, its router and its traffic
FLEET = ("olmo-1b", "qwen3-8b")
SERVE_MAX_LEN = 1056               # 1024-token prompt + 32 new tokens
SERVE_CALLS, SERVE_BATCH, MAX_NEW = 4, 16, 32
PROMPT_LEN = (128, 1024)
TIME_BATCH, TIME_LEN, TIME_STEPS = 8, 1024, 16
# attention kernel checks at the serving shapes, (B, S or T, H, Hk, dh),
# in each fleet model's head layout: qwen3-8b's GQA (rep 4), and
# olmo-1b's MHA (rep 1) at the group it is served (~13 of 16 requests,
# prompts up to 1024 tokens, a cache of SERVE_MAX_LEN rows). The
# qwen3-8b shapes are the ones in the kernels line.
FLASH_SHAPES = {"qwen3-8b": (8, 1024, 32, 8, 128),
                "olmo-1b": (13, 1024, 16, 16, 128)}
DECODE_SHAPES = {"qwen3-8b": (16, 2048, 32, 8, 128),
                 "olmo-1b": (13, 1056, 16, 16, 128),
                 "phi3.5-moe": (16, SERVE_MAX_LEN, 32, 8, 128),
                 "bf16 8k": (8, 8192, 8, 8, 128)}
# the decode layouts over a bf16 cache (every row valid: the kernels
# bench's decode_attention_8k; no fleet model keeps a bf16 cache), and
# the prefill length of each layout's check against the last row of flash
DECODE_BF16 = ("bf16 8k",)
DECODE_FLASH_S = {"qwen3-8b": 1024, "olmo-1b": 1024, "phi3.5-moe": 1024,
                  "bf16 8k": 8192}
RAGGED_S, WINDOW = 777, 256
# a padded group of each model, kernel path against plain path
COMPARE_LENS = {"qwen3-8b": (900, 613),
                "olmo-1b": (1024, 977, 901, 850, 777, 640, 600, 512, 433,
                            300, 256, 200, 128)}
# the launcher's default fleet (launch/serve.py: ARCH_IDS[:4]) at full
# width: groups padded to LAUNCH_PAD_LEN tokens (a multiple of mamba2's
# SSD chunk, 256), LAUNCH_CALLS serve() calls of SERVE_BATCH requests,
# then ADMIT_REQUESTS through the admission queue at ADMIT_RATE req/s;
# LAUNCH_SEED draws the requests (every model gets a group with it)
LAUNCH_FLEET = ("whisper-large-v3", "olmo-1b", "mamba2-780m", "qwen3-8b")
LAUNCH_PAD_LEN = 1024
LAUNCH_CALLS, LAUNCH_SEED = 2, 0
ADMIT_REQUESTS, ADMIT_RATE = 32, 20.0
# the decode graphs warmed for the launcher fleet: every row count its
# traffic can make. An admission window of 16 bounds every group at 16
# rows (the queue's default, 32, could make groups of 17..32, and
# whisper's static caches alone take 0.84 GB a row: 26.8 GB at 32)
LAUNCH_BUCKETS = (1, 2, 4, 8, 16)
ADMIT_WINDOW = 16
# the graph phase of the routing path: GRAPH_ROUNDS ragged batches, each
# followed by GRAPH_FEED new prompts of feedback (8 pairs each) and a
# commit; the DB grows past C_EXPECTED in the first rounds, and both
# grown replicas are then routed
GRAPH_ROUNDS, GRAPH_FEED = 20, 500
ROUTE_P50_EAGER = (8, 64, 1024)
# the sharded phase: meshes of SHARDS shards on the one card, each warmed
# on both replicas for SHARD_WARM[S] (None: the whole ladder; the 4-shard
# and 1-shard ladders are cut to save the graph pools' memory), routes
# checked at SHARD_BUCKETS_CHECKED; SHARD_ROUNDS feedback rounds of
# SHARD_FEED prompts, then up to SHARD_GROW_ROUNDS more for the prebaker
# to cross the grow to 2 C_EXPECTED; the control (the merge without the
# last shard) must change the top-n rows of CONTROL_SHARE of the queries
SHARDS = (1, 2, 4)
SHARD_BUCKETS_CHECKED = (8, 64, 1024)
SHARD_WARM = {1: SHARD_BUCKETS_CHECKED, 2: None, 4: SHARD_BUCKETS_CHECKED}
SHARD_ROUNDS, SHARD_GROW_ROUNDS, SHARD_FEED = 3, 17, 500
CONTROL_SHARE = 0.9
# the operational obs plane (`drive_obs_plane`), by the JAX package's two
# gates: the obs gate (benchmarks/route_batch_bench.py:run_obs_gate: 500
# ragged batches of 1..256 queries, a feedback commit every 20, each
# routed with the plane off and on in alternating order; the paired-delta
# overhead at most 5% of the off-path p50), repeated at OBS_BUCKETS for
# OBS_BUCKET_STEPS steps each; and the quality gate
# (benchmarks/queue_bench.py:run_quality_gate: 500 routed windows of
# 1..32 queries, a stationary fold every 10, then a +400 step)
OBS_STEPS, OBS_MAX_BATCH, OBS_COMMIT_EVERY, OBS_MAX_OVERHEAD = 500, 256, 20, 0.05
OBS_BUCKETS, OBS_BUCKET_STEPS = (8, 64, 1024), 50
QUALITY_STEPS, QUALITY_WINDOW, QUALITY_FOLD_EVERY = 500, 32, 10
# the prebaker beside a scraper: serve() calls of PREBAKE_BATCH requests,
# each compared and fed back, until both replicas have grown
PREBAKE_BATCH, PREBAKE_ROUNDS = 1024, 16
# whisper-large-v3's attention call sites at its serving shapes: flash
# (B, S, S_kv, H, Hk, dh, causal) and decode (B, T, H, Hk, dh); the
# encoder over 1500 frames, the cross prefill of a 1024-token prompt
# against them, the causal decoder, and one token against the self
# cache (SERVE_MAX_LEN rows) and the cross cache (1500 rows)
WHISPER_FLASH = {"encoder": (8, 1500, 1500, 20, 20, 64, False),
                 "cross prefill": (8, 1024, 1500, 20, 20, 64, False),
                 "decoder": (8, 1024, 1024, 20, 20, 64, True)}
WHISPER_DECODE = {"self decode": (16, SERVE_MAX_LEN, 20, 20, 64),
                  "cross decode": (16, 1500, 20, 20, 64)}
# the kernels line's entries for those sites, by the count_sites key of
# their launches on the launcher fleet's run
WHISPER_SITES = {"whisper flash encoder": "flash encoder",
                 "whisper flash cross prefill": "flash cross",
                 "whisper flash decoder": "flash causal",
                 "whisper self decode": "decode self",
                 "whisper cross decode": "decode cross"}
COMPARE_LENS.update({
    "whisper-large-v3": (1024, 900, 777, 640, 512, 300, 200, 128),
    "mamba2-780m": (1024, 700, 513, 256)})   # padded to 1024: 4 chunks
# the moe family (ROADMAP §2.6.1): phi3.5-moe at full width (d_model
# 4096, 32 / 8 heads of 128, 16 experts of width 6400, top-2, vocab
# 32064, bf16) cut to MOE_LAYERS of its 32 layers, its one reduction:
# 21.1B parameters, 42.1 GB in bf16 (all 32 layers: 83.7 GB, more than
# the card). It is served beside olmo-1b at full width (costs 1 and 8)
# behind a router at D = 1536: MOE_CALLS serve() calls of SERVE_BATCH
# requests drawn with MOE_SEED (phi answers a group in each: 2 and 4
# requests in a rehearsal on the CPU with stub models), groups padded to
# LAUNCH_PAD_LEN tokens and the row ladder, decode graphs for
# LAUNCH_BUCKETS rows
MOE_MODEL, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 16
MOE_FLEET = ("olmo-1b", MOE_MODEL)
MOE_CALLS, MOE_SEED = 2, 0
COMPARE_LENS[MOE_MODEL] = (1024, 900, 777, 640, 512, 300, 200, 128)
# phi's two attention call sites at its serving shapes (H = 32, Hk = 8,
# dh = 128): the causal prefill of 8 x 1024 and one token against its
# cache of SERVE_MAX_LEN rows; the kernels line's entries, by the
# count_sites key of their launches on the MoE fleet's run
PHI_FLASH = {"prefill": (8, 1024, 1024, 32, 8, 128, True)}
PHI_DECODE = {"self decode": (16, SERVE_MAX_LEN, 32, 8, 128)}
PHI_SITES = {"phi flash prefill": "flash causal",
             "phi self decode": "decode self"}
# the MoE FFN on the card: one layer's bf16 weights at 8 x 1024 tokens
# and at 8 decode rows, against the same function in fp32 (the same bf16
# weights and activations, widened; TF32 off). Both take the same experts
# and slots: the router reads the same fp32 values in both. The bf16 path
# rounds, each to u = 2^-8 relative (bf16's unit roundoff, the products
# accumulated in fp32): the gate and up products g and v, silu(g), the
# gated product h = silu(g) v, the down product y_k of each of the k
# choices, the choice's weight w_k, the weighted output and the sum over
# the choices. A relative error e of g moves silu(g) by a e, a = 1 + g (1
# - sigmoid(g)); so h_j moves by eps_j h_j, eps_j the sum of four
# independent roundings, of variance (a_j^2 + 3) u^2 / 3 (each uniform on
# [-u, u]). Through y_k,i = sum_j h_j W_ji over 6400 terms they sum to a
# normal error of variance sigma_i^2 = (u^2 / 3) sum_k w_k^2 sum_j (a_j^2
# + 3) h_j^2 W_ji^2 (fp32, from the reference's own g, h, w); the four
# roundings after it move an element by at most u each of a choice's
# term: 4 u sum_k w_k |y_k,i|. The bar, element by element:
# MOE_SIGMAS sigma_i + 4 u sum_k w_k |y_k,i|. A normal variable passes
# 8 sigma with probability 1.2e-15: 4e-8 expected excesses in the 3.4e7
# elements of the prefill. Predicted largest error over the bar 0.2-0.5.
MOE_SIGMAS, MOE_ROUND = 8.0, 2.0 ** -8
MOE_FFN_SHAPES = {"prefill": (8, 1024), "decode": (8, 1)}
# the dense families (ROADMAP §2.6.2-4) at full width and full depth:
# internlm2-20b (48 layers, 48 / 8 heads of 128; 39.7 GB in bf16),
# gemma3-12b (48 layers, 40 local with a window of 1024 and rope theta
# 10k, 8 global at 1M; 16 / 8 heads of 256; 23.5 GB) and
# llava-next-mistral-7b (32 layers, 32 / 8 heads of 128, 2,880 stub image
# rows before each prompt; 14.5 GB). Each is served beside olmo-1b (costs
# 1 and 8) behind a router at D = 1536, one engine at a time (freed before
# the next), DENSE_CALLS serve() calls of SERVE_BATCH requests drawn with
# DENSE_SEED, groups padded to LAUNCH_PAD_LEN tokens, decode graphs for
# LAUNCH_BUCKETS rows. llava's cache counts the image rows: 2880 + 1024 +
# 32 = 3936 rows, DENSE_MAX_LEN.
DENSE_MODELS = ("internlm2-20b", "gemma3-12b", "llava-next-mistral-7b")
DENSE_MAX_LEN = {"llava-next-mistral-7b": 2880 + LAUNCH_PAD_LEN + MAX_NEW}
DENSE_CALLS, DENSE_SEED = 2, 0
COMPARE_LENS.update({"internlm2-20b": (1024, 900, 640, 300),
                     "gemma3-12b": (1024, 900, 640, 300),
                     "llava-next-mistral-7b": (1024, 700)})
# their attention call sites at the serving shapes, bf16 queries:
# flash (B, S, S_kv, H, Hk, dh, causal, window), decode (B, T, H, Hk, dh,
# window, least kv_len) over fp32 caches of SERVE_MAX_LEN rows (llava:
# DENSE_MAX_LEN, every row past its image rows and a 128-token prompt).
# gemma3's local sites carry its window of 1024: at these lengths it
# drops at most 32 of 1,056 keys, so WINDOW_BITE below proves the window
DENSE_FLASH = {
    "internlm2": {"prefill": (8, 1024, 1024, 48, 8, 128, True)},
    "gemma3": {"prefill local": (8, 1024, 1024, 16, 8, 256, True, 1024),
               "prefill global": (8, 1024, 1024, 16, 8, 256, True)},
    "llava": {"prefill": (4, 3904, 3904, 32, 8, 128, True)}}
DENSE_DECODE = {
    "internlm2": {"self decode": (16, SERVE_MAX_LEN, 48, 8, 128)},
    "gemma3": {"self decode local": (16, SERVE_MAX_LEN, 16, 8, 256, 1024),
               "self decode global": (16, SERVE_MAX_LEN, 16, 8, 256)},
    "llava": {"self decode": (16, DENSE_MAX_LEN["llava-next-mistral-7b"],
                              32, 8, 128, 0, 2880 + 129)}}
# the kernels line's entries for those sites, by the count_sites key of
# their launches on the model's served run
DENSE_SITES = {
    "internlm2 flash prefill": "internlm2-20b flash causal",
    "internlm2 self decode": "internlm2-20b decode self",
    "gemma3 flash prefill local": "gemma3-12b flash causal window",
    "gemma3 flash prefill global": "gemma3-12b flash causal",
    "gemma3 self decode local": "gemma3-12b decode self window",
    "gemma3 self decode global": "gemma3-12b decode self",
    "llava flash prefill": "llava-next-mistral-7b flash causal",
    "llava self decode": "llava-next-mistral-7b decode self"}
# a window that bites: gemma3's heads and window over 4,096 keys (flash)
# and a cache of 4,096 rows with kv_len in [3,900, 4,096] (decode); the
# control is the same call without the window, which must fail the bar
# by CONTROL_MIN
WINDOW_BITE = {"flash": (2, 4096, 16, 8, 256, 1024),
               "decode": (16, 4096, 16, 8, 256, 1024, 3900)}
# phase 10d: zamba2-7b (hybrid; 81 blocks, 68 of them mamba2, 32 / 32
# heads of 112; 11.2 GB in bf16) at full depth, and deepseek-v3's MLA
# over its MoE at DEEPSEEK_LAYERS of 61 layers (3 dense and 1 MoE of 256
# routed experts and one shared: ~15.1 B parameters, 30.2 GB in bf16),
# each served beside olmo-1b as the dense phase serves its models
HYBRID_MODELS = ("zamba2-7b", "deepseek-v3-671b")
DEEPSEEK_LAYERS = 4
COMPARE_LENS.update({"zamba2-7b": (1024, 900, 640, 300),
                     "deepseek-v3-671b": (1024, 900, 640, 300)})
# their call sites: flash (B, S, S_kv, H, Hk, dh or (dk, dv), causal),
# zamba2's self decode (B, T, H, Hk, dh) over an fp32 cache; deepseek's
# decode (the absorbed form) is plain PyTorch and has no site
HYBRID_FLASH = {"zamba2": {"prefill": (8, 1024, 1024, 32, 32, 112, True)},
                "deepseek": {"prefill": (8, 1024, 1024, 128, 128,
                                         (192, 128), True)}}
HYBRID_DECODE = {"zamba2": {"self decode": (16, SERVE_MAX_LEN, 32, 32,
                                            112)},
                 "deepseek": {}}
HYBRID_SITES = {"zamba2 flash prefill": "zamba2-7b flash causal",
                "zamba2 self decode": "zamba2-7b decode self",
                "deepseek flash prefill": "deepseek-v3-671b flash causal"}
# phase 10c': the dry-run and gemma3's ring caches (`drive_dryrun_ring`),
# after the dense phase. (a) `repro_torch.launch.dryrun --all` into a
# temporary directory (the meta device: no card), run after (b) and (c)
# so that their host-timed steps have the host's cores to themselves,
# then `benchmarks_torch.roofline` over it: DRYRUN_OK records ok and
# DRYRUN_SKIPPED skipped (long_500k outside `shapes._LONG_OK`), none in
# error. (b) gemma3-12b with ring
# caches (window_cache: W = 1,024 slots a local layer) served as the
# dense phase serves it, the same seed (DENSE_SEED's requests, groups
# padded to LAUNCH_PAD_LEN = W tokens, so the first decode writes slot
# 0 with position 1,024), under the fleet key RING_KEY; its logits held
# against the full caches' on the same weights; its ring decode site
# (RING_DECODE: kv_len = W, no window) against its plain version. (c)
# gemma3-12b x long_500k with --window-cache --bf16-params, executed
# once: bf16 weights and caches drawn on the card, decode_step at
# LONG_INDEX through the kernels and through the plain attend.
DRYRUN_OK, DRYRUN_SKIPPED = 33, 7
RING_KEY = "ring:gemma3-12b"
COMPARE_LENS[RING_KEY] = COMPARE_LENS["gemma3-12b"]
RING_DECODE = {"self decode local": (16, 1024, 16, 8, 256, 0, 1024)}
RING_SITES = {"gemma3 ring self decode local": f"{RING_KEY} decode self ring"}
LONG_INDEX, LONG_SEED = 524_287, 41
# the long step's memory against the dry-run's record of it (the bars
# PERF.md states for it): after the setup the allocator holds the
# record's argument bytes up to its rounding (a block of ALLOC_ROUND
# bytes; a block over 1 MiB is not split where 1 MiB or less would be
# left, so under 1 MiB + ALLOC_ROUND more a tensor past 1 MiB); the
# kernel path's peak above them stays under the record's temp (the plain
# attend's fp32 copies, which the kernels never make); the plain path's
# peak above them is the record's temp within LONG_TEMP_REL of it plus
# LONG_TEMP_ABS bytes
ALLOC_ROUND = 512
LONG_TEMP_REL, LONG_TEMP_ABS = 0.10, 256 << 20
LONG_SITES = {"gemma3 long_500k decode local": "gemma3-12b long local",
              "gemma3 long_500k decode global": "gemma3-12b long global"}
# phase 10e: training (training/loop.py, launch/train.py). (a) every
# family's reduced config in fp32, TRAIN_CMP_STEPS steps on the card and
# on the CPU from the same weights and batches: the ce / aux / mtp
# histories within TRAIN_METRIC_RTOL of each other, the step-1 gradients
# within TRAIN_GRAD_ATOL of each leaf's largest |value|. On the CPU the
# port holds JAX's within 6.1e-7 (metrics over 5 steps) and 6.6e-6
# (gradients, zamba2's SSD) (tests/_torch_training_common.py); cuBLAS
# sums fp32 products in other orders than the CPU's (TF32 off), which
# moves both by a few ulp of each sum; the bars leave ~15x over the CPU
# readings. A MoE whose top-k flips on a near tie would fail them: that
# is a fault to read, not a bar to widen.
TRAIN_CMP_STEPS = 5
TRAIN_CMP_SHAPE = (2, 32)          # batch, seq (the reduced SSD chunk)
TRAIN_METRIC_RTOL = 1e-5
TRAIN_GRAD_ATOL = 1e-4
# (b) olmo-1b at full width through launch/train.py's main: bf16 compute,
# fp32 masters and AdamW state, remat on, batch 8 x seq 1024, 20 steps
TRAIN_ARGV = ("--arch", "olmo-1b", "--steps", "20", "--batch", "8",
              "--seq", "1024")
# the kinds a train step's device time is summed by (a kernel name's
# first matching marks): fp32 GEMMs (the plain attend's einsums, TF32
# off), the other GEMMs (the bf16 weight products), copies and casts,
# reductions and softmax, the other elementwise passes
TRAIN_KERNEL_KINDS = (("fp32 gemm", ("sgemm", "f32f32")),
                      ("gemm", ("gemm", "nvjet", "xmma")),
                      ("copy", ("direct_copy", "copy_kernel")),
                      ("softmax / reduce", ("softmax", "reduce")),
                      ("elementwise", ("elementwise",)))
# the ops whose kernels are the step's matrix products (torch counts
# their FLOPs under the profiler's with_flops)
TRAIN_MATMUL_OPS = ("aten::mm", "aten::bmm", "aten::addmm",
                    "aten::baddbmm")
# (c) the checkpoint round trip: reduced olmo-1b, AdamW state in bf16,
# CKPT_STEPS steps uninterrupted against a restore after CKPT_STEPS - 1
CKPT_STEPS = 3
# (d) examples_torch/train_small.py at its default of 300 steps
# phase 10f: the fleet meshes (`drive_mesh`). (a) olmo-1b, MESH_TRAIN
# (batch, seq), MESH_TRAIN_STEPS steps on a (1, 1) mesh against no mesh;
# if not bit-equal, the training bars: ce MESH_CE_RTOL, the parameters
# MESH_PARAM_ATOL of each leaf's largest |value|
MESH_TRAIN, MESH_TRAIN_STEPS = (8, 1024), 3
MESH_CE_RTOL, MESH_PARAM_ATOL = 2e-6, 5e-4
# (b) one phi3.5-moe layer, MESH_MOE_TOKENS (batch, seq) = 8,320 tokens
# (past moe.SMALL_T: the expert-parallel branch), two gloo ranks on
# (data=1, model=2): with one batch shard each rank routes every token,
# so the sharded call equals the unsharded one up to the order of its
# sums. y: the MoE bar (MOE_SIGMAS sigma + 4u sum_k w_k |y_k|, against
# the fp32 evaluation); the control (a rank's y without the other
# rank's experts) must pass it by MESH_CONTROL_MIN. The gradients are
# sums over the same pairs split between the ranks, rounded in bf16 once
# more where the two halves meet: x's and the experts' (bf16) within
# MESH_GRAD_BF16 of each leaf's largest |value| (two bf16 steps), the
# router's (fp32) within MESH_GRAD_FP32; aux (fp32, the same gates)
# within MESH_AUX_ATOL
MESH_MOE_ARCH, MESH_MOE_TOKENS, MESH_MOE_SEED = \
    "phi3.5-moe-42b-a6.6b", (8, 1040), 29
MESH_CONTROL_MIN = 10.0
MESH_GRAD_BF16, MESH_GRAD_FP32, MESH_AUX_ATOL = 2.0 ** -7, 1e-5, 1e-6
# (c) the dry-run on the fake backend: (arch, shape, mesh, options)
MESH_DRYRUN = (("qwen3-8b", "train_4k", "single", ()),
               ("deepseek-v3-671b", "decode_32k", "single",
                ("--experts-2d",)),
               ("mamba2-780m", "prefill_32k", "multi", ()))
MESH_SHAPES = {"single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}
# tolerances: the JAX suite's own bars between its backends
SIM_TOL = 1e-5                     # similarity (tests/test_kernels.py)
R_RTOL, R_ATOL = 1e-5, 1e-3        # ratings (tests/test_router_state.py)
CHOICE_TIE = 1e-3                  # top-two combined scores this close: a tie
# bf16 decode attention, kernel against plain version, element by
# element: both compute in fp32 (TF32 off) and round the output to bf16
# once, so they differ by one bf16 step (at most 2^-7 of the value) where
# their fp32 results straddle a rounding boundary. The bar is two steps of
# each element (rtol 2^-6), plus 1e-4 for elements near zero, where fp32
# sums of ~1000 terms taken in another order differ by ~1e-6 of the
# terms' size. A control (the newest key dropped) must fail it.
DECODE_RTOL, DECODE_ATOL = 2.0 ** -6, 1e-4
# bf16 flash attention: the plain version keeps the softmax weights w in
# fp32; the kernel rounds each unnormalised weight p_j to bf16 before the
# second product (relative error d_j, |d_j| <= 2^-8, the unit roundoff of
# an 8-bit significand) and divides by the fp32 sum of the unrounded p.
# An output element then moves by sum_j d_j w_j v_j, at most 2^-8 *
# sum_j w_j |v_j|: the attention of |v| through the same weights. That is
# the floor, element by element (`flash_atol`), so it scales with the
# inputs: model activations are held as random data are. Typical errors
# sit far below it (standard deviation ~2^-9 / sqrt(3) * sqrt(sum_j w_j^2
# v_j^2), ~6e-5 for N(0, 1) inputs over ~1000 keys, against a floor of
# ~3e-3 there); rows with few keys err more and the floor grows with
# them. Both sides round the output to bf16 once, half a step (2^-8 of
# the value) each: the relative part stays two steps, 2^-6 |want|. fp32
# sums taken in another order differ by ~1e-6 of sum_j w_j |v_j|, inside
# the floor. So a correct kernel stays below the bar by construction;
# predicted largest error over the bar 0.5-0.8 (an emulation of the
# rounding in PyTorch on the CPU gave 0.54 and 0.68 at B=2, S=1024,
# H=32). The fixed 1e-4 floor of the decode bar would reject it (9.8x in
# that emulation). The control (the diagonal key dropped) moves a row of
# ~500 keys by ~w_diag |v_diag - o| against a floor of ~3e-3 there, and
# must fail by CONTROL_MIN (emulation: 33x and 37x).
FLASH_RTOL, FLASH_P_ROUND = 2.0 ** -6, 2.0 ** -8
CONTROL_MIN = 10.0
# kernel path vs plain path through 36 layers of bf16: the two differ
# where the plain path rounds its softmax weights to bf16 (one bf16 step,
# 2^-8 relative, per attention output); 36 such independent steps add up
# to about sqrt(36) * 2^-8 = 2.3% of the residual stream. The bar is
# twice that, relative to the largest logit. It catches gross faults
# only: with random weights attention is a small part of the residual
# stream, and dropping the newest key at every decode moved olmo-1b's
# logits by 0.64% of the largest (H100 80GB HBM3). The subtle faults are
# caught by holding every kernel call of the model path against its
# plain version (`kernels_held`).
LOGIT_REL_BAR = 0.05
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12           # tensor cores
PEAK_BYTES = 3.35e12
ROUTE_KERNELS = ("retrieve_topn", "topn_merge", "elo_scan_select",
                 "elo_scan")
# the fused retrieve's kernels checked and timed at these buckets (the
# first is the kernels line's), with DEAD_ROWS rows past the live count
RETRIEVE_BUCKETS = (1024, 64, 8)
DEAD_ROWS = 768
# the fused retrieve checked at N and at LARGE_N past 128 neighbours, at
# RETRIEVE_BUCKETS, unsharded and over SHARDS_LARGE_N shards on the card,
# with controls built with TIE_CONTROL; a router of MAX_N neighbours
# routes LARGE_N_BATCHES (buckets 8, 64, 1024) through graphs
LARGE_N, SHARDS_LARGE_N = (129, 256, 512), 4
LARGE_N_BATCHES = (5, 50, 1000)
TIE_CONTROL = ("TOPN_CONTROL_TIE_HIGH",)
# a control: kernel 2 over the panel without its last DROP_COLS columns
# (at n = 20, C = 32768: 3,328 live rows, in the top-20 of ~89% of random
# queries)
DROP_COLS = 4096
# the similarity panel (`similarity_cuda`): off the serving route; the
# legacy retrieval (`VectorDB.query`) of the route benchmark runs it
OFF_PATH = ("similarity",)
# device-side names a route's profile may hold: the retrieve's two
# kernels, the replay, and copies; anything else (a library GEMM, a sort)
# fails
ROUTE_PROFILE_KERNELS = ("panel_gemm_kernel", "panel_gemv_kernel",
                         "topn_select_kernel", "elo_scan_kernel")
# fp32 operations of one replay step of one query: difference, divide,
# pow, add, reciprocal, difference, two products, two updates
REPLAY_STEP_OPS = 10
# the paper's experiments: captured MLP/SVM fits held against eager fits
# on the card after FIT_STEPS steps. The graph replays the kernels the
# eager step launches, over the same tensors, so the two agree to fp32
# rounding (cuBLAS may pick another algorithm inside a capture)
FIT_STEPS, FIT_TOL = 50, 1e-6


def log(*a):
    print(*a, flush=True)


def log_time(stats, msg):
    """A timing line, with the card it was measured on."""
    log(f"{msg} [{stats['card']}]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back runs."""
    for _ in range(warmup):
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


def queued_ms(fn, iters: int) -> float:
    """Device time of one run of fn() with the host ahead of the device
    (`benchmarks_torch.kernels_bench.device_ms`: `iters` runs queued
    behind a spin kernel, timed by CUDA events). cuda_ms over
    back-to-back calls measures the host instead when a call takes longer
    than its kernels run (the replay's wrappers: tens of microseconds of
    Python a call)."""
    from benchmarks_torch.kernels_bench import device_ms
    return device_ms(fn, iters)


def bound_ms(nbytes: float, flops: float, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def topk_rows_agree(got_i, want_i, panel, n, tol):
    """Rows whose top-n indices differ must have two of the reference's
    n+1 best scores within `tol` (a near-tie the two panels may order
    either way). Returns (rows that differ, of which not near-tied)."""
    from repro_torch.kernels.ref import stable_topk
    best = stable_topk(panel, n + 1)[0]
    gaps = (best[:, :-1] - best[:, 1:]).abs().nan_to_num(0.0)
    tied = (gaps < tol).any(dim=1)
    differ = ~(got_i == want_i).all(dim=1)
    return int(differ.sum()), int((differ & ~tied).sum())


def choices_agree(got, want, combined):
    """Differing choices are allowed only where the top two feasible
    combined scores are within CHOICE_TIE. Returns (differ, untied)."""
    top2 = torch.topk(combined, 2, dim=-1).values
    tied = (top2[:, 0] - top2[:, 1]).abs().nan_to_num(0.0) < CHOICE_TIE
    differ = got.long() != want.long()
    return int(differ.sum()), int((differ & ~tied).sum())


def att_check(got, want, atol, rtol):
    """(max abs error, the largest ratio of an element's error to its
    bar atol + rtol |want|): attention passes where the ratio is at most
    1. `atol` is a number or a tensor that broadcasts against `want`."""
    err = (got.float() - want.float()).abs()
    bar = atol + rtol * want.float().abs()
    return float(err.max()), float((err / bar).max())


def flash_atol(q, k, v, **kw):
    """The flash bar's floor, element by element: FLASH_P_ROUND * the
    attention of |v| through the plain version's weights (fp32)."""
    from repro_torch.kernels import ref
    return FLASH_P_ROUND * ref.flash_attention_ref(
        q.float(), k.float(), v.float().abs(), **kw)


def flash_check(got, want, atol):
    return att_check(got, want, atol, FLASH_RTOL)


def decode_check(got, want):
    return att_check(got, want, DECODE_ATOL, DECODE_RTOL)


def sass(lib) -> str:
    """`cuobjdump -sass` of a built library ("" where the toolkit has no
    cuobjdump)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        return subprocess.run([tool, "-sass", str(lib)], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


SASS_COUNTED = ("MUFU.EX2", "MUFU.RCP", "MUFU.LG2", "FCHK", "CALL", "SHFL")


def step_loops(listing: str):
    """Per kernel function of a SASS listing: its instruction count, and
    its step loop, the shortest backward branch whose span holds a SHFL
    (a replay step shuffles its ratings): the instructions in that span,
    the counted instructions among them (SASS_COUNTED), and, where the
    span holds MUFU.EX2 (one a step), instructions per step. Work a step
    calls out of the span (a CALL) is not in its count."""
    import re
    funcs, cur = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            t = re.search(r"ILi(\d+)ELb(\d)ELb(\d)E", name)
            if t:   # elo_scan_kernel<W, SELECT, GATHER>
                name = "elo_scan_kernel<%s,%s,%s>" % t.groups()
            elif "elo_scan_kernel" in name:
                name = "elo_scan_kernel"
            cur = funcs.setdefault(name, {"ins": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur["labels"][m.group(1)] = len(cur["ins"])
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+([^;]*);", line)
        if m:
            tokens = m.group(2).split()
            mnem = tokens[1] if tokens[0].startswith("@") else tokens[0]
            cur["ins"].append((int(m.group(1), 16), mnem, m.group(2)))
    report = {}
    for name, f in funcs.items():
        ins = f["ins"]
        at = {addr: i for i, (addr, _, _) in enumerate(ins)}
        loops = []
        for i, (_, mnem, text) in enumerate(ins):
            m = re.search(r"\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", text)
            if not (mnem.startswith("BRA") and m):
                continue
            tgt = f["labels"].get(m.group(1)) if m.group(1) \
                else at.get(int(m.group(2), 16))
            if tgt is not None and tgt <= i and any(
                    mn.startswith("SHFL") for _, mn, _ in ins[tgt:i + 1]):
                loops.append((i - tgt + 1, tgt, i))
        entry = {"instructions": len(ins)}
        if loops:
            n, lo, hi = min(loops)
            body = [mn for _, mn, _ in ins[lo:hi + 1]]
            counts = {k: sum(mn.startswith(k) for mn in body)
                      for k in SASS_COUNTED}
            entry.update(loop_instructions=n, loop_counts=counts)
            if counts["MUFU.EX2"]:
                entry["per_step"] = n / counts["MUFU.EX2"]
        report[name] = entry
    return report


def build_report(libs, stats):
    """Registers, shared memory and spills of each kernel (`-Xptxas -v`),
    ptxas's notes on serialised `wgmma` or ignored `setmaxnreg`, the
    count of tensor-core instructions in the built flash library
    (HGMMA: wgmma; HMMA: mma.sync), and the replay kernels' step loops
    (`step_loops`), from `cuobjdump -sass` where the toolkit has it.
    Fails the run where ptxas serialised a flash instance's `wgmma`s or a
    dh = 256 decode instance spills (`build_guards`)."""
    import re
    from repro_torch.kernels import _build
    report, logs = {}, {}
    for name in ("retrieve_topn", "flash_attention", "elo_scan",
                 "decode_attention"):
        logs[name] = _build.build_log(name)
        entry, lines = None, []
        for line in logs[name].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and re.search(
                    r"Used|spill|Performance|serialized|setmaxnreg", line):
                lines.append(f"{entry}: {line.strip()}")
        report[name] = lines
        for line in lines:
            log(f"ptxas {name}: {line}")
    failures, regs = _build.build_guards(logs)
    log("registers, spill stores and spill loads (bytes) of each flash and "
        f"dh = 256 decode instance: {regs}")
    report["guarded"] = {k: list(v) for k, v in regs.items()}
    if failures:
        fail("build report: " + "; ".join(failures))
    by_name = {p.name.split("-")[0][3:]: p for p in libs}
    listing = sass(by_name["flash_attention"])
    counts = {op: len(re.findall(rf"\b{op}\b", listing))
              for op in ("HGMMA", "HMMA", "UTMALDG")} if listing \
        else "not available"
    log(f"tensor-core instructions in the flash library (cuobjdump "
        f"-sass): {counts}")
    report["flash_sass"] = counts
    listing = sass(by_name["elo_scan"])
    loops = step_loops(listing) if listing else "not available"
    log(f"replay kernels (cuobjdump -sass; W, SELECT, GATHER): "
        f"instructions, step loop (span, counted instructions, per step) "
        f"{loops}")
    report["elo_scan_sass"] = loops
    stats["build"] = report


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def similarity_tile_ms(q, db, tile, iters):
    """Device time of the similarity kernel (the retrieve's kernel 1 with
    no live-row count) with its tile forced (8: the streaming kernel; 32,
    64, 128: the GEMM with that many query rows), to show where the path's
    choice should switch. Timing only: these launches go around the
    wrappers and are not counted."""
    from repro_torch.kernels import retrieve_topn as RT
    return cuda_ms(lambda: RT.panel_launch(q, db, None, 0, tile), iters)


def check_similarity(dev, kernels, stats):
    """The similarity panel (`similarity_cuda`: the retrieve's kernel 1
    with no live-row count, the legacy `VectorDB.query`'s) at every bucket
    of the dispatch ladder against the plain version (SIM_TOL, and the
    top-N near-tie check), timed beside the plain version, the library
    call and the bound; the buckets up to 128 also with each tile that
    could take them."""
    from repro_torch.core.dispatch import bucket_ladder
    from repro_torch.kernels import ref
    from repro_torch.kernels.similarity_topk import similarity_cuda
    rng = torch.Generator(device=dev).manual_seed(0)
    db = torch.randn((C_EXPECTED, DIM), generator=rng, device=dev)
    buckets = {}
    for nq in sorted(bucket_ladder(), reverse=True):
        q = torch.randn((nq, DIM), generator=rng, device=dev)
        got = similarity_cuda(q, db)
        want = ref.similarity_ref(q, db)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=SIM_TOL, atol=SIM_TOL):
            fail(f"similarity Q={nq}: max abs err {err}")
        gi = ref.stable_topk(got, N)[1]
        wi = ref.stable_topk(want, N)[1]
        differ, untied = topk_rows_agree(gi, wi, want, N, SIM_TOL)
        if untied:
            fail(f"similarity Q={nq}: top-{N} differs on {untied} rows "
                 "without a near-tie")
        del got, want
        iters = 20 if nq >= 256 else 50
        ms = cuda_ms(lambda: similarity_cuda(q, db), iters)
        plain = cuda_ms(lambda: ref.similarity_ref(q, db), iters)
        lib = cuda_ms(lambda: torch.matmul(
            torch.nn.functional.normalize(q, dim=-1),
            torch.nn.functional.normalize(db, dim=-1).T), iters)
        nbytes = 4.0 * (nq * DIM + C_EXPECTED * DIM + nq * C_EXPECTED)
        flops = 2.0 * nq * C_EXPECTED * DIM + 2.0 * (nq + C_EXPECTED) * DIM
        bms, by = bound_ms(nbytes, flops)
        tiles = {}
        if nq <= 128:
            for tile in (8, 32, 64, 128):
                if tile >= nq:
                    tiles[tile] = similarity_tile_ms(q, db, tile, iters)
        log_time(stats,
                 f"similarity Q={nq} C={C_EXPECTED} D={DIM}: "
                 f"max_abs_err={err} topk rows differing at near-ties="
                 f"{differ} kernel_ms={ms} ({bms / ms} of the bound, "
                 f"{flops / ms / 1e9} TFLOP/s) plain_ms={plain} "
                 f"library_ms={lib} (kernel / library {ms / lib}) "
                 f"bound_ms={bms} ({by}); each tile ms {tiles}")
        buckets[nq] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=bms, bound_by=by,
                           share_of_bound=bms / ms,
                           topk_rows_near_tie=differ, tile_ms=tiles)
        if nq == 1024:
            kernels["similarity"] = dict(
                name="similarity", route="cuda",
                source="src/repro_torch/kernels/csrc/retrieve_topn.cu",
                replaces="src/repro/kernels/similarity_topk.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)
    stats["similarity_buckets"] = buckets


def retrieve_bound(nq, c, d, n, passes):
    """The retrieve's bounds: kernel 1 reads q and the DB once and writes
    the (Q, C) panel of scores (the product's fp32 operations bound it at
    large Q); kernel 2 reads the panel and writes the top-n (scores, int64
    rows, hit), comparing each entry once a radix pass (`passes`: the
    passes this run's rows took, summed, from the plain version's select)
    and once to gather. Returns ((ms, by), (ms, by))."""
    k1 = bound_ms(4.0 * (nq * d + c * d) + 4.0 * nq * c,
                  2.0 * nq * c * d + 2.0 * (nq + c) * d)
    k2 = bound_ms(4.0 * nq * c + 13.0 * nq * n, float(c * (passes + nq)))
    return k1, k2


def pair_bound(nq, c, d, n=N):
    """The fused retrieve's bound as one function (both kernels, timed
    together): q and the DB read once, the top-n (scores, int64 rows, hit)
    written once, the product's fp32 operations and the norms. The panel
    between the kernels is the design's own and is not counted. Returns
    (ms, by)."""
    return bound_ms(4.0 * (nq * d + c * d) + 13.0 * nq * n,
                    2.0 * nq * c * d + 2.0 * (nq + c) * d)


def _shards(x, s):
    cl = x.shape[0] // s
    return [x[i * cl:(i + 1) * cl] for i in range(s)]


def check_retrieve(dev, kernels, stats):
    """The fused retrieve (kernel 1 writes the masked panel at the
    similarity kernel's tile, kernel 2 selects; the kernels take n up to
    MAX_N = 512, the replay kernel's bound) at the routing path's n = N
    and at LARGE_N, at RETRIEVE_BUCKETS over C_EXPECTED rows of D = DIM
    (DEAD_ROWS dead, duplicates on tile boundaries and the queries that
    tie on them): kernel 1's panel equal to the similarity kernel's masked
    panel at the plan's tile and within SIM_TOL of the plain one; kernel 2
    equal to its plain version (the select, `ref.topn_select_ref`) and to
    one stable sort of kernel 1's own panel, bit for bit, and to the plain
    version's top-n but at near-ties; the capacity-sharded retrieve at S =
    SHARDS_LARGE_N on the card equal to `ref.sharded_panel_topn_ref` bit
    for bit (rows, scores, hits, the pre-gathered records). Controls at
    bucket 1024, each of which must change the top-n rows: kernel 2 over
    the panel without its last DROP_COLS columns; the sharded retrieve
    without the last shard; kernel 2 built with TOPN_CONTROL_TIE_HIGH
    over a row copied n + 5 times. Each kernel timed (queued) beside its
    bound, its plain version and the library call (normalize + matmul +
    topk; torch.topk over the panel); the pair and the S = 4 composite
    beside the similarity kernel alone and the panel + stable sort."""
    from functools import partial
    from unittest import mock
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import retrieve_topn as RT
    from repro_torch.kernels.similarity_topk import similarity_cuda
    gen = torch.Generator(device=dev).manual_seed(7)
    db0 = torch.randn((C_EXPECTED, DIM), generator=gen, device=dev)
    recs = (torch.randint(0, M, (C_EXPECTED, R), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randint(0, M, (C_EXPECTED, R), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand((C_EXPECTED, R), generator=gen, device=dev),
            torch.rand((C_EXPECTED, R), generator=gen, device=dev) < 0.8)
    live = C_EXPECTED - DEAD_ROWS
    size = torch.tensor(live, dtype=torch.int32, device=dev)
    sizes = [size] * SHARDS_LARGE_N
    panels = tuple(_shards(x, SHARDS_LARGE_N) for x in recs)
    norm = torch.nn.functional.normalize
    library = _build.library

    def tie_high(name, defines=()):
        return library(name, TIE_CONTROL if name == "retrieve_topn"
                       else defines)
    out = {}
    for n in (N,) + LARGE_N:
        for nq in RETRIEVE_BUCKETS:
            tile, route = RT.plan(nq, C_EXPECTED, DIM, n=n)
            where = f"retrieve n={n} Q={nq}"
            if route != RT.PANEL:
                fail(f"{where}: the plan takes the {route} route")
            ties = [1024 * i for i in range(1, 5)]
            db = db0.clone()
            for b in ties:
                db[b] = db[b - 1]
            q = torch.randn((nq, DIM), generator=gen, device=dev)
            k = min(nq, len(ties))
            q[:k] = db[[b - 1 for b in ties[:k]]]
            emb = _shards(db, SHARDS_LARGE_N)
            # the similarity kernel at kernel 1's tile: across tiles scores
            # may differ in the last place
            sim = partial(similarity_cuda, tile=tile)
            panel = RT.retrieve_topn_cuda(q, db, size)
            top = RT.topn_merge_cuda(panel, None, n)
            sharded = RT.sharded_topn_cuda(q, emb, panels, sizes, n)
            want_panel = ref.mask_dead(sim(q, db), 0, size)
            panel_top = ref.stable_topk(panel, n)
            want_top = ref.topn_select_ref(panel, None, n)[:3]
            passes = int(ref.key_select_ref(panel, None, n)[1].sum())
            want_sh = ref.sharded_panel_topn_ref(q, emb, panels, sizes, n,
                                                 similarity_fn=sim)
            plain_panel = ref.panel_ref(q, db, size)
            plain_top = ref.stable_topk(plain_panel, n)
            alive = torch.isfinite(plain_panel)
            err = float((panel - plain_panel)[alive].abs().max())
            torch.cuda.synchronize()
            if not torch.equal(panel, want_panel):
                fail(f"{where}: the panel differs from the similarity "
                     "kernel's masked panel")
            if not err <= SIM_TOL:
                fail(f"{where}: the panel is {err} from the plain one")
            if not all(torch.equal(x, y) for x, y in zip(top, want_top)):
                fail(f"{where}: topn_merge differs from its plain version")
            if not (torch.equal(top[0], panel_top[0])
                    and torch.equal(top[1], panel_top[1])):
                fail(f"{where}: the top-n differs from the stable sort of "
                     "kernel 1's panel")
            differ, untied = topk_rows_agree(top[1], plain_top[1],
                                             plain_panel, n, SIM_TOL)
            if untied:
                fail(f"{where}: the top-n differs from the plain version "
                     f"on {untied} rows without a near-tie")
            if not all(torch.equal(x, y) for x, y in
                       zip(sharded[:3] + sharded[3], want_sh[:3]
                           + want_sh[3])):
                fail(f"{where}: the S={SHARDS_LARGE_N} retrieve differs "
                     "from the sharded panel + stable sort")
            del want_panel, want_top, want_sh, sharded, plain_panel, alive
            del plain_top
            ctl = {}
            if nq == RETRIEVE_BUCKETS[0]:
                dropped = RT.topn_merge_cuda(panel[:, :-DROP_COLS], None,
                                             n)[1]
                ctl["cols_dropped"] = float(
                    (dropped != panel_top[1]).any(dim=1).float().mean())
                fewer = RT.sharded_topn_cuda(
                    q, emb[:-1], tuple(x[:-1] for x in panels), sizes[:-1],
                    n)[1]
                ctl["shard_dropped"] = float(
                    (fewer != panel_top[1]).any(dim=1).float().mean())
                dup = db.clone()
                dup[100:100 + n + 5] = dup[99]   # rows 99..n+104 tie
                qd = dup[99].expand(nq, DIM).contiguous()
                with mock.patch.object(_build, "library", tie_high):
                    high = RT.topn_cuda(qd, dup, size, n)[1]
                ctl["tie_high"] = float(
                    (high != torch.arange(99, 99 + n, device=dev))
                    .any(dim=1).float().mean())
                torch.cuda.synchronize()
                if ctl["cols_dropped"] < 0.2 or ctl["shard_dropped"] < 0.2 \
                        or ctl["tie_high"] < 1.0:
                    fail(f"{where}: a control did not change the top-n "
                         f"rows: shares {ctl}")
            iters = 10 if nq >= 256 else 30
            k1_ms = queued_ms(lambda: RT.retrieve_topn_cuda(q, db, size),
                              iters)
            k2_ms = queued_ms(lambda: RT.topn_merge_cuda(panel, None, n),
                              iters)
            pair_ms = queued_ms(lambda: RT.topn_cuda(q, db, size, n), iters)
            s4_ms = queued_ms(lambda: RT.sharded_topn_cuda(
                q, emb, panels, sizes, n), iters)
            sim_ms = queued_ms(lambda: sim(q, db), iters)
            panel_ms = queued_ms(lambda: ref.panel_topn_ref(
                q, db, size, n, similarity_fn=sim), 10)
            plain1 = cuda_ms(lambda: ref.panel_ref(q, db, size), 2,
                             warmup=1)
            plain2 = cuda_ms(lambda: ref.topn_select_ref(panel, None, n), 2,
                             warmup=1)
            lib1 = queued_ms(lambda: torch.topk(
                torch.matmul(norm(q, dim=-1), norm(db, dim=-1).T), n,
                dim=-1), 10)
            lib2 = queued_ms(lambda: torch.topk(panel, n, dim=-1), iters)
            (b1, by1), (b2, by2) = retrieve_bound(nq, C_EXPECTED, DIM, n,
                                                  passes)
            log_time(stats,
                     f"{where} C={C_EXPECTED} D={DIM} (tile {tile}, "
                     f"{passes / nq} radix passes a row, {live} live rows): "
                     f"panel, top-n and S={SHARDS_LARGE_N} equal to the "
                     f"panel + stable sort; panel max abs err {err} from the"
                     f" plain one, top-n rows differing from the plain "
                     f"version's at near-ties {differ}; controls (share of "
                     f"rows changed) {ctl}; retrieve_topn (the panel) ms "
                     f"{k1_ms} (queued) bound {b1} ({by1}, {b1 / k1_ms} of "
                     f"it) plain {plain1} library (normalize + matmul + "
                     f"topk) {lib1}; topn_merge (the select, k={n}) ms "
                     f"{k2_ms} bound {b2} ({by2}, {b2 / k2_ms} of it) plain "
                     f"{plain2} library (topk over the panel) {lib2}; the "
                     f"pair {pair_ms}, S={SHARDS_LARGE_N} {s4_ms}, the "
                     f"similarity kernel alone {sim_ms}, the panel + stable"
                     f" sort {panel_ms}")
            out[f"n{n} q{nq}"] = dict(
                n=n, q=nq, tile=tile, route=route, passes=passes,
                max_abs_err=err, topk_rows_near_tie=differ, controls=ctl,
                retrieve_topn_ms=k1_ms, retrieve_topn_bound_ms=b1,
                retrieve_topn_plain_ms=plain1,
                retrieve_topn_library_ms=lib1, topn_merge_ms=k2_ms,
                topn_merge_bound_ms=b2, topn_merge_plain_ms=plain2,
                topn_merge_library_ms=lib2, pair_ms=pair_ms,
                sharded_ms=s4_ms, similarity_ms=sim_ms,
                panel_sort_ms=panel_ms)
            if nq == RETRIEVE_BUCKETS[0] and n in (N, LARGE_N[-1]):
                src = "src/repro_torch/kernels/csrc/retrieve_topn.cu"
                k1, k2 = ("retrieve_topn", "topn_merge") if n == N else (
                    "retrieve_topn n512", "topn_merge k512")
                kernels[k1] = dict(
                    name=k1, route="cuda", source=src,
                    replaces="src/repro/kernels/similarity_topk.py:42",
                    max_abs_err=err, ms=k1_ms, queued_ms=k1_ms,
                    plain_ms=plain1, bound_ms=b1, bound_by=by1,
                    library_ms=lib1)
                kernels[k2] = dict(
                    name=k2, route="cuda", source=src,
                    replaces="src/repro/kernels/similarity_topk.py:91",
                    max_abs_err=0.0, ms=k2_ms, queued_ms=k2_ms,
                    plain_ms=plain2, bound_ms=b2, bound_by=by2,
                    library_ms=lib2)
            del q, db, emb, panel, top, panel_top
    stats["retrieve"] = out


def route_large_n(dev, corpus, fb, stats):
    """An EagleRouter(n_neighbors = MAX_N) at the paper's width, fitted on
    the corpus, routed through a RouteDispatcher's graphs at buckets 8, 64
    and 1024 (warmed first): no capture by traffic, each batch's choices
    equal to the eager route's and to the panel route's (the similarity
    kernel's panel at the route's tile + stable sort) bit for bit; and a
    router or dispatcher
    of MAX_N + 1 neighbours raises when it is built. Returns the launches
    of the routed run."""
    import dataclasses
    from functools import partial
    from repro_torch import graphs
    from repro_torch.configs.eagle import PAPER_CONFIG
    from repro_torch.core.dispatch import RouteDispatcher
    from repro_torch.core.router import EagleRouter
    from repro_torch.kernels import _build
    from repro_torch.kernels import retrieve_topn as RT
    from repro_torch.kernels.retrieve_topn import MAX_N
    from repro_torch.kernels.similarity_topk import similarity_cuda
    cfg = dataclasses.replace(PAPER_CONFIG, n_neighbors=MAX_N)
    router = EagleRouter(corpus.model_names, corpus.costs, cfg, device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
               query_id=fb["query_idx"])
    disp = RouteDispatcher.for_router(router)
    st = router.state
    torch.cuda.synchronize()
    pool_gb = [graph_pool_gb()]
    warmed = disp.warmup(st, LARGE_N_BATCHES)
    torch.cuda.synchronize()
    pool_gb.append(graph_pool_gb())
    rng = np.random.default_rng(9)
    embs = np.asarray(corpus.embeddings[corpus.test_idx], np.float32)
    batches = []
    for nb in LARGE_N_BATCHES:
        i = rng.integers(0, len(embs), nb)
        batches.append((embs[i], rng.uniform(
            corpus.costs.min(), corpus.costs.max(), nb).astype(np.float32)))
    torch.cuda.synchronize()
    c0, led0 = graphs.capture_count(), disp.cache_stats()
    _build.reset_launches()
    got = [disp.route(st, q, b) for q, b in batches]
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    led = disp.cache_stats()
    captured = graphs.capture_count() - c0
    traffic = led["misses"] - led0["misses"]
    differ = sum(int((g != eager_route(disp, st, q, b)).sum())
                 + int((g != panel_eager_route(disp, st, q, b, partial(
                     similarity_cuda, tile=RT.tile_for(
                         disp.bucket(len(q)), DIM)))).sum())
                 for g, (q, b) in zip(got, batches))
    refused = []
    for make in (lambda: EagleRouter(
            corpus.model_names, corpus.costs,
            dataclasses.replace(cfg, n_neighbors=MAX_N + 1), device=dev),
            lambda: RouteDispatcher(router.costs, n_neighbors=MAX_N + 1)):
        try:
            make()
        except ValueError as e:
            refused.append(str(e))
    log(f"EagleRouter(n_neighbors={MAX_N}) at D={DIM}, C="
        f"{router.db.capacity}: {warmed} route graphs warmed (graph pools "
        f"{pool_gb[0]:.3f} -> {pool_gb[1]:.3f} GB), batches "
        f"{LARGE_N_BATCHES} routed through them with {captured} captures "
        f"({traffic} by traffic), launches {launches}; choices differing "
        f"from the eager route and the panel route {differ}; "
        f"n_neighbors={MAX_N + 1} refused: {refused}")
    stats["route_large_n"] = dict(warmed=warmed, pool_gb=pool_gb,
                                  captured=captured,
                                  traffic_captures=traffic,
                                  launches=launches, differ=differ,
                                  refused=refused)
    if captured or traffic or differ or len(refused) != 2 or not all(
            str(MAX_N) in e for e in refused) or not all(
            launches[k] == len(batches) for k in ("retrieve_topn",
                                                    "topn_merge",
                                                    "elo_scan_select")):
        fail(f"the route at n = {MAX_N}: {stats['route_large_n']}")
    return launches

def replay_inputs(dev, gen, nq, t):
    a = torch.randint(0, M, (nq, t), generator=gen, device=dev,
                      dtype=torch.int32)
    b = (a + torch.randint(1, M, (nq, t), generator=gen, device=dev,
                           dtype=torch.int32)) % M
    s = torch.randint(0, 3, (nq, t), generator=gen, device=dev).float() / 2
    v = torch.rand((nq, t), generator=gen, device=dev) < 0.8
    r0 = 1000 + 50 * torch.randn((nq, M), generator=gen, device=dev)
    return r0, a.int(), b.int(), s, v


def check_select(dev, nq, stats):
    """elo_scan_select at Q queries x T = N * R pre-gathered records
    against the plain version (R_RTOL / R_ATOL; choices equal except at
    ties), timed. Returns (inputs, entry)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.elo_scan import elo_scan_select_cuda
    gen = torch.Generator(device=dev).manual_seed(1)
    t = N * R                        # N neighbours x R records
    r0, a, b, s, v = replay_inputs(dev, gen, nq, t)
    g = 1000 + 30 * torch.randn((M,), generator=gen, device=dev)
    costs = 0.5 + 40 * torch.rand((M,), generator=gen, device=dev)
    bud = 45 * torch.rand((nq,), generator=gen, device=dev)
    args = (r0, a, b, s, v, g, costs, bud)
    got_r, got_c = elo_scan_select_cuda(*args, p=P)
    want_r, want_c = ref.elo_scan_select_ref(*args, p=P)
    torch.cuda.synchronize()
    err = float((got_r - want_r).abs().max())
    if not torch.allclose(got_r, want_r, rtol=R_RTOL, atol=R_ATOL):
        fail(f"elo_scan_select Q={nq} ratings: max abs err {err}")
    comb = P * g[None] + (1 - P) * want_r
    comb = torch.where(costs[None] <= bud[:, None], comb,
                       torch.full_like(comb, float("-inf")))
    differ, untied = choices_agree(got_c, want_c, comb)
    if untied:
        fail(f"elo_scan_select Q={nq}: {untied} choices differ without a "
             "tie")
    ms = queued_ms(lambda: elo_scan_select_cuda(*args, p=P), 50)
    call = cuda_ms(lambda: elo_scan_select_cuda(*args, p=P), 200)
    plain = cuda_ms(lambda: ref.elo_scan_select_ref(*args, p=P), 3,
                    warmup=1)
    # each input read once, each output written once; the valid steps
    nbytes = nq * t * (4 + 4 + 4 + 1) + nq * M * 4 * 2 + nq * 4 * 2 \
        + 2 * M * 4
    bms, by = bound_ms(nbytes, int(v.sum()) * REPLAY_STEP_OPS + nq * M * 3)
    log_time(stats,
             f"elo_scan_select Q={nq} T={t} M={M} (pre-gathered records): "
             f"max_abs_err={err} choices differing at ties={differ} "
             f"kernel_ms={ms} (device, queued; {ms * 1e6 / t} ns a step) "
             f"call_ms={call} (back-to-back calls) plain_ms={plain} "
             f"bound_ms={bms} ({by})")
    entry = dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                 bound_ms=bms, bound_by=by,
                 choices_differing_at_ties=differ)
    stats[f"elo_scan_select_q{nq}"] = entry
    return args, entry


def fold_log(dev, records, n_valid=None, pad=True):
    """A global fold's record log as `core/elo.py` runs it: padded to its
    pow-2 bucket (floor 64) with valid = step < T, on the card, each
    (1, T_bucket). `n_valid` < T marks the records from it on invalid
    (the control drops the last one); pad=False leaves the log at T."""
    a, b, s = (np.asarray(x) for x in records)
    t = len(a)
    tb = 64 if pad else t
    while tb < t:
        tb *= 2

    def padded(x, dtype):
        return torch.tensor(np.pad(np.asarray(x, dtype), (0, tb - t)),
                            device=dev)[None]
    v = torch.arange(tb, device=dev)[None] < (t if n_valid is None
                                              else n_valid)
    return (padded(a, np.int32), padded(b, np.int32),
            padded(s, np.float32), v)


def check_fit_fold(dev, kernels, stats, fold_records):
    """The fit's global fold at its real shape (Q = 1, the fit's whole
    record log, padded), held against host folds of the plain formula in
    float32 and float64 (`ref.elo_fold_host`): the kernel must lie no
    farther from the float64 fold than max(2 x the float32 fold's
    distance, R_ATOL + R_RTOL |r|), model by model, and a control (the
    same log with its last record invalid) must miss that bar by
    CONTROL_MIN. Timed beside its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.elo_scan import elo_scan_cuda
    a, b, s = (np.asarray(x) for x in fold_records)
    t = len(a)
    rec = fold_log(dev, fold_records)
    ctl_rec = fold_log(dev, fold_records, n_valid=t - 1)
    g0 = torch.full((1, M), 1000.0, device=dev)
    got = elo_scan_cuda(g0, *rec)[0].cpu().numpy()
    ctl = elo_scan_cuda(g0, *ctl_rec)[0].cpu().numpy()
    host, host_s = {}, {}
    for name, dtype in (("float32", np.float32), ("float64", np.float64)):
        t0 = time.perf_counter()
        host[name] = ref.elo_fold_host(np.full(M, 1000.0), a, b, s,
                                       np.ones(t, bool), dtype=dtype)
        host_s[name] = time.perf_counter() - t0
    r64 = host["float64"]
    bar = np.maximum(2 * np.abs(host["float32"] - r64),
                     R_ATOL + R_RTOL * np.abs(r64))

    def over(r):
        return float(np.max(np.abs(np.asarray(r, np.float64) - r64) / bar))
    ratio, ctl_ratio = over(got), over(ctl)
    if not ratio <= 1.0:
        fail(f"fit fold T={t}: {ratio} times its bar from the float64 fold")
    if not ctl_ratio >= CONTROL_MIN:
        fail(f"fit fold: the control without the last record is only "
             f"{ctl_ratio} times the bar (at least {CONTROL_MIN})")
    ms = queued_ms(lambda: elo_scan_cuda(g0, *rec), 5)
    unpadded = fold_log(dev, fold_records, pad=False)
    ms_unpadded = queued_ms(lambda: elo_scan_cuda(g0, *unpadded), 5)
    tb = rec[0].shape[1]
    bms, by = bound_ms(tb * 13 + 2 * M * 4, t * REPLAY_STEP_OPS)
    dist = {"float32 host": float(np.max(np.abs(host["float32"] - r64))),
            "kernel": float(np.max(np.abs(got - r64)))}
    log_time(stats,
             f"elo_scan fit fold Q=1 T={tb} ({t} valid, the fit's own log): "
             f"kernel_ms={ms} (device, queued; {ms * 1e6 / t} ns a valid "
             f"step; the same {t} records unpadded {ms_unpadded} ms) "
             f"bound_ms={bms} "
             f"({by}); max distance from the float64 host fold {dist}, "
             f"over the bar {ratio} (at most 1), control without the last "
             f"record {ctl_ratio} (at least {CONTROL_MIN}); host folds s "
             f"{host_s}")
    # the plain version on the same log, once (a Python loop of ~15
    # launches a step: about a minute)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref.elo_scan_ref(g0, *rec)[0]
    end.record()
    torch.cuda.synchronize()
    plain = start.elapsed_time(end)
    err = float((torch.tensor(got, device=dev) - want).abs().max())
    log_time(stats, f"elo_scan fit fold: plain_ms={plain} (one run), the "
             f"kernel against it max_abs_err={err}")
    stats["elo_scan_fit_fold"] = dict(
        t=tb, valid=t, ms=ms, ns_per_valid_step=ms * 1e6 / t,
        unpadded_ms=ms_unpadded, bound_ms=bms, bound_by=by,
        distance_from_float64=dist, err_over_bar=ratio,
        control_over_bar=ctl_ratio, host_fold_s=host_s, plain_ms=plain,
        max_abs_err=err)
    kernels["elo_scan fit fold"] = dict(
        name="elo_scan fit fold", route="cuda",
        source="src/repro_torch/kernels/csrc/elo_scan.cu",
        replaces="src/repro/kernels/elo_scan.py:157", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)


def check_fused(dev, kernels, stats, size):
    """The routing path's replay: the gather route (records read in place
    through top-n rows) at buckets 1024 and 8, held bit for bit against
    the gather glue + pre-gathered kernel on the same inputs and against
    the plain version (R_RTOL / R_ATOL, choices except at ties), each
    timed. The top-n rows are drawn from the `size` live rows of a
    C_EXPECTED-row DB."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.elo_scan import (elo_scan_gather_select_cuda,
                                              elo_scan_select_cuda)
    gen = torch.Generator(device=dev).manual_seed(4)
    _, pa, pb, ps, pv = replay_inputs(dev, gen, C_EXPECTED, R)
    panels = (pa, pb, ps, pv)
    g = 1000 + 30 * torch.randn((M,), generator=gen, device=dev)
    costs = 0.5 + 40 * torch.rand((M,), generator=gen, device=dev)
    for nq in (1024, 8):
        top_i = torch.randint(0, size, (nq, N), generator=gen, device=dev)
        hit = torch.ones((nq, N), dtype=torch.bool, device=dev)
        bud = 45 * torch.rand((nq,), generator=gen, device=dev)
        sel = (g, costs, bud)

        def fused():
            return elo_scan_gather_select_cuda(g, panels, top_i, hit, *sel,
                                               p=P)

        def unfused():
            recs = ref.gather_records(*panels, top_i, hit)
            return elo_scan_select_cuda(g.expand(nq, M), *recs, *sel, p=P)
        got, two = fused(), unfused()
        want = ref.elo_scan_gather_select_ref(g, panels, top_i, hit, *sel,
                                              p=P)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])):
            fail(f"gather route Q={nq}: differs from the pre-gathered "
                 "kernel on the same records")
        err = float((got[0] - want[0]).abs().max())
        if not torch.allclose(got[0], want[0], rtol=R_RTOL, atol=R_ATOL):
            fail(f"gather route Q={nq}: max abs err {err}")
        comb = P * g[None] + (1 - P) * want[0]
        comb = torch.where(costs[None] <= bud[:, None], comb,
                           torch.full_like(comb, float("-inf")))
        differ, untied = choices_agree(got[1], want[1], comb)
        if untied:
            fail(f"gather route Q={nq}: {untied} choices differ without a "
                 "tie")
        ms, unfused_q = queued_ms(fused, 50), queued_ms(unfused, 50)
        call, unfused_call = cuda_ms(fused, 200), cuda_ms(unfused, 200)
        plain = cuda_ms(lambda: ref.elo_scan_gather_select_ref(
            g, panels, top_i, hit, *sel, p=P), 3, warmup=1)
        rows = torch.unique(top_i[hit]).numel()
        t = N * R
        valid = int(pv[top_i].logical_and(hit[..., None]).sum())
        nbytes = rows * R * 13 + nq * N * 9 + nq * M * 4 + nq * 4 * 2 \
            + 3 * M * 4
        bms, by = bound_ms(nbytes, valid * REPLAY_STEP_OPS + nq * M * 3)
        log_time(stats,
                 f"elo_scan_select gather route Q={nq} n={N} R={R} M={M}: "
                 f"equal to gather + pre-gathered kernel; max_abs_err={err} "
                 f"choices differing at ties={differ} kernel_ms={ms} "
                 f"(device, queued; {ms * 1e6 / t} ns a step) against "
                 f"{unfused_q} for gather + pre-gathered kernel; a call "
                 f"{call} against {unfused_call} ms; plain_ms={plain} "
                 f"bound_ms={bms} ({by})")
        entry = dict(max_abs_err=err, ms=ms, unfused_ms=unfused_q,
                     call_ms=call,
                     unfused_call_ms=unfused_call, plain_ms=plain,
                     bound_ms=bms, bound_by=by,
                     choices_differing_at_ties=differ)
        stats[f"elo_scan_gather_select_q{nq}"] = entry
        if nq == 1024:
            kernels["elo_scan_select"] = dict(
                name="elo_scan_select", route="cuda",
                source="src/repro_torch/kernels/csrc/elo_scan.cu",
                replaces="src/repro/kernels/elo_scan.py:124",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)
    check_route_retrieve(dev, stats, panels, g, costs, size)


def panel_route_fn(g, costs, bud, shards):
    """The panel route on the card: the retrieve as the similarity kernel's
    masked panel and a stable sort (per shard, then a stable-sort merge,
    when `shards`), then the same replay kernel as the kernel route. Takes
    the route's (q, emb, a, b, s, v, size, prior) and n."""
    from functools import partial
    from repro_torch.kernels import ref
    from repro_torch.kernels.elo_scan import (elo_scan_gather_select_cuda,
                                              elo_scan_select_cuda)
    from repro_torch.kernels.similarity_topk import similarity_cuda
    if shards:
        replay = partial(elo_scan_select_cuda, global_ratings=g, costs=costs,
                         budgets=bud, p=P)
        return partial(ref.sharded_retrieve_replay_pipeline, partial(
            ref.sharded_panel_topn_ref, similarity_fn=similarity_cuda),
            replay)
    replay = partial(elo_scan_gather_select_cuda, global_ratings=g,
                     costs=costs, budgets=bud, p=P)
    return partial(ref.retrieve_replay_pipeline, partial(
        ref.panel_topn_ref, similarity_fn=similarity_cuda), replay)


def check_route_retrieve(dev, stats, panels, g, costs, size):
    """The route's retrieve + replay (`retrieve_replay_select_cuda`: the
    fused retrieve's two kernels and the gather replay) at
    RETRIEVE_BUCKETS over a C_EXPECTED-row DB with `size` live rows, the
    tie queries first: equal bit for bit (top-n rows and scores, ratings,
    choices) to the panel route on the same inputs, and to the plain
    version but at near-ties (top-n rows) and score ties (choices)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.retrieve_replay import \
        retrieve_replay_select_cuda
    gen = torch.Generator(device=dev).manual_seed(6)
    db = torch.randn((C_EXPECTED, DIM), generator=gen, device=dev)
    ties = [C_EXPECTED * i // 8 for i in range(1, 6)]   # split and shard
    for b in ties:
        db[b] = db[b - 1]
    live = torch.tensor(size, dtype=torch.int32, device=dev)
    out = {}
    for nq in RETRIEVE_BUCKETS:
        q = torch.randn((nq, DIM), generator=gen, device=dev)
        k = min(nq, len(ties))
        q[:k] = db[[b - 1 for b in ties[:k]]]
        bud = 45 * torch.rand((nq,), generator=gen, device=dev)
        args = (q, db, *panels, live, g, g, costs, bud)
        got = retrieve_replay_select_cuda(*args, n=N, p=P)
        panel = panel_route_fn(g, costs, bud, 0)(*args[:8], n=N)
        want = ref.retrieve_replay_select_ref(*args, n=N, p=P)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, panel)):
            fail(f"route Q={nq}: differs from the panel route on the same "
                 "inputs")
        plain_panel = ref.mask_dead(ref.similarity_ref(q, db), 0, live)
        t_differ, t_untied = topk_rows_agree(got[1], want[1], plain_panel,
                                             N, SIM_TOL)
        del plain_panel
        same = (got[1] == want[1]).all(dim=1)
        err = float((got[0][same] - want[0][same]).abs().max())
        comb = P * g[None] + (1 - P) * want[0]
        comb = torch.where(costs[None] <= bud[:, None], comb,
                           torch.full_like(comb, float("-inf")))
        c_differ, c_untied = choices_agree(got[3][same], want[3][same],
                                           comb[same])
        if t_untied or c_untied or not torch.allclose(
                got[0][same], want[0][same], rtol=R_RTOL, atol=R_ATOL):
            fail(f"route Q={nq} against the plain version: {t_untied} top-n "
                 f"rows and {c_untied} choices differ without a tie, "
                 f"ratings max abs err {err}")
        log(f"route Q={nq} (fused retrieve + gather replay): equal to the "
            f"panel route bit for bit; against the plain version top-n rows "
            f"differing at near-ties {t_differ}, choices at ties {c_differ},"
            f" ratings max abs err {err}")
        out[nq] = dict(topk_near_ties=t_differ, choices_at_ties=c_differ,
                       max_abs_err=err)
    stats["route_retrieve"] = out


def check_replay(dev, kernels, stats, fold_records):
    """Every route of the replay kernel at the shapes the path gives it:
    the select epilogue over pre-gathered records at Q = 1024 and 8, the
    plain replay at Q = 1024, the fit's fold (prefix and whole), the
    online fold and the gather route."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.elo_scan import elo_scan_cuda
    select_args, _ = check_select(dev, 1024, stats)
    check_select(dev, 8, stats)

    # the replay without the epilogue, at the same shape
    r0, a, b, s, v = select_args[:5]
    nq, t = a.shape
    got = elo_scan_cuda(r0, a, b, s, v)
    want = ref.elo_scan_ref(r0, a, b, s, v)
    torch.cuda.synchronize()
    err_local = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=R_RTOL, atol=R_ATOL):
        fail(f"elo_scan Q={nq}: max abs err {err_local}")
    ms_local = queued_ms(lambda: elo_scan_cuda(r0, a, b, s, v), 50)
    plain_local = cuda_ms(lambda: ref.elo_scan_ref(r0, a, b, s, v), 3,
                          warmup=1)
    bms_local, by_local = bound_ms(nq * t * (4 + 4 + 4 + 1) + nq * M * 4 * 2,
                                   int(v.sum()) * REPLAY_STEP_OPS)
    log_time(stats,
             f"elo_scan Q={nq} T={t} M={M}: max_abs_err={err_local} "
             f"kernel_ms={ms_local} (device, queued) plain_ms={plain_local} "
             f"bound_ms={bms_local} ({by_local})")
    stats["elo_scan_q1024"] = dict(max_abs_err=err_local, ms=ms_local,
                                   plain_ms=plain_local, bound_ms=bms_local,
                                   bound_by=by_local)

    # the global fold: Q = 1 over a prefix of the fit's record log
    fa, fb_, fs = (torch.tensor(x[:16384], device=dev) for x in fold_records)
    fv = torch.ones_like(fs, dtype=torch.bool)
    g0 = torch.full((1, M), 1000.0, device=dev)
    fold = [x[None] for x in (fa, fb_, fs, fv)]
    got = elo_scan_cuda(g0, *fold)
    want = ref.elo_scan_ref(g0, *fold)
    torch.cuda.synchronize()
    err_fold = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=R_RTOL, atol=R_ATOL):
        fail(f"elo_scan global fold: max abs err {err_fold}")
    log(f"elo_scan global fold Q=1 T=16384: max_abs_err={err_fold}")
    stats["elo_scan_fold16384_err"] = err_fold
    check_fit_fold(dev, kernels, stats, fold_records)

    # timed at the online update's shape: a 400-record fold, padded to 512
    t_up = 512
    ua, ub, us = (x[:, :t_up].contiguous() for x in fold[:3])
    uv = torch.arange(t_up, device=dev)[None] < 400
    ms_up = queued_ms(lambda: elo_scan_cuda(g0, ua, ub, us, uv), 50)
    call_up = cuda_ms(lambda: elo_scan_cuda(g0, ua, ub, us, uv), 200)
    plain_up = cuda_ms(lambda: ref.elo_scan_ref(g0, ua, ub, us, uv), 3,
                       warmup=1)
    nbytes = t_up * 13 + 2 * M * 4
    bms, by = bound_ms(nbytes, 400 * REPLAY_STEP_OPS)
    log_time(stats,
             f"elo_scan Q=1 T={t_up} (online fold, 400 valid): kernel_ms="
             f"{ms_up} (device, queued; {ms_up * 1e6 / 400} ns a valid step) "
             f"call_ms={call_up} plain_ms={plain_up} bound_ms={bms} ({by})")
    stats["elo_scan_fold512"] = dict(ms=ms_up, call_ms=call_up,
                                     plain_ms=plain_up, bound_ms=bms,
                                     bound_by=by)
    kernels["elo_scan"] = dict(
        name="elo_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/elo_scan.cu",
        replaces="src/repro/kernels/elo_scan.py:157",
        max_abs_err=max(err_local, err_fold), ms=ms_up, plain_ms=plain_up,
        bound_ms=bms, bound_by=by, library_ms=None)
    check_fused(dev, kernels, stats, len(fold_records[0]) // PAIRS_PER_QUERY)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pregathered_selects():
    """Inside: a count (in the one-element list yielded) of the replay
    kernel's select launches over pre-gathered records, which the
    routing path must not make: its replays read their records in
    place."""
    from unittest import mock
    from repro_torch.kernels import elo_scan
    launch, count = elo_scan._launch, [0]

    def counted(*args, select, rows=None, **kw):
        count[0] += bool(select and rows is None)
        return launch(*args, select=select, rows=rows, **kw)
    with mock.patch.object(elo_scan, "_launch", counted):
        yield count


def graph_pool_gb():
    """Device memory held by CUDA graph memory pools in this process: the
    caching allocator's segments that belong to a private pool (the
    static inputs and states outside the graphs are not in them)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0)) / 1e9


def warm_both(disp, dbuf, router, batch_sizes=None) -> int:
    """Capture the dispatcher's route graphs on both replicas of the
    double buffer, each while it is the front (two commits: the same
    replica is the front after). Returns the number captured."""
    n = 0
    for _ in range(2):
        n += disp.warmup(dbuf.front, batch_sizes)
        dbuf.commit(router.global_ratings)
    return n


def eager_route(disp, state, q, budgets):
    """A dispatch without its graph, as the dispatcher ran before it kept
    graphs: each chunk padded to its bucket, pageable copies of the
    queries and budgets, route_batch_choices, one readout."""
    from repro_torch.core.state import route_batch_choices
    q = np.atleast_2d(np.asarray(q, np.float32))
    b = np.broadcast_to(np.asarray(budgets, np.float32),
                        (q.shape[0],)).astype(np.float32)
    out = []
    for lo, hi in disp._chunks(q.shape[0]) or [(0, 0)]:
        nq = hi - lo
        qb = disp.bucket(nq)
        qp = np.pad(q[lo:hi], ((0, qb - nq), (0, 0)))
        bp = np.pad(b[lo:hi], (0, qb - nq))
        res = route_batch_choices(state, torch.from_numpy(qp).to(state.device),
                                  torch.from_numpy(bp).to(state.device),
                                  disp.costs, **disp.kw)
        out.append(res.choices[:nq].cpu().numpy())
    return np.concatenate(out)


def drive_main_path(dev, corpus, fb, stats):
    from unittest import mock
    from repro_torch.configs.eagle import PAPER_CONFIG
    from repro_torch.core import elo
    from repro_torch.core.dispatch import RouteDispatcher, bucket_ladder
    from repro_torch.core.router import EagleRouter
    from repro_torch.core.state import DoubleBuffer
    from repro_torch.data.routerbench import (budget_grid, evaluate_router,
                                              pairwise_feedback)
    from repro_torch.kernels import _build

    router = EagleRouter(corpus.model_names, corpus.costs, PAPER_CONFIG,
                         device=dev)
    fit_global, fold_s, fold_launches = elo.fit_global, [], []

    def timed_fold(*args, **kw):     # fit()'s wall, split: the global fold
        n0 = _build.launch_counts()["elo_scan"]
        t0 = time.perf_counter()
        out = fit_global(*args, **kw)
        torch.cuda.synchronize()
        fold_s.append(time.perf_counter() - t0)
        fold_launches.append(_build.launch_counts()["elo_scan"] - n0)
        return out
    with mock.patch.object(elo, "fit_global", timed_fold):
        fit_s = router.fit(fb["emb"], fb["model_a"], fb["model_b"],
                           fb["outcome"], query_id=fb["query_idx"])
    db = router.db
    if (db.capacity, db.rcap, db.size) != (C_EXPECTED, R,
                                            len(corpus.train_idx)):
        fail(f"vector DB is C={db.capacity} R={db.rcap} size={db.size}")
    if not bool(torch.isfinite(router.global_ratings).all()):
        fail("global ratings are not finite after fit")
    log_time(stats,
             f"fit: {len(fb['model_a'])} records, C={db.capacity} R={db.rcap} "
             f"size={db.size}: {fit_s} s, of which the global fold "
             f"(padding, upload, kernel) {fold_s[0]} s and db.add "
             f"{fit_s - fold_s[0]} s")
    stats["fit_s"] = dict(wall=fit_s, fold=fold_s[0],
                          db_add=fit_s - fold_s[0])
    stats["fit_fold_launches"] = fold_launches[0]

    t0 = time.perf_counter()
    dbuf = DoubleBuffer(db, router.global_ratings, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    disp = RouteDispatcher.for_router(router)
    t0 = time.perf_counter()
    warmed = warm_both(disp, dbuf, router)
    warm_s = time.perf_counter() - t0
    pool_gb = graph_pool_gb()
    log_time(stats,
             f"double buffer upload {upload_s:.3f} s; warmup: {warmed} route "
             f"graphs (buckets {bucket_ladder()} x 2 replicas) captured in "
             f"{warm_s:.3f} s (capture seconds "
             f"{disp.cache_stats()['compile_s']:.3f}); their memory pool "
             f"{pool_gb:.3f} GB")
    stats["route_graphs"] = dict(warmed=warmed, warm_s=warm_s,
                                 pool_gb=pool_gb)

    # ragged routing of the test split at several budgets
    rng = np.random.default_rng(0)
    test = corpus.embeddings[corpus.test_idx]
    grid = budget_grid(corpus.costs)
    routed, t0 = 0, time.perf_counter()
    for budget in grid[::5]:
        lo = 0
        while lo < len(test):
            hi = min(len(test), lo + int(rng.integers(1, 1500)))
            ch = disp.route(dbuf.front, test[lo:hi], float(budget))
            if ch.shape != (hi - lo,) or ch.min() < 0 or ch.max() >= M:
                fail(f"route returned {ch.shape} choices in "
                     f"[{ch.min()}, {ch.max()}]")
            routed += hi - lo
            lo = hi
    route_s = time.perf_counter() - t0
    log_time(stats,
             f"ragged routing: {routed} queries in {route_s:.3f} s = "
             f"{routed / route_s:.1f} queries/s")
    stats["routed_queries_per_s"] = routed / route_s

    auc = evaluate_router(lambda e, b: disp.route(dbuf.front, e, b),
                          corpus)["auc"]
    if not 0.0 < auc <= 1.0:
        fail(f"AUC {auc}")
    log(f"AUC over the {len(grid)}-budget grid, test split, after fit: "
        f"{auc}")
    stats["auc_after_fit"] = auc

    # online feedback: new prompts from the test split, 8 pairs each
    fed = corpus.test_idx[:FEEDBACK_ROUNDS * FEEDBACK_PROMPTS]
    new = pairwise_feedback(corpus, fed, seed=1,
                            pairs_per_query=PAIRS_PER_QUERY)
    update_s, commit_s = [], []
    per = FEEDBACK_PROMPTS * PAIRS_PER_QUERY
    for rnd in range(FEEDBACK_ROUNDS):
        sl = slice(rnd * per, (rnd + 1) * per)
        update_s.append(router.update(
            new["emb"][sl], new["model_a"][sl], new["model_b"][sl],
            new["outcome"][sl],
            query_id=new["query_idx"][sl]))
        t0 = time.perf_counter()
        front = dbuf.commit(router.global_ratings)
        torch.cuda.synchronize()
        commit_s.append(time.perf_counter() - t0)
        ch = disp.route(front, test[:1024], float(grid[10]))
        if ch.shape != (len(test[:1024]),):
            fail("routing after commit")
    if int(dbuf.front.size) != db.size:
        fail(f"front replica holds {int(dbuf.front.size)} rows, the DB "
             f"{db.size}")
    log_time(stats,
             f"feedback rounds: update s {update_s}; commit s {commit_s}")
    stats["update_s"], stats["commit_s"] = update_s, commit_s
    held_out = corpus.test_idx[FEEDBACK_ROUNDS * FEEDBACK_PROMPTS:]
    auc2 = evaluate_router(lambda e, b: disp.route(dbuf.front, e, b),
                           corpus, idx=held_out)["auc"]
    log(f"AUC after feedback, test queries not fed back: {auc2}")
    stats["auc_after_feedback_held_out"] = auc2
    return router, disp, dbuf, test, grid


def route_vs_plain(router, st, q, bud, where):
    """route_batch over `st` through the kernels and through the plain
    versions, both on the card: top-n rows equal but at near-ties,
    choices (where the rows agree) but at score ties, scores within
    R_RTOL / R_ATOL. Returns (choices differing, of which at score
    ties, rows differing at near-ties)."""
    from repro_torch.core.state import route_batch
    from repro_torch.kernels import ref
    kw = router._kw()
    kw.pop("backend")
    got = route_batch(st, q, bud, router.costs, backend="cuda", **kw)
    want = route_batch(st, q, bud, router.costs, backend="reference", **kw)
    torch.cuda.synchronize()
    panel = ref.mask_dead(ref.similarity_ref(q, st.emb), 0, st.size)
    t_differ, t_untied = topk_rows_agree(got.topk_idx, want.topk_idx, panel,
                                         N, SIM_TOL)
    del panel
    if t_untied:
        fail(f"{where}: top-{N} differs on {t_untied} rows without a tie")
    same = (got.topk_idx == want.topk_idx).all(dim=1)
    comb = torch.where(router.costs[None] <= bud[:, None], want.scores,
                       torch.full_like(want.scores, float("-inf")))
    c_differ, c_untied = choices_agree(got.choices[same], want.choices[same],
                                       comb[same])
    if c_untied:
        fail(f"{where}: {c_untied} choices differ without a tie")
    if not torch.allclose(got.scores[same], want.scores[same], rtol=R_RTOL,
                          atol=R_ATOL):
        fail(f"{where}: scores differ")
    n_diff = int((got.choices.long() != want.choices.long()).sum())
    return n_diff, c_differ, t_differ


def compare_route(router, dbuf, test, grid, stats):
    """1024 queries through the kernels and through the plain versions,
    both on the card."""
    st = dbuf.front
    q = torch.tensor(test[:1024], device=st.device)
    bud = torch.linspace(float(grid[0]), float(grid[-1]), len(q),
                         device=st.device)
    n_diff, c_differ, t_differ = route_vs_plain(router, st, q, bud, "route")
    log(f"route {len(q)} queries, kernels vs plain on the card: {n_diff} "
        f"choices differ ({c_differ} at score ties, the rest on {t_differ} "
        f"rows whose retrieval met a near-tie)")
    stats["route_choices_differing"] = n_diff


def panel_eager_route(disp, state, q, budgets, similarity_fn=None):
    """eager_route with the panel route's retrieve (the similarity
    kernel's panel, or `similarity_fn`'s, and a stable sort) in place of
    the fused one."""
    from functools import partial
    from unittest import mock
    from repro_torch.kernels import ref, retrieve_replay
    from repro_torch.kernels.similarity_topk import similarity_cuda
    with mock.patch.object(retrieve_replay, "topn_cuda", partial(
            ref.panel_topn_ref,
            similarity_fn=similarity_fn or similarity_cuda)):
        return eager_route(disp, state, q, budgets)


def time_path(disp, dbuf, router, test, stats):
    from repro_torch.core import elo
    from repro_torch.core.dispatch import bucket_ladder
    st = dbuf.front
    budget = float(router.costs.max())
    p50 = {}
    for qb in bucket_ladder():
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            disp.route(st, test[:qb], budget)
            ts.append((time.perf_counter() - t0) * 1e3)
        p50[qb] = statistics.median(ts)
    eager = {}
    for qb in ROUTE_P50_EAGER:
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            eager_route(disp, st, test[:qb], budget)
            ts.append((time.perf_counter() - t0) * 1e3)
        eager[qb] = statistics.median(ts)
    log_time(stats,
             f"route p50 ms per bucket through the graphs: {p50}; without "
             f"them (eager): {eager}")
    stats["route_p50_ms"], stats["route_p50_eager_ms"] = p50, eager
    rng = np.random.default_rng(5)
    a = rng.integers(0, M, 400).astype(np.int32)
    b = ((a + rng.integers(1, M, 400)) % M).astype(np.int32)
    s = rng.choice([0.0, 0.5, 1.0], 400).astype(np.float32)
    ts = []
    for _ in range(11):
        t0 = time.perf_counter()
        elo.update_global(router.global_ratings, a, b, s)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    log_time(stats,
             f"update_global 400-record fold p50 ms: {statistics.median(ts)}")
    stats["update_global_400_p50_ms"] = statistics.median(ts)


def profile_route(disp, dbuf, router, test, stats):
    """Where a route's time goes: device time by kernel over 5 routes per
    bucket under torch.profiler, and the device's busy share of the wall
    time (the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    st = dbuf.front
    budget = float(router.costs.max())
    stats["profile"] = {}
    for qb in (8, 1024):
        q = test[:qb]
        disp.route(st, q, budget)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                disp.route(st, q, budget)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 5
        # device-side events only: a host op (aten::sort) also reports
        # the time of the kernels it launched
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / 5)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        device_ms = sum(ms for _, ms in rows)
        top = [(name[:60], ms) for name, ms in rows[:8]]
        check_route_names({name for name, _ in rows}, f"bucket {qb}")
        log_time(stats,
                 f"profile bucket {qb}: wall {wall_ms} ms/route, device "
                 f"{device_ms} ms/route, busy {device_ms / wall_ms}; "
                 f"top: {top}")
        stats["profile"][qb] = dict(wall_ms=wall_ms, device_ms=device_ms,
                                    top=top)
    names = route_device_names(lambda: eager_route(disp, st, test[:1024],
                                                   budget))
    log(f"eager route at bucket 1024: device work {sorted(names)}")
    stats["profile"]["eager_names"] = sorted(names)


def check_route_names(names, where):
    """A route's device work must be the retrieve's two kernels, the
    replay and copies: no similarity panel, no sort, no glue."""
    other = sorted(n for n in names if not n.startswith(("Memcpy", "Memset"))
                   and not any(k in n for k in ROUTE_PROFILE_KERNELS))
    if other:
        fail(f"route {where}: device work besides the retrieve, the replay "
             f"and copies: {other}")


def route_device_names(fn):
    """The names of the device work of one fn() under torch.profiler
    (after a warm-up call), checked by check_route_names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0}
    if not any(k in n for n in names for k in ROUTE_PROFILE_KERNELS):
        fail(f"the profiler saw no route kernel: {sorted(names)}")
    check_route_names(names, "under the profiler")
    return names


def drive_route_graphs(router, disp, dbuf, corpus, stats):
    """The graph phase of the routing path: GRAPH_ROUNDS ragged batches
    (1..1499 queries, budgets from the grid) through the warmed
    dispatcher, each followed by GRAPH_FEED new prompts of feedback and
    a commit, so that both replicas serve and the DB grows (C_EXPECTED ->
    2 C_EXPECTED). After each commit the new front is warmed: only a
    grown replica (new tensors, a new key) captures there, as the JAX
    package's prebaker compiles the next capacity off the route. Every
    batch's choices must equal the eager route's on the same state; no
    capture may come from traffic (cache_stats: misses - warmed), and
    the process-wide capture count must equal the warmups' captures.
    Then a second grow: one prompt with R + 1 records doubles the
    records per prompt, and each replica is warmed and routed as it
    becomes the front. The cache must then hold the graphs of the two
    live replicas only (the four freed ones' evicted with their pools);
    the pool is reported after each grow."""
    from repro_torch import graphs
    from repro_torch.core.dispatch import bucket_ladder, replica
    from repro_torch.data.routerbench import budget_grid, pairwise_feedback
    rng = np.random.default_rng(7)
    test = corpus.embeddings[corpus.test_idx]
    grid = budget_grid(corpus.costs)
    lo = FEEDBACK_ROUNDS * FEEDBACK_PROMPTS
    new = pairwise_feedback(
        corpus, corpus.test_idx[lo:lo + GRAPH_ROUNDS * GRAPH_FEED], seed=2,
        pairs_per_query=PAIRS_PER_QUERY)
    per = GRAPH_FEED * PAIRS_PER_QUERY
    st0, c0 = disp.cache_stats(), graphs.capture_count()
    warm_caps, replicas, grew, routed, differ = 0, set(), [], 0, 0
    panel_differ, plain_differ = 0, [0, 0, 0]
    dev = dbuf.front.device
    wall = 0.0
    for rnd in range(GRAPH_ROUNDS):
        front = dbuf.front
        replicas.add(replica(front))
        nq = int(rng.integers(1, 1500))
        start = int(rng.integers(0, len(test) - nq))
        q = test[start:start + nq]
        b = rng.choice(grid, nq).astype(np.float32)
        t0 = time.perf_counter()
        got = disp.route(front, q, b)
        wall += time.perf_counter() - t0
        differ += int((got != eager_route(disp, front, q, b)).sum())
        panel_differ += int((got != panel_eager_route(disp, front, q,
                                                      b)).sum())
        plain = route_vs_plain(router, front, torch.tensor(q, device=dev),
                               torch.tensor(b, device=dev),
                               f"graph phase round {rnd}")
        plain_differ = [x + y for x, y in zip(plain_differ, plain)]
        routed += nq
        sl = slice(rnd * per, (rnd + 1) * per)
        router.update(new["emb"][sl], new["model_a"][sl],
                      new["model_b"][sl], new["outcome"][sl],
                      query_id=new["query_idx"][sl])
        dbuf.commit(router.global_ratings)
        if dbuf.front.capacity != front.capacity:
            grew.append(rnd)
        warm_caps += disp.warmup(dbuf.front)
    pool_gb = [graph_pool_gb()]
    del front

    def routed_front():                       # one checked batch
        nq = int(rng.integers(1, 1500))
        q, b = test[:nq], rng.choice(grid, nq).astype(np.float32)
        got = disp.route(dbuf.front, q, b)
        return nq, int((got != eager_route(disp, dbuf.front, q, b)).sum())
    r0 = router.db.rcap
    router.update(np.repeat(test[:1], r0 + 1, axis=0),
                  np.zeros(r0 + 1, np.int32), np.ones(r0 + 1, np.int32),
                  np.ones(r0 + 1, np.float32),
                  query_id=np.full(r0 + 1, 1 << 40))
    for _ in range(2):
        dbuf.commit(router.global_ratings)
        replicas.add(replica(dbuf.front))
        warm_caps += disp.warmup(dbuf.front)
        n, d = routed_front()
        routed, differ = routed + n, differ + d
    pool_gb.append(graph_pool_gb())
    st = disp.cache_stats()
    traffic = (st["misses"] - st0["misses"]) - (st["warmed"] - st0["warmed"])
    captures = graphs.capture_count() - c0
    live = {replica(dbuf.front), replica(dbuf._back[0])}
    ladder = len(bucket_ladder(disp.min_bucket, disp.max_bucket))
    evicted = disp.telemetry()["cache_evicted"]
    log_time(stats,
             f"graph phase: {GRAPH_ROUNDS} ragged batches, {routed} queries "
             f"({routed / wall:.1f} queries/s through the graphs), feedback "
             f"of {GRAPH_FEED} prompts and a commit after each; replicas "
             f"routed {len(replicas)}; the DB grew to "
             f"{router.db.capacity} rows at rounds {grew}; captures by the "
             f"warmups after commits {warm_caps}, by traffic {traffic}, "
             f"process-wide {captures}; choices differing from the eager "
             f"route {differ}, from the panel route {panel_differ}, from the "
             f"plain version (eager; differing, at score ties, top-n rows "
             f"at near-ties) {plain_differ}; then a second grow (records "
             f"per prompt "
             f"{r0} -> {router.db.rcap}); ledger "
             f"{dict(st, keys=len(st['keys']))}, evicted {evicted}; the "
             f"route graphs' pool after the first grow {pool_gb[0]:.3f} GB, "
             f"after the second {pool_gb[1]:.3f} GB")
    stats["route_graph_phase"] = dict(
        routed=routed, queries_per_s=routed / wall, replicas=len(replicas),
        grew_at=grew, warm_captures=warm_caps, traffic_captures=traffic,
        captures=captures, choices_differing=differ,
        panel_route_differing=panel_differ, plain_differing=plain_differ,
        pool_gb=pool_gb,
        evicted=evicted, records_per_prompt=[r0, router.db.rcap],
        ledger={k: v for k, v in st.items() if k != "keys"})
    if differ or panel_differ:
        fail(f"graph phase: {differ} choices differ from the eager route, "
             f"{panel_differ} from the panel route")
    if traffic or captures != warm_caps:
        fail(f"graph phase: {traffic} captures by traffic, {captures} in "
             f"the process against {warm_caps} by the warmups")
    # the front's capacity changes once: the second replica grows while
    # the first grown one is the front
    if len(grew) != 1 or router.db.capacity != 2 * C_EXPECTED \
            or router.db.rcap != 2 * r0 or len(replicas) != 6:
        fail(f"graph phase: the front grew at rounds {grew} to "
             f"{router.db.capacity} rows of {router.db.rcap} records, "
             f"{len(replicas)} replicas routed")
    if {k[-1] for k in st["keys"]} != live or st["entries"] != 2 * ladder \
            or evicted != 4 * ladder:
        fail(f"graph phase: {st['entries']} graphs cached over "
             f"{len({k[-1] for k in st['keys']})} replicas ({evicted} "
             f"evicted): the freed replicas' graphs were not evicted")


# ---------------------------------------------------------------------------
# phase 5b: the capacity-sharded route, its commit and the prebaker
# ---------------------------------------------------------------------------

def tie_embeddings(fb, first_row, rows):
    """fb's record embeddings, where the prompt that lands on each row of
    `rows` (prompts take rows in their first appearance, from
    `first_row`) carries the embedding of the prompt before it: equal
    scores on the two sides of a shard boundary."""
    qis = fb["query_idx"]
    _, first = np.unique(qis, return_index=True)
    order = qis[np.sort(first)]
    emb = fb["emb"].copy()
    for row in rows:
        k = row - first_row
        if 0 < k < len(order):
            emb[qis == order[k]] = emb[qis == order[k - 1]][0]
    return emb


def shard_routes_equal(disp, sst, base_route, q, grid, rng, where):
    """Choices and topk_idx of the sharded dispatcher's route over `sst`
    against `base_route(q, b)` (the unsharded kernel route) at
    SHARD_BUCKETS_CHECKED, full and ragged, the tie queries first.
    Returns the rows compared; fails on any difference."""
    rows = 0
    for qb in SHARD_BUCKETS_CHECKED:
        for nq in (qb, qb // 2 + 1):
            b = rng.choice(grid, nq).astype(np.float32)
            ch, top = disp.route_result(sst, q[:nq], b)
            want_ch, want_top = base_route(q[:nq], b)
            bad = int((ch != want_ch).sum()) + int(
                (top != want_top).any(axis=1).sum())
            if bad:
                fail(f"{where}: bucket {qb} ({nq} queries): {bad} choices "
                     "or top-n rows differ from the unsharded route")
            rows += nq
    return rows


def base_route_fn(disp, state):
    """The unsharded kernel route over `state`, choices and top-n rows:
    through the dispatcher's graph when it has one for the bucket, else
    without one (eager_route's padding)."""
    from repro_torch.core.state import route_batch_choices

    def run(q, b):
        if disp._key(state, disp.bucket(len(q))) in disp._cache.entries:
            return disp.route_result(state, q, b)
        qb = disp.bucket(len(q))
        qp = torch.zeros((qb, q.shape[1]), device=state.device)
        qp[:len(q)] = torch.from_numpy(q).to(state.device)
        bp = torch.zeros((qb,), device=state.device)
        bp[:len(q)] = torch.from_numpy(b).to(state.device)
        res = route_batch_choices(state, qp, bp, disp.costs, **disp.kw)
        return (res.choices[:len(q)].cpu().numpy(),
                res.topk_idx[:len(q)].cpu().numpy())
    return run


def replicas_equal(base_buf, bufs):
    """Fields of each sharded replica (shards concatenated) against the
    unsharded replica at the same turn, bit for bit. Returns the fields
    that differ."""
    from repro_torch.sharding import DB_SHARDED
    bad = []
    for s, buf in bufs.items():
        for want, got in ((base_buf.front, buf.front),
                          (base_buf._back[0], buf._back[0])):
            for f in DB_SHARDED:
                if not torch.equal(getattr(want, f),
                                   torch.cat(getattr(got, f))):
                    bad.append((s, f))
            if not (torch.equal(want.global_ratings, got.global_ratings[0])
                    and int(want.size) == int(got.size[0])):
                bad.append((s, "ratings/size"))
    return bad


def check_sharded_kernel(dev, sst, kernels, stats, q, grid, costs, g):
    """The composite at S = len(sst.emb) shards (per shard the fused
    retrieve's two kernels, then the merge kernel and the replay kernel
    on the leader) at bucket 1024 against the panel route on the same
    inputs (per shard the similarity kernel's panel and a stable sort,
    the merge by a stable sort, the same replay kernel) bit for bit, and
    against its plain version: top-n rows equal but at near-ties, choices
    but at score ties, ratings within R_RTOL / R_ATOL. Timed by CUDA
    events over back-to-back calls and over calls queued ahead
    (`queued_ms`), beside the panel route, the plain version, the bound
    (the product's operations plus the replay's bytes) and the library
    chain (per shard normalize + matmul + torch.topk(n), then torch.topk
    over the pool). The kernels line takes the largest S."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.retrieve_replay import \
        sharded_retrieve_replay_select_cuda
    nq, s = len(q), len(sst.emb)
    qt = torch.tensor(q, device=dev)
    bud = torch.tensor(np.resize(grid, nq).astype(np.float32), device=dev)
    args = (qt, sst.emb, sst.model_a, sst.model_b, sst.outcome, sst.valid,
            sst.size, g, g, costs, bud)
    panel_route = panel_route_fn(g, costs, bud, s)

    def composite():
        return sharded_retrieve_replay_select_cuda(*args, n=N, p=P)
    got, panel = composite(), panel_route(*args[:8], n=N)
    want = ref.sharded_retrieve_replay_select_ref(*args, n=N, p=P)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, panel)):
        fail(f"sharded composite S={s}: differs from the panel route on the "
             "same inputs")
    whole = ref.similarity_ref(qt, torch.cat(sst.emb))
    whole[:, int(sst.size[0]):] = float("-inf")
    t_differ, t_untied = topk_rows_agree(got[1], want[1], whole, N, SIM_TOL)
    del whole
    if t_untied:
        fail(f"sharded composite S={s}: top-{N} differs on {t_untied} rows "
             "without a near-tie")
    same = (got[1] == want[1]).all(dim=1)
    err = float((got[0][same] - want[0][same]).abs().max())
    if not torch.allclose(got[0][same], want[0][same], rtol=R_RTOL,
                          atol=R_ATOL):
        fail(f"sharded composite S={s}: ratings max abs err {err}")
    comb = P * g[None] + (1 - P) * want[0]
    comb = torch.where(costs[None] <= bud[:, None], comb,
                       torch.full_like(comb, float("-inf")))
    c_differ, c_untied = choices_agree(got[3][same], want[3][same],
                                       comb[same])
    if c_untied:
        fail(f"sharded composite S={s}: {c_untied} choices differ without "
             "a tie")
    norm = torch.nn.functional.normalize
    c_l = sst.shard_rows

    def chain():
        parts = [torch.topk(torch.matmul(norm(qt, dim=-1),
                                         norm(e, dim=-1).T),
                            min(N, c_l), dim=-1) for e in sst.emb]
        top, pos = torch.topk(torch.cat([v for v, _ in parts], 1), N, dim=-1)
        rows = torch.cat([i + j * c_l for j, (_, i) in enumerate(parts)], 1)
        return top, torch.gather(rows, 1, pos)
    # queued runs: the panel route launches ~85 kernels a run at S = 4,
    # and a stream holds ~1000 ahead of the device
    ms = cuda_ms(composite, 10)
    queued = queued_ms(composite, 10)
    panel_ms = cuda_ms(lambda: panel_route(*args[:8], n=N), 10)
    panel_queued = queued_ms(lambda: panel_route(*args[:8], n=N), 5)
    plain = cuda_ms(lambda: ref.sharded_retrieve_replay_select_ref(
        *args, n=N, p=P), 3, warmup=1)
    lib = cuda_ms(chain, 10)
    c, t = sst.capacity, N * sst.records_per_query
    pool = len(sst.emb) * min(N, c_l)
    sim_b = bound_ms(4.0 * (nq * DIM + c * DIM) + 8.0 * nq * pool,
                     2.0 * nq * c * DIM + 2.0 * (nq + c) * DIM)[0]
    rep_b = bound_ms(nq * t * (4 + 4 + 4 + 1) + nq * M * 4 * 2 + nq * 8,
                     nq * t * REPLAY_STEP_OPS)[0]
    log_time(stats,
             f"sharded composite S={s} Q={nq} C={c} (C/S={c_l}) D={DIM}: "
             f"equal to the panel route bit for bit; against the plain "
             f"version max_abs_err={err} top-n rows differing at "
             f"near-ties={t_differ} choices at ties={c_differ}; "
             f"kernel_ms={ms} (back-to-back calls; queued {queued}) against "
             f"the panel route {panel_ms} (queued {panel_queued}); "
             f"plain_ms={plain} library_ms={lib} (per shard normalize + "
             f"matmul + topk, then topk over the pool) bound_ms="
             f"{sim_b + rep_b} (retrieve {sim_b} by operations + replay "
             f"{rep_b})")
    stats.setdefault("sharded_composite", {})[s] = dict(
        nq=nq, capacity=c, max_abs_err=err, ms=ms, queued_ms=queued,
        panel_route_ms=panel_ms, panel_route_queued_ms=panel_queued,
        plain_ms=plain, library_ms=lib, bound_ms=sim_b + rep_b,
        topk_near_ties=t_differ, choices_at_ties=c_differ)
    if s == max(SHARDS):
        kernels["sharded_retrieve_replay_select"] = dict(
            name="sharded_retrieve_replay_select", route="cuda",
            source="src/repro_torch/kernels/retrieve_replay.py",
            replaces="src/repro/kernels/retrieve_replay.py:75",
            max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain,
            bound_ms=sim_b + rep_b, bound_by="operations", library_ms=lib)


def route_p50(fn, reps=10):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def drive_sharded(dev, corpus, fb, kernels, stats):
    """The capacity-sharded route at the paper's width (D = 1536, N = 20,
    M = 10, R = 8) over its own router, fitted from the main path's
    records with duplicate prompts at rows C/4 and C/2 (and 3C/4 through
    the first feedback round): on meshes of 1, 2 and 4 shards on the
    card beside the unsharded route, each behind its DoubleBuffer and
    dispatcher, warmed (SHARD_WARM) with each mesh's captures under the
    call-site label "shards S". Checks each shard's similarity panel
    against its plain version and the unsharded kernel's columns; then,
    in the counted run, routes at SHARD_BUCKETS_CHECKED equal to the
    unsharded route (choices and topk_idx), route p50 per bucket,
    SHARD_ROUNDS feedback rounds with commits into every replica and
    the replicas equal to the unsharded ones bit for bit, no capture
    after the warmups. Then the control (the merge without the last
    shard's candidates must change topk_idx on at least CONTROL_SHARE of
    the rows at S = 2), the composite against its plain version, and
    the prebaker over the 2-shard mesh across the grow C_EXPECTED ->
    2 C_EXPECTED with no hand warmup. Returns the launch counts of the
    counted run."""
    from unittest import mock
    from repro_torch import graphs
    from repro_torch.configs.eagle import PAPER_CONFIG
    from repro_torch.core.dispatch import (CapacityPrebaker, RouteDispatcher,
                                           replica)
    from repro_torch.core.router import EagleRouter
    from repro_torch.core.state import (DoubleBuffer,
                                        route_batch_choices_sharded)
    from repro_torch.data.routerbench import budget_grid, pairwise_feedback
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import retrieve_topn as RT
    from repro_torch.kernels.similarity_topk import similarity_cuda
    from repro_torch.launch.mesh import make_db_mesh
    ties = [C_EXPECTED // 4, C_EXPECTED // 2, 3 * C_EXPECTED // 4]
    router = EagleRouter(corpus.model_names, corpus.costs, PAPER_CONFIG,
                         device=dev)
    router.fit(tie_embeddings(fb, 0, ties), fb["model_a"], fb["model_b"],
               fb["outcome"], query_id=fb["query_idx"])
    db = router.db
    rng = np.random.default_rng(11)
    grid = budget_grid(corpus.costs)
    test = corpus.embeddings[corpus.test_idx]
    base_buf = DoubleBuffer(db, router.global_ratings, device=dev,
                            tags=("flat_a", "flat_b"))
    base = RouteDispatcher.for_router(router)
    meshes = {s: make_db_mesh(s, [dev] * s) for s in SHARDS}
    bufs = {s: DoubleBuffer(db, router.global_ratings, mesh=meshes[s],
                            tags=(f"s{s}_a", f"s{s}_b")) for s in SHARDS}
    disps = {s: RouteDispatcher.for_router(router, mesh=meshes[s])
             for s in SHARDS}

    # each shard's similarity kernel against its plain version, and
    # against the unsharded kernel's columns (the bit-identity's root)
    qt = torch.tensor(test[:1024], device=dev)
    full = similarity_cuda(qt, base_buf.front.emb)
    panels = {}
    for s, buf in bufs.items():
        errs, unequal = [], 0
        for c, emb in enumerate(buf.front.emb):
            got = similarity_cuda(qt, emb)
            want = ref.similarity_ref(qt, emb)
            errs.append(float((got - want).abs().max()))
            lo = c * buf.front.shard_rows
            unequal += int((got != full[:, lo:lo + emb.shape[0]]).sum())
        panels[s] = dict(max_abs_err=errs, unequal_to_unsharded=unequal)
        if max(errs) > SIM_TOL or unequal:
            fail(f"sharded similarity S={s}: max abs err {errs}, "
                 f"{unequal} scores unlike the unsharded kernel's")
    del full
    log(f"sharded similarity at Q=1024, C={C_EXPECTED}, D={DIM} per shard: "
        f"{panels}")

    # warmups: the unsharded route at the checked buckets, each mesh at
    # SHARD_WARM[s]; every select launch of a sharded capture goes over
    # pre-gathered records, none of the unsharded's
    t0 = time.perf_counter()
    with pregathered_selects() as pre:
        warmed = {"flat": warm_both(base, base_buf, router,
                                    SHARD_BUCKETS_CHECKED)}
        flat_pre = pre[0]
        for s in SHARDS:
            with _build.site(f"shards {s}"):
                warmed[s] = warm_both(disps[s], bufs[s], router,
                                      SHARD_WARM[s])
    warm_s = time.perf_counter() - t0
    if flat_pre or pre[0] == 0:
        fail(f"sharded warmups: {flat_pre} pre-gathered selects in the "
             f"unsharded route's, {pre[0]} in all")
    pool_gb = graph_pool_gb()
    log_time(stats, f"sharded phase warmup: route graphs {warmed} captured "
             f"in {warm_s:.2f} s; graph pools {pool_gb:.2f} GB")

    # the counted run
    _build.reset_launches()
    c0 = graphs.capture_count()
    led0 = {s: d.cache_stats() for s, d in disps.items()}

    def queries():
        """The tie queries (the rows before each duplicated boundary row
        that is live), then test queries."""
        live = [row for row in ties if row < db.size]
        q = test[rng.integers(0, len(test), 1024)].copy()
        k = len(live)
        q[:k] = db.emb[[row - 1 for row in live]]
        return q, k
    checked, p50, n_ties = 0, {}, 0
    q, n_ties = queries()
    for s in SHARDS:
        checked += shard_routes_equal(
            disps[s], bufs[s].front, base_route_fn(base, base_buf.front), q,
            grid, rng, f"S={s} before feedback")
    budget = float(router.costs.max())
    for qb in SHARD_BUCKETS_CHECKED:
        p50[qb] = {"flat": route_p50(lambda: base.route(
            base_buf.front, test[:qb], budget))}
        for s in SHARDS:
            p50[qb][s] = route_p50(lambda: disps[s].route(
                bufs[s].front, test[:qb], budget))
    def feed(rnd):
        """Round `rnd`: SHARD_FEED new prompts of the test split, 8 pairs
        each, the one landing on a boundary row of `ties` a duplicate."""
        new = pairwise_feedback(
            corpus, corpus.test_idx[rnd * SHARD_FEED:(rnd + 1) * SHARD_FEED],
            seed=3 + rnd, pairs_per_query=PAIRS_PER_QUERY)
        router.update(tie_embeddings(new, db.size, ties), new["model_a"],
                      new["model_b"], new["outcome"],
                      query_id=new["query_idx"])
    for rnd in range(SHARD_ROUNDS):
        feed(rnd)
        base_buf.commit(router.global_ratings)
        for s in SHARDS:
            bufs[s].commit(router.global_ratings)
        q, n_ties = queries()
        for s in SHARDS:
            checked += shard_routes_equal(
                disps[s], bufs[s].front, base_route_fn(base, base_buf.front),
                q, grid, rng, f"S={s} after feedback round {rnd}")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    sites = site_launches()
    per_shard = {s: {k: _build.site_counts().get((k, f"shards {s}"), 0)
                     for k in ("retrieve_topn", "topn_merge",
                               "elo_scan_select")}
                 for s in SHARDS}
    captured = graphs.capture_count() - c0
    traffic = {s: (d.cache_stats()["misses"] - led0[s]["misses"])
               for s, d in disps.items()}
    differ = replicas_equal(base_buf, bufs)
    log_time(stats,
             f"sharded route, counted run: {checked} rows at buckets "
             f"{SHARD_BUCKETS_CHECKED} (the {n_ties} tie queries first) "
             f"equal to the unsharded route at S = {SHARDS}, over "
             f"{SHARD_ROUNDS} feedback rounds of {SHARD_FEED} prompts (DB "
             f"{db.size} rows of {db.capacity}); route p50 ms per bucket "
             f"(unsharded, then S) {p50}; replicas differing from the "
             f"unsharded ones {differ}; captures after warmup {captured}, "
             f"by traffic per S {traffic}; launches {counts}, by site "
             f"{sites}; the sharded routes' (retrieve, merge, select) per S "
             f"{per_shard}")
    if differ:
        fail(f"sharded replicas differ from the unsharded ones: {differ}")
    if captured or any(traffic.values()):
        fail(f"sharded route: {captured} captures after warmup, by "
             f"traffic {traffic}")
    missing = [(k, s) for s, n in per_shard.items() for k, c in n.items()
               if not c]
    if missing:
        fail(f"sharded route: never launched {missing}")
    stats["sharded"] = dict(rows_checked=checked, tie_queries=n_ties,
                            panels=panels, warmed=warmed, warm_s=warm_s,
                            pool_gb=pool_gb, route_p50_ms=p50,
                            captured=captured, launches=counts,
                            sites=sites, per_shard=per_shard)

    # the control: the merge kernel over the first shard's candidates only
    merge = RT.merge_shards_cuda

    def drop_last(pool_s, pool_i, records, n):
        kl = pool_s.shape[1] // 2
        return merge(pool_s[:, :kl], pool_i[:, :kl],
                     tuple(x[:, :kl] for x in records), n)
    st2 = bufs[2].front
    bud = np.resize(grid, 1024).astype(np.float32)
    want_top = base_route_fn(base, base_buf.front)(q, bud)[1]
    with mock.patch.object(RT, "merge_shards_cuda", drop_last):
        ctl = route_batch_choices_sharded(st2, torch.tensor(q, device=dev),
                                          torch.tensor(bud, device=dev),
                                          router.costs, **disps[2].kw)
    share = float((ctl.topk_idx.cpu().numpy() != want_top).any(axis=1).mean())
    log(f"control (S=2, the merge without shard 1's candidates): top-n "
        f"rows differ on {share:.4f} of 1024 queries (bar: at least "
        f"{CONTROL_SHARE})")
    if share < CONTROL_SHARE:
        fail(f"sharded control: only {share} of the rows changed")
    stats["sharded"]["control_share"] = share

    for s in SHARDS:
        check_sharded_kernel(dev, bufs[s].front, kernels, stats, q, grid,
                             router.costs, bufs[s].front.global_ratings[0])
        qt1024 = torch.tensor(test[:1024], device=dev)
        bud1024 = torch.full((1024,), budget, device=dev)
        names = route_device_names(lambda: disps[s].route(
            bufs[s].front, test[:1024], budget))
        names |= route_device_names(lambda: route_batch_choices_sharded(
            bufs[s].front, qt1024, bud1024, router.costs, **disps[s].kw))
        stats["sharded"].setdefault("profile_names", {})[s] = sorted(names)
        log(f"sharded route S={s} at bucket 1024, through its graph and "
            f"eagerly: device work {sorted(names)}")
    # the composite's launches on the counted run, over every mesh: each
    # route two retrieve launches a shard, the merge and the select
    kernels["sharded_retrieve_replay_select"]["launches"] = sum(
        sum(n.values()) for n in per_shard.values())

    # the prebaker over S = 2 across the grow, with no hand warmup; the
    # other meshes go (memory), the unsharded replicas stay as reference
    del disps[1], disps[4], bufs[1], bufs[4], st2, ctl, qt
    torch.cuda.empty_cache()
    disp, buf = disps[2], bufs[2]
    prebaker = CapacityPrebaker(disp, db, dbuf=buf)
    c0 = graphs.capture_count()
    led0 = disp.cache_stats()
    polls, first_route, grown_fronts, rnd = [], None, [], SHARD_ROUNDS
    while len(grown_fronts) < 2:
        if rnd >= SHARD_ROUNDS + SHARD_GROW_ROUNDS:
            fail(f"prebaker: the DB did not grow past {C_EXPECTED} rows in "
                 f"{SHARD_GROW_ROUNDS} rounds ({db.size} rows)")
        nq = int(rng.integers(1, 1025))
        qq = test[rng.integers(0, len(test), nq)]
        b = rng.choice(grid, nq).astype(np.float32)
        ch, top = disp.route_result(buf.front, qq, b)
        want_ch, want_top = base_route_fn(base, base_buf.front)(qq, b)
        if (ch != want_ch).any() or (top != want_top).any():
            fail(f"prebaker round {rnd}: the sharded route differs from "
                 "the unsharded")
        feed(rnd)
        rnd += 1
        base_buf.commit(router.global_ratings)
        front = buf.commit(router.global_ratings)
        t0 = time.perf_counter()
        baked = prebaker.poll()
        polls.append(((time.perf_counter() - t0) * 1e3, baked))
        if front.capacity > C_EXPECTED:
            grown_fronts.append(replica(front))
            if first_route is None:    # the first route on a grown replica
                t0 = time.perf_counter()
                disp.route(front, test[:64], budget)
                first_route = (time.perf_counter() - t0) * 1e3
    del front
    torch.cuda.synchronize()
    q, n_ties = queries()
    rows = shard_routes_equal(disp, buf.front,
                              base_route_fn(base, base_buf.front), q, grid,
                              rng, f"S=2 at C={db.capacity}")
    led = disp.cache_stats()
    traffic = (led["misses"] - led0["misses"]) - \
        (led["warmed"] - led0["warmed"])
    captured = graphs.capture_count() - c0
    bake_s = prebaker._m_bake_s.value
    steady = {qb: route_p50(lambda: disp.route(buf.front, test[:qb],
                                               budget))
              for qb in SHARD_BUCKETS_CHECKED}
    prepared = set(prebaker.prepared.get(db.capacity, ()))
    log_time(stats,
             f"prebaker (S=2): {rnd - SHARD_ROUNDS} rounds to C="
             f"{db.capacity}; polls ms (stall, baked) "
             f"{[p for p in polls if p[1]]}, the others' max "
             f"{max(p[0] for p in polls if not p[1]):.3f} ms; bake "
             f"{bake_s:.3f} s for {led['warmed'] - led0['warmed']} graphs "
             f"({captured} captures in the process), by traffic "
             f"{traffic}; the grown fronts prebaked: "
             f"{[f in prepared for f in grown_fronts]}; the first route "
             f"on a grown replica (64 queries) {first_route:.3f} ms, steady "
             f"p50 after it {steady}; {rows} rows at C="
             f"{db.capacity} equal to the unsharded route; evicted "
             f"{disp.telemetry()['cache_evicted']}")
    stats["prebaker"] = dict(
        rounds=rnd - SHARD_ROUNDS, polls_ms=polls, bake_s=bake_s,
        graphs=led["warmed"] - led0["warmed"], captured=captured,
        traffic_captures=traffic,
        fronts_prebaked=[f in prepared for f in grown_fronts],
        first_route=first_route, steady_p50_ms=steady, rows_checked=rows,
        evicted=disp.telemetry()["cache_evicted"])
    if traffic or captured != led["warmed"] - led0["warmed"] or \
            not all(f in prepared for f in grown_fronts) or not bake_s:
        fail(f"prebaker: {traffic} captures by traffic, {captured} in the "
             f"process, fronts prebaked "
             f"{[f in prepared for f in grown_fronts]}")
    return counts


# ---------------------------------------------------------------------------
# phase 5c: the operational obs plane
# ---------------------------------------------------------------------------

class StubModel:
    """A fleet entry that answers zeros: routing and feedback do not read
    the tokens."""

    def generate(self, tokens, max_new):
        return np.zeros((tokens.shape[0], max_new), np.int32)


def drive_obs_plane(dev, corpus, fb, stats):
    """The operational plane at the paper's width (D = 1536, C = 32768,
    N = 20, K = 32, P = 0.5, the 10-model fleet) over a router of its
    own behind a DoubleBuffer and a RouteDispatcher sharing one enabled
    scope, with the quality monitor, the stock SLO rules and an exporter:

      1. the JAX quality gate on the freshly fitted router (the JAX
         gate's world: a fitted router, no feedback since): every step's
         score_batch equal to routing_regret_oracle bit for bit, no alert
         on the stationary run, one at least after a +400 step, as a
         quality_alert event and in a LogFileSink file;
      2. the JAX obs gate (OBS_STEPS ragged batches, a feedback commit
         every OBS_COMMIT_EVERY, off and on legs) with a thread scraping
         /metrics, /slo and /healthz throughout: paired-delta overhead at
         most OBS_MAX_OVERHEAD of the off-path p50, no capture after
         warmup, the Chrome trace, Prometheus text and decision JSONL
         parse with one route record per routed request, scrapes and no
         scrape error; then the overhead at OBS_BUCKETS (reported);
      3. captures beside a thread scraping all six routes: a fresh
         replica's route ladder (its choices equal to the eager route's),
         then a ServingEngine(prebake=True) with the launcher's plane
         across a DB grow (C_EXPECTED -> 2 C_EXPECTED): every capture
         succeeds, none by traffic, each batch's choices equal to the
         eager route's on the state it was routed on."""
    from benchmarks_torch import queue_bench as QB
    from benchmarks_torch import route_batch_bench as RB
    from repro_torch import graphs
    from repro_torch import obs as OBS
    from repro_torch.configs.eagle import PAPER_CONFIG
    from repro_torch.core.router import EagleRouter
    from repro_torch.core.state import commit
    from repro_torch.launch.serve import build_obs_plane, quality_oracle
    from repro_torch.obs.alerts import LogFileSink
    from repro_torch.obs.exporter import ROUTES, ObsExporter
    from repro_torch.obs.quality import RouterQualityMonitor
    from repro_torch.obs.slo import SLOEngine, default_serving_rules
    from repro_torch.serving import Request, ServingEngine
    t_phase = time.perf_counter()
    router = EagleRouter(corpus.model_names, corpus.costs, PAPER_CONFIG,
                         device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
               query_id=fb["query_idx"])
    ob = OBS.Observability(enabled=True, trace_capacity=8 * OBS_STEPS + 64,
                           event_capacity=1 << 20)
    # the gate's world (benchmarks_torch.route_batch_bench.RaggedWorld) at
    # the paper's width: its dispatcher (the whole ladder) and double
    # buffer share the enabled scope
    w = RB.RaggedWorld(router, corpus.embeddings, corpus.costs,
                       max_batch=OBS_MAX_BATCH, max_bucket=1024,
                       commit_every=OBS_COMMIT_EVERY, obs=ob,
                       tags=("obs_a", "obs_b"))
    disp, dbuf = w.dispatch, w.dbuf
    quality = RouterQualityMonitor.for_router(router, obs=ob)
    slo = SLOEngine(ob.registry, default_serving_rules(), obs=ob)
    exporter = ObsExporter(ob, slo=slo, quality=quality).start()
    sorted_costs = np.sort(w.costs)

    t0 = time.perf_counter()
    warmed = warm_both(disp, dbuf, router)
    warm_s = time.perf_counter() - t0

    # 1. the quality gate (benchmarks_torch.queue_bench.quality_gate), on
    # the freshly fitted router as in JAX
    qob = OBS.Observability(enabled=True)
    tmp = tempfile.TemporaryDirectory()
    alert_path = Path(tmp.name) / "alerts.jsonl"
    mon = RouterQualityMonitor.for_router(
        router, obs=qob, attach=False, sinks=[LogFileSink(alert_path)])
    gate_q = QB.quality_gate(lambda q, b: disp.route(dbuf.front, q, b), mon,
                             w.embs, w.bud_lo, w.bud_hi, steps=QUALITY_STEPS,
                             window=QUALITY_WINDOW,
                             fold_every=QUALITY_FOLD_EVERY)
    events = qob.events.records("quality_alert")
    sink_docs = [json.loads(ln) for ln in alert_path.read_text().splitlines()
                 ] if alert_path.exists() else []
    tmp.cleanup()
    snap = mon.snapshot()
    log(f"quality gate ({QUALITY_STEPS} routed windows of 1..{QUALITY_WINDOW}"
        f", {gate_q['requests_scored']} requests, a stationary fold every "
        f"{QUALITY_FOLD_EVERY}): regret unequal to the oracle on "
        f"{gate_q['oracle_mismatches']} steps; alerts on the stationary run "
        f"{gate_q['alerts_stationary']}, after the +400 step "
        f"{gate_q['alerts_after_perturbation']} (events {len(events)}, "
        f"alert-log lines {len(sink_docs)}: "
        f"{[d['payload'].get('alert') for d in sink_docs]}); regret mean "
        f"{snap['regret']['mean']:.3f} p99 {snap['regret']['p99']:.3f}; "
        f"{gate_q['wall_s']:.2f} s")
    stats["quality_gate"] = dict(gate_q, alert_events=len(events),
                                 alert_log_lines=len(sink_docs),
                                 regret=snap["regret"])
    errs = QB.quality_gate_errors(gate_q, len(events))
    if errs or not any(d["event"] == "quality_alert" for d in sink_docs):
        fail(f"quality gate: {errs}, alert log {sink_docs}")

    # 2. the obs gate (benchmarks_torch.route_batch_bench.obs_gate): the
    # world's warmup (two feedback commits; its graphs are warm), then
    # OBS_STEPS paired steps beside a scraper; then the buckets, reported
    t0 = time.perf_counter()
    led0 = disp.cache_stats()
    gate, scraper = RB.obs_gate(w, ob, quality, exporter, n_steps=OBS_STEPS,
                                out_dir=ROOT / "chiprun_out",
                                max_overhead=OBS_MAX_OVERHEAD)
    traffic = disp.cache_stats()["misses"] - led0["misses"]
    gate_s = time.perf_counter() - t0
    per_bucket = {}
    for qb in OBS_BUCKETS:
        off_b, on_b = [], []
        for step in range(OBS_BUCKET_STEPS):
            RB.obs_legs(ob, w, quality, sorted_costs, *w.next_batch(qb),
                        step, off_b, on_b, 0)
        per_bucket[qb] = RB.overhead(off_b, on_b)
    log_time(stats,
             f"obs gate ({OBS_STEPS} ragged batches of 1..{OBS_MAX_BATCH}, "
             f"a feedback commit every {OBS_COMMIT_EVERY}, the plane live: "
             f"spans, decision records, the quality monitor, an exporter "
             f"scraped every 0.25 s): route p50 off {gate['p50_off_us']:.1f}"
             f" us, on {gate['p50_on_us']:.1f} us, paired delta "
             f"{gate['paired_delta_us']:+.2f} us = "
             f"{gate['overhead_frac'] * 100:+.2f}% (bar "
             f"{OBS_MAX_OVERHEAD * 100:.0f}%); per bucket "
             f"{ {qb: round(v['overhead_frac'] * 100, 2) for qb, v in per_bucket.items()} }% "
             f"(p50 off us "
             f"{ {qb: round(v['p50_off_us'], 1) for qb, v in per_bucket.items()} }); "
             f"warmup {warmed} route graphs in {warm_s:.2f} s, captures "
             f"after it {gate['post_warmup_xla_compiles']} (by traffic "
             f"{traffic}); trace events {gate['trace_events']}, Prometheus "
             f"samples {gate['prometheus_samples']}, route records "
             f"{gate['decision_records']} ({gate['dumped_records']} dumped);"
             f" scrapes {scraper.stats()}; gate {gate_s:.2f} s")
    stats["obs_gate"] = dict(gate, per_bucket=per_bucket, warmed=warmed,
                             warm_s=warm_s, traffic_captures=traffic,
                             scrapes=scraper.stats(), loop_s=gate_s)
    errs = RB.obs_gate_errors(gate)
    if errs or traffic:
        fail(f"obs gate: {errs}, captures by traffic {traffic}")

    # 3a. a fresh replica's ladder captured beside a scraper of all routes
    fresh = commit(router.db, router.global_ratings, None,
                   consumer="obs_fresh", device=dev)
    with RB.Scraper(exporter, ROUTES, 0.001) as sc:
        c1 = graphs.capture_count()
        n_fresh = disp.warmup(fresh)
        caps_fresh = graphs.capture_count() - c1
        differ = 0
        for qb in OBS_BUCKETS:
            q, b = w.next_batch(qb)
            differ += int((disp.route(fresh, q, b)
                           != eager_route(disp, fresh, q, b)).sum())
    exporter.stop()
    fresh_scrapes = dict(scrapes=sc.scrapes, errors=sc.errors,
                         first_error=sc.first_error)
    log_time(stats,
             f"a fresh replica's ladder beside a scraper of {list(ROUTES)}: "
             f"{n_fresh} graphs captured ({caps_fresh} in the process), "
             f"choices differing from the eager route {differ}; scrapes "
             f"{fresh_scrapes}")
    if n_fresh != caps_fresh or not n_fresh or differ or not sc.scrapes \
            or sc.errors:
        fail(f"capture beside a scraper: {n_fresh} warmed, {caps_fresh} "
             f"captured, {differ} choices differ, scrapes {fresh_scrapes}")
    del disp, dbuf, fresh
    torch.cuda.empty_cache()

    # 3b. the prebaker's bake across a grow beside a scraper
    names = list(corpus.model_names)
    engine = ServingEngine({n: StubModel() for n in names}, router,
                           compare_rate=1.0, seed=0,
                           quality_oracle=quality_oracle,
                           obs=OBS.Observability(enabled=True),
                           warmup_batch_sizes=(PREBAKE_BATCH,),
                           prebake=True)
    plane = build_obs_plane(engine)
    c2, led0 = graphs.capture_count(), engine.dispatch.cache_stats()
    serve_ms, differ, grown_routes, rounds, requests = [], 0, 0, 0, 0
    with RB.Scraper(plane, ROUTES, 0.001) as sc2:
        while grown_routes < 2:
            if rounds >= PREBAKE_ROUNDS:
                fail(f"prebaker beside a scraper: the DB did not grow past "
                     f"{C_EXPECTED} rows in {rounds} rounds")
            q, b = w.next_batch(PREBAKE_BATCH)
            front = engine.dbuf.front
            grown_routes += front.capacity > C_EXPECTED
            want = eager_route(engine.dispatch, front, q, b)
            reqs = [Request(tokens=np.zeros(4, np.int32), embedding=e,
                            budget=float(x), max_new_tokens=1,
                            rid=requests + k)
                    for k, (e, x) in enumerate(zip(q, b))]
            t0 = time.perf_counter()
            res = engine.serve(reqs)
            serve_ms.append((time.perf_counter() - t0) * 1e3)
            differ += int((np.asarray([names.index(r.model) for r in res])
                           != want).sum())
            requests += len(reqs)
            rounds += 1
        del front
        with urllib.request.urlopen(plane.url("/quality"), timeout=30) as r:
            decisions = json.loads(r.read())["decisions"]
    plane.stop()
    led = engine.dispatch.cache_stats()
    traffic = (led["misses"] - led0["misses"]) - (led["warmed"]
                                                  - led0["warmed"])
    captured = graphs.capture_count() - c2
    bake_s = engine.prebaker._m_bake_s.value
    bake_scrapes = dict(scrapes=sc2.scrapes, errors=sc2.errors,
                        first_error=sc2.first_error)
    log_time(stats,
             f"ServingEngine(prebake=True) with the launcher's plane beside "
             f"a scraper of every route: {rounds} serve() calls of "
             f"{PREBAKE_BATCH} requests, all fed back; C {C_EXPECTED} -> "
             f"{router.db.capacity}; bake {bake_s:.3f} s ("
             f"{led['warmed'] - led0['warmed']} graphs, {captured} captures "
             f"in the process, by traffic {traffic}); serve() ms "
             f"{[round(x, 1) for x in serve_ms]}; choices differing from "
             f"the eager route {differ}; /quality decisions {decisions}; "
             f"scrapes {bake_scrapes}")
    stats["obs_capture"] = dict(
        fresh_graphs=n_fresh, fresh_scrapes=fresh_scrapes, rounds=rounds,
        bake_s=bake_s, baked=led["warmed"] - led0["warmed"],
        captured=captured, traffic_captures=traffic, serve_ms=serve_ms,
        choices_differing=differ, decisions=decisions,
        scrapes=bake_scrapes)
    if traffic or captured != led["warmed"] - led0["warmed"] or not bake_s \
            or differ or decisions != requests or not sc2.scrapes \
            or sc2.errors:
        fail(f"prebaker beside a scraper: {traffic} captures by traffic, "
             f"{captured} in the process, bake {bake_s} s, {differ} choices "
             f"differ, /quality decisions {decisions} of {requests}, "
             f"scrapes {bake_scrapes}")
    stats["obs_phase_s"] = time.perf_counter() - t_phase
    log_time(stats, f"obs plane phase wall: {stats['obs_phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 6: the attention kernels against their plain versions, bf16
# ---------------------------------------------------------------------------

def _bf16(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _sdpa(q, k, v, **kw):
    """The library call: PyTorch's fused attention on (B, H, S, dh)
    views. Timed only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def check_flash(dev, kernels, stats):
    """Each layout of FLASH_SHAPES at its S, a ragged S and a window,
    against the plain version; the control (each row's own key masked,
    an off-by-one on the causal diagonal) must fail the bar by
    CONTROL_MIN."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(2)
    errs, ratios, controls, timed = {}, {}, {}, {}
    for model, (b, s_main, h, hk, dh) in FLASH_SHAPES.items():
        for s, window in ((s_main, 0), (RAGGED_S, 0), (s_main, WINDOW)):
            case = f"{model} S={s} window={window}"
            q = _bf16(gen, (b, s, h, dh), dev)
            k = _bf16(gen, (b, s, hk, dh), dev)
            v = _bf16(gen, (b, s, hk, dh), dev)
            got = flash_attention_cuda(q, k, v, causal=True, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           window=window)
            atol = flash_atol(q, k, v, causal=True, window=window)
            errs[case], ratios[case] = flash_check(got, want, atol)
            if not ratios[case] <= 1.0:
                fail(f"flash_attention {case}: max abs err {errs[case]}, "
                     f"{ratios[case]} times the bar")
            if (s, window) != (s_main, 0):
                continue
            # row i through the kernel with keys 0..i-1 only, held on the
            # rows with at least S/2 keys, where one key matters least
            ctl = flash_attention_cuda(q[:, 1:], k[:, :-1], v[:, :-1],
                                       causal=True)
            controls[model] = flash_check(ctl[:, s // 2:],
                                          want[:, 1 + s // 2:],
                                          atol[:, 1 + s // 2:])[1]
            if not controls[model] >= CONTROL_MIN:
                fail(f"flash_attention {case}: the control without the "
                     f"diagonal key is only {controls[model]} times the "
                     f"bar (at least {CONTROL_MIN})")
            ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True),
                         20)
            plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                            causal=True), 3)
            lib = cuda_ms(lambda: _sdpa(q, k, v, is_causal=True), 20)
            nbytes = 2.0 * (2 * b * s * h * dh + 2 * b * s * hk * dh)
            flops = 4.0 * b * h * dh * s * (s + 1) / 2   # the causal pairs
            bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            tflops = flops / ms / 1e9
            timed[model] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bms, bound_by=by)
            stats[f"flash_{model}_tflops"] = tflops
            log_time(stats,
                     f"flash_attention bf16 {model} layout B={b} S={s} H={h} "
                     f"Hk={hk} dh={dh} causal: kernel_ms={ms} ({tflops} "
                     f"TFLOP/s, {bms / ms} of the bound) plain_ms={plain} "
                     f"library_ms(SDPA)={lib} (kernel / SDPA {ms / lib}) "
                     f"bound_ms={bms} ({by})")
    log(f"flash_attention max abs err {errs}; error over the bar (at most "
        f"1) {ratios}; control without the diagonal key, over the bar "
        f"(at least {CONTROL_MIN}) {controls}")
    stats["flash_attention"] = dict(max_abs_err=errs, err_over_bar=ratios,
                                    control_over_bar=controls, **timed)
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85",
        max_abs_err=max(errs.values()), **timed["qwen3-8b"])


def check_decode(dev, kernels, stats):
    """Each layout of DECODE_SHAPES with ragged lengths over an fp32 cache
    (DECODE_BF16: every row of a bf16 cache), and over a full cache
    against the last row of flash; the control (kv_len - 1: the newest
    key dropped) must fail the bar; one captured graph of the call,
    replayed three times into a zeroed output, must equal the eager call
    bit for bit (the last split of each (b, KV head) resets its arrival
    counter, or a replay would merge too early or never)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    decode_attention_cuda = DA.decode_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, ratios, controls, timed, queued, replays = {}, {}, {}, {}, {}, {}
    for model, (b, t, h, hk, dh) in DECODE_SHAPES.items():
        bf16 = model in DECODE_BF16
        q = _bf16(gen, (b, h, dh), dev)
        if bf16:
            k, v = _bf16(gen, (b, t, hk, dh), dev), _bf16(gen, (b, t, hk, dh),
                                                         dev)
            kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
        else:
            k = torch.randn((b, t, hk, dh), generator=gen, device=dev)
            v = torch.randn((b, t, hk, dh), generator=gen, device=dev)
            kv_len = torch.randint(1, t + 1, (b,), generator=gen, device=dev,
                                   dtype=torch.int32)
            kv_len[0] = t
        got = decode_attention_cuda(q, k, v, kv_len)
        # the kernel rounds the cache to q's type in registers, as the
        # model's plain path does before its product
        want = ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len)
        errs[model], ratios[model] = decode_check(got, want)
        if not ratios[model] <= 1.0:
            fail(f"decode_attention {model}: max abs err {errs[model]}, "
                 f"{ratios[model]} times the bar")
        # held on the rows with at least T/2 keys, where one key matters
        # least
        ctl = decode_attention_cuda(q, k, v, kv_len - 1)
        long = kv_len >= t // 2
        controls[model] = decode_check(ctl[long], want[long])[1]
        if not controls[model] >= CONTROL_MIN:
            fail(f"decode_attention {model}: the control with kv_len - 1 "
                 f"is only {controls[model]} times the bar (at least "
                 f"{CONTROL_MIN})")

        # one captured graph of the call, replayed into a zeroed output
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out = decode_attention_cuda(q, k, v, kv_len)
        same = []
        for _ in range(3):
            g_out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same.append(bool(torch.equal(g_out, got)))
        counters = sum(int(x.count_nonzero())
                       for x in DA._ARRIVALS.get(dev.index or 0, []))
        replays[model] = dict(equal=same, counters_left=counters)
        if not all(same) or counters:
            fail(f"decode_attention {model}: graph replays equal to the "
                 f"eager call {same}, arrival counters left non-zero "
                 f"{counters}")
        del graph, g_out

        # decode over a full cache == the last row of prefill, held to
        # the flash bar: the flash kernel rounds its weights to bf16
        s = DECODE_FLASH_S[model]
        qf = _bf16(gen, (2, s, h, dh), dev)
        kf = _bf16(gen, (2, s, hk, dh), dev)
        vf = _bf16(gen, (2, s, hk, dh), dev)
        full = flash_attention_cuda(qf, kf, vf, causal=True)
        dec = decode_attention_cuda(qf[:, -1], kf, vf,
                                    torch.full((2,), s, dtype=torch.int32,
                                               device=dev))
        row = f"{model} vs flash row"
        atol = flash_atol(qf[:, -1:], kf, vf, causal=True)
        errs[row], ratios[row] = flash_check(dec[:, None], full[:, -1:],
                                             atol)
        if not ratios[row] <= 1.0:
            fail(f"decode vs the last row of flash, {model}: max abs err "
                 f"{errs[row]}, {ratios[row]} times the bar")
        del qf, kf, vf, full

        ms = cuda_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 1000)
        # the device's own time, the host's launches queued ahead of it
        qms = queued_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 200)
        plain = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, kv_len), 5)
        if bf16:       # every row valid: no mask
            lib_what = "SDPA, bf16, GQA"
            lib = queued_ms(lambda: _sdpa(q[:, None], k, v)[:, :, 0], 200)
        else:
            lib_what = "SDPA, fp32, mask"
            q32 = q.float()[:, :, None]
            mask = (torch.arange(t, device=dev)[None]
                    < kv_len[:, None])[:, None, None]
            lib = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q32, k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True), 20)
        n_kv = float(kv_len.sum())
        nbytes = (n_kv * hk * dh * k.element_size() * 2 + 2.0 * 2 * b * h * dh
                  + 4 * b)
        bms, by = bound_ms(nbytes, 4.0 * h * dh * n_kv, PEAK_BF16_FLOPS)
        timed[model] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=bms, bound_by=by)
        queued[model] = qms
        n_split, split_rows = DA.split_plan(b, t, hk, dh, k.element_size(),
                                            DA._sm_count(dev))
        log_time(stats,
                 f"decode_attention q bf16, cache {k.dtype}, {model} layout "
                 f"B={b} T={t} H={h} Hk={hk} dh={dh}, {int(n_kv)} valid "
                 f"rows, {n_split} splits of {split_rows} rows: "
                 f"kernel_ms={ms} ({bms / ms} of the bound) queued_ms={qms} "
                 f"({bms / qms} of the bound) plain_ms={plain} "
                 f"library_ms({lib_what})={lib} bound_ms={bms} ({by})")
    # the split plan counts on BLOCKS_PER_SM resident blocks an SM
    lib = _build.library("decode_attention")
    occupancy = {f"{pair} dh={dh} rep={rep}":
                 lib.decode_attention_occupancy(*codes, dh, rep)
                 for pair, codes in (("fp32/fp32", (0, 0)),
                                     ("bf16/fp32", (1, 0)),
                                     ("bf16/bf16", (1, 1)))
                 for dh in DA.HEAD_DIMS for rep in (1, 2, 4, 8)}
    if set(occupancy.values()) != {DA.BLOCKS_PER_SM}:
        fail(f"decode_attention: resident blocks an SM {occupancy}, the "
             f"split plan counts on {DA.BLOCKS_PER_SM}")
    log(f"decode_attention max abs err {errs}; error over the bar (at most "
        f"1) {ratios}; control with kv_len - 1, over the bar (at least "
        f"{CONTROL_MIN}) {controls}; graph replays {replays}; resident "
        f"blocks an SM {occupancy}")
    stats["decode_attention"] = dict(max_abs_err=errs, err_over_bar=ratios,
                                     control_over_bar=controls,
                                     queued_ms=queued, graph_replays=replays,
                                     occupancy=occupancy, **timed)
    kernels["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:75",
        max_abs_err=max(errs.values()), **timed["qwen3-8b"])


# ---------------------------------------------------------------------------
# phase 7: the serving path at full width
# ---------------------------------------------------------------------------

def build_serving(dev, stats):
    from repro_torch.configs import get_config
    from repro_torch.core.router import EagleConfig, EagleRouter
    from repro_torch.data.routerbench import make_corpus, pairwise_feedback
    from repro_torch.launch.serve import quality_oracle
    from repro_torch.serving import FleetModel, ServingEngine
    names = list(FLEET)
    corpus = make_corpus(seed=0, n_per_dataset=60, dim=DIM,
                         model_names=names,
                         costs=np.linspace(1.0, 8.0, len(names)))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    router = EagleRouter(names, corpus.costs, EagleConfig(embed_dim=DIM),
                         db_capacity=1 << 15, device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    fleet = {}
    for i, name in enumerate(names):
        t0 = time.perf_counter()
        fleet[name] = FleetModel(get_config(name), seed=i,
                                 max_len=SERVE_MAX_LEN, device=dev)
        torch.cuda.synchronize()
        cfg = fleet[name].cfg
        n_params = sum(x.numel() for x in _leaves(fleet[name].params))
        log(f"{name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {n_params / 1e9:.3f}B "
            f"parameters, compute {cfg.dtype}; init + cast "
            f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(fleet, router, compare_rate=0.25, seed=0,
                           quality_oracle=quality_oracle)
    engine.warmup()
    # each model's static decode state at SERVE_BATCH rows, the largest
    # group; the groups' own row counts are captured at first use
    for m in fleet.values():
        m.warmup([SERVE_BATCH])
    torch.cuda.empty_cache()      # the fp32 copies the casts released
    stats["serve_fleet"] = {n: dict(layers=m.cfg.n_layers,
                                    d_model=m.cfg.d_model)
                            for n, m in fleet.items()}
    return engine, corpus


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_requests(corpus, rng, n, vocab):
    from repro_torch.serving import Request
    idx = rng.choice(corpus.test_idx, n, replace=False)
    return [Request(tokens=rng.integers(0, vocab, int(rng.integers(
                        PROMPT_LEN[0], PROMPT_LEN[1] + 1))).astype(np.int32),
                    embedding=corpus.embeddings[i],
                    budget=float(rng.uniform(1.0, 10.0)),
                    max_new_tokens=MAX_NEW, rid=k)
            for k, i in enumerate(idx)]


def check_responses(engine, reqs, res, where):
    """Response i answers request i: its rid, max_new_tokens tokens, each
    in its model's vocabulary."""
    if len(res) != len(reqs):
        fail(f"{where}: {len(res)} responses to {len(reqs)} requests")
    for req, r in zip(reqs, res):
        vocab = engine.fleet[r.model].cfg.vocab
        if r.rid != req.rid or r.tokens.shape != (req.max_new_tokens,) \
                or r.tokens.min() < 0 or r.tokens.max() >= vocab:
            fail(f"{where}: response {r.rid} from {r.model}: tokens of "
                 f"shape {r.tokens.shape} in [{r.tokens.min()}, "
                 f"{r.tokens.max()}]")


def drive_serving(engine, corpus, stats):
    rng = np.random.default_rng(0)
    db0 = engine.router.db.size
    wall, groups = [], {n: 0 for n in FLEET}
    vocab = min(m.cfg.vocab for m in engine.fleet.values())
    for call in range(SERVE_CALLS):
        reqs = serve_requests(corpus, rng, SERVE_BATCH, vocab)
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        check_responses(engine, reqs, res, f"serve() call {call}")
        for name in {r.model for r in res}:
            groups[name] += 1
        st = engine.stats
        if st["served"] != SERVE_BATCH * (call + 1) \
                or sum(st["per_model"].values()) != st["served"]:
            fail(f"stats after call {call}: {st}")
    st = engine.stats
    if not (st["feedback"] > 0 and 0 < st["commits"] <= SERVE_CALLS):
        fail(f"no feedback was committed: {st}")
    if engine.router.db.size != db0 + st["feedback"] \
            or int(engine.dbuf.front.size) != engine.router.db.size:
        fail(f"DB holds {engine.router.db.size} rows, the front replica "
             f"{int(engine.dbuf.front.size)}, after {st['feedback']} "
             f"comparisons on {db0}")
    if min(groups.values()) == 0:
        fail(f"a model served no group: {groups}")
    p50 = statistics.median(wall)
    log_time(stats,
             f"serving: {SERVE_CALLS} serve() calls of {SERVE_BATCH} "
             f"requests: stats {st}; groups per model {groups}; wall s "
             f"{wall}; p50 {p50:.3f} s")
    stats["serve"] = dict(stats=st, groups=groups, wall_s=wall,
                          p50_s=p50)


def stub_inputs(cfg, b, dev, gen=None):
    """(the stub embeddings a model's prefill reads, as keyword arguments;
    the rows they put before the prompt in the cache): whisper's frames
    and llava's image rows, zeros as FleetModel feeds them, or seeded
    normal values from `gen` (distinct rows)."""
    def stub(n):
        shape = (b, n, cfg.d_model)
        return torch.zeros(shape, device=dev) if gen is None else \
            torch.randn(shape, generator=gen, device=dev)
    if cfg.arch_type == "encdec":
        return {"enc_embeds": stub(cfg.n_audio_frames)}, 0
    if cfg.arch_type == "vlm":
        return {"img_embeds": stub(cfg.n_image_tokens)}, cfg.n_image_tokens
    return {}, 0


# ---------------------------------------------------------------------------
# phase 8: kernel path vs plain path through the full model
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def kernels_held(worst, drop):
    """Inside: the model's two attention kernels, each call also held
    against its plain version on the same inputs; `worst` keeps each
    kernel's largest error over its bar (flash or decode). `drop` keys are taken
    off kv_len before the decode kernel (1: the control)."""
    from unittest import mock
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    flash, decode = L.flash_attention_cuda, L.decode_attention_cuda

    def keep(kernel, got, ratio):
        worst[kernel] = max(worst[kernel], ratio)
        return got

    def flash_held(q, k, v, **kw):
        # the flash bar's floor follows this call's activations
        got = flash(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        return keep("flash_attention", got,
                    flash_check(got, want, flash_atol(q, k, v, **kw))[1])

    def decode_held(q, k, v, kv_len, **kw):
        # the plain version over the cache as the kernel reads it
        got = decode(q, k, v, kv_len - drop, **kw)
        want = ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len, **kw)
        return keep("decode_attention", got, decode_check(got, want)[1])

    with mock.patch.object(L, "flash_attention_cuda", flash_held), \
            mock.patch.object(L, "decode_attention_cuda", decode_held):
        yield


@contextlib.contextmanager
def pinned_experts(calls, record):
    """Inside: each `moe.route` call records the experts it chose into
    `calls` (record), or takes the ones recorded there, in the same
    order, with its weights renormalised from its own gates at them."""
    from unittest import mock
    from repro_torch.models import moe as MOE
    route, replay = MOE.route, iter(list(calls))
    if record:
        calls.clear()

    def pinned(cfg, router, xt, sum_grad=None):
        top_w, top_e, gates = route(cfg, router, xt, sum_grad)
        if record:
            calls.append(top_e)
            return top_w, top_e, gates
        top_e = next(replay)
        top_w = gates.gather(1, top_e)
        return (top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_e,
                gates)

    with mock.patch.object(MOE, "route", pinned):
        yield


@torch.inference_mode()
def compare_model_paths(engine, stats, names=FLEET):
    """A padded group of each fleet model through prefill + 4 decode
    steps three ways, fed the same tokens: the kernels, the plain attend,
    and a control, the kernel path with the newest key dropped at every
    decode (kv_len - 1; whisper's cross decode: the last frame). Every
    kernel call of the kernel path must pass its bar (flash or decode)
    against its plain version on the same inputs, and the control's
    decode calls must fail it; the logits must lie within LOGIT_REL_BAR
    of the plain path's. whisper's encoder reads seeded random frame
    embeddings (distinct rows; the served stub is zeros). mamba2 has no
    attention: its paths run the same code, so it has no control and no
    kernel call to hold, and its logits are held to the same bar; an MLA
    model's decode (the absorbed form) is plain PyTorch on every path, so
    its control has no decode call to fail (its flash control is
    check_site_attention's). A MoE
    model's plain and control paths take the kernel path's experts
    (`pinned_experts`): a near-tied gate could otherwise flip a token's
    expert, and a capacity drop after it, and move its logits by a
    whole expert's output, which is no attention fault."""
    from repro_torch.models import transformer as T
    # path: (backend, keys dropped from kv_len; None: calls not held)
    paths = {"kernels": ("cuda", 0), "plain": ("reference", None),
             "control": ("cuda", 1)}
    stats.setdefault("model_paths", {})
    for name in names:
        m = engine.fleet[name]
        cfg, dev, lens = m.cfg, m.device, COMPARE_LENS[name]
        rng = np.random.default_rng(4)
        s = max(lens)
        toks = np.zeros((len(lens), s), np.int32)       # padded, as served
        for row, n in enumerate(lens):
            toks[row, :n] = rng.integers(0, cfg.vocab, n)
        toks = torch.tensor(toks, dtype=torch.int64, device=dev)
        stub, n_img = stub_inputs(cfg, len(lens), dev,
                                  torch.Generator(device=dev).manual_seed(4))
        worst = {p: dict(flash_attention=0.0, decode_attention=0.0)
                 for p in ("kernels", "control")}
        experts = [] if cfg.arch_type == "moe" else None

        def run(p, fn):
            backend, drop = paths[p]
            with (contextlib.nullcontext() if drop is None
                  else kernels_held(worst[p], drop)), \
                    (contextlib.nullcontext() if experts is None
                     else pinned_experts(experts, record=p == "kernels")):
                return fn(backend)

        out = {p: run(p, lambda b: T.prefill(
                   cfg, m.params, toks, m.max_len,
                   cache_dtype=torch.float32, backend=b, **stub))
               for p in paths}
        rel, ctl_rel, flips, ties = [], [], 0, 0
        for step in range(5):
            lk, lp, lc = (out[p][0].float() for p in paths)
            diff = (lk - lp).abs()
            rel.append(float(diff.max() / lp.abs().max()))
            ctl_rel.append(float((lc - lp).abs().max() / lp.abs().max()))
            top2 = torch.topk(lp, 2, dim=-1).values
            # a perturbation of at most e per logit flips an argmax only
            # where the top two are within 2e
            tied = (top2[:, 0] - top2[:, 1]) <= 2 * diff.max(dim=-1).values
            differ = lk.argmax(-1) != lp.argmax(-1)
            flips += int(differ.sum())
            ties += int((differ & tied).sum())
            if int((differ & ~tied).sum()):
                fail(f"{name}, kernel vs plain path, step {step}: a greedy "
                     "token differs without a near-tie")
            if step == 4:
                break
            tok = lp.argmax(-1)[:, None]   # every path takes the same token
            out = {p: run(p, lambda b: T.decode_step(
                       cfg, m.params, out[p][1], tok, n_img + s + step,
                       backend=b))
                   for p in paths}
        del out
        held, ctl = worst["kernels"], worst["control"]
        if max(held.values()) > 1.0:
            fail(f"{name}: a kernel call on the model path misses its "
                 f"plain version by more than its bar: {held}")
        if cfg.arch_type != "ssm" and cfg.attn_kind != "mla" and \
                not ctl["decode_attention"] > 1.0:
            fail(f"{name}: the control's decode calls pass the attention "
                 f"bar ({ctl['decode_attention']})")
        if max(rel) > LOGIT_REL_BAR:
            fail(f"{name}, kernel vs plain path: logits differ by "
                 f"{max(rel)} of the largest logit (bar {LOGIT_REL_BAR})")
        log(f"{name}, a group of {len(lens)} prompts of {lens} tokens "
            f"through prefill + 4 decode steps: every kernel call against "
            f"its plain version, error over the bar (at most 1) {held}, "
            f"the control's calls (above 1) {ctl}; max |dlogit| / max "
            f"|logit| per step, kernels vs plain attend {rel} (bar "
            f"{LOGIT_REL_BAR}), control vs plain {ctl_rel}; greedy tokens "
            f"differing {flips}, all at near-ties ({ties})")
        stats["model_paths"][name] = dict(
            calls_err_over_bar=held, control_calls_err_over_bar=ctl,
            rel_logit_diff=rel, control_rel_logit_diff=ctl_rel,
            token_flips=flips)


@torch.inference_mode()
def eager_generate(m, toks, max_new):
    """Greedy tokens through the eager path (compare_model_paths'
    kernel path): prefill into a fresh cache, then decode_step with an
    int position and its own argmax, as FleetModel.generate runs them
    through its graph."""
    from repro_torch.models import transformer as T
    t = torch.tensor(toks, dtype=torch.int64, device=m.device)
    stub, n_img = stub_inputs(m.cfg, t.shape[0], m.device)
    logits, cache = T.prefill(m.cfg, m.params, t, m.max_len,
                              cache_dtype=torch.float32, **stub)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = T.decode_step(m.cfg, m.params, cache, tok,
                                      n_img + toks.shape[1] + i)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def compare_graph_generate(engine, stats, key="graph_tokens_differing",
                           names=None):
    """Each fleet model's (of `names`: every one by default) greedy
    tokens through its captured decode graphs (FleetModel.generate, a
    warmed row count of 8) against the eager path's on the same padded
    group of 8 prompts of 128..1024 tokens, MAX_NEW tokens each: every
    token must be equal, and nothing may be captured."""
    rng = np.random.default_rng(8)
    out = {}
    for name in names or list(engine.fleet):
        m = engine.fleet[name]
        toks = np.zeros((8, LAUNCH_PAD_LEN), np.int32)
        for row in range(8):
            n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
            toks[row, :n] = rng.integers(0, m.cfg.vocab, n)
        misses = m.cache_stats()["misses"]
        got = m.generate(toks, MAX_NEW)
        want = eager_generate(m, toks, MAX_NEW)
        out[name] = int((got != want).sum())
        if m.cache_stats()["misses"] != misses:
            fail(f"{name}: generate at 8 rows captured a graph")
    log(f"greedy tokens through the decode graphs against the eager "
        f"path, 8 prompts x {MAX_NEW} tokens per model: differing {out}")
    stats[key] = out
    if any(out.values()):
        fail(f"tokens through the decode graphs differ from the eager "
             f"path's: {out}")


# ---------------------------------------------------------------------------
# phase 9: serving times
# ---------------------------------------------------------------------------

@torch.inference_mode()
def time_serving(engine, stats, names=FLEET):
    """Time to first token (prefill of TIME_BATCH x TIME_LEN; whisper's
    includes its encoder over the zero stub, which is also timed alone)
    and the decode step at batch TIME_BATCH, per model."""
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(5)
    out = stats.setdefault("serve_times", {})
    for name in names:
        m = engine.fleet[name]
        cfg = m.cfg
        toks = torch.tensor(rng.integers(0, cfg.vocab,
                                         (TIME_BATCH, TIME_LEN)),
                            dtype=torch.int64, device=m.device)
        stub, n_img = stub_inputs(cfg, TIME_BATCH, m.device)
        enc = stub.get("enc_embeds")
        if enc is not None:
            enc_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                T._encode(cfg, m.params, enc, "cuda")
                torch.cuda.synchronize()
                enc_ms.append((time.perf_counter() - t0) * 1e3)
            log_time(stats, f"{name}: encoder over {TIME_BATCH} x "
                     f"{cfg.n_audio_frames} frames p50 "
                     f"{statistics.median(enc_ms):.2f} ms of {enc_ms}")
        ttft = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits, cache = T.prefill(cfg, m.params, toks, m.max_len,
                                      cache_dtype=torch.float32, **stub)
            torch.cuda.synchronize()
            ttft.append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)[:, None]
        pos = n_img + TIME_LEN        # the first decode position
        T.decode_step(cfg, m.params, cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIME_STEPS):
            logits, cache = T.decode_step(cfg, m.params, cache, tok,
                                          pos + 1 + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TIME_STEPS
        del cache
        graph = graph_step_times(m, toks, stub, pos)
        out[name] = dict(ttft_ms=statistics.median(ttft),
                         decode_step_ms=step_ms,
                         tokens_per_s=TIME_BATCH / step_ms * 1e3,
                         graph=graph)
        if enc is not None:
            out[name]["encoder_ms"] = statistics.median(enc_ms)
        img = f" after {n_img} image rows" if n_img else ""
        log_time(stats,
                 f"{name}: time to first token (prefill of {TIME_BATCH} x "
                 f"{TIME_LEN}{img}) p50 {out[name]['ttft_ms']:.2f} ms of "
                 f"{ttft}; decode step at batch {TIME_BATCH}, context "
                 f"~{pos}: eager {step_ms:.3f} ms = "
                 f"{out[name]['tokens_per_s']:.1f} tokens/s; through its "
                 f"graph: wall {graph['wall_ms']:.3f} ms, device (events) "
                 f"{graph['device_ms']:.3f} ms, host (index update and "
                 f"replay, enqueued) {graph['host_ms']:.4f} ms = "
                 f"{TIME_BATCH / graph['wall_ms'] * 1e3:.1f} tokens/s")


@torch.inference_mode()
def graph_step_times(m, toks, stub, pos):
    """One model's decode step at batch TIME_BATCH, at position `pos`
    (TIME_LEN after any stub rows), through its captured graph
    (FleetModel's static state, as generate drives it): the wall per
    step (host clock to a synchronise), the device time per step (CUDA
    events around the steps: the host runs far ahead of a replay, so no
    gap between graphs is counted), and the host's cost per step (an
    index update and a replay, enqueued)."""
    from repro_torch.models import transformer as T
    step = m._step(TIME_BATCH)
    cache, hist, index = m._view(TIME_BATCH)
    logits, _ = T.prefill(m.cfg, m.params, toks, m.max_len, cache=cache,
                          **stub)
    hist[:, pos] = logits.argmax(-1)
    index.fill_(pos)
    step(cache, hist, index)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TIME_STEPS):
        index.fill_(pos + 1 + i)
        step(cache, hist, index)
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(wall_ms=wall * 1e3 / TIME_STEPS,
                device_ms=start.elapsed_time(end) / TIME_STEPS,
                host_ms=host * 1e3 / TIME_STEPS)


@torch.inference_mode()
def profile_decode(engine, stats, name="qwen3-8b", what="decode"):
    """Device time by op of one fleet model at batch TIME_BATCH, context
    TIME_LEN: over 3 eager decode steps, 3 replays of its captured decode
    step (what="graph"), or one prefill (what="prefill"; whisper's
    includes its encoder over the zero stub)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    m = engine.fleet[name]
    toks = torch.zeros((TIME_BATCH, TIME_LEN), dtype=torch.int64,
                       device=m.device)
    stub, n_img = stub_inputs(m.cfg, TIME_BATCH, m.device)
    pos = n_img + TIME_LEN

    def prefill():
        return T.prefill(m.cfg, m.params, toks, m.max_len,
                         cache_dtype=torch.float32, **stub)
    logits, cache = prefill()
    tok = logits.argmax(-1)[:, None]
    T.decode_step(m.cfg, m.params, cache, tok, pos)
    if what == "graph":
        del cache
        step = m._step(TIME_BATCH)
        cache, hist, index = m._view(TIME_BATCH)
        T.prefill(m.cfg, m.params, toks, m.max_len, cache=cache, **stub)
        index.fill_(pos)
        step(cache, hist, index)
    torch.cuda.synchronize()
    n = 1 if what == "prefill" else 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            if what == "decode":
                T.decode_step(m.cfg, m.params, cache, tok, pos + 1 + i)
            elif what == "graph":
                index.fill_(pos + 1 + i)
                step(cache, hist, index)
            else:
                prefill()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    top = [(op[:60], ms) for op, ms in rows[:10]]
    log_time(stats,
             f"profile {name} {what}{' step' if n == 3 else ''}, batch "
             f"{TIME_BATCH}: wall {wall_ms} ms under the profiler, device "
             f"{device_ms} ms, busy {device_ms / wall_ms}; top: {top}")
    key = "profile_decode" if (name, what) == ("qwen3-8b", "decode") \
        else f"profile_{what}_{name}"
    stats[key] = dict(wall_ms=wall_ms, device_ms=device_ms, top=top)
    del cache


# ---------------------------------------------------------------------------
# phase 10: the launcher and its default fleet
# ---------------------------------------------------------------------------

def launch_cli(*args):
    """`python -m repro_torch.launch.serve ARGS` in a subprocess on the
    card, from this checkout's sources (a CompletedProcess)."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(SRC)})


def drive_launcher(stats):
    """`launch.serve` at its defaults on the card: build_engine() (the
    reduced ARCH_IDS[:4], max_len 64, a router at D = 64), 8 requests
    through serve(), then 8 through `_serve_admitted` at the default
    rate, window and wait (--admission); the requests as `main` makes
    them."""
    from repro_torch import graphs
    from repro_torch import obs as OBS
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as LS
    from repro_torch.serving import Request
    t0 = time.perf_counter()
    # a telemetry scope of its own: `stats` counts this engine alone
    engine, corpus = LS.build_engine(obs=OBS.Observability())
    build_s = time.perf_counter() - t0
    c0 = graphs.capture_count()
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, 100, rng.integers(4, 12)).astype(
                        np.int32),
                    embedding=corpus.embeddings[i], budget=5.0,
                    max_new_tokens=4, rid=k)
            for k, i in enumerate(corpus.test_idx[:16])]
    _build.reset_launches()
    t0 = time.perf_counter()
    res = engine.serve(reqs[:8])
    serve_s = time.perf_counter() - t0
    check_responses(engine, reqs[:8], res, "launcher serve()")
    t0 = time.perf_counter()
    adm = LS._serve_admitted(engine, reqs[8:], 500.0, 8, 5.0)
    admit_s = time.perf_counter() - t0
    check_responses(engine, reqs[8:], adm, "launcher --admission")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    models = sorted({r.model for r in res + adm})
    captured = graphs.capture_count() - c0
    if captured:
        fail(f"the launcher at its defaults captured {captured} graphs "
             "after build_engine warmed it")
    log_time(stats, f"launcher at its defaults (reduced {list(engine.fleet)}"
             f"): built in {build_s:.1f} s; serve() of 8 in {serve_s:.3f} "
             f"s, --admission of 8 in {admit_s:.3f} s; models answering "
             f"{models}; stats {engine.stats}; launches {counts}; graphs "
             f"captured after build_engine {captured} (route "
             f"{engine.dispatch.cache_stats()['misses']} and decode "
             f"{sum(m.cache_stats()['misses'] for m in engine.fleet.values())}"
             f" at build)")
    stats["launcher"] = dict(build_s=build_s, serve_s=serve_s,
                             admission_s=admit_s, models=models,
                             stats=engine.stats, launches=counts)
    del engine
    # the CLI with the sharded route and the prebaker, at its defaults
    t0 = time.perf_counter()
    out = launch_cli("--db-shards", "1", "--prebake")
    cli_s = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines or not lines[-1].startswith("stats:"):
        fail(f"python -m repro_torch.launch.serve --db-shards 1 --prebake "
             f"exited {out.returncode}: {out.stdout[-2000:]}"
             f"{out.stderr[-2000:]}")
    log_time(stats, f"python -m repro_torch.launch.serve --db-shards 1 "
             f"--prebake: exit 0 in {cli_s:.1f} s; {lines[0]} ... "
             f"{lines[-1]}")
    stats["launcher_sharded_cli"] = dict(seconds=cli_s, last=lines[-1])
    # the CLI with the obs plane on an ephemeral port and an alert log
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = launch_cli("--serve-obs", "0", "--alert-log",
                         str(Path(tmp) / "alerts.jsonl"))
        cli_s = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    url = [ln for ln in lines if re.fullmatch(
        r"obs plane at http://127\.0\.0\.1:\d+ \(/metrics /trace "
        r"/decisions /healthz /slo /quality\)", ln)]
    if out.returncode or not url or not lines[-1].startswith("stats:"):
        fail(f"python -m repro_torch.launch.serve --serve-obs 0 --alert-log "
             f"exited {out.returncode}: {out.stdout[-2000:]}"
             f"{out.stderr[-2000:]}")
    log_time(stats, f"python -m repro_torch.launch.serve --serve-obs 0 "
             f"--alert-log PATH: exit 0 in {cli_s:.1f} s; {url[0]} ... "
             f"{lines[-1]}")
    stats["launcher_obs_cli"] = dict(seconds=cli_s, url=url[0],
                                     last=lines[-1])


def _site_entry(kernels, key, name, nbytes, flops, got_ms, plain_ms,
                lib_ms, err):
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    kernels[key] = dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/" + (
            "flash_attention.cu" if "flash" in key
            else "decode_attention.cu"),
        replaces=("src/repro/kernels/flash_attention.py:85"
                  if "flash" in key
                  else "src/repro/kernels/decode_attention.py:75"),
        max_abs_err=err, ms=got_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    return bms, by


def _band(s, t, window, dev):
    """The (S, T) boolean mask of a causal window (bottom-right aligned,
    as the kernels'): SDPA's explicit mask for a windowed call."""
    qp = torch.arange(s, device=dev)[:, None] + (t - s)
    kp = torch.arange(t, device=dev)[None, :]
    return (kp <= qp) & (kp > qp - window)


def check_site_attention(dev, kernels, stats, model="whisper",
                         flash_shapes=WHISPER_FLASH,
                         decode_shapes=WHISPER_DECODE, seed=6):
    """A model's attention call sites in bf16 at its serving shapes
    (whisper-large-v3's five: WHISPER_FLASH, WHISPER_DECODE; phi3.5-moe's
    two: PHI_FLASH, PHI_DECODE; the dense families': DENSE_FLASH,
    DENSE_DECODE; zamba2-7b's and deepseek-v3's: HYBRID_FLASH,
    HYBRID_DECODE, a flash dh of (dk, dv) giving v its own width), each
    against its plain version (the flash and decode
    bars of phase 6) with a control, one key dropped, that must fail by
    CONTROL_MIN: a bidirectional flash site (the encoder, the cross
    prefill) drops the last key for every row (held on all rows), a
    causal one each row's own key (rows with at least S/2 keys), the
    decodes the newest row (kv_len - 1; under a window w, w - 1 too, so
    the window keeps its first row). A flash shape may end in a window
    (0: none), a decode shape in a window and the least kv_len drawn
    (else 129: prompts of 128..1024 + steps). Each timed beside its bound
    and SDPA (with an explicit mask for a window); the kernels line's
    entries are "<model> flash <site>" and "<model> <site>"."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(seed)
    report = {}
    for site, shape in flash_shapes.items():
        b, s, t, h, hk, dh, causal = shape[:7]
        window = shape[7] if len(shape) > 7 else 0
        dk, dv = dh if isinstance(dh, tuple) else (dh, dh)
        q = _bf16(gen, (b, s, h, dk), dev)
        k = _bf16(gen, (b, t, hk, dk), dev)
        v = _bf16(gen, (b, t, hk, dv), dev)
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        atol = flash_atol(q, k, v, causal=causal, window=window)
        err, ratio = flash_check(got, want, atol)
        if causal:
            ctl = flash_attention_cuda(q[:, 1:], k[:, :-1], v[:, :-1],
                                       causal=True, window=window)
            control = flash_check(ctl[:, s // 2:], want[:, 1 + s // 2:],
                                  atol[:, 1 + s // 2:])[1]
        else:
            ctl = flash_attention_cuda(q, k[:, :-1], v[:, :-1], causal=False)
            control = flash_check(ctl, want, atol)[1]
        if not (ratio <= 1.0 and control >= CONTROL_MIN):
            fail(f"{model} flash {site} B={b} S={s} S_kv={t} window="
                 f"{window}: error over the bar {ratio} (at most 1), "
                 f"control {control} (at least {CONTROL_MIN})")
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window), 20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), 3)
        if window:
            band = _band(s, t, window, dev)
            lib = cuda_ms(lambda: _sdpa(q, k, v, attn_mask=band), 20)
            pairs = float(band.sum())
        else:
            lib = cuda_ms(lambda: _sdpa(q, k, v, is_causal=causal), 20)
            pairs = s * (s + 1) / 2 if causal else s * t
        # q and k of width dk, v and the output of width dv
        nbytes = 2.0 * (b * s * h * (dk + dv) + b * t * hk * (dk + dv))
        flops = 2.0 * b * h * (dk + dv) * pairs
        bms, by = _site_entry(kernels, f"{model} flash {site}",
                              f"flash_attention ({model} {site})",
                              nbytes, flops, ms, plain, lib, err)
        report[site] = dict(max_abs_err=err, err_over_bar=ratio,
                            control_over_bar=control, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=bms, bound_by=by)
        log_time(stats,
                 f"flash_attention bf16 {model} {site} B={b} S={s} "
                 f"S_kv={t} H={h} Hk={hk} dh={dh} causal={causal} window="
                 f"{window}: max abs "
                 f"err {err}, over the bar {ratio}, control {control}; "
                 f"kernel_ms={ms} ({bms / ms} of the bound) plain_ms={plain}"
                 f" library_ms(SDPA)={lib} (kernel / SDPA {ms / lib}) "
                 f"bound_ms={bms} ({by})")
    for site, shape in decode_shapes.items():
        b, t, h, hk, dh = shape[:5]
        window = shape[5] if len(shape) > 5 else 0
        least = shape[6] if len(shape) > 6 else 129
        q = _bf16(gen, (b, h, dh), dev)
        k = torch.randn((b, t, hk, dh), generator=gen, device=dev)  # fp32
        v = torch.randn((b, t, hk, dh), generator=gen, device=dev)
        if site == "cross decode":        # every frame, every row
            kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
        else:                             # prompts of 128..1024 + steps
            kv_len = torch.randint(least, t + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        got = decode_attention_cuda(q, k, v, kv_len, window=window)
        want = ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len, window=window)
        err, ratio = decode_check(got, want)
        ctl = decode_attention_cuda(q, k, v, kv_len - 1,
                                    window=max(window - 1, 0))
        control = decode_check(ctl, want)[1]
        if not (ratio <= 1.0 and control >= CONTROL_MIN):
            fail(f"{model} {site} B={b} T={t} window={window}: error over "
                 f"the bar {ratio} (at most 1), control {control} (at "
                 f"least {CONTROL_MIN})")
        ms = cuda_ms(lambda: decode_attention_cuda(q, k, v, kv_len,
                                                   window=window), 1000)
        qms = queued_ms(lambda: decode_attention_cuda(q, k, v, kv_len,
                                                      window=window), 200)
        plain = cuda_ms(lambda: ref.decode_attention_ref(
            q, k, v, kv_len, window=window), 5)
        rows = torch.arange(t, device=dev)[None]
        mask = rows < kv_len[:, None]
        if window:
            mask &= rows >= kv_len[:, None] - window
        mask = mask[:, None, None]
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.float()[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 20)
        n_kv = float(mask.sum())
        nbytes = n_kv * hk * dh * 4 * 2 + 2.0 * 2 * b * h * dh + 4 * b
        bms, by = _site_entry(kernels, f"{model} {site}",
                              f"decode_attention ({model} {site})",
                              nbytes, 4.0 * h * dh * n_kv, ms, plain, lib,
                              err)
        report[site] = dict(max_abs_err=err, err_over_bar=ratio,
                            control_over_bar=control, ms=ms, queued_ms=qms,
                            plain_ms=plain, library_ms=lib, bound_ms=bms,
                            bound_by=by)
        log_time(stats,
                 f"decode_attention q bf16, cache fp32, {model} {site} B={b} "
                 f"T={t} H={h} Hk={hk} dh={dh} window={window}, {int(n_kv)} "
                 f"valid rows: max "
                 f"abs err {err}, over the bar {ratio}, control {control}; "
                 f"kernel_ms={ms} ({bms / ms} of the bound) queued_ms={qms} "
                 f"({bms / qms} of the bound) plain_ms={plain}"
                 f" library_ms(SDPA, fp32, mask)={lib} bound_ms={bms} ({by})")
    stats[f"{model}_attention"] = report


def launch_router(dev):
    """The launcher's router at D = 1536: fitted on its corpus (60 prompts
    per dataset, costs linspace(1, 8, 4)). Returns (router, corpus)."""
    from repro_torch.core.router import EagleConfig, EagleRouter
    from repro_torch.data.routerbench import make_corpus, pairwise_feedback
    corpus = make_corpus(seed=0, n_per_dataset=60, dim=DIM,
                         model_names=list(LAUNCH_FLEET),
                         costs=np.linspace(1.0, 8.0, len(LAUNCH_FLEET)))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    router = EagleRouter(list(LAUNCH_FLEET), corpus.costs,
                         EagleConfig(embed_dim=DIM), db_capacity=1 << 15,
                         device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    return router, corpus


def compare_sharded_engine(dev, fleet, stats):
    """Over the launcher fleet's models: a ServingEngine with a 2-shard DB
    mesh on the card and the prebaker, one with the launcher's obs plane
    (`build_obs_plane` over an enabled scope), and an unsharded one, each
    behind a fresh launcher router and warmed for SERVE_BATCH, serve the
    same SERVE_BATCH requests: equal choices and tokens, and no graph
    captured by any serve(); the plane's /quality counts SERVE_BATCH
    decisions and each of its six routes answers 200."""
    from repro_torch import graphs
    from repro_torch import obs as OBS
    from repro_torch.launch.mesh import make_db_mesh
    from repro_torch.launch.serve import build_obs_plane, quality_oracle
    from repro_torch.obs.exporter import ROUTES
    from repro_torch.serving import ServingEngine
    engines, res = {}, {}
    for name, kw in (("flat", {}), ("sharded", dict(
            mesh=make_db_mesh(2, devices=[dev, dev]), prebake=True)),
            ("obs", dict(obs=OBS.Observability(enabled=True)))):
        router, corpus = launch_router(dev)
        kw.setdefault("obs", OBS.Observability())
        engines[name] = ServingEngine(
            fleet, router, compare_rate=0.25, seed=0,
            quality_oracle=quality_oracle, gen_bucket=True,
            gen_pad_len=LAUNCH_PAD_LEN, warmup_batch_sizes=(SERVE_BATCH,),
            **kw)
    plane = build_obs_plane(engines["obs"])
    vocab = min(m.cfg.vocab for m in fleet.values())
    wall = {}
    c0 = graphs.capture_count()
    for name, eng in engines.items():
        reqs = serve_requests(corpus, np.random.default_rng(LAUNCH_SEED + 1),
                              SERVE_BATCH, vocab)
        t0 = time.perf_counter()
        res[name] = eng.serve(reqs)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        check_responses(eng, reqs, res[name], f"{name} engine")
    captured = graphs.capture_count() - c0
    statuses = {}
    for path in ROUTES:
        with urllib.request.urlopen(plane.url(path), timeout=30) as r:
            body = r.read()
            statuses[path] = r.status
        if path == "/quality":
            decisions = json.loads(body)["decisions"]
    plane.stop()
    differ = {name: [r.rid for r, w in zip(res[name], res["flat"])
                     if r.model != w.model
                     or not np.array_equal(r.tokens, w.tokens)]
              for name in ("sharded", "obs")}
    log_time(stats,
             f"ServingEngine(mesh=2 shards, prebake=True) and one with the "
             f"launcher's obs plane against the unsharded engine over the "
             f"launcher fleet: {SERVE_BATCH} requests, models "
             f"{sorted({r.model for r in res['flat']})}, responses "
             f"differing {differ}; serve() wall s {wall}; graphs captured "
             f"by the serve() calls {captured}; the plane's routes "
             f"{statuses}, /quality decisions {decisions}; stats "
             f"{engines['sharded'].stats}")
    stats["sharded_engine"] = dict(differing=differ["sharded"], wall_s=wall,
                                   captured=captured)
    stats["obs_engine"] = dict(differing=differ["obs"], statuses=statuses,
                               decisions=decisions)
    if any(differ.values()) or captured:
        fail(f"the sharded and obs engines' responses {differ} differ from "
             f"the unsharded engine's; {captured} graphs captured by "
             f"serve()")
    if decisions != SERVE_BATCH or set(statuses.values()) != {200}:
        fail(f"the obs engine's plane: /quality decisions {decisions}, "
             f"routes {statuses}")


def build_launch_fleet(dev, serving, stats):
    """A ServingEngine over ARCH_IDS[:4] at full width and depth
    (whisper-large-v3 and mamba2-780m made here, olmo-1b and qwen3-8b
    taken from the serving phase's engine: the same configs and
    weights), bf16 compute, fp32 caches of SERVE_MAX_LEN rows, groups
    padded to LAUNCH_PAD_LEN tokens (gen_bucket, gen_pad_len: mamba2's
    chunk of 256 divides every group), behind a router fitted at
    D = 1536 with the launcher's costs linspace(1, 8, 4)."""
    from repro_torch import obs as OBS
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.serve import quality_oracle
    from repro_torch.serving import FleetModel, ServingEngine
    names = list(ARCH_IDS[:4])
    if tuple(names) != LAUNCH_FLEET:
        fail(f"the launcher's default fleet is {names}")
    router, corpus = launch_router(dev)
    fleet = {}
    for i, name in enumerate(names):
        if name in serving.fleet:
            fleet[name] = serving.fleet[name]
            continue
        t0 = time.perf_counter()
        fleet[name] = FleetModel(get_config(name), seed=i,
                                 max_len=SERVE_MAX_LEN, device=dev)
        torch.cuda.synchronize()
        cfg = fleet[name].cfg
        n_params = sum(x.numel() for x in _leaves(fleet[name].params))
        log(f"{name} ({cfg.arch_type}): {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}"
            f", d_model {cfg.d_model}, {n_params / 1e9:.3f}B parameters, "
            f"compute {cfg.dtype}; init + cast "
            f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(fleet, router, compare_rate=0.25, seed=0,
                           quality_oracle=quality_oracle, gen_bucket=True,
                           gen_pad_len=LAUNCH_PAD_LEN,
                           obs=OBS.Observability())
    engine.warmup()
    torch.cuda.empty_cache()
    return engine, corpus


def warm_launch_fleet(engine, stats):
    """Capture every model's decode graphs for LAUNCH_BUCKETS rows (the
    static states sized at the largest) and run a generate of
    LAUNCH_PAD_LEN tokens at each (engine.warmup_generate). Reports the
    captures, their seconds, the static states' memory (from their
    shapes) and the process's graph pools (the route graphs' too)."""
    t0 = time.perf_counter()
    n = engine.warmup_generate(LAUNCH_PAD_LEN, batch_sizes=LAUNCH_BUCKETS)
    warm_s = time.perf_counter() - t0
    pools = graph_pool_gb()
    state_gb = {name: sum(x.numel() * x.element_size()
                          for x in _leaves(m._cache)) / 1e9
                for name, m in engine.fleet.items()}
    ledgers = {name: {k: v for k, v in m.cache_stats().items()}
               for name, m in engine.fleet.items()}
    log_time(stats,
             f"launcher fleet warmup: {n} decode graphs captured for "
             f"{LAUNCH_BUCKETS} rows in {warm_s:.1f} s (with a generate at "
             f"each); static decode states GB {state_gb} (rows "
             f"{ {k: m.rows for k, m in engine.fleet.items()} }); graph "
             f"pools in the process (the decode graphs of the four models, "
             f"the launch router's route graphs) {pools:.2f} GB; ledgers "
             f"{ledgers}")
    stats["launch_warmup"] = dict(captured=n, warm_s=warm_s,
                                  state_gb=state_gb, pools_gb=pools,
                                  ledgers=ledgers)


@contextlib.contextmanager
def count_sites(engine):
    """Inside: each attention kernel launch carries the label of its call
    site, "<model> <site>" (`_build.site`; flash: causal, encoder (S =
    S_kv, no mask) or cross (S != S_kv); decode: cross over a model's
    n_audio_frames rows, else self; " ring" after a call over a local
    layer's ring cache (window_cache), " window" after a windowed call's:
    gemma3's local layers). A graph captured inside keeps the
    labels in its recording, and each replay is credited under them, so
    `site_launches()` attributes replayed launches too."""
    from unittest import mock
    from repro_torch.kernels import _build
    from repro_torch.models import layers as L
    flash, decode = L.flash_attention_cuda, L.decode_attention_cuda
    current = {}

    def flash_site(q, k, v, **kw):
        site = "flash causal" if kw.get("causal", True) else \
            "flash encoder" if k.shape[1] == q.shape[1] else "flash cross"
        if kw.get("window"):
            site += " window"
        with _build.site(f"{current['model']} {site}"):
            return flash(q, k, v, **kw)

    def decode_site(q, k, v, kv_len, **kw):
        m = engine.fleet[current["model"]]
        cfg = m.cfg
        site = "decode cross" if cfg.arch_type == "encdec" \
            and k.shape[1] == cfg.n_audio_frames else "decode self"
        if cfg.window_cache and k.shape[1] < m.max_len:
            site += " ring"          # a local layer's ring of W slots
        if kw.get("window"):
            site += " window"
        with _build.site(f"{current['model']} {site}"):
            return decode(q, k, v, kv_len, **kw)

    def tracked(name, method):
        def run(*a, **kw):
            current["model"] = name
            return method(*a, **kw)
        return run

    for name, m in engine.fleet.items():
        m.generate = tracked(name, m.generate)
        m.warmup = tracked(name, m.warmup)
    try:
        with mock.patch.object(L, "flash_attention_cuda", flash_site), \
                mock.patch.object(L, "decode_attention_cuda", decode_site):
            yield
    finally:
        for m in engine.fleet.values():
            del m.generate, m.warmup


def site_launches():
    """The launches since the last reset by call-site label (summed over
    the kernels), and "graph <kernel>" for a replayed graph's launches
    that carry no label (the route graphs)."""
    from repro_torch.kernels import _build
    sites = {}
    for (kernel, label), n in _build.site_counts().items():
        key = label or f"graph {kernel}"
        sites[key] = sites.get(key, 0) + n
    return sites


def drive_launch_fleet(engine, corpus, stats):
    """LAUNCH_CALLS serve() calls of SERVE_BATCH requests (prompts of
    128..1024 tokens, MAX_NEW new tokens, budgets over [1, 10], 25% fed
    back), then ADMIT_REQUESTS requests through an
    AdmissionQueue.for_engine on the real clock at Poisson arrivals of
    ADMIT_RATE req/s (`traffic.poisson_arrivals`, each request stamped
    with its arrival time; a window of ADMIT_WINDOW, the queue's default
    max wait of 5 ms). Every response is checked; every model must
    answer a group."""
    from repro_torch.serving.admission import AdmissionQueue
    from repro_torch.serving.traffic import poisson_arrivals
    rng = np.random.default_rng(LAUNCH_SEED)
    db0 = engine.router.db.size
    wall, groups = [], {n: 0 for n in engine.fleet}
    vocab = min(m.cfg.vocab for m in engine.fleet.values())
    for call in range(LAUNCH_CALLS):
        reqs = serve_requests(corpus, rng, SERVE_BATCH, vocab)
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        check_responses(engine, reqs, res, f"serve() call {call}")
        for name in {r.model for r in res}:
            groups[name] += 1
    queue = AdmissionQueue.for_engine(engine, window_bucket=ADMIT_WINDOW)
    reqs = serve_requests(corpus, rng, ADMIT_REQUESTS, vocab)
    arrivals = poisson_arrivals(ADMIT_RATE, ADMIT_REQUESTS, seed=LAUNCH_SEED)
    # open loop on the real clock: every request whose arrival time has
    # passed is submitted (stamped with that time) before the queue is
    # pumped; then sleep to the next arrival or flush deadline
    done, i, t0 = [], 0, time.perf_counter_ns()
    due_at = [t0 + int(a) for a in arrivals]
    while i < len(reqs) or queue.depth:
        while i < len(reqs) and due_at[i] <= queue.now_ns():
            reqs[i].arrival_ns = due_at[i]
            if queue.submit(reqs[i]) is not None:
                fail(f"the admission queue rejected request {reqs[i].rid}")
            i += 1
        done += queue.pump()
        wake = [t for t in (due_at[i] if i < len(reqs) else None,
                            queue.next_flush_ns()) if t is not None]
        if wake:
            time.sleep(max(0.0, (min(wake) - queue.now_ns()) / 1e9))
    torch.cuda.synchronize()
    check_responses(engine, reqs, sorted((c.response for c in done),
                                         key=lambda r: r.rid), "admission")
    for name in {c.response.model for c in done}:
        groups[name] += 1
    summary = queue.summary()
    waits = [c.wait_us / 1e3 for c in done]
    e2e = [c.e2e_us / 1e3 for c in done]
    st = engine.stats
    if engine.router.db.size != db0 + st["feedback"] or not st["commits"]:
        fail(f"feedback not committed: {st}, DB {engine.router.db.size} "
             f"rows on {db0}")
    if min(groups.values()) == 0:
        fail(f"a model of the launcher's fleet served no group: {groups}")
    p50 = statistics.median(wall)
    log_time(stats,
             f"launcher fleet at full width: {LAUNCH_CALLS} serve() calls "
             f"of {SERVE_BATCH}: wall s {wall}, p50 {p50:.3f} s; admission "
             f"of {ADMIT_REQUESTS} at {ADMIT_RATE} req/s: {summary}, "
             f"flushes (reason, n) "
             f"{[(f.reason, f.n) for f in queue.flush_log]}, wait ms p50 "
             f"{statistics.median(waits):.1f} max {max(waits):.1f}, e2e ms "
             f"p50 {statistics.median(e2e):.1f} max {max(e2e):.1f}; stats "
             f"{st}; groups per model {groups}")
    stats["launch_fleet"] = dict(
        serve_wall_s=wall, serve_p50_s=p50, admission=summary,
        flushes=[(f.reason, f.n) for f in queue.flush_log],
        wait_ms=waits, e2e_ms=e2e, stats=st, groups=groups)


# ---------------------------------------------------------------------------
# phase 10b: the moe family, phi3.5-moe at full width beside olmo-1b
# ---------------------------------------------------------------------------

def build_moe_fleet(dev, stats):
    """A ServingEngine over MOE_FLEET: olmo-1b at full width and depth,
    phi3.5-moe at full width and MOE_LAYERS layers (each block cast to
    bf16 as it is drawn), fp32 caches of SERVE_MAX_LEN rows, groups
    padded to LAUNCH_PAD_LEN tokens and the row ladder, behind a router
    fitted at D = 1536 with costs linspace(1, 8, 2)."""
    import dataclasses
    from repro_torch import obs as OBS
    from repro_torch.configs import get_config
    from repro_torch.core.router import EagleConfig, EagleRouter
    from repro_torch.data.routerbench import make_corpus, pairwise_feedback
    from repro_torch.launch.serve import quality_oracle
    from repro_torch.models.config import count_params
    from repro_torch.serving import FleetModel, ServingEngine
    names = list(MOE_FLEET)
    corpus = make_corpus(seed=0, n_per_dataset=60, dim=DIM,
                         model_names=names,
                         costs=np.linspace(1.0, 8.0, len(names)))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    router = EagleRouter(names, corpus.costs, EagleConfig(embed_dim=DIM),
                         db_capacity=1 << 15, device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    fleet = {}
    for i, name in enumerate(names):
        cfg = get_config(name)
        if name == MOE_MODEL:
            full = cfg
            cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fleet[name] = FleetModel(cfg, seed=i, max_len=SERVE_MAX_LEN,
                                 device=dev)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in _leaves(fleet[name].params))
        gb = sum(x.numel() * x.element_size()
                 for x in _leaves(fleet[name].params)) / 1e9
        experts = f", {cfg.n_experts} experts of {cfg.expert_ff}, top-" \
            f"{cfg.experts_per_tok}" if cfg.n_experts else ""
        log(f"{name} ({cfg.arch_type}): {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads{experts}"
            f", {n_params / 1e9:.3f}B parameters ({gb:.2f} GB), compute "
            f"{cfg.dtype}; init + cast {time.perf_counter() - t0:.1f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    stats["moe_model"] = dict(
        layers=MOE_LAYERS, of_layers=full.n_layers,
        params=sum(x.numel() for x in _leaves(fleet[MOE_MODEL].params)),
        full_params=count_params(full))
    engine = ServingEngine(fleet, router, compare_rate=0.25, seed=0,
                           quality_oracle=quality_oracle, gen_bucket=True,
                           gen_pad_len=LAUNCH_PAD_LEN,
                           obs=OBS.Observability())
    engine.warmup()
    torch.cuda.empty_cache()
    return engine, corpus


def drive_moe_fleet(engine, corpus, stats):
    """MOE_CALLS serve() calls of SERVE_BATCH requests (prompts of
    128..1024 tokens, MAX_NEW new tokens, budgets over [1, 10], 25% fed
    back), drawn with MOE_SEED: every response checked, phi must answer
    a group in each call."""
    rng = np.random.default_rng(MOE_SEED)
    db0 = engine.router.db.size
    vocab = min(m.cfg.vocab for m in engine.fleet.values())
    wall, groups = [], []
    for call in range(MOE_CALLS):
        reqs = serve_requests(corpus, rng, SERVE_BATCH, vocab)
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        check_responses(engine, reqs, res, f"MoE fleet serve() call {call}")
        groups.append({n: sum(r.model == n for r in res)
                       for n in engine.fleet})
    st = engine.stats
    if engine.router.db.size != db0 + st["feedback"] or not st["commits"]:
        fail(f"MoE fleet: feedback not committed: {st}")
    if not all(g[MOE_MODEL] for g in groups):
        fail(f"{MOE_MODEL} answered no group in a serve() call: {groups}")
    p50 = statistics.median(wall)
    log_time(stats,
             f"MoE fleet {list(engine.fleet)}: {MOE_CALLS} serve() calls of "
             f"{SERVE_BATCH}: requests per model {groups}; wall s {wall}, "
             f"p50 {p50:.3f} s; stats {st}")
    stats["moe_fleet"] = dict(serve_wall_s=wall, serve_p50_s=p50,
                              groups=groups, stats=st)


def moe_err_over_bar(cfg, ffn, x):
    """The MoE FFN on bf16 `x` (B, S, d) with a layer's bf16 weights,
    against the same function in fp32 on the same values: (max abs
    error, the largest ratio of an element's error to its bar, pairs
    dropped by the device's slots, pairs the host drops from the same
    top-k). The bar: MOE_SIGMAS (`moe_bar`)."""
    from repro_torch.models import moe as MOE
    b, s, d = x.shape
    got = MOE.apply_moe(cfg, ffn, x)[0].float().reshape(b * s, d)
    want, bar, dp = moe_bar(cfg, ffn, x)
    err = (got - want).abs()
    ratio = float((err / bar).nan_to_num(nan=0.0).max())
    # the slots on the host: each pair the next of its expert, in order
    flat = dp.top_e.reshape(-1).cpu().numpy()
    host_drops = int(sum(max(0, int((flat == ex).sum()) - dp.cap)
                         for ex in range(cfg.n_experts)))
    return float(err.max()), ratio, int((~dp.keep).sum()), host_drops


def moe_bar(cfg, ffn, x):
    """(the fp32 evaluation (T, d), the MoE bar (T, d), the fp32 dispatch)
    of the bf16 FFN on `x` (B, S, d): the bar is MOE_SIGMAS sigma + 4u
    sum_k w_k |y_k| (derivation at MOE_SIGMAS)."""
    import torch.nn.functional as F
    from repro_torch.models import moe as MOE
    u = MOE_ROUND
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.experts_per_tok
    p32 = {n: ffn[n].detach().float() for n in ("router", "w_gate", "w_up",
                                                "w_down")}
    xt = x.detach().float().reshape(t, d)
    want = MOE.apply_moe(cfg, p32, xt[None])[0][0]
    dp = MOE.dispatch(cfg, p32["router"], xt)
    buf = torch.cat([xt, xt.new_zeros((1, d))])[dp.src].view(e, dp.cap, d)
    g = torch.bmm(buf, p32["w_gate"])
    h = F.silu(g) * torch.bmm(buf, p32["w_up"])
    a = 1.0 + g * (1.0 - torch.sigmoid(g))
    var = torch.bmm((a * a + 3.0) * h * h, p32["w_down"].square())
    del g, a, buf
    y_k = torch.bmm(h, p32["w_down"]).abs().view(-1, d)
    var = var.view(-1, d) * (u * u / 3.0)
    idx = torch.where(dp.keep, dp.pair, 0)
    w = dp.top_w.reshape(-1, 1) * dp.keep[:, None]
    sigma = (var[idx] * w * w).view(t, k, d).sum(1).sqrt()
    return want, MOE_SIGMAS * sigma + 4.0 * u * (y_k[idx] * w).view(
        t, k, d).sum(1), dp


@torch.inference_mode()
def check_moe_ffn(m, stats):
    """phi's first layer's MoE FFN at MOE_FFN_SHAPES (the activations
    seeded normal values in bf16, as a unit-scale norm gives them)
    against its fp32 evaluation within the bar at MOE_SIGMAS; the pairs
    dropped on the device equal the host's count from the same top-k.
    Each timed (bf16; the decode size queued): the FFN's device time
    for the share of the step it takes."""
    from repro_torch.models import moe as MOE
    cfg, ffn = m.cfg, m.params["blocks"][0]["ffn"]
    gen = torch.Generator(device=m.device).manual_seed(9)
    report = {}
    for case, (b, s) in MOE_FFN_SHAPES.items():
        x = _bf16(gen, (b, s, cfg.d_model), m.device)
        err, ratio, drops, host = moe_err_over_bar(cfg, ffn, x)
        torch.cuda.empty_cache()
        if not ratio <= 1.0 or drops != host:
            fail(f"MoE FFN {case} ({b} x {s} tokens): error over the bar "
                 f"{ratio} (at most 1), pairs dropped {drops}, on the host "
                 f"{host}")
        run = lambda: MOE.apply_moe(cfg, ffn, x)
        # ~50 launches a call: 8 queued stay well inside a stream's queue
        ms = cuda_ms(run, 10) if s > 1 else queued_ms(run, 8)
        report[case] = dict(tokens=b * s, capacity=MOE.capacity(cfg, b * s),
                            max_abs_err=err, err_over_bar=ratio,
                            dropped=drops, ms=ms)
        log_time(stats,
                 f"MoE FFN bf16 ({cfg.n_experts} experts of "
                 f"{cfg.expert_ff}, top-{cfg.experts_per_tok}) at {b} x {s} "
                 f"tokens, capacity {MOE.capacity(cfg, b * s)}: max abs err "
                 f"{err} against fp32, over the bar {ratio} (bar "
                 f"{MOE_SIGMAS} sigma + 4u sum_k w_k |y_k|); pairs dropped "
                 f"{drops} (host {host}); device ms a layer {ms}")
    stats["moe_ffn"] = report


def moe_share(stats):
    """The MoE FFN's share of phi's prefill (8 x 1024) and of its
    decode step through the graph (batch 8): MOE_LAYERS times one
    layer's FFN time (check_moe_ffn) over the profiled device time
    (profile_decode)."""
    ffn = stats["moe_ffn"]
    share = {
        "prefill": MOE_LAYERS * ffn["prefill"]["ms"]
        / stats[f"profile_prefill_{MOE_MODEL}"]["device_ms"],
        "decode": MOE_LAYERS * ffn["decode"]["ms"]
        / stats[f"profile_graph_{MOE_MODEL}"]["device_ms"]}
    log_time(stats, f"{MOE_MODEL}: the MoE FFN's share of the device time "
             f"(16 layers x one layer's FFN over the profiled total): "
             f"prefill of 8 x 1024 {share['prefill']}, decode step at "
             f"batch 8 through its graph {share['decode']}")
    stats["moe_share"] = share


def drive_launcher_fleet5(stats):
    """The launcher with `--fleet 5` at its reduced configs: in process,
    build_engine(n_fleet=5) serves 8 requests of which phi3.5-moe
    answers at least one (the first test prompt the router sends to phi
    at a budget of 10, then 7 at budgets over [1, 10]); then the CLI,
    `python -m repro_torch.launch.serve --fleet 5 --requests 17 --budget
    10`, must exit 0 with its stats line."""
    from repro_torch import obs as OBS
    from repro_torch.launch import serve as LS
    from repro_torch.serving import Request
    t0 = time.perf_counter()
    engine, corpus = LS.build_engine(n_fleet=5, obs=OBS.Observability())
    build_s = time.perf_counter() - t0
    names = list(engine.fleet)
    test = corpus.test_idx
    choice = engine.router.route(corpus.embeddings[test],
                                 np.full(len(test), 10.0, np.float32))
    phi = [int(i) for i in np.nonzero(
        choice.cpu().numpy() == names.index(MOE_MODEL))[0]]
    if not phi:
        fail(f"the launcher's router sends no test prompt to {MOE_MODEL}")
    rng = np.random.default_rng(0)
    idx = [phi[0]] + [i for i in range(len(test)) if i != phi[0]][:7]
    reqs = [Request(tokens=rng.integers(0, 100, rng.integers(4, 12)).astype(
                        np.int32),
                    embedding=corpus.embeddings[test[i]],
                    budget=10.0 if k == 0 else float(rng.uniform(1, 10)),
                    max_new_tokens=4, rid=k)
            for k, i in enumerate(idx)]
    res = engine.serve(reqs)
    torch.cuda.synchronize()
    check_responses(engine, reqs, res, "launcher --fleet 5 serve()")
    models = sorted({r.model for r in res})
    if MOE_MODEL not in models:
        fail(f"launcher --fleet 5: {MOE_MODEL} answered none of {models}")
    del engine
    t1 = time.perf_counter()
    out = launch_cli("--fleet", "5", "--requests", "17", "--budget", "10")
    cli_s = time.perf_counter() - t1
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines or not lines[-1].startswith("stats:"):
        fail(f"python -m repro_torch.launch.serve --fleet 5 exited "
             f"{out.returncode}: {out.stdout[-2000:]}{out.stderr[-2000:]}")
    log_time(stats, f"launcher --fleet 5 (reduced {names}): built in "
             f"{build_s:.1f} s, serve() of 8: models answering {models}; "
             f"python -m repro_torch.launch.serve --fleet 5 --requests 17 "
             f"--budget 10: exit 0 in {cli_s:.1f} s; {lines[-1]}")
    stats["launcher_fleet5"] = dict(build_s=build_s, models=models,
                                    cli_s=cli_s, cli_last=lines[-1])


def drive_moe(dev, kernels, stats):
    """The moe family's phase: phi's attention call sites, the MoE fleet
    served with every decode graph warmed (launches per call site,
    nothing captured, peak memory), greedy tokens through the graphs
    against the eager path's, phi's kernel path against its plain path,
    its MoE FFN against fp32, its times and profiles, then the launcher
    with --fleet 5. Returns (launches, launches by call site) of the
    served run."""
    from repro_torch import graphs
    from repro_torch.kernels import _build
    # the launcher fleet's models sit in reference cycles (a decode
    # graph's step holds its model's bound method): free them first
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory held before the MoE phase "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    check_site_attention(dev, kernels, stats, "phi", PHI_FLASH, PHI_DECODE,
                         seed=7)
    torch.cuda.empty_cache()
    engine, corpus = build_moe_fleet(dev, stats)
    with count_sites(engine):
        t0 = time.perf_counter()
        n = engine.warmup_generate(LAUNCH_PAD_LEN, batch_sizes=LAUNCH_BUCKETS)
        log_time(stats, f"MoE fleet warmup: {n} decode graphs captured for "
                 f"{LAUNCH_BUCKETS} rows in {time.perf_counter() - t0:.1f} "
                 f"s (with a generate at each); graph pools "
                 f"{graph_pool_gb():.2f} GB")
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        c0 = graphs.capture_count()
        drive_moe_fleet(engine, corpus, stats)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    sites = site_launches()
    credited = _build.credited_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    captured = graphs.capture_count() - c0
    stats.update(moe_launches=launches, moe_sites=sites,
                 moe_peak_mem_gb=peak, moe_captures=captured)
    log(f"launches on the MoE fleet's run: {launches}, of which credited by "
        f"graph replays {credited}; by call site {sites}; graphs captured "
        f"in the run {captured}")
    log_time(stats, f"peak device memory of the MoE fleet's run (phi at "
             f"{MOE_LAYERS} layers and olmo-1b: weights, static decode "
             f"states, graph pools, activations): {peak:.2f} GB")
    missing = [k for k in ("flash_attention", "decode_attention")
               if not launches[k]] + [
        k for k, site in PHI_SITES.items()
        if not sites.get(f"{MOE_MODEL} {site}")]
    if missing:
        fail(f"never launched on the MoE fleet's run: {missing}")
    if captured:
        fail(f"{captured} graphs captured after warmup on the MoE fleet's "
             "run")
    if credited.get("decode_attention") != launches["decode_attention"]:
        fail(f"decode launches {launches['decode_attention']}, of which "
             f"credited by replays {credited.get('decode_attention')}: the "
             "decode path left its graphs")
    if peak >= 80.0:
        fail(f"the MoE fleet's peak device memory {peak:.2f} GB")
    compare_graph_generate(engine, stats, key="moe_graph_tokens_differing")
    compare_model_paths(engine, stats, names=(MOE_MODEL,))
    check_moe_ffn(engine.fleet[MOE_MODEL], stats)
    time_serving(engine, stats, names=(MOE_MODEL,))
    for what in ("prefill", "graph"):
        profile_decode(engine, stats, MOE_MODEL, what=what)
    moe_share(stats)
    del engine, corpus
    gc.collect()
    torch.cuda.empty_cache()
    drive_launcher_fleet5(stats)
    return launches, sites


# ---------------------------------------------------------------------------
# phase 10c: the dense families at full width and depth
# ---------------------------------------------------------------------------

def check_window_bite(dev, stats):
    """WINDOW_BITE: the flash kernel at S = 4096 and the decode kernel over
    4,096 rows, both with gemma3's window of 1024 and head width 256, where
    the window drops most keys: each against its plain version with the
    window (the bars of phase 6), and the same call without the window,
    the control, must fail the bar by CONTROL_MIN. Each timed beside its
    bound, the plain version and SDPA with the band as an explicit
    mask."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(11)
    report = {}
    b, s, h, hk, dh, w = WINDOW_BITE["flash"]
    q = _bf16(gen, (b, s, h, dh), dev)
    k = _bf16(gen, (b, s, hk, dh), dev)
    v = _bf16(gen, (b, s, hk, dh), dev)
    got = flash_attention_cuda(q, k, v, causal=True, window=w)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=w)
    atol = flash_atol(q, k, v, causal=True, window=w)
    err, ratio = flash_check(got, want, atol)
    control = flash_check(flash_attention_cuda(q, k, v, causal=True), want,
                          atol)[1]
    if not (ratio <= 1.0 and control >= CONTROL_MIN):
        fail(f"flash window {w} at S={s}: error over the bar {ratio} (at "
             f"most 1), without the window {control} (at least "
             f"{CONTROL_MIN})")
    band = _band(s, s, w, dev)
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True,
                                              window=w), 20)
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                    window=w), 3)
    lib = cuda_ms(lambda: _sdpa(q, k, v, attn_mask=band), 20)
    nbytes = 2.0 * (2 * b * s * h * dh + 2 * b * s * hk * dh)
    bms, by = bound_ms(nbytes, 4.0 * b * h * dh * float(band.sum()),
                       PEAK_BF16_FLOPS)
    report["flash"] = dict(max_abs_err=err, err_over_bar=ratio,
                           control_over_bar=control, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=bms, bound_by=by)
    log_time(stats,
             f"flash_attention bf16 window {w} biting: B={b} S={s} H={h} "
             f"Hk={hk} dh={dh}: max abs err {err}, over the bar {ratio}, "
             f"without the window {control}; kernel_ms={ms} ({bms / ms} of "
             f"the bound) plain_ms={plain} library_ms(SDPA, band mask)="
             f"{lib} bound_ms={bms} ({by})")
    del q, k, v, got, want, atol, band
    b, t, h, hk, dh, w, least = WINDOW_BITE["decode"]
    q = _bf16(gen, (b, h, dh), dev)
    k = torch.randn((b, t, hk, dh), generator=gen, device=dev)   # fp32
    v = torch.randn((b, t, hk, dh), generator=gen, device=dev)
    kv_len = torch.randint(least, t + 1, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    got = decode_attention_cuda(q, k, v, kv_len, window=w)
    want = ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype), kv_len,
                                    window=w)
    err, ratio = decode_check(got, want)
    control = decode_check(decode_attention_cuda(q, k, v, kv_len), want)[1]
    if not (ratio <= 1.0 and control >= CONTROL_MIN):
        fail(f"decode window {w} over T={t}: error over the bar {ratio} (at "
             f"most 1), without the window {control} (at least "
             f"{CONTROL_MIN})")
    rows = torch.arange(t, device=dev)[None]
    mask = ((rows < kv_len[:, None]) & (rows >= kv_len[:, None] - w))
    run = lambda: decode_attention_cuda(q, k, v, kv_len, window=w)
    qms = queued_ms(run, 200)
    ms = cuda_ms(run, 1000)
    plain = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, kv_len,
                                                     window=w), 5)
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.float()[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None], enable_gqa=True), 20)
    n_kv = float(mask.sum())
    bms, by = bound_ms(n_kv * hk * dh * 4 * 2 + 2.0 * 2 * b * h * dh + 4 * b,
                       4.0 * h * dh * n_kv, PEAK_BF16_FLOPS)
    report["decode"] = dict(max_abs_err=err, err_over_bar=ratio,
                            control_over_bar=control, ms=ms, queued_ms=qms,
                            plain_ms=plain, library_ms=lib, bound_ms=bms,
                            bound_by=by)
    log_time(stats,
             f"decode_attention q bf16, cache fp32, window {w} biting: B={b} "
             f"T={t} H={h} Hk={hk} dh={dh}, kv_len {least}..{t}, "
             f"{int(n_kv)} rows in the windows: max abs err {err}, over the "
             f"bar {ratio}, without the window {control}; kernel_ms={ms} "
             f"queued_ms={qms} ({bms / qms} of the bound) plain_ms={plain} "
             f"library_ms(SDPA, fp32, mask)={lib} bound_ms={bms} ({by})")
    stats["window_bite"] = report


def build_dense_engine(dev, name, olmo, seed, stats, cfg=None):
    """A ServingEngine over olmo-1b (`olmo`, shared by the dense phase's
    engines) and `name` at full width and depth (each block cast to bf16
    as it is drawn; `cfg`: another depth), an fp32 cache of SERVE_MAX_LEN
    rows (llava: DENSE_MAX_LEN), groups padded to LAUNCH_PAD_LEN tokens
    and the row ladder, behind a router fitted at D = 1536 with costs
    linspace(1, 8, 2)."""
    from repro_torch import obs as OBS
    from repro_torch.configs import get_config
    from repro_torch.core.router import EagleConfig, EagleRouter
    from repro_torch.data.routerbench import make_corpus, pairwise_feedback
    from repro_torch.launch.serve import quality_oracle
    from repro_torch.models.config import count_params
    from repro_torch.serving import FleetModel, ServingEngine
    names = ["olmo-1b", name]
    corpus = make_corpus(seed=0, n_per_dataset=60, dim=DIM,
                         model_names=names,
                         costs=np.linspace(1.0, 8.0, len(names)))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    router = EagleRouter(names, corpus.costs, EagleConfig(embed_dim=DIM),
                         db_capacity=1 << 15, device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    cfg = cfg or get_config(name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FleetModel(cfg, seed=seed,
                       max_len=DENSE_MAX_LEN.get(name, SERVE_MAX_LEN),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(model.params))
    gb = sum(x.numel() * x.element_size()
             for x in _leaves(model.params)) / 1e9
    kinds = {k: cfg.layer_kinds().count(k) for k in set(cfg.layer_kinds())}
    heads = (f"MLA over {cfg.n_heads} heads of {cfg.qk_nope_dim} + "
             f"{cfg.qk_rope_dim} / {cfg.v_head_dim}, latent "
             f"{cfg.kv_lora_rank}" if cfg.attn_kind == "mla" else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}")
    log(f"{name} ({cfg.arch_type}): {cfg.n_layers} layers {kinds}, d_model "
        f"{cfg.d_model}, {heads}"
        f"{f', {cfg.n_image_tokens} image rows' if cfg.n_image_tokens else ''}"
        f", {n_params / 1e9:.3f}B parameters ({gb:.2f} GB; count_params "
        f"{count_params(cfg) / 1e9:.3f}B), cache of {model.max_len} rows; "
        f"init + cast {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    stats.setdefault("dense_models", {})[name] = dict(
        layers=cfg.n_layers, params=n_params, gb=gb, max_len=model.max_len)
    engine = ServingEngine({"olmo-1b": olmo, name: model}, router,
                           compare_rate=0.25, seed=0,
                           quality_oracle=quality_oracle, gen_bucket=True,
                           gen_pad_len=LAUNCH_PAD_LEN,
                           obs=OBS.Observability())
    engine.warmup()
    torch.cuda.empty_cache()
    return engine, corpus


def drive_dense_engine(engine, corpus, name, stats):
    """DENSE_CALLS serve() calls of SERVE_BATCH requests (prompts of
    128..1024 tokens, MAX_NEW new tokens, budgets over [1, 10], 25% fed
    back), drawn with DENSE_SEED: every response checked, `name` must
    answer a group in each call."""
    rng = np.random.default_rng(DENSE_SEED)
    db0 = engine.router.db.size
    vocab = min(m.cfg.vocab for m in engine.fleet.values())
    wall, groups = [], []
    for call in range(DENSE_CALLS):
        reqs = serve_requests(corpus, rng, SERVE_BATCH, vocab)
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        check_responses(engine, reqs, res, f"{name} serve() call {call}")
        groups.append({n: sum(r.model == n for r in res)
                       for n in engine.fleet})
    st = engine.stats
    if engine.router.db.size != db0 + st["feedback"] or not st["commits"]:
        fail(f"{name} engine: feedback not committed: {st}")
    if not all(g[name] for g in groups):
        fail(f"{name} answered no group in a serve() call: {groups}")
    p50 = statistics.median(wall)
    log_time(stats,
             f"{name} beside olmo-1b: {DENSE_CALLS} serve() calls of "
             f"{SERVE_BATCH}: requests per model {groups}; wall s {wall}, "
             f"p50 {p50:.3f} s; stats {st}")
    return dict(serve_wall_s=wall, serve_p50_s=p50, groups=groups, stats=st)


def serve_full_model(engine, corpus, name, want_sites, stats):
    """One full-width model's engine (build_dense_engine's, beside
    olmo-1b): decode graphs warmed, served (drive_dense_engine) with
    launches per call site, nothing captured, every site of `want_sites`
    launched, peak memory under 80 GB; greedy tokens through the graphs
    against the eager path's, the kernel path against the plain path,
    TTFT and the decode step, and a profile of a replayed step. Returns
    (report, launches, launches by call site) of the served run."""
    from repro_torch import graphs
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with count_sites(engine):
        n = engine.warmup_generate(LAUNCH_PAD_LEN,
                                   batch_sizes=LAUNCH_BUCKETS)
        log_time(stats, f"{name} engine warmup: {n} decode graphs "
                 f"captured for {LAUNCH_BUCKETS} rows (with a generate "
                 f"at each); graph pools {graph_pool_gb():.2f} GB")
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        c0 = graphs.capture_count()
        report = drive_dense_engine(engine, corpus, name, stats)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    run_sites = site_launches()
    credited = _build.credited_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    captured = graphs.capture_count() - c0
    report.update(launches=launches, sites=run_sites, peak_mem_gb=peak,
                  captures=captured)
    log(f"launches on the {name} engine's run: {launches}, of which "
        f"credited by graph replays {credited}; by call site {run_sites}; "
        f"graphs captured in the run {captured}")
    log_time(stats, f"peak device memory of the {name} engine's run (with "
             f"olmo-1b: weights, static decode states, graph pools, "
             f"activations): {peak:.2f} GB")
    missing = [k for k in ("flash_attention", "decode_attention")
               if not launches[k]] + [
        site for site in want_sites if not run_sites.get(site)]
    if missing:
        fail(f"never launched on the {name} engine's run: {missing}")
    if captured:
        fail(f"{captured} graphs captured after warmup on the {name} "
             "engine's run")
    if credited.get("decode_attention") != launches["decode_attention"]:
        fail(f"{name}: decode launches {launches['decode_attention']}, of "
             f"which credited by replays {credited.get('decode_attention')}"
             ": the decode path left its graphs")
    if peak >= 80.0:
        fail(f"the {name} engine's peak device memory {peak:.2f} GB")
    compare_graph_generate(engine, stats, names=(name,),
                           key=f"graph_tokens_differing_{name.split('-')[0]}")
    compare_model_paths(engine, stats, names=(name,))
    time_serving(engine, stats, names=(name,))
    profile_decode(engine, stats, name, what="graph")
    report["wall_s"] = time.perf_counter() - t0
    return report, launches, run_sites


def drive_launcher_fleet10(stats):
    """The launcher with `--fleet 10` at its reduced configs (every model
    of ARCH_IDS: the dense families, zamba2-7b's hybrid stack and
    deepseek-v3's MLA last): in process, build_engine(n_fleet=10) serves
    16 requests at budgets over [1, 10] (every answer checked; its warmup
    generated on every model, the new ones among them); then the CLI,
    `python -m repro_torch.launch.serve --fleet 10 --requests 16`, must
    exit 0 with its stats line."""
    from repro_torch import obs as OBS
    from repro_torch.launch import serve as LS
    from repro_torch.serving import Request
    t0 = time.perf_counter()
    engine, corpus = LS.build_engine(n_fleet=10, obs=OBS.Observability())
    build_s = time.perf_counter() - t0
    names = list(engine.fleet)
    if names[5:] != list(DENSE_MODELS + HYBRID_MODELS):
        fail(f"launcher --fleet 10 built {names}")
    rng = np.random.default_rng(0)
    test = corpus.test_idx
    reqs = [Request(tokens=rng.integers(0, 100, rng.integers(4, 12)).astype(
                        np.int32),
                    embedding=corpus.embeddings[test[i]],
                    budget=float(rng.uniform(1, 10)), max_new_tokens=4,
                    rid=i) for i in range(16)]
    res = engine.serve(reqs)
    torch.cuda.synchronize()
    check_responses(engine, reqs, res, "launcher --fleet 10 serve()")
    models = sorted({r.model for r in res})
    del engine
    gc.collect()
    t1 = time.perf_counter()
    out = launch_cli("--fleet", "10", "--requests", "16")
    cli_s = time.perf_counter() - t1
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines or not lines[-1].startswith("stats:"):
        fail(f"python -m repro_torch.launch.serve --fleet 10 exited "
             f"{out.returncode}: {out.stdout[-2000:]}{out.stderr[-2000:]}")
    log_time(stats, f"launcher --fleet 10 (reduced {names}): built in "
             f"{build_s:.1f} s, serve() of 16: models answering {models}; "
             f"python -m repro_torch.launch.serve --fleet 10 --requests 16: "
             f"exit 0 in {cli_s:.1f} s; {lines[-1]}")
    stats["launcher_fleet10"] = dict(build_s=build_s, models=models,
                                     cli_s=cli_s, cli_last=lines[-1])


def drive_dense(dev, kernels, stats):
    """The dense families' phase: their attention call sites and the
    biting window, then each of DENSE_MODELS at full width and depth
    beside olmo-1b, one engine at a time (`serve_full_model`). Returns
    (launches by model, launches by call site) of the served runs."""
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving import FleetModel
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"device memory held before the dense phase "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    for i, short in enumerate(DENSE_FLASH):
        check_site_attention(dev, kernels, stats, short, DENSE_FLASH[short],
                             DENSE_DECODE[short], seed=20 + i)
        torch.cuda.empty_cache()
    check_window_bite(dev, stats)
    torch.cuda.empty_cache()
    olmo = FleetModel(get_config("olmo-1b"), seed=0, max_len=SERVE_MAX_LEN,
                      device=dev)
    launches, sites, report = {}, {}, {}
    for i, name in enumerate(DENSE_MODELS):
        engine, corpus = build_dense_engine(dev, name, olmo, i + 1, stats)
        short = name.split("-")[0]    # DENSE_FLASH's and DENSE_SITES' key
        report[name], launches[name], run_sites = serve_full_model(
            engine, corpus, name,
            [v for k, v in DENSE_SITES.items() if k.startswith(short + " ")],
            stats)
        sites.update({k: v for k, v in run_sites.items()
                      if k.startswith(name)})
        del engine, corpus
        gc.collect()
        torch.cuda.empty_cache()
    del olmo
    gc.collect()
    torch.cuda.empty_cache()
    stats["dense"] = report
    stats["dense_phase_s"] = time.perf_counter() - t_phase
    log_time(stats, f"dense phase wall: {stats['dense_phase_s']:.1f} s "
             f"(engines: { {n: r['wall_s'] for n, r in report.items()} })")
    return launches, sites


# ---------------------------------------------------------------------------
# phase 10c': the dry-run sweep, gemma3's ring caches, gemma3 x long_500k
# ---------------------------------------------------------------------------

def drive_dryrun(stats):
    """(a): the sweep (`repro_torch.launch.dryrun --all`, the meta
    device) into a temporary directory, its records checked
    (DRYRUN_OK ok, DRYRUN_SKIPPED skipped, no error), then the roofline
    report over them against the card's memory; logs the table and the
    sweep's seconds."""
    import io
    from benchmarks_torch import roofline as RF
    from repro_torch.launch import dryrun as DR
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = DR.main(["--all", "--force", "--out", tmp])
        sweep_s = time.perf_counter() - t0
        recs = RF.load_records(tmp)
        status = {}
        for r in recs:
            status[r["status"]] = status.get(r["status"], 0) + 1
        errors = [f"{r['arch']} x {r['shape']}: {r.get('error')}"
                  for r in recs if r["status"] == "error"]
        if rc or errors or status.get("ok") != DRYRUN_OK or \
                status.get("skipped") != DRYRUN_SKIPPED:
            fail(f"dry-run sweep: exit {rc}, records {status} (want "
                 f"{DRYRUN_OK} ok, {DRYRUN_SKIPPED} skipped), errors "
                 f"{errors}")
        total = torch.cuda.get_device_properties(0).total_memory
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = RF.run(dryrun=Path(tmp), out=Path(tmp) / "roofline.json",
                          hbm_bytes=total)
    trace_s = sum(r.get("elapsed_s", 0.0) for r in recs)
    log(buf.getvalue().rstrip())
    workers = min(DR.MAX_WORKERS, os.cpu_count() or 1, len(recs))
    log_time(stats, f"dry-run sweep (repro_torch.launch.dryrun --all, the "
             f"meta device, {workers} processes): {status}, "
             f"{sweep_s:.1f} s wall ({trace_s:.1f} s of counting over the "
             f"combos); roofline against the card's total_memory {total} "
             f"bytes")
    stats["dryrun"] = dict(status=status, sweep_s=sweep_s, trace_s=trace_s,
                           total_memory=total, roofline=rows,
                           records={f"{r['arch']} x {r['shape']}": {
                               k: r.get(k) for k in (
                                   "status", "flops_per_device",
                                   "bytes_per_device", "memory",
                                   "model_flops_global", "analytic",
                                   "elapsed_s")} for r in recs})


@torch.inference_mode()
def compare_ring_full(m, stats):
    """gemma3-12b's ring caches against its full caches on the same
    weights: a padded group of COMPARE_LENS prompts (padded to
    LAUNCH_PAD_LEN = W rows) through prefill and MAX_NEW - 1 decode
    steps, both fed the full path's tokens: the logits within
    LOGIT_REL_BAR of the full path's at every step, greedy tokens equal
    but at near-ties."""
    import dataclasses
    from repro_torch.models import transformer as T
    full = dataclasses.replace(m.cfg, window_cache=False)
    lens = COMPARE_LENS[RING_KEY]
    rng = np.random.default_rng(12)
    toks = np.zeros((len(lens), LAUNCH_PAD_LEN), np.int32)
    for row, n in enumerate(lens):
        toks[row, :n] = rng.integers(0, m.cfg.vocab, n)
    toks = torch.tensor(toks, dtype=torch.int64, device=m.device)
    out = {c: T.prefill(c, m.params, toks, m.max_len,
                        cache_dtype=torch.float32) for c in (m.cfg, full)}
    w = out[m.cfg][1]["kv_local"]["k"].shape[2]
    rel, flips, ties = [], 0, 0
    for step in range(MAX_NEW):
        lr, lf = out[m.cfg][0].float(), out[full][0].float()
        diff = (lr - lf).abs()
        rel.append(float(diff.max() / lf.abs().max()))
        top2 = torch.topk(lf, 2, dim=-1).values
        tied = (top2[:, 0] - top2[:, 1]) <= 2 * diff.max(dim=-1).values
        differ = lr.argmax(-1) != lf.argmax(-1)
        flips += int(differ.sum())
        ties += int((differ & tied).sum())
        if int((differ & ~tied).sum()):
            fail(f"gemma3 ring vs full caches, step {step}: a greedy token "
                 "differs without a near-tie")
        if step == MAX_NEW - 1:
            break
        tok = lf.argmax(-1)[:, None]
        out = {c: T.decode_step(c, m.params, out[c][1], tok,
                                LAUNCH_PAD_LEN + step) for c in out}
    del out
    if max(rel) > LOGIT_REL_BAR:
        fail(f"gemma3 ring vs full caches: logits differ by {max(rel)} of "
             f"the largest (bar {LOGIT_REL_BAR})")
    log(f"gemma3-12b, ring caches of {w} slots (local layers) vs full "
        f"caches of {m.max_len} rows, a group of {len(lens)} prompts of "
        f"{lens} tokens padded to {LAUNCH_PAD_LEN}, prefill + "
        f"{MAX_NEW - 1} decode steps (positions {LAUNCH_PAD_LEN}.."
        f"{LAUNCH_PAD_LEN + MAX_NEW - 2}: the ring wraps at the first): "
        f"max |dlogit| / max |logit| per step {rel} (bar {LOGIT_REL_BAR}); "
        f"greedy tokens differing {flips}, all at near-ties ({ties})")
    stats["ring_vs_full"] = dict(rel_logit_diff=rel, token_flips=flips,
                                 near_ties=ties)


def drive_ring_engine(dev, kernels, stats):
    """(b): gemma3-12b with ring caches beside olmo-1b, served as the
    dense phase serves gemma3 (`serve_full_model`, its seed and
    requests); its logits against the full caches'; its ring decode site
    against its plain version. Returns (launches, launches by site)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import FleetModel
    check_site_attention(dev, kernels, stats, "gemma3 ring", {},
                         RING_DECODE, seed=25)
    torch.cuda.empty_cache()
    olmo = FleetModel(get_config("olmo-1b"), seed=0, max_len=SERVE_MAX_LEN,
                      device=dev)
    cfg = dataclasses.replace(get_config("gemma3-12b"), window_cache=True)
    seed = 1 + DENSE_MODELS.index("gemma3-12b")     # the dense phase's
    engine, corpus = build_dense_engine(dev, RING_KEY, olmo, seed, stats,
                                        cfg=cfg)
    m = engine.fleet[RING_KEY]
    w = T.ring_shape(cfg, m.max_len)[2]
    if w != cfg.sliding_window or LAUNCH_PAD_LEN % w:
        fail(f"gemma3 ring: {w} slots against prompts padded to "
             f"{LAUNCH_PAD_LEN}")
    want = [f"{RING_KEY} {site}" for site in (
        "flash causal window", "flash causal", "decode self ring",
        "decode self")]
    report, launches, run_sites = serve_full_model(engine, corpus, RING_KEY,
                                                   want, stats)
    compare_ring_full(m, stats)
    step = stats["serve_times"][RING_KEY]["graph"]["device_ms"]
    full = stats["serve_times"].get("gemma3-12b", {}).get("graph", {})
    log_time(stats, f"gemma3-12b decode step at batch {TIME_BATCH} through "
             f"its graph: ring caches {step:.3f} ms (device), full caches "
             f"{full.get('device_ms')} ms in this run")
    stats["ring_engine"] = report
    del engine, corpus, m, olmo
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {k: v for k, v in run_sites.items()
                      if k.startswith(RING_KEY)}


def _ref_by_head(q, k, v, kv_len, **kw):
    """ref.decode_attention_ref (`kw`: its scale and window) one KV head
    at a time: the same values, with one head's fp32 copy of the cache
    alive at once (a 524,288-row layer is 4.3 GB of K in fp32 a head
    group)."""
    from repro_torch.kernels import ref
    hk, rep = k.shape[2], q.shape[1] // k.shape[2]
    return torch.cat([ref.decode_attention_ref(
        q[:, j * rep:(j + 1) * rep], k[:, :, j:j + 1].to(q.dtype),
        v[:, :, j:j + 1].to(q.dtype), kv_len, **kw) for j in range(hk)],
        dim=1)


@contextlib.contextmanager
def long_sites(worst=None):
    """Inside: each decode kernel call carries the label of its long_500k
    site (LONG_SITES: a ring of W slots, or a global layer's full
    cache); with `worst`, each call is also held against its plain
    version (`_ref_by_head`), its largest error over the decode bar kept
    there."""
    from unittest import mock
    from repro_torch.kernels import _build
    from repro_torch.models import layers as L
    decode = L.decode_attention_cuda

    def labelled(q, k, v, kv_len, **kw):
        where = "local" if k.shape[1] < LONG_INDEX else "global"
        with _build.site(f"gemma3-12b long {where}"):
            got = decode(q, k, v, kv_len, **kw)
        if worst is not None:   # with the call's scale: q comes scaled
            ratio = decode_check(got, _ref_by_head(q, k, v, kv_len,
                                                   **kw))[1]
            worst[where] = max(worst.get(where, 0.0), ratio)
        return got

    with mock.patch.object(L, "decode_attention_cuda", labelled):
        yield


def check_long_site(dev, kernels, stats, key, k, v, gen):
    """One long_500k decode site on the layer's own cache (B = 1): a bf16
    query that looks for the newest key (each head: that key's K plus
    N(0, 0.25) noise, so the newest key's weight dominates the softmax
    over every row), the kernel against `_ref_by_head`, and the control
    (kv_len - 1: the newest key dropped) failing the bar by CONTROL_MIN;
    timed beside its bound, the plain version and SDPA."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    b, t, hk, dh = k.shape
    h = 16
    kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    newest = k[:, t - 1].float().repeat_interleave(h // hk, dim=1)
    q = (newest + 0.25 * torch.randn(newest.shape, generator=gen,
                                     device=dev)).to(torch.bfloat16)
    got = decode_attention_cuda(q, k, v, kv_len)
    want = _ref_by_head(q, k, v, kv_len)
    err, ratio = decode_check(got, want)
    control = decode_check(decode_attention_cuda(q, k, v, kv_len - 1),
                           want)[1]
    if not (ratio <= 1.0 and control >= CONTROL_MIN):
        fail(f"{key} T={t}: error over the bar {ratio} (at most 1), "
             f"control {control} (at least {CONTROL_MIN})")
    ms = cuda_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 20)
    plain = cuda_ms(lambda: _ref_by_head(q, k, v, kv_len), 2)
    try:
        lib = cuda_ms(lambda: _sdpa(q[:, None], k, v)[:, 0], 20)
    except torch.OutOfMemoryError:        # beside 58 GB of arguments
        lib = None
        torch.cuda.empty_cache()
    nbytes = 2.0 * t * hk * dh * k.element_size() + 2.0 * 2 * b * h * dh
    bms, by = _site_entry(kernels, key, f"decode_attention ({key})", nbytes,
                          4.0 * h * dh * t, ms, plain, lib, err)
    log_time(stats, f"decode_attention q bf16, cache bf16, {key}: B={b} "
             f"T={t} H={h} Hk={hk} dh={dh}, every row valid: max abs err "
             f"{err}, over the bar {ratio}, control {control}; kernel_ms="
             f"{ms} ({bms / ms} of the bound) plain_ms={plain} library_ms"
             f"(SDPA, bf16, GQA; None: out of memory)={lib} bound_ms={bms} "
             f"({by})")
    return dict(max_abs_err=err, err_over_bar=ratio,
                control_over_bar=control, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


@torch.inference_mode()
def drive_long_context(dev, kernels, stats):
    """(c): gemma3-12b x long_500k with ring caches, executed once at full
    size: the dry-run's record of the combo (--window-cache
    --bf16-params), then its argument trees on the card (bf16 weights
    from LONG_SEED, bf16 caches drawn from it: 8 global layers of
    524,288 rows and 40 rings of 1,024 slots holding the positions before
    LONG_INDEX), decode_step at LONG_INDEX through the kernels and
    through the plain attend (logits within LOGIT_REL_BAR), each decode
    call held against its plain version, the two sites with controls,
    the allocator against the record (ALLOC_ROUND, LONG_TEMP_*), the
    step timed by CUDA events. Returns launches by site."""
    import dataclasses
    from repro_torch import graphs
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import input_specs
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import transformer as T
    with tempfile.TemporaryDirectory() as tmp:
        rec = DR.run_combo("gemma3-12b", "long_500k", "card", Path(tmp),
                           force=True, bf16_params=True, window_cache=True)
    if rec["status"] != "ok":
        fail(f"dry-run of gemma3-12b x long_500k: {rec.get('error')}")
    mem = rec["memory"]
    cfg = dataclasses.replace(get_config("gemma3-12b"), window_cache=True,
                              param_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(LONG_SEED)
    params = T.init_params(cfg, gen)
    spec = input_specs(cfg, "long_500k", device=dev)
    cache = spec["cache"]
    for kv in (cache["kv_local"], cache["kv_global"]):
        for name in ("k", "v"):
            kv[name].normal_(generator=gen)
    # slot j holds the last position before LONG_INDEX that is j mod W
    w = cache["kv_local"]["k"].shape[2]
    slot = torch.arange(w, device=dev)
    last = LONG_INDEX - 1
    cache["kv_local"]["pos"].copy_((slot + w * ((last - slot) // w)).to(
        torch.int32).expand_as(cache["kv_local"]["pos"]))
    del slot
    tokens = spec["tokens"].random_(0, cfg.vocab, generator=gen)
    index = spec["index"].fill_(LONG_INDEX)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    leaves = TR.leaves(params) + TR.leaves(cache) + [tokens, index]
    args = mem["argument_size_in_bytes"]
    slack = sum(ALLOC_ROUND if x.numel() * x.element_size() <= 1 << 20
                else (1 << 20) + ALLOC_ROUND for x in leaves)
    if not 0 <= held - args < slack:
        fail(f"long_500k: the allocator holds {held} bytes after the setup, "
             f"the dry-run counts {args} argument bytes ({len(leaves)} "
             f"tensors: the rounding stays under {slack})")

    def step(backend):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, _ = T.decode_step(cfg, params, cache, tokens, index,
                                  backend=backend)
        torch.cuda.synchronize()
        return logits.float(), torch.cuda.max_memory_allocated() - base

    _build.reset_launches()
    with long_sites():
        got, peak_k = step("cuda")
    torch.cuda.synchronize()
    sites = site_launches()
    launches = _build.launch_counts()
    kinds = cfg.layer_kinds()
    want_sites = {v: kinds.count(kind) for v, kind in zip(
        LONG_SITES.values(), ("local", "global"))}
    if any(sites.get(k) != n for k, n in want_sites.items()) or \
            launches["decode_attention"] != len(kinds):
        fail(f"long_500k step: decode launches by site {sites}, want "
             f"{want_sites}")
    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(run):
        run()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    eager_ms = timed(lambda: T.decode_step(cfg, params, cache, tokens,
                                           index))
    # the device's time: the step captured, as FleetModel runs it
    graph = graphs.Step(lambda: T.decode_step(cfg, params, cache, tokens,
                                              index), device=dev)
    step_ms = timed(graph)
    del graph
    want, peak_r = step("reference")
    rel = float((got - want).abs().max() / want.abs().max())
    worst = {}
    with long_sites(worst):
        T.decode_step(cfg, params, cache, tokens, index)
    report = {}
    gen_q = torch.Generator(device=dev).manual_seed(LONG_SEED + 1)
    for key, layer in (("gemma3 long_500k decode local", cache["kv_local"]),
                       ("gemma3 long_500k decode global",
                        cache["kv_global"])):
        report[key] = check_long_site(dev, kernels, stats, key, layer["k"][0],
                                      layer["v"][0], gen_q)
    temp = mem["temp_size_in_bytes"]
    over_k, over_r = peak_k - held, peak_r - held
    param_bytes = sum(x.numel() * x.element_size() for x in TR.leaves(params))
    cache_bytes = sum(x.numel() * x.element_size() for x in TR.leaves(cache))
    bms, by = bound_ms(param_bytes + cache_bytes, rec["flops_per_device"],
                       PEAK_BF16_FLOPS)
    log_time(stats,
             f"gemma3-12b x long_500k (ring caches, bf16): {param_bytes} "
             f"bytes of weights, {cache_bytes} of caches, set up in "
             f"{setup_s:.1f} s; the allocator holds {held} bytes, the "
             f"dry-run counts {args} argument bytes; decode_step at "
             f"{LONG_INDEX} through the kernels (CUDA events over {reps} "
             f"steps): {step_ms:.3f} ms through a captured graph (bound "
             f"{bms:.3f} ms, {by}: {bms / step_ms} of it), {eager_ms:.3f} ms "
             f"eagerly; logits within {rel} of the plain path's (bar "
             f"{LOGIT_REL_BAR}); every decode call over its bar (at most 1) "
             f"{worst}; peak above the arguments: kernels {over_k}, plain "
             f"{over_r}, the dry-run's temp {temp} (peak "
             f"{mem['peak_size_in_bytes']})")
    stats["long_500k"] = dict(
        record_memory=mem, record_flops=rec["flops_per_device"],
        held_bytes=held, param_bytes=param_bytes, cache_bytes=cache_bytes,
        step_ms=step_ms, eager_ms=eager_ms, bound_ms=bms, bound_by=by,
        rel_logit_diff=rel,
        calls_err_over_bar=worst, peak_over_args_kernels=over_k,
        peak_over_args_plain=over_r, setup_s=setup_s, sites=report,
        launches=sites)
    if rel > LOGIT_REL_BAR:
        fail(f"long_500k: kernel path logits differ by {rel} of the "
             f"largest from the plain path's (bar {LOGIT_REL_BAR})")
    if set(worst) != {"local", "global"} or max(worst.values()) > 1.0:
        fail(f"long_500k: a decode call misses its plain version: {worst}")
    if not over_k <= temp:
        fail(f"long_500k: the kernel path's peak is {over_k} bytes above the "
             f"arguments, over the dry-run's temp {temp}")
    if abs(over_r - temp) > LONG_TEMP_REL * temp + LONG_TEMP_ABS:
        fail(f"long_500k: the plain path's peak is {over_r} bytes above the "
             f"arguments, the dry-run's temp {temp} (bar {LONG_TEMP_REL} of "
             f"it + {LONG_TEMP_ABS})")
    del params, cache, spec, got, want, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return sites


def drive_dryrun_ring(dev, kernels, stats):
    """Phase 10c': gemma3's ring engine (b), gemma3 x long_500k (c), then
    the dry-run sweep and its roofline (a). Returns (ring launches, ring
    launches by site, long_500k launches by site)."""
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"device memory held before the dry-run and ring phase "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ring_launches, ring_sites = drive_ring_engine(dev, kernels, stats)
    long = drive_long_context(dev, kernels, stats)
    drive_dryrun(stats)
    stats["dryrun_ring_phase_s"] = time.perf_counter() - t_phase
    log_time(stats, f"dry-run and ring phase wall: "
             f"{stats['dryrun_ring_phase_s']:.1f} s")
    return ring_launches, ring_sites, long


# ---------------------------------------------------------------------------
# phase 10d: zamba2-7b (hybrid) and deepseek-v3's MLA
# ---------------------------------------------------------------------------

def drive_hybrid_mla(dev, kernels, stats):
    """The last two families: zamba2-7b's and deepseek-v3's attention call
    sites (HYBRID_FLASH, HYBRID_DECODE), then zamba2-7b at full width and
    depth and deepseek-v3 at full width and DEEPSEEK_LAYERS layers, each
    beside olmo-1b, one engine at a time (`serve_full_model`; zamba2's
    prefill profiled too: 68 mamba2 blocks of SSD panels), then the
    launcher with --fleet 10. Returns (launches by model, launches by
    call site) of the served runs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serving import FleetModel
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"device memory held before the hybrid and MLA phase "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    for i, short in enumerate(HYBRID_FLASH):
        check_site_attention(dev, kernels, stats, short, HYBRID_FLASH[short],
                             HYBRID_DECODE[short], seed=30 + i)
        torch.cuda.empty_cache()
    olmo = FleetModel(get_config("olmo-1b"), seed=0, max_len=SERVE_MAX_LEN,
                      device=dev)
    cfgs = {"zamba2-7b": get_config("zamba2-7b"),
            "deepseek-v3-671b": dataclasses.replace(
                get_config("deepseek-v3-671b"), n_layers=DEEPSEEK_LAYERS)}
    launches, sites, report = {}, {}, {}
    for i, name in enumerate(HYBRID_MODELS):
        t0 = time.perf_counter()
        engine, corpus = build_dense_engine(dev, name, olmo, i + 10, stats,
                                            cfg=cfgs[name])
        build_s = time.perf_counter() - t0
        short = name.split("-")[0]
        report[name], launches[name], run_sites = serve_full_model(
            engine, corpus, name,
            [v for k, v in HYBRID_SITES.items() if k.startswith(short + " ")],
            stats)
        report[name]["build_s"] = build_s
        if name == "zamba2-7b":
            profile_decode(engine, stats, name, what="prefill")
        sites.update({k: v for k, v in run_sites.items()
                      if k.startswith(name)})
        del engine, corpus
        gc.collect()
        torch.cuda.empty_cache()
    del olmo
    gc.collect()
    torch.cuda.empty_cache()
    stats["hybrid_mla"] = report
    drive_launcher_fleet10(stats)
    stats["hybrid_mla_phase_s"] = time.perf_counter() - t_phase
    log_time(stats, f"hybrid and MLA phase wall: "
             f"{stats['hybrid_mla_phase_s']:.1f} s (engines: "
             f"{ {n: (r['build_s'], r['wall_s']) for n, r in report.items()} }"
             f" s to build, s to serve and check)")
    return launches, sites


# ---------------------------------------------------------------------------
# phase 10e: training
# ---------------------------------------------------------------------------

def train_batches(cfg, n, dev, seed=0):
    """n synthetic batches (`loop.synthetic_lm_batches`) of
    TRAIN_CMP_SHAPE on the CPU, encdec's frame and vlm's image
    embeddings drawn beside them from `seed`, and their copies on
    `dev`."""
    from repro_torch.training.loop import synthetic_lm_batches
    b, s = TRAIN_CMP_SHAPE
    it = synthetic_lm_batches(cfg, b, s, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    cpu = []
    for _ in range(n):
        batch = dict(next(it))
        if cfg.arch_type == "encdec":
            batch["enc_embeds"] = torch.randn(
                b, cfg.n_audio_frames, cfg.d_model, generator=gen)
        if cfg.arch_type == "vlm":
            batch["img_embeds"] = torch.randn(
                b, cfg.n_image_tokens, cfg.d_model, generator=gen)
        cpu.append(batch)
    return cpu, [{k: v.to(dev) for k, v in x.items()} for x in cpu]


def train_grads(cfg, params, batch):
    """The gradient tree of loss_fn at `params` (the train step's route)."""
    from repro_torch.models import transformer as T
    from repro_torch import tree as TR
    leaves = TR.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = T.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(total, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return grads


def compare_training(dev, stats):
    """(a): each family's reduced config in fp32, the same weights and
    batches on the card and on the CPU: the step-1 gradients, then
    TRAIN_CMP_STEPS steps of make_train_step; the metric histories and
    the gradients held to their bars."""
    from repro_torch.configs import ARCH_IDS, get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.training import loop as TL
    from repro_torch import tree as TR
    from repro_torch.training.optim import AdamW
    report = {}
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_reduced_config(arch, dtype="float32")
        cpu_p = T.init_params(cfg, torch.Generator().manual_seed(0),
                              train=True)
        card_p = TR.map_tree(lambda x: x.to(dev, copy=True), cpu_p)
        cpu_b, card_b = train_batches(cfg, TRAIN_CMP_STEPS, dev)
        g_cpu = train_grads(cfg, cpu_p, cpu_b[0])
        g_card = train_grads(cfg, card_p, card_b[0])
        grad_err = max(float((a.cpu() - b).abs().max())
                       / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(g_card, g_cpu))
        hist = {}
        for where, p, batches in (("cpu", cpu_p, cpu_b),
                                  ("card", card_p, card_b)):
            opt = AdamW(lr=1e-3)
            state, step = opt.init(p), TL.make_train_step(cfg, opt)
            rows = []
            for batch in batches:
                p, state, m = step(p, state, batch)
                rows.append({k: float(v) for k, v in m.items()})
            hist[where] = rows
        metric_err = max(
            abs(c[k] - h[k]) / max(abs(h[k]), 1e-30)
            for c, h in zip(hist["card"], hist["cpu"]) for k in h)
        report[arch] = dict(
            grad_err=grad_err, metric_err=metric_err,
            ce=[r["ce"] for r in hist["card"]],
            aux=[r["aux"] for r in hist["card"]],
            mtp=[r["mtp"] for r in hist["card"]] if "mtp" in hist["card"][0]
            else None, wall_s=time.perf_counter() - t0)
        log(f"training {arch} (reduced, fp32), card against CPU: step-1 "
            f"gradients {grad_err:.3e} of their leaves' scale (bar "
            f"{TRAIN_GRAD_ATOL}), {TRAIN_CMP_STEPS}-step metric histories "
            f"{metric_err:.3e} relative (bar {TRAIN_METRIC_RTOL}); ce "
            f"{[round(x, 4) for x in report[arch]['ce']]}")
        if not (grad_err <= TRAIN_GRAD_ATOL
                and metric_err <= TRAIN_METRIC_RTOL):
            fail(f"training {arch}: card against CPU over the bar: "
                 f"gradients {grad_err:.3e}, metrics {metric_err:.3e}")
    return report


def train_full_width(stats):
    """(b): launch/train.py's main with TRAIN_ARGV on the card: ms per
    step over steps 1..19 (the ce reads at the logged steps wait for the
    device), tokens/s, the model FLOPs a step (6 N tokens + the attention
    products, 12 L d S a token, PaLM's count; remat's recompute not
    counted) over the bf16 peak, and the peak device memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    cfg = get_config("olmo-1b")
    argv = dict(zip(TRAIN_ARGV[::2], TRAIN_ARGV[1::2]))
    b, s = int(argv["--batch"]), int(argv["--seq"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = LT.main(list(TRAIN_ARGV))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    (i0, t0), (i1, t1) = out["wall"][0], out["wall"][-1]
    step_ms = 1e3 * (t1 - t0) / (i1 - i0)
    tokens = b * s
    n = cfg.total_params()
    flops = 6 * n * tokens + 12 * cfg.n_layers * cfg.d_model * s * tokens
    mfu = flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    ces = [ce for _, ce in out["history"]]
    res = dict(steps=i1 + 1, params=n, step_ms=step_ms,
               tokens_per_s=tokens / (step_ms / 1e3),
               model_tflop_per_step=flops / 1e12, mfu=mfu, peak_gb=peak,
               history=out["history"], wall=out["wall"],
               remat=cfg.remat, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype)
    log_time(stats, f"training olmo-1b at full width ({n / 1e9:.3f} B "
             f"parameters, {cfg.dtype} compute, {cfg.param_dtype} masters "
             f"and AdamW state, remat {cfg.remat}), batch {b} x seq {s}: "
             f"{step_ms:.1f} ms a step over steps {i0 + 1}..{i1}, "
             f"{res['tokens_per_s']:.0f} tokens/s, "
             f"{flops / 1e12:.2f} model TFLOP a step = {100 * mfu:.2f}% of "
             f"the bf16 peak, peak device memory {peak:.2f} GB; ce "
             f"{ces}")
    if not (all(np.isfinite(ces)) and ces[-1] < ces[0]):
        fail(f"training olmo-1b: ce {ces} is not finite and descending")
    res["profile"] = profile_train_step(cfg, out, b, s, stats)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def profile_train_step(cfg, out, b, s, stats):
    """Device time by kernel of one more full-width train step from the
    trained state (`out`: loop.train's result), and the device's busy
    share of its wall time under the profiler. Each kernel is sorted into
    a kind by its name (TRAIN_KERNEL_KINDS). A second step, profiled with
    torch's FLOP counts (which cost host time, so the busy share is
    read from the first), reads the matmuls from the ops that launched
    them (TRAIN_MATMUL_OPS): their kernels' time and FLOPs, by the kind
    of each op's longest kernel, so the rate each GEMM kind implies
    shows a kernel sorted into the wrong kind or a count that is off.
    The top kernels are logged by their full names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import loop as TL
    from repro_torch.training.optim import AdamW
    step = TL.make_train_step(cfg, AdamW(lr=3e-4))
    batch = next(TL.synthetic_lm_batches(
        cfg, b, s, seed=1, device=out["params"]["embed"].device))
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=activities, with_flops=True) as counted:
        step(out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()

    def kind_of(name):
        return next((k for k, marks in TRAIN_KERNEL_KINDS
                     if any(m in name for m in marks)), "other")

    rows = sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    top = [(op, kind_of(op), ms) for op, ms in rows[:12]]
    kinds = {}
    for op, ms in rows:
        kinds[kind_of(op)] = kinds.get(kind_of(op), 0.0) + ms
    # the matmul ops: each op's own kernels (ms) and torch's FLOP count
    matmul = {}
    for e in counted.events():
        if e.name not in TRAIN_MATMUL_OPS or not e.kernels:
            continue
        main = max(e.kernels, key=lambda k: k.duration).name
        row = matmul.setdefault(kind_of(main), {"ms": 0.0, "tflop": 0.0,
                                                "ops": 0, "kernels": {}})
        row["ms"] += sum(k.duration for k in e.kernels) / 1e3
        row["tflop"] += (e.flops or 0) / 1e12
        row["ops"] += 1
        for k in e.kernels:
            row["kernels"][k.name] = (row["kernels"].get(k.name, 0.0)
                                      + k.duration / 1e3)
    for row in matmul.values():
        row["tflop_per_s"] = row["tflop"] / (row["ms"] / 1e3)
    log_time(stats, f"profile of one olmo-1b train step (batch {b} x seq "
             f"{s}): wall {wall_ms} ms under the profiler, device "
             f"{device_ms} ms, busy {device_ms / wall_ms}; device ms by "
             f"kernel kind {kinds}; the matmul ops of a second step by "
             f"their longest kernel's kind: " + "; ".join(
                 f"{k}: {r['ops']} ops, {r['ms']} ms, {r['tflop']} TFLOP "
                 f"(torch's count), {r['tflop_per_s']} TFLOP/s"
                 for k, r in sorted(matmul.items())))
    for k, r in sorted(matmul.items()):
        names = sorted(r["kernels"].items(), key=lambda kv: -kv[1])
        log(f"  matmul kind {k}: kernels (ms) {names}")
    for op, kind, ms in top:
        log(f"  top kernel {ms} ms, kind {kind}: {op}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, kinds=kinds, top=top,
                matmul=matmul)


def checkpoint_round_trip(dev):
    """(c): reduced olmo-1b with its AdamW state in bf16: CKPT_STEPS
    steps uninterrupted, against CKPT_STEPS - 1 steps, a save, a restore
    into a fresh tree on the card and the last step; every leaf (fp32
    masters, bf16 moments, the int32 step) equal bit for bit."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import loop as TL
    from repro_torch import tree as TR
    from repro_torch.training.optim import AdamW
    cfg = get_reduced_config("olmo-1b")
    opt = AdamW(lr=1e-3, state_dtype=torch.bfloat16)
    step = TL.make_train_step(cfg, opt)
    _, batches = train_batches(cfg, CKPT_STEPS, dev, seed=5)

    def fresh():
        p = T.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                          train=True)
        return {"params": p, "opt": opt.init(p)}

    def run(tree, batches):
        for batch in batches:
            tree["params"], tree["opt"], _ = step(tree["params"],
                                                  tree["opt"], batch)
        return tree

    whole = run(fresh(), batches)
    part = run(fresh(), batches[:-1])
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(f"{d}/step_{CKPT_STEPS - 1}.npz", part,
                  step=CKPT_STEPS - 1)
        latest = CKPT.latest_step(d)
        resumed = CKPT.restore(f"{d}/step_{latest}.npz", fresh())
    resumed = run(resumed, batches[-1:])
    leaves = list(zip(TR.leaves(resumed), TR.leaves(whole)))
    dtypes = sorted({str(a.dtype) for a, _ in leaves})
    equal = all(a.device == b.device and a.dtype == b.dtype
                and torch.equal(a.detach(), b.detach()) for a, b in leaves)
    log(f"checkpoint round trip on the card (reduced olmo-1b, leaves of "
        f"{dtypes}, restored from step {latest}, then step {CKPT_STEPS}): "
        f"{'equal' if equal else 'NOT equal'} bit for bit to the "
        f"uninterrupted run over {len(leaves)} leaves")
    if not equal or latest != CKPT_STEPS - 1 or "torch.bfloat16" not in dtypes:
        fail("the checkpoint round trip on the card is not bit-equal")
    return dict(equal=equal, leaves=len(leaves), dtypes=dtypes)


def refuse_grad_kernels(dev):
    """The attention kernels have no backward: their wrappers raise on
    CUDA inputs that require grad (under grad mode), and launch under
    no_grad."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn(1, 8, 2, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 8, 2, 64, device=dev)
    lens = torch.full((1,), 8, dtype=torch.int32, device=dev)
    calls = {"flash": lambda: flash_attention_cuda(q, kv, kv),
             "decode": lambda: decode_attention_cuda(q[:, 0], kv, kv, lens)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"the {name} kernel's wrapper took an input that "
                 "requires grad")
        with torch.no_grad():
            call()


def drive_training(dev, stats):
    """Phase 10e: the training path (module docstring). Its attention is
    the plain attend (`transformer.TRAIN_ATTENTION`): the kernel counts,
    zeroed before the path runs, must read 0 after it. Returns them."""
    from repro_torch.kernels import _build
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"device memory held before the training phase "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    refuse_grad_kernels(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    report = {"families": compare_training(dev, stats)}
    report["olmo_1b"] = train_full_width(stats)
    report["checkpoint"] = checkpoint_round_trip(dev)
    t0 = time.perf_counter()
    small = _example("train_small").main(["--device", "cuda"])
    report["train_small"] = dict(history=small["history"],
                                 wall_s=time.perf_counter() - t0)
    del small
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"launches on the training path: {launches} (its attention is the "
        f"plain attend; the kernels have no backward)")
    if any(launches.values()):
        fail(f"the training path launched kernels: {launches}")
    report["wall_s"] = time.perf_counter() - t_phase
    stats["training"] = report
    log_time(stats, f"training phase wall: {report['wall_s']:.1f} s "
             f"(train_small: {report['train_small']['wall_s']:.1f} s, ce "
             f"{report['train_small']['history'][0][1]:.3f} -> "
             f"{report['train_small']['history'][-1][1]:.3f})")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10f: the fleet meshes
# ---------------------------------------------------------------------------

def sync(dev):
    """Wait for the device's queue (a CPU rehearsal has none)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_train(dev, stats):
    """(a): MESH_TRAIN_STEPS steps of olmo-1b at full width with and
    without a (1, 1) mesh from the same weights and batches, under an
    NCCL world of one rank (gloo on the CPU, for a rehearsal)."""
    import torch.distributed as dist
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import loop as TL
    from repro_torch.training.optim import AdamW
    cfg = get_config("olmo-1b")
    b, s = MESH_TRAIN
    if dev.type == "cuda":
        torch.cuda.set_device(0)     # the rank's card, before the mesh
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1, device=dev.type)
        it = TL.synthetic_lm_batches(cfg, b, s, seed=0, device=dev)
        batches = [next(it) for _ in range(MESH_TRAIN_STEPS)]
        first = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              train=True)
        runs = {}
        for name, m in (("no mesh", None), ("mesh (1, 1)", mesh)):
            params = TR.map_tree(torch.clone, first)
            opt = AdamW()
            state, step = opt.init(params), TL.make_train_step(
                cfg, opt, mesh=m)
            ms, ces = [], []
            for batch in batches:
                sync(dev)
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                ces.append(float(metrics["ce"]))    # waits for the step
                ms.append(1e3 * (time.perf_counter() - t0))
            runs[name] = dict(params=params, ces=ces, ms=ms)
    finally:
        dist.destroy_process_group()
    a, m = runs["no mesh"], runs["mesh (1, 1)"]
    pairs = list(zip(TR.leaves(m["params"]), TR.leaves(a["params"])))
    equal = sum(bool(torch.equal(x, y)) for x, y in pairs)
    param_err = max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                    for x, y in pairs)
    ce_err = max(abs(x - y) / abs(y) for x, y in zip(m["ces"], a["ces"]))
    res = dict(ces=m["ces"], ces_no_mesh=a["ces"], leaves=len(pairs),
               leaves_bit_equal=equal, param_err=param_err, ce_err=ce_err,
               step_ms=m["ms"], step_ms_no_mesh=a["ms"])
    log_time(stats, f"mesh (a): olmo-1b at full width, batch {b} x {s}, "
             f"{MESH_TRAIN_STEPS} steps on a (1, 1) mesh (NCCL, world 1) "
             f"against no mesh: ce {m['ces']} / {a['ces']}, {equal} of "
             f"{len(pairs)} parameter leaves bit-equal (largest difference "
             f"{param_err:.3e} of a leaf's scale); ms a step {m['ms']} "
             f"(no mesh {a['ms']})")
    if equal != len(pairs) and not (ce_err <= MESH_CE_RTOL
                                    and param_err <= MESH_PARAM_ATOL):
        fail(f"mesh (a): the (1, 1) mesh's steps against no mesh: ce "
             f"{ce_err:.3e}, parameters {param_err:.3e} of a leaf's scale")
    del runs, first, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _mesh_moe_rank(rank, port, out, cfg_name, device):
    """(b)'s rank: joins the gloo world of two, runs the layer sharded
    and unsharded (module notes at MESH_MOE_ARCH) and writes its numbers
    to out/rank<rank>.json."""
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as MOE
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_test_mesh(model=2, data=1, device=dev.type)
        cfg = get_config(cfg_name) if dev.type == "cuda" else \
            get_reduced_config(cfg_name)
        gen = torch.Generator(device=dev).manual_seed(MESH_MOE_SEED)
        ffn = MOE.init_moe(cfg, gen, torch.float32)
        for n in ("w_gate", "w_up", "w_down"):     # the router stays fp32
            ffn[n] = ffn[n].to(torch.bfloat16)
        b, s = MESH_MOE_TOKENS
        x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        cot = torch.randn(b, s, cfg.d_model, generator=gen, device=dev,
                          dtype=torch.bfloat16)
        names = ("router", "w_gate", "w_up", "w_down")

        def run(m):
            leaves = [x.detach().requires_grad_(True)] + [
                ffn[n].detach().requires_grad_(True) for n in names]
            p = dict(zip(names, leaves[1:]))
            y, aux = MOE.apply_moe(cfg, p, leaves[0], m)
            total = (y.float() * cot.float()).sum() + 0.5 * aux
            return (y.detach(), float(aux.detach()),
                    torch.autograd.grad(total, leaves))

        counter = DR.StepCounter()
        with counter:
            y, aux, grads = run(mesh)
        walls = []
        for m in (mesh, None):
            sync(dev)
            t0 = time.perf_counter()
            run(m)
            sync(dev)
            walls.append(1e3 * (time.perf_counter() - t0))
        y0, aux0, grads0 = run(None)
        want, bar, _ = moe_bar(cfg, ffn, x)
        t = b * s
        over = lambda got: float(((got.float().reshape(t, -1)
                                   - y0.float().reshape(t, -1)).abs()
                                  / bar).max())
        # the control: this rank's experts only, the combine dropped
        n = cfg.n_experts // 2
        lo = rank * n
        with torch.no_grad():
            alone, _ = MOE._experts(cfg, ffn["router"],
                                    x.reshape(t, cfg.d_model),
                                    *MOE._expert_slices(ffn, lo, n),
                                    e_lo=lo)
        rel = lambda g, w: float((g.float() - w.float()).abs().max()) / \
            max(float(w.float().abs().max()), 1e-30)
        experts = {nm: rel(g[lo:lo + n], w[lo:lo + n]) for nm, g, w in zip(
            names[1:], grads[2:], grads0[2:])}
        others = {nm: float(g[:lo].abs().max().item() if lo else 0.0) +
                  float(g[lo + n:].abs().max().item() if lo + n <
                        cfg.n_experts else 0.0)
                  for nm, g in zip(names[1:], grads[2:])}
        res = dict(rank=rank, tokens=t, capacity=MOE.capacity(cfg, t),
                   y_over_bar=over(y), control_over_bar=over(alone),
                   y_vs_fp32_over_bar=float(((y0.float().reshape(t, -1)
                                              - want).abs() / bar).max()),
                   y_bit_equal=bool(torch.equal(y, y0)),
                   aux=aux, aux_unsharded=aux0,
                   grad_x=rel(grads[0], grads0[0]),
                   grad_router=rel(grads[1], grads0[1]),
                   grad_experts=experts, grad_others_max=others,
                   collectives=counter.collectives, sharded_ms=walls[0],
                   unsharded_ms=walls[1], device=str(dev))
        (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mesh_moe(dev, stats):
    """(b): the two ranks in processes of their own (torch.multiprocessing,
    spawn), their reports checked against the bars."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_mesh_moe_rank, args=(free_port(), tmp, MESH_MOE_ARCH,
                                       dev.type), nprocs=2, join=True)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    for r in ranks:
        log_time(stats, f"mesh (b): {MESH_MOE_ARCH}'s MoE layer, "
                 f"{r['tokens']} tokens (capacity {r['capacity']}), rank "
                 f"{r['rank']} of (data=1, model=2) over gloo on "
                 f"{r['device']}: y over the MoE bar {r['y_over_bar']:.3e} "
                 f"(bit-equal {r['y_bit_equal']}; the unsharded bf16 call "
                 f"against fp32 {r['y_vs_fp32_over_bar']:.3f}), control "
                 f"{r['control_over_bar']:.1f}; aux {r['aux']} / "
                 f"{r['aux_unsharded']}; gradients x {r['grad_x']:.3e}, "
                 f"router {r['grad_router']:.3e}, its experts "
                 f"{r['grad_experts']} of each leaf's scale (the other "
                 f"rank's experts: {r['grad_others_max']}); gloo "
                 f"transfers {r['collectives']}; fwd + bwd "
                 f"{r['sharded_ms']:.1f} ms sharded, "
                 f"{r['unsharded_ms']:.1f} ms unsharded (wall)")
        bad = []
        if not r["y_over_bar"] <= 1.0:
            bad.append(f"y {r['y_over_bar']}")
        if not r["control_over_bar"] >= MESH_CONTROL_MIN:
            bad.append(f"control {r['control_over_bar']}")
        if not abs(r["aux"] - r["aux_unsharded"]) <= MESH_AUX_ATOL:
            bad.append(f"aux {r['aux']} / {r['aux_unsharded']}")
        if not (r["grad_x"] <= MESH_GRAD_BF16
                and r["grad_router"] <= MESH_GRAD_FP32
                and max(r["grad_experts"].values()) <= MESH_GRAD_BF16
                and not any(r["grad_others_max"].values())):
            bad.append(f"gradients x {r['grad_x']}, router "
                       f"{r['grad_router']}, experts {r['grad_experts']}, "
                       f"others {r['grad_others_max']}")
        if not r["collectives"].get("all-reduce_count"):
            bad.append(f"no all-reduce: {r['collectives']}")
        if bad:
            fail(f"mesh (b), rank {r['rank']}: {bad}")
    return ranks


def mesh_dryrun(stats):
    """(c): each MESH_DRYRUN combo through `repro_torch.launch.dryrun` in a
    process of its own (the fake world holds the process's group), side
    by side; the per-device argument bytes against the spec arithmetic,
    the collectives and the roofline's terms logged."""
    from benchmarks_torch import roofline as RF
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import input_specs
    from repro_torch.launch import dryrun as DR
    env = dict(os.environ, PYTHONPATH=str(SRC))
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", sh, "--mesh", m, "--force", "--out", tmp] +
            list(opts), env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for a, sh, m, opts in MESH_DRYRUN]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        wall = time.perf_counter() - t0
        bad = [f"{a} x {sh} x {m} {opts}: exit {p.returncode}: "
               f"{text[-2000:]}" for (a, sh, m, opts), p, text in
               zip(MESH_DRYRUN, procs, outs) if p.returncode]
        if bad:
            fail(f"mesh (c): {bad}")
        for a, sh, m, opts in MESH_DRYRUN:
            rec = json.loads((Path(tmp) / f"{a}__{sh}__{m}.json")
                             .read_text())
            kw = {o.lstrip("-").replace("-", "_"): True for o in opts}
            cfg, trees, specs = DR.mesh_arguments(
                get_config(a), MESH_SHAPES[m], input_specs(get_config(a),
                                                           sh), **kw)
            want = sum(SH.local_bytes(MESH_SHAPES[m], t, sp)
                       for t, sp in zip(trees, specs))
            got = rec["memory"]["argument_size_in_bytes"]
            row = RF.analyze(rec)
            report[f"{a} x {sh} x {m}{''.join(opts)}"] = dict(
                argument_bytes=got, spec_bytes=want,
                memory=rec["memory"], collectives=rec["collectives"],
                flops_per_device=rec["flops_per_device"],
                bytes_per_device=rec["bytes_per_device"],
                trace_s=rec["trace_s"], roofline=row)
            log(f"mesh (c): {a} x {sh} x {m} {' '.join(opts)} on the fake "
                f"backend ({rec['n_devices']} ranks): per device arguments "
                f"{got} B (spec arithmetic {want} B), temp "
                f"{rec['memory']['temp_size_in_bytes']} B, "
                f"{rec['flops_per_device']:.4e} FLOP, collectives "
                f"{rec['collectives']}; roofline compute "
                f"{row['compute_s']:.4e} s, memory {row['memory_s']:.4e} s, "
                f"collective {row['collective_s']:.4e} s: {row['dominant']}"
                f" ({rec['trace_s']} s of counting)")
            if rec["status"] != "ok" or got != want or \
                    not rec["collectives"]["total_bytes"]:
                fail(f"mesh (c): {a} x {sh} x {m}: status {rec['status']}, "
                     f"arguments {got} against {want}, collectives "
                     f"{rec['collectives']}")
    log_time(stats, f"mesh (c): {len(MESH_DRYRUN)} dry-run combos on the "
             f"fake backend in {wall:.1f} s wall, side by side")
    report["wall_s"] = wall
    return report


def drive_mesh(dev, stats):
    """Phase 10f: the fleet meshes (module docstring). The kernel counts,
    zeroed before the phase, must read 0 after it. Returns them."""
    from repro_torch.kernels import _build
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    _build.reset_launches()
    report = {"train": mesh_train(dev, stats),
              "moe": mesh_moe(dev, stats),
              "dryrun": mesh_dryrun(stats)}
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if any(launches.values()):
        fail(f"the mesh phase launched kernels: {launches}")
    report["wall_s"] = time.perf_counter() - t_phase
    stats["mesh"] = report
    log_time(stats, f"mesh phase wall: {report['wall_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the paper's experiments (benchmarks_torch) at the frozen regime
# ---------------------------------------------------------------------------

def paper_regime(dev):
    """benchmarks_torch.common's frozen regime at seed 0 (300 prompts per
    dataset, D = 64, 8 pairs per query): the corpus, its train split's
    feedback and the online win-rate targets."""
    from benchmarks_torch import common as C
    from repro_torch.data.routerbench import winrate_targets
    corpus, fb = C.build(0, dev)
    return corpus, fb, winrate_targets(fb, corpus.n_models)


@contextlib.contextmanager
def knn_site():
    """Inside: KNN's retrieve launches carry the call-site label "knn"
    (Eagle's carry none)."""
    from unittest import mock
    from repro_torch.kernels import _build
    from repro_torch.routing import baselines as B
    predict = B.KNNRouter.predict

    def labelled(self, emb):
        with _build.site("knn"):
            return predict(self, emb)
    with mock.patch.object(B.KNNRouter, "predict", labelled):
        yield


def check_knn(dev, kernels, stats, corpus, targets):
    """KNN's call (`ops.similarity_topk`: the fused retrieve's two kernels,
    no live mask) at its Fig. 2 shape (a dataset's test rows against the
    C win-rate rows, D = 64, top-40) against the reference backend (the
    plain panel and its stable sort): the neighbours equal except at
    near-ties, the scores within SIM_TOL, the predictions within 1e-6
    where the neighbours agree; and bit for bit against the similarity
    kernel's panel and its stable sort (the call before the fused
    retrieve). Timed on the device over launches queued ahead (the
    wrappers' host cost exceeds the kernels'), beside that panel route,
    the plain version, the library chain (normalize + matmul + topk) and
    the bound."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.kernels import ref
    from repro_torch.kernels.similarity_topk import similarity_cuda
    from repro_torch.routing.baselines import KNNRouter
    got_r = KNNRouter(corpus.costs, device=dev)
    want_r = KNNRouter(corpus.costs, backend="reference", device=dev)
    for r in (got_r, want_r):
        r.fit(*targets)
    db = got_r.emb
    test = corpus.test_idx[corpus.dataset_id[corpus.test_idx] == 0]
    q = torch.tensor(corpus.embeddings[test], device=dev)
    nq, c = q.shape[0], db.shape[0]
    n = min(got_r.n, c)
    gs, gi = KOPS.similarity_topk(q, db, n)
    ws, wi = KOPS.similarity_topk(q, want_r.emb, n, backend="reference")
    ps, pi = ref.stable_topk(similarity_cuda(q, db), n)
    want = ref.similarity_ref(q, want_r.emb)
    torch.cuda.synchronize()
    if not (torch.equal(gs, ps) and torch.equal(gi, pi)):
        fail("knn: the fused retrieve differs from the similarity kernel's "
             "panel and its stable sort")
    err = float((gs - torch.gather(want, 1, gi)).abs().max())
    if not err <= SIM_TOL:
        fail(f"knn Q={nq} C={c}: scores max abs err {err}")
    differ, untied = topk_rows_agree(gi, wi, want, n, SIM_TOL)
    if untied:
        fail(f"knn: top-{n} differs on {untied} rows without a near-tie")
    same = (gi == wi).all(dim=1)
    p_err = float((got_r.predict(q) - want_r.predict(q))[same].abs().max())
    if p_err > 1e-6:
        fail(f"knn predictions: max abs err {p_err} on rows with equal "
             "neighbours")
    # 25 runs where a run launches ~10-20 kernels (the panel routes, the
    # plain version, the library chain): a stream holds about a thousand
    # launches before the host blocks (which would end the queue ahead
    # of the device)
    norm = torch.nn.functional.normalize
    ms = queued_ms(lambda: KOPS.similarity_topk(q, db, n), 50)
    panel_ms = queued_ms(lambda: ref.stable_topk(similarity_cuda(q, db), n),
                         25)
    plain = queued_ms(lambda: KOPS.similarity_topk(q, db, n,
                                                   backend="reference"), 25)
    lib = queued_ms(lambda: torch.topk(torch.matmul(
        norm(q, dim=-1), norm(db, dim=-1).T), n, dim=-1), 25)
    d = q.shape[1]
    from repro_torch.kernels import retrieve_topn as RT
    pl = RT.plan(nq, c, d, n=n)
    if pl.route != RT.PANEL:
        fail(f"knn Q={nq} C={c}: the plan takes the {pl.route} route")
    panel = RT.retrieve_topn_cuda(q, db, None)
    k1_ms = queued_ms(lambda: RT.retrieve_topn_cuda(q, db, None), 50)
    k2_ms = queued_ms(lambda: RT.topn_merge_cuda(panel, None, n), 50)
    passes = int(ref.key_select_ref(panel, None, n)[1].sum())
    (b1, _), (b2, _) = retrieve_bound(nq, c, d, n, passes)
    bound, by = pair_bound(nq, c, d, n)
    log_time(stats, f"knn retrieve Q={nq} C={c} D={d} top-{n} (the panel "
             f"route, tile {pl.tile}; kernel 1 {k1_ms} ms (bound {b1}), "
             f"kernel 2 {k2_ms} ms (bound {b2})): equal to the similarity "
             f"kernel's panel + stable sort; "
             f"scores max abs err {err}, top-n rows differing at near-ties "
             f"{differ}, prediction err {p_err}; the pair ms {ms} (device, "
             f"queued) against the panel + stable sort {panel_ms}; "
             f"plain_ms={plain} library_ms={lib} bound_ms={bound} ({by}; the "
             f"pair's inputs and top-n, not the panel between)")
    kernels["retrieve knn"] = dict(
        name="retrieve knn", route="cuda",
        source="src/repro_torch/kernels/csrc/retrieve_topn.cu",
        replaces="src/repro/kernels/similarity_topk.py:42",
        max_abs_err=err, ms=ms, queued_ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib)
    stats["knn_retrieve"] = dict(q=nq, c=c, route=pl.route, passes=passes,
                                 retrieve_topn_ms=k1_ms, topn_merge_ms=k2_ms,
                                 retrieve_topn_bound_ms=b1,
                                 topn_merge_bound_ms=b2,
                                 topk_rows_near_tie=differ,
                                 prediction_err=p_err, panel_sort_ms=panel_ms)


def check_eagle_d64(dev, stats, corpus, fb):
    """Eagle at D = 64 (Fig. 2's router, fitted on the frozen regime's
    11,760 records) routes the 630 test queries at every budget of the
    grid through the kernels and through the plain versions: retrieval
    equal except at near-ties, choices equal except at score ties, the
    combined scores within the ratings' bar."""
    from benchmarks_torch import common as C
    from repro_torch.core.state import route_batch
    from repro_torch.data.routerbench import budget_grid
    from repro_torch.kernels import ref
    router, _ = C.fit_eagle(corpus, fb, device=dev)
    st = router.state
    kw = router._kw()
    kw.pop("backend")
    n = kw["n_neighbors"]
    q = torch.tensor(corpus.embeddings[corpus.test_idx], device=dev)
    panel = ref.similarity_ref(q, st.emb)
    panel[:, int(st.size):] = float("-inf")
    totals = dict(choices=0, at_ties=0, retrieval_near_ties=0)
    grid = budget_grid(corpus.costs)
    for b in grid:
        got = route_batch(st, q, float(b), router.costs, backend="cuda",
                          **kw)
        want = route_batch(st, q, float(b), router.costs,
                           backend="reference", **kw)
        t_differ, t_untied = topk_rows_agree(got.topk_idx, want.topk_idx,
                                             panel, n, SIM_TOL)
        if t_untied:
            fail(f"eagle D=64 budget {b}: top-{n} differs on {t_untied} "
                 "rows without a near-tie")
        same = (got.topk_idx == want.topk_idx).all(dim=1)
        comb = torch.where(router.costs[None] <= float(b), want.scores,
                           torch.full_like(want.scores, float("-inf")))
        c_differ, c_untied = choices_agree(got.choices[same],
                                           want.choices[same], comb[same])
        if c_untied:
            fail(f"eagle D=64 budget {b}: {c_untied} choices differ "
                 "without a tie")
        if not torch.allclose(got.scores[same], want.scores[same],
                              rtol=R_RTOL, atol=R_ATOL):
            fail(f"eagle D=64 budget {b}: scores differ")
        totals["choices"] += int((got.choices.long()
                                  != want.choices.long()).sum())
        totals["at_ties"] += c_differ
        totals["retrieval_near_ties"] += t_differ
    log(f"eagle D=64, {len(q)} test queries x {len(grid)} budgets, kernels "
        f"vs plain on the card: {totals['choices']} choices differ "
        f"({totals['at_ties']} at score ties, the rest on rows whose "
        f"retrieval met a near-tie: {totals['retrieval_near_ties']})")
    stats["eagle_d64_choices_differing"] = totals


def check_fit_capture(dev, stats, costs, targets):
    """A captured MLP fit and a captured SVM fit of FIT_STEPS steps
    against an eager loop of the same steps on the card (TrainStep, no
    graph): parameters and losses within FIT_TOL, one capture each."""
    from repro_torch import graphs
    from repro_torch.routing.baselines import MLPRouter, SVMRouter, TrainStep
    errs = {}
    for name, cls in (("mlp", MLPRouter), ("svm", SVMRouter)):
        r = cls(costs, epochs=FIT_STEPS, device=dev)
        c0 = graphs.capture_count()
        r.fit(*targets)
        if graphs.capture_count() - c0 != 1:
            fail(f"{name} fit: {graphs.capture_count() - c0} captures, "
                 "not 1")
        x, y, mk = (r._f32(a) for a in targets)
        init = r._init(x.shape[1], y.shape[1])
        eager = TrainStep(r, x, y, init).load(x, y, mk, init)
        for _ in range(FIT_STEPS):
            eager()
        torch.cuda.synchronize()
        err = max(float((r.params[k] - v).detach().abs().max())
                  for k, v in eager.params.items())
        l_err = float((r.losses - eager.losses).abs().max())
        if max(err, l_err) > FIT_TOL:
            fail(f"{name}: captured fit against eager after {FIT_STEPS} "
                 f"steps: parameters {err}, losses {l_err}")
        # a step's device time through its graph (replays queued ahead)
        # and its time eagerly (back-to-back, host included)
        (_, step), = r._steps.entries.values()
        graph_ms = queued_ms(step, FIT_STEPS)
        eager_ms = cuda_ms(eager, FIT_STEPS)
        errs[name] = dict(params=err, losses=l_err, graph_step_ms=graph_ms,
                          eager_step_ms=eager_ms)
        log_time(stats, f"{name} training step: {graph_ms} ms of device "
                 f"time through its graph (queued), {eager_ms} ms eagerly")
    log(f"captured fits against eager fits on the card, {FIT_STEPS} steps "
        f"(max abs err): {errs}")
    stats["fit_capture_err"] = errs


def drive_paper(dev, stats):
    """The paper's four experiments through benchmarks_torch at seed 0 (as
    `python -m benchmarks_torch.run --quick`): Fig. 2 in both regimes,
    Table 3a, Fig. 3b and Fig. 4 (a and b). Table 3a's timed fits must
    capture nothing: its warm fits capture every MLP and SVM step (one
    per router and stage), and `table3a_timing.timed` raises on a timed
    fit that captured."""
    from benchmarks_torch import (fig2_auc, fig3b_incremental,
                                  fig4_ablation, table3a_timing)
    from repro_torch import graphs
    seeds = (0,)
    t0 = time.perf_counter()
    f2 = fig2_auc.run(seeds=seeds, device=dev)
    t1 = time.perf_counter()
    c0 = graphs.capture_count()
    t3 = table3a_timing.run(seeds=seeds, device=dev)
    captures = graphs.capture_count() - c0
    warm = 2 * len(table3a_timing.STAGES) * len(seeds)
    if captures != warm:
        fail(f"table 3a: {captures} captures, not the {warm} of its warm "
             "fits")
    t2 = time.perf_counter()
    f3 = fig3b_incremental.run(seeds=seeds, device=dev)
    f4 = fig4_ablation.run(seeds=seeds, device=dev)
    t4 = time.perf_counter()
    stats["paper"] = dict(fig2=f2, table3a=t3, fig3b=f3, fig4=f4,
                          table3a_captures=captures,
                          table3a_timed_captures=captures - warm,
                          wall_s=dict(fig2=t1 - t0, table3a=t2 - t1,
                                      fig3b_fig4=t4 - t2))
    for regime, summ in f2["regimes"].items():
        log_time(stats, f"fig 2 ({regime}): summed AUC "
                 + " ".join(f"{k}={summ[k]['mean']}"
                            for k in ("eagle", "knn", "mlp", "svm"))
                 + f"; eagle improvement % {summ['improvement_vs']}")
    log_time(stats, f"table 3a: seconds {t3['seconds']}; eagle as % of the "
             f"baselines' mean {t3['eagle_pct_of_baseline_mean']}; "
             f"captures {captures} (warm fits {warm}, timed fits "
             f"{captures - warm})")
    log_time(stats, f"fig 3b: summed AUC by stage {f3['auc']}; eagle "
             f"improvement % {f3['eagle_improvement_vs_baseline_mean_pct']}")
    log_time(stats, f"fig 4: components {f4['components']}; N sweep "
             f"{f4['n_sweep']}")
    log(f"paper phase wall: {stats['paper']['wall_s']} s")



def _example(name):
    """examples_torch/<name>.py as a module (its main not run)."""
    import importlib.util
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive_router_benchmarks(dev, stats):
    """The router path's benchmarks and examples (ROADMAP §2.9.1) at their
    smoke sizes on the card, as their CLIs run them: the route benchmark's
    `run` (the fused route against the legacy VectorDB.query +
    gather_feedback + local_elo path, choices asserted equal; the
    similarity kernel's launches are the legacy retrieval's), its ragged
    loop under --assert-steady-state and its sharded loop at S = 2 and 4
    under --assert-sharded (no capture after warmup, choices equal to the
    unsharded route's); the queue benchmark under --assert-queue and
    --assert-quality; the kernel microbenchmarks; and the three examples
    at their smallest settings. Returns the launches of the legacy run."""
    from benchmarks_torch import kernels_bench, queue_bench
    from benchmarks_torch import route_batch_bench as RB
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.reset_launches()
    rows = RB.run(smoke=True, device=dev)
    torch.cuda.synchronize()
    legacy = _build.launch_counts()
    wall = {"run": time.perf_counter() - t0}
    if not legacy["similarity"]:
        fail(f"the legacy route launched no similarity kernel: {legacy}")
    ragged = RB.run_ragged(smoke=True, assert_steady_state=True, device=dev)
    sharded = {s: RB.run_sharded(smoke=True, mesh_n=s, assert_sharded=True,
                                 device=dev) for s in (2, 4)}
    wall["ragged_sharded"] = time.perf_counter() - t0 - wall["run"]
    t1 = time.perf_counter()
    queue_rows = queue_bench.run(smoke=True, assert_queue=True, device=dev)
    quality = queue_bench.run_quality_gate(smoke=True, assert_quality=True,
                                           device=dev)
    wall["queue"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    kernel_rows = kernels_bench.run(device=dev)
    wall["kernels"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    _example("quickstart").main(["--device", "cuda"])
    _example("online_adaptation").main(["--device", "cuda"])
    _example("serve_routed").main(["--device", "cuda", "--requests", "8",
                                   "--fleet", "2", "--max-new", "2",
                                   "--serve-obs"])
    wall["examples"] = time.perf_counter() - t1
    stats["router_benchmarks"] = dict(
        route=rows, legacy_launches=legacy, ragged=ragged, sharded=sharded,
        queue=queue_rows, quality_gate=quality, kernels=kernel_rows,
        wall_s=wall)
    log_time(stats, f"router-path benchmarks and examples: legacy route "
             f"launches {legacy}; ragged p50 {ragged['route_p50_us']:.1f} "
             f"us, captures after warmup "
             f"{ragged['post_warmup_xla_compiles']}; sharded "
             f"{ {s: (round(v['route_p50_us'], 1), v['oracle_mismatches']) for s, v in sharded.items()} }"
             f" (p50 us, mismatches); wall s {wall}")
    return legacy

def main() -> int:
    # the preconditions come first, so a failed run prints no result
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import graphs
    from repro_torch.data.routerbench import make_corpus, pairwise_feedback
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}"
        f"; devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    # the tie-high control build of retrieve_topn.cu, beside the others
    control = threading.Thread(target=_build.build, args=(
        ["retrieve_topn"], TIE_CONTROL), name="control-build")
    control.start()
    libs = _build.build()
    control.join()
    stats = {"card": card, "build_s": time.perf_counter() - t0}
    log(f"built {[p.name for p in libs]} and the control "
        f"{_build._lib_path('retrieve_topn', TIE_CONTROL).name} in "
        f"{stats['build_s']:.1f} s")
    build_report(libs, stats)

    t0 = time.perf_counter()
    corpus = make_corpus(seed=0, n_per_dataset=N_PER_DATASET, dim=DIM)
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=PAIRS_PER_QUERY)
    fold_records = (fb["model_a"], fb["model_b"], fb["outcome"])
    log(f"corpus: {len(corpus.embeddings)} prompts, "
        f"{len(fb['model_a'])} train records, {corpus.n_models} models "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    kernels = {}
    check_similarity(dev, kernels, stats)
    check_retrieve(dev, kernels, stats)
    check_replay(dev, kernels, stats, fold_records)
    launches = {"large_n": route_large_n(dev, corpus, fb, stats)}
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with pregathered_selects() as unfused:
        router, disp, dbuf, test, grid = drive_main_path(dev, corpus, fb,
                                                         stats)
    torch.cuda.synchronize()
    launches["route"] = _build.launch_counts()
    log(f"launches on the routing path: {launches['route']}, of which "
        f"elo_scan_select over pre-gathered records: {unfused[0]}")
    missing = [k for k in ROUTE_KERNELS if launches["route"][k] == 0]
    if missing:
        fail(f"kernels never launched on the routing path: {missing}")
    if unfused[0]:
        fail(f"{unfused[0]} elo_scan_select launches of the routing path "
             "did not take the gather route")
    # each route went through a graph: its retrieve and select launches
    # are the replays' credits (a hit each) and the captures' eager
    # warm-up runs (a warmed entry each), nothing else
    ledger = disp.cache_stats()
    replays = ledger["hits"] + ledger["warmed"]
    if ledger["misses"] != ledger["warmed"] or any(
            launches["route"][k] != replays
            for k in ("retrieve_topn", "topn_merge", "elo_scan_select")):
        fail(f"routing path: launches {launches['route']} against "
             f"{ledger['hits']} replays and {ledger['warmed']} warm-up "
             f"runs ({ledger['misses']} captures)")
    log(f"routing path through the route graphs: {ledger['hits']} replays "
        f"(their launches credited), {ledger['warmed']} graphs captured by "
        f"warmup, none by traffic")
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    compare_route(router, dbuf, test, grid, stats)
    time_path(disp, dbuf, router, test, stats)
    profile_route(disp, dbuf, router, test, stats)
    drive_route_graphs(router, disp, dbuf, corpus, stats)
    del router, disp, dbuf
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches["sharded"] = drive_sharded(dev, corpus, fb, kernels, stats)
    stats["sharded_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log_time(stats, f"peak device memory of the sharded phase "
             f"{stats['sharded_peak_mem_gb']:.2f} GB")
    torch.cuda.empty_cache()
    drive_obs_plane(dev, corpus, fb, stats)
    del corpus, fb
    torch.cuda.empty_cache()

    check_flash(dev, kernels, stats)
    check_decode(dev, kernels, stats)
    torch.cuda.empty_cache()
    engine, serve_corpus = build_serving(dev, stats)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    drive_serving(engine, serve_corpus, stats)
    torch.cuda.synchronize()
    launches["serve"] = _build.launch_counts()
    log(f"launches on the serving path: {launches['serve']}")
    missing = [k for k, n in launches["serve"].items()
               if n == 0 and k not in OFF_PATH]
    if missing:
        fail(f"kernels never launched on the serving path: {missing}")
    stats["launches"] = launches
    stats["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log_time(stats, f"peak device memory: routing path "
             f"{stats['peak_mem_gb']:.2f} GB; serving path (weights, "
             f"caches, activations) {stats['serve_peak_mem_gb']:.2f} GB")
    compare_model_paths(engine, stats)
    time_serving(engine, stats)
    for name in FLEET:
        profile_decode(engine, stats, name)
        profile_decode(engine, stats, name, what="graph")

    drive_launcher(stats)
    check_site_attention(dev, kernels, stats)
    torch.cuda.empty_cache()
    launch_engine, launch_corpus = build_launch_fleet(dev, engine, stats)
    del engine, serve_corpus     # olmo-1b and qwen3-8b live on in the fleet
    torch.cuda.empty_cache()
    with count_sites(launch_engine):
        warm_launch_fleet(launch_engine, stats)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()  # and the warm-up generates' launches
        c0 = graphs.capture_count()
        route0 = launch_engine.dispatch.cache_stats()
        decode0 = {n: m.cache_stats() for n, m in launch_engine.fleet.items()}
        drive_launch_fleet(launch_engine, launch_corpus, stats)
    torch.cuda.synchronize()
    launches["launch"] = _build.launch_counts()
    sites = site_launches()
    credited = _build.credited_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    captured = {"process": graphs.capture_count() - c0,
                "route": launch_engine.dispatch.cache_stats()["misses"]
                - route0["misses"]}
    captured.update({n: m.cache_stats()["misses"] - decode0[n]["misses"]
                     for n, m in launch_engine.fleet.items()})
    stats.update(launch_sites=sites, launch_credited=credited,
                 launch_peak_mem_gb=peak, launch_captures=captured)
    log(f"launches on the launcher fleet's run: {launches['launch']}, of "
        f"which credited by graph replays {credited}; by call site "
        f"(replays credited per site): {sites}; graphs captured in the "
        f"run {captured}")
    log_time(stats, f"peak device memory of the launcher fleet's run "
             f"(four models' weights, static decode states, graph pools, "
             f"activations): {peak:.2f} GB")
    missing = [k for k, n in launches["launch"].items()
               if n == 0 and k not in OFF_PATH] + [
        k for k, site in WHISPER_SITES.items()
        if not sites.get(f"whisper-large-v3 {site}")]
    if missing:
        fail(f"never launched on the launcher fleet's run: {missing}")
    if any(captured.values()):
        fail(f"graphs captured after warmup on the launcher fleet's run: "
             f"{captured}")
    if credited.get("decode_attention") != \
            launches["launch"]["decode_attention"]:
        fail(f"decode launches {launches['launch']['decode_attention']}, "
             f"of which credited by replays "
             f"{credited.get('decode_attention')}: the decode path left "
             "its graphs")
    if peak >= 80.0:
        fail(f"the launcher fleet's peak device memory {peak:.2f} GB")
    compare_graph_generate(launch_engine, stats)
    compare_sharded_engine(dev, launch_engine.fleet, stats)
    new_models = ("whisper-large-v3", "mamba2-780m")
    compare_model_paths(launch_engine, stats, names=new_models)
    time_serving(launch_engine, stats, names=new_models)
    for name in new_models:
        profile_decode(launch_engine, stats, name)
        profile_decode(launch_engine, stats, name, what="graph")
    profile_decode(launch_engine, stats, "mamba2-780m", what="prefill")

    del launch_engine, launch_corpus
    torch.cuda.empty_cache()
    launches["moe"], moe_sites = drive_moe(dev, kernels, stats)
    torch.cuda.empty_cache()
    launches["dense"], dense_sites = drive_dense(dev, kernels, stats)
    torch.cuda.empty_cache()
    launches["ring"], ring_sites, long_sites_run = drive_dryrun_ring(
        dev, kernels, stats)
    torch.cuda.empty_cache()
    launches["hybrid_mla"], hybrid_sites = drive_hybrid_mla(dev, kernels,
                                                            stats)
    torch.cuda.empty_cache()
    launches["training"] = drive_training(dev, stats)
    torch.cuda.empty_cache()
    launches["mesh"] = drive_mesh(dev, stats)

    torch.cuda.empty_cache()
    corpus, fb, targets = paper_regime(dev)
    check_knn(dev, kernels, stats, corpus, targets)
    check_eagle_d64(dev, stats, corpus, fb)
    check_fit_capture(dev, stats, corpus.costs, targets)
    _build.reset_launches()
    with knn_site():
        drive_paper(dev, stats)
    torch.cuda.synchronize()
    launches["paper"] = _build.launch_counts()
    knn_launches = {k: _build.site_counts().get((k, "knn"), 0)
                    for k in ("retrieve_topn", "topn_merge")}
    log(f"launches on the paper's experiments: {launches['paper']}, of "
        f"which KNN's retrieve {knn_launches}")
    missing = [k for k in ROUTE_KERNELS if launches["paper"][k] == 0]
    if missing or not all(knn_launches.values()):
        fail(f"never launched on the paper's experiments: {missing}, KNN's "
             f"retrieve {knn_launches}")
    launches["legacy"] = drive_router_benchmarks(dev, stats)

    if any(m == "jax" or m.startswith("jax.") or m in ("repro", "benchmarks",
                                                       "examples")
           or m.startswith(("repro.", "benchmarks.", "examples.")) for m, v in
           sys.modules.items() if v is not None):
        fail("JAX, the JAX package or its benchmarks or examples were "
             "imported")
    for name, entry in kernels.items():
        if name in WHISPER_SITES:
            entry["launches"] = sites[f"whisper-large-v3 "
                                      f"{WHISPER_SITES[name]}"]
            continue
        if name in PHI_SITES:
            entry["launches"] = moe_sites[f"{MOE_MODEL} {PHI_SITES[name]}"]
            continue
        if name in DENSE_SITES:
            entry["launches"] = dense_sites[DENSE_SITES[name]]
            continue
        if name in HYBRID_SITES:
            entry["launches"] = hybrid_sites[HYBRID_SITES[name]]
            continue
        if name in RING_SITES:
            entry["launches"] = ring_sites[RING_SITES[name]]
            continue
        if name in LONG_SITES:
            entry["launches"] = long_sites_run[LONG_SITES[name]]
            continue
        if name == "elo_scan fit fold":
            entry["launches"] = stats["fit_fold_launches"]
            continue
        if name == "retrieve knn":
            entry["launches"] = sum(knn_launches.values())
            continue
        if name == "sharded_retrieve_replay_select":
            continue                 # set by drive_sharded
        if name in ("retrieve_topn n512", "topn_merge k512"):
            entry["launches"] = launches["large_n"][name.split()[0]]
            continue
        # similarity: off the serving route since the fused retrieve; the
        # legacy retrieval (VectorDB.query) of the route benchmark runs it
        path = "route" if name in ROUTE_KERNELS else \
            "legacy" if name == "similarity" else "serve"
        entry["launches"] = launches[path][name]
    order = ROUTE_KERNELS + ("similarity", "elo_scan fit fold",
                             "sharded_retrieve_replay_select",
                             "flash_attention",
                             "decode_attention") + tuple(WHISPER_SITES) \
        + tuple(PHI_SITES) + tuple(DENSE_SITES) + tuple(RING_SITES) \
        + tuple(LONG_SITES) + tuple(HYBRID_SITES) + (
            "retrieve knn", "retrieve_topn n512", "topn_merge k512")
    line = {"kernels": [kernels[k] for k in order]}
    stats["kernels"] = line["kernels"]
    (out / "chip_smoke.json").write_text(json.dumps(stats, indent=1))
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
