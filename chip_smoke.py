#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's routing and serving paths, and the
paper's experiments, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit. It builds the port's kernels from `src/repro_torch/kernels/
csrc/` into `build/repro_torch/` (one `nvcc` per source, all started
together), then:

  1. prints the card (name, power limit) and the torch/CUDA versions,
     the build time, each kernel's registers, shared memory and spills
     (`-Xptxas -v`), the tensor-core instructions in the flash library
     and the replay kernels' step loops (`cuobjdump -sass`);
  2. holds every kernel against its plain PyTorch version on the card,
     at the shapes the routing path gives it, with the stated
     tolerances: the similarity kernel at every bucket of the 8..1024
     ladder, each timed beside its bound and the library call (and, up
     to 128, with every tile that could take it); the fused retrieve's
     two kernels (retrieve_topn: similarity + live-row mask + a top-n a
     column split, no panel; topn_merge: the top-n of its pool) at
     buckets 1024, 64 and 8, bit for bit against the per-split stable
     top-n of the similarity kernel's panel and against their plain
     versions, timed (queued) beside their bounds, plain versions and
     library chains and beside the panel + stable sort they replace; the
     route over them (retrieve + gather replay) at those buckets bit for
     bit against the panel route and against the plain version; the
     replay kernel on
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
     its own at the same width: the JAX package's obs gate (500 ragged
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
     cache with ragged lengths and against the last row of prefill),
     checks that a control with one key dropped fails its bar (flash:
     floor scaled with rms(v), decode: fixed; derivations at the
     constants) by 10x or more, and times each beside SDPA (decode also
     over launches queued ahead of the device, `queued_ms`);
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
     The similarity kernel is off every path since the fused retrieve:
     it is checked in phase 2 and stays in the kernels line, launched 0
     times on the path.

Every CUDA graph is captured by `repro_torch.graphs` (counted process
wide); a failed capture raises. Any mismatch or exception exits
non-zero. The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON, and the one before that the card's name and power limit.
Everything measured is also written to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
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
                 "olmo-1b": (13, 1056, 16, 16, 128)}
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
# kernels off every path since the fused retrieve: checked and timed in
# phase 2, not required to launch on a path
OFF_PATH = ("similarity",)
# device-side names a route's profile may hold: the retrieve's two kernels,
# the replay, and copies; anything else (a GEMM panel, a sort) fails
ROUTE_PROFILE_KERNELS = ("topn_gemm_kernel", "topn_gemv_kernel",
                         "topn_merge_kernel", "elo_scan_kernel")
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
    """Device time of one run of fn() with the host ahead of the device:
    the launches of `iters` runs queue behind a spin kernel
    (`torch.cuda._sleep`, >= 0.1 s), so CUDA events time the device's own
    run of the sequence, the gaps between its kernels included. cuda_ms
    over back-to-back calls measures the host instead when a call takes
    longer than its kernels run (the replay's wrappers: tens of
    microseconds of Python a call). A try counts only if the spin still
    held the device when the last launch was queued (the start event not
    yet reached); a try that the host outran is made again behind a
    spin twice as long, up to four tries."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin in (1, 2, 4, 8):
        torch.cuda._sleep(spin * 200_000_000)   # cycles: >= 0.1 s a unit
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    fail(f"queued_ms: the host did not queue {iters} runs within a spin "
         "of 0.8 s")


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
    (`step_loops`), from `cuobjdump -sass` where the toolkit has it."""
    import re
    from repro_torch.kernels import _build
    report = {}
    for name in ("similarity", "retrieve_topn", "flash_attention",
                 "elo_scan"):
        entry, lines = None, []
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and re.search(
                    r"Used|spill|Performance|serialized|setmaxnreg", line):
                lines.append(f"{entry}: {line.strip()}")
        report[name] = lines
        for line in lines:
            log(f"ptxas {name}: {line}")
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
    """Device time of the similarity kernel with its tile forced (8: the
    streaming kernel; 32, 64, 128: the GEMM with that many query rows), to
    show where the path's choice should switch. Timing only: these
    launches go around the wrapper and are not counted."""
    from repro_torch.kernels import _build
    lib = _build.library("similarity")
    out = torch.empty((q.shape[0], db.shape[0]), device=q.device)
    stream = _build.stream_handle(q.device)

    def run():
        _build.check(lib.similarity_launch_tile(
            q.data_ptr(), db.data_ptr(), out.data_ptr(), q.shape[0],
            db.shape[0], q.shape[1], tile, stream), "similarity tile")
    return cuda_ms(run, iters)


def check_similarity(dev, kernels, stats):
    """Every bucket of the dispatch ladder against the plain version
    (SIM_TOL, and the top-N near-tie check), timed beside the plain
    version, the library call and the bound; the buckets up to 128 also
    with each tile that could take them."""
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
                source="src/repro_torch/kernels/csrc/similarity.cu",
                replaces="src/repro/kernels/similarity_topk.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)
    stats["similarity_buckets"] = buckets


def retrieve_bound(nq, c, d, pool):
    """The fused retrieve's bounds: kernel 1 reads q and the DB once and
    writes its pool (the product's fp32 operations bound it at large Q),
    kernel 2 reads the pool and writes the top-n (scores, int64 rows,
    hit) with one comparison a candidate. Returns ((ms, by), (ms, by))."""
    k1 = bound_ms(4.0 * (nq * d + c * d) + 8.0 * nq * pool,
                  2.0 * nq * c * d + 2.0 * (nq + c) * d)
    k2 = bound_ms(8.0 * nq * pool + 13.0 * nq * N, float(nq * pool))
    return k1, k2


def check_retrieve(dev, kernels, stats):
    """The fused retrieve's two kernels at the routing path's shapes
    (RETRIEVE_BUCKETS against C_EXPECTED rows of D = DIM, n = N, the
    last DEAD_ROWS rows past the live count, duplicate rows on split
    boundaries and the queries that tie on them): kernel 1's pool equal,
    bit for bit, to the per-split stable top-n of the similarity kernel's
    masked panel (`ref.panel_pool_ref`), its scores within SIM_TOL of the
    plain similarity; kernel 2 over that pool equal to its plain version
    bit for bit; the pair's top-n equal to the panel's stable sort bit for
    bit and to the plain version's but at near-ties. Each kernel timed on
    the device (`queued_ms`) beside its bound, its plain version and the
    library chain (normalize + matmul + torch.topk for kernel 1;
    torch.topk over the pool for kernel 2), and the pair beside the
    panel + stable sort it replaces."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import retrieve_topn as RT
    from repro_torch.kernels.similarity_topk import similarity_cuda
    rng = torch.Generator(device=dev).manual_seed(2)
    db0 = torch.randn((C_EXPECTED, DIM), generator=rng, device=dev)
    live = C_EXPECTED - DEAD_ROWS
    size = torch.tensor(live, dtype=torch.int32, device=dev)
    norm = torch.nn.functional.normalize
    buckets = {}
    for nq in RETRIEVE_BUCKETS:
        tile, rows, splits = RT.plan(nq, C_EXPECTED, DIM, RT._sm_count(dev))
        ties = [rows * i for i in range(1, min(splits, 5))]
        db = db0.clone()
        for b in ties:
            db[b] = db[b - 1]
        q = torch.randn((nq, DIM), generator=rng, device=dev)
        k = min(nq, len(ties))
        q[:k] = db[[b - 1 for b in ties[:k]]]
        pool_s, pool_i = RT.retrieve_topn_cuda(q, db, size, N)
        top = RT.topn_merge_cuda(pool_s, pool_i, N)
        panel = ref.mask_dead(similarity_cuda(q, db), 0, size)
        want_pool = ref.panel_pool_ref(panel, N, rows)
        want_top = ref.topn_merge_ref(pool_s, pool_i, N)[:3]
        panel_top = ref.stable_topk(panel, N)
        del panel
        plain_panel = ref.mask_dead(ref.similarity_ref(q, db), 0, size)
        plain_top = ref.stable_topk(plain_panel, N)
        torch.cuda.synchronize()
        if not (torch.equal(pool_s, want_pool[0])
                and torch.equal(pool_i, want_pool[1])):
            fail(f"retrieve_topn Q={nq}: the pool differs from the "
                 "per-split stable top-n of the similarity kernel's panel")
        if not all(torch.equal(x, y) for x, y in zip(top, want_top)):
            fail(f"topn_merge Q={nq}: differs from its plain version")
        if not (torch.equal(top[0], panel_top[0])
                and torch.equal(top[1], panel_top[1])):
            fail(f"retrieve Q={nq}: the top-{N} differs from the panel's "
                 "stable sort")
        hit = top[2]
        err = float((top[0] - torch.gather(plain_panel, 1, top[1]))[hit]
                    .abs().max())
        if not err <= SIM_TOL:
            fail(f"retrieve_topn Q={nq}: scores {err} from the plain "
                 "similarity")
        differ, untied = topk_rows_agree(top[1], plain_top[1], plain_panel,
                                         N, SIM_TOL)
        if untied:
            fail(f"retrieve Q={nq}: top-{N} differs from the plain version "
                 f"on {untied} rows without a near-tie")
        del plain_panel, plain_top
        # runs queued: a stream holds ~1000 launches ahead of the device,
        # and the panel route and the library chain launch ~20 a run
        iters = 20 if nq >= 256 else 50
        k1_ms = queued_ms(lambda: RT.retrieve_topn_cuda(q, db, size, N),
                          iters)
        k2_ms = queued_ms(lambda: RT.topn_merge_cuda(pool_s, pool_i, N), 50)
        pair_ms = queued_ms(lambda: RT.topn_cuda(q, db, size, N), iters)
        sim_ms = queued_ms(lambda: similarity_cuda(q, db), iters)
        panel_ms = queued_ms(lambda: ref.panel_topn_ref(
            q, db, size, N, similarity_fn=similarity_cuda), 20)
        plain1 = cuda_ms(lambda: ref.split_topn_ref(q, db, size, N, rows),
                         3, warmup=1)
        plain2 = cuda_ms(lambda: ref.topn_merge_ref(pool_s, pool_i, N), 3,
                         warmup=1)
        lib1 = queued_ms(lambda: torch.topk(
            torch.matmul(norm(q, dim=-1), norm(db, dim=-1).T), N, dim=-1),
            20)
        lib2 = queued_ms(lambda: torch.topk(pool_s, N, dim=-1), 50)
        pool = splits * N
        (b1, by1), (b2, by2) = retrieve_bound(nq, C_EXPECTED, DIM, pool)
        log_time(stats,
                 f"retrieve Q={nq} C={C_EXPECTED} D={DIM} n={N} (tile "
                 f"{tile}, {splits} splits of {rows} rows, pool {pool} a "
                 f"query, {live} live rows): pool and top-n equal to the "
                 f"similarity kernel's panel + stable sort; scores max abs "
                 f"err {err} from the plain version, top-n rows differing "
                 f"at near-ties {differ}; retrieve_topn ms {k1_ms} (queued) "
                 f"bound {b1} ({by1}, {b1 / k1_ms} of it) plain {plain1} "
                 f"library (normalize + matmul + topk) {lib1}; topn_merge "
                 f"ms {k2_ms} bound {b2} ({by2}) plain {plain2} library "
                 f"(topk over the pool) {lib2}; the pair {pair_ms} against "
                 f"the similarity kernel alone {sim_ms} and its panel + "
                 f"stable sort {panel_ms}")
        buckets[nq] = dict(tile=tile, splits=splits, split_rows=rows,
                           pool=pool, max_abs_err=err,
                           topk_rows_near_tie=differ, retrieve_topn_ms=k1_ms,
                           retrieve_topn_bound_ms=b1, retrieve_topn_plain_ms=
                           plain1, retrieve_topn_library_ms=lib1,
                           topn_merge_ms=k2_ms, topn_merge_bound_ms=b2,
                           topn_merge_plain_ms=plain2,
                           topn_merge_library_ms=lib2, pair_ms=pair_ms,
                           similarity_ms=sim_ms, panel_sort_ms=panel_ms)
        if nq == RETRIEVE_BUCKETS[0]:
            src = "src/repro_torch/kernels/csrc/retrieve_topn.cu"
            kernels["retrieve_topn"] = dict(
                name="retrieve_topn", route="cuda", source=src,
                replaces="src/repro/kernels/similarity_topk.py:42",
                max_abs_err=err, ms=k1_ms, queued_ms=k1_ms, plain_ms=plain1,
                bound_ms=b1, bound_by=by1, library_ms=lib1)
            kernels["topn_merge"] = dict(
                name="topn_merge", route="cuda", source=src,
                replaces="src/repro/kernels/similarity_topk.py:91",
                max_abs_err=0.0, ms=k2_ms, queued_ms=k2_ms, plain_ms=plain2,
                bound_ms=b2, bound_by=by2, library_ms=lib2)
        del q, db, pool_s, pool_i, top
    stats["retrieve_buckets"] = buckets


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


def panel_eager_route(disp, state, q, budgets):
    """eager_route with the panel route's retrieve (the similarity
    kernel's panel and a stable sort) in place of the fused one."""
    from functools import partial
    from unittest import mock
    from repro_torch.kernels import ref, retrieve_replay
    from repro_torch.kernels.similarity_topk import similarity_cuda
    with mock.patch.object(retrieve_replay, "topn_cuda", partial(
            ref.panel_topn_ref, similarity_fn=similarity_cuda)):
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

_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


def check_prometheus(text: str) -> int:
    """Every non-comment line is `name{labels} value`; returns the number
    of samples (the JAX obs gate's check)."""
    samples = [ln for ln in text.strip().splitlines()
               if not ln.startswith("#")]
    bad = [ln for ln in samples if not _PROM_LINE.match(ln)]
    if bad or not samples:
        fail(f"Prometheus text: {len(samples)} samples, unparseable "
             f"{bad[:3]}")
    return len(samples)


def check_chrome_trace(path: Path) -> int:
    """The trace is traceEvents JSON with complete events and at least
    one route span; returns the event count."""
    evs = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in evs if e.get("ph") == "X"]
    bad = [e for e in xs if not (isinstance(e["ts"], (int, float))
                                 and e["dur"] >= 0 and e["name"]
                                 and "pid" in e and "tid" in e)]
    if not evs or bad or not any("route" in e["name"] for e in xs):
        fail(f"Chrome trace {path.name}: {len(evs)} events, {len(bad)} "
             "malformed, route spans "
             f"{sum('route' in e['name'] for e in xs)}")
    return len(evs)


class Scraper:
    """A thread that GETs `paths` of a running exporter in turn until it
    is stopped, waiting `pause` seconds after each round, and counts the
    scrapes by HTTP status and the errors (the first kept). It runs in
    the process it scrapes: it touches no CUDA state, as the exporter's
    own thread does not."""

    def __init__(self, exporter, paths, pause: float):
        self.exporter, self.paths, self.pause = exporter, paths, pause
        self.scrapes, self.errors, self.first_error = 0, 0, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="scraper",
                                        daemon=True)

    def _loop(self):
        while not self._stop.is_set():
            for path in self.paths:
                try:
                    with urllib.request.urlopen(self.exporter.url(path),
                                                timeout=30) as r:
                        r.read()
                        ok = r.status == 200
                except Exception as e:       # counted, reported by main
                    ok = False
                    self.first_error = self.first_error or repr(e)
                self.scrapes += ok
                self.errors += not ok
            self._stop.wait(self.pause)

    def __enter__(self) -> "Scraper":
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            fail("the scraper thread did not stop")
        return False


class StubModel:
    """A fleet entry that answers zeros: routing and feedback do not read
    the tokens."""

    def generate(self, tokens, max_new):
        return np.zeros((tokens.shape[0], max_new), np.int32)


def obs_legs(ob, disp, dbuf, quality, sorted_costs, q, budgets, step,
             off, on, routed):
    """One step of the JAX obs gate: the same batch routed with the plane
    off and fully on (a span around the route, a decision record per
    request as the engine emits them, host arrays whose conversion the
    event log defers, the monitor's capture), the order alternating by
    step; the
    host wall of each leg (us) appended to `off` and `on`. Returns the
    requests routed on the enabled leg."""
    nb = len(budgets)
    for leg in (("off", "on") if step % 2 == 0 else ("on", "off")):
        if leg == "off":
            ob.disable()
            t0 = time.perf_counter()
            disp.route(dbuf.front, q, budgets)
            off.append((time.perf_counter() - t0) * 1e6)
            continue
        ob.enable()
        t0 = time.perf_counter()
        with ob.span("bench.route_step"):
            choices = disp.route(dbuf.front, q, budgets)
            feas = np.searchsorted(sorted_costs, budgets, side="right")
            ob.events.emit_columns(
                "route", nb, {"step": step, "batch": nb},
                {"rid": range(routed, routed + nb), "model_idx": choices,
                 "budget": budgets, "feasible": feas})
            quality.observe_batch(budgets, choices)
        on.append((time.perf_counter() - t0) * 1e6)
    ob.enable()
    return nb


def overhead(off, on):
    """The JAX gate's estimator: the median of the paired per-step
    differences over the off-path p50."""
    p50_off = float(np.percentile(off, 50))
    delta = float(np.median(np.asarray(on) - np.asarray(off)))
    return dict(p50_off_us=p50_off, p50_on_us=float(np.percentile(on, 50)),
                paired_delta_us=delta, overhead_frac=delta / p50_off,
                steps=len(off))


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
    from repro_torch import graphs
    from repro_torch import obs as OBS
    from repro_torch.configs.eagle import PAPER_CONFIG
    from repro_torch.core.dispatch import RouteDispatcher
    from repro_torch.core.router import EagleRouter
    from repro_torch.core.state import DoubleBuffer, commit
    from repro_torch.launch.serve import build_obs_plane, quality_oracle
    from repro_torch.obs.alerts import LogFileSink
    from repro_torch.obs.exporter import ROUTES, ObsExporter
    from repro_torch.obs.quality import (RouterQualityMonitor,
                                         routing_regret_oracle)
    from repro_torch.obs.slo import SLOEngine, default_serving_rules
    from repro_torch.serving import Request, ServingEngine
    t_phase = time.perf_counter()
    router = EagleRouter(corpus.model_names, corpus.costs, PAPER_CONFIG,
                         device=dev)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
               query_id=fb["query_idx"])
    ob = OBS.Observability(enabled=True, trace_capacity=8 * OBS_STEPS + 64,
                           event_capacity=1 << 20)
    router.obs = ob
    disp = RouteDispatcher.for_router(router, obs=ob)
    dbuf = DoubleBuffer(router.db, router.global_ratings, device=dev, obs=ob,
                        tags=("obs_a", "obs_b"))
    quality = RouterQualityMonitor.for_router(router, obs=ob)
    slo = SLOEngine(ob.registry, default_serving_rules(), obs=ob)
    exporter = ObsExporter(ob, slo=slo, quality=quality).start()
    embs = np.asarray(corpus.embeddings, np.float32)
    lo_b, hi_b = float(corpus.costs.min()), float(corpus.costs.max())
    sorted_costs = np.sort(np.asarray(corpus.costs, np.float32))
    rng = np.random.default_rng(1)
    qid = iter(range(20_000_000, 1 << 40, 4))

    def batch(n=None):
        bs = int(rng.integers(1, OBS_MAX_BATCH + 1)) if n is None else n
        i = rng.integers(0, len(embs), bs)
        return embs[i], rng.uniform(lo_b, hi_b, bs).astype(np.float32)

    def feedback_cycle():
        """4 pairwise records on fresh prompts, a commit, and the post-fold
        ratings to the monitor (router.update bypasses feedback())."""
        i = rng.integers(0, len(embs), 4)
        base = next(qid)
        router.update(embs[i], [0, 1, 2, 3], [1, 2, 3, 0],
                      [1.0, 0.0, 0.5, 1.0],
                      query_id=[base + j for j in range(4)])
        dbuf.commit(router.global_ratings)
        quality.observe_ratings(router.global_ratings.cpu().numpy())

    t0 = time.perf_counter()
    warmed = warm_both(disp, dbuf, router)
    warm_s = time.perf_counter() - t0

    # 1. the quality gate, on the freshly fitted router as in JAX
    qob = OBS.Observability(enabled=True)
    tmp = tempfile.TemporaryDirectory()
    alert_path = Path(tmp.name) / "alerts.jsonl"
    mon = RouterQualityMonitor.for_router(
        router, obs=qob, attach=False, sinks=[LogFileSink(alert_path)])
    rng_q = np.random.default_rng(31)
    base = router.global_ratings.cpu().numpy().astype(np.float64)
    mismatches = scored = 0
    t0 = time.perf_counter()
    for step in range(QUALITY_STEPS):
        bs = int(rng_q.integers(1, QUALITY_WINDOW + 1))
        i = rng_q.integers(0, len(embs), bs)
        budgets = rng_q.uniform(lo_b, hi_b, bs).astype(np.float32)
        choices = disp.route(dbuf.front, embs[i], budgets)
        got = mon.score_batch(budgets, choices)
        want = routing_regret_oracle(mon.ratings, mon.costs, budgets,
                                     choices)
        mismatches += not np.array_equal(got, want)
        scored += bs
        if (step + 1) % QUALITY_FOLD_EVERY == 0:
            mon.observe_ratings(base + rng_q.normal(0.0, 1.0, M))
    stationary = mon.alerts_fired
    shifted = base.copy()
    shifted[0] += 400.0
    mon.observe_ratings(shifted + rng_q.normal(0.0, 1.0, M))
    perturbed = mon.alerts_fired - stationary
    quality_s = time.perf_counter() - t0
    events = qob.events.records("quality_alert")
    sink_docs = [json.loads(ln) for ln in alert_path.read_text().splitlines()
                 ] if alert_path.exists() else []
    tmp.cleanup()
    snap = mon.snapshot()
    log(f"quality gate ({QUALITY_STEPS} routed windows of 1..{QUALITY_WINDOW}"
        f", {scored} requests, a stationary fold every {QUALITY_FOLD_EVERY}"
        f"): regret unequal to the oracle on {mismatches} steps; alerts on "
        f"the stationary run {stationary}, after the +400 step {perturbed}"
        f" (events {len(events)}, alert-log lines {len(sink_docs)}: "
        f"{[d['payload'].get('alert') for d in sink_docs]}); regret mean "
        f"{snap['regret']['mean']:.3f} p99 {snap['regret']['p99']:.3f}; "
        f"{quality_s:.2f} s")
    stats["quality_gate"] = dict(
        steps=QUALITY_STEPS, requests_scored=scored,
        oracle_mismatches=mismatches, alerts_stationary=stationary,
        alerts_after_perturbation=perturbed, alert_events=len(events),
        alert_log_lines=len(sink_docs), wall_s=quality_s,
        regret=snap["regret"])
    if mismatches or stationary or perturbed < 1 or not events or not any(
            d["event"] == "quality_alert" for d in sink_docs):
        fail(f"quality gate: {mismatches} mismatches, {stationary} "
             f"stationary alerts, {perturbed} after the step, {len(events)} "
             f"events, alert log {sink_docs}")

    # 2. the obs gate
    args = (ob, disp, dbuf, quality, sorted_costs)
    with Scraper(exporter, ("/metrics", "/slo", "/healthz"), 0.25) as gate:
        for i in range(2):                    # a commit on each replica
            feedback_cycle()
        for step in range(3):                 # both legs' Python warm
            obs_legs(*args, *batch(), step, [], [], 0)
        c0, led0 = graphs.capture_count(), disp.cache_stats()
        ob.events.clear()        # count exactly the loop's decision records
        off, on, routed = [], [], 0
        t0 = time.perf_counter()
        for step in range(OBS_STEPS):
            routed += obs_legs(*args, *batch(), step, off, on, routed)
            if (step + 1) % OBS_COMMIT_EVERY == 0:
                feedback_cycle()
        captured = graphs.capture_count() - c0
        led = disp.cache_stats()
        traffic = led["misses"] - led0["misses"]
        gate_s = time.perf_counter() - t0
        ragged = overhead(off, on)
        out = ROOT / "chiprun_out"
        n_events = check_chrome_trace(
            Path(ob.tracer.save_chrome_trace(out / "obs_trace.json")))
        n_samples = check_prometheus(ob.registry.prometheus_text())
        n_dumped = ob.events.dump(out / "obs_decisions.jsonl")
        for line in (out / "obs_decisions.jsonl").read_text().splitlines():
            json.loads(line)
        n_route = len(ob.events.records("route"))
        per_bucket = {}
        for qb in OBS_BUCKETS:
            off_b, on_b = [], []
            for step in range(OBS_BUCKET_STEPS):
                obs_legs(*args, *batch(qb), step, off_b, on_b, 0)
            per_bucket[qb] = overhead(off_b, on_b)
    gate_scrapes = dict(scrapes=gate.scrapes, errors=gate.errors,
                        first_error=gate.first_error)
    log_time(stats,
             f"obs gate ({OBS_STEPS} ragged batches of 1..{OBS_MAX_BATCH}, "
             f"a feedback commit every {OBS_COMMIT_EVERY}, the plane live: "
             f"spans, decision records, the quality monitor, an exporter "
             f"scraped every 0.25 s): route p50 off {ragged['p50_off_us']:.1f}"
             f" us, on {ragged['p50_on_us']:.1f} us, paired delta "
             f"{ragged['paired_delta_us']:+.2f} us = "
             f"{ragged['overhead_frac'] * 100:+.2f}% (bar "
             f"{OBS_MAX_OVERHEAD * 100:.0f}%); per bucket "
             f"{ {qb: round(v['overhead_frac'] * 100, 2) for qb, v in per_bucket.items()} }% "
             f"(p50 off us "
             f"{ {qb: round(v['p50_off_us'], 1) for qb, v in per_bucket.items()} }); "
             f"warmup {warmed} route graphs in {warm_s:.2f} s, captures "
             f"after it {captured} (by traffic {traffic}); trace events "
             f"{n_events}, Prometheus samples {n_samples}, route records "
             f"{n_route} for {routed} routed requests ({n_dumped} dumped); "
             f"scrapes {gate_scrapes}; loop {gate_s:.2f} s")
    stats["obs_gate"] = dict(
        ragged=ragged, per_bucket=per_bucket, warmed=warmed, warm_s=warm_s,
        captured=captured, traffic_captures=traffic, trace_events=n_events,
        prometheus_samples=n_samples, route_records=n_route, routed=routed,
        spans_recorded=ob.tracer.recorded, spans_dropped=ob.tracer.dropped,
        scrapes=gate_scrapes, loop_s=gate_s)
    if ragged["overhead_frac"] > OBS_MAX_OVERHEAD:
        fail(f"obs gate: the plane costs {ragged['overhead_frac'] * 100:.2f}"
             f"% of route p50 (bar {OBS_MAX_OVERHEAD * 100:.0f}%)")
    if captured or traffic:
        fail(f"obs gate: {captured} captures after warmup, {traffic} by "
             "traffic")
    if n_route != routed or n_dumped < routed:
        fail(f"obs gate: {n_route} route records ({n_dumped} dumped) for "
             f"{routed} routed requests")
    if not gate.scrapes or gate.errors:
        fail(f"obs gate: scrapes {gate_scrapes}")

    # 3a. a fresh replica's ladder captured beside a scraper of all routes
    fresh = commit(router.db, router.global_ratings, None,
                   consumer="obs_fresh", device=dev)
    with Scraper(exporter, ROUTES, 0.001) as sc:
        c1 = graphs.capture_count()
        n_fresh = disp.warmup(fresh)
        caps_fresh = graphs.capture_count() - c1
        differ = 0
        for qb in OBS_BUCKETS:
            q, b = batch(qb)
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
    with Scraper(plane, ROUTES, 0.001) as sc2:
        while grown_routes < 2:
            if rounds >= PREBAKE_ROUNDS:
                fail(f"prebaker beside a scraper: the DB did not grow past "
                     f"{C_EXPECTED} rows in {rounds} rounds")
            q, b = batch(PREBAKE_BATCH)
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
    """Each layout of DECODE_SHAPES over an fp32 cache with ragged
    lengths, and over a full cache against the last row of flash; the
    control (kv_len - 1: the newest key dropped) must fail the bar."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, ratios, controls, timed, queued = {}, {}, {}, {}, {}
    for model, (b, t, h, hk, dh) in DECODE_SHAPES.items():
        q = _bf16(gen, (b, h, dh), dev)
        k = torch.randn((b, t, hk, dh), generator=gen, device=dev)  # fp32
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

        # decode over a full cache == the last row of prefill, held to
        # the flash bar: the flash kernel rounds its weights to bf16
        s = FLASH_SHAPES[model][1]
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

        ms = cuda_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 1000)
        # the device's own time, the host's launches queued ahead of it
        qms = queued_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 200)
        plain = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, kv_len), 5)
        q32 = q.float()[:, :, None]
        mask = (torch.arange(t, device=dev)[None]
                < kv_len[:, None])[:, None, None]
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q32, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True), 20)
        n_kv = float(kv_len.sum())
        nbytes = n_kv * hk * dh * 4 * 2 + 2.0 * 2 * b * h * dh + 4 * b
        bms, by = bound_ms(nbytes, 4.0 * h * dh * n_kv, PEAK_BF16_FLOPS)
        timed[model] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=bms, bound_by=by)
        queued[model] = qms
        log_time(stats,
                 f"decode_attention q bf16, cache fp32, {model} layout B={b} "
                 f"T={t} H={h} Hk={hk} dh={dh}, {int(n_kv)} valid rows: "
                 f"kernel_ms={ms} ({bms / ms} of the bound) queued_ms={qms} "
                 f"({bms / qms} of the bound) plain_ms={plain} "
                 f"library_ms(SDPA, fp32, mask)={lib} bound_ms={bms} ({by})")
    log(f"decode_attention max abs err {errs}; error over the bar (at most "
        f"1) {ratios}; control with kv_len - 1, over the bar (at least "
        f"{CONTROL_MIN}) {controls}")
    stats["decode_attention"] = dict(max_abs_err=errs, err_over_bar=ratios,
                                     control_over_bar=controls,
                                     queued_ms=queued, **timed)
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
    kernel call to hold, and its logits are held to the same bar."""
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
        enc = None
        if cfg.arch_type == "encdec":
            enc = torch.randn((len(lens), cfg.n_audio_frames, cfg.d_model),
                              generator=torch.Generator(
                                  device=dev).manual_seed(4), device=dev)
        worst = {p: dict(flash_attention=0.0, decode_attention=0.0)
                 for p in ("kernels", "control")}

        def run(p, fn):
            backend, drop = paths[p]
            with (contextlib.nullcontext() if drop is None
                  else kernels_held(worst[p], drop)):
                return fn(backend)

        out = {p: run(p, lambda b: T.prefill(
                   cfg, m.params, toks, SERVE_MAX_LEN,
                   cache_dtype=torch.float32, backend=b, enc_embeds=enc))
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
                       cfg, m.params, out[p][1], tok, s + step, backend=b))
                   for p in paths}
        del out
        held, ctl = worst["kernels"], worst["control"]
        if max(held.values()) > 1.0:
            fail(f"{name}: a kernel call on the model path misses its "
                 f"plain version by more than its bar: {held}")
        if cfg.arch_type != "ssm" and not ctl["decode_attention"] > 1.0:
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
    enc = None
    if m.cfg.arch_type == "encdec":
        enc = torch.zeros((t.shape[0], m.cfg.n_audio_frames,
                           m.cfg.d_model), device=m.device)
    logits, cache = T.prefill(m.cfg, m.params, t, m.max_len,
                              cache_dtype=torch.float32, enc_embeds=enc)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = T.decode_step(m.cfg, m.params, cache, tok,
                                      toks.shape[1] + i)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def compare_graph_generate(engine, stats):
    """Each fleet model's greedy tokens through its captured decode
    graphs (FleetModel.generate, a warmed row count of 8) against the
    eager path's on the same padded group of 8 prompts of 128..1024
    tokens, MAX_NEW tokens each: every token must be equal, and nothing
    may be captured."""
    rng = np.random.default_rng(8)
    out = {}
    for name, m in engine.fleet.items():
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
    stats["graph_tokens_differing"] = out
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
        enc = None
        if cfg.arch_type == "encdec":
            enc = torch.zeros((TIME_BATCH, cfg.n_audio_frames, cfg.d_model),
                              device=m.device)
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
            logits, cache = T.prefill(cfg, m.params, toks, SERVE_MAX_LEN,
                                      cache_dtype=torch.float32,
                                      enc_embeds=enc)
            torch.cuda.synchronize()
            ttft.append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)[:, None]
        T.decode_step(cfg, m.params, cache, tok, TIME_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIME_STEPS):
            logits, cache = T.decode_step(cfg, m.params, cache, tok,
                                          TIME_LEN + 1 + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TIME_STEPS
        del cache
        graph = graph_step_times(m, toks, enc)
        out[name] = dict(ttft_ms=statistics.median(ttft),
                         decode_step_ms=step_ms,
                         tokens_per_s=TIME_BATCH / step_ms * 1e3,
                         graph=graph)
        if enc is not None:
            out[name]["encoder_ms"] = statistics.median(enc_ms)
        log_time(stats,
                 f"{name}: time to first token (prefill of {TIME_BATCH} x "
                 f"{TIME_LEN}) p50 {out[name]['ttft_ms']:.2f} ms of "
                 f"{ttft}; decode step at batch {TIME_BATCH}, context "
                 f"~{TIME_LEN}: eager {step_ms:.3f} ms = "
                 f"{out[name]['tokens_per_s']:.1f} tokens/s; through its "
                 f"graph: wall {graph['wall_ms']:.3f} ms, device (events) "
                 f"{graph['device_ms']:.3f} ms, host (index update and "
                 f"replay, enqueued) {graph['host_ms']:.4f} ms = "
                 f"{TIME_BATCH / graph['wall_ms'] * 1e3:.1f} tokens/s")


@torch.inference_mode()
def graph_step_times(m, toks, enc):
    """One model's decode step at batch TIME_BATCH, context ~TIME_LEN,
    through its captured graph (FleetModel's static state, as generate
    drives it): the wall per step (host clock to a synchronise), the
    device time per step (CUDA events around the steps: the host runs
    far ahead of a replay, so no gap between graphs is counted), and the
    host's cost per step (an index update and a replay, enqueued)."""
    from repro_torch.models import transformer as T
    step = m._step(TIME_BATCH)
    cache, hist, index = m._view(TIME_BATCH)
    logits, _ = T.prefill(m.cfg, m.params, toks, m.max_len,
                          enc_embeds=enc, cache=cache)
    hist[:, TIME_LEN] = logits.argmax(-1)
    index.fill_(TIME_LEN)
    step(cache, hist, index)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TIME_STEPS):
        index.fill_(TIME_LEN + 1 + i)
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
    enc = None
    if m.cfg.arch_type == "encdec":
        enc = torch.zeros((TIME_BATCH, m.cfg.n_audio_frames, m.cfg.d_model),
                          device=m.device)

    def prefill():
        return T.prefill(m.cfg, m.params, toks, SERVE_MAX_LEN,
                         cache_dtype=torch.float32, enc_embeds=enc)
    logits, cache = prefill()
    tok = logits.argmax(-1)[:, None]
    T.decode_step(m.cfg, m.params, cache, tok, TIME_LEN)
    if what == "graph":
        del cache
        step = m._step(TIME_BATCH)
        cache, hist, index = m._view(TIME_BATCH)
        T.prefill(m.cfg, m.params, toks, SERVE_MAX_LEN, enc_embeds=enc,
                  cache=cache)
        index.fill_(TIME_LEN)
        step(cache, hist, index)
    torch.cuda.synchronize()
    n = 1 if what == "prefill" else 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            if what == "decode":
                T.decode_step(m.cfg, m.params, cache, tok, TIME_LEN + 1 + i)
            elif what == "graph":
                index.fill_(TIME_LEN + 1 + i)
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
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--db-shards",
         "1", "--prebake"], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(SRC)})
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
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--serve-obs",
             "0", "--alert-log", str(Path(tmp) / "alerts.jsonl")],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(SRC)})
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


def _whisper_site(kernels, key, name, nbytes, flops, got_ms, plain_ms,
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


def check_whisper_attention(dev, kernels, stats):
    """whisper-large-v3's five attention call sites in bf16 at its serving
    shapes (WHISPER_FLASH, WHISPER_DECODE), each against its plain
    version (the flash and decode bars of phase 6) with a control, one
    key dropped, that must fail by CONTROL_MIN: the encoder and the
    cross prefill drop the last key for every row (held on all rows),
    the causal decoder each row's own key (rows with at least S/2 keys),
    the decodes the newest row (kv_len - 1). Each timed beside its
    bound and SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(6)
    report = {}
    for site, (b, s, t, h, hk, dh, causal) in WHISPER_FLASH.items():
        q = _bf16(gen, (b, s, h, dh), dev)
        k = _bf16(gen, (b, t, hk, dh), dev)
        v = _bf16(gen, (b, t, hk, dh), dev)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        atol = flash_atol(q, k, v, causal=causal)
        err, ratio = flash_check(got, want, atol)
        if causal:
            ctl = flash_attention_cuda(q[:, 1:], k[:, :-1], v[:, :-1],
                                       causal=True)
            control = flash_check(ctl[:, s // 2:], want[:, 1 + s // 2:],
                                  atol[:, 1 + s // 2:])[1]
        else:
            ctl = flash_attention_cuda(q, k[:, :-1], v[:, :-1], causal=False)
            control = flash_check(ctl, want, atol)[1]
        if not (ratio <= 1.0 and control >= CONTROL_MIN):
            fail(f"whisper flash {site} B={b} S={s} S_kv={t}: error over "
                 f"the bar {ratio} (at most 1), control {control} (at "
                 f"least {CONTROL_MIN})")
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal),
                     20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                        causal=causal), 3)
        lib = cuda_ms(lambda: _sdpa(q, k, v, is_causal=causal), 20)
        nbytes = 2.0 * (2 * b * s * h * dh + 2 * b * t * hk * dh)
        pairs = s * (s + 1) / 2 if causal else s * t
        flops = 4.0 * b * h * dh * pairs
        bms, by = _whisper_site(kernels, f"whisper flash {site}",
                                f"flash_attention (whisper {site})",
                                nbytes, flops, ms, plain, lib, err)
        report[site] = dict(max_abs_err=err, err_over_bar=ratio,
                            control_over_bar=control, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=bms, bound_by=by)
        log_time(stats,
                 f"flash_attention bf16 whisper {site} B={b} S={s} "
                 f"S_kv={t} H={h} Hk={hk} dh={dh} causal={causal}: max abs "
                 f"err {err}, over the bar {ratio}, control {control}; "
                 f"kernel_ms={ms} ({bms / ms} of the bound) plain_ms={plain}"
                 f" library_ms(SDPA)={lib} (kernel / SDPA {ms / lib}) "
                 f"bound_ms={bms} ({by})")
    for site, (b, t, h, hk, dh) in WHISPER_DECODE.items():
        q = _bf16(gen, (b, h, dh), dev)
        k = torch.randn((b, t, hk, dh), generator=gen, device=dev)  # fp32
        v = torch.randn((b, t, hk, dh), generator=gen, device=dev)
        if site == "cross decode":        # every frame, every row
            kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
        else:                             # prompts of 128..1024 + steps
            kv_len = torch.randint(129, t + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        got = decode_attention_cuda(q, k, v, kv_len)
        want = ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len)
        err, ratio = decode_check(got, want)
        ctl = decode_attention_cuda(q, k, v, kv_len - 1)
        control = decode_check(ctl, want)[1]
        if not (ratio <= 1.0 and control >= CONTROL_MIN):
            fail(f"whisper {site} B={b} T={t}: error over the bar {ratio} "
                 f"(at most 1), control {control} (at least "
                 f"{CONTROL_MIN})")
        ms = cuda_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 1000)
        qms = queued_ms(lambda: decode_attention_cuda(q, k, v, kv_len), 200)
        plain = cuda_ms(lambda: ref.decode_attention_ref(q, k, v, kv_len), 5)
        mask = (torch.arange(t, device=dev)[None]
                < kv_len[:, None])[:, None, None]
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.float()[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 20)
        n_kv = float(kv_len.sum())
        nbytes = n_kv * hk * dh * 4 * 2 + 2.0 * 2 * b * h * dh + 4 * b
        bms, by = _whisper_site(kernels, f"whisper {site}",
                                f"decode_attention (whisper {site})",
                                nbytes, 4.0 * h * dh * n_kv, ms, plain, lib,
                                err)
        report[site] = dict(max_abs_err=err, err_over_bar=ratio,
                            control_over_bar=control, ms=ms, queued_ms=qms,
                            plain_ms=plain, library_ms=lib, bound_ms=bms,
                            bound_by=by)
        log_time(stats,
                 f"decode_attention q bf16, cache fp32, whisper {site} B={b} "
                 f"T={t} H={h} Hk={hk} dh={dh}, {int(n_kv)} valid rows: max "
                 f"abs err {err}, over the bar {ratio}, control {control}; "
                 f"kernel_ms={ms} ({bms / ms} of the bound) queued_ms={qms} "
                 f"({bms / qms} of the bound) plain_ms={plain}"
                 f" library_ms(SDPA, fp32, mask)={lib} bound_ms={bms} ({by})")
    stats["whisper_attention"] = report


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
    n_audio_frames rows, else self). A graph captured inside keeps the
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
        with _build.site(f"{current['model']} {site}"):
            return flash(q, k, v, **kw)

    def decode_site(q, k, v, kv_len, **kw):
        cfg = engine.fleet[current["model"]].cfg
        site = "decode cross" if cfg.arch_type == "encdec" \
            and k.shape[1] == cfg.n_audio_frames else "decode self"
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
    pool = RT.plan(nq, c, d, RT._sm_count(dev))[2] * n
    (b1, by1), (b2, _) = retrieve_bound(nq, c, d, pool)
    log_time(stats, f"knn retrieve Q={nq} C={c} D={d} top-{n} (pool {pool}"
             f"): equal to the similarity kernel's panel + stable sort; "
             f"scores max abs err {err}, top-n rows differing at near-ties "
             f"{differ}, prediction err {p_err}; the pair ms {ms} (device, "
             f"queued) against the panel + stable sort {panel_ms}; "
             f"plain_ms={plain} library_ms={lib} bound_ms={b1 + b2} ({by1})")
    kernels["retrieve knn"] = dict(
        name="retrieve knn", route="cuda",
        source="src/repro_torch/kernels/csrc/retrieve_topn.cu",
        replaces="src/repro/kernels/similarity_topk.py:42",
        max_abs_err=err, ms=ms, queued_ms=ms, plain_ms=plain,
        bound_ms=b1 + b2, bound_by=by1, library_ms=lib)
    stats["knn_retrieve"] = dict(q=nq, c=c, pool=pool,
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
    libs = _build.build()
    stats = {"card": card, "build_s": time.perf_counter() - t0}
    log(f"built {[p.name for p in libs]} in {stats['build_s']:.1f} s")
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

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with pregathered_selects() as unfused:
        router, disp, dbuf, test, grid = drive_main_path(dev, corpus, fb,
                                                         stats)
    torch.cuda.synchronize()
    launches = {"route": _build.launch_counts()}
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
    check_whisper_attention(dev, kernels, stats)
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

    if any(m == "jax" or m.startswith("jax.") or m in ("repro", "benchmarks")
           or m.startswith(("repro.", "benchmarks.")) for m, v in
           sys.modules.items() if v is not None):
        fail("JAX, the JAX package or its benchmarks were imported")
    for name, entry in kernels.items():
        if name in WHISPER_SITES:
            entry["launches"] = sites[f"whisper-large-v3 "
                                      f"{WHISPER_SITES[name]}"]
            continue
        if name == "elo_scan fit fold":
            entry["launches"] = stats["fit_fold_launches"]
            continue
        if name == "retrieve knn":
            entry["launches"] = sum(knn_launches.values())
            continue
        if name == "sharded_retrieve_replay_select":
            continue                 # set by drive_sharded
        # similarity: off every path since the fused retrieve (0 here)
        path = "route" if name in ROUTE_KERNELS + ("similarity",) \
            else "serve"
        entry["launches"] = launches[path][name]
    order = ROUTE_KERNELS + ("similarity", "elo_scan fit fold",
                             "sharded_retrieve_replay_select",
                             "flash_attention",
                             "decode_attention") + tuple(WHISPER_SITES) \
        + ("retrieve knn",)
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
