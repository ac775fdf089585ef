#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's routing path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit. It builds the port's kernels from `src/repro_torch/kernels/
csrc/` into `build/repro_torch/` (one `nvcc` per source, all started
together), then:

  1. prints the card (name, power limit) and the torch/CUDA versions;
  2. holds every kernel against its plain PyTorch version on the card,
     at the shapes the routing path gives it, with the stated
     tolerances;
  3. drives the main path at the paper's width (D = 1536, N = 20, K = 32,
     P = 0.5, the 10-model fleet) over a RouterBench-scale corpus:
     fit (196k records, C = 32768, R = 8), a RouteDispatcher over a
     DoubleBuffer warmed on the 8..1024 ladder, ragged routing of the
     10,500 test queries at several budgets, the AUC over the budget
     grid, and 3 rounds of online feedback (global fold, commit,
     route), then routes 1024 queries through the kernels and through
     the plain versions and compares the choices;
  4. checks that every kernel of the path was launched in that run;
  5. times each kernel (CUDA events), its plain version, the library
     call where one exists, and the path's end-to-end latencies.

Any mismatch or exception exits non-zero. The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON, and the one before that the card's name and power limit.
Everything measured is also written to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
# tolerances: the JAX suite's own bars between its backends
SIM_TOL = 1e-5                     # similarity (tests/test_kernels.py)
R_RTOL, R_ATOL = 1e-5, 1e-3        # ratings (tests/test_router_state.py)
CHOICE_TIE = 1e-3                  # top-two combined scores this close: a tie
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of one replay step of one query: difference, divide,
# pow, add, reciprocal, difference, two products, two updates
REPLAY_STEP_OPS = 10


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
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


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def check_similarity(dev, kernels, stats):
    from repro_torch.kernels import ref
    from repro_torch.kernels.similarity_topk import similarity_cuda
    rng = torch.Generator(device=dev).manual_seed(0)
    db = torch.randn((C_EXPECTED, DIM), generator=rng, device=dev)
    for nq in (1024, 8):
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
        ms = cuda_ms(lambda: similarity_cuda(q, db), 20 if nq > 8 else 50)
        plain = cuda_ms(lambda: ref.similarity_ref(q, db), 20)
        lib = cuda_ms(lambda: torch.matmul(
            torch.nn.functional.normalize(q, dim=-1),
            torch.nn.functional.normalize(db, dim=-1).T), 20)
        nbytes = 4.0 * (nq * DIM + C_EXPECTED * DIM + nq * C_EXPECTED)
        flops = 2.0 * nq * C_EXPECTED * DIM + 2.0 * (nq + C_EXPECTED) * DIM
        bms, by = bound_ms(nbytes, flops)
        log_time(stats,
                 f"similarity Q={nq} C={C_EXPECTED} D={DIM}: "
                 f"max_abs_err={err} topk rows differing at near-ties="
                 f"{differ} kernel_ms={ms} plain_ms={plain} "
                 f"library_ms={lib} bound_ms={bms} ({by})")
        stats[f"similarity_q{nq}"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain, library_ms=lib,
                                          bound_ms=bms, bound_by=by,
                                          topk_rows_near_tie=differ)
        if nq == 1024:
            kernels["similarity"] = dict(
                name="similarity", route="cuda",
                source="src/repro_torch/kernels/csrc/similarity.cu",
                replaces="src/repro/kernels/similarity_topk.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def replay_inputs(dev, gen, nq, t):
    a = torch.randint(0, M, (nq, t), generator=gen, device=dev,
                      dtype=torch.int32)
    b = (a + torch.randint(1, M, (nq, t), generator=gen, device=dev,
                           dtype=torch.int32)) % M
    s = torch.randint(0, 3, (nq, t), generator=gen, device=dev).float() / 2
    v = torch.rand((nq, t), generator=gen, device=dev) < 0.8
    r0 = 1000 + 50 * torch.randn((nq, M), generator=gen, device=dev)
    return r0, a.int(), b.int(), s, v


def check_replay(dev, kernels, stats, fold_records):
    from repro_torch.kernels import ref
    from repro_torch.kernels.elo_scan import (elo_scan_cuda,
                                              elo_scan_select_cuda)
    gen = torch.Generator(device=dev).manual_seed(1)
    nq, t = 1024, N * R              # N neighbours x R records
    r0, a, b, s, v = replay_inputs(dev, gen, nq, t)
    g = 1000 + 30 * torch.randn((M,), generator=gen, device=dev)
    costs = 0.5 + 40 * torch.rand((M,), generator=gen, device=dev)
    bud = 45 * torch.rand((nq,), generator=gen, device=dev)

    got_r, got_c = elo_scan_select_cuda(r0, a, b, s, v, g, costs, bud, p=P)
    want_r, want_c = ref.elo_scan_select_ref(r0, a, b, s, v, g, costs, bud,
                                             p=P)
    torch.cuda.synchronize()
    err = float((got_r - want_r).abs().max())
    if not torch.allclose(got_r, want_r, rtol=R_RTOL, atol=R_ATOL):
        fail(f"elo_scan_select ratings: max abs err {err}")
    comb = P * g[None] + (1 - P) * want_r
    comb = torch.where(costs[None] <= bud[:, None], comb,
                       torch.full_like(comb, float("-inf")))
    differ, untied = choices_agree(got_c, want_c, comb)
    if untied:
        fail(f"elo_scan_select: {untied} choices differ without a tie")
    ms = cuda_ms(lambda: elo_scan_select_cuda(r0, a, b, s, v, g, costs, bud,
                                              p=P), 200)
    plain = cuda_ms(lambda: ref.elo_scan_select_ref(r0, a, b, s, v, g, costs,
                                                    bud, p=P), 3, warmup=1)
    nbytes = nq * t * (4 + 4 + 4 + 1) + nq * M * 4 * 2 + nq * 4 * 2 \
        + 2 * M * 4
    flops = nq * t * REPLAY_STEP_OPS + nq * M * 3
    bms, by = bound_ms(nbytes, flops)
    log_time(stats,
             f"elo_scan_select Q={nq} T={t} M={M}: max_abs_err={err} choices "
             f"differing at ties={differ} kernel_ms={ms} plain_ms={plain} "
             f"bound_ms={bms} ({by})")
    stats["elo_scan_select"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                    bound_ms=bms, bound_by=by,
                                    choices_differing_at_ties=differ)
    kernels["elo_scan_select"] = dict(
        name="elo_scan_select", route="cuda",
        source="src/repro_torch/kernels/csrc/elo_scan.cu",
        replaces="src/repro/kernels/elo_scan.py:124", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)

    # the replay without the epilogue, at the same shape
    got = elo_scan_cuda(r0, a, b, s, v)
    want = ref.elo_scan_ref(r0, a, b, s, v)
    torch.cuda.synchronize()
    err_local = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=R_RTOL, atol=R_ATOL):
        fail(f"elo_scan Q={nq}: max abs err {err_local}")
    ms_local = cuda_ms(lambda: elo_scan_cuda(r0, a, b, s, v), 200)
    log_time(stats,
             f"elo_scan Q={nq} T={t} M={M}: max_abs_err={err_local} "
             f"kernel_ms={ms_local}")
    stats["elo_scan_q1024"] = dict(max_abs_err=err_local, ms=ms_local)

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

    # timed at the online update's shape: a 400-record fold, padded to 512
    t_up = 512
    ua, ub, us = (x[:, :t_up].contiguous() for x in fold[:3])
    uv = torch.arange(t_up, device=dev)[None] < 400
    ms_up = cuda_ms(lambda: elo_scan_cuda(g0, ua, ub, us, uv), 200)
    plain_up = cuda_ms(lambda: ref.elo_scan_ref(g0, ua, ub, us, uv), 3,
                       warmup=1)
    nbytes = t_up * 13 + 2 * M * 4
    bms, by = bound_ms(nbytes, 400 * REPLAY_STEP_OPS)
    log_time(stats,
             f"elo_scan Q=1 T={t_up} (online fold): kernel_ms={ms_up} "
             f"plain_ms={plain_up} bound_ms={bms} ({by})")
    stats["elo_scan_fold512"] = dict(ms=ms_up, plain_ms=plain_up,
                                     bound_ms=bms, bound_by=by)
    kernels["elo_scan"] = dict(
        name="elo_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/elo_scan.cu",
        replaces="src/repro/kernels/elo_scan.py:157",
        max_abs_err=max(err_local, err_fold), ms=ms_up, plain_ms=plain_up,
        bound_ms=bms, bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def drive_main_path(dev, corpus, fb, stats):
    from repro_torch.configs.eagle import PAPER_CONFIG
    from repro_torch.core.dispatch import RouteDispatcher, bucket_ladder
    from repro_torch.core.router import EagleRouter
    from repro_torch.core.state import DoubleBuffer
    from repro_torch.data.routerbench import (budget_grid, evaluate_router,
                                              pairwise_feedback)

    router = EagleRouter(corpus.model_names, corpus.costs, PAPER_CONFIG,
                         device=dev)
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
             f"size={db.size}: {fit_s:.3f} s")

    t0 = time.perf_counter()
    dbuf = DoubleBuffer(db, router.global_ratings, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    disp = RouteDispatcher.for_router(router)
    t0 = time.perf_counter()
    warmed = disp.warmup(dbuf.front)
    warm_s = time.perf_counter() - t0
    log_time(stats,
             f"double buffer upload {upload_s:.3f} s; warmup of {warmed} "
             f"buckets {bucket_ladder()} {warm_s:.3f} s")

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


def compare_route(router, dbuf, test, grid, stats):
    """1024 queries through the kernels and through the plain versions,
    both on the card."""
    from repro_torch.core.state import route_batch
    from repro_torch.kernels import ref
    st = dbuf.front
    q = torch.tensor(test[:1024], device=st.device)
    bud = torch.linspace(float(grid[0]), float(grid[-1]), len(q),
                         device=st.device)
    kw = router._kw()
    kw.pop("backend")
    got = route_batch(st, q, bud, router.costs, backend="cuda", **kw)
    want = route_batch(st, q, bud, router.costs, backend="reference", **kw)
    torch.cuda.synchronize()
    panel = ref.similarity_ref(q, st.emb)
    panel[:, int(st.size):] = float("-inf")
    t_differ, t_untied = topk_rows_agree(got.topk_idx, want.topk_idx, panel,
                                         N, SIM_TOL)
    if t_untied:
        fail(f"route: top-{N} differs on {t_untied} rows without a tie")
    same = (got.topk_idx == want.topk_idx).all(dim=1)
    comb = torch.where(router.costs[None] <= bud[:, None], want.scores,
                       torch.full_like(want.scores, float("-inf")))
    c_differ, c_untied = choices_agree(got.choices[same], want.choices[same],
                                       comb[same])
    if c_untied:
        fail(f"route: {c_untied} choices differ without a tie")
    if not torch.allclose(got.scores[same], want.scores[same], rtol=R_RTOL,
                          atol=R_ATOL):
        fail("route: scores differ")
    n_diff = int((got.choices.long() != want.choices.long()).sum())
    log(f"route {len(q)} queries, kernels vs plain on the card: {n_diff} "
        f"choices differ ({c_differ} at score ties, the rest on {t_differ} "
        f"rows whose retrieval met a near-tie)")
    stats["route_choices_differing"] = n_diff


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
    log_time(stats,
             f"route p50 ms per bucket: {p50}")
    stats["route_p50_ms"] = p50
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
        log_time(stats,
                 f"profile bucket {qb}: wall {wall_ms} ms/route, device "
                 f"{device_ms} ms/route, busy {device_ms / wall_ms}; "
                 f"top: {top}")
        stats["profile"][qb] = dict(wall_ms=wall_ms, device_ms=device_ms,
                                    top=top)


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
    log(f"built {[p.name for p in libs]} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    corpus = make_corpus(seed=0, n_per_dataset=N_PER_DATASET, dim=DIM)
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=PAIRS_PER_QUERY)
    log(f"corpus: {len(corpus.embeddings)} prompts, "
        f"{len(fb['model_a'])} train records, {corpus.n_models} models "
        f"({time.perf_counter() - t0:.1f} s on the host)")

    kernels, stats = {}, {"card": card}
    check_similarity(dev, kernels, stats)
    check_replay(dev, kernels, stats,
                 (fb["model_a"], fb["model_b"], fb["outcome"]))

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    router, disp, dbuf, test, grid = drive_main_path(dev, corpus, fb,
                                                     stats)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    stats["launches"] = launches
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    compare_route(router, dbuf, test, grid, stats)
    time_path(disp, dbuf, router, test, stats)
    profile_route(disp, dbuf, router, test, stats)

    if any(m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.") for m, v in sys.modules.items()
           if v is not None):
        fail("JAX or the JAX package was imported")
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    order = ("similarity", "elo_scan_select", "elo_scan")
    line = {"kernels": [kernels[k] for k in order]}
    stats["kernels"] = line["kernels"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(stats, indent=1))
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
