"""End-to-end batch-routing latency on the port: the fused route (the
retrieve's two kernels and the replay, through the dispatcher's CUDA
graphs) against the seed's host-hopping object path, over a
RouterBench-style corpus. The counterpart of
`benchmarks/route_batch_bench.py`, with its four parts and flags:

  PYTHONPATH=src python -m benchmarks_torch.route_batch_bench [--smoke]
  PYTHONPATH=src python -m benchmarks_torch.route_batch_bench \\
      [--smoke] --ragged [--assert-steady-state] [--trace OUT.json]
  PYTHONPATH=src python -m benchmarks_torch.route_batch_bench \\
      [--smoke] --mesh N [--assert-sharded]
  PYTHONPATH=src python -m benchmarks_torch.route_batch_bench \\
      [--smoke] (--obs | --assert-obs)

Every entry point runs on the card unless `--device cpu` is given (the
plain versions; the tests run so).

The legacy path is the seed's serve() hot path: `VectorDB.query` (the
similarity kernel's panel and a stable sort) -> `gather_feedback` (host
fancy-indexing) -> `elo.local_elo` (the plain replay loop) -> the score
combine and budget selection on the host. `run` asserts that its
choices equal the fused route's.

--ragged is the steady-state serving scenario: a loop of random batch
sizes through the dispatcher over a double-buffered state with a
feedback commit every 20 steps. The JAX package counts XLA compiles
after warmup; the port's counterpart is CUDA graph captures after warmup
(`graphs.capture_count()` and the dispatcher ledger's misses), reported
under the JAX key `post_warmup_xla_compiles`, so the JSON keys stay the
JAX module's. --assert-steady-state exits non-zero on any capture after
warmup.

--mesh N routes the same loop over an N-shard DB mesh. JAX re-execs
with forced host devices; the port's mesh is single-controller
(ROADMAP §4.10): on one card its shards repeat the card, on the CPU they
are `["cpu"] * N`. The choices must equal the unsharded route's bit for
bit (--assert-sharded).

--obs / --assert-obs is the telemetry overhead gate: each step routes
the same batch with the plane off and fully on (spans, a decision record
a request, the quality monitor, an exporter scraped by a thread), in
alternating order; the paired-delta overhead must stay within 5% of the
off-path p50, nothing captured after warmup, and the Chrome trace,
Prometheus text and decision JSONL must parse. `obs_gate` is the loop
itself; `chip_smoke.py` calls it at the paper's width with its own
world.

Results go to results/torch/ (`common.save_json`), never to the JAX
package's BENCH_route.json.
"""
from __future__ import annotations

import argparse
import json
import re
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from benchmarks_torch import common as C
from repro_torch import DeviceLike, graphs, resolve_device
from repro_torch import obs as OBS
from repro_torch.core import elo
from repro_torch.core.dispatch import RouteDispatcher
from repro_torch.core.state import (DoubleBuffer, combine_scores,
                                    route_batch, route_batch_choices,
                                    state_from_buffer)

#: the paths the gate's scraper reads, as the JAX gate's
SCRAPE_PATHS = ("/metrics", "/slo", "/healthz")


def legacy_route(router, q, budgets):
    """The seed implementation's serve() hot path: the legacy retrieval
    on the router's device, the records gathered on the host, the plain
    replay, and the selection in numpy."""
    q = torch.as_tensor(np.asarray(q, np.float32), device=router.device)
    idx, _, hit = router.db.query(q, router.cfg.n_neighbors)
    a, b, s, v = router.db.gather_feedback(idx, hit)   # host round trip
    local = elo.local_elo(router.global_ratings, a, b, s, v,
                          k=router.cfg.k_factor)
    scores = combine_scores(router.global_ratings, local,
                            router.cfg.p_global).cpu().numpy()
    costs = router.costs.cpu().numpy()
    budgets = np.asarray(budgets, np.float32)
    feasible = costs[None, :] <= budgets[:, None]
    masked = np.where(feasible, scores, -np.inf)
    return np.where(feasible.any(1), masked.argmax(1),
                    int(np.argmin(costs)))


def run(verbose: bool = True, smoke: bool = False,
        device: DeviceLike = None):
    """The fused route against the legacy path at batches 1, 8, 64, 256
    (smoke: 8, 64), choices asserted equal; then the incremental commit
    against a full upload. Returns (name, us_per_call, derived) rows."""
    dev = resolve_device(device)
    n_per = 60 if smoke else C.N_PER_DATASET
    repeat = 3 if smoke else 9
    corpus, fb = C.build(0, dev, n_per_dataset=n_per)
    router, _ = C.fit_eagle(corpus, fb, device=dev)
    kw = router._kw()
    rows = []
    for batch in (8, 64) if smoke else (1, 8, 64, 256):
        rng = np.random.default_rng(batch)
        q = corpus.embeddings[rng.integers(0, len(corpus.embeddings), batch)]
        budgets = rng.uniform(corpus.costs.min(), corpus.costs.max(),
                              batch).astype(np.float32)
        state = router.state
        qd = torch.as_tensor(q, dtype=torch.float32, device=dev)
        bd = torch.as_tensor(budgets, device=dev)
        # warm both paths (the legacy retrieval's DB snapshot) first
        route_batch(state, qd, bd, router.costs, **kw)
        legacy_route(router, q, budgets)
        us_fused, res = C.timer(
            lambda: route_batch(state, qd, bd, router.costs, **kw),
            repeat=repeat)
        us_legacy, legacy_choice = C.timer(
            lambda: legacy_route(router, q, budgets), repeat=repeat)
        assert (res.choices.cpu().numpy() == legacy_choice).all(), \
            "fused/legacy disagreement"
        rows.append((f"route_batch_fused_q{batch}", us_fused,
                     f"legacy={us_legacy:.0f}us"
                     f"|speedup={us_legacy / us_fused:.2f}x"))

    # incremental commit against a full re-upload (the online-update
    # claim): the feedback append and the global fold happen outside the
    # timed region, which holds only the dirty-row copies of commit()
    fb2_emb = np.asarray(corpus.embeddings[:4], np.float32)
    ts = []
    for _ in range(repeat + 1):              # the first one warms
        router.update(fb2_emb, [0, 1, 2, 3], [1, 2, 3, 0],
                      [1.0, 0.0, 0.5, 1.0])
        t0 = time.perf_counter()
        router.state
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts.append((time.perf_counter() - t0) * 1e6)
    us_commit = float(np.median(ts[1:]))
    us_full, _ = C.timer(
        lambda: state_from_buffer(router.db, router.global_ratings,
                                  device=dev), repeat=repeat)
    rows.append(("state_commit_incremental", us_commit,
                 f"full_upload={us_full:.0f}us"))

    if verbose:
        for n, us, d in rows:
            print(f"[route_batch] {n},{us:.1f},{d}")
    C.save_json("route_batch_bench.json",
                [{"name": n, "us_per_call": us, "derived": d}
                 for n, us, d in rows])
    return rows


class RaggedWorld:
    """The steady-state scenarios' world: a fitted router, a dispatcher
    and a double-buffered state over it, and the periodic feedback cycle.
    `build` makes the JAX module's (the frozen corpus at D = 64); a caller
    with a router of its own (chip_smoke.py, at the paper's width) passes
    it in."""

    def __init__(self, router, embs, costs, *, max_batch: int,
                 commit_every: int = 20, obs=None, mesh=None,
                 max_bucket: int = 0, tags=DoubleBuffer.TAGS):
        self.router = router
        self.max_batch = max_batch
        self.commit_every = commit_every
        self.rng = np.random.default_rng(1)
        self.embs = np.asarray(embs, np.float32)
        self.costs = np.asarray(costs, np.float32)
        self.bud_lo = float(self.costs.min())
        self.bud_hi = float(self.costs.max())
        # mesh: capacity-shard the routing DB (DESIGN.md §12): the
        # dispatcher keeps sharded graphs, commits owner-scatter
        self.mesh = mesh
        self.dispatch = RouteDispatcher.for_router(
            router, max_bucket=max_bucket or max_batch, obs=obs, mesh=mesh)
        self.dbuf = DoubleBuffer(router.db, router.global_ratings,
                                 device=router.device, mesh=mesh, tags=tags,
                                 obs=obs)
        router.obs = obs
        self._qid = 20_000_000

    @classmethod
    def build(cls, smoke: bool, n_steps: int, commit_every: int = 20,
              obs=None, mesh=None, device: DeviceLike = None):
        dev = resolve_device(device)
        corpus, fb = C.build(0, dev, n_per_dataset=60 if smoke
                             else C.N_PER_DATASET)
        router, _ = C.fit_eagle(corpus, fb, device=dev)
        w = cls(router, corpus.embeddings, corpus.costs,
                max_batch=64 if smoke else 256, commit_every=commit_every,
                obs=obs, mesh=mesh)
        # the loop appends rows; it must not outgrow the buffer mid-run
        # (a grow makes new replicas, whose graphs are captured anew)
        n_commits = n_steps // commit_every
        assert router.db.size + 4 * (n_commits + 2) <= router.db.capacity
        return w

    def feedback_cycle(self, qid_base=None):
        """One real online update: 4 pairwise records on fresh prompts
        and a double-buffer commit."""
        if qid_base is None:
            qid_base, self._qid = self._qid, self._qid + 4
        i = self.rng.integers(0, len(self.embs), 4)
        self.router.update(self.embs[i], [0, 1, 2, 3], [1, 2, 3, 0],
                           [1.0, 0.0, 0.5, 1.0],
                           query_id=[qid_base + j for j in range(4)])
        self.dbuf.commit(self.router.global_ratings)

    def warmup(self):
        """The bucket ladder on both replicas (the dispatcher keys a graph
        on its replica), each followed by a real feedback/commit cycle.
        Returns (seconds, route graphs captured)."""
        t0 = time.perf_counter()
        warm = 0
        for i in range(2):
            warm += self.dispatch.warmup(self.dbuf.front)
            self.feedback_cycle(10_000_000 + 4 * i)
        return time.perf_counter() - t0, warm

    def next_batch(self, n: int = 0):
        bs = n or int(self.rng.integers(1, self.max_batch + 1))
        i = self.rng.integers(0, len(self.embs), bs)
        budgets = self.rng.uniform(self.bud_lo, self.bud_hi,
                                   bs).astype(np.float32)
        return self.embs[i], budgets


class CaptureCounter:
    """The counterpart of JAX's CompileCounter: CUDA graph captures in
    the process and the dispatcher's cache misses inside the block."""

    def __init__(self, dispatch):
        self.dispatch = dispatch

    def __enter__(self):
        self.c0 = graphs.capture_count()
        self.m0 = self.dispatch.cache_stats()["misses"]
        return self

    def __exit__(self, *exc):
        self.captures = graphs.capture_count() - self.c0
        self.misses = self.dispatch.cache_stats()["misses"] - self.m0
        return False

    def delta(self) -> int:
        return max(self.captures, self.misses)


def _loop(w, n_steps, span=None):
    lat_us = []
    with CaptureCounter(w.dispatch) as cc:
        for step in range(n_steps):
            q, budgets = w.next_batch()
            t0 = time.perf_counter()
            if span is None:
                w.dispatch.route(w.dbuf.front, q, budgets)
            else:
                with span("bench.route_step"):
                    w.dispatch.route(w.dbuf.front, q, budgets)
            lat_us.append((time.perf_counter() - t0) * 1e6)
            if (step + 1) % w.commit_every == 0:
                w.feedback_cycle()
    return lat_us, cc.delta()


def _dispatch_stats(dispatch):
    return {k: v for k, v in dispatch.cache_stats().items() if k != "keys"}


def run_ragged(verbose: bool = True, smoke: bool = False,
               assert_steady_state: bool = False,
               trace_path: str | None = None, device: DeviceLike = None):
    """Ragged traffic (a random batch size a step) through the dispatcher
    over a double-buffered state with periodic feedback commits: after
    warmup the loop must capture no graph."""
    n_steps = 60 if smoke else 500
    ob = OBS.Observability(enabled=bool(trace_path),
                           trace_capacity=4 * n_steps + 64)
    w = RaggedWorld.build(smoke, n_steps, obs=ob, device=device)
    warm_s, warm_routes = w.warmup()
    lat_us, captures = _loop(w, n_steps, ob.span)

    p50, p90, p99 = (float(np.percentile(lat_us, p)) for p in (50, 90, 99))
    payload = {
        "scenario": "ragged_steady_state",
        "smoke": smoke,
        "steps": n_steps,
        "max_batch": w.max_batch,
        "commit_every": w.commit_every,
        "route_p50_us": p50,
        "route_p90_us": p90,
        "route_p99_us": p99,
        "warmup_s": warm_s,
        "warmup_route_executables": warm_routes,
        # CUDA graph captures after warmup (the JAX key: XLA compiles)
        "post_warmup_xla_compiles": captures,
        "dispatch": _dispatch_stats(w.dispatch),
        "telemetry": w.dispatch.telemetry(),
        "metrics": ob.registry.json_snapshot(),
    }
    C.save_json("route_ragged_bench.json", payload)
    if trace_path:
        ob.tracer.save_chrome_trace(trace_path)
        if verbose:
            print(f"[route_ragged] chrome trace -> {trace_path} "
                  f"({ob.tracer.recorded} spans, "
                  f"{ob.tracer.dropped} dropped)")
    if verbose:
        tel = payload["telemetry"]
        print(f"[route_ragged] steps={n_steps} max_batch={w.max_batch} "
              f"p50={p50:.0f}us p90={p90:.0f}us p99={p99:.0f}us "
              f"warmup={warm_s:.1f}s ({warm_routes} graphs) "
              f"post_warmup_captures={captures} "
              f"pad_waste={tel['pad_waste_ratio']:.2f} "
              f"hit_rate={tel['cache_hit_rate']:.3f}")
    if assert_steady_state and captures != 0:
        raise SystemExit(
            f"steady-state violation: {captures} graph capture(s) after "
            f"warmup (expected 0) — dispatch stats: "
            f"{w.dispatch.cache_stats()}")
    return payload


# ---------------------------------------------------------------------------
# sharded routing gate (--assert-sharded)
# ---------------------------------------------------------------------------

def _mesh(n: int, dev: torch.device):
    """An n-shard DB mesh on the run's device: the first n cards when the
    machine has them, else n shards on the one card (or the CPU)."""
    from repro_torch.launch.mesh import make_db_mesh
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return make_db_mesh(n)
    return make_db_mesh(n, [dev] * n)


def run_sharded(verbose: bool = True, smoke: bool = False,
                mesh_n: int = 2, assert_sharded: bool = False,
                device: DeviceLike = None):
    """The ragged loop over a capacity-sharded state (DESIGN.md §12):
    the dispatcher keeps sharded graphs and every commit owner-scatters
    over the mesh. Reports latency and the captures after warmup, and
    holds the sharded choices to the unsharded route's, bit for bit."""
    dev = resolve_device(device)
    n_steps = 60 if smoke else 300
    mesh = _mesh(mesh_n, dev)
    w = RaggedWorld.build(smoke, n_steps, mesh=mesh, device=dev)
    warm_s, warm_routes = w.warmup()
    lat_us, captures = _loop(w, n_steps)

    # the oracle check outside the counted region (the unsharded route
    # has graphs of its own): routing is pure, so fresh batches over the
    # final state are a sound equivalence probe
    kw = w.router._kw()
    checked = mismatches = 0
    oracle = state_from_buffer(w.router.db, w.router.global_ratings,
                               device=mesh.leader)
    for _ in range(8):
        q, budgets = w.next_batch()
        got = w.dispatch.route(w.dbuf.front, q, budgets)
        want = route_batch_choices(oracle, q, budgets, w.router.costs,
                                   **kw).choices.cpu().numpy()
        checked += len(got)
        mismatches += int((got != want).sum())

    p50, p90, p99 = (float(np.percentile(lat_us, p)) for p in (50, 90, 99))
    payload = {
        "mesh": mesh_n,
        "smoke": smoke,
        "steps": n_steps,
        "max_batch": w.max_batch,
        "commit_every": w.commit_every,
        "route_p50_us": p50,
        "route_p90_us": p90,
        "route_p99_us": p99,
        "warmup_s": warm_s,
        "warmup_route_executables": warm_routes,
        "post_warmup_xla_compiles": captures,
        "oracle_rows_checked": checked,
        "oracle_mismatches": mismatches,
        "dispatch": _dispatch_stats(w.dispatch),
    }
    C.save_json("route_sharded_bench.json", payload)
    if verbose:
        print(f"[route_sharded] mesh={mesh_n} steps={n_steps} "
              f"p50={p50:.0f}us p90={p90:.0f}us p99={p99:.0f}us "
              f"warmup={warm_s:.1f}s ({warm_routes} graphs) "
              f"post_warmup_captures={captures} "
              f"oracle={checked - mismatches}/{checked} rows equal")
    if assert_sharded:
        if captures != 0:
            raise SystemExit(
                f"sharded gate: {captures} graph capture(s) after warmup "
                f"on the {mesh_n}-shard mesh (expected 0) — dispatch "
                f"stats: {w.dispatch.cache_stats()}")
        if mismatches:
            raise SystemExit(
                f"sharded gate: {mismatches}/{checked} choices diverge "
                f"from the unsharded route on the {mesh_n}-shard mesh "
                f"(expected bit-identical)")
    return payload


# ---------------------------------------------------------------------------
# telemetry overhead gate (--assert-obs)
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


def validate_prometheus(text: str) -> int:
    """Every non-comment line must be `name{labels} value`; returns the
    number of samples."""
    n = 0
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        if not _PROM_LINE.match(line):
            raise SystemExit(f"unparseable Prometheus line: {line!r}")
        n += 1
    if n == 0:
        raise SystemExit("empty Prometheus snapshot")
    return n


def validate_chrome_trace(path: Path) -> int:
    """The trace must be traceEvents JSON with complete events and at
    least one route span; returns the event count."""
    evs = json.loads(Path(path).read_text())["traceEvents"]
    xs = [e for e in evs if e.get("ph") == "X"]
    bad = [e for e in xs if not (isinstance(e["ts"], (int, float))
                                 and e["dur"] >= 0 and e["name"]
                                 and "pid" in e and "tid" in e)]
    if not evs or bad:
        raise SystemExit(f"Chrome trace {path}: {len(evs)} events, "
                         f"{len(bad)} malformed")
    if not any("route" in e["name"] for e in xs):
        raise SystemExit("trace has no route spans")
    return len(evs)


class Scraper:
    """A thread that GETs `paths` of a running exporter in turn until it
    is stopped, waiting `pause` seconds after each round, and counts the
    scrapes and the errors (the first kept). It touches no CUDA state, as
    the exporter's own thread does not: a capture fails if another
    thread makes an unsafe CUDA call."""

    def __init__(self, exporter, paths=SCRAPE_PATHS, pause: float = 0.25):
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
                except Exception as e:       # counted and reported
                    ok = False
                    self.first_error = self.first_error or repr(e)
                self.scrapes += ok
                self.errors += not ok
            self._stop.wait(self.pause)

    def stats(self):
        return dict(scrapes=self.scrapes, errors=self.errors,
                    first_error=self.first_error)

    def __enter__(self) -> "Scraper":
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise SystemExit("the scraper thread did not stop")
        return False


def obs_legs(ob, w, quality, sorted_costs, q, budgets, step, off, on,
             routed):
    """One step of the gate: the same batch routed with the plane off and
    fully on (a span around the route, a decision record a request, host
    arrays whose conversion the event log defers, the monitor's O(1)
    capture), the order alternating by step; the host wall of each leg
    (us) appended to `off` and `on`. Returns the requests routed on the
    enabled leg."""
    nb = len(budgets)
    for leg in (("off", "on") if step % 2 == 0 else ("on", "off")):
        if leg == "off":
            ob.disable()
            t0 = time.perf_counter()
            w.dispatch.route(w.dbuf.front, q, budgets)
            off.append((time.perf_counter() - t0) * 1e6)
            continue
        ob.enable()
        t0 = time.perf_counter()
        with ob.span("bench.route_step"):
            choices = w.dispatch.route(w.dbuf.front, q, budgets)
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
    """The gate's estimator: the median of the paired per-step
    differences over the off-path p50."""
    p50_off = float(np.percentile(off, 50))
    delta = float(np.median(np.asarray(on) - np.asarray(off)))
    return dict(p50_off_us=p50_off, p50_on_us=float(np.percentile(on, 50)),
                paired_delta_us=delta, overhead_frac=delta / p50_off)


def obs_gate(w, ob, quality, exporter, *, n_steps: int, out_dir: Path,
             smoke: bool = False, max_overhead: float = 0.05,
             pause: float = 0.25):
    """The gate's loop over the world `w` (its router, dispatcher and
    double buffer sharing the enabled scope `ob`), with `quality`
    monitoring and a thread scraping `exporter` throughout: the world's
    warmup, three warm routes with the plane off and on, then `n_steps`
    paired steps with a feedback
    commit every `w.commit_every` (the post-fold ratings to the monitor);
    then the Chrome trace, the Prometheus text and the decision JSONL
    written under `out_dir` and parsed. Returns the JAX gate's payload
    (captures after warmup under its `post_warmup_xla_compiles`) and
    the scraper, whose thread has stopped; asserts nothing."""
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = out_dir / "obs_trace.json"
    decisions_path = out_dir / "obs_decisions.jsonl"
    sorted_costs = np.sort(w.costs)
    with Scraper(exporter, SCRAPE_PATHS, pause) as scraper:
        w.warmup()
        for _ in range(3):          # both legs' Python caches
            q, budgets = w.next_batch()
            ob.disable()
            w.dispatch.route(w.dbuf.front, q, budgets)
            ob.enable()
            w.dispatch.route(w.dbuf.front, q, budgets)
        off_us, on_us, routed = [], [], 0
        ob.events.clear()     # count exactly the loop's decision records
        with CaptureCounter(w.dispatch) as cc:
            for step in range(n_steps):
                routed += obs_legs(ob, w, quality, sorted_costs,
                                   *w.next_batch(), step, off_us, on_us,
                                   routed)
                if (step + 1) % w.commit_every == 0:
                    w.feedback_cycle()
                    # router.update bypasses the feedback() hook: the
                    # post-fold ratings go to the monitor here
                    quality.observe_ratings(
                        w.router.global_ratings.cpu().numpy())
    ob.enable()
    est = overhead(off_us, on_us)
    n_events = validate_chrome_trace(
        Path(ob.tracer.save_chrome_trace(trace_path)))
    prom = ob.registry.prometheus_text()
    n_samples = validate_prometheus(prom)
    (out_dir / "obs_metrics.prom").write_text(prom)
    n_decisions = ob.events.dump(decisions_path)
    n_route = len(ob.events.records("route"))
    for line in decisions_path.read_text().splitlines():
        json.loads(line)
    payload = {
        "smoke": smoke,
        "steps": n_steps,
        "p50_off_us": est["p50_off_us"],
        "p50_on_us": est["p50_on_us"],
        "paired_delta_us": est["paired_delta_us"],
        "overhead_frac": est["overhead_frac"],
        "max_overhead_frac": max_overhead,
        "post_warmup_xla_compiles": cc.delta(),
        "trace_events": n_events,
        "prometheus_samples": n_samples,
        "decision_records": n_route,
        "dumped_records": n_decisions,
        "spans_recorded": ob.tracer.recorded,
        "spans_dropped": ob.tracer.dropped,
        "exporter": {"scrapes": scraper.scrapes,
                     "scrape_errors": scraper.errors,
                     "regret_scored": int(ob.registry.value(
                         "quality_decisions_total", 0)),
                     "quality_alerts": quality.alerts_fired},
    }
    if n_route != routed or ob.events.emitted < routed:
        raise SystemExit(f"decision log incomplete: {n_route} route "
                         f"records for {routed} routed requests")
    return payload, scraper


def obs_gate_errors(payload, timing: bool = True):
    """The gate's failures: captures after warmup, the overhead over its
    bar (where `timing`: the bar needs a steady clock, the card's), no
    scrape or a scrape error."""
    errs = []
    if payload["post_warmup_xla_compiles"]:
        errs.append(f"{payload['post_warmup_xla_compiles']} graph "
                    "capture(s) after warmup with telemetry active "
                    "(expected 0)")
    if timing and payload["overhead_frac"] > payload["max_overhead_frac"]:
        errs.append(f"telemetry overhead "
                    f"{payload['overhead_frac'] * 100:.2f}% exceeds the "
                    f"{payload['max_overhead_frac'] * 100:.0f}% p50 budget "
                    f"(off={payload['p50_off_us']:.0f}us "
                    f"on={payload['p50_on_us']:.0f}us)")
    ex = payload["exporter"]
    if ex["scrapes"] == 0 or ex["scrape_errors"]:
        errs.append(f"exporter scraping failed ({ex['scrapes']} ok, "
                    f"{ex['scrape_errors']} errors)")
    return errs


def run_obs_gate(verbose: bool = True, smoke: bool = False,
                 assert_obs: bool = False, trace_path: str | None = None,
                 max_overhead: float = 0.05, device: DeviceLike = None):
    """The telemetry overhead and artifact gate over the ragged loop, the
    full operational plane live: a router-quality monitor scoring every
    enabled-leg batch, an SLO engine, and an exporter on an ephemeral
    port scraped by a thread throughout."""
    from repro_torch.obs.exporter import ObsExporter
    from repro_torch.obs.quality import RouterQualityMonitor
    from repro_torch.obs.slo import SLOEngine, default_serving_rules

    n_steps = 150 if smoke else 500
    out_dir = C.RESULTS
    ob = OBS.Observability(enabled=True, trace_capacity=8 * n_steps + 64,
                           event_capacity=1 << 20)
    w = RaggedWorld.build(smoke, n_steps, obs=ob, device=device)
    quality = RouterQualityMonitor.for_router(w.router, obs=ob)
    slo = SLOEngine(ob.registry, default_serving_rules(), obs=ob)
    exporter = ObsExporter(ob, slo=slo, quality=quality).start()
    try:
        payload, _ = obs_gate(w, ob, quality, exporter, n_steps=n_steps,
                              out_dir=out_dir, smoke=smoke,
                              max_overhead=max_overhead)
    finally:
        exporter.stop()
    if trace_path:
        ob.tracer.save_chrome_trace(trace_path)
    C.save_json("obs_gate.json", payload)
    if verbose:
        print(f"[obs_gate] steps={n_steps} "
              f"p50_off={payload['p50_off_us']:.0f}us "
              f"p50_on={payload['p50_on_us']:.0f}us "
              f"paired_delta={payload['paired_delta_us']:+.1f}us "
              f"overhead={payload['overhead_frac'] * 100:+.1f}% "
              f"captures={payload['post_warmup_xla_compiles']} "
              f"trace_events={payload['trace_events']} "
              f"prom_samples={payload['prometheus_samples']} "
              f"decisions={payload['decision_records']} "
              f"scrapes={payload['exporter']['scrapes']}")
    if assert_obs:
        errs = obs_gate_errors(payload)
        if errs:
            raise SystemExit("obs gate: " + "; ".join(errs))
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus + few repeats (CI smoke)")
    ap.add_argument("--ragged", action="store_true",
                    help="steady-state ragged-traffic scenario")
    ap.add_argument("--assert-steady-state", action="store_true",
                    help="with --ragged: fail if any post-warmup step "
                         "captured a graph")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record spans and write a Chrome-trace/"
                         "Perfetto JSON (implies telemetry on)")
    ap.add_argument("--obs", action="store_true",
                    help="run the telemetry overhead scenario "
                         "(report only)")
    ap.add_argument("--assert-obs", action="store_true",
                    help="telemetry gate: <5%% p50 overhead, valid "
                         "trace/Prometheus/JSONL artifacts, zero "
                         "post-warmup captures")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the ragged loop over an N-shard DB mesh "
                         "(on one card, its shards repeat the card)")
    ap.add_argument("--assert-sharded", action="store_true",
                    help="with --mesh: fail on any post-warmup capture "
                         "or any divergence from the unsharded route")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mesh:
        run_sharded(smoke=args.smoke, mesh_n=args.mesh,
                    assert_sharded=args.assert_sharded, device=dev)
    elif args.obs or args.assert_obs:
        run_obs_gate(smoke=args.smoke, assert_obs=args.assert_obs,
                     trace_path=args.trace, device=dev)
    elif args.ragged:
        run_ragged(smoke=args.smoke,
                   assert_steady_state=args.assert_steady_state,
                   trace_path=args.trace, device=dev)
    else:
        run(smoke=args.smoke, device=dev)


if __name__ == "__main__":
    main()
