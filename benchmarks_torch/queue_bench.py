"""Open-loop admission benchmark on the port: end-to-end latency (queue
wait + route + generate), bucket occupancy and goodput against offered
load through the admission frontend, and the router-quality gate. The
counterpart of `benchmarks/queue_bench.py`:

  PYTHONPATH=src python -m benchmarks_torch.queue_bench [--smoke]
  PYTHONPATH=src python -m benchmarks_torch.queue_bench --smoke \\
      --assert-queue
  PYTHONPATH=src python -m benchmarks_torch.queue_bench --smoke \\
      --assert-quality

On the card unless `--device cpu` is given. The harness is the port's
discrete-event driver (`repro_torch.serving.traffic`): seeded Poisson,
Gamma-burst and replayed arrivals on a virtual clock, the
`AdmissionQueue` coalescing them into dispatch-bucket windows, and a
`SimServer` running the real route (the dispatcher's graphs) with
generation modelled as a cost-proportional service time. Rejects, sheds,
flushes and every latency on the virtual clock follow from the choices
alone, so they equal the JAX module's wherever the choices do. Where the
JAX module counts XLA compiles after warmup, the port counts CUDA graph
captures (under the JAX key `post_warmup_xla_compiles`).

Scenarios: the goodput sweep (Poisson at loads 0.4, 0.8, 1.2), a Gamma
burst (cv = 3) at 0.8, the steady trace replayed, the steady gate (0.6:
`--assert-queue` wants no capture, no reject and no shed, p99 queue wait
under the deadline, mean occupancy >= 60%) and the overload gate (2x for
500 windows: the queue depth stationary, no reject). The quality gate
(`--assert-quality`): 500 routed windows with the regret bit-equal to
its oracle, no drift alert on a stationary run, one at least after a
+400 step on one model. Results go to results/torch/, never to the JAX
package's BENCH_queue.json or BENCH_route.json.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks_torch import common as C
from benchmarks_torch.route_batch_bench import CaptureCounter
from repro_torch import DeviceLike, resolve_device
from repro_torch import obs as OBS
from repro_torch.core.dispatch import MIN_BUCKET, RouteDispatcher
from repro_torch.serving import traffic as TR
from repro_torch.serving.admission import AdmissionConfig, AdmissionQueue
from repro_torch.serving.engine import Request

WINDOW = 32            # coalescing window == dispatch bucket target
MAX_WAIT_MS = 5.0      # coalescing deadline slack
DEADLINE_MS = 50.0     # per-request end-to-end deadline
WATERMARK = 4 * WINDOW
REJECT_CAP = 16 * WINDOW
OVERLOAD_STEPS = 500   # full windows in the overload run (acceptance)


def _build_world(smoke: bool, obs=None, device: DeviceLike = None):
    dev = resolve_device(device)
    n_per = 60 if smoke else C.N_PER_DATASET
    corpus, fb = C.build(0, dev, n_per_dataset=n_per)
    router, _ = C.fit_eagle(corpus, fb, device=dev)
    dispatch = RouteDispatcher.for_router(router, max_bucket=WINDOW,
                                          obs=obs)
    server = TR.SimServer(dispatch, router.state, router.model_names,
                          corpus.costs, base_us=500.0, per_cost_us=12.0)
    return corpus, router, dispatch, server


def _requests(corpus, n: int, seed: int,
              deadline_ms: float = DEADLINE_MS,
              hi_prio_frac: float = 0.1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(corpus.embeddings), n)
    budgets = rng.uniform(float(corpus.costs.min()),
                          float(corpus.costs.max()), n)
    prios = (rng.random(n) < hi_prio_frac).astype(np.int64)
    empty = np.empty(0, np.int32)
    return [Request(tokens=empty, embedding=corpus.embeddings[i],
                    budget=float(b), rid=k, deadline_ms=deadline_ms,
                    priority=int(p))
            for k, (i, b, p) in enumerate(zip(idx, budgets, prios))]


def calibrate_capacity_hz(server, corpus, seed: int = 123) -> float:
    """Requests/sec at which full coalescing windows exactly saturate
    the service model: one real routed window, priced by the model."""
    reqs = _requests(corpus, WINDOW, seed)
    embs = np.stack([r.embedding for r in reqs])
    budgets = np.asarray([r.budget for r in reqs], np.float32)
    choices = server.dispatch.route(server.state, embs, budgets)
    return WINDOW / server.batch_service_s(choices)


def _depth_stationarity(depth_series):
    """(max_depth, mid_mean, tail_mean) over the flush-sampled depth
    series, thirds by index — a growing queue shows tail >> mid."""
    d = np.asarray([x[1] for x in depth_series], np.float64)
    if d.size < 9:
        return (float(d.max(initial=0.0)), 0.0, 0.0)
    third = d.size // 3
    return (float(d.max()), float(d[third:2 * third].mean()),
            float(d[2 * third:].mean()))


def run_scenario(server, dispatch, corpus, *, name: str, kind: str,
                 load: float, capacity_hz: float, n_arrivals: int,
                 seed: int = 7, arrivals=None):
    """One open-loop run; returns the scenario's summary payload."""
    ob = OBS.Observability(enabled=False)   # fresh counters per scenario
    cfg = AdmissionConfig(window_bucket=WINDOW, max_wait_ms=MAX_WAIT_MS,
                          shed_watermark=WATERMARK, reject_cap=REJECT_CAP,
                          min_bucket=dispatch.min_bucket,
                          max_bucket=dispatch.max_bucket)
    queue = AdmissionQueue(server.serve, cfg, obs=ob)
    reqs = _requests(corpus, n_arrivals, seed)
    rate_hz = load * capacity_hz
    if arrivals is None:
        arrivals = TR.make_arrivals(kind, rate_hz, n_arrivals, seed=seed)
    tel0 = dispatch.telemetry()
    t_wall = time.perf_counter()
    with CaptureCounter(dispatch) as cc:
        res = TR.OpenLoopDriver(queue, reqs, arrivals).run()
    wall_s = time.perf_counter() - t_wall
    tel1 = dispatch.telemetry()
    rows = tel1["rows"] - tel0["rows"]
    padded = tel1["padded_rows"] - tel0["padded_rows"]
    wait, e2e = res.wait_us(), res.e2e_us()
    summ = queue.summary()
    depth_max, depth_mid, depth_tail = _depth_stationarity(
        res.depth_series)
    prio_wait = {}
    for p in (0, 1):
        w = np.asarray([c.wait_us for c in res.completed
                        if c.priority == p])
        if w.size:
            prio_wait[f"p{p}_wait_p50_us"] = float(np.percentile(w, 50))
    return {
        "name": name, "kind": kind, "load": load,
        "offered_hz": rate_hz, "offered": res.offered,
        "completed": len(res.completed),
        "rejected": len(res.rejections),
        "shed": summ["shed"],
        "flushes": summ["flushes"],
        "wait_p50_us": float(np.percentile(wait, 50)),
        "wait_p99_us": float(np.percentile(wait, 99)),
        "e2e_p50_us": float(np.percentile(e2e, 50)),
        "e2e_p99_us": float(np.percentile(e2e, 99)),
        "goodput_hz": res.goodput_hz(DEADLINE_MS),
        "occupancy_mean": rows / padded if padded else 0.0,
        "depth_max": depth_max,
        "depth_mid_mean": depth_mid,
        "depth_tail_mean": depth_tail,
        # CUDA graph captures during the run (the JAX key: XLA compiles)
        "post_warmup_xla_compiles": cc.delta(),
        "virtual_horizon_s": res.horizon_ns / 1e9,
        "wall_s": wall_s,
        **prio_wait,
    }


def queue_gate_errors(steady, overload):
    """The queue gate's failures over the steady and overload runs."""
    errs = []
    for s in (steady, overload):
        if s["post_warmup_xla_compiles"] != 0:
            errs.append(f"{s['name']}: {s['post_warmup_xla_compiles']} "
                        "graph capture(s) after warmup (expected 0)")
        if s["rejected"] != 0:
            errs.append(f"{s['name']}: {s['rejected']} rejects "
                        "(expected 0)")
    if steady["shed"] != 0:
        errs.append(f"steady: {steady['shed']} sheds below the "
                    "watermark (expected 0)")
    if steady["wait_p99_us"] > DEADLINE_MS * 1e3:
        errs.append(f"steady: p99 queue wait "
                    f"{steady['wait_p99_us'] / 1e3:.2f}ms exceeds the "
                    f"{DEADLINE_MS:.0f}ms deadline")
    if steady["occupancy_mean"] < 0.60:
        errs.append(f"steady: mean bucket occupancy "
                    f"{steady['occupancy_mean']:.2f} < 0.60")
    if overload["depth_tail_mean"] > overload["depth_mid_mean"] * 1.25 + 2.0:
        errs.append(f"overload: queue depth grows monotonically "
                    f"(mid={overload['depth_mid_mean']:.1f} -> "
                    f"tail={overload['depth_tail_mean']:.1f})")
    return errs


def run(verbose: bool = True, smoke: bool = False,
        assert_queue: bool = False, device: DeviceLike = None):
    ob = OBS.Observability(enabled=False)
    corpus, router, dispatch, server = _build_world(smoke, obs=ob,
                                                    device=device)
    t0 = time.perf_counter()
    warm_routes = dispatch.warmup(server.state)   # the whole ladder
    warm_s = time.perf_counter() - t0
    capacity_hz = calibrate_capacity_hz(server, corpus)

    n_steady = (6000 if smoke else 12000)
    scenarios = {}

    def add(s):
        scenarios[s["name"]] = s
        if verbose:
            print(f"[queue_bench] {s['name']:18s} load={s['load']:.1f} "
                  f"offered={s['offered']} completed={s['completed']} "
                  f"shed={s['shed']} rejected={s['rejected']} "
                  f"wait_p99={s['wait_p99_us'] / 1e3:7.2f}ms "
                  f"e2e_p99={s['e2e_p99_us'] / 1e3:7.2f}ms "
                  f"occ={s['occupancy_mean']:.2f} "
                  f"goodput={s['goodput_hz']:.0f}/s "
                  f"captures={s['post_warmup_xla_compiles']}")

    # goodput sweep: sub- to supercritical Poisson
    for load in (0.4, 0.8, 1.2):
        add(run_scenario(server, dispatch, corpus,
                         name=f"poisson_L{load:.1f}", kind="poisson",
                         load=load, capacity_hz=capacity_hz,
                         n_arrivals=2048, seed=11))

    # bursty arrivals at moderate load (the coalescing window's case)
    add(run_scenario(server, dispatch, corpus, name="burst_L0.8",
                     kind="burst", load=0.8, capacity_hz=capacity_hz,
                     n_arrivals=2048, seed=12))

    # the steady gate scenario: fixed subcritical offered load
    steady = run_scenario(server, dispatch, corpus, name="steady_L0.6",
                          kind="poisson", load=0.6,
                          capacity_hz=capacity_hz,
                          n_arrivals=n_steady, seed=13)
    add(steady)

    # replay: the steady trace re-driven through the replay path
    steady_arr = TR.make_arrivals("poisson", 0.6 * capacity_hz,
                                  2048, seed=13)
    add(run_scenario(server, dispatch, corpus, name="replay_steady",
                     kind="replay", load=0.6, capacity_hz=capacity_hz,
                     n_arrivals=2048, seed=13,
                     arrivals=TR.replay_arrivals(steady_arr / 1e9)))

    # the overload gate scenario: 2x capacity for OVERLOAD_STEPS windows
    overload = run_scenario(server, dispatch, corpus, name="overload_L2.0",
                            kind="poisson", load=2.0,
                            capacity_hz=capacity_hz,
                            n_arrivals=OVERLOAD_STEPS * WINDOW, seed=14)
    add(overload)

    payload = {
        "smoke": smoke,
        "window_bucket": WINDOW,
        "max_wait_ms": MAX_WAIT_MS,
        "deadline_ms": DEADLINE_MS,
        "shed_watermark": WATERMARK,
        "reject_cap": REJECT_CAP,
        "capacity_hz": capacity_hz,
        "warmup_s": warm_s,
        "warmup_route_executables": warm_routes,
        # what per-request dispatch would score on the same ladder
        "per_request_occupancy": 1.0 / MIN_BUCKET,
        "scenarios": scenarios,
        "dispatch_telemetry": dispatch.telemetry(),
        "metrics": ob.registry.json_snapshot(),
    }
    C.save_json("queue_bench.json", payload)

    if assert_queue:
        errs = queue_gate_errors(steady, overload)
        if errs:
            raise SystemExit("queue gate violation(s):\n  "
                             + "\n  ".join(errs))
        if verbose:
            print("[queue_bench] gate OK: 0 captures, 0 rejects, "
                  f"p99 wait {steady['wait_p99_us'] / 1e3:.2f}ms <= "
                  f"{DEADLINE_MS:.0f}ms, occupancy "
                  f"{steady['occupancy_mean']:.2f} >= 0.60, overload "
                  f"depth stationary "
                  f"({overload['depth_mid_mean']:.1f} -> "
                  f"{overload['depth_tail_mean']:.1f})")

    rows = [(f"queue_{s['name']}", s["e2e_p50_us"],
             f"p99={s['e2e_p99_us']:.0f}us|occ={s['occupancy_mean']:.2f}"
             f"|goodput={s['goodput_hz']:.0f}/s|shed={s['shed']}"
             f"|rej={s['rejected']}")
            for s in scenarios.values()]
    return rows


# ---------------------------------------------------------------------------
# router-quality gate (--assert-quality, DESIGN.md §11)
# ---------------------------------------------------------------------------

QUALITY_STEPS = 500    # seeded decision steps in the gate run
FOLD_EVERY = 10        # rating folds every K steps (50 folds total)


def quality_gate(route, mon, embs, bud_lo: float, bud_hi: float, *,
                 steps: int = QUALITY_STEPS, window: int = WINDOW,
                 fold_every: int = FOLD_EVERY, seed: int = 31):
    """The gate's loop: `steps` routed windows of 1..`window` queries
    (`route(q, budgets)` -> host choices), each scored by the monitor
    `mon` and by `routing_regret_oracle` (equal bit for bit, float64), a
    stationary fold (the starting ratings plus seeded N(0, 1) jitter)
    every `fold_every`; then one +400 step on model 0. Returns the
    counts (mismatches, requests scored, alerts on the stationary run and
    after the step) and the loop's wall."""
    from repro_torch.obs.quality import routing_regret_oracle
    rng = np.random.default_rng(seed)
    embs = np.asarray(embs, np.float32)
    base = mon.ratings.astype(np.float64).copy()
    n_models = len(mon.model_names)
    t0 = time.perf_counter()
    mismatches = scored = 0
    for step in range(steps):
        bs = int(rng.integers(1, window + 1))
        i = rng.integers(0, len(embs), bs)
        budgets = rng.uniform(bud_lo, bud_hi, bs).astype(np.float32)
        choices = route(embs[i], budgets)
        got = mon.score_batch(budgets, choices)
        want = routing_regret_oracle(mon.ratings, mon.costs, budgets,
                                     choices)
        mismatches += not np.array_equal(got, want)
        scored += bs
        if (step + 1) % fold_every == 0:
            # stationary rating fold: tiny seeded jitter only
            mon.observe_ratings(base + rng.normal(0.0, 1.0, n_models))
    stationary = mon.alerts_fired
    # inject a rating step on one model: the detector must fire
    shifted = base.copy()
    shifted[0] += 400.0
    mon.observe_ratings(shifted + rng.normal(0.0, 1.0, n_models))
    return dict(oracle_mismatches=mismatches, requests_scored=scored,
                alerts_stationary=stationary,
                alerts_after_perturbation=mon.alerts_fired - stationary,
                wall_s=time.perf_counter() - t0)


def quality_gate_errors(got, alert_events: int):
    """The quality gate's failures."""
    errs = []
    if got["oracle_mismatches"]:
        errs.append(f"{got['oracle_mismatches']} step(s) where the "
                    "vectorised regret differed from the oracle (bitwise)")
    if got["alerts_stationary"]:
        errs.append(f"{got['alerts_stationary']} false-positive drift "
                    "alert(s) on the stationary run (expected 0)")
    if got["alerts_after_perturbation"] < 1:
        errs.append("injected +400 rating step fired no drift alert")
    if not alert_events and got["alerts_after_perturbation"]:
        errs.append("alerts fired but no quality_alert event landed in "
                    "the EventLog")
    return errs


def run_quality_gate(verbose: bool = True, smoke: bool = False,
                     assert_quality: bool = False,
                     device: DeviceLike = None):
    """The seeded router-quality gate over the queue benchmark's world:
    QUALITY_STEPS routed windows with the monitor attached, and its three
    contracts (exactness, no false alarm, sensitivity)."""
    from repro_torch.obs.quality import RouterQualityMonitor

    ob = OBS.Observability(enabled=True)
    corpus, router, dispatch, server = _build_world(smoke, obs=ob,
                                                    device=device)
    dispatch.warmup(server.state)
    mon = RouterQualityMonitor.for_router(router, obs=ob)
    got = quality_gate(lambda q, b: dispatch.route(server.state, q, b),
                       mon, corpus.embeddings, float(corpus.costs.min()),
                       float(corpus.costs.max()))
    alert_events = ob.events.records("quality_alert")
    payload = {
        "smoke": smoke,
        "steps": QUALITY_STEPS,
        "requests_scored": got["requests_scored"],
        "oracle_mismatches": got["oracle_mismatches"],
        "folds": QUALITY_STEPS // FOLD_EVERY + 1,
        "alerts_stationary": got["alerts_stationary"],
        "alerts_after_perturbation": got["alerts_after_perturbation"],
        "alert_events": len(alert_events),
        "wall_s": got["wall_s"],
        "quality": mon.snapshot(),
    }
    C.save_json("quality_gate.json", payload)
    if verbose:
        print(f"[quality_gate] steps={QUALITY_STEPS} "
              f"requests={got['requests_scored']} "
              f"oracle_mismatches={got['oracle_mismatches']} "
              f"alerts_stationary={got['alerts_stationary']} "
              f"alerts_perturbed={got['alerts_after_perturbation']} "
              f"wall={got['wall_s']:.1f}s")
    if assert_quality:
        errs = quality_gate_errors(got, len(alert_events))
        if errs:
            raise SystemExit("quality gate violation(s):\n  "
                             + "\n  ".join(errs))
        if verbose:
            print(f"[quality_gate] gate OK: {got['requests_scored']} "
                  f"requests bit-exact vs oracle, 0 stationary alerts, "
                  f"{got['alerts_after_perturbation']} alert(s) on "
                  "perturbation")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI smoke); the overload gate "
                         "keeps its full 500 windows")
    ap.add_argument("--assert-queue", action="store_true",
                    help="gate: 0 post-warmup captures, 0 rejects/sheds "
                         "below the watermark, p99 wait under deadline, "
                         "occupancy >= 60%%, overload depth stationary")
    ap.add_argument("--assert-quality", action="store_true",
                    help="router-quality gate: regret bit-exact vs "
                         "oracle over a seeded 500-step run, zero "
                         "stationary drift alerts, >=1 alert on an "
                         "injected rating step")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.assert_quality:
        run_quality_gate(smoke=args.smoke, assert_quality=True, device=dev)
    else:
        run(smoke=args.smoke, assert_queue=args.assert_queue, device=dev)


if __name__ == "__main__":
    main()
