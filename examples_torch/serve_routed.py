"""Serve batched requests through the Eagle-routed fleet on the port
(Fig. 1 workflow): route -> batch per model -> prefill + decode ->
optional second-opinion feedback folded back into the router online. The
counterpart of `examples/serve_routed.py`, with its flags, on the card.

  PYTHONPATH=src python examples_torch/serve_routed.py --requests 24
  PYTHONPATH=src python examples_torch/serve_routed.py --arrival poisson \\
      --rate 2000
  PYTHONPATH=src python examples_torch/serve_routed.py --serve-obs
  PYTHONPATH=src python examples_torch/serve_routed.py --device cpu \\
      --requests 8 --fleet 2 --max-new 2
"""
import argparse
import json
import urllib.request

import numpy as np
import torch

from repro_torch.launch.serve import (build_admission, build_engine,
                                      build_obs_plane)
from repro_torch.obs import Observability
from repro_torch.serving import traffic as TR
from repro_torch.serving.engine import Request


def _watch_live_router(exporter):
    """'Watching a live router' walkthrough: scrape the operational
    plane the way a dashboard would — over HTTP — and narrate what each
    endpoint answers. Self-scrapes so the demo runs non-interactively;
    the same URLs work from curl / Prometheus while the process lives."""
    get = lambda p: urllib.request.urlopen(exporter.url(p), timeout=5).read()
    print(f"\n-- watching the live router at http://127.0.0.1:"
          f"{exporter.port} --")
    print("  1. is it up?            curl /healthz")
    print("     ", json.loads(get("/healthz")))
    print("  2. what is it doing?    curl /metrics   (Prometheus 0.0.4)")
    lines = [l for l in get("/metrics").decode().splitlines()
             if l and not l.startswith("#")]
    for l in lines[:6]:
        print("     ", l)
    print(f"      ... {len(lines)} samples total")
    print("  3. who got each query?  curl '/decisions?n=3'")
    for l in get("/decisions?n=3").decode().splitlines():
        print("     ", l)
    print("  4. is the router good?  curl /quality   (ELO, regret, shares)")
    q = json.loads(get("/quality"))
    print(f"      ratings={ {m: round(v, 1) for m, v in q['ratings'].items()} }")
    print(f"      selection_share={ {m: round(v, 2) for m, v in q['selection_share'].items()} }")
    print(f"      regret: n={q['regret']['count']} "
          f"mean={q['regret']['mean']:.2f}  alerts={q['alerts']}")
    print("  5. are we meeting SLOs? curl /slo       (burn-rate status)")
    s = json.loads(get("/slo"))
    for r in s["rules"]:
        print(f"      {r['rule']:16s} {r['status']:8s} "
              f"value={r['value']} bound={r['op']}{r['bound']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--fleet", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", choices=["batch", "poisson", "burst"],
                    default="batch",
                    help="'batch' serves one big batch directly; "
                         "'poisson'/'burst' stream arrivals through the "
                         "admission queue (open-loop, virtual clock)")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered load in requests/s for --arrival modes")
    ap.add_argument("--window", type=int, default=8,
                    help="admission coalescing window (requests)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--trace", type=str, default=None,
                    help="write a Chrome-trace JSON of the serve step here")
    ap.add_argument("--serve-obs", action="store_true",
                    help="start the HTTP observability plane (/metrics "
                         "/trace /decisions /quality /slo /healthz) on an "
                         "ephemeral port and run the 'watching a live "
                         "router' walkthrough after serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ob = Observability(enabled=True)
    engine, corpus = build_engine(args.fleet, seed=args.seed, obs=ob,
                                  device=args.device)
    if engine.router.device.type == "cuda":
        print(f"on {torch.cuda.get_device_name(engine.router.device)}")
    exporter = None
    if args.serve_obs:
        # attach the quality monitor + SLO engine BEFORE serving so the
        # walkthrough's /quality and /decisions reflect this run
        exporter = build_obs_plane(engine)
        print(f"obs plane listening: {exporter.url('/metrics')}")
    rng = np.random.default_rng(args.seed)
    rows = corpus.test_idx[:args.requests]
    budgets = rng.uniform(corpus.costs.min(), corpus.costs.max(),
                          args.requests)
    reqs = [Request(tokens=rng.integers(0, 100, 8).astype(np.int32),
                    embedding=corpus.embeddings[i], budget=float(b),
                    max_new_tokens=args.max_new, rid=k)
            for k, (i, b) in enumerate(zip(rows, budgets))]

    ratings_before = engine.router.global_ratings.cpu().numpy().copy()
    if args.arrival == "batch":
        responses = engine.serve(reqs)
    else:
        queue = build_admission(engine, window_bucket=args.window,
                                max_wait_ms=args.max_wait_ms)
        arrivals = TR.make_arrivals(args.arrival, args.rate,
                                    len(reqs), seed=args.seed)
        result = TR.OpenLoopDriver(queue, reqs, arrivals).run()
        responses = sorted((c.response for c in result.completed),
                           key=lambda r: r.rid)
        waits = result.wait_us()
        summ = queue.summary()
        print(f"admission [{args.arrival} @ {args.rate:.0f}/s]: "
              f"{summ['flushed']} served over {len(queue.flush_log)} "
              f"windows {dict(summ['flushes'])}, "
              f"shed={summ['shed']} rejected={summ['rejected']}")
        print(f"queue wait: p50={np.percentile(waits, 50):.0f}us "
              f"p99={np.percentile(waits, 99):.0f}us  "
              f"window fill: "
              f"{np.mean([f.n / f.bucket for f in queue.flush_log]):.2f}\n")
    ratings_after = engine.router.global_ratings.cpu().numpy()

    print("responses (first 8):")
    for r in responses[:8]:
        print(f"  req {r.rid:3d}  budget {reqs[r.rid].budget:6.2f} -> "
              f"{r.model:26s} tokens {np.asarray(r.tokens).tolist()}")
    print("\nper-model load:", engine.stats["per_model"])
    print(f"feedback collected online: {engine.stats['feedback']}")
    moved = np.abs(ratings_after - ratings_before).max()
    print(f"max global-ELO movement from online feedback: {moved:.2f}")

    # telemetry readout: the serve step above ran fully instrumented
    # (DESIGN.md §9) — latency histograms, per-layer counters, and one
    # decision record per routed request
    snap = engine.metrics_snapshot()
    print("\nmetrics summary:")
    for name, h in sorted(snap["histograms"].items()):
        if h["count"] and name.endswith("_us"):
            print(f"  {name:22s} n={h['count']:4d}  p50={h['p50']:9.1f}us"
                  f"  p99={h['p99']:9.1f}us")
    for name in ("serve_requests_total", "serve_feedback_total",
                 "dispatch_cache_hits_total", "dispatch_cache_misses_total",
                 "dbuf_swaps_total"):
        if name in snap["counters"]:
            print(f"  {name:28s} {snap['counters'][name]}")
    decisions = ob.events.records("route")
    print(f"\nroute decisions logged: {len(decisions)}; first 3:")
    for d in decisions[:3]:
        print(f"  rid={d['rid']:3d} model={d['model']:26s} "
              f"budget={d['budget']:6.2f} feasible={d['feasible']}")
    if args.trace:
        ob.tracer.save_chrome_trace(args.trace)
        print(f"\nchrome trace ({ob.tracer.recorded} spans) -> {args.trace}")
    if exporter is not None:
        try:
            _watch_live_router(exporter)
        finally:
            exporter.stop()


if __name__ == "__main__":
    main()
