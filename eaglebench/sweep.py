"""Find a cell's knee: the highest offered rate its program sustains,
with no growing backlog and its tail within a limit. Runs the cell's
driver once a rate, each with a fresh set-up, untraced, and prints a row
a rate.

    python3 eaglebench/sweep.py --workload paper-route-open \
        --rates 150,200,250,300 --seconds 30 --seed 79

A rate is sustained when the mean latency of the window's last fifth of
requests is under twice that of its first fifth (no growing backlog) and,
with --p95-limit-ms, its 95th percentile meets that limit. The table goes
to results/eaglebench/sweep-<cell>.json.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from eaglebench.run import prepare  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--p95-limit-ms", type=float, default=None,
                    help="a rate is sustained only with its p95 within it")
    args = ap.parse_args()
    _, cell, config, mix, device, out_dir = prepare(args.workload)
    import gc

    import numpy as np
    import torch

    from eaglebench import spec
    driver = spec.driver(cell["driver"])
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        rec = driver.run(dict(cell, rate_hz=rate), config, mix,
                         seed=args.seed, seconds=args.seconds, traced=False,
                         device=device, t_start=time.perf_counter(),
                         out_dir=out_dir)
        lat = np.asarray(next(v for k, v in rec["samples"].items()
                              if k.endswith("latency_s")))
        fifth = max(1, len(lat) // 5)
        first, last_ = lat[:fifth].mean(), lat[-fifth:].mean()
        row = {"rate": rate, "served": int(len(lat)),
               "p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "p95_ms": float(np.percentile(lat, 95)) * 1e3,
               "max_ms": float(lat.max()) * 1e3,
               "first_fifth_ms": float(first) * 1e3,
               "last_fifth_ms": float(last_) * 1e3,
               "sustained": bool(last_ < 2 * first and (
                   args.p95_limit_ms is None
                   or np.percentile(lat, 95) * 1e3 <= args.p95_limit_ms)),
               "means_ms": {k: float(np.mean(v)) * 1e3
                            for k, v in rec["samples"].items() if v},
               "end_to_end": rec["end_to_end"],
               "checks": {k: v for k, (v, _) in rec["checks"].items()},
               "correct": all(v <= lim for v, lim in rec["checks"].values())}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    with open(out_dir / f"sweep-{args.workload}.json", "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
