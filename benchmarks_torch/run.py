"""The paper's experiments on the port, one module per table or figure:

  PYTHONPATH=src python -m benchmarks_torch.run [--quick] [--device cpu]

Runs Fig. 2, Table 3a, Fig. 3b and Fig. 4 (`--quick`: seed 0 only; by
default the five seeds of the frozen regime), the route benchmark, the
admission queue benchmark (`--quick`: their smoke sizes) and the kernel
microbenchmarks on the card, prints the card's name and power limit,
and at the end the same ``name,us_per_call,derived`` CSV rows as
`benchmarks/run.py` prints for these seven (its roofline section waits
for the dry-run's port); detailed JSON lands in results/torch/.
"""
from __future__ import annotations

import argparse
import subprocess
import time


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="single seed (CI-speed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()

    import torch
    from benchmarks_torch import common as C
    from repro_torch import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products
        print(f"card: {card_line()}; torch {torch.__version__} CUDA "
              f"{torch.version.cuda}", flush=True)
    seeds = (0,) if args.quick else C.SEEDS

    rows = []  # (name, us_per_call, derived)

    def section(title):
        print(f"\n===== {title} =====", flush=True)

    section("Fig 2 — cost-quality AUC, Eagle vs KNN/MLP/SVM")
    from benchmarks_torch import fig2_auc
    t0 = time.perf_counter()
    f2 = fig2_auc.run(seeds=seeds, device=dev)
    us = (time.perf_counter() - t0) * 1e6
    imp = f2["regimes"]["online"]["improvement_vs"]
    rows.append(("fig2_auc_online", us,
                 f"eagle_vs_knn=+{imp['knn']:.2f}%"
                 f"|mlp=+{imp['mlp']:.2f}%|svm=+{imp['svm']:.2f}%"))

    section("Table 3a — init/incremental update timing")
    from benchmarks_torch import table3a_timing
    t0 = time.perf_counter()
    t3 = table3a_timing.run(seeds=seeds, device=dev)
    us = (time.perf_counter() - t0) * 1e6
    r = t3["eagle_pct_of_baseline_mean"]
    rows.append(("table3a_timing", us,
                 f"eagle_pct_of_baselines:70%={r['70%']:.2f}"
                 f"|85%={r['85%']:.2f}|100%={r['100%']:.2f}"))

    section("Fig 3b — online adaptation quality")
    from benchmarks_torch import fig3b_incremental
    t0 = time.perf_counter()
    f3 = fig3b_incremental.run(seeds=seeds, device=dev)
    us = (time.perf_counter() - t0) * 1e6
    i3 = f3["eagle_improvement_vs_baseline_mean_pct"]
    rows.append(("fig3b_incremental", us,
                 f"eagle_vs_mean:+{i3['70%']:.2f}%/+{i3['85%']:.2f}%"
                 f"/+{i3['100%']:.2f}%"))

    section("Fig 4 — ablations (components, N sweep)")
    from benchmarks_torch import fig4_ablation
    t0 = time.perf_counter()
    f4 = fig4_ablation.run(seeds=seeds, device=dev)
    us = (time.perf_counter() - t0) * 1e6
    c = f4["components"]
    rows.append(("fig4_ablation", us,
                 f"eagle={c['eagle']['mean']:.3f}"
                 f"|global={c['global_only']['mean']:.3f}"
                 f"|local={c['local_only']['mean']:.3f}"))

    section("Batch routing latency — fused route_batch vs legacy path")
    from benchmarks_torch import route_batch_bench
    for n, us, d in route_batch_bench.run(smoke=args.quick, device=dev):
        rows.append((n, us, d))

    section("Admission queue — coalescing, backpressure, goodput")
    from benchmarks_torch import queue_bench
    for n, us, d in queue_bench.run(smoke=args.quick, device=dev):
        rows.append((n, us, d))

    section("Kernel microbenchmarks")
    from benchmarks_torch import kernels_bench
    for n, us, d in kernels_bench.run(device=dev):
        rows.append((n, us, d))

    print("\nname,us_per_call,derived")
    for n, us, d in rows:
        print(f"{n},{us:.1f},{d}")


if __name__ == "__main__":
    main()
