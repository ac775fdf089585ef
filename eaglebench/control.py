"""Read the numbers that decide a cell's `correct` for the program and
for the controls, seed by seed: each control is the plain reference put
in the program's place at a precision below the configuration's
(eaglebench/reference: "control", one precision below throughout, and
"control_tf32", the similarity alone in TF32). The benchmark's own runs
never run them.

    python3 eaglebench/control.py --workload paper-route-open \
        --seeds 11,12,13 --seconds 10

Each seed is one window of the cell at its own load, with a fresh
set-up. Every control's reading must fail a limit somewhere; the
readings go to results/eaglebench/control-<cell>.json.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from eaglebench.run import prepare  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    _, cell, config, mix, device, out_dir = prepare(args.workload)
    import torch

    from eaglebench import spec
    driver = spec.driver(cell["driver"])
    out = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        rec = driver.run(cell, config, mix, seed=seed, seconds=args.seconds,
                         traced=False, device=device,
                         t_start=time.perf_counter(), out_dir=out_dir,
                         control=True)
        row = {"seed": seed,
               "program": {k: v for k, (v, _) in rec["checks"].items()},
               "program_passes": all(v <= lim for v, lim in
                                     rec["checks"].values())}
        for c, checks in rec["control"].items():
            row[c] = {k: v for k, (v, _) in checks.items()}
            row[f"{c}_fails"] = any(v > lim for v, lim in checks.values())
        out.append(row)
        print(json.dumps(row), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    with open(out_dir / f"control-{args.workload}.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0 if all(v for r in out for k, v in r.items()
                    if k.endswith("_fails")) else 1


if __name__ == "__main__":
    sys.exit(main())
