"""Run one cell of the port's benchmark on the card.

    python3 eaglebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`eaglebench/workloads/<cell>.json`) names its configuration,
traffic mix and load driver; BENCHMARK.json at the checkout's root names
the metrics it reports. An untraced run reports the end-to-end metrics
with the program's obs disabled; a traced run enables obs and
torch.profiler over the window's last slice and reports the per-layer
metrics, the device's busy time and a breakdown. The last line of
standard output is the result, one JSON object; the numbers that decided
`correct` come last on standard error and last in that object, each
beside its limit. Traces and raw samples go to results/eaglebench/.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fail(msg: str, code: int = 1):
    print(f"eaglebench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _stamp(what: str):
    print(f"set-up: {what} at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def devices_used(torch) -> int:
    """The cards this process allocated memory on."""
    return sum(torch.cuda.max_memory_allocated(i) > 0
               for i in range(torch.cuda.device_count()))


def prepare(workload: str):
    """Put the program on the path, check the card and read the cell.
    Returns (benchmark, cell, config, mix, device, out_dir)."""
    # the script's own folder is not a package root
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "eaglebench"]
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(f"the program (src/repro_torch) is not in {ROOT}", 2)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from eaglebench import spec
    _stamp("torch imported")

    bench = spec.benchmark()
    cell = dict(spec.cell(workload), name=workload)
    config = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark measures the card and never "
              "falls back to the CPU")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found")
    _stamp("the card checked")
    print(f"card: {card_line()}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _stamp("the card's name and power limit read")
    out_dir = ROOT / "results" / "eaglebench"
    out_dir.mkdir(parents=True, exist_ok=True)
    return bench, cell, config, mix, torch.device("cuda", 0), out_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, mix, device, out_dir = prepare(args.workload)
    import numpy as np
    import torch

    from eaglebench import spec

    traced = bool(args.trace)
    rec = spec.driver(cell["driver"]).run(
        cell, config, mix, seed=args.seed, seconds=args.seconds,
        traced=traced, device=device, t_start=T_START, out_dir=out_dir)

    with open(out_dir / f"{args.workload}-{args.seed}-t{args.trace}"
              ".samples.json", "w") as f:
        json.dump(rec["samples"], f)

    metrics = {}
    if traced:
        for m in spec.metrics_of(bench, "per_layer", args.workload):
            v = spec.metric(m["name"]).read(rec["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in spec.metrics_of(bench, "end_to_end", args.workload):
            v = rec["end_to_end"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for name, m in metrics.items():
        print(f"metric {name} = {m['value']} {m['unit']}", flush=True)
    print(f"captures in the window: {rec['captures_in_window']}",
          flush=True)

    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": devices_used(torch),
                  "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": None, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": device_rec}
    if traced:
        sl = rec["slice"]
        if sl is None:
            _fail("the traced run's profiler recorded no slice")
        device_rec["busy_s"] = sl.busy_s()
        device_rec["window_s"] = sl.window_s
        result["breakdown"] = sl.breakdown()
        print(f"traced slice {sl.window_s} s, device busy {sl.busy_s()} s",
              flush=True)

    bad = forbidden_modules()
    if bad:
        _fail(f"modules loaded that must not be: {', '.join(bad)}", 3)
    checks = rec["checks"]
    result["correct"] = bool(all(np.isfinite(v) and v <= lim
                                 for v, lim in checks.values()))
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
