"""Roofline analysis over the port's dry-run sweep (launch/dryrun.py), the
counterpart of the JAX package's `benchmarks/roofline.py`.

Reads results/dryrun_torch/<arch>__<shape>__card.json and derives, per
combo on one H100:

  compute_s    = FLOPs / PEAK_FLOPS        (989 TFLOP/s dense bf16)
  memory_s     = HBM bytes / HBM_BW        (3.35 TB/s)
  collective_s = 0                         (one card: no links)

with the FLOPs and bytes from the analytic model
(`repro_torch.analysis.roofline_model`), as the JAX report takes them,
and the dry-run's own counts kept as the cross-check column
(counted_flops_coverage: the meta device's count over the analytic one;
its plain attend computes full S x S panels under a mask). `dominant`
is taken over compute and memory. Also: MODEL_FLOPS / FLOPs (the useful
fraction), and whether the step's peak bytes (arguments + temp + outputs
- aliases, the dry-run's memory record) fit the card's memory.

    PYTHONPATH=src python -m benchmarks_torch.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

#: the H100 SXM's dense bf16 tensor-core peak and HBM3 rate (PERF.md)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: `torch.cuda.get_device_properties(0).total_memory` of the H100 80GB
#: HBM3 (700.00 W) it was read on by chip_smoke.py's dry-run phase
HBM_BYTES = 85_017_493_504

DRYRUN = Path(__file__).resolve().parent.parent / "results" / "dryrun_torch"

_SUGGEST = {
    "compute": ("increase per-chip batch or fuse elementwise chains; at "
                "high useful-fraction this is roofline — scale out instead"),
    "memory": ("cut HBM traffic: fuse the loss/logits pipeline, keep bf16 "
               "accumulators where safe, or re-block attention/MoE to raise "
               "arithmetic intensity"),
}


def load_records(dryrun: Path = DRYRUN) -> List[Dict]:
    """Every record of a sweep directory (not the op tables)."""
    return [json.loads(f.read_text())
            for f in sorted(Path(dryrun).glob("*.json"))
            if not f.name.endswith(".trace.json")]


def analyze(rec: Dict, hbm_bytes: float = HBM_BYTES) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    n_dev = rec["n_devices"]
    ana = rec.get("analytic", {})
    flops_g = ana.get("flops_global", rec["flops_per_device"] * n_dev)
    hbm_g = ana.get("hbm_bytes_global", rec["bytes_per_device"] * n_dev)
    compute_s = flops_g / (n_dev * PEAK_FLOPS)
    memory_s = hbm_g / (n_dev * HBM_BW)
    terms = {"compute": compute_s, "memory": memory_s}
    dominant = max(terms, key=terms.get)
    mem = rec["memory"]
    per_dev_bytes = (mem.get("argument_size_in_bytes", 0)
                     + mem.get("temp_size_in_bytes", 0)
                     + mem.get("output_size_in_bytes", 0)
                     - mem.get("alias_size_in_bytes", 0))
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec.get("kind"),
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": 0.0, "dominant": dominant,
        "useful_flops_fraction": rec["model_flops_global"] / max(flops_g,
                                                                 1.0),
        "counted_flops_coverage": rec["flops_per_device"] * n_dev
        / max(flops_g, 1.0),
        "bound_step_s": max(terms.values()),
        "per_device_gib": per_dev_bytes / 2**30,
        "fits_hbm": per_dev_bytes <= hbm_bytes,
        "suggestion": _SUGGEST[dominant],
    }


def run(verbose: bool = True, dryrun: Path = DRYRUN,
        out: Optional[Path] = None,
        hbm_bytes: float = HBM_BYTES) -> List[Dict]:
    """analyze() over a sweep; written to `out` (default:
    roofline_torch.json beside the sweep's directory) and, with
    `verbose`, printed as a table."""
    rows = [a for a in (analyze(r, hbm_bytes) for r in load_records(dryrun))
            if a]
    out = Path(out) if out else Path(dryrun).parent / "roofline_torch.json"
    out.write_text(json.dumps(rows, indent=1))
    if verbose:
        print(f"{'arch':24s} {'shape':12s} {'mesh':6s} "
              f"{'compute':>9s} {'memory':>9s} {'collect':>9s} "
              f"{'dom':>9s} {'useful':>7s} {'counted':>7s} {'GiB/dev':>8s} "
              f"fits")
        for r in rows:
            print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
                  f"{r['compute_s']*1e3:8.2f}m {r['memory_s']*1e3:8.2f}m "
                  f"{r['collective_s']*1e3:8.2f}m {r['dominant']:>9s} "
                  f"{r['useful_flops_fraction']:7.3f} "
                  f"{r['counted_flops_coverage']:7.3f} "
                  f"{r['per_device_gib']:8.2f} "
                  f"{'y' if r['fits_hbm'] else 'N'}")
    return rows


def pick_hillclimb(rows: List[Dict]) -> Dict[str, Dict]:
    """The JAX report's targets that one card has: worst useful-fraction
    (train) and most serving-representative (the decode with the longest
    bound). Its third, the most collective-bound, needs the meshes of
    ROADMAP §2.10: on one card every collective_s is 0."""
    worst = min((r for r in rows if r["kind"] == "train"),
                key=lambda r: r["useful_flops_fraction"])
    serving = max((r for r in rows if r["kind"] == "decode"),
                  key=lambda r: r["bound_step_s"])
    return {"worst_useful": worst, "serving_representative": serving}


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DRYRUN),
                    help="the dry-run's output directory")
    args = ap.parse_args(argv)
    rows = run(dryrun=Path(args.dir))
    picks = pick_hillclimb(rows)
    print("\nhillclimb picks:")
    for k, v in picks.items():
        print(f"  {k}: {v['arch']} x {v['shape']} (dominant {v['dominant']})")
    return rows


if __name__ == "__main__":
    main()
