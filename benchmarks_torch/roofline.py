"""Roofline analysis over the port's dry-run sweep (launch/dryrun.py), the
counterpart of the JAX package's `benchmarks/roofline.py`.

Reads results/dryrun_torch/<arch>__<shape>__<mesh>.json and derives, per
combo and per H100 (one card, or a device of the JAX meshes single /
multi, which the dry-run runs on the fake backend):

  compute_s    = FLOPs / PEAK_FLOPS               (989 TFLOP/s dense bf16)
  memory_s     = HBM bytes / HBM_BW               (3.35 TB/s)
  collective_s = collective bytes / LINK_BW       (450 GB/s NVLink)

with the FLOPs and bytes from the analytic model
(`repro_torch.analysis.roofline_model`), as the JAX report takes them,
and the dry-run's own counts kept as the cross-check column
(counted_flops_coverage: the meta device's count over the analytic one;
its plain attend computes full S x S panels under a mask). The
collective bytes are the record's per-device total: the port's
program's collectives (DTensor's and the expert-parallel MoE's), not
XLA's; one card has none. `dominant` is taken over the three terms.
Also: MODEL_FLOPS / FLOPs (the useful fraction), and whether the step's
peak bytes (arguments + temp + outputs - aliases, the dry-run's memory
record) fit the card's memory.

    PYTHONPATH=src python -m benchmarks_torch.roofline [--dir DIR] \
        [--mesh card|single|multi]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

#: the H100 SXM's dense bf16 tensor-core peak and HBM3 rate (PERF.md)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: NVLink 4 on the H100 SXM: 900 GB/s a GPU both ways together (18 links
#: of 50 GB/s), 450 GB/s each way. NVIDIA's datasheet figure, not a
#: measurement: one card has no link to measure
LINK_BW = 450e9
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
    "collective": ("reshard to cut cross-chip bytes: move the dominant "
                   "all-gather/all-reduce onto a smaller axis, overlap with "
                   "compute, or switch to reduce-scatter + local update"),
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
    coll = rec["collectives"].get("total_bytes", 0)   # per device
    compute_s = flops_g / (n_dev * PEAK_FLOPS)
    memory_s = hbm_g / (n_dev * HBM_BW)
    collective_s = coll / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
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
        "collective_s": collective_s, "dominant": dominant,
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
        out: Optional[Path] = None, hbm_bytes: float = HBM_BYTES,
        mesh: str = "card") -> List[Dict]:
    """analyze() over a sweep, `mesh`'s rows first; written to `out`
    (default: roofline_torch.json beside the sweep's directory) and, with
    `verbose`, `mesh`'s rows printed as a table."""
    rows = [a for a in (analyze(r, hbm_bytes) for r in load_records(dryrun))
            if a]
    rows = [r for r in rows if r["mesh"] == mesh] + \
        [r for r in rows if r["mesh"] != mesh]
    out = Path(out) if out else Path(dryrun).parent / "roofline_torch.json"
    out.write_text(json.dumps(rows, indent=1))
    if verbose:
        print(f"{'arch':24s} {'shape':12s} {'mesh':6s} "
              f"{'compute':>9s} {'memory':>9s} {'collect':>9s} "
              f"{'dom':>9s} {'useful':>7s} {'counted':>7s} {'GiB/dev':>8s} "
              f"fits")
        for r in rows:
            if r["mesh"] != mesh:
                continue
            print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
                  f"{r['compute_s']*1e3:8.2f}m {r['memory_s']*1e3:8.2f}m "
                  f"{r['collective_s']*1e3:8.2f}m {r['dominant']:>9s} "
                  f"{r['useful_flops_fraction']:7.3f} "
                  f"{r['counted_flops_coverage']:7.3f} "
                  f"{r['per_device_gib']:8.2f} "
                  f"{'y' if r['fits_hbm'] else 'N'}")
    return rows


def pick_hillclimb(rows: List[Dict], mesh: str = "card") -> Dict[str, Dict]:
    """The JAX report's three targets among `mesh`'s rows: worst
    useful-fraction (train), most collective-bound, most
    serving-representative (the decode with the longest bound). One card
    has no collectives, so there the second is left out."""
    sel = [r for r in rows if r["mesh"] == mesh]
    worst = min((r for r in sel if r["kind"] == "train"),
                key=lambda r: r["useful_flops_fraction"])
    picks = {"worst_useful": worst}
    if mesh != "card":
        picks["most_collective"] = max(sel, key=lambda r: r["collective_s"])
    picks["serving_representative"] = max(
        (r for r in sel if r["kind"] == "decode"),
        key=lambda r: r["bound_step_s"])
    return picks


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DRYRUN),
                    help="the dry-run's output directory")
    ap.add_argument("--mesh", default="card",
                    choices=("card", "single", "multi"),
                    help="the mesh whose rows the table and picks take")
    args = ap.parse_args(argv)
    rows = run(dryrun=Path(args.dir), mesh=args.mesh)
    picks = pick_hillclimb(rows, args.mesh)
    print("\nhillclimb picks:")
    for k, v in picks.items():
        print(f"  {k}: {v['arch']} x {v['shape']} (dominant {v['dominant']})")
    return rows


if __name__ == "__main__":
    main()
