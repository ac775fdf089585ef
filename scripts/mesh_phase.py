#!/usr/bin/env python3
"""Run `chip_smoke.py`'s mesh phase (`drive_mesh`) alone on one CUDA card:
olmo-1b's train step on a (1, 1) mesh against no mesh, the expert-parallel
MoE as two gloo ranks on the card against the unsharded call, and the
dry-run on the fake backend for `chip_smoke.MESH_DRYRUN`.

    python3 scripts/mesh_phase.py

Run from the root of a checkout. Prints the torch and CUDA versions, the
card's name and power limit and the phase's lines; writes its numbers to
chiprun_out/mesh_phase.json; exits non-zero if a check fails (the
phase's own bars).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    C.log(f"torch {torch.__version__} CUDA {torch.version.cuda}")
    stats = {"card": C.card_line()}
    C.log(stats["card"])
    C.drive_mesh(torch.device("cuda"), stats)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_phase.json").write_text(json.dumps(stats, indent=1,
                                                    default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
