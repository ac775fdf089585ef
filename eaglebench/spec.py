"""Finding the benchmark's pieces by name.

BENCHMARK.json at the checkout's root lists the configurations, cells
and metrics; each piece lives in a file of its own, found here by its
name, so a later change adds files and edits none:

  eaglebench/configs/<config>.json         one configuration
  eaglebench/workloads/<cell>.json         one cell: its configuration,
                                           traffic mix, driver and limits
  eaglebench/traffic/mixes/<traffic>.json  one traffic mix's parameters
  eaglebench/drivers/<driver>.py           one load driver: run(...)
  eaglebench/metrics/<metric>.py           one per-layer metric: read(ctx)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "eaglebench"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict:
    return _json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> Dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> Dict:
    return _json(HERE / "traffic" / "mixes" / f"{name}.json")


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"eaglebench.drivers.{kind}")


def metric(name: str) -> ModuleType:
    """The reader of a per-layer metric (its file name is the metric's
    name, which may hold a dot)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"eaglebench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict, kind: str, cell_name: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries a cell reports: those that
    name it under `workloads`, and those without that key."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
