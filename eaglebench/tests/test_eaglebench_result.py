"""The result line: the contract's five keys first, the compared numbers
last; no result without a card; the import check by whole names."""
import io
import json
import subprocess
import sys
import types
from contextlib import redirect_stdout

import pytest
import torch

from eaglebench import run, spec

ROOT = spec.ROOT


class _Slice:
    window_s = 2.0

    def busy_s(self):
        return 1.5

    def breakdown(self):
        return {"device_ops": [["k", 1.5]], "idle_gaps": [["eb.wait", 0.5]]}


def _record(*_, **__):
    ctx = types.SimpleNamespace(
        spans={"dispatch.route": [0.001]}, telemetry={
            "calls": 1, "rows": 3, "padded_rows": 4},
        update_s=[0.002], commit_s=[0.001], fb_apply=[0.004], trace=None,
        slice_routes=[],
        routes=[(3, 4, 0)], route_s=[0.001], dim=8, n=2, records=8,
        rows_fit=10, rows_per_batch=1, warm=0)
    return {"attempted": 3, "failed": 0, "ctx": ctx, "slice": _Slice(),
            "end_to_end": {"route_p95_ms": 2.0, "setup_s": 4.0},
            "checks": {"choice_gap": (0.0, 0.5)}, "memory_peak_bytes": 5,
            "samples": {}, "captures_in_window": 0}


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(monkeypatch, tmp_path, trace):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "stub")
    monkeypatch.setattr(spec, "driver",
                        lambda kind: types.SimpleNamespace(run=_record))
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "devices_used", lambda torch: 1)
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", "paper-route-open", "--seed",
                         str(2 ** 31 + 5), "--seconds", "1", "--trace",
                         str(trace)]) == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(last)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"} | ({"breakdown"} if trace
                                                 else set())
    assert last["correct"] is True
    assert last["checks"]["choice_gap"] == {"value": 0.0, "limit": 0.5}
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == 1
    names = set(last["metrics"])
    if trace:
        assert {"route_call_ms", "pad_waste", "feedback_apply_ms"} <= names
        assert "route_p95_ms" not in names
        assert last["device"]["busy_s"] == 1.5
    else:
        assert names == {"route_p95_ms", "setup_s"}


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "eaglebench/run.py", "--workload",
                        "paper-route-open", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert p.returncode != 0 and "{" not in p.stdout


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert run.forbidden_modules() == ["repro"]

