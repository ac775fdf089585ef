"""The admission queue benchmark on the port (`benchmarks_torch/
queue_bench.py`) against the JAX package's (`benchmarks/queue_bench.py`),
at `--smoke` on the CPU. Everything on the virtual clock follows from the
choices, so it must equal JAX's: offered, completed, rejected, shed and
flushed requests, waits, end-to-end latencies, goodput, occupancy, the
queue depth, the horizon and the calibrated capacity; and the quality
gate's mismatches, scored requests and alerts. The JAX module's
BENCH_queue.json / BENCH_route.json and results go to `tmp_path`.
"""
import json

import jax
import pytest
import torch

from benchmarks import common as JC
from benchmarks import queue_bench as JQ
from benchmarks import route_batch_bench as JRB
from benchmarks_torch import common as TC
from benchmarks_torch import queue_bench as TQ

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread: its tensors are small, and
    the suite runs several test processes on one CPU, where more threads
    only contend (the wall time alone is the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: wall-clock and host fields: not the virtual clock's
HOST = {"wall_s", "warmup_s", "post_warmup_xla_compiles"}


@pytest.fixture
def results(monkeypatch, tmp_path):
    monkeypatch.setattr(JQ, "BENCH_JSON", tmp_path / "BENCH_queue.json")
    monkeypatch.setattr(JRB, "BENCH_JSON", tmp_path / "BENCH_route.json")
    monkeypatch.setattr(JC, "RESULTS", tmp_path / "jax")
    monkeypatch.setattr(TC, "RESULTS", tmp_path / "torch")
    return tmp_path


def test_queue_scenarios_equal_jax(results):
    t_rows = TQ.run(verbose=False, smoke=True, assert_queue=True,
                    device="cpu")
    j_rows = JQ.run(verbose=False, smoke=True, assert_queue=True)
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows]
    got = json.loads((results / "torch" / "queue_bench.json").read_text())
    want = json.loads((results / "jax" / "queue_bench.json").read_text())
    assert set(got) == set(want)
    assert got["capacity_hz"] == want["capacity_hz"]
    assert set(got["scenarios"]) == set(want["scenarios"])
    for name, s in got["scenarios"].items():
        w = want["scenarios"][name]
        assert set(s) == set(w)
        assert s["post_warmup_xla_compiles"] == 0
        for k in set(s) - HOST:
            assert s[k] == w[k], (name, k)
    for k in ("calls", "rows", "padded_rows"):
        assert got["dispatch_telemetry"][k] == want["dispatch_telemetry"][k]
    assert not (results / "torch" / "BENCH_queue.json").exists()


def test_quality_gate_equals_jax(results):
    got = TQ.run_quality_gate(verbose=False, smoke=True,
                              assert_quality=True, device="cpu")
    want = JQ.run_quality_gate(verbose=False, smoke=True,
                               assert_quality=True)
    assert set(got) == set(want)
    for k in ("steps", "requests_scored", "oracle_mismatches", "folds",
              "alerts_stationary", "alerts_after_perturbation",
              "alert_events"):
        assert got[k] == want[k], k
    assert got["oracle_mismatches"] == 0 and got["alerts_stationary"] == 0
    assert got["alerts_after_perturbation"] >= 1


def test_gates_fail_on_a_violation():
    """The gates' checks report what the JAX gates report."""
    ok = dict(name="steady_L0.6", post_warmup_xla_compiles=0, rejected=0,
              shed=0, wait_p99_us=1.0, occupancy_mean=0.9,
              depth_mid_mean=1.0, depth_tail_mean=1.0)
    assert TQ.queue_gate_errors(ok, dict(ok, name="overload_L2.0")) == []
    bad = dict(ok, post_warmup_xla_compiles=2, shed=1, occupancy_mean=0.5)
    errs = TQ.queue_gate_errors(bad, dict(ok, depth_tail_mean=9.0))
    assert len(errs) == 4
    got = dict(oracle_mismatches=1, alerts_stationary=1,
               alerts_after_perturbation=0)
    assert len(TQ.quality_gate_errors(got, 0)) == 3
