"""The route benchmark on the port (`benchmarks_torch/route_batch_bench.py`)
against the JAX package's (`benchmarks/route_batch_bench.py`), each part
at `--smoke` on the CPU: the JSON keys equal the JAX module's, and its
deterministic fields too (the fused and legacy choices, the ragged
loop's rows and padding, the obs gate's decision records and regret
counts; captures after warmup 0 where JAX counts 0 compiles). The JAX
module's BENCH_route.json and results are redirected to `tmp_path`.
JAX's `run_sharded` re-execs with forced host devices, so it is not
driven here: the port's sharded choices are held to the port's
unsharded route (`oracle_mismatches`), and its keys to the JAX payload's
(`benchmarks/route_batch_bench.py:360-376`). The obs gate's 5% timing
bar is not asserted: CPU times are not steady.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as JC
from benchmarks import route_batch_bench as JRB
from benchmarks_torch import common as TC
from benchmarks_torch import route_batch_bench as TRB
from repro.core.state import route_batch as j_route_batch
from repro_torch.core.state import route_batch as t_route_batch

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


SHARDED_KEYS = {"mesh", "smoke", "steps", "max_batch", "commit_every",
                "route_p50_us", "route_p90_us", "route_p99_us", "warmup_s",
                "warmup_route_executables", "post_warmup_xla_compiles",
                "oracle_rows_checked", "oracle_mismatches", "dispatch"}


@pytest.fixture
def results(monkeypatch, tmp_path):
    monkeypatch.setattr(JRB, "BENCH_JSON", tmp_path / "BENCH_route.json")
    monkeypatch.setattr(JC, "RESULTS", tmp_path / "jax")
    monkeypatch.setattr(TC, "RESULTS", tmp_path / "torch")
    return tmp_path


def _load(path):
    return json.loads(path.read_text())


def test_run_fused_equals_legacy_and_jax(results):
    """`run` asserts the fused route's choices equal the legacy path's in
    each package; here they also equal JAX's on the same batches, and the
    rows and JSON match the JAX module's."""
    t_rows = TRB.run(verbose=False, smoke=True, device="cpu")
    j_rows = JRB.run(verbose=False, smoke=True)
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows]
    t_doc = _load(results / "torch" / "route_batch_bench.json")
    j_doc = _load(results / "jax" / "route_batch_bench.json")
    assert [sorted(e) for e in t_doc] == [sorted(e) for e in j_doc]

    j_corpus, j_fb = JC.build(0, n_per_dataset=60)
    t_corpus, t_fb = TC.build(0, "cpu", n_per_dataset=60)
    jr, _ = JC.fit_eagle(j_corpus, j_fb)
    tr, _ = TC.fit_eagle(t_corpus, t_fb, device="cpu")
    for batch in (8, 64):
        rng = np.random.default_rng(batch)
        q = j_corpus.embeddings[rng.integers(0, len(j_corpus.embeddings),
                                             batch)]
        budgets = rng.uniform(j_corpus.costs.min(), j_corpus.costs.max(),
                              batch).astype(np.float32)
        want = JRB.legacy_route(jr, q, budgets)
        np.testing.assert_array_equal(TRB.legacy_route(tr, q, budgets), want)
        fused_j = np.asarray(j_route_batch(
            jr.state, jnp.asarray(q), jnp.asarray(budgets), jr.costs,
            **jr._kw()).choices)
        fused_t = t_route_batch(tr.state, torch.tensor(q),
                                torch.tensor(budgets), tr.costs,
                                **tr._kw()).choices.numpy()
        np.testing.assert_array_equal(fused_j, want)
        np.testing.assert_array_equal(fused_t, want)


def test_ragged_steady_state(results):
    """No capture after warmup (JAX: no compile); the keys, the loop's
    shape and its rows, padded rows and dispatches equal JAX's."""
    got = TRB.run_ragged(verbose=False, smoke=True,
                         assert_steady_state=True, device="cpu")
    want = JRB.run_ragged(verbose=False, smoke=True)
    assert set(got) == set(want)
    assert got == _load(results / "torch" / "route_ragged_bench.json")
    assert got["post_warmup_xla_compiles"] == \
        want["post_warmup_xla_compiles"] == 0
    for k in ("scenario", "smoke", "steps", "max_batch", "commit_every"):
        assert got[k] == want[k]
    for k in ("calls", "rows", "padded_rows", "pad_waste_ratio"):
        assert got["telemetry"][k] == want["telemetry"][k]


@pytest.mark.parametrize("mesh_n", [2, 4])
def test_sharded_equals_unsharded(results, mesh_n):
    """Over a mesh of CPU shards: no capture after warmup, every choice
    equal to the unsharded route's, the JAX payload's keys."""
    got = TRB.run_sharded(verbose=False, smoke=True, mesh_n=mesh_n,
                          assert_sharded=True, device="cpu")
    assert set(got) == SHARDED_KEYS
    assert got["mesh"] == mesh_n and got["oracle_rows_checked"] > 0
    assert got["oracle_mismatches"] == 0
    assert got["post_warmup_xla_compiles"] == 0


def test_obs_gate(results):
    """The gate's artifacts parse (a Chrome trace with route spans,
    Prometheus text, one decision record per routed request), nothing
    captured after warmup, scrapes without error; the keys and the
    deterministic counts equal JAX's."""
    got = TRB.run_obs_gate(verbose=False, smoke=True, device="cpu")
    want = JRB.run_obs_gate(verbose=False, smoke=True)
    assert set(got) == set(want)
    assert set(got["exporter"]) == set(want["exporter"])
    assert TRB.obs_gate_errors(got, timing=False) == []
    for k in ("steps", "decision_records", "post_warmup_xla_compiles"):
        assert got[k] == want[k]
    for k in ("regret_scored", "quality_alerts"):
        assert got["exporter"][k] == want["exporter"][k]
    out = results / "torch"
    assert TRB.validate_chrome_trace(out / "obs_trace.json") > 0
    assert TRB.validate_prometheus((out / "obs_metrics.prom").read_text())
    lines = (out / "obs_decisions.jsonl").read_text().splitlines()
    assert len(lines) == got["dumped_records"] >= got["decision_records"]


def test_cli_on_the_cpu(results, capsys):
    """The flags reach their parts (here --ragged --assert-steady-state)."""
    TRB.main(["--smoke", "--ragged", "--assert-steady-state", "--device",
              "cpu"])
    assert "post_warmup_captures=0" in capsys.readouterr().out
