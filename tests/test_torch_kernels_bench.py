"""The kernel microbenchmarks on the port (`benchmarks_torch/
kernels_bench.py`) at small shapes on the CPU: the JAX module's five row
names (each one appears in `benchmarks/kernels_bench.py`) and the n = 512
retrieve, one JSON entry a row; on the CPU no device time is claimed, and
each bound is the H100's for the row's bytes and operations."""
import inspect
import json

import pytest

from benchmarks import kernels_bench as JK
from benchmarks_torch import common as TC
from benchmarks_torch import kernels_bench as TK

JAX_ROWS = ["similarity_topk_64x16k", "elo_local_64x160",
            "retrieve_replay_64x16k", "flash_attention_1k",
            "decode_attention_8k"]
SMALL = dict(similarity=(4, 300, 32, 5), elo=(4, 16, 10),
             retrieve_replay=(4, 300, 32, 4, 5), flash=(1, 128, 2, 32),
             decode=(2, 256, 2, 32), similarity_n512=(4, 700, 32, 512))


@pytest.fixture
def results(monkeypatch, tmp_path):
    monkeypatch.setattr(TC, "RESULTS", tmp_path)
    return tmp_path


def test_rows_are_the_jax_modules(results, monkeypatch):
    monkeypatch.setattr(TK, "SHAPES", SMALL)
    rows = TK.run(verbose=False, device="cpu")
    names = [r[0] for r in rows]
    assert names == JAX_ROWS + ["similarity_topk_64x16k_n512"]
    source = inspect.getsource(JK.run)
    for name in JAX_ROWS:
        assert f'"{name}"' in source
    entries = json.loads((results / "kernels_bench.json").read_text())
    assert [e["name"] for e in entries] == names
    for e in entries:
        assert e["device"] == "cpu" and e["us_per_call"] > 0
        assert e["kernel_ms"] is e["plain_ms"] is e["library_ms"] is None
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes", "operations")


def test_bounds_at_the_full_shapes():
    """The bounds of two full-size rows, from their shapes alone: the
    fused retrieve is bound by fp32 operations
    (2 Q C D / 67 TFLOP/s = 0.048 ms), the decode by reading its bf16
    cache (268 MB: 0.080 ms)."""
    q, c, d, n = TK.SHAPES["similarity"]
    ms, by = TK.bound_ms(4.0 * (q * d + c * d) + 12.0 * q * n,
                         2.0 * q * c * d + 2.0 * (q + c) * d)
    assert by == "operations" and ms == pytest.approx(0.0481, abs=1e-3)
    b, t, h, dh = TK.SHAPES["decode"]
    ms, by = TK.bound_ms(2.0 * b * t * h * dh * 2 + 4.0 * b * h * dh,
                         4.0 * b * h * t * dh, TK.PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(0.0801, abs=2e-4)
