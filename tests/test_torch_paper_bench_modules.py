"""The port's experiment modules `benchmarks_torch/fig3b_incremental.py`
and `table3a_timing.py` each return and save the same JSON keys as their
JAX counterparts in `benchmarks/`, on the CPU, one seed, at a shrunk
regime: N_PER_DATASET prompts per dataset (the JAX harness binds the
constant as `build`'s default, so there the default is shrunk) and a
budget grid of BUDGETS points in each module's `evaluate_router`.
`check_run_keys` serves `test_torch_paper_bench.py` (Fig. 2) and
`test_torch_paper_bench_ablation.py` (Fig. 4) too: the four modules
are spread over three files so that each stays under a minute.
"""
import importlib
import json

import jax
import pytest

from benchmarks import common as JC
from benchmarks_torch import common as TC
from repro.data import routerbench as JRB
from repro_torch.data import routerbench as TRB

jax.config.update("jax_platform_name", "cpu")

N_SHRUNK = 40
BUDGETS = 3
MODULES = ("fig3b_incremental", "table3a_timing")


def _short_grid(rb):
    def evaluate(route_fn, corpus, **kw):
        return rb.evaluate_router(
            route_fn, corpus, budgets=rb.budget_grid(corpus.costs, BUDGETS),
            **kw)
    return evaluate


def _keys(tree):
    """The nested key structure of a JSON-like result, leaves dropped."""
    if isinstance(tree, dict):
        return {str(k): _keys(v) for k, v in tree.items()}
    return None


def check_run_keys(monkeypatch, tmp_path, module):
    """Run `module` of both harnesses at the shrunk regime; their results
    and saved JSON must have the same keys."""
    monkeypatch.setattr(TC, "N_PER_DATASET", N_SHRUNK)
    monkeypatch.setattr(JC, "N_PER_DATASET", N_SHRUNK)
    monkeypatch.setattr(JC.build, "__defaults__", (N_SHRUNK,))
    monkeypatch.setattr(TC, "RESULTS", tmp_path / "torch")
    monkeypatch.setattr(JC, "RESULTS", tmp_path / "jax")
    jm = importlib.import_module(f"benchmarks.{module}")
    tm = importlib.import_module(f"benchmarks_torch.{module}")
    for owner, rb in ((JC, JRB), (TC, TRB), (jm, JRB), (tm, TRB)):
        if hasattr(owner, "evaluate_router"):
            monkeypatch.setattr(owner, "evaluate_router", _short_grid(rb))
    want = jm.run(seeds=(0,), verbose=False)
    got = tm.run(seeds=(0,), verbose=False, device="cpu")
    assert _keys(got) == _keys(want)
    saved = {d: json.loads((tmp_path / d / f"{module}.json").read_text())
             for d in ("jax", "torch")}
    assert _keys(saved["torch"]) == _keys(saved["jax"])


@pytest.mark.parametrize("module", MODULES)
def test_module_run_has_the_jax_json_keys(monkeypatch, tmp_path, module):
    check_run_keys(monkeypatch, tmp_path, module)
