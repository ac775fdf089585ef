"""Fig. 4's module on the port (`benchmarks_torch/fig4_ablation.py`)
returns and saves the same JSON keys as the JAX package's
(`benchmarks/fig4_ablation.py`), on the CPU, one seed, at the shrunk
regime of `test_torch_paper_bench_modules.check_run_keys`."""
from test_torch_paper_bench_modules import check_run_keys


def test_fig4_run_has_the_jax_json_keys(monkeypatch, tmp_path):
    check_run_keys(monkeypatch, tmp_path, "fig4_ablation")
