"""The paper's experiments on the port (`benchmarks_torch/`) against the
JAX package's (`benchmarks/`), on the CPU, one seed, at a shrunk regime
(the harness's N_PER_DATASET; the JAX harness binds it as `build`'s
default, so there the default is shrunk).

Equal: Eagle's and Eagle-Global/Local's per-dataset AUCs, and KNN's in
both supervision regimes (the choices are integers held to JAX, so the
AUCs match exactly); and Fig. 2's module returns and saves the JAX
module's JSON keys (`test_torch_paper_bench_modules.py` holds the other
three modules' keys, at a shorter budget grid).
"""
import jax
import numpy as np
import pytest

from benchmarks import common as JC
from benchmarks_torch import common as TC
from repro.core import router as JROUTER
from repro_torch.core import router as TROUTER
from test_torch_paper_bench_modules import check_run_keys

jax.config.update("jax_platform_name", "cpu")

N_SHRUNK = 40
CLASSES = {"eagle": "EagleRouter", "global_only": "GlobalOnlyRouter",
           "local_only": "LocalOnlyRouter"}


@pytest.fixture
def shrunk(monkeypatch, tmp_path):
    monkeypatch.setattr(TC, "N_PER_DATASET", N_SHRUNK)
    monkeypatch.setattr(JC, "N_PER_DATASET", N_SHRUNK)
    monkeypatch.setattr(JC.build, "__defaults__", (N_SHRUNK,))
    monkeypatch.setattr(TC, "RESULTS", tmp_path / "torch")
    monkeypatch.setattr(JC, "RESULTS", tmp_path / "jax")
    j_corpus, j_fb = JC.build(0)
    t_corpus, t_fb = TC.build(0, device="cpu")
    assert len(t_corpus.embeddings) == len(j_corpus.embeddings) \
        == 7 * N_SHRUNK
    for k in j_fb:
        np.testing.assert_array_equal(t_fb[k], j_fb[k])
    return j_corpus, j_fb, t_corpus, t_fb


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_eagle_per_dataset_auc_equal(shrunk, name):
    j_corpus, j_fb, t_corpus, t_fb = shrunk
    jr, _ = JC.fit_eagle(j_corpus, j_fb, cls=getattr(JROUTER, CLASSES[name]))
    tr, _ = TC.fit_eagle(t_corpus, t_fb, cls=getattr(TROUTER, CLASSES[name]),
                         device="cpu")
    assert TC.per_dataset_auc(tr, t_corpus) == \
        JC.per_dataset_auc(jr, j_corpus)


@pytest.mark.parametrize("regime", ["online", "offline"])
def test_knn_per_dataset_auc_equal(shrunk, regime):
    j_corpus, j_fb, t_corpus, t_fb = shrunk
    jr = JC.fit_baselines(j_corpus, j_fb, regime)["knn"][0]
    tr = TC.fit_baselines(t_corpus, t_fb, regime, device="cpu")["knn"][0]
    assert TC.per_dataset_auc(tr, t_corpus) == \
        JC.per_dataset_auc(jr, j_corpus)


def test_fig2_run_has_the_jax_json_keys(monkeypatch, tmp_path):
    check_run_keys(monkeypatch, tmp_path, "fig2_auc")
