"""The port's examples (`examples_torch/`) run on the CPU with
`--device cpu`, at a small size, against the JAX package's (`examples/`)
where those run in seconds here: the quickstart's AUC at its own size,
and online adaptation's Eagle and KNN AUCs at each stage (40 prompts a
dataset; the MLP's and SVM's fits are not bit-reproducible across the
frameworks, ROADMAP §4.9, so theirs are only printed). serve_routed runs
its batch, Poisson-admission and live-exporter walk-through paths.
"""
import importlib.util
from pathlib import Path

import jax
import pytest
import torch

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


ROOT = Path(__file__).resolve().parent.parent


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"example_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(monkeypatch, mod, n_per_dataset=None):
    """The example module with its AUCs recorded (evaluate_router wrapped)
    and, with `n_per_dataset`, its corpus shrunk."""
    aucs = []
    evaluate = mod.evaluate_router

    def recording(*a, **kw):
        out = evaluate(*a, **kw)
        aucs.append(out["auc"])
        return out
    monkeypatch.setattr(mod, "evaluate_router", recording)
    if n_per_dataset is not None:
        make = mod.make_corpus
        monkeypatch.setattr(mod, "make_corpus", lambda **kw: make(
            **{**kw, "n_per_dataset": n_per_dataset}))
    return aucs


def test_quickstart_auc_equals_jax(monkeypatch, capsys):
    port = _load(ROOT / "examples_torch" / "quickstart.py")
    ref = _load(ROOT / "examples" / "quickstart.py")
    got = _recorded(monkeypatch, port)
    want = _recorded(monkeypatch, ref)
    port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    ref.main()
    assert got == want and len(got) == 1
    assert "AUC over the budget grid" in out and "online update" in out


def test_online_adaptation_aucs_equal_jax(monkeypatch, capsys):
    port = _load(ROOT / "examples_torch" / "online_adaptation.py")
    ref = _load(ROOT / "examples" / "online_adaptation.py")
    got = _recorded(monkeypatch, port, 40)
    want = _recorded(monkeypatch, ref, 40)
    port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    ref.main()
    assert len(got) == len(want) == 3 * 4       # 3 stages x 4 routers
    for stage in range(3):                      # eagle, knn, mlp, svm
        assert got[4 * stage:4 * stage + 2] == want[4 * stage:4 * stage + 2]
    for line in ("stage 70%", "stage 100%", "eagle fit", "eagle update",
                 "knn retrain", "mlp retrain", "svm retrain"):
        assert line in out


@pytest.mark.parametrize("extra,expect", [
    ([], "per-model load"),
    (["--arrival", "poisson", "--rate", "2000"], "admission [poisson"),
    (["--serve-obs"], "watching the live router"),
])
def test_serve_routed(capsys, extra, expect):
    port = _load(ROOT / "examples_torch" / "serve_routed.py")
    port.main(["--device", "cpu", "--requests", "8", "--fleet", "2",
               "--max-new", "2", *extra])
    out = capsys.readouterr().out
    assert expect in out
    assert "route decisions logged: 8" in out


def test_train_small_descends(capsys):
    """examples_torch/train_small.py: the JAX example's olmo-100m (the
    same config), a few steps on the CPU; the example itself raises if
    the loss does not descend."""
    import dataclasses
    port = _load(ROOT / "examples_torch" / "train_small.py")
    ref = _load(ROOT / "examples" / "train_small.py")
    assert dataclasses.asdict(port.small_100m()) == \
        dataclasses.asdict(ref.small_100m())
    out = port.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                     "--seq", "32"])
    text = capsys.readouterr().out
    assert "olmo-100m:" in text and "% drop)" in text
    assert out["history"][-1][1] < out["history"][0][1]
