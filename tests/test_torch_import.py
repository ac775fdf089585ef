"""Import boundary of the PyTorch port: every `repro_torch` module imports
with JAX blocked and loads nothing of the JAX package, and the entry
points default to the card instead of running on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_PROBE = r"""
import pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    __import__(name)
leaked = sorted(m for m, v in sys.modules.items() if v is not None and
                (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(" ", 1)
    assert int(n) >= 30
    assert leaked.strip() == "[]"


def _default_device_entry_points():
    from repro_torch import resolve_device
    from repro_torch.core import elo
    from repro_torch.core.router import EagleRouter
    from repro_torch.core.state import DoubleBuffer, init_state
    from repro_torch.core.vectordb import VectorDB
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import ratings_from_numpy
    from repro_torch.routing.baselines import (KNNRouter, MLPRouter,
                                               SVMRouter)
    from repro_torch.serving import FleetModel, ServingEngine
    from benchmarks_torch import common as bench
    return [
        ("resolve_device", lambda: resolve_device()),
        ("init_state", lambda: init_state(3, 4)),
        ("fit_global", lambda: elo.fit_global(3, [0], [1], [1.0])),
        ("EagleRouter", lambda: EagleRouter(["a", "b"], [1.0, 2.0])),
        ("DoubleBuffer", lambda: DoubleBuffer(VectorDB(4, 8), [1.0, 2.0])),
        ("ratings_from_numpy", lambda: ratings_from_numpy([1.0])),
        ("FleetModel", lambda: FleetModel(get_reduced_config("olmo-1b"))),
        # the engine runs on its router's and its fleet's devices
        ("ServingEngine", lambda: ServingEngine(
            {}, EagleRouter([], np.zeros(0, np.float32)))),
        ("KNNRouter", lambda: KNNRouter([1.0, 2.0])),
        ("MLPRouter", lambda: MLPRouter([1.0, 2.0])),
        ("SVMRouter", lambda: SVMRouter([1.0, 2.0])),
        ("benchmarks_torch.common.build", lambda: bench.build(0)),
    ]


@pytest.mark.parametrize("idx", range(12))
def test_default_device_is_the_card_and_raises_without_one(idx):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    name, call = _default_device_entry_points()[idx]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


_NEW_MODULES = r"""
import sys
sys.modules["jax"] = None
import repro_torch.models.ssm, repro_torch.serving.admission
import repro_torch.serving.traffic, repro_torch.launch.serve
leaked = sorted(m for m, v in sys.modules.items() if v is not None and
                (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
print(leaked)
"""


def test_serving_launcher_modules_import_without_jax():
    """The launcher's modules (the mamba2 block, admission, traffic, the
    launcher itself) import with JAX blocked and load no JAX-package
    module."""
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.launch.serve import build_engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(n_fleet=2)


def test_explicit_cpu_device_runs():
    from repro_torch.core.state import init_state
    st = init_state(3, 4, capacity=8, device="cpu")
    assert st.device.type == "cpu" and st.capacity == 8


_BENCH_MODULES = r"""
import pkgutil, sys
sys.modules["jax"] = None
import benchmarks_torch
import repro_torch.routing.baselines, repro_torch.training.optim
names = [m.name for m in pkgutil.walk_packages(benchmarks_torch.__path__,
                                               "benchmarks_torch.")]
for name in names:
    __import__(name)
leaked = sorted(m for m, v in sys.modules.items() if v is not None and
                (m in ("repro", "jax", "benchmarks") or
                 m.startswith(("repro.", "jax.", "benchmarks."))))
print(sorted(names), leaked)
"""


def test_paper_experiments_import_without_jax():
    """The baselines, the optimiser and every module of `benchmarks_torch`
    import with JAX blocked and load nothing of the JAX package or of
    `benchmarks`."""
    out = subprocess.run([sys.executable, "-c", _BENCH_MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": f"{SRC}{os.pathsep}{ROOT}"})
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.strip().split("] ", 1)
    for mod in ("common", "fig2_auc", "fig3b_incremental", "fig4_ablation",
                "table3a_timing", "run"):
        assert f"'benchmarks_torch.{mod}'" in names
    assert leaked == "[]"


_SHARDED_MODULES = r"""
import sys
sys.modules["jax"] = None
import repro_torch.sharding, repro_torch.launch.mesh
import repro_torch.core.state, repro_torch.core.dispatch
from repro_torch.launch.mesh import make_db_mesh
mesh = make_db_mesh(2, ["cpu", "cpu"])
repro_torch.sharding.check_db_mesh(mesh, 8)
leaked = sorted(m for m, v in sys.modules.items() if v is not None and
                (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
print(leaked)
"""


def test_sharded_route_modules_import_without_jax():
    """The sharded route's modules (the DB axis, the DB mesh, the sharded
    state and the prebaker's dispatcher) import and make a mesh with JAX
    blocked, and load no JAX-package module."""
    out = subprocess.run([sys.executable, "-c", _SHARDED_MODULES], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
