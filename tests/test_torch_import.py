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

SRC = Path(__file__).resolve().parent.parent / "src"

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
    from repro_torch.serving import FleetModel, ServingEngine
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
    ]


@pytest.mark.parametrize("idx", range(8))
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
