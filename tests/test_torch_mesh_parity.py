"""The port's fleet meshes against the JAX package's, on the CPU: the
expert-parallel MoE and the SPMD train step on a (data=2, model=2) mesh
(4 gloo ranks against JAX's shard_map / GSPMD over 4 forced host
devices), the production meshes on the "fake" backend, and a world too
small for them refused.

The halves run in subprocesses of tests/_torch_mesh_worker.py, side by
side: JAX needs its forced-device flag before it initialises, and a
process holds one default process group. JAX's mesh is built with Auto
axes in the worker: its package's `make_test_mesh` makes Explicit ones
(JAX 0.9), on which the sharded train step fails in the embedding
gather (ROADMAP §4, reference defect), which the last test records."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_worker import MOE_ARCHS, TRAIN, nest
from _torch_training_common import (METRIC_RTOL, STEP_ATOL,
                                    assert_trees_close, configs, port_tree)
from repro_torch import tree as TR

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_mesh_worker.py"
#: the MoE bars: y within this fraction of its largest |value|, aux
#: absolutely, each gradient leaf within GRAD of its largest |value|
Y_BAR, AUX_BAR, GRAD_BAR = 1e-5, 1e-6, 1e-5
_OUT = {}


def halves(tmp_path_factory):
    """Both halves' arrays and reports (run once a session, side by
    side)."""
    if not _OUT:
        out = tmp_path_factory.mktemp("mesh")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        jenv = dict(env, XLA_FLAGS=(env.get("XLA_FLAGS", "") + " --xla_"
                                    "force_host_platform_device_count=4"
                                    ).strip())
        procs = [subprocess.Popen([sys.executable, str(WORKER), half,
                                   str(out)], env=e,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for half, e in (("jax", jenv), ("ranks", env),
                                 ("fake", env))]
        for p in procs:
            text = p.communicate(timeout=600)[0]
            assert p.returncode == 0, text[-4000:]
        for half in ("jax", "ranks"):
            with np.load(out / f"{half}.npz") as f:
                _OUT[half] = dict(f)
        for half in ("jax", "ranks", "fake"):
            _OUT[half + ".json"] = json.loads(
                (out / f"{half}.json").read_text())
    return _OUT


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return halves(tmp_path_factory)


def close(got, want, bar, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bar * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_moe_equals_jax_shard_map(out, arch):
    """apply_moe at 8,320 tokens on (2, 2): y, aux and the gradients of x,
    the router, the experts (and deepseek's shared experts) against
    JAX's shard_map path; and at this size the sharded call drops
    other pairs than the unsharded one, on both packages (each batch
    shard's capacity is its own tokens')."""
    j, t = out["jax"], out["ranks"]
    k = f"moe/{arch}/"
    close(t[k + "y"], j[k + "y"], Y_BAR, "y")
    np.testing.assert_allclose(t[k + "aux"], j[k + "aux"], rtol=0,
                               atol=AUX_BAR)
    close(t[k + "gx"], j[k + "gx"], GRAD_BAR, "grad x")
    names = sorted(n for n in j if n.startswith(k + "gp/"))
    assert names == sorted(n for n in t if n.startswith(k + "gp/"))
    assert any(n.endswith("router") for n in names)
    for n in names:
        close(t[n], j[n], GRAD_BAR, n)
    for half in (j, t):
        assert np.abs(half[k + "y"] - half[k + "y_unsharded"]).max() > 1e-2
    close(t[k + "y_unsharded"], j[k + "y_unsharded"], Y_BAR, "unsharded y")


@pytest.mark.parametrize("arch", [a for a, _, _ in TRAIN])
def test_train_steps_on_a_mesh_equal_jax(out, arch):
    """3 steps of make_train_step(mesh=) from JAX's initial weights on the
    same global batches: the metrics within METRIC_RTOL each step, the
    parameters within STEP_ATOL of each leaf's scale."""
    mj = out["jax.json"]["metrics"][arch]
    mt = out["ranks.json"]["metrics"][arch]
    assert len(mj) == len(mt) == 3
    for i, (a, b) in enumerate(zip(mt, mj)):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], rtol=METRIC_RTOL,
                                       err_msg=f"{arch} step {i} {key}")
    assert mt[-1]["ce"] != mt[0]["ce"]
    cfg_j, cfg_t = configs(arch)
    want = port_tree(cfg_t, nest(out["jax"], f"train/{arch}/"))
    leaves = [torch.tensor(out["ranks"][f"train/{arch}/{i}"])
              for i in range(len(TR.leaves(want)))]
    assert_trees_close(TR.unflatten(want, leaves), want, 0.0, STEP_ATOL,
                       f"{arch} parameters after 3 steps")


def test_port_ranks_built_the_test_mesh(out):
    assert out["ranks.json"]["mesh"] == [["data", "model"], [2, 2]]
    assert out["jax.json"]["n_devices"] == 4


@pytest.mark.parametrize("which,shape,names", [
    ("single", [16, 16], ["data", "model"]),
    ("multi", [2, 16, 16], ["pod", "data", "model"])])
def test_production_meshes_on_the_fake_backend(out, which, shape, names):
    got = out["fake.json"][which]
    assert got == {"shape": shape, "names": names, "model_group": 16}


def test_a_world_of_one_is_refused_naming_256(out):
    msg = out["fake.json"]["world_1"]
    assert "needs 256 ranks" in msg and "torchrun" in msg, msg


def test_jax_test_mesh_has_explicit_axes(out):
    """Reference defect: JAX 0.9's make_mesh without axis_types gives
    Explicit axes, so the JAX package's make_test_mesh is not the mesh its
    sharded train step runs on; the worker builds Auto axes itself."""
    assert out["jax.json"]["test_mesh_axis_types"] == ["Explicit"] * 2
