"""The port's checkpoints of sharded trees against the JAX package's
contract (`training/checkpoint.py`: `save` gathers a sharded leaf to the
host; `restore(path, like, shardings=None)` re-shards): DTensor trees on
a one-rank gloo mesh on the CPU, in a subprocess of
tests/_torch_checkpoint_worker.py (a process holds one default process
group). The JAX half writes its file here first, from the worker's tree.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from _torch_checkpoint_worker import tree_np
from repro.training import checkpoint as JCKPT
from repro_torch.training import checkpoint as CKPT

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_checkpoint_worker.py"
_REPORT = {}


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    if not _REPORT:
        out = tmp_path_factory.mktemp("ckpt")
        tree = tree_np()
        JCKPT.save(out / "jax.npz", {"w": jnp.asarray(tree["w"]),
                                     "b": jnp.asarray(tree["b"],
                                                      jnp.bfloat16),
                                     "step": jnp.asarray(tree["step"])},
                   step=5)
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        proc = subprocess.run([sys.executable, str(WORKER), str(out)],
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
        _REPORT.update(json.loads((out / "report.json").read_text()))
    return _REPORT


def test_save_of_a_dtensor_tree_equals_the_unsharded_file(report):
    """`save` of a tree of DTensors (sharded and replicated leaves, fp32,
    bf16, int32) succeeds and writes the file the same tree writes
    unsharded: the same entries, the same metadata, every leaf equal in
    type and value."""
    assert report["save"] == dict(files=True, meta=True, leaves=True)


def test_restore_onto_a_dtensor_like_keeps_its_placements(report):
    """Without `shardings=`, a DTensor leaf of `like` gives its own mesh
    and placements: the restored leaves are DTensors placed as `like`'s,
    in its types, and hold the saved values."""
    got = report["like"]
    assert got["placements"] == got["want"]
    assert all(p is not None for p in got["placements"].values())
    assert got["dtypes"] == ["torch.float32", "torch.bfloat16",
                             "torch.int32"]
    assert got["equal"]


def test_restore_shardings_places_each_leaf_as_given(report):
    """`restore(path, like, shardings=)` onto a plain `like`: each leaf
    given a (mesh, placements) pair comes back a DTensor placed so, a
    leaf given None a plain tensor, every value as saved."""
    got = report["shardings"]
    assert got["placements"] == got["want"]
    assert got["equal"]


def test_a_jax_written_file_restores_onto_dtensors(report):
    """A file the JAX package's `save` wrote reads onto a DTensor `like`,
    placed as `like` is, with the values JAX saved (bf16 as its bits)."""
    got = report["jax"]
    assert got["placements"] == got["want"]
    assert got["equal"]


def test_restore_refuses_shardings_of_another_structure(tmp_path):
    """A `shardings` tree with another count of leaves than `like` is
    refused before any leaf is read."""
    tree = {k: torch.from_numpy(v) for k, v in tree_np().items()}
    CKPT.save(tmp_path / "t.npz", tree)
    with pytest.raises(ValueError, match="shardings"):
        CKPT.restore(tmp_path / "t.npz", tree, shardings={"w": None})
