"""Subprocess worker for tests/test_torch_checkpoint_sharded.py: the port's
checkpoints of DTensor trees on a one-rank gloo mesh on the CPU.

  python tests/_torch_checkpoint_worker.py OUT

OUT holds `jax.npz`, written by the JAX package's `save` from the tree
`tree_np()` gives. The worker builds a (data=1, model=1) mesh, saves the
same tree as DTensors and as plain tensors, restores files onto DTensor
and plain `like` trees, with and without `shardings=`, and writes
OUT/report.json: per check, the placements it found and whether every
leaf equals the tree it should.
"""
import json
import socket
import sys
from pathlib import Path

import numpy as np


def tree_np():
    """The tree both packages write: fp32, bf16 (as float32 values that
    bf16 holds exactly) and int32 leaves, keyed as a flat dict."""
    rng = np.random.default_rng(21)
    return {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "b": np.round(rng.normal(size=(6,)) * 8).astype(np.float32) / 8,
            "step": np.asarray(5, np.int32)}


def _torch_tree():
    import torch
    t = {k: torch.from_numpy(v.copy()) for k, v in tree_np().items()}
    t["b"] = t["b"].to(torch.bfloat16)
    return t


def _names(placements):
    return [str(p) for p in placements]


def main(out: Path):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch import tree as TR
    from repro_torch.training import checkpoint as CKPT

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    report = {}
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        plain = _torch_tree()
        layout = {"w": [Shard(0), Shard(1)], "b": [Replicate(), Shard(0)],
                  "step": [Replicate(), Replicate()]}
        sharded = {k: distribute_tensor(v, mesh, layout[k])
                   for k, v in plain.items()}

        def equal(tree):
            return all(
                torch.equal(x.full_tensor() if isinstance(x, DTensor)
                            else x, y)
                for x, y in zip(TR.leaves(tree), TR.leaves(plain)))

        def placed(tree):
            return {k: (_names(v.placements) if isinstance(v, DTensor)
                        else None) for k, v in tree.items()}

        # save: a DTensor tree, then the same tree unsharded
        CKPT.save(out / "sharded.npz", sharded, step=5)
        CKPT.save(out / "plain.npz", plain, step=5)
        with np.load(out / "sharded.npz") as a, \
                np.load(out / "plain.npz") as b:
            report["save"] = dict(
                files=sorted(a.files) == sorted(b.files),
                meta=str(a["__meta__"]) == str(b["__meta__"]),
                leaves=all(a[f].dtype == b[f].dtype
                           and np.array_equal(a[f], b[f])
                           for f in a.files if f != "__meta__"))

        # restore onto a DTensor `like`: its own mesh and placements
        like = {k: distribute_tensor(torch.zeros_like(v), mesh, layout[k])
                for k, v in plain.items()}
        got = CKPT.restore(out / "sharded.npz", like)
        report["like"] = dict(placements=placed(got),
                              want=placed(like), equal=equal(got),
                              dtypes=[str(v.dtype) for v in got.values()])

        # restore(shardings=) onto a plain `like`: each leaf as given,
        # None keeping the plain tensor
        given = {"w": (mesh, [Shard(1), Replicate()]),
                 "b": (mesh, [Shard(0), Replicate()]), "step": None}
        plain_like = TR.map_tree(torch.zeros_like, plain)
        got = CKPT.restore(out / "plain.npz", plain_like, shardings=given)
        report["shardings"] = dict(
            placements=placed(got),
            want={"w": _names(given["w"][1]), "b": _names(given["b"][1]),
                  "step": None},
            equal=equal(got))

        # a JAX-written file onto DTensors
        got = CKPT.restore(out / "jax.npz", like)
        report["jax"] = dict(placements=placed(got), want=placed(like),
                             equal=equal(got))
    finally:
        dist.destroy_process_group()
    (out / "report.json").write_text(json.dumps(report))


if __name__ == "__main__":
    main(Path(sys.argv[1]))
