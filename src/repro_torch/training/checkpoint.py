"""Checkpoints: a tree of tensors (`repro_torch/tree.py`: the parameters,
the optimiser's state) as one `.npz`, the JAX package's
`training/checkpoint.py` layout.

The file holds `__meta__`, a JSON string of {"treedef": the tree's
structure (`tree.describe`, the port's own description), "n_leaves",
"step", "dtypes": each leaf's type name}, and `leaf_i`, the leaves in
`tree.leaves` order as host arrays. numpy has no bfloat16: a bf16 leaf
is stored as its uint16 bits, as the JAX package stores it.

A DTensor leaf is saved whole (`full_tensor()`, a collective: every rank
of its mesh calls `save`), as the JAX package gathers a sharded leaf to
the host; `restore` places a leaf as `shardings=` gives it, or as its
`like` leaf is placed, with `distribute_tensor`.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.sharding import is_dtensor

Tree = Any


def _to_numpy(leaf: torch.Tensor):
    """(host array, type name); bf16 as its uint16 bits; a DTensor whole."""
    t = leaf.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(path, tree: Tree, step: Optional[int] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pairs = [_to_numpy(x) for x in TR.leaves(tree)]
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(pairs)}
    meta = {"treedef": TR.describe(tree), "n_leaves": len(pairs),
            "step": step, "dtypes": [d for _, d in pairs]}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def restore(path, like: Tree, shardings: Optional[Tree] = None) -> Tree:
    """The tree saved at `path`, in the structure of `like`, each leaf in
    its `like` leaf's type. The leaf counts and shapes must agree; the
    treedef is not compared (the JAX package writes its own), so a JAX
    file of a flat dict reads here too.

    Where `shardings` (a tree of `like`'s structure whose leaves are
    (DeviceMesh, placements) pairs or None) gives a leaf a pair, the leaf
    is rebuilt on that mesh with `distribute_tensor`; elsewhere a DTensor
    `like` leaf gives its own mesh and placements, and any other leaf is
    put on its `like` leaf's device."""
    want = TR.leaves(like)
    places = [None] * len(want) if shardings is None \
        else TR.leaves(shardings)
    if len(places) != len(want):
        raise ValueError(f"restore: `shardings` has {len(places)} leaves, "
                         f"`like` {len(want)}")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["n_leaves"] != len(want):
            raise ValueError(f"restore: {path} holds {meta['n_leaves']} "
                             f"leaves, `like` {len(want)}")
        got = []
        for i, (dt, w, place) in enumerate(zip(meta["dtypes"], want,
                                               places)):
            a = z[f"leaf_{i}"]
            if dt == "bfloat16":   # the uint16 bits, read through int16
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            if tuple(t.shape) != tuple(w.shape):
                raise ValueError(f"restore: leaf {i} of shape "
                                 f"{tuple(t.shape)}, `like` has "
                                 f"{tuple(w.shape)}")
            if place is None and is_dtensor(w):
                place = (w.device_mesh, w.placements)
            if place is None:
                got.append(t.to(device=w.device, dtype=w.dtype))
            else:
                from torch.distributed.tensor import distribute_tensor
                mesh, placements = place
                got.append(distribute_tensor(t.to(w.dtype), mesh,
                                             placements))
    return TR.unflatten(like, got)


def latest_step(ckpt_dir) -> Optional[int]:
    """The largest N of the `step_N.npz` files in `ckpt_dir`, or None."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for f in d.glob("step_*.npz"):
        try:
            steps.append(int(f.stem.split("_")[1]))
        except ValueError:
            pass
    return max(steps) if steps else None
