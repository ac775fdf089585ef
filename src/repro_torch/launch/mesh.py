"""The router DB's mesh: the counterpart of the JAX package's
`launch/mesh.py:make_db_mesh` (its fleet meshes belong to training and
the dry-run, which the port does not have yet).

JAX's `shard_map` is single-controller: one process drives every shard.
The port keeps that model. A `DbMesh` is the axis name "db" over a tuple
of devices, which may repeat: each shard of a RouterState lives in its
own allocation on its device, and one process launches every shard's
kernels. It is not built on `torch.distributed`: NCCL refuses two ranks
on one card, and the JAX counterpart is not multi-process either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.sharding import DB_AXIS


@dataclasses.dataclass(frozen=True)
class DbMesh:
    """A 1-D mesh over the DB's capacity axis: shard s on devices[s].
    Hashable, so a dispatcher's cache key can carry it."""
    devices: Tuple[torch.device, ...]

    axis_names = (DB_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return {DB_AXIS: len(self.devices)}

    @property
    def leader(self) -> torch.device:
        """Shard 0's device: the merge gathers the candidates there and
        the replay runs there once."""
        return self.devices[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def make_db_mesh(n_shards: int = 1,
                 devices: Optional[Sequence[DeviceLike]] = None) -> DbMesh:
    """A DB mesh of `n_shards` shards. Without `devices` it takes the first
    `n_shards` cards, as the JAX package takes the first devices, and
    raises when there are fewer; it never puts a shard on the CPU. With
    `devices` (one per shard, repeats allowed: `["cpu"] * 4` for the CPU
    tests, `[cuda:0] * 4` for several shards on one card) it takes those."""
    if n_shards < 1:
        raise ValueError(f"a DB mesh needs at least one shard, not "
                         f"{n_shards}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise RuntimeError(f"DB mesh needs {n_shards} CUDA devices, "
                               f"found {have}; pass devices= to place "
                               "several shards on one device")
        return DbMesh(tuple(torch.device("cuda", i)
                            for i in range(n_shards)))
    devs = tuple(resolve_device(d) for d in devices)
    if len(devs) != n_shards:
        raise ValueError(f"{len(devs)} devices for {n_shards} shards")
    # "cuda" and "cuda:0" are one device: name the index
    devs = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)
    return DbMesh(devs)
