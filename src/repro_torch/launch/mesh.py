"""Meshes: the fleet's serving / training meshes and the router DB's, the
counterparts of the JAX package's `launch/mesh.py`.

The fleet meshes (`make_production_mesh`, `make_test_mesh`) are
`torch.distributed` DeviceMeshes (`init_device_mesh`) with JAX's shapes
and axis names:

  single pod : (16, 16)     axes (data, model)        = 256 ranks
  multi-pod  : (2, 16, 16)  axes (pod, data, model)   = 512 ranks
  test       : (data, model)

one rank a device, each axis with its own process group
(`mesh.get_group("model")`). They need a world of that many ranks:
launched by `torchrun` (which sets the rank, world size and rendezvous
address), or, for the dry-run, the "fake" backend of one process
(`launch/dryrun.py`); a smaller world raises. The mesh's devices are the
cards unless the caller asks for the CPU (`device="cpu"`: gloo ranks).

The router DB's mesh is not one of these. JAX's `shard_map` is
single-controller: one process drives every shard, and the port keeps
that model for it. A `DbMesh` is the axis name "db" over a tuple of
devices, which may repeat: each shard of a RouterState lives in its own
allocation on its device, and one process launches every shard's
kernels. It is not built on `torch.distributed`: NCCL refuses two ranks
on one card, and the JAX counterpart is not multi-process either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.sharding import DB_AXIS


def _fleet_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                device: DeviceLike):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device_type = resolve_device(device).type
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < need:
        raise RuntimeError(
            f"mesh {shape} {names} needs {need} ranks, found "
            f"{world or 'no torch.distributed world'}: launch it with "
            f"torchrun over {need} processes (e.g. --nnodes "
            f"{max(need // 8, 1)} --nproc-per-node {min(need, 8)}), or "
            "init_process_group with that world size")
    if world == need:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    # a larger world (the JAX dry-run host's 512 devices): the first
    # `need` ranks
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The pod mesh (16, 16) ("data", "model"), or (2, 16, 16) ("pod",
    "data", "model") with `multi_pod`, over the world's ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _fleet_mesh(shape, names, device)


def make_test_mesh(model: int = 1, data: int = 1,
                   device: DeviceLike = None):
    """A small (data, model) mesh over the world's first data * model
    ranks -- for tests (gloo ranks on the CPU with device="cpu")."""
    return _fleet_mesh((data, model), ("data", "model"), device)


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
