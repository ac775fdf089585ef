"""The router DB's capacity axis: which RouterState fields split over a DB
mesh and which are held once per device (DESIGN.md §12).

A copy of the DB part of the JAX package's `sharding.py`; its model
parameter rules belong to training and the dry-run, which the port does
not have yet. A mesh here is a `launch.mesh.DbMesh`: the axis name
DB_AXIS over a tuple of devices.
"""
from __future__ import annotations

from typing import Dict, Optional

#: mesh axis the RouterState DB panels partition over. Not the fleet's
#: "data"/"model": the routing DB scales on its own 1-D mesh.
DB_AXIS = "db"

#: the (C, ...) DB panels: split on dim 0 into CONTIGUOUS row ranges
DB_SHARDED = ("emb", "model_a", "model_b", "outcome", "valid")
#: the (M,) ratings and the () live-row count: one copy per device
DB_PER_DEVICE = ("global_ratings", "size")


def db_state_specs() -> Dict[str, Optional[str]]:
    """The mesh axis each RouterState field splits dim 0 over (None: held
    whole on every device). Shard s owns global rows [s*C/S, (s+1)*C/S).
    Contiguity is load-bearing: the cross-shard top-k merge orders its
    candidate pool (shard, local rank), which is ascending global row
    among equal scores only under a contiguous split — that keeps
    tie-breaking bit-identical to the single-device route."""
    specs: Dict[str, Optional[str]] = {f: None for f in DB_PER_DEVICE}
    specs.update({f: DB_AXIS for f in DB_SHARDED})
    return specs


def db_shard_count(mesh) -> int:
    return mesh.shape[DB_AXIS]


def check_db_mesh(mesh, capacity: int) -> int:
    """Validate a DB mesh against a state capacity; returns the shard
    count. The capacity must divide exactly (VectorDB's doubling grow
    keeps a power-of-two capacity divisible)."""
    if DB_AXIS not in mesh.axis_names:
        raise ValueError(
            f"DB mesh must carry a {DB_AXIS!r} axis, got {mesh.axis_names}")
    shards = db_shard_count(mesh)
    if capacity % shards != 0:
        raise ValueError(
            f"capacity {capacity} does not divide over {shards} DB shards")
    return shards
