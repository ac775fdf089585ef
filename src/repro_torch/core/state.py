"""Device-resident routing core.

RouterState is a frozen dataclass of tensors holding everything the
routing path needs on the device: the standing global ELO ratings plus
the vector-DB panels (embeddings + grouped pairwise feedback). Routing a
batch is one pass over this state:

    route_batch(state, query_embs, budgets, costs)
      = similarity -> top-n -> record gather -> local ELO replay
        -> score combine -> budget selection

with no host transfer between the query embeddings and the choices. The
VectorDB stays a host-side append buffer and syncs into a RouterState
through commit(), which copies only the rows touched since that
replica's last commit into its tensors, in place.

Over a DB mesh (launch/mesh.py, DESIGN.md §12) the state is a
ShardedRouterState: each DB panel split into contiguous row ranges, one
allocation per shard; commit(mesh=) copies each dirty row into the one
shard that owns it, and route_batch_choices_sharded runs the retrieval
per shard and merges the candidates on shard 0's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch import obs as OBS
from repro_torch import sharding as SHARD
from repro_torch.core import elo
from repro_torch.kernels import ops as KOPS

#: route_batch scoring modes (paper Appendix B ablations).
MODES = ("combined", "global", "local")


# ---------------------------------------------------------------------------
# score combination + budget selection
# ---------------------------------------------------------------------------

def combine_scores(global_r, local_r, p: float):
    """Score(X) = P * Global(X) + (1-P) * Local(X).  global_r: (M,),
    local_r: (Q, M) -> (Q, M)."""
    return p * global_r[None, :] + (1.0 - p) * local_r


def select_within_budget(scores, costs, budget):
    """Highest-scoring model with cost <= budget; falls back to the
    cheapest model when nothing fits (never refuse service).

    scores: (Q, M); costs: (M,); budget: scalar or (Q,).
    Returns (choice (Q,), feasible (Q, M))."""
    budget = torch.as_tensor(budget, dtype=torch.float32,
                             device=scores.device)
    if budget.ndim == 0:
        budget = budget[None]
    feasible = costs[None, :] <= budget[:, None]
    masked = torch.where(feasible, scores,
                         torch.full_like(scores, float("-inf")))
    choice = torch.argmax(masked, dim=-1)
    fallback = torch.argmin(costs)
    any_ok = feasible.any(dim=-1)
    return torch.where(any_ok, choice, fallback), feasible


# ---------------------------------------------------------------------------
# RouterState
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouterState:
    """Device snapshot of the router; capacities are the tensor shapes."""
    global_ratings: torch.Tensor   # (M,)  standing Eagle-Global ratings
    emb: torch.Tensor              # (C, D) L2-normalised prompt embeddings
    model_a: torch.Tensor          # (C, R) int32 pairwise records
    model_b: torch.Tensor          # (C, R) int32
    outcome: torch.Tensor          # (C, R) float32 S for model_a
    valid: torch.Tensor            # (C, R) bool record mask
    size: torch.Tensor             # ()    int32 live prompt rows

    @property
    def n_models(self) -> int:
        return self.global_ratings.shape[-1]

    @property
    def capacity(self) -> int:
        return self.emb.shape[0]

    @property
    def dim(self) -> int:
        return self.emb.shape[1]

    @property
    def records_per_query(self) -> int:
        return self.model_a.shape[1]

    @property
    def device(self) -> torch.device:
        return self.emb.device


#: the (C, ...) DB panels' element types; their width is D for emb, R else
_PANEL_DTYPES = {"emb": torch.float32, "model_a": torch.int32,
                 "model_b": torch.int32, "outcome": torch.float32,
                 "valid": torch.bool}


def _panel(field: str, rows: int, dim: int, records: int,
           dev: torch.device) -> torch.Tensor:
    width = dim if field == "emb" else records
    return torch.zeros((rows, width), dtype=_PANEL_DTYPES[field],
                       device=dev)


def init_state(n_models: int, dim: int, capacity: int = 4096,
               records_per_query: int = 8,
               init_rating: float = elo.DEFAULT_RATING,
               device: DeviceLike = None) -> RouterState:
    """Empty device state (no history)."""
    dev = resolve_device(device)
    return RouterState(
        global_ratings=torch.full((n_models,), init_rating,
                                  dtype=torch.float32, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev),
        **{f: _panel(f, capacity, dim, records_per_query, dev)
           for f in SHARD.DB_SHARDED})


def _ratings(global_ratings, dev: torch.device) -> torch.Tensor:
    """A copy the state owns: commit() writes into it in place, so it
    must not alias the router's ratings or another replica's."""
    return torch.as_tensor(global_ratings, dtype=torch.float32,
                           device=dev).clone()


def _size(n: int, dev: torch.device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=dev)


def state_from_buffer(db, global_ratings,
                      device: DeviceLike = None) -> RouterState:
    """Full upload of a host append buffer (VectorDB) to the device."""
    dev = resolve_device(device)
    return RouterState(
        global_ratings=_ratings(global_ratings, dev),
        emb=torch.tensor(db.emb, device=dev),
        model_a=torch.tensor(db.model_a, device=dev),
        model_b=torch.tensor(db.model_b, device=dev),
        outcome=torch.tensor(db.outcome, device=dev),
        valid=torch.tensor(db.valid, device=dev),
        size=_size(db.size, dev))


def _shape(state) -> Tuple[int, int, int]:
    return (state.capacity, state.dim, state.records_per_query)


def _db_shape(db) -> Tuple[int, int, int]:
    return (db.capacity, db.dim, db.rcap)


def commit(db, global_ratings, prev=None, consumer: str = "default",
           device: DeviceLike = None, mesh=None,
           obs: Optional[OBS.Observability] = None):
    """Sync the host append buffer into a device RouterState.

    With a previous state of matching shape, only the rows touched since
    `consumer`'s last commit are uploaded, and they are copied IN PLACE
    into `prev`'s tensors (`index_copy_`); the global ratings and the
    live-row count are written into `prev`'s too. The returned state is
    `prev`, over the same storage: O(new records), no reallocation, and
    a CUDA graph captured over `prev` reads the committed state (the
    dispatcher keys its graphs on that storage). This is the
    counterpart of the JAX package's donated buffers. That package pads
    the row count to a pow-2 bucket so its scatter compiles once per
    bucket; eager PyTorch compiles nothing, so the rows go as they are.

    A shape change (a VectorDB._grow between commits) takes a full
    re-upload onto `prev`'s device, or onto `device` when there is no
    `prev`.

    With a DB `mesh` the state is a ShardedRouterState, and each dirty
    row is copied only into the shard that owns it (DESIGN.md §12).

    In `obs` (the process default when None), with spans enabled, the
    ledger's drain and the gather of the host rows are a
    `state.commit.rows` span, the copies a `state.commit.copy` span."""
    o = OBS.get_obs(obs)
    if mesh is not None:
        return _commit_sharded(db, global_ratings, prev, consumer, mesh, o)
    dev = prev.device if prev is not None else resolve_device(device)
    full = prev is None or _shape(prev) != _db_shape(db)
    with o.span("state.commit.rows"):
        rows = db.drain_dirty(consumer)
        # rollback/clear guard: a drained row at/past the live count is
        # stale (its content is masked by `size` anyway) — drop it
        rows = rows[rows < db.size]
        host = {} if full or not rows.size else \
            {f: getattr(db, f)[rows] for f in SHARD.DB_SHARDED}
    with o.span("state.commit.copy"):
        if full:
            return state_from_buffer(db, global_ratings, dev)
        if host:
            idx = torch.as_tensor(rows.astype(np.int64), device=dev)
            for field, h in host.items():
                getattr(prev, field).index_copy_(
                    0, idx, torch.as_tensor(h, device=dev))
        _write_held(prev, global_ratings, db.size)
    return prev


def _write_held(state, global_ratings, size: int) -> None:
    """Write the ratings and the live-row count into the state's own
    copies, in place: once per device of a sharded state."""
    g = torch.as_tensor(global_ratings, dtype=torch.float32)
    if isinstance(state, RouterState):
        held = [(state.global_ratings, state.size)]
    else:   # once per device: shards there share the two tensors
        held = {id(g): (g, n) for g, n in
                zip(state.global_ratings, state.size)}.values()
    for ratings, n in held:
        ratings.copy_(g)
        n.fill_(size)


def _load_state(db, global_ratings, into):
    """Full upload of the host buffer into `into`, a state (sharded or
    not) of the buffer's shape, in place; returns `into`. The capacity
    prebaker's replicas take a grow this way (DoubleBuffer.commit)."""
    if _shape(into) != _db_shape(db):
        raise ValueError(f"_load_state: a state of shape {_shape(into)} for "
                         f"a buffer of {_db_shape(db)}")
    for field in SHARD.DB_SHARDED:
        host = torch.from_numpy(getattr(db, field))
        if isinstance(into, RouterState):
            getattr(into, field).copy_(host)
            continue
        c_local = into.shard_rows
        for s, x in enumerate(getattr(into, field)):
            x.copy_(host[s * c_local:(s + 1) * c_local])
    _write_held(into, global_ratings, db.size)
    return into


# ---------------------------------------------------------------------------
# the capacity-sharded state (DESIGN.md §12)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedRouterState:
    """A RouterState split over a DB mesh's capacity axis. Each field is a
    tuple of one tensor per shard: shard s holds global rows
    [s*C/S, (s+1)*C/S) of each DB panel in its own allocation on
    mesh.devices[s]; the ratings and the live-row count are held once per
    distinct device, so shards on one device share those tensors."""
    mesh: Any                                # launch.mesh.DbMesh
    global_ratings: Tuple[torch.Tensor, ...]   # (M,)
    emb: Tuple[torch.Tensor, ...]              # (C/S, D)
    model_a: Tuple[torch.Tensor, ...]          # (C/S, R) int32
    model_b: Tuple[torch.Tensor, ...]          # (C/S, R) int32
    outcome: Tuple[torch.Tensor, ...]          # (C/S, R) float32
    valid: Tuple[torch.Tensor, ...]            # (C/S, R) bool
    size: Tuple[torch.Tensor, ...]             # ()  int32 live rows, global

    @property
    def n_models(self) -> int:
        return self.global_ratings[0].shape[-1]

    @property
    def shard_rows(self) -> int:
        return self.emb[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.shard_rows * len(self.emb)

    @property
    def dim(self) -> int:
        return self.emb[0].shape[1]

    @property
    def records_per_query(self) -> int:
        return self.model_a[0].shape[1]

    @property
    def device(self) -> torch.device:
        """The leader's: queries, the merge and the replay live there."""
        return self.mesh.leader


AnyState = Union[RouterState, ShardedRouterState]


def _held(mesh, make) -> Tuple[torch.Tensor, ...]:
    """make(device) once per distinct device, as a per-shard tuple."""
    made = {d: make(d) for d in mesh.distinct}
    return tuple(made[d] for d in mesh.devices)


def _own(x, dev: torch.device) -> torch.Tensor:
    """A copy of x (a host array or a tensor) in its own allocation on
    `dev`: a shard never aliases another shard's or the source's memory."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=dev)
    return x.to(dev, copy=True)


def _place(panels: Dict[str, Any], global_ratings, size: int,
           mesh) -> ShardedRouterState:
    """Split (C, ...) panels (host arrays or tensors) over the mesh."""
    shards = SHARD.check_db_mesh(mesh, len(panels["emb"]))
    c_local = len(panels["emb"]) // shards
    return ShardedRouterState(
        mesh=mesh,
        global_ratings=_held(mesh, lambda d: _ratings(global_ratings, d)),
        size=_held(mesh, lambda d: _size(size, d)),
        **{f: tuple(_own(panels[f][s * c_local:(s + 1) * c_local], d)
                    for s, d in enumerate(mesh.devices))
           for f in SHARD.DB_SHARDED})


def shard_state(state: RouterState, mesh) -> ShardedRouterState:
    """Place a RouterState onto a DB mesh (contiguous capacity split)."""
    return _place({f: getattr(state, f) for f in SHARD.DB_SHARDED},
                  state.global_ratings, int(state.size), mesh)


def _empty_state(n_models: int, dim: int, capacity: int, records: int,
                device: DeviceLike = None, mesh=None) -> AnyState:
    """A zero state of the given shape (split over `mesh` when given),
    for a commit to fill: the capacity prebaker's replicas."""
    if mesh is None:
        return init_state(n_models, dim, capacity, records, 0.0, device)
    c_local = capacity // SHARD.check_db_mesh(mesh, capacity)
    return ShardedRouterState(
        mesh=mesh,
        global_ratings=_held(mesh, lambda d: torch.zeros(
            (n_models,), dtype=torch.float32, device=d)),
        size=_held(mesh, lambda d: _size(0, d)),
        **{f: tuple(_panel(f, c_local, dim, records, d)
                    for d in mesh.devices)
           for f in SHARD.DB_SHARDED})


def _commit_sharded(db, global_ratings, prev: Optional[ShardedRouterState],
                    consumer: str, mesh, obs) -> ShardedRouterState:
    """commit() over a DB mesh: drain the ledger grouped by OWNING shard
    and copy each group into its shard in place (`index_copy_` at the
    local rows); a shape change takes a full sharded re-upload. The
    ratings and the live-row count are rewritten on every device in
    place, as the unsharded commit does. The spans are commit()'s."""
    shards = SHARD.check_db_mesh(mesh, db.capacity)
    full = prev is None or _shape(prev) != _db_shape(db) or \
        prev.mesh != mesh
    with obs.span("state.commit.rows"):
        per_shard = db.drain_dirty_sharded(consumer, shards)
        host = [] if full else \
            [(s, rows, {f: getattr(db, f)[rows] for f in SHARD.DB_SHARDED})
             for s, rows in enumerate(per_shard) if rows.size]
    with obs.span("state.commit.copy"):
        if full:
            return _place({f: getattr(db, f) for f in SHARD.DB_SHARDED},
                          global_ratings, db.size, mesh)
        c_local = db.capacity // shards
        for s, rows, panels in host:
            dev = mesh.devices[s]
            idx = torch.as_tensor((rows - s * c_local).astype(np.int64),
                                  device=dev)
            for field, h in panels.items():
                getattr(prev, field)[s].index_copy_(
                    0, idx, torch.as_tensor(h, device=dev))
        _write_held(prev, global_ratings, db.size)
    return prev


class DoubleBuffer:
    """Two device replicas of the router state over ONE host buffer, so a
    feedback commit never writes into the replica that routing reads.

    `front` serves every dispatch; `commit()` copies the BACK replica's
    dirty rows into it in place and swaps. Each replica keeps its own
    ledger (VectorDB consumers named by `tags`), so rows appended between
    a replica's commits reach it on its next turn. The copy runs on the
    current stream, so it is ordered after routing already enqueued
    there. With a DB `mesh` both replicas are ShardedRouterStates.

    A grow of the host buffer makes each replica's next commit a full
    re-upload; into the replicas `prepare()` made for that shape when
    there are any (the capacity prebaker's), else into new ones.

    Each commit is counted in the `obs` scope, as in the JAX package:
    `dbuf_swaps_total`, `dbuf_dirty_backlog` (the back replica's ledger
    length as the commit starts), `dbuf_commit_us` (the host's time to
    enqueue the commit: the copies run on the stream) and a
    `state.commit` span, with commit()'s `state.commit.rows` and
    `state.commit.copy` inside it."""

    TAGS = ("dbuf_a", "dbuf_b")   # the replicas' dirty-row ledgers

    def __init__(self, db, global_ratings, device: DeviceLike = None,
                 mesh=None, tags: Tuple[str, str] = TAGS,
                 obs: Optional[OBS.Observability] = None):
        self.db = db
        self.mesh = mesh
        dev = mesh.leader if mesh is not None else resolve_device(device)
        front, back = tags
        db.register_consumer(front)
        db.register_consumer(back)
        self._front = (commit(db, global_ratings, None, consumer=front,
                              device=dev, mesh=mesh), front)
        self._back = (commit(db, global_ratings, None, consumer=back,
                             device=dev, mesh=mesh), back)
        #: (capacity, dim, records) -> replicas prepared for that shape
        self._spares: Dict[Tuple[int, int, int], List[AnyState]] = {}
        self.obs = OBS.get_obs(obs)
        r = self.obs.registry
        self._m_swaps = r.counter(
            "dbuf_swaps_total", "double-buffer commit/swap cycles")
        self._g_backlog = r.gauge(
            "dbuf_dirty_backlog",
            "dirty rows pending in the back replica's ledger at commit")
        self._h_commit_us = r.histogram(
            "dbuf_commit_us",
            "host-side commit enqueue latency (the copies run on the "
            "stream)")

    @property
    def front(self) -> AnyState:
        """The replica dispatches read. Valid until the SECOND next
        commit() (one swap keeps it as back, the next writes into it)."""
        return self._front[0]

    def prepare(self, capacity: int, records: int) -> Tuple[AnyState, ...]:
        """Allocate the two replicas a grow of the host buffer to
        `capacity` prompts of `records` records will commit into, and
        keep them for it: the grow's full re-upload then copies into them
        in place, so what was captured over them (route graphs) serves
        the grown replicas. Returns them."""
        st = self.front
        pair = [_empty_state(st.n_models, st.dim, capacity, records,
                            st.device, self.mesh) for _ in range(2)]
        self._spares[(capacity, st.dim, records)] = list(pair)
        return tuple(pair)

    def commit(self, global_ratings) -> AnyState:
        """Absorb pending feedback into the back replica, swap, return the
        new front."""
        st, tag = self._back
        self._g_backlog.set(len(self.db._dirty.get(tag, ())))
        t0 = time.perf_counter_ns()
        with self.obs.span("state.commit"):
            shape = _db_shape(self.db)
            spares = self._spares.get(shape)
            if spares and _shape(st) != shape:
                with self.obs.span("state.commit.rows"):
                    self.db.drain_dirty(tag)
                with self.obs.span("state.commit.copy"):
                    new = _load_state(self.db, global_ratings,
                                      spares.pop())
            else:
                new = commit(self.db, global_ratings, st, consumer=tag,
                             mesh=self.mesh, obs=self.obs)
            if spares == []:
                del self._spares[shape]
        self._back, self._front = self._front, (new, tag)
        self._h_commit_us.observe((time.perf_counter_ns() - t0) / 1e3)
        self._m_swaps.inc()
        return self.front


# ---------------------------------------------------------------------------
# the routing pipeline
# ---------------------------------------------------------------------------

class RouteResult(NamedTuple):
    choices: torch.Tensor    # (Q,)   selected model per query
    scores: torch.Tensor     # (Q, M) combined quality scores
    topk_idx: torch.Tensor   # (Q, N) retrieved prompt rows (-1 in global mode)


class RouteChoices(NamedTuple):
    choices: torch.Tensor    # (Q,)   selected model per query
    topk_idx: torch.Tensor   # (Q, N) retrieved prompt rows (-1 in global mode)


def _queries(state: AnyState, q) -> torch.Tensor:
    q = torch.as_tensor(q, dtype=torch.float32, device=state.device)
    return q[None] if q.ndim == 1 else q


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _no_topk(state: AnyState, nq: int, n: int) -> torch.Tensor:
    return torch.full((nq, n), -1, dtype=torch.int64, device=state.device)


def _scores(state: RouterState, q, p_global, n_neighbors, k, backend,
            mode, init_rating):
    _check_mode(mode)
    q = _queries(state, q)
    nq, m = q.shape[0], state.n_models
    n = min(n_neighbors, state.capacity)
    if mode == "global":
        # Eagle-Global ablation: no retrieval at all
        return state.global_ratings.expand(nq, m), _no_topk(state, nq, n)
    if mode == "local":
        init = torch.full((m,), init_rating, dtype=torch.float32,
                          device=state.device)  # flat prior
    else:
        init = state.global_ratings
    local, top_i, _ = KOPS.retrieve_replay(
        q, state.emb, state.model_a, state.model_b, state.outcome,
        state.valid, state.size, init, n=n, k=k, backend=backend)
    if mode == "local":
        return local, top_i
    return combine_scores(state.global_ratings, local, p_global), top_i


def batch_scores(state: RouterState, query_embs, *, p_global: float = 0.5,
                 n_neighbors: int = 20, k: float = 32.0,
                 backend: str = "cuda", mode: str = "combined",
                 init_rating: float = elo.DEFAULT_RATING):
    """(Q, M) combined quality scores."""
    return _scores(state, query_embs, p_global, n_neighbors, k, backend,
                   mode, init_rating)[0]


def _route(state: AnyState, q, budgets, costs, p_global, n_neighbors, k,
           backend, mode, init_rating, with_scores=True):
    """Shared body of route_batch/route_batch_choices(_sharded): retrieval
    + replay with the budget selection in the replay kernel's epilogue
    (the standalone select_within_budget stays as the parity oracle).
    Without `with_scores` the combined scores are not formed (None): the
    serving variants read only the choices and the top-n rows."""
    _check_mode(mode)
    q = _queries(state, q)
    nq, m = q.shape[0], state.n_models
    n = min(n_neighbors, state.capacity)
    sharded = isinstance(state, ShardedRouterState)
    # the leader's copy of the ratings (every device holds the same)
    g = state.global_ratings[0] if sharded else state.global_ratings
    costs = torch.as_tensor(costs, dtype=torch.float32, device=state.device)
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=state.device).expand(nq)
    if mode == "global":
        # Eagle-Global ablation: no retrieval, selection is the whole op
        scores = g.expand(nq, m)
        choices, _ = select_within_budget(scores, costs, budgets)
        return choices.int(), scores, _no_topk(state, nq, n)
    if mode == "local":
        init = torch.full((m,), init_rating, dtype=torch.float32,
                          device=state.device)  # flat prior
        p = 0.0   # 0*Global + 1*Local == Local, bit-exact for finite r
    else:
        init = g
        p = p_global
    retrieve = KOPS.retrieve_replay_select_sharded if sharded \
        else KOPS.retrieve_replay_select
    local, top_i, _, choices = retrieve(
        q, state.emb, state.model_a, state.model_b, state.outcome,
        state.valid, state.size, init, g, costs, budgets, n=n, k=k, p=p,
        backend=backend)
    if not with_scores:
        return choices, None, top_i
    scores = local if mode == "local" else combine_scores(g, local, p_global)
    return choices, scores, top_i


def route_batch(state: RouterState, query_embs, budgets, costs, *,
                p_global: float = 0.5, n_neighbors: int = 20,
                k: float = 32.0, backend: str = "cuda",
                mode: str = "combined",
                init_rating: float = elo.DEFAULT_RATING) -> RouteResult:
    """Route a batch of queries under budgets: similarity, top-n,
    feedback gather, local ELO replay, score combination and budget
    selection, all on the state's device."""
    return RouteResult(*_route(state, query_embs, budgets, costs, p_global,
                               n_neighbors, k, backend, mode, init_rating))


def route_batch_choices(state: RouterState, query_embs, budgets, costs, *,
                        p_global: float = 0.5, n_neighbors: int = 20,
                        k: float = 32.0, backend: str = "cuda",
                        mode: str = "combined",
                        init_rating: float = elo.DEFAULT_RATING
                        ) -> RouteChoices:
    """Serving variant of route_batch: the same dataflow, returning only
    the choices and the retrieval trace (what the dispatcher reads). A
    ShardedRouterState takes the sharded route."""
    choices, _, top_i = _route(state, query_embs, budgets, costs, p_global,
                               n_neighbors, k, backend, mode, init_rating,
                               with_scores=False)
    return RouteChoices(choices, top_i)


def route_batch_choices_sharded(state: ShardedRouterState, query_embs,
                                budgets, costs, *, p_global: float = 0.5,
                                n_neighbors: int = 20, k: float = 32.0,
                                backend: str = "cuda",
                                mode: str = "combined",
                                init_rating: float = elo.DEFAULT_RATING
                                ) -> RouteChoices:
    """route_batch_choices over a capacity-sharded state (DESIGN.md §12):
    per-shard similarity and local top-n, the cross-shard merge on the
    leader, the replay and selection once there. Choices and topk_idx
    (global rows) equal the single-device route's bit for bit. The mesh
    is the state's own (the JAX package passes it beside the state)."""
    if not isinstance(state, ShardedRouterState):
        raise TypeError("route_batch_choices_sharded takes a "
                        "ShardedRouterState (core.state.shard_state, or "
                        "commit(mesh=...))")
    choices, _, top_i = _route(state, query_embs, budgets, costs, p_global,
                               n_neighbors, k, backend, mode, init_rating,
                               with_scores=False)
    return RouteChoices(choices, top_i)
