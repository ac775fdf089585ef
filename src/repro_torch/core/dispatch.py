"""Steady-state dispatch layer: query bucketing over the routing path and
an eviction-free cache of captured CUDA graphs, the counterpart of the
JAX package's cache of compiled executables (its `core/dispatch.py`).

  * Ragged batches are padded to power-of-two BUCKETS (the same policy
    elo._pad_bucket applies to record folds, with a smaller floor), so
    the set of shapes the device sees is the bucket ladder, not the
    traffic.
  * Each dispatch is served from a cache entry keyed on
    (bucket, capacity, records_per_query, mode, backend) — the JAX key —
    plus the replica the entry reads. On the card an entry is a CUDA
    graph of `route_batch_choices` (the fused retrieve's two kernels, the
    replay kernel's gather-select route) captured over static query and
    budget buffers and one RouterState's tensors, so the key carries
    those tensors' addresses: `DoubleBuffer.front` alternates between
    two replicas (two graphs a bucket), and a grow allocates new ones (a
    new key, as the new capacity is in JAX). Commits write a replica in
    place (core/state.py), so its graphs read what was committed. The
    graphs of one state shape (capacity, records per prompt) share a
    memory pool. Once a replica's tensors are freed (the old replicas
    after a grow), its graphs can never be hit again: the next capture
    evicts them, and the old shape's pool goes with its last graph.
  * Queries and budgets are staged through pinned host memory and copied
    in without blocking; the host reads the choices (and the top-n rows
    for route_result) once per dispatch.
  * A capture happens only on a miss, so `cache_stats()` is an exact
    capture ledger; `warmup()` fills the cache before traffic and
    returns how many entries it made (0 when warm). Its `entries` are
    the live ones: the JAX cache evicts nothing, and neither does this
    one but for the graphs of freed replicas (`telemetry()` counts them).
  * On CPU tensors an entry runs the eager route: nothing is captured,
    the key has no replica, nothing is evicted, and the keys, hits and
    misses are the ones the JAX package counts.
  * With a DB mesh (launch/mesh.py, DESIGN.md §12) the dispatcher routes
    ShardedRouterStates (route_batch_choices takes the sharded route for
    them), and the key carries the mesh, as the JAX key does; the
    replica is every shard's tensors. A mesh on one card is captured whole into each route
    graph; a mesh over several cards routes eagerly (a graph holds one
    device's work).
  * `CapacityPrebaker` prepares the next capacity's replicas and
    captures their ladder before a DB grow.

Batches past `max_bucket` are routed in ladder-sized chunks.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import graphs
from repro_torch import obs as OBS
from repro_torch.graphs import DispatchStats  # noqa: F401  (re-exported)
from repro_torch.core import elo
from repro_torch.core.state import (AnyState, ShardedRouterState,
                                    route_batch_choices)

#: default bucket ladder bounds (powers of two, inclusive)
MIN_BUCKET = 8
MAX_BUCKET = 1024

#: the RouterState tensors a route graph reads
_STATE_FIELDS = ("global_ratings", "emb", "model_a", "model_b", "outcome",
                 "valid", "size")


def batch_bucket(n: int, min_bucket: int = MIN_BUCKET,
                 max_bucket: int = MAX_BUCKET) -> int:
    """Power-of-two bucket for a batch of n queries. Batches beyond
    max_bucket keep their exact padded size."""
    b = elo._pad_bucket(max(1, n), floor=min_bucket)
    return b if b <= max_bucket else elo._pad_bucket(n, floor=max_bucket)


def bucket_ladder(min_bucket: int = MIN_BUCKET,
                  max_bucket: int = MAX_BUCKET) -> Tuple[int, ...]:
    """All buckets the dispatcher can produce up to max_bucket."""
    out = []
    b = min_bucket
    while b <= max_bucket:
        out.append(b)
        b *= 2
    return tuple(out)


def _tensors(state: AnyState) -> List[torch.Tensor]:
    """Every tensor a route over `state` reads: each shard's, when it is
    sharded."""
    if isinstance(state, ShardedRouterState):
        return [t for f in _STATE_FIELDS for t in getattr(state, f)]
    return [getattr(state, f) for f in _STATE_FIELDS]


def replica(state: AnyState) -> Optional[Tuple[int, ...]]:
    """The storage a route graph over `state` reads (None on the CPU,
    where nothing is captured)."""
    if state.device.type != "cuda":
        return None
    return tuple(t.data_ptr() for t in _tensors(state))


def _one_device(state: AnyState) -> bool:
    return not isinstance(state, ShardedRouterState) or \
        len(state.mesh.distinct) == 1


class _Entry:
    """One cached dispatch at bucket `qb`: static query and budget
    buffers (pinned host staging on the card) and the route step over
    them, captured from `state` on the card (routed eagerly when the
    state spans several cards)."""

    def __init__(self, state: AnyState, qb: int, costs, kw: Dict, pool):
        dev = state.device
        pinned = dev.type == "cuda"
        self.q = torch.zeros((qb, state.dim), dtype=torch.float32,
                             device=dev)
        self.b = torch.zeros((qb,), dtype=torch.float32, device=dev)
        q_host = torch.zeros((qb, state.dim), dtype=torch.float32,
                             pin_memory=True) if pinned else self.q
        b_host = torch.zeros((qb,), dtype=torch.float32,
                             pin_memory=True) if pinned else self.b
        self.q_np, self.b_np = q_host.numpy(), b_host.numpy()
        self._host = (q_host, b_host) if pinned else None
        self.costs = torch.as_tensor(costs, dtype=torch.float32, device=dev)
        self.kw = kw
        # the replica's tensors, to tell when they are gone (not kept
        # alive by the entry: the graph reads them by address)
        self._replica = [weakref.ref(t) for t in _tensors(state)] \
            if pinned else []
        self.step = graphs.Step(self._route, state, device=dev, pool=pool) \
            if _one_device(state) else self._route

    def dead(self) -> bool:
        """True once a tensor of the replica it reads is freed."""
        return any(ref() is None for ref in self._replica)

    def _route(self, state: AnyState):
        return tuple(route_batch_choices(state, self.q, self.b, self.costs,
                                         **self.kw))

    def __call__(self, state: AnyState, q: np.ndarray, b: np.ndarray,
                 with_topk: bool):
        nq = q.shape[0]
        self.q_np[:nq], self.q_np[nq:] = q, 0.0
        self.b_np[:nq], self.b_np[nq:] = b, 0.0
        if self._host is not None:
            # the previous dispatch's readout waited for its copy, so the
            # staging buffers are free to rewrite
            self.q.copy_(self._host[0], non_blocking=True)
            self.b.copy_(self._host[1], non_blocking=True)
        choices, topk = self.step(state)
        return (choices[:nq].cpu().numpy(),
                topk[:nq].cpu().numpy() if with_topk else None)


class RouteDispatcher:
    """Owns the serving hot path's route graphs.

    One dispatcher per (routing config, costs) pair; states of any
    capacity or record width flow through it — the cache key carries
    the shape-defining axes, the DB mesh and, on the card, the replica.
    Routing runs on the caller's thread and stream, one dispatch at a
    time."""

    def __init__(self, costs, *, p_global: float = 0.5,
                 n_neighbors: int = 20, k: float = 32.0,
                 backend: str = "cuda", mode: str = "combined",
                 init_rating: float = elo.DEFAULT_RATING,
                 min_bucket: int = MIN_BUCKET,
                 max_bucket: int = MAX_BUCKET,
                 mesh=None,
                 obs: Optional[OBS.Observability] = None):
        # with a DB mesh the dispatcher serves ShardedRouterStates over it
        self.mesh = mesh
        self.costs = costs
        self.kw = dict(p_global=float(p_global),
                       n_neighbors=int(n_neighbors), k=float(k),
                       backend=backend, mode=mode,
                       init_rating=float(init_rating))
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        # telemetry handles, by the JAX package's names (metrics are
        # always on; spans are gated by obs.enabled). The pad-waste
        # ratio and the hit rate are derived from them at read time.
        self.obs = OBS.get_obs(obs)
        r = self.obs.registry
        self._m_calls = r.counter(
            "dispatch_calls_total", "route() dispatches")
        self._m_rows = r.counter(
            "dispatch_rows_total", "real query rows routed")
        self._m_padded = r.counter(
            "dispatch_padded_rows_total",
            "bucket-padded rows dispatched (>= rows; waste = padded-rows)")
        self._m_hits = r.counter(
            "dispatch_cache_hits_total", "graph-cache hits")
        self._m_misses = r.counter(
            "dispatch_cache_misses_total",
            "graph-cache misses == graphs this dispatcher captured")
        self._m_compile_s = r.counter(
            "dispatch_compile_seconds_total", "time spent capturing")
        self._h_occupancy = r.histogram(
            "dispatch_bucket_occupancy", "rows/bucket fill per dispatch",
            bounds=[i / 16 for i in range(1, 17)])
        # what the LAST dispatch filled: the SLO engine's live occupancy
        # signal (the histogram's mean averages over all time)
        self._g_occupancy = r.gauge(
            "dispatch_occupancy_last", "rows/bucket fill, last dispatch")
        self._bucket_counters: Dict[int, OBS.Counter] = {}
        r.gauge("graph_captures_total",
                "process-wide CUDA graph captures",
                fn=graphs.capture_count)
        m_misses, m_compile_s, obs = \
            self._m_misses, self._m_compile_s, self.obs

        def on_miss(key: Tuple, dt: float):
            m_misses.inc()
            m_compile_s.inc(dt)
            obs.emit({"kind": "dispatch_compile", "bucket": key[0],
                      "capacity": key[1], "records": key[2],
                      "seconds": dt})
        # the hooks hold the counters, not the dispatcher: no reference
        # cycle, so a dropped dispatcher frees its graphs at once
        self._cache = graphs.StepCache(on_hit=self._m_hits.inc,
                                       on_miss=on_miss)
        self.stats = self._cache.stats

    def _bucket_counter(self, qb: int):
        c = self._bucket_counters.get(qb)
        if c is None:
            c = self.obs.registry.counter(
                "dispatch_bucket_total", "dispatches per bucket size",
                bucket=str(qb))
            self._bucket_counters[qb] = c
        return c

    @classmethod
    def for_router(cls, router, **kw) -> "RouteDispatcher":
        """Build from an EagleRouter's config (costs, mode, backend...)."""
        c = router.cfg
        return cls(router.costs, p_global=c.p_global,
                   n_neighbors=c.n_neighbors, k=c.k_factor,
                   backend=c.backend, mode=router.mode,
                   init_rating=c.init_rating, **kw)

    # -- cache ---------------------------------------------------------------
    def bucket(self, n: int) -> int:
        return batch_bucket(n, self.min_bucket, self.max_bucket)

    def _key(self, state: AnyState, qb: int) -> Tuple:
        return (qb, state.capacity, state.records_per_query,
                self.kw["mode"], self.kw["backend"], self.mesh,
                replica(state))

    def _entry(self, state: AnyState, qb: int,
               warm: bool = False) -> _Entry:
        if getattr(state, "mesh", None) != self.mesh:
            raise ValueError(f"a dispatcher over the DB mesh {self.mesh} "
                             f"got a state over {getattr(state, 'mesh', None)}")
        key = self._key(state, qb)
        entry = self._cache.entries.get(key)
        # (a dead entry on a hit: new tensors at a freed replica's
        # addresses, which get graphs of their own)
        if entry is None or entry.dead():
            self.evict_dead()

        def make(pool):
            with self.obs.span(f"dispatch.compile.q{qb}"):
                return _Entry(state, qb, self.costs, self.kw, pool)
        return self._cache.get(key, make, device=state.device,
                               group=key[1:3], warm=warm)

    def evict_dead(self) -> int:
        """Drop the graphs of freed replicas (and give their memory back).
        A miss does it before it captures; the prebaker after each commit,
        as a prebaked grow captures nothing. Returns how many went."""
        n = self._cache.evict(lambda k, e: e.dead())
        if n:
            torch.cuda.empty_cache()
        return n

    def warmup(self, state: AnyState,
               batch_sizes: Optional[Sequence[int]] = None) -> int:
        """Fill the cache for `state` at each bucket of the ladder (or of
        `batch_sizes`) so that traffic on it never captures. Returns the
        number of entries made (0 if already warm). A DoubleBuffer's two
        replicas are two states: warm each while it is the front."""
        buckets = sorted({self.bucket(n) for n in batch_sizes}
                         if batch_sizes is not None
                         else bucket_ladder(self.min_bucket,
                                            self.max_bucket))
        before = self.stats.misses
        for qb in buckets:
            self._entry(state, qb, warm=True)
        return self.stats.misses - before

    def cache_stats(self) -> Dict:
        """The JAX package's readout: misses is the exact number of
        entries (graphs, on the card) this dispatcher ever made; entries
        and keys are the live ones (the freed replicas' graphs evicted)."""
        return self._cache.as_dict()

    def telemetry(self) -> Dict:
        """Serving-efficiency readout from the raw counters: pad-waste
        ratio (the share of dispatched rows that were padding), the hit
        rate over traffic, and the capture ledger."""
        rows = self._m_rows.value
        padded = self._m_padded.value
        hits, misses = self._m_hits.value, self._m_misses.value
        # warmup()'s captures are deliberate, not traffic misses
        traffic_misses = max(0, misses - self.stats.warmed)
        return {
            "calls": self._m_calls.value,
            "rows": rows,
            "padded_rows": padded,
            "pad_waste_ratio": (padded - rows) / padded if padded else 0.0,
            "cache_hit_rate": hits / (hits + traffic_misses)
                              if (hits + traffic_misses) else 1.0,
            "cache_hits": hits,
            "cache_misses": misses,
            "compile_seconds": self._m_compile_s.value,
            "graph_captures_process": graphs.capture_count(),
            "cache_evicted": self._cache.evicted,
        }

    def _record_dispatch(self, nq: int, qb: int):
        self._m_calls.inc()
        self._m_rows.inc(nq)
        self._m_padded.inc(qb)
        self._h_occupancy.observe(nq / qb)
        self._g_occupancy.set(nq / qb)
        self._bucket_counter(qb).inc()

    # -- the hot path --------------------------------------------------------
    def _chunks(self, nq: int):
        """(lo, hi) spans of at most max_bucket rows. Routing is
        row-independent, so an oversized batch is dispatched as
        ladder-sized chunks (an off-ladder size would miss the warmed
        cache and capture on the hot path)."""
        return [(lo, min(lo + self.max_bucket, nq))
                for lo in range(0, nq, self.max_bucket)]

    def _route_one(self, state: AnyState, q: np.ndarray, b: np.ndarray,
                   with_topk: bool):
        nq = q.shape[0]
        qb = self.bucket(nq)
        self._record_dispatch(nq, qb)
        name = "dispatch.route_result" if with_topk else "dispatch.route"
        with self.obs.span(name):
            return self._entry(state, qb)(state, q, b, with_topk)

    def _route(self, state, query_embs, budgets, with_topk: bool):
        q = np.atleast_2d(np.asarray(query_embs, np.float32))
        nq = q.shape[0]
        b = np.broadcast_to(np.asarray(budgets, np.float32),
                            (nq,)).astype(np.float32)
        if nq <= self.max_bucket:
            return [self._route_one(state, q, b, with_topk)]
        return [self._route_one(state, q[lo:hi], b[lo:hi], with_topk)
                for lo, hi in self._chunks(nq)]

    def route(self, state: AnyState, query_embs, budgets) -> np.ndarray:
        """Bucket-pad, dispatch the cached entry, slice. Returns host (Q,)
        int32 choices — the single readout of a routing step. Oversized
        batches are chunked."""
        parts = self._route(state, query_embs, budgets, with_topk=False)
        return np.concatenate([p[0] for p in parts])

    def route_result(self, state: AnyState, query_embs, budgets):
        """route() that also returns the retrieval trace: (choices (Q,),
        topk_idx (Q, n)) as host arrays."""
        parts = self._route(state, query_embs, budgets, with_topk=True)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


# ---------------------------------------------------------------------------
# capacity prebaker: fill the cache BEFORE the DB grows
# ---------------------------------------------------------------------------

class CapacityPrebaker:
    """Preparation of the NEXT capacity's route graphs before the DB grows.

    A VectorDB._grow() doubles the panel shapes; each replica's next
    commit is a full re-upload into new tensors, whose route graphs would
    be captured on the hot path. poll() is a post-commit hook: once the
    buffer fills past `watermark`, the double buffer allocates the two
    replicas of db.next_capacity() (sharded when the dispatcher has a
    mesh: `DoubleBuffer.prepare`) and their ladder (`batch_sizes`, or the
    whole ladder) is captured into the dispatcher's cache, counted as
    warmed entries. The grow's commits then copy into those replicas, so
    the first dispatch after the grow is a cache hit.

    The JAX package bakes from abstract shapes on a background thread and
    needs no double buffer. A CUDA graph reads concrete tensors, so this
    one takes the buffer whose grow will use them (`dbuf`); and it bakes
    inside poll(), on the serving thread: while a stream captures, the
    card refuses a device-wide synchronise from any other thread
    (cudaErrorStreamCaptureUnsupported), and the serving path makes one
    in every EagleRouter.update. That poll() stalls its serve() call by
    the bake's seconds (`dispatch_prebake_seconds_total`). join() is kept
    for the JAX package's callers: there is nothing left to wait for."""

    def __init__(self, dispatch: RouteDispatcher, db, *, dbuf,
                 watermark: float = 0.75,
                 batch_sizes: Optional[Sequence[int]] = None,
                 obs: Optional[OBS.Observability] = None):
        self.dispatch = dispatch
        self.db = db
        self.dbuf = dbuf
        self.watermark = watermark
        self.batch_sizes = batch_sizes
        self._baked = {db.capacity}
        #: capacity -> the storage of the two replicas baked for it
        #: (`replica()`: what the grown replicas' keys must be)
        self.prepared: Dict[int, Tuple] = {}
        self.obs = OBS.get_obs(obs)
        self._m_bakes = self.obs.registry.counter(
            "dispatch_prebake_total", "next-capacity bakes")
        self._m_bake_s = self.obs.registry.counter(
            "dispatch_prebake_seconds_total", "time spent prebaking")

    def poll(self) -> bool:
        """Post-commit hook: bake if the fill watermark is crossed and the
        next capacity isn't covered yet, and drop the graphs of replicas
        a grow freed (no capture follows a prebaked grow to do it).
        Returns whether it baked."""
        self.dispatch.evict_dead()
        if self.db.size < self.watermark * self.db.capacity:
            return False
        nxt = self.db.next_capacity()
        if nxt in self._baked:
            return False
        self._baked.add(nxt)
        self._bake(nxt, self.db.rcap)
        return True

    def join(self, timeout: Optional[float] = None):
        """The JAX package's wait for its bake thread; poll() baked."""

    def _bake(self, capacity: int, records: int):
        t0 = time.perf_counter()
        with self.obs.span("dispatch.prebake"):
            pair = self.dbuf.prepare(capacity, records)
            n = sum(self.dispatch.warmup(st, self.batch_sizes)
                    for st in pair)
        self.prepared[capacity] = tuple(replica(st) for st in pair)
        dt = time.perf_counter() - t0
        self._m_bakes.inc()
        self._m_bake_s.inc(dt)
        self.obs.emit({"kind": "dispatch_prebake", "capacity": capacity,
                       "records": records, "executables": n,
                       "seconds": dt})
