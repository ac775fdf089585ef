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
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
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


def init_state(n_models: int, dim: int, capacity: int = 4096,
               records_per_query: int = 8,
               init_rating: float = elo.DEFAULT_RATING,
               device: DeviceLike = None) -> RouterState:
    """Empty device state (no history)."""
    dev = resolve_device(device)
    rc = (capacity, records_per_query)
    return RouterState(
        global_ratings=torch.full((n_models,), init_rating,
                                  dtype=torch.float32, device=dev),
        emb=torch.zeros((capacity, dim), dtype=torch.float32, device=dev),
        model_a=torch.zeros(rc, dtype=torch.int32, device=dev),
        model_b=torch.zeros(rc, dtype=torch.int32, device=dev),
        outcome=torch.zeros(rc, dtype=torch.float32, device=dev),
        valid=torch.zeros(rc, dtype=torch.bool, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev))


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


def commit(db, global_ratings, prev: Optional[RouterState] = None,
           consumer: str = "default",
           device: DeviceLike = None) -> RouterState:
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
    `prev`."""
    rows = db.drain_dirty(consumer)
    dev = prev.device if prev is not None else resolve_device(device)
    if (prev is None or tuple(prev.emb.shape) != db.emb.shape
            or tuple(prev.model_a.shape) != db.model_a.shape):
        return state_from_buffer(db, global_ratings, dev)
    # rollback/clear guard: a drained row at/past the live count is
    # stale (its content is masked by `size` anyway) — drop it
    rows = rows[rows < db.size]
    if rows.size:
        idx = torch.as_tensor(rows.astype(np.int64), device=dev)
        for field in ("emb", "model_a", "model_b", "outcome", "valid"):
            host = getattr(db, field)[rows]
            getattr(prev, field).index_copy_(
                0, idx, torch.as_tensor(host, device=dev))
    prev.global_ratings.copy_(torch.as_tensor(global_ratings,
                                              dtype=torch.float32))
    prev.size.fill_(db.size)
    return prev


class DoubleBuffer:
    """Two device replicas of the router state over ONE host buffer, so a
    feedback commit never writes into the replica that routing reads.

    `front` serves every dispatch; `commit()` copies the BACK replica's
    dirty rows into it in place and swaps. Each replica keeps its own
    ledger (VectorDB consumers), so rows appended between a replica's
    commits reach it on its next turn. The copy runs on the current
    stream, so it is ordered after routing already enqueued there."""

    TAGS = ("dbuf_a", "dbuf_b")   # the replicas' dirty-row ledgers

    def __init__(self, db, global_ratings, device: DeviceLike = None):
        self.db = db
        dev = resolve_device(device)
        front, back = self.TAGS
        db.register_consumer(front)
        db.register_consumer(back)
        self._front = (commit(db, global_ratings, None, consumer=front,
                              device=dev), front)
        self._back = (commit(db, global_ratings, None, consumer=back,
                             device=dev), back)

    @property
    def front(self) -> RouterState:
        """The replica dispatches read. Valid until the SECOND next
        commit() (one swap keeps it as back, the next writes into it)."""
        return self._front[0]

    def commit(self, global_ratings) -> RouterState:
        """Absorb pending feedback into the back replica, swap, return the
        new front."""
        st, tag = self._back
        new = commit(self.db, global_ratings, st, consumer=tag)
        self._back, self._front = self._front, (new, tag)
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


def _queries(state: RouterState, q) -> torch.Tensor:
    q = torch.as_tensor(q, dtype=torch.float32, device=state.device)
    return q[None] if q.ndim == 1 else q


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _no_topk(state: RouterState, nq: int, n: int) -> torch.Tensor:
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


def _route(state: RouterState, q, budgets, costs, p_global, n_neighbors,
           k, backend, mode, init_rating):
    """Shared body of route_batch/route_batch_choices: retrieval + replay
    with the budget selection in the replay kernel's epilogue (the
    standalone select_within_budget stays as the parity oracle)."""
    _check_mode(mode)
    q = _queries(state, q)
    nq, m = q.shape[0], state.n_models
    n = min(n_neighbors, state.capacity)
    costs = torch.as_tensor(costs, dtype=torch.float32, device=state.device)
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=state.device).expand(nq)
    if mode == "global":
        # Eagle-Global ablation: no retrieval, selection is the whole op
        scores = state.global_ratings.expand(nq, m)
        choices, _ = select_within_budget(scores, costs, budgets)
        return choices.int(), scores, _no_topk(state, nq, n)
    if mode == "local":
        init = torch.full((m,), init_rating, dtype=torch.float32,
                          device=state.device)  # flat prior
        p = 0.0   # 0*Global + 1*Local == Local, bit-exact for finite r
    else:
        init = state.global_ratings
        p = p_global
    local, top_i, _, choices = KOPS.retrieve_replay_select(
        q, state.emb, state.model_a, state.model_b, state.outcome,
        state.valid, state.size, init, state.global_ratings, costs,
        budgets, n=n, k=k, p=p, backend=backend)
    scores = local if mode == "local" else \
        combine_scores(state.global_ratings, local, p_global)
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
    the choices and the retrieval trace (what the dispatcher reads)."""
    choices, _, top_i = _route(state, query_embs, budgets, costs, p_global,
                               n_neighbors, k, backend, mode, init_rating)
    return RouteChoices(choices, top_i)
