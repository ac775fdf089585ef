"""Serving dispatch: query bucketing over the routing path.

Ragged batches are padded to power-of-two BUCKETS (the same policy
elo._pad_bucket applies to record folds, with a smaller floor), so the
set of shapes the device sees is the bucket ladder, not the traffic.
Eager PyTorch compiles nothing per shape, but the ladder is what a
cache of captured CUDA graphs keys on, and `warmup()` runs one dispatch
per bucket so the first real request of any size finds the kernels
built and loaded. Batches past `max_bucket` are routed in ladder-sized
chunks.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import elo
from repro_torch.core.state import RouterState, route_batch_choices

#: default bucket ladder bounds (powers of two, inclusive)
MIN_BUCKET = 8
MAX_BUCKET = 1024


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


class RouteDispatcher:
    """Routes host query batches over a RouterState: bucket-pad, one pass
    of route_batch_choices, slice. One dispatcher per (routing config,
    costs) pair; states of any capacity flow through it."""

    def __init__(self, costs, *, p_global: float = 0.5,
                 n_neighbors: int = 20, k: float = 32.0,
                 backend: str = "cuda", mode: str = "combined",
                 init_rating: float = elo.DEFAULT_RATING,
                 min_bucket: int = MIN_BUCKET,
                 max_bucket: int = MAX_BUCKET):
        self.costs = costs
        self.kw = dict(p_global=float(p_global),
                       n_neighbors=int(n_neighbors), k=float(k),
                       backend=backend, mode=mode,
                       init_rating=float(init_rating))
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket

    @classmethod
    def for_router(cls, router, **kw) -> "RouteDispatcher":
        """Build from an EagleRouter's config (costs, mode, backend...)."""
        c = router.cfg
        return cls(router.costs, p_global=c.p_global,
                   n_neighbors=c.n_neighbors, k=c.k_factor,
                   backend=c.backend, mode=router.mode,
                   init_rating=c.init_rating, **kw)

    def bucket(self, n: int) -> int:
        return batch_bucket(n, self.min_bucket, self.max_bucket)

    def warmup(self, state: RouterState,
               batch_sizes: Optional[Sequence[int]] = None) -> int:
        """One dispatch per bucket of the ladder (or of `batch_sizes`), so
        the kernels are built and loaded before traffic. Returns the
        number of buckets run."""
        buckets = sorted({self.bucket(n) for n in batch_sizes}
                         if batch_sizes is not None
                         else bucket_ladder(self.min_bucket,
                                            self.max_bucket))
        budget = float(torch.as_tensor(self.costs).max())
        for qb in buckets:
            self.route(state, np.zeros((qb, state.dim), np.float32), budget)
        return len(buckets)

    def _chunks(self, nq: int):
        """(lo, hi) spans of at most max_bucket rows. Routing is
        row-independent, so an oversized batch is dispatched as
        ladder-sized chunks."""
        return [(lo, min(lo + self.max_bucket, nq))
                for lo in range(0, nq, self.max_bucket)]

    def _route_one(self, state: RouterState, q: np.ndarray, b: np.ndarray,
                   with_topk: bool):
        nq = q.shape[0]
        qb = self.bucket(nq)
        if qb != nq:
            q = np.pad(q, ((0, qb - nq), (0, 0)))
            b = np.pad(b, (0, qb - nq))
        res = route_batch_choices(state, torch.from_numpy(q).to(state.device),
                                  torch.from_numpy(b).to(state.device),
                                  self.costs, **self.kw)
        return (res.choices[:nq].cpu().numpy(),
                res.topk_idx[:nq].cpu().numpy() if with_topk else None)

    def _host_batch(self, query_embs, budgets):
        q = np.ascontiguousarray(np.atleast_2d(
            np.asarray(query_embs, np.float32)))
        b = np.broadcast_to(np.asarray(budgets, np.float32),
                            (q.shape[0],)).astype(np.float32)
        return q, b

    def _route(self, state, query_embs, budgets, with_topk: bool):
        q, b = self._host_batch(query_embs, budgets)
        parts = [self._route_one(state, q[lo:hi], b[lo:hi], with_topk)
                 for lo, hi in self._chunks(q.shape[0])] \
            or [self._route_one(state, q, b, with_topk)]
        return parts

    def route(self, state: RouterState, query_embs, budgets) -> np.ndarray:
        """Bucket-pad, route, slice. Returns host (Q,) int32 choices — the
        single readout of a routing step. Oversized batches are chunked."""
        parts = self._route(state, query_embs, budgets, with_topk=False)
        return np.concatenate([p[0] for p in parts])

    def route_result(self, state: RouterState, query_embs, budgets):
        """route() that also returns the retrieval trace: (choices (Q,),
        topk_idx (Q, n)) as host arrays."""
        parts = self._route(state, query_embs, budgets, with_topk=True)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
