"""Eagle router: Global + Local ELO, budget-constrained selection.

The workflow of Fig. 1 / §2.2 of the paper:

  1. a query arrives with its prompt embedding;
  2. Eagle-Local retrieves the N most similar past prompts from the
     vector DB (cosine similarity) and replays their pairwise feedback
     through ELO, starting from the global ratings;
  3. Eagle-Global is the standing rating vector over all history;
  4. Score(X) = P * Global(X) + (1-P) * Local(X);
  5. the highest-scoring model with cost <= budget is selected;
  6. feedback is appended to the DB and folded into Global — the
     training-free online update.

EagleRouter is a thin stateful shell over core/state.py: writes
(fit/update/feedback) land in the host append buffer and the global
ratings and lazily commit into a device RouterState; reads
(scores/rank/route) are one pass of route_batch/batch_scores over it.
`feedback` is the instrumented write: the JAX package's counters, span
and quality-monitor hook.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch import obs as OBS
from repro_torch.core import elo
from repro_torch.core.state import (RouterState, RouteResult, batch_scores,
                                    combine_scores, commit, route_batch,
                                    select_within_budget)
from repro_torch.core.vectordb import VectorDB
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.retrieve_topn import check_neighbours

__all__ = ["EagleConfig", "EagleRouter", "GlobalOnlyRouter",
           "LocalOnlyRouter", "combine_scores", "select_within_budget"]


@dataclasses.dataclass(frozen=True)
class EagleConfig:
    """Paper Appendix A.1 parameters."""
    p_global: float = 0.5   # P: weight of the global score
    n_neighbors: int = 20   # N: local retrieval size
    k_factor: float = 32.0  # K: ELO sensitivity
    init_rating: float = elo.DEFAULT_RATING
    embed_dim: int = 256
    backend: str = "cuda"   # kernels.ops backend


class EagleRouter:
    """Online router over a fleet of models."""

    #: route_batch scoring mode; the Appendix B ablation subclasses
    #: override this (see core.state.MODES).
    mode = "combined"

    #: telemetry scope; None -> the module default (repro_torch.obs.DEFAULT).
    #: ServingEngine points this at its own scope.
    obs: Optional[OBS.Observability] = None

    #: optional router-quality monitor (obs/quality.py): when attached,
    #: every feedback fold feeds it the comparison outcomes and the
    #: post-fold rating vector (trajectories + drift detection).
    quality = None

    def __init__(self, model_names: Sequence[str], costs,
                 cfg: EagleConfig = EagleConfig(), db_capacity: int = 4096,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.backend == "cuda":
            check_neighbours(cfg.n_neighbors, self.device)
        self.model_names = list(model_names)
        self.n_models = len(model_names)
        self.costs = torch.as_tensor(costs, dtype=torch.float32,
                                     device=self.device)
        if self.costs.shape != (self.n_models,):
            raise ValueError(f"{self.n_models} models but costs of shape "
                             f"{tuple(self.costs.shape)}")
        self.global_ratings = torch.full((self.n_models,), cfg.init_rating,
                                         dtype=torch.float32,
                                         device=self.device)
        self.db = VectorDB(cfg.embed_dim, db_capacity, backend=cfg.backend)
        self._state: Optional[RouterState] = None
        self._stale = True
        # (ratings tensor, its host copy): the last readout of feedback
        self._host_copy = (None, None)

    # -- device state --------------------------------------------------------
    @property
    def state(self) -> RouterState:
        """Device snapshot of the router, recommitted lazily after writes
        (only dirty DB rows are uploaded). Valid until the next write:
        the following commit writes into its tensors in place."""
        if self._stale or self._state is None:
            self._state = commit(self.db, self.global_ratings, self._state,
                                 device=self.device)
            self._stale = False
        return self._state

    def _kw(self) -> Dict:
        c = self.cfg
        return dict(p_global=c.p_global, n_neighbors=c.n_neighbors,
                    k=c.k_factor, backend=c.backend, mode=self.mode,
                    init_rating=c.init_rating)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- state building ------------------------------------------------------
    def fit(self, embeddings, model_a, model_b, outcome,
            query_id=None) -> float:
        """Initialise from a feedback history. Returns wall seconds (the
        paper's Table 3a 'training time')."""
        t0 = time.perf_counter()
        self.db.add(embeddings, model_a, model_b, outcome, query_id)
        self.global_ratings = elo.fit_global(
            self.n_models, model_a, model_b, outcome, k=self.cfg.k_factor,
            init=self.cfg.init_rating, device=self.device)
        self._sync()
        self._stale = True
        return time.perf_counter() - t0

    def update(self, embeddings, model_a, model_b, outcome,
               query_id=None) -> float:
        """Incremental online update: O(new records), no retraining.
        With obs enabled, a `router.update` span holds one of each step:
        the DB's append (`.add`), the global fold's enqueue (`.fold`)
        and the synchronise (`.sync`)."""
        t0 = time.perf_counter()
        o = OBS.get_obs(self.obs)
        with o.span("router.update"):
            with o.span("router.update.add"):
                self.db.add(embeddings, model_a, model_b, outcome, query_id)
            with o.span("router.update.fold"):
                self.global_ratings = elo.update_global(
                    self.global_ratings, model_a, model_b, outcome,
                    k=self.cfg.k_factor)
            with o.span("router.update.sync"):
                self._sync()
        self._stale = True
        return time.perf_counter() - t0

    # -- scoring -------------------------------------------------------------
    def scores(self, query_emb) -> torch.Tensor:
        """(Q, M) combined quality scores (higher = better predicted)."""
        return batch_scores(self.state, query_emb, **self._kw())

    def rank(self, query_emb) -> torch.Tensor:
        """(Q, M) model indices, best first (stable on ties)."""
        return torch.argsort(-self.scores(query_emb), dim=-1, stable=True)

    def route_result(self, query_emb, budget) -> RouteResult:
        """Full routing step: (choices, scores, topk_idx)."""
        return route_batch(self.state, query_emb, budget, self.costs,
                           **self._kw())

    def route(self, query_emb, budget) -> torch.Tensor:
        """(Q,) selected model index per query under the budget."""
        return self.route_result(query_emb, budget).choices

    def local_ratings(self, query_emb) -> torch.Tensor:
        """(Q, M) Eagle-Local ratings (replay from the global prior)."""
        s = self.state
        q = torch.as_tensor(query_emb, dtype=torch.float32, device=s.device)
        q = q[None] if q.ndim == 1 else q
        local, _, _ = KOPS.retrieve_replay(
            q, s.emb, s.model_a, s.model_b, s.outcome, s.valid, s.size,
            s.global_ratings, n=min(self.cfg.n_neighbors, s.capacity),
            k=self.cfg.k_factor, backend=self.cfg.backend)
        return local

    # -- feedback loop (workflow step 6) ------------------------------------
    def _host_ratings(self) -> np.ndarray:
        """The global ratings on the host, copied once per rating vector:
        `update` and `fit` make a new tensor, so a vector read after the
        last fold is read again from the host."""
        held, host = self._host_copy
        if held is not self.global_ratings:
            host = self.global_ratings.cpu().numpy()
            self._host_copy = (self.global_ratings, host)
        return host

    def feedback(self, query_emb, chosen, opponent, outcome) -> float:
        """Record a user comparison between two served responses.

        Instrumented: the batch size lands in `router_feedback_total`,
        and, when obs is enabled, the update's magnitude (max |delta
        rating| of the global fold) in a histogram and the post-fold
        ratings in the attached quality monitor. Those readouts are host
        copies of M floats: the one before the fold is the previous
        fold's readout while the vector has not changed since (no copy,
        no synchronise), the one after it is taken after `update`'s own
        synchronise."""
        o = OBS.get_obs(self.obs)
        before = self._host_ratings() if o.enabled else None
        with o.span("router.feedback"):
            dt = self.update(query_emb, chosen, opponent, outcome)
        n = np.asarray(chosen).reshape(-1).size
        o.registry.counter("router_feedback_total",
                           "pairwise comparisons folded online").inc(n)
        if before is not None:
            after = self._host_ratings()
            mag = float(np.max(np.abs(after - before)))
            o.registry.histogram(
                "router_elo_update_magnitude",
                "max |delta global rating| per feedback fold",
                bounds=OBS.geometric_bounds(1e-3, 100.0, 1.5)).observe(mag)
            if self.quality is not None:
                # the monitor rides the same host readout: win-rate
                # accounting, then the post-fold trajectory and drift
                self.quality.observe_feedback(chosen, opponent, outcome,
                                              ratings=after)
        return dt


# ---------------------------------------------------------------------------
# Ablation variants (paper Appendix B)
# ---------------------------------------------------------------------------

class GlobalOnlyRouter(EagleRouter):
    """Eagle-Global: ignores the local module (P=1, retrieval skipped)."""
    mode = "global"


class LocalOnlyRouter(EagleRouter):
    """Eagle-Local only: local replay from a FLAT prior (no global info)."""
    mode = "local"
