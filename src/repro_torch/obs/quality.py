"""Router-quality monitors: ELO trajectories, online routing regret,
and drift alerting over the live decision/feedback stream (DESIGN.md §11).
A copy of the JAX package's `obs/quality.py`; the port's router holds its
ratings and costs on the card, so `for_router` copies them to the host
once, and every array the monitor keeps is a host array.

The serving substrate records *what* the router did (decision log) and
*how fast* (spans/metrics); nothing so far watched whether it keeps
routing *well* as ratings drift under online feedback — the exact
failure mode RouteLLM (Ong et al., 2024) documents under distribution
shift. `RouterQualityMonitor` closes that loop on the host, with zero
device work:

  * **ELO trajectories** — every rating vector the feedback leg
    produces lands in a per-model ring buffer (bounded; one deque
    append per model per fold) and a `quality_rating{model=}` gauge,
    so `/metrics` shows the standing ratings and `snapshot()` the
    recent path;
  * **routing regret** — per routed request, the gap between the best
    feasible model under the request's budget and the chosen model:

        regret_i = max_{m : cost_m <= budget_i} r[m]   - r[choice_i]
                   (cheapest-model fallback when nothing is feasible,
                    mirroring the fused budget epilogue bit for bit)

    Choices made before a feedback fold are scored post-hoc against
    the ratings that fold produced, so regret rises exactly when the
    router's decisions lag the rating drift. Everything involved —
    ratings, costs, budgets, choices — is a host-side input/output of
    `route_batch_choices`, so the estimate is EXACT, not sampled:
    `routing_regret` (vectorized) and `routing_regret_oracle`
    (brute-force loops) must agree bit for bit (the tests and
    chip_smoke.py's quality gate enforce bitwise equality).

    Scoring is DEFERRED off the hot path (the emit_columns idiom):
    `observe_batch` appends two array refs and bumps one counter —
    O(1) regardless of batch size — and the pending batches are scored
    in bulk at the next feedback fold (`observe_ratings`), at any
    readout (`snapshot`/`selection_share`/`win_rate`), or when
    `max_pending` batches accumulate, whichever comes first;
  * **win-rate / selection-share** — per-model counters from the
    decision and feedback streams, exposed as gauges at snapshot time;
  * **drift detectors** — EWMA mean/variance z-score detectors on each
    model's rating and on batch-mean regret; beyond `z_threshold` they
    emit a typed `quality_alert` event into the `EventLog` and bump
    `quality_alerts_total{kind=}`.

Gating contract: the monitor is OPT-IN (engine/router hold `None` by
default) and its observe_* hooks are called from the serving path only
when `Observability.enabled` is on — the hot-path cost when attached is
a few numpy ops per BATCH, inside the <5% budget chip_smoke.py's obs
gate enforces with the monitor attached.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs as OBS

__all__ = ["QualityConfig", "DriftDetector", "RouterQualityMonitor",
           "routing_regret", "routing_regret_oracle"]


# ---------------------------------------------------------------------------
# routing regret: exact host mirror of the fused budget epilogue
# ---------------------------------------------------------------------------

def routing_regret(ratings, costs, budgets, choices) -> np.ndarray:
    """(B,) per-request routing regret under the given rating vector.

    Feasibility (`cost <= budget`) and the cheapest-model fallback
    mirror `select_within_budget`; the best feasible score is compared
    against the chosen model's score. All float64 host math — the
    brute-force oracle below performs the identical operations in the
    identical order, so the two are bitwise equal."""
    r = np.asarray(ratings, np.float64)
    c = np.asarray(costs, np.float64)
    b = np.asarray(budgets, np.float64).reshape(-1)
    ch = np.asarray(choices, np.int64).reshape(-1)
    feasible = c[None, :] <= b[:, None]
    masked = np.where(feasible, r[None, :], -np.inf)
    best = masked.max(axis=1)
    cheapest = int(np.argmin(c))
    best = np.where(feasible.any(axis=1), best, r[cheapest])
    return best - r[ch]


def routing_regret_oracle(ratings, costs, budgets, choices) -> np.ndarray:
    """Brute-force reference: pure-python loops over models, same
    float64 ops as `routing_regret` (chip_smoke.py's quality gate asserts
    bit-for-bit agreement on a seeded 500-step decision log on the
    card)."""
    r = np.asarray(ratings, np.float64)
    c = np.asarray(costs, np.float64)
    b = np.asarray(budgets, np.float64).reshape(-1)
    ch = np.asarray(choices, np.int64).reshape(-1)
    cheapest = int(np.argmin(c))
    out = np.empty(len(b), np.float64)
    for i in range(len(b)):
        best = -np.inf
        any_ok = False
        for m in range(len(c)):
            if c[m] <= b[i]:
                any_ok = True
                if r[m] > best:
                    best = r[m]
        if not any_ok:
            best = r[cheapest]
        out[i] = best - r[ch[i]]
    return out


# ---------------------------------------------------------------------------
# EWMA z-score drift detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QualityConfig:
    window: int = 256          # ring length of each rating trajectory
    ewma_alpha: float = 0.05   # EWMA smoothing for mean/variance
    z_threshold: float = 6.0   # |z| beyond which a detector fires
    min_samples: int = 32      # observations before a detector may fire
    min_std: float = 1e-6      # variance floor (flat series never fire
                               # on numerical dust)
    max_pending: int = 256     # unscored batches before an inline flush


class DriftDetector:
    """Streaming EWMA mean/variance z-score detector.

    `update(x)` returns the z-score when the new observation deviates
    from the running EWMA mean by more than `z_threshold` standard
    deviations (after `min_samples` warmup observations), else None;
    the observation is folded into the EWMA either way, so a genuine
    level shift fires once and the detector re-adapts instead of
    alarming forever. Stationary noise keeps |z| small: at the default
    threshold the per-step false-positive rate is negligible (the
    quality gate runs a seeded stationary trace and requires
    exactly zero alerts)."""

    __slots__ = ("alpha", "z_threshold", "min_samples", "min_std",
                 "mean", "var", "n", "_m2")

    def __init__(self, alpha: float = 0.05, z_threshold: float = 6.0,
                 min_samples: int = 32, min_std: float = 1e-6):
        assert 0 < alpha <= 1 and z_threshold > 0 and min_samples >= 2
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.min_samples = min_samples
        self.min_std = min_std
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self._m2 = 0.0   # Welford sum of squared deviations (warmup)

    def update(self, x: float) -> Optional[float]:
        x = float(x)
        fired: Optional[float] = None
        if self.n >= self.min_samples:
            std = max(math.sqrt(self.var), self.min_std)
            z = (x - self.mean) / std
            if abs(z) > self.z_threshold:
                fired = z
            d = x - self.mean
            self.mean += self.alpha * d
            # EWMA of squared deviation around the (pre-update) mean
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * d * d)
        else:
            # Welford warmup: the first min_samples observations seed
            # the EWMA with their SAMPLE mean/variance, so the detector
            # opens with a calibrated scale instead of growing variance
            # from zero (which would make the first post-warmup steps
            # spuriously significant)
            d = x - self.mean
            self.mean += d / (self.n + 1)
            self._m2 += d * (x - self.mean)
            if self.n + 1 == self.min_samples:
                self.var = self._m2 / max(self.n, 1)
        self.n += 1
        return fired


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

class RouterQualityMonitor:
    """Consumes the per-request decision stream and the feedback leg's
    rating folds; maintains trajectories, regret, shares, and drift
    alarms on one `Observability` scope."""

    def __init__(self, model_names: Sequence[str], costs, ratings, *,
                 cfg: QualityConfig = QualityConfig(),
                 obs: Optional["OBS.Observability"] = None,
                 sinks: Sequence = ()):
        self.model_names = list(model_names)
        self.costs = np.asarray(costs, np.float64)
        self.ratings = np.asarray(ratings, np.float64).copy()
        assert self.costs.shape == self.ratings.shape == \
            (len(self.model_names),)
        self.cfg = cfg
        self.obs = OBS.get_obs(obs)
        # push delivery for drift alerts (obs.alerts): every _alert
        # payload fans out to the registered sinks, error-isolated
        from repro_torch.obs.alerts import AlertSinkHub
        self.sinks = AlertSinkHub(sinks, obs=self.obs)
        self.trajectories: Dict[str, deque] = {
            m: deque(maxlen=cfg.window) for m in self.model_names}
        self._rating_detectors = [
            DriftDetector(cfg.ewma_alpha, cfg.z_threshold,
                          cfg.min_samples, cfg.min_std)
            for _ in self.model_names]
        self._regret_detector = DriftDetector(
            cfg.ewma_alpha, cfg.z_threshold, cfg.min_samples, cfg.min_std)
        self._fold_seq = 0
        # unscored (budgets, choices) batches; two refs per serve step,
        # scored in bulk at the next fold/readout/flush
        self._pending: List = []
        self._pending_lock = threading.Lock()
        # one scorer at a time: the exporter thread's readouts flush
        # beside the feedback leg's, and the regret detector's update
        # is a read-modify-write
        self._score_lock = threading.Lock()
        r = self.obs.registry
        self._m_decisions = r.counter(
            "quality_decisions_total", "requests the monitor scored")
        self._m_selected = {
            m: r.counter("quality_selected_total",
                         "routed selections per model", model=m)
            for m in self.model_names}
        self._m_wins = {
            m: r.counter("quality_win_total",
                         "pairwise feedback wins per model", model=m)
            for m in self.model_names}
        self._m_cmp = {
            m: r.counter("quality_comparisons_total",
                         "pairwise feedback appearances per model",
                         model=m)
            for m in self.model_names}
        self._g_rating = {
            m: r.gauge("quality_rating", "last observed ELO rating",
                       model=m)
            for m in self.model_names}
        self._m_regret_sum = r.counter(
            "quality_regret_sum", "cumulative routing regret (rating pts)")
        self._g_regret = r.gauge(
            "quality_regret_last", "mean routing regret of the last batch")
        self._h_regret = r.histogram(
            "quality_regret", "per-request routing regret (rating pts)",
            bounds=OBS.geometric_bounds(0.25, 2048.0, 2.0))
        self._m_alerts = {
            kind: r.counter("quality_alerts_total",
                            "drift alerts fired, by kind", kind=kind)
            for kind in ("rating_drift", "regret_drift")}
        for i, m in enumerate(self.model_names):
            self._g_rating[m].set(float(self.ratings[i]))

    @classmethod
    def for_router(cls, router, *, cfg: QualityConfig = QualityConfig(),
                   obs: Optional["OBS.Observability"] = None,
                   attach: bool = True,
                   sinks: Sequence = ()) -> "RouterQualityMonitor":
        """Build from an EagleRouter (names/costs/current ratings) and,
        by default, attach so the feedback leg feeds the monitor. The
        router's costs and ratings are device tensors: they are copied
        to the host here, on the caller's thread."""
        mon = cls(router.model_names, router.costs.cpu().numpy(),
                  router.global_ratings.cpu().numpy(),
                  cfg=cfg, obs=obs if obs is not None
                  else OBS.get_obs(router.obs), sinks=sinks)
        if attach:
            router.quality = mon
        return mon

    # -- alerting ------------------------------------------------------------
    def _alert(self, kind: str, z: float, value: float, **extra):
        # counter always on (§9: metrics ungated); the typed event rides
        # the gated emit path like every other event
        self._m_alerts[kind].inc()
        payload = {"kind": "quality_alert", "alert": kind,
                   "z": float(z), "value": float(value),
                   "fold": self._fold_seq, **extra}
        self.obs.emit(payload)
        # push delivery: sink failures are isolated inside the hub —
        # this runs on the feedback-fold path and must never raise
        self.sinks.deliver(payload)

    @property
    def alerts_fired(self) -> int:
        return int(sum(c.value for c in self._m_alerts.values()))

    # -- observation hooks ---------------------------------------------------
    def observe_ratings(self, ratings) -> None:
        """One rating vector from a feedback fold: sync the monitor's
        ratings, score any pending decision batches against the POST-
        fold vector (regret rises when decisions lag the drift), extend
        trajectories, and run the per-model drift detectors."""
        r = np.asarray(ratings, np.float64)
        self._fold_seq += 1
        self.ratings = r.copy()
        self.flush()
        for i, m in enumerate(self.model_names):
            x = float(r[i])
            self.trajectories[m].append((self._fold_seq, x))
            self._g_rating[m].set(x)
            z = self._rating_detectors[i].update(x)
            if z is not None:
                self._alert("rating_drift", z, x, model=m)

    def observe_batch(self, budgets, choices) -> None:
        """One routed batch from the serving hot path: O(1) — two array
        refs appended + one counter; scoring is deferred to the next
        fold/readout (`flush`). This is what keeps the attached monitor
        inside the <5% overhead budget at any batch size."""
        self._m_decisions.inc(len(choices))
        with self._pending_lock:
            # the refs as given (the int64 view is taken at the flush)
            self._pending.append((budgets, choices))
            overflow = len(self._pending) >= self.cfg.max_pending
        if overflow:
            self.flush()

    def score_batch(self, budgets, choices) -> np.ndarray:
        """Eager variant: fold one batch immediately and return its (B,)
        regret vector (the quality gate cross-checks this against the
        brute-force oracle)."""
        ch = np.asarray(choices, np.int64).reshape(-1)
        regret = routing_regret(self.ratings, self.costs, budgets, ch)
        self._m_decisions.inc(len(ch))
        with self._score_lock:
            self._fold_batch(ch, regret)
        return regret

    def flush(self) -> int:
        """Score all pending batches against the current rating vector;
        returns the number of batches folded. Called from feedback
        folds, readouts, and the max_pending overflow guard — never
        from the route hot path."""
        with self._score_lock:
            with self._pending_lock:
                pending, self._pending = self._pending, []
            for budgets, choices in pending:
                ch = np.asarray(choices, np.int64).reshape(-1)
                self._fold_batch(
                    ch, routing_regret(self.ratings, self.costs, budgets,
                                       ch))
        return len(pending)

    def _fold_batch(self, ch: np.ndarray, regret: np.ndarray) -> None:
        """Land one scored batch in the metrics + the regret detector."""
        for mi, cnt in enumerate(np.bincount(
                ch, minlength=len(self.model_names))):
            if cnt:
                self._m_selected[self.model_names[mi]].inc(int(cnt))
        self._h_regret.observe_many(regret)
        total = float(regret.sum())
        self._m_regret_sum.inc(total)
        mean = total / len(regret) if len(regret) else 0.0
        self._g_regret.set(mean)
        z = self._regret_detector.update(mean)
        if z is not None:
            self._alert("regret_drift", z, mean)

    def observe_feedback(self, chosen, opponent, outcome,
                         ratings=None) -> None:
        """One pairwise-comparison batch from the router's feedback leg:
        win-rate accounting, then (optionally) the post-fold ratings."""
        a = np.asarray(chosen, np.int64).reshape(-1)
        b = np.asarray(opponent, np.int64).reshape(-1)
        s = np.asarray(outcome, np.float64).reshape(-1)
        for ai, bi, si in zip(a, b, s):
            self._m_cmp[self.model_names[int(ai)]].inc()
            self._m_cmp[self.model_names[int(bi)]].inc()
            if si > 0.5:
                self._m_wins[self.model_names[int(ai)]].inc()
            elif si < 0.5:
                self._m_wins[self.model_names[int(bi)]].inc()
        if ratings is not None:
            self.observe_ratings(ratings)

    # -- readout -------------------------------------------------------------
    def selection_share(self) -> Dict[str, float]:
        self.flush()
        total = self._m_decisions.value
        return {m: (self._m_selected[m].value / total if total else 0.0)
                for m in self.model_names}

    def win_rate(self) -> Dict[str, float]:
        out = {}
        for m in self.model_names:
            n = self._m_cmp[m].value
            out[m] = self._m_wins[m].value / n if n else math.nan
        return out

    def snapshot(self) -> Dict:
        """Quality snapshot for `/quality` and `/slo`-adjacent
        readouts."""
        self.flush()
        h = self._h_regret
        return {
            "decisions": int(self._m_decisions.value),
            "feedback_folds": self._fold_seq,
            "ratings": {m: float(self.ratings[i])
                        for i, m in enumerate(self.model_names)},
            "selection_share": self.selection_share(),
            "win_rate": self.win_rate(),
            "regret": {
                "sum": float(self._m_regret_sum.value),
                "last_batch_mean": float(self._g_regret.value),
                "mean": h.mean, "p50": h.quantile(0.50),
                "p99": h.quantile(0.99), "count": h.count,
            },
            "alerts": {kind: int(c.value)
                       for kind, c in self._m_alerts.items()},
            "trajectory_tail": {
                m: list(self.trajectories[m])[-8:]
                for m in self.model_names},
        }
