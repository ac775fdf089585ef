"""Open-loop traffic harness for the admission frontend: a copy of the JAX
package's `serving/traffic.py` (DESIGN.md §10) over the port's admission
queue and engine. Host code only: no kernel and no JAX.

Three seeded, wall-clock-free arrival processes plus a discrete-event
driver:

  * `poisson_arrivals`  — memoryless open-loop traffic (exponential
    interarrivals at a target rate);
  * `burst_arrivals`    — Gamma-renewal arrivals: same mean rate, but an
    interarrival coefficient-of-variation > 1 produces clumps of
    back-to-back requests separated by long gaps (the ragged shape the
    coalescing window exists for);
  * `replay_arrivals` / `arrivals_from_decision_log` — replay recorded
    timestamps (e.g. the obs decision log's per-batch `ts`), optionally
    time-scaled to a different offered load.

`OpenLoopDriver` runs an `AdmissionQueue` over a VIRTUAL clock: arrivals
land at generator times, a single serial server flushes windows when the
queue's dual trigger fires (or as soon as it goes idle, if the trigger
fired while it was busy), and the clock advances by the server's
reported service time. Open-loop means arrivals never wait for the
server — offered load past capacity piles into the queue exactly as it
would in production, which is what exercises the shed/reject
watermarks. Everything is deterministic given the seeds: no sleeps, no
`time.time()`, no dates.

`SimServer` is a routing-real / generation-simulated backend: serve()
runs the REAL bucketed dispatch over a RouterState (so the routing
kernels, bucket padding and budget-epilogue routing are all live), and models generation as a cost-proportional service time —
cheap models are fast, which is precisely the property that makes
budget-clamp shedding raise the service rate under overload.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.admission import (AdmissionQueue, Completed,
                                          Rejection)
from repro_torch.serving.engine import Request, Response

ARRIVAL_KINDS = ("poisson", "burst")


# ---------------------------------------------------------------------------
# arrival processes (int64 nanosecond offsets from 0; seeded, Date-free)
# ---------------------------------------------------------------------------

def poisson_arrivals(rate_hz: float, n: int, seed: int = 0,
                     start_ns: int = 0) -> np.ndarray:
    """n Poisson-process arrival times at `rate_hz` (ns offsets)."""
    assert rate_hz > 0 and n > 0
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, n)
    return (start_ns + np.cumsum(gaps) * 1e9).astype(np.int64)

def burst_arrivals(rate_hz: float, n: int, seed: int = 0,
                   cv: float = 3.0, start_ns: int = 0) -> np.ndarray:
    """Gamma-renewal arrivals: mean rate `rate_hz`, interarrival
    coefficient of variation `cv` (cv=1 is Poisson; cv>1 is bursty)."""
    assert rate_hz > 0 and n > 0 and cv > 0
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    gaps = rng.gamma(shape, 1.0 / (rate_hz * shape), n)
    return (start_ns + np.cumsum(gaps) * 1e9).astype(np.int64)

def replay_arrivals(timestamps_s: Sequence[float], rate_scale: float = 1.0,
                    start_ns: int = 0) -> np.ndarray:
    """Arrival offsets replayed from recorded wall timestamps (seconds),
    re-based to 0 and optionally compressed: rate_scale=2 replays the
    trace at twice its recorded offered load."""
    t = np.sort(np.asarray(list(timestamps_s), np.float64))
    assert t.size > 0 and rate_scale > 0
    rel = (t - t[0]) / rate_scale
    return (start_ns + rel * 1e9).astype(np.int64)

def arrivals_from_decision_log(source: Union[str, Iterable[Dict]],
                               **kw) -> np.ndarray:
    """Replay the `ts` field of decision-log records (a JSONL path or an
    iterable of dicts, e.g. `obs.events.records("route")`)."""
    if isinstance(source, str):
        with open(source) as f:
            records: Iterable[Dict] = [json.loads(line) for line in f
                                       if line.strip()]
    else:
        records = source
    ts = [r["ts"] for r in records if "ts" in r]
    assert ts, "no 'ts' timestamps in the decision log"
    return replay_arrivals(ts, **kw)

def make_arrivals(kind: str, rate_hz: float, n: int, seed: int = 0,
                  **kw) -> np.ndarray:
    if kind == "poisson":
        return poisson_arrivals(rate_hz, n, seed=seed, **kw)
    if kind in ("burst", "gamma"):
        return burst_arrivals(rate_hz, n, seed=seed, **kw)
    raise ValueError(f"unknown arrival kind {kind!r} "
                     f"(expected one of {ARRIVAL_KINDS})")


# ---------------------------------------------------------------------------
# routing-real, generation-simulated backend
# ---------------------------------------------------------------------------

class SimServer:
    """serve()-compatible backend: real bucketed routing dispatch, and a
    deterministic cost-proportional generation model — one batch costs
    `base_us + per_cost_us * sum(cost of chosen model per request)`.
    Every request in a window reports the shared batch service time
    (a serial batch server, the engine's prefill+decode shape)."""

    def __init__(self, dispatch, state, model_names: Sequence[str], costs,
                 *, base_us: float = 400.0, per_cost_us: float = 150.0):
        self.dispatch = dispatch
        self.state = state
        self.model_names = list(model_names)
        self.costs = np.asarray(costs, np.float32)
        self.base_us = float(base_us)
        self.per_cost_us = float(per_cost_us)

    def batch_service_s(self, choices) -> float:
        return (self.base_us + self.per_cost_us
                * float(self.costs[np.asarray(choices)].sum())) * 1e-6

    def serve(self, requests: Sequence[Request]) -> List[Response]:
        if not len(requests):
            return []
        embs = np.stack([r.embedding for r in requests])
        budgets = np.asarray([r.budget for r in requests], np.float32)
        choices = self.dispatch.route(self.state, embs, budgets)
        svc_s = self.batch_service_s(choices)
        empty = np.empty(0, np.int32)
        return [Response(r.rid, self.model_names[int(c)], empty, svc_s)
                for r, c in zip(requests, choices)]


# ---------------------------------------------------------------------------
# discrete-event open-loop driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DriverResult:
    completed: List[Completed]
    rejections: List[Rejection]
    depth_series: List   # (t_ns, queue depth) sampled after each flush
    horizon_ns: int      # virtual time when the last event settled
    offered: int

    def wait_us(self) -> np.ndarray:
        return np.asarray([c.wait_us for c in self.completed], np.float64)

    def e2e_us(self) -> np.ndarray:
        return np.asarray([c.e2e_us for c in self.completed], np.float64)

    def goodput_hz(self, deadline_ms: float) -> float:
        """Completed requests that met the end-to-end deadline, per
        virtual second."""
        if not self.horizon_ns:
            return 0.0
        good = int((self.e2e_us() <= deadline_ms * 1e3).sum())
        return good / (self.horizon_ns / 1e9)


class OpenLoopDriver:
    """Single-server discrete-event loop binding an arrival trace to an
    AdmissionQueue. Takes ownership of the queue's clock. `service_model`
    maps one flushed window to its service duration in seconds; the
    default trusts the server's reported per-request latency (each
    request in a window reports its own batch's service, so the max over
    the window is that batch's wall time)."""

    def __init__(self, queue: AdmissionQueue, requests: Sequence[Request],
                 arrivals_ns, service_model: Optional[
                     Callable[[List[Completed]], float]] = None):
        assert len(requests) == len(arrivals_ns)
        self.queue = queue
        self.requests = list(requests)
        self.arrivals = np.asarray(arrivals_ns, np.int64)
        assert (np.diff(self.arrivals) >= 0).all(), "arrivals not sorted"
        self.service_model = service_model or (
            lambda batch: max(c.service_us for c in batch) * 1e-6)
        self._t = int(self.arrivals[0]) if len(self.arrivals) else 0
        queue.now_ns = lambda: self._t

    def run(self) -> DriverResult:
        t, busy_until, i, n = self._t, 0, 0, len(self.requests)
        completed: List[Completed] = []
        rejections: List[Rejection] = []
        depth_series: List = []
        q = self.queue
        while i < n or q.depth:
            due = q.next_flush_ns()
            nxt = int(self.arrivals[i]) if i < n else None
            flush_at = None if due is None else max(due, busy_until)
            if flush_at is None or (nxt is not None and nxt <= flush_at):
                self._t = t = nxt
                rej = q.submit(self.requests[i])
                if rej is not None:
                    rejections.append(rej)
                i += 1
            else:
                self._t = t = flush_at
                batch = q.flush_due()
                assert batch, "flush was due but produced no window"
                completed.extend(batch)
                busy_until = t + int(self.service_model(batch) * 1e9)
                depth_series.append((t, q.depth))
        return DriverResult(completed, rejections, depth_series,
                            max(t, busy_until), n)
