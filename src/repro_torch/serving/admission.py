"""Admission & coalescing frontend for the serving engine: a copy of the
JAX package's `serving/admission.py` (DESIGN.md §10) over the port's
dispatcher, engine and obs. Host code only: no kernel and no JAX.

Online traffic arrives one request at a time; the serving hot path is
cheapest per request when it runs over FULL dispatch buckets
(core/dispatch.py's power-of-two ladder). This layer sits between
arrival and `ServingEngine.serve` and trades a bounded few milliseconds
of coalescing delay for full buckets and graceful overload behaviour:

  * `AdmissionQueue` coalesces arrivals into micro-batch windows with a
    DUAL flush trigger — flush as soon as the pending count reaches the
    configured dispatch-bucket boundary (`window_bucket`, snapped onto
    the same `batch_bucket` ladder the dispatcher pads to, so
    coalescing and dispatch share one shape universe), or
    when the oldest request's deadline slack is exhausted
    (per-request `deadline_ms`, capped by the `max_wait_ms` coalescing
    window);
  * flushes pop in PRIORITY order (higher `Request.priority` first,
    FIFO within a class) — under pressure low-priority traffic waits,
    it is not interleaved;
  * BACKPRESSURE is depth-watermarked: past `shed_watermark` pending
    requests, newly admitted traffic has its effective budget clamped
    to `shed_budget` (default 0.0 — the budget epilogue's
    cheapest-model fallback), so overload degrades to cheaper models
    and the service rate RISES instead of the queue growing without
    bound; only past `reject_cap` is a request refused, with a typed
    `Rejection` result;
  * the clock is injectable (`now_ns=`), so queue dynamics are
    deterministic under test and under the open-loop virtual-time
    harness (serving/traffic.py).

Telemetry (through the shared `repro_torch.obs` scope): queue-depth gauge,
queue-wait and end-to-end histograms, window-fill histogram,
shed/reject counters, per-reason flush counters, `admission.flush.*`
spans, and one `admission_flush` event per window.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch import obs as OBS
from repro_torch.core.dispatch import MAX_BUCKET, MIN_BUCKET, batch_bucket
from repro_torch.serving.engine import Request, Response

#: flush reasons (span suffix + `admission_flush_total{reason=}` label)
FLUSH_FULL = "full"          # pending count reached the window bucket
FLUSH_DEADLINE = "deadline"  # oldest request's deadline slack exhausted
FLUSH_DRAIN = "drain"        # explicit drain() (shutdown / end of run)


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed admission refusal: returned by submit() past the hard cap
    (the request was NOT enqueued)."""
    rid: int
    reason: str
    depth: int
    priority: int = 0


@dataclasses.dataclass
class Completed:
    """One served request with its queueing accounting attached."""
    response: Response
    wait_us: float       # arrival -> flush (queue wait)
    service_us: float    # the server-reported latency for this request
    flush_reason: str
    shed: bool           # budget was clamped by the overload watermark
    priority: int

    @property
    def rid(self) -> int:
        return self.response.rid

    @property
    def e2e_us(self) -> float:
        return self.wait_us + self.service_us


@dataclasses.dataclass
class FlushRecord:
    """One line of the flush ledger (always kept; one tuple per window).
    `requests` carries the exact flushed batch (post-clamp) when
    `keep_flushed_requests` is set — the replay/bit-identity hook."""
    reason: str
    n: int
    bucket: int
    t_ns: int
    depth_after: int
    requests: Optional[List[Request]] = None


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    window_bucket: int = 32        # flush-size trigger; snapped to the
                                   # dispatch bucket ladder, <= max_bucket
    max_wait_ms: float = 5.0       # coalescing window: max deadline slack
    shed_watermark: int = 128      # depth beyond which budgets clamp
    reject_cap: int = 512          # depth beyond which submit() rejects
    shed_budget: float = 0.0       # clamped effective budget (0.0 routes
                                   # to the cheapest-model fallback)
    min_bucket: int = MIN_BUCKET   # ladder bounds shared with dispatch
    max_bucket: int = MAX_BUCKET
    keep_flushed_requests: bool = False

    def __post_init__(self):
        assert math.isfinite(self.max_wait_ms) and self.max_wait_ms >= 0
        assert 0 < self.shed_watermark <= self.reject_cap
        wb = batch_bucket(self.window_bucket, self.min_bucket,
                          self.max_bucket)
        object.__setattr__(self, "window_bucket",
                           min(wb, self.max_bucket))


class _Entry:
    __slots__ = ("req", "arrival_ns", "deadline_ns", "priority", "shed",
                 "budget")

    def __init__(self, req: Request, arrival_ns: int, deadline_ns: int,
                 shed: bool, budget: float):
        self.req = req
        self.arrival_ns = arrival_ns
        self.deadline_ns = deadline_ns
        self.priority = req.priority
        self.shed = shed
        self.budget = budget


class AdmissionQueue:
    """Deadline-aware micro-batching in front of a `serve(requests) ->
    responses` callable (normally `ServingEngine.serve`).

    Single-owner: submit()/pump() are meant to be called from one
    serving thread (the engine's dispatch path is itself serial); the
    injectable `now_ns` clock makes every decision reproducible."""

    def __init__(self, serve: Callable[[Sequence[Request]], List[Response]],
                 cfg: Optional[AdmissionConfig] = None, *,
                 obs: Optional["OBS.Observability"] = None,
                 now_ns: Callable[[], int] = time.perf_counter_ns):
        self.serve = serve
        self.cfg = cfg or AdmissionConfig()
        self.now_ns = now_ns
        self._entries: Dict[int, _Entry] = {}
        self._order: Dict[int, deque] = {}   # priority -> FIFO of seqs
        self._deadlines: List = []           # heap of (deadline_ns, seq)
        self._seq = itertools.count()
        self.flush_log: List[FlushRecord] = []
        self.obs = OBS.get_obs(obs)
        r = self.obs.registry
        self._m_submitted = r.counter(
            "admission_submitted_total", "requests offered to the queue")
        self._m_shed = r.counter(
            "admission_shed_total",
            "requests admitted with the overload budget clamp")
        self._m_rejected = r.counter(
            "admission_rejected_total", "requests refused past the cap")
        self._m_flushed = r.counter(
            "admission_flushed_requests_total", "requests flushed to serve")
        self._m_deadline_miss = r.counter(
            "admission_deadline_miss_total",
            "completed requests whose e2e latency exceeded their own "
            "deadline (the SLO engine's goodput-complement signal)")
        self._m_flush = {
            reason: r.counter("admission_flush_total",
                              "coalescing windows flushed, by trigger",
                              reason=reason)
            for reason in (FLUSH_FULL, FLUSH_DEADLINE, FLUSH_DRAIN)}
        self._g_depth = r.gauge(
            "admission_queue_depth", "requests pending admission",
            fn=lambda: len(self._entries))
        self._h_wait = r.histogram(
            "admission_wait_us", "queue wait (arrival -> flush)")
        self._h_e2e = r.histogram(
            "admission_e2e_us", "end-to-end latency (wait + service)")
        self._h_fill = r.histogram(
            "admission_window_fill", "flushed requests / window bucket",
            bounds=[i / 16 for i in range(1, 17)])

    @classmethod
    def for_engine(cls, engine, *,
                   obs: Optional["OBS.Observability"] = None,
                   now_ns: Callable[[], int] = time.perf_counter_ns,
                   **cfg_kw) -> "AdmissionQueue":
        """Build in front of a ServingEngine, inheriting its telemetry
        scope and its dispatcher's bucket-ladder bounds, so coalescing
        windows land exactly on the warmed buckets."""
        cfg_kw.setdefault("min_bucket", engine.dispatch.min_bucket)
        cfg_kw.setdefault("max_bucket", engine.dispatch.max_bucket)
        return cls(engine.serve, AdmissionConfig(**cfg_kw),
                   obs=obs if obs is not None else engine.obs,
                   now_ns=now_ns)

    # -- intake --------------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self._entries)

    def submit(self, req: Request) -> Optional[Rejection]:
        """Offer one request. Returns None when admitted, or a typed
        `Rejection` past the hard depth cap. Past the shed watermark the
        request is admitted with its effective budget clamped to
        `shed_budget` (graceful degradation to cheaper models)."""
        self._m_submitted.inc()
        depth = len(self._entries)
        if depth >= self.cfg.reject_cap:
            self._m_rejected.inc()
            self.obs.emit({"kind": "admission_reject", "rid": req.rid,
                           "depth": depth, "priority": req.priority})
            return Rejection(req.rid, "queue_full", depth, req.priority)
        now = self.now_ns()
        arrival = req.arrival_ns or now
        slack_ms = min(req.deadline_ms, self.cfg.max_wait_ms)
        shed = depth >= self.cfg.shed_watermark
        budget = min(req.budget, self.cfg.shed_budget) if shed \
            else req.budget
        if shed:
            self._m_shed.inc()
        e = _Entry(req, arrival, arrival + int(slack_ms * 1e6), shed,
                   budget)
        seq = next(self._seq)
        self._entries[seq] = e
        dq = self._order.get(e.priority)
        if dq is None:
            dq = self._order[e.priority] = deque()
        dq.append(seq)
        heapq.heappush(self._deadlines, (e.deadline_ns, seq))
        return None

    # -- flush machinery -----------------------------------------------------
    def next_flush_ns(self) -> Optional[int]:
        """When the next flush is due: the current clock if the window
        is already full, else the earliest pending deadline, else None
        (empty queue). The open-loop driver schedules off this."""
        if not self._entries:
            return None
        if len(self._entries) >= self.cfg.window_bucket:
            return self.now_ns()
        while self._deadlines and self._deadlines[0][1] not in self._entries:
            heapq.heappop(self._deadlines)   # lazily drop flushed seqs
        return self._deadlines[0][0] if self._deadlines else None

    def flush_due(self, now_ns: Optional[int] = None) -> List[Completed]:
        """Flush AT MOST ONE window if a trigger fires; [] otherwise."""
        now = self.now_ns() if now_ns is None else now_ns
        if not self._entries:
            return []
        if len(self._entries) >= self.cfg.window_bucket:
            return self._flush(FLUSH_FULL, now)
        due = self.next_flush_ns()
        if due is None or due > now:
            return []
        return self._flush(FLUSH_DEADLINE, now)

    def pump(self, now_ns: Optional[int] = None) -> List[Completed]:
        """Flush windows until no trigger fires; the serving loop's main
        entry point."""
        out: List[Completed] = []
        while True:
            batch = self.flush_due(now_ns)
            if not batch:
                return out
            out.extend(batch)

    def drain(self, now_ns: Optional[int] = None) -> List[Completed]:
        """Flush everything regardless of triggers (shutdown)."""
        now = self.now_ns() if now_ns is None else now_ns
        out: List[Completed] = []
        while self._entries:
            out.extend(self._flush(FLUSH_DRAIN, now))
        return out

    def _flush(self, reason: str, now: int) -> List[Completed]:
        n = min(len(self._entries), self.cfg.window_bucket)
        picked: List[_Entry] = []
        for prio in sorted(self._order, reverse=True):
            dq = self._order[prio]
            while dq and len(picked) < n:
                e = self._entries.pop(dq.popleft(), None)
                if e is not None:
                    picked.append(e)
            if len(picked) == n:
                break
        bucket = batch_bucket(n, self.cfg.min_bucket, self.cfg.max_bucket)
        reqs = [dataclasses.replace(e.req, budget=e.budget)
                if e.budget != e.req.budget else e.req for e in picked]
        waits_us = [(now - e.arrival_ns) / 1e3 for e in picked]
        for w in waits_us:
            self._h_wait.observe(w)
        self._h_fill.observe(n / bucket)
        self._m_flush[reason].inc()
        self._m_flushed.inc(n)
        with self.obs.span(f"admission.flush.{reason}"):
            responses = self.serve(reqs)
        self.obs.emit({"kind": "admission_flush", "reason": reason,
                       "n": n, "bucket": bucket,
                       "depth": len(self._entries)})
        out = []
        for e, w, resp in zip(picked, waits_us, responses):
            svc_us = resp.latency_s * 1e6
            self._h_e2e.observe(w + svc_us)
            if w + svc_us > e.req.deadline_ms * 1e3:
                self._m_deadline_miss.inc()
            out.append(Completed(resp, w, svc_us, reason, e.shed,
                                 e.priority))
        self.flush_log.append(FlushRecord(
            reason, n, bucket, now, len(self._entries),
            reqs if self.cfg.keep_flushed_requests else None))
        return out

    # -- readout -------------------------------------------------------------
    def summary(self) -> Dict:
        return {
            "depth": len(self._entries),
            "submitted": int(self._m_submitted.value),
            "shed": int(self._m_shed.value),
            "rejected": int(self._m_rejected.value),
            "flushed": int(self._m_flushed.value),
            "flushes": {reason: int(c.value)
                        for reason, c in self._m_flush.items()},
        }
