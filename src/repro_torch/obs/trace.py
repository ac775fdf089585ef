"""Span tracer: low-overhead host-side timing of the serving hot path.

Design constraints (the JAX package's DESIGN.md §9):

  * spans must be cheap enough to leave on in production — a span is
    two `perf_counter_ns` calls plus ONE tuple store into a
    preallocated ring buffer (no allocation growth, no locks on the
    record path: slot indices come from an `itertools.count`, which is
    atomic under the GIL, and a slot write is a single STORE_SUBSCR);
  * the buffer is a RING: the tracer never grows and never blocks —
    old spans are overwritten and accounted in `dropped`;
  * clocks are monotonic (`time.perf_counter_ns`), so spans are
    orderable within the process even across NTP steps;
  * export is Chrome-trace JSON (the `traceEvents` "X" complete-event
    form), which chrome://tracing and Perfetto both load;
  * when `profiler=True`, every span also enters a
    `torch.profiler.record_function`, so host spans line up with the
    device timeline in a `torch.profiler` trace. `named_scope` is kept
    for the JAX package's call sites and is a no-op here: eager PyTorch
    has no traced program to tag.

A disabled tracer hands out a shared no-op span: the cost of an
instrumented region collapses to one attribute check + one call.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

from torch.profiler import record_function

# bound once: a span is on the route path (two a routed batch)
_clock = time.perf_counter_ns
_thread_id = threading.get_ident


def named_scope(name):
    """No-op: the JAX package tags traced ops with it."""
    return nullcontext()


#: ring-buffer record: (seq, name, t0_ns, dur_ns, thread_id, depth)
SpanRecord = Tuple[int, str, int, int, int, int]


class _NullSpan:
    """Shared do-nothing span handed out when tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "t0", "depth", "annot")

    def __init__(self, tracer: "SpanTracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        tr = self.tracer
        tls = tr._tls
        self.depth = depth = getattr(tls, "depth", 0)
        tls.depth = depth + 1
        if tr.profiler:
            self.annot = record_function(self.name)
            self.annot.__enter__()
        else:
            self.annot = None
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _clock()
        if self.annot is not None:
            self.annot.__exit__(None, None, None)
        tr = self.tracer
        tr._tls.depth = depth = self.depth
        seq = next(tr._seq)
        tr._slots[seq % tr.capacity] = (seq, self.name, self.t0, t1 - self.t0,
                                        _thread_id(), depth)
        return False


class SpanTracer:
    """Thread-safe span recorder over a preallocated ring buffer."""

    def __init__(self, capacity: int = 8192, profiler: bool = False):
        assert capacity > 0
        self.capacity = capacity
        self.profiler = profiler
        self.enabled = True
        self._slots: List[Optional[SpanRecord]] = [None] * capacity
        self._seq = itertools.count()
        self._tls = threading.local()

    # -- recording -----------------------------------------------------------
    def span(self, name: str):
        """Context manager timing a region; no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name)

    # -- accounting ----------------------------------------------------------
    @property
    def recorded(self) -> int:
        """Total spans ever closed (including overwritten ones). A slot
        is only ever overwritten by a HIGHER seq, so the max retained
        seq is the max completed seq — exact once writers quiesce,
        without touching the (lock-free) sequence counter."""
        seqs = [s[0] for s in self._slots if s is not None]
        return max(seqs) + 1 if seqs else 0

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.capacity)

    def spans(self) -> List[SpanRecord]:
        """Retained spans, oldest first (seq order). At most `capacity`;
        concurrent writers may tear the *set* of retained spans but
        never an individual record (slot writes are atomic stores)."""
        out = [s for s in self._slots if s is not None]
        out.sort(key=lambda s: s[0])
        return out

    def reset(self):
        self._slots = [None] * self.capacity
        self._seq = itertools.count()

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """Chrome-trace/Perfetto JSON object (complete "X" events, µs)."""
        pid = os.getpid()
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro_torch.obs"},
        }]
        for seq, name, t0, dur, tid, depth in self.spans():
            events.append({
                "name": name, "cat": "host", "ph": "X",
                "ts": t0 / 1e3, "dur": dur / 1e3,
                "pid": pid, "tid": tid,
                "args": {"seq": seq, "depth": depth},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def save_chrome_trace(self, path) -> str:
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path
