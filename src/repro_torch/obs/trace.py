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
    device timeline in a `torch.profiler` trace;
  * the export's `ts` is on torch.profiler's time base (epoch µs less
    its trace's `baseTimeNanoseconds`), converted from `perf_counter_ns`
    through one (perf_counter_ns, time_ns) pair taken when the tracer
    is made or reset, so a scrape lays over a device trace;
  * a DEVICE span (`device_span`) times a region on the card's own
    clock: a timing event on the current stream at enter and at exit,
    from a pool the tracer reuses. Nothing synchronises for it: it is
    written to the ring once its end event has completed, found at the
    next span's exit or device span's enter on the recording thread,
    and `spans()` waits for what is still pending. A route's device
    span is so written when its readout's span closes, and a scrape
    from another thread finds nothing pending: it makes no CUDA call
    that could break a capture on the serving thread. Its record has
    the host's time at enter as `t0`, the events' elapsed time as
    `dur`, and `-1 - device index` as its thread (the export's track of
    that device). It records nothing on the CPU or while the current
    stream captures a CUDA graph.

A disabled tracer hands out a shared no-op span: the cost of an
instrumented region collapses to one attribute check + one call.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

# bound once: a span is on the route path (five a routed batch)
_clock = time.perf_counter_ns
_thread_id = threading.get_ident

#: libkineto's ChromeTraceBaseTime floors the epoch to this many seconds:
#: torch.profiler's Chrome trace writes `ts` relative to that base
_PROFILER_BASE_S = 7889238


def profiler_base_ns(epoch_ns: int) -> int:
    """torch.profiler's time base at `epoch_ns` (its trace's
    `baseTimeNanoseconds`): epoch µs in its trace are `ts` plus it."""
    s = epoch_ns // 1_000_000_000
    return s // _PROFILER_BASE_S * _PROFILER_BASE_S * 1_000_000_000


#: ring-buffer record: (seq, name, t0_ns, dur_ns, thread_id, depth); a
#: device span's thread_id is -1 - its device's index
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
        if tr._pending:
            tr._resolve(block=False)
        return False


class _DeviceSpan:
    __slots__ = ("tracer", "name", "dev", "stream", "t0", "depth", "ev")

    def __init__(self, tracer: "SpanTracer", name: str, dev: int):
        self.tracer = tracer
        self.name = name
        self.dev = dev

    def __enter__(self):
        tr = self.tracer
        tr._resolve(block=False)
        self.depth = getattr(tr._tls, "depth", 0)
        self.stream = torch.cuda.current_stream(self.dev)
        try:
            self.ev = tr._free.setdefault(self.dev, []).pop()
        except IndexError:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        self.t0 = _clock()
        self.ev[0].record(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.ev[1].record(self.stream)
        self.tracer._pending.append((self.name, self.t0, self.depth,
                                     self.dev) + self.ev)
        return False


class SpanTracer:
    """Thread-safe span recorder over a preallocated ring buffer."""

    def __init__(self, capacity: int = 8192, profiler: bool = False):
        assert capacity > 0
        self.capacity = capacity
        self.profiler = profiler
        self.enabled = True
        self._tls = threading.local()
        #: device spans whose end event may not have completed, oldest
        #: first: (name, t0, depth, device, start event, end event)
        self._pending: collections.deque = collections.deque()
        #: device index -> reusable (start, end) event pairs
        self._free: Dict[int, list] = {}
        self._resolving = threading.Lock()
        self.reset()

    # -- recording -----------------------------------------------------------
    def span(self, name: str):
        """Context manager timing a region; no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name)

    def device_span(self, name: str, device: torch.device):
        """Context manager timing a region on the card's clock: the work
        the host enqueues inside it on `device`'s current stream. A no-op
        when disabled, on a CPU device, or while the current stream
        captures."""
        if not self.enabled or device.type != "cuda" or \
                torch.cuda.is_current_stream_capturing():
            return NULL_SPAN
        index = device.index
        return _DeviceSpan(self, name, torch.cuda.current_device()
                           if index is None else index)

    def _resolve(self, block: bool):
        """Write the pending device spans whose end event has completed
        (all of them, waiting for each, when `block`) into the ring, and
        give their events back to the pool."""
        pending = self._pending
        if not pending:
            return
        with self._resolving:
            while pending:
                name, t0, depth, dev, start, end = pending[0]
                if block:
                    end.synchronize()
                elif not end.query():
                    return
                pending.popleft()
                dur = int(start.elapsed_time(end) * 1e6)
                seq = next(self._seq)
                self._slots[seq % self.capacity] = (seq, name, t0, dur,
                                                    -1 - dev, depth)
                self._free.setdefault(dev, []).append((start, end))

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
        """Retained spans, oldest first (seq order: a device span's is
        taken when it is resolved), the pending device spans resolved
        first. At most `capacity`; concurrent writers may tear the *set*
        of retained spans but never an individual record (slot writes
        are atomic stores)."""
        self._resolve(block=True)
        out = [s for s in self._slots if s is not None]
        out.sort(key=lambda s: s[0])
        return out

    def reset(self):
        """Empty the ring (pending device spans dropped) and take the
        export's clock pair anew."""
        self._slots: List[Optional[SpanRecord]] = [None] * self.capacity
        self._seq = itertools.count()
        with self._resolving:
            while self._pending:
                _, _, _, dev, start, end = self._pending.popleft()
                self._free.setdefault(dev, []).append((start, end))
        perf, epoch = _clock(), time.time_ns()
        #: perf_counter_ns + this = ns on torch.profiler's time base
        self._to_profiler_ns = epoch - profiler_base_ns(epoch) - perf

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """Chrome-trace/Perfetto JSON object (complete "X" events, µs on
        torch.profiler's time base); device spans on a track (tid) of
        their device's."""
        pid = os.getpid()
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro_torch.obs"},
        }]
        off = self._to_profiler_ns
        tracks = set()
        for seq, name, t0, dur, tid, depth in self.spans():
            if tid < 0:
                tracks.add(tid)
            events.append({
                "name": name, "cat": "device" if tid < 0 else "host",
                "ph": "X", "ts": (t0 + off) / 1e3, "dur": dur / 1e3,
                "pid": pid, "tid": tid,
                "args": {"seq": seq, "depth": depth},
            })
        events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                    "args": {"name": f"cuda:{-1 - t} (device clock)"}}
                   for t in sorted(tracks)]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def save_chrome_trace(self, path) -> str:
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path
