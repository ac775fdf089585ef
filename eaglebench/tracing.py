"""The traced slice of a run: `torch.profiler` (CPU and CUDA activities)
over the last part of the window, exported as a Chrome trace and read
back from it.

The harness marks each piece of its own work on the profiler's timeline
(`mark`: "eb.route", "eb.feedback", "eb.wait"); with obs
enabled the program's spans appear there too ("dispatch.route",
"state.commit", ...). From the trace come the device's busy time (the
union of its kernels, copies and fills), the idle gaps labelled by the
innermost host mark open at each gap's middle, and the device time by
kernel name.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation",)


@dataclasses.dataclass
class Event:
    name: str
    ts: float      # us, the profiler's clock
    dur: float     # us

    @property
    def end(self) -> float:
        return self.ts + self.dur


def mark(on: bool, name: str):
    """A host mark on the profiler's timeline (a no-op when not traced)."""
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


def profiler(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


@dataclasses.dataclass
class Slice:
    """What the traced slice holds: the device's events and the host's
    marks, in time order, and the slice's span on the profiler's clock
    (the first harness mark's start to the last one's end)."""
    device: List[Event]
    host: List[Event]
    t0: float
    t1: float
    _starts: List[float] = dataclasses.field(default_factory=list)
    _host_starts: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.device.sort(key=lambda e: e.ts)
        self.host.sort(key=lambda e: e.ts)
        self._starts = [e.ts for e in self.device]
        self._host_starts = [e.ts for e in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def marks(self, name: str) -> List[Event]:
        return [e for e in self.host if e.name == name]

    def device_in(self, t0: float, t1: float) -> List[Event]:
        """Device events that start within [t0, t1]."""
        lo = bisect.bisect_left(self._starts, t0)
        hi = bisect.bisect_right(self._starts, t1)
        return self.device[lo:hi]

    def busy_intervals(self):
        """The union of the device events inside the slice."""
        out = []
        for e in self.device:
            a, b = max(e.ts, self.t0), min(e.end, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def _label(self, t: float) -> str:
        """The innermost host mark open at t ("host.other" if none): the
        marks of one thread nest, so it is the latest-starting one that
        covers t."""
        i = bisect.bisect_right(self._host_starts, t)
        for e in reversed(self.host[max(0, i - 64):i]):
            if e.end >= t:
                return e.name
        return "host.other"

    def idle_by_host(self) -> Dict[str, float]:
        """Seconds the device idled in the slice, by what the host was
        doing at each gap's middle."""
        out: Dict[str, float] = defaultdict(float)
        t = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > t:
                out[self._label((t + a) / 2)] += (a - t) / 1e6
            t = max(t, b)
        return dict(out)

    def device_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            if e.ts >= self.t0 and e.end <= self.t1:
                out[e.name[:120]] += e.dur / 1e6
        return dict(out)

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time, and the ten
        host marks under which the device idled longest: [name, seconds]."""
        return {"device_ops": _top(self.device_by_name()),
                "idle_gaps": _top(self.idle_by_host())}


def _top(d: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def read_slice(path: Path, harness_prefix: str = "eb.") -> Optional[Slice]:
    """The slice from an exported Chrome trace (None when the harness
    marked nothing in it)."""
    with open(path) as f:
        raw = json.load(f)
    dev, host = [], []
    for e in raw.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        ev = Event(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)))
        if e.get("cat") in DEVICE_CATS:
            dev.append(ev)
        elif e.get("cat") in HOST_CATS:
            host.append(ev)
    ours = [e for e in host if e.name.startswith(harness_prefix)]
    if not ours:
        return None
    return Slice(dev, host, min(e.ts for e in ours),
                 max(e.end for e in ours))
