"""Metrics registry: counters, gauges, and fixed-bucket histograms.

The registry is the typed replacement for ad-hoc `stats` dicts across
the serving path. Metrics are identified by (name, sorted label pairs);
handles are get-or-create, so instruments can cache a handle once and
pay only the increment on the hot path. Histograms use FIXED bucket
edges: quantiles (p50/p90/p99) come from linear interpolation inside
the covering bucket — no samples are retained, so a histogram is O(one
int per bucket) forever regardless of traffic volume.

Two expositions:
  * `prometheus_text()` — Prometheus text format 0.0.4 (HELP/TYPE
    comments, `name{labels} value` samples, cumulative `_bucket{le=}`
    histogram series);
  * `json_snapshot()` — nested dict with derived quantiles, for bench
    artifacts and quick printouts.

All mutation is lock-guarded per metric (uncontended CPython locks are
~100ns; the serving hot path touches a handful of metrics per BATCH,
not per request), so concurrent writers never lose increments — the
concurrency tests assert exact totals.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def geometric_bounds(lo: float, hi: float, factor: float = 1.25
                     ) -> Tuple[float, ...]:
    """Geometric bucket edges covering [lo, hi]; relative quantile error
    is bounded by `factor - 1` (before in-bucket interpolation)."""
    assert lo > 0 and hi > lo and factor > 1
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


#: default latency edges: 1µs .. ~75s at 1.25x (≤25% worst-case error)
DEFAULT_LATENCY_BOUNDS_US = geometric_bounds(1.0, 60e6, 1.25)


class Counter:
    """Monotonic counter."""
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name, self.labels = name, labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Point-in-time value; either `set()` or a callback `fn` sampled
    at scrape time (e.g. a process-wide count)."""
    __slots__ = ("name", "labels", "_value", "_fn", "_lock")

    def __init__(self, name: str, labels: LabelKey = (),
                 fn: Optional[Callable[[], float]] = None):
        self.name, self.labels = name, labels
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._value = v

    def inc(self, n: float = 1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._value


class Histogram:
    """Fixed-bucket histogram: counts per bucket + sum/min/max.

    `bounds` are ascending upper edges; observations above the last
    edge land in a +Inf overflow bucket. Quantiles interpolate linearly
    within the covering bucket, clamped to the observed [min, max], so
    the error is at most one bucket width."""
    __slots__ = ("name", "labels", "bounds", "_counts", "_sum", "_count",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, bounds: Sequence[float],
                 labels: LabelKey = ()):
        assert len(bounds) > 0 and list(bounds) == sorted(bounds)
        self.name, self.labels = name, labels
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float):
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values):
        """Batched observe under ONE lock acquisition (hot-path callers
        with per-batch vectors, e.g. the regret monitor)."""
        # ndarray.tolist() converts to python floats in C — much faster
        # than iterating numpy scalars
        vs = values.tolist() if hasattr(values, "tolist") \
            else [float(v) for v in values]
        if not vs:
            return
        with self._lock:
            for v in vs:
                self._counts[bisect_left(self.bounds, v)] += 1
                self._sum += v
            self._count += len(vs)
            lo, hi = min(vs), max(vs)
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else math.nan

    @property
    def max(self) -> float:
        return self._max if self._count else math.nan

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def quantile(self, q: float) -> float:
        """q in [0, 1]; nan when empty."""
        if not self._count:
            return math.nan
        target = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if cum + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else min(self._min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                frac = (target - cum) / c
                v = lo + frac * (hi - lo)
                return min(max(v, self._min), self._max)
            cum += c
        return self._max

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_edge, count) pairs, Prometheus `le` style,
        ending with (+inf, total)."""
        out, cum = [], 0
        for edge, c in zip(self.bounds, self._counts):
            cum += c
            out.append((edge, cum))
        out.append((math.inf, cum + self._counts[-1]))
        return out


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and line feed must be escaped or the sample line is
    unparseable (exposition format 0.0.4)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """# HELP text escaping: backslash and line feed (quotes are legal
    verbatim in HELP)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: LabelKey) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return str(v)


class MetricsRegistry:
    """Get-or-create home for all metrics of one observability scope."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._help: Dict[str, str] = {}
        self._type: Dict[str, str] = {}
        self._lock = threading.Lock()

    # -- handles -------------------------------------------------------------
    def _get(self, kind: str, cls, name: str, help: str, labels: Dict,
             **ctor):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=key[1], **ctor)
                self._metrics[key] = m
                if help or name not in self._help:
                    self._help[name] = help
                self._type[name] = kind
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels, fn=fn)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", Histogram, name, help, labels,
                         bounds=bounds or DEFAULT_LATENCY_BOUNDS_US)

    # -- introspection -------------------------------------------------------
    def metrics(self) -> List[object]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def find(self, name: str, **labels) -> Optional[object]:
        return self._metrics.get((name, _labels_key(labels)))

    def value(self, name: str, default=None, **labels):
        m = self.find(name, **labels)
        return default if m is None else m.value  # type: ignore

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self._help.clear()
            self._type.clear()

    # -- exposition ----------------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        by_name: Dict[str, List] = {}
        for (name, _), m in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append(m)
        for name, ms in by_name.items():
            if self._help.get(name):
                lines.append(
                    f"# HELP {name} {_escape_help(self._help[name])}")
            lines.append(f"# TYPE {name} {self._type.get(name, 'untyped')}")
            for m in ms:
                lab = m.labels
                if isinstance(m, Histogram):
                    for edge, cum in m.bucket_counts():
                        le = (("le", _fmt_value(edge)),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(lab + le)} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(lab)} {_fmt_value(m.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(lab)} {m.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(lab)} {_fmt_value(m.value)}")
        return "\n".join(lines) + "\n"

    def json_snapshot(self) -> Dict:
        """Nested snapshot with derived quantiles (bench artifacts)."""
        out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in sorted(self._metrics.items()):
            key = name + _fmt_labels(labels)
            if isinstance(m, Histogram):
                out["histograms"][key] = {
                    "count": m.count, "sum": m.sum, "mean": m.mean,
                    "min": m.min, "max": m.max,
                    "p50": m.quantile(0.50), "p90": m.quantile(0.90),
                    "p99": m.quantile(0.99),
                }
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["counters"][key] = m.value
        return out
