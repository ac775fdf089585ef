"""Observability substrate for the serving path: a copy of the JAX
package's host-only `obs` modules. Besides the three below, the
operational plane: `quality` (routing regret, drift alarms), `slo` (rule
status and burn rates over the registry), `alerts` (push sinks) and
`exporter` (the stdlib HTTP scrape endpoint).

Three instruments behind one bundle:

  * `SpanTracer`   — host-side span timing, ring-buffered, Chrome-trace
                     export, optional `torch.profiler.record_function`
                     pass-through (obs/trace.py);
  * `MetricsRegistry` — counters / gauges / fixed-bucket histograms with
                     Prometheus-text and JSON exposition (obs/metrics.py);
  * `EventLog`     — structured JSONL event stream (per-request route
                     decisions) (obs/events.py).

Gating contract: METRICS ARE ALWAYS ON — they back typed engine
statistics (`ServingEngine.stats`) and cost nanoseconds per batch.
SPANS and EVENTS are gated by `Observability.enabled` (default OFF):
when disabled, an instrumented region costs one attribute check, which
is how the <5% hot-path overhead budget is kept.

Components take an optional `obs=` handle and fall back to the module
default (`DEFAULT`), so a process normally has one telemetry scope;
tests and benchmarks build private `Observability()` instances for
isolation.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.events import EventLog
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BOUNDS_US, Counter, Gauge,
                               Histogram, MetricsRegistry,
                               geometric_bounds)
from repro_torch.obs.trace import NULL_SPAN, SpanTracer, named_scope

__all__ = ["Observability", "DEFAULT", "get_obs", "enable", "disable",
           "reset_default", "SpanTracer", "MetricsRegistry", "EventLog",
           "Counter", "Gauge", "Histogram", "geometric_bounds",
           "DEFAULT_LATENCY_BOUNDS_US", "named_scope", "NULL_SPAN"]


class Observability:
    """One telemetry scope: tracer + registry + event log + the enable
    switch for the gated instruments."""

    def __init__(self, enabled: bool = False, trace_capacity: int = 8192,
                 event_capacity: int = 1 << 16, profiler: bool = False,
                 event_path: Optional[str] = None):
        self.tracer = SpanTracer(capacity=trace_capacity,
                                 profiler=profiler)
        self.registry = MetricsRegistry()
        self.events = EventLog(capacity=event_capacity, path=event_path)
        self.tracer.enabled = enabled
        self.enabled = enabled

    # -- switches ------------------------------------------------------------
    def enable(self, profiler: Optional[bool] = None) -> "Observability":
        if profiler is not None:
            self.tracer.profiler = profiler
        self.tracer.enabled = True
        self.enabled = True
        return self

    def disable(self) -> "Observability":
        self.tracer.enabled = False
        self.enabled = False
        return self

    # -- hot-path helpers ----------------------------------------------------
    def span(self, name: str):
        """Timed span; collapses to a shared no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name)

    def emit(self, record) -> bool:
        """Gated event emission; returns whether the record was taken."""
        if not self.enabled:
            return False
        self.events.emit(record)
        return True

    def reset(self):
        """Fresh instruments, switch state preserved (tests/benches)."""
        self.tracer.reset()
        self.registry.reset()
        self.events.clear()


#: process-default scope: what instrumented components use unless handed
#: an explicit `obs=`; disabled (metrics-only) out of the box.
DEFAULT = Observability(enabled=False)


def get_obs(obs: Optional[Observability] = None) -> Observability:
    return obs if obs is not None else DEFAULT


def reset_default(enabled: bool = False, **kw) -> Observability:
    """Tear down and re-create the process-default scope.

    Test fixtures call this between tests so metric/event state from a
    component built without an explicit `obs=` cannot bleed across
    tests. Handles cached from the OLD bundle
    keep working against the old instruments — isolation comes from
    `get_obs()` resolving to the fresh bundle at the next lookup, not
    from invalidating old references."""
    global DEFAULT
    DEFAULT = Observability(enabled=enabled, **kw)
    return DEFAULT


def enable(profiler: Optional[bool] = None) -> Observability:
    """Switch the process-default scope on (spans + events)."""
    return DEFAULT.enable(profiler=profiler)


def disable() -> Observability:
    return DEFAULT.disable()
