"""Alert delivery: pluggable push sinks for quality/SLO alerts
(DESIGN.md §11). A copy of the JAX package's `obs/alerts.py`.

The monitors are pull-shaped — `quality_alert` events land in the
`EventLog` and `slo_status` is a gauge you scrape. A deployment that
wants a PAGE needs push: this module adds a tiny fan-out hub that the
`RouterQualityMonitor` (per drift alert) and the `SLOEngine` (on the
TRANSITION into `page`) deliver typed payloads through.

Contract (tests/test_alerts.py, held on both packages by
tests/test_torch_obs_parity.py):

  * **isolation** — a raising sink must never break the hot path: each
    sink call is individually try/except'd; failures bump
    `alert_sink_errors_total` and the remaining sinks still receive
    the payload. The monitors call `deliver()` from fold/evaluate
    paths, so an exception escaping here would take down serving.
  * **fire-once** — `deliver(payload, key=...)` delivers at most once
    per live key; `reset(key)` re-arms it. The SLO engine keys page
    alerts by rule and resets on recovery, so a rule that stays paged
    across many scrapes pages exactly once, and pages again only after
    it has recovered in between.
  * sinks are plain callables taking one dict. `LogFileSink` is the
    stock file-backed sink: webhook-shaped JSON lines (the body an
    HTTP push sink would POST), one object per alert.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from repro_torch import obs as OBS

__all__ = ["AlertSinkHub", "LogFileSink"]

#: a sink is any callable taking the alert payload dict
AlertSink = Callable[[Dict], None]


class AlertSinkHub:
    """Fans one alert payload out to every registered sink, with
    per-sink error isolation and optional fire-once keying."""

    def __init__(self, sinks: Iterable[AlertSink] = (), *,
                 registry=None, obs: Optional["OBS.Observability"] = None):
        self.obs = OBS.get_obs(obs)
        self._sinks = list(sinks)
        self._fired: set = set()
        self._lock = threading.Lock()
        r = registry if registry is not None else self.obs.registry
        self._m_delivered = r.counter(
            "alert_sink_delivered_total",
            "alert payloads delivered to a sink")
        self._m_errors = r.counter(
            "alert_sink_errors_total",
            "sink calls that raised (isolated, never propagated)")

    def add_sink(self, sink: AlertSink) -> "AlertSinkHub":
        self._sinks.append(sink)
        return self

    def __len__(self) -> int:
        return len(self._sinks)

    def deliver(self, payload: Dict, key=None) -> int:
        """Push `payload` to every sink; returns sinks reached.

        `key` (hashable) arms fire-once: the first deliver under a
        live key goes through, repeats are dropped until `reset(key)`.
        The key is claimed even when no sinks are attached, so a sink
        added mid-incident doesn't get a stale page."""
        if key is not None:
            with self._lock:
                if key in self._fired:
                    return 0
                self._fired.add(key)
        delivered = 0
        for sink in self._sinks:
            try:
                sink(dict(payload))
                delivered += 1
                self._m_delivered.inc()
            except Exception:
                # isolation: a broken webhook must not take down the
                # serving/evaluate path that alerted
                self._m_errors.inc()
        return delivered

    def reset(self, key) -> None:
        """Re-arm a fire-once key (e.g. the SLO rule recovered)."""
        with self._lock:
            self._fired.discard(key)


class LogFileSink:
    """Webhook-shaped sink backed by a JSONL file: each alert appends
    one JSON object — the body an HTTP push sink would POST — with a
    monotone per-sink sequence number. Append-per-call (no held file
    handle): alerts are rare and crash-safety beats throughput here."""

    def __init__(self, path):
        self.path = str(path)
        self._seq = 0
        self._lock = threading.Lock()

    def __call__(self, payload: Dict) -> None:
        with self._lock:
            self._seq += 1
            line = json.dumps({
                "event": payload.get("kind", "alert"),
                "seq": self._seq,
                "ts": time.time(),
                "payload": payload,
            }, sort_keys=True, default=str)
            with open(self.path, "a") as f:
                f.write(line + "\n")
