"""Scrape endpoints for one `Observability` scope (DESIGN.md §11). A copy
of the JAX package's `obs/exporter.py`.

A stdlib `http.server.ThreadingHTTPServer` on a daemon thread — no new
dependencies, safe to run inside benchmarks and tests on an ephemeral
port (`port=0`). Serving is entirely PULL-based: nothing is computed
between scrapes, and a scrape renders from the live registry/tracer/
event-log on the exporter thread, never touching the serving hot path.

Endpoint map:

  GET /metrics            Prometheus text 0.0.4 (registry.prometheus_text)
  GET /trace              Chrome-trace/Perfetto JSON (tracer.chrome_trace)
  GET /decisions?n=&kind= JSONL tail of the event log (default kind
                          "route", n=256; kind=all for everything)
  GET /healthz            liveness JSON: uptime, scrape counts, event/
                          span accounting
  GET /slo                SLO engine status (obs/slo.py) evaluated AT
                          SCRAPE TIME; {"status": "no_rules"} when no
                          engine is attached
  GET /quality            quality-monitor snapshot (obs/quality.py);
                          {"status": "no_monitor"} when none attached

Scrapes are themselves metered (`exporter_scrapes_total{path=}` in the
same registry), so the Prometheus view shows its own scrape traffic.

The exporter thread touches no CUDA tensor and calls nothing in
`torch.cuda`: every route renders host state (the registry, whose
callback gauges read Python counters; the monitor's host arrays; the
SLO engine over the registry). The serving thread captures CUDA graphs
while this thread runs, and a capture fails if another thread makes a
CUDA call that is unsafe during it (cudaErrorStreamCaptureUnsupported).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from repro_torch import obs as OBS

__all__ = ["ObsExporter", "start_exporter"]

_CT_PROM = "text/plain; version=0.0.4; charset=utf-8"
_CT_JSON = "application/json; charset=utf-8"
_CT_NDJSON = "application/x-ndjson; charset=utf-8"

#: endpoints enumerated by /healthz and metered per path
ROUTES = ("/metrics", "/trace", "/decisions", "/healthz", "/slo",
          "/quality")


class ObsExporter:
    """Threaded HTTP daemon over one observability scope, with optional
    SLO engine and router-quality monitor attachments."""

    def __init__(self, obs: Optional["OBS.Observability"] = None, *,
                 slo=None, quality=None, host: str = "127.0.0.1",
                 port: int = 0, decisions_tail: int = 256):
        self.obs = OBS.get_obs(obs)
        self.slo = slo
        self.quality = quality
        self.host = host
        self._requested_port = port
        self.decisions_tail = decisions_tail
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        r = self.obs.registry
        self._m_scrapes = {
            p: r.counter("exporter_scrapes_total",
                         "scrape requests served, by endpoint", path=p)
            for p in ROUTES}
        self._m_errors = r.counter(
            "exporter_errors_total", "scrape requests that failed")

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        assert self._httpd is not None, "exporter not started"
        return self._httpd.server_address[1]

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def start(self) -> "ObsExporter":
        assert self._httpd is None, "exporter already started"
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            # one exporter per handler class: the stdlib API offers no
            # clean ctor injection
            def log_message(self, *a):   # silence per-request stderr
                pass

            def do_GET(self):
                exporter._handle(self)

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-exporter",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ObsExporter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- rendering -----------------------------------------------------------
    def _payload(self, path: str, query) -> tuple:
        """(content_type, body_bytes) for one route; raises KeyError on
        unknown paths."""
        if path == "/metrics":
            return _CT_PROM, self.obs.registry.prometheus_text().encode()
        if path == "/trace":
            return _CT_JSON, json.dumps(
                self.obs.tracer.chrome_trace()).encode()
        if path == "/decisions":
            n = int(query.get("n", [self.decisions_tail])[0])
            kind = query.get("kind", ["route"])[0]
            recs = self.obs.events.tail(
                n, kind=None if kind == "all" else kind)
            body = "".join(json.dumps(r) + "\n" for r in recs)
            return _CT_NDJSON, body.encode()
        if path == "/healthz":
            doc = {
                "status": "ok",
                "uptime_s": time.monotonic() - self._t0,
                "endpoints": list(ROUTES),
                "scrapes": {p: int(c.value)
                            for p, c in self._m_scrapes.items()},
                "events": {"emitted": self.obs.events.emitted,
                           "retained": len(self.obs.events),
                           "dropped": self.obs.events.dropped},
                "spans": {"recorded": self.obs.tracer.recorded,
                          "dropped": self.obs.tracer.dropped},
                "enabled": self.obs.enabled,
            }
            return _CT_JSON, json.dumps(doc).encode()
        if path == "/slo":
            doc = self.slo.evaluate() if self.slo is not None \
                else {"status": "no_rules", "rules": []}
            return _CT_JSON, json.dumps(doc).encode()
        if path == "/quality":
            doc = self.quality.snapshot() if self.quality is not None \
                else {"status": "no_monitor"}
            return _CT_JSON, json.dumps(doc).encode()
        raise KeyError(path)

    def _handle(self, h: BaseHTTPRequestHandler):
        u = urlparse(h.path)
        try:
            ct, body = self._payload(u.path, parse_qs(u.query))
        except KeyError:
            h.send_error(404, explain=f"unknown endpoint {u.path!r}; "
                         f"try one of {', '.join(ROUTES)}")
            return
        except Exception as e:   # render errors must not kill the thread
            self._m_errors.inc()
            h.send_error(500, explain=repr(e))
            return
        self._m_scrapes[u.path].inc()
        h.send_response(200)
        h.send_header("Content-Type", ct)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)


def start_exporter(obs=None, *, port: int = 0, slo=None, quality=None,
                   host: str = "127.0.0.1") -> ObsExporter:
    """One-call helper: build + start; returns the running exporter
    (use `.port`/`.url()` for the ephemeral address)."""
    return ObsExporter(obs, slo=slo, quality=quality, host=host,
                       port=port).start()
