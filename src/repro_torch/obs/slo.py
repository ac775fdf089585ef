"""Declarative SLO rules with multi-window burn-rate status
(DESIGN.md §11). A copy of the JAX package's `obs/slo.py`.

An `SLORule` names a metric in the registry, a statistic to read off it
(`value` for counters/gauges, `mean`/`p50`/`p90`/`p99` for histograms,
or a ratio against a denominator metric via `per=` — e.g. shed rate =
`admission_shed_total / admission_submitted_total`), a comparison, and
a bound. Rules are data, not code: they serialize to/from plain dicts
(`SLORule.from_dict`), so a deployment can ship its SLOs as JSON.

`SLOEngine.evaluate()` is called AT SCRAPE TIME (the `/slo` endpoint,
tests, or a bench loop) — rules cost nothing between scrapes. Each
evaluation compares every rule and pushes the breach bit into a
bounded window; status is derived Google-SRE-style from TWO windows of
recent evaluations:

  * `ok`      — rule holds now;
  * `breach`  — rule fails the current evaluation
                (`slo_breach_total{rule=}` increments);
  * `page`    — the breach *burn rate* (breached fraction) is at least
                `page_burn` over BOTH the short and the long window —
                i.e. the failure is sustained, not a blip;
  * `no_data` — the metric (or its denominator) is absent or empty;
                never counted as a breach.

The engine's own bookkeeping lives in the same registry
(`slo_evaluations_total`, `slo_breach_total{rule=}`,
`slo_status{rule=}` gauge: 0 ok / 1 breach / 2 page / -1 no_data), so
`/metrics` alone is enough to alert on.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch import obs as OBS
from repro_torch.obs.metrics import Histogram

__all__ = ["SLORule", "SLOEngine", "default_serving_rules"]

#: rule.stat -> how to read a Histogram
_H_STATS = ("mean", "p50", "p90", "p99", "count")
_STATUS_CODE = {"no_data": -1.0, "ok": 0.0, "breach": 1.0, "page": 2.0}
_SEVERITY = {"no_data": 0, "ok": 1, "breach": 2, "page": 3}


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One objective over the metrics registry. `labels` narrows the
    metric instance (e.g. `{"model": "olmo-1b"}`); `per` divides by a
    second metric's value (ratio objectives)."""
    name: str                  # rule id (label on slo_* metrics)
    metric: str                # registry metric name
    op: str                    # "<=" or ">="
    bound: float
    stat: str = "value"        # value | mean | p50 | p90 | p99 | count
    labels: Optional[Dict[str, str]] = None
    per: Optional[str] = None  # denominator metric (value stat)
    per_labels: Optional[Dict[str, str]] = None
    help: str = ""

    def __post_init__(self):
        assert self.op in ("<=", ">="), f"bad op {self.op!r}"
        assert self.stat in ("value",) + _H_STATS, \
            f"bad stat {self.stat!r}"

    @classmethod
    def from_dict(cls, d: Dict) -> "SLORule":
        return cls(**d)

    def as_dict(self) -> Dict:
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v not in (None, "")}


class SLOEngine:
    """Evaluates a rule set against one registry; keeps burn-rate
    windows per rule. Stateless between scrapes except the windows."""

    def __init__(self, registry, rules: Sequence[SLORule], *,
                 short_window: int = 12, long_window: int = 60,
                 page_burn: float = 0.5,
                 obs: Optional["OBS.Observability"] = None,
                 sinks: Sequence = ()):
        assert 0 < short_window <= long_window and 0 < page_burn <= 1
        self.registry = registry
        self.rules = list(rules)
        assert len({r.name for r in self.rules}) == len(self.rules), \
            "duplicate rule names"
        self.short_window = short_window
        self.long_window = long_window
        self.page_burn = page_burn
        self._windows: Dict[str, deque] = {
            r.name: deque(maxlen=long_window) for r in self.rules}
        self.obs = obs if obs is not None else OBS.get_obs(None)
        # the engine's own metrics land in the SAME registry it reads
        # (so one /metrics scrape carries rule status too), under slo_*
        # names no rule should ever target
        own = registry
        self._m_evals = own.counter(
            "slo_evaluations_total", "SLO evaluation passes")
        self._m_breach = {
            r.name: own.counter("slo_breach_total",
                                "evaluations that breached, by rule",
                                rule=r.name)
            for r in self.rules}
        self._g_status = {
            r.name: own.gauge("slo_status",
                              "rule status: -1 no_data, 0 ok, 1 breach,"
                              " 2 page", rule=r.name)
            for r in self.rules}
        # push delivery on the TRANSITION into page (obs.alerts): keyed
        # per rule, so a rule that stays paged across scrapes pages
        # once; leaving page re-arms the key (pages again on re-entry)
        from repro_torch.obs.alerts import AlertSinkHub
        self.sinks = AlertSinkHub(sinks, registry=registry, obs=self.obs)

    # -- metric readout ------------------------------------------------------
    def _read(self, name: str, labels: Optional[Dict[str, str]],
              stat: str) -> Optional[float]:
        m = self.registry.find(name, **(labels or {}))
        if m is None:
            return None
        if isinstance(m, Histogram):
            if stat == "count":
                return float(m.count)
            if m.count == 0:
                return None
            if stat == "mean":
                return float(m.mean)
            if stat in ("p50", "p90", "p99"):
                return float(m.quantile(int(stat[1:]) / 100.0))
            return None  # "value" is meaningless on a histogram
        if stat != "value":
            return None  # quantile stats need a histogram
        return float(m.value)

    def rule_value(self, rule: SLORule) -> Optional[float]:
        v = self._read(rule.metric, rule.labels, rule.stat)
        if v is None:
            return None
        if rule.per is not None:
            d = self._read(rule.per, rule.per_labels, "value")
            if d is None or d == 0:
                return None
            v = v / d
        return v

    # -- evaluation ----------------------------------------------------------
    def _burn(self, win: deque, n: int) -> float:
        """Breached fraction of the most recent `n` evaluations. The
        denominator is the FULL window length even while it is still
        filling — missing history counts as non-breached, so a blip
        right after startup can never page on its own."""
        return sum(list(win)[-n:]) / n

    def evaluate(self) -> Dict:
        """One scrape-time pass over every rule; returns the `/slo`
        JSON payload and updates burn windows + slo_* metrics."""
        self._m_evals.inc()
        out: List[Dict] = []
        worst = "ok" if self.rules else "no_rules"
        for rule in self.rules:
            v = self.rule_value(rule)
            win = self._windows[rule.name]
            if v is None:
                status, burn_s, burn_l = "no_data", 0.0, 0.0
            else:
                breached = not (v <= rule.bound if rule.op == "<="
                                else v >= rule.bound)
                win.append(1 if breached else 0)
                burn_s = self._burn(win, self.short_window)
                burn_l = self._burn(win, self.long_window)
                if breached:
                    self._m_breach[rule.name].inc()
                    status = "page" if (burn_s >= self.page_burn
                                        and burn_l >= self.page_burn) \
                        else "breach"
                else:
                    status = "ok"
            self._g_status[rule.name].set(_STATUS_CODE[status])
            page_key = ("slo_page", rule.name)
            if status == "page":
                self.sinks.deliver(
                    {"kind": "slo_page", "rule": rule.name,
                     "value": v, "bound": rule.bound, "op": rule.op,
                     "burn_short": burn_s, "burn_long": burn_l},
                    key=page_key)
            else:
                self.sinks.reset(page_key)
            if worst != "no_rules" and \
                    _SEVERITY[status] > _SEVERITY[worst]:
                worst = status
            out.append({
                "rule": rule.name, "status": status,
                "value": v, "bound": rule.bound, "op": rule.op,
                "metric": rule.metric, "stat": rule.stat,
                "burn_short": burn_s, "burn_long": burn_l,
                "breaches_total": int(self._m_breach[rule.name].value),
                **({"help": rule.help} if rule.help else {}),
            })
        return {
            "status": worst,
            "evaluations": int(self._m_evals.value),
            "windows": {"short": self.short_window,
                        "long": self.long_window,
                        "page_burn": self.page_burn},
            "rules": out,
        }


def default_serving_rules(*, deadline_ms: float = 50.0,
                          occupancy_floor: float = 0.5,
                          shed_rate_cap: float = 0.05,
                          regret_bound: float = 50.0) -> List[SLORule]:
    """The stock serving objectives over the metric names the engine,
    dispatcher, admission queue, and quality monitor already emit."""
    return [
        SLORule("queue_wait_p99", "admission_wait_us", "<=",
                deadline_ms * 1e3, stat="p99",
                help="p99 admission queue wait within the deadline"),
        SLORule("occupancy_floor", "dispatch_bucket_occupancy", ">=",
                occupancy_floor, stat="mean",
                help="mean dispatch-bucket fill above the floor"),
        SLORule("shed_rate", "admission_shed_total", "<=",
                shed_rate_cap, per="admission_submitted_total",
                help="budget-clamped (shed) fraction of offered load"),
        SLORule("reject_rate", "admission_rejected_total", "<=", 0.0,
                per="admission_submitted_total",
                help="hard-rejected fraction of offered load"),
        SLORule("routing_regret", "quality_regret_last", "<=",
                regret_bound,
                help="mean per-batch routing regret (rating points)"),
    ]
