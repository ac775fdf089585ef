"""The port's operational obs plane (`obs/{quality,slo,alerts,exporter}.py`)
against the JAX package's, on the CPU: every scenario of tests/test_quality.py,
tests/test_alerts.py and tests/test_exporter.py runs on both packages,
each held to the scenario's own assertions, and the two traces must be
equal: regret bit for bit (and each package's equal to its own oracle),
drift alerts at the same fold with the same z, SLO statuses, burn rates
and page deliveries, the exporter's content types, JSON keys and
Prometheus metric names. Where a trace carries the routers' own ratings,
which are allclose across the packages and not bit-equal (ROADMAP §4.5),
it is compared within the ratings tolerance. Then the core's write-side
counters (`vectordb_*`, `dbuf_*`, `router_feedback_total`, the update
magnitude histogram) after the same seeded fit -> feedback x 3 -> serve(),
and `launch.serve.build_obs_plane` over each package's `build_engine()`.
"""
import itertools
import json
import re
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro import obs as JOBS
from repro.core.router import EagleConfig as JConfig
from repro.core.router import EagleRouter as JRouter
from repro.obs import alerts as JALERTS
from repro.obs import exporter as JEXP
from repro.obs import metrics as JMETRICS
from repro.obs import quality as JQ
from repro.obs import slo as JSLO
from repro.serving import engine as JENG
from repro_torch import obs as TOBS
from repro_torch.core.router import EagleConfig as TConfig
from repro_torch.core.router import EagleRouter as TRouter
from repro_torch.obs import alerts as TALERTS
from repro_torch.obs import exporter as TEXP
from repro_torch.obs import metrics as TMETRICS
from repro_torch.obs import quality as TQ
from repro_torch.obs import slo as TSLO
from repro_torch.serving import engine as TENG

jax.config.update("jax_platform_name", "cpu")

PKGS = {
    "jax": SimpleNamespace(
        name="jax", OBS=JOBS, Q=JQ, ALERTS=JALERTS, SLO=JSLO, EXP=JEXP,
        METRICS=JMETRICS, ENG=JENG,
        router=lambda *a, **kw: JRouter(*a, **kw), Config=JConfig),
    "torch": SimpleNamespace(
        name="torch", OBS=TOBS, Q=TQ, ALERTS=TALERTS, SLO=TSLO, EXP=TEXP,
        METRICS=TMETRICS, ENG=TENG,
        router=lambda *a, **kw: TRouter(*a, device="cpu", **kw),
        Config=TConfig),
}
# the routers' ratings across the packages (tests/test_router_state.py)
R_RTOL, R_ATOL = 1e-5, 1e-3
_PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


@pytest.fixture(autouse=True)
def _fresh_port_default_obs():
    """tests/conftest.py resets the JAX package's default scope; this
    resets the port's, which holds the VectorDB counters."""
    before = TOBS.DEFAULT
    TOBS.reset_default(enabled=False)
    try:
        yield
    finally:
        TOBS.DEFAULT = before


def _canon(x):
    """A value the two packages must agree on EXACTLY, as plain data:
    float arrays by their bytes (bitwise), NaN as a token."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, (float, np.floating)):
        return "nan" if np.isnan(x) else float(x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def _assert_traces_equal(got, want):
    """Traces are dicts; the key "approx" holds float lists compared
    within the ratings tolerance, everything else exactly."""
    got, want = dict(got), dict(want)
    g_approx, w_approx = got.pop("approx", None), want.pop("approx", None)
    assert _canon(got) == _canon(want)
    assert (g_approx is None) == (w_approx is None)
    if g_approx is not None:
        assert g_approx.keys() == w_approx.keys()
        for k in g_approx:
            np.testing.assert_allclose(g_approx[k], w_approx[k],
                                       rtol=R_RTOL, atol=R_ATOL, err_msg=k)


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


class _Capture:
    def __init__(self):
        self.payloads = []

    def __call__(self, payload):
        self.payloads.append(payload)


class _Boom:
    def __init__(self):
        self.calls = 0

    def __call__(self, payload):
        self.calls += 1
        raise RuntimeError("webhook down")


class _StubModel:
    """Duck-typed fleet entry: generate()'s shape contract only."""

    def generate(self, tokens, max_new):
        return np.zeros((tokens.shape[0], max_new), np.int32)


# ---------------------------------------------------------------------------
# tests/test_quality.py: routing regret
# ---------------------------------------------------------------------------

def regret_randomized(pkg):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(50):
        m = int(rng.integers(2, 9))
        b = int(rng.integers(1, 33))
        ratings = rng.normal(1500.0, 120.0, m)
        costs = rng.uniform(0.5, 10.0, m)
        budgets = rng.uniform(0.0, 12.0, b)
        choices = rng.integers(0, m, b)
        got = pkg.Q.routing_regret(ratings, costs, budgets, choices)
        want = pkg.Q.routing_regret_oracle(ratings, costs, budgets, choices)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want)   # bitwise, not allclose
        out.append(got)
    return {"regret": out}


def regret_zero_when_choice_is_best_feasible(pkg):
    ratings = [1500.0, 1600.0, 1400.0]
    costs = [1.0, 4.0, 8.0]
    r = [pkg.Q.routing_regret(ratings, costs, [5.0], [1])[0],
         pkg.Q.routing_regret(ratings, costs, [5.0], [0])[0],
         pkg.Q.routing_regret(ratings, costs, [2.0], [0])[0]]
    assert r == [0.0, 100.0, 0.0]
    return {"regret": r}


def regret_infeasible_budget_uses_cheapest_fallback(pkg):
    ratings = np.array([1500.0, 1650.0])
    costs = np.array([1.0, 4.0])
    r = pkg.Q.routing_regret(ratings, costs, [0.5, 0.5], [0, 1])
    assert r[0] == 0.0
    assert r[1] == ratings[0] - ratings[1] < 0
    want = pkg.Q.routing_regret_oracle(ratings, costs, [0.5, 0.5], [0, 1])
    assert np.array_equal(r, want)
    return {"regret": r}


def regret_boundary_cost_equals_budget(pkg):
    r = pkg.Q.routing_regret([1500.0, 1600.0], [1.0, 4.0], [4.0], [0])
    assert r[0] == 100.0
    return {"regret": r}


# ---------------------------------------------------------------------------
# tests/test_quality.py: drift detection
# ---------------------------------------------------------------------------

def drift_detector_quiet_on_stationary_noise(pkg):
    rng = np.random.default_rng(7)
    det = pkg.Q.DriftDetector(alpha=0.05, z_threshold=6.0, min_samples=32)
    fired = [det.update(x) for x in rng.normal(1500.0, 5.0, 5000)]
    assert not any(z is not None for z in fired)
    return {"state": [det.mean, det.var, det.n]}


def drift_detector_fires_once_then_readapts(pkg):
    rng = np.random.default_rng(3)
    det = pkg.Q.DriftDetector(alpha=0.05, z_threshold=6.0, min_samples=32)
    for x in rng.normal(1500.0, 5.0, 500):
        assert det.update(x) is None
    z = det.update(1900.0)
    assert z is not None and z > 6.0
    post = [det.update(x) for x in rng.normal(1900.0, 5.0, 500)]
    assert sum(z is not None for z in post) <= 3
    assert all(z is None for z in post[-400:])
    return {"z": z, "post": [(i, p) for i, p in enumerate(post)
                             if p is not None]}


def drift_detector_respects_min_samples(pkg):
    det = pkg.Q.DriftDetector(min_samples=32)
    for i in range(31):
        assert det.update(float(i * 1000)) is None
    return {"state": [det.mean, det.var, det.n]}


def drift_detector_variance_floor_on_flat_series(pkg):
    det = pkg.Q.DriftDetector(min_samples=4, min_std=1e-6)
    for _ in range(100):
        assert det.update(1500.0) is None
    return {"state": [det.mean, det.var, det.n]}


# ---------------------------------------------------------------------------
# tests/test_quality.py: the monitor end to end
# ---------------------------------------------------------------------------

def _mon(pkg):
    o = pkg.OBS.Observability(enabled=True)
    return pkg.Q.RouterQualityMonitor(
        ["a", "b", "c"], costs=[1.0, 2.0, 4.0],
        ratings=[1500.0, 1550.0, 1450.0],
        cfg=pkg.Q.QualityConfig(min_samples=8, window=16), obs=o)


def _snapshot(mon):
    snap = mon.snapshot()
    snap["trajectory_tail"] = {m: [list(p) for p in t]
                               for m, t in snap["trajectory_tail"].items()}
    return snap


def monitor_score_batch_accounting(pkg):
    mon = _mon(pkg)
    regret = mon.score_batch([5.0, 5.0, 1.5, 0.5], [1, 0, 0, 0])
    want = pkg.Q.routing_regret_oracle(mon.ratings, mon.costs,
                                       [5.0, 5.0, 1.5, 0.5], [1, 0, 0, 0])
    assert np.array_equal(regret, want)
    share = mon.selection_share()
    assert share == {"a": 0.75, "b": 0.25, "c": 0.0}
    snap = mon.snapshot()
    assert snap["decisions"] == 4
    assert snap["regret"]["count"] == 4
    assert snap["regret"]["sum"] == pytest.approx(float(want.sum()))
    r = mon.obs.registry
    assert r.value("quality_decisions_total") == 4
    assert r.value("quality_selected_total", model="a") == 3
    assert r.value("quality_regret_last") == pytest.approx(
        float(want.mean()))
    return {"regret": regret, "snapshot": _snapshot(mon)}


def monitor_win_rate_and_feedback(pkg):
    mon = _mon(pkg)
    mon.observe_feedback([0, 0, 2, 1], [1, 1, 0, 2], [1.0, 1.0, 1.0, 0.5])
    wr = mon.win_rate()
    assert wr["a"] == pytest.approx(2 / 3)
    assert wr["b"] == 0.0
    assert wr["c"] == pytest.approx(1 / 2)
    lone = pkg.Q.RouterQualityMonitor(["x"], [1.0], [1500.0], obs=mon.obs)
    assert np.isnan(lone.win_rate()["x"])
    return {"win_rate": wr, "lone": lone.win_rate()}


def monitor_trajectories_bounded_and_refreshed(pkg):
    mon = _mon(pkg)
    rng = np.random.default_rng(0)
    base = np.array([1500.0, 1550.0, 1450.0])
    for _ in range(40):
        mon.observe_ratings(base + rng.normal(0, 1.0, 3))
    for m in mon.model_names:
        assert len(mon.trajectories[m]) == 16
    last = mon.trajectories["a"][-1][1]
    assert mon.obs.registry.value("quality_rating", model="a") == last
    assert mon.ratings[0] == last
    return {"trajectories": {m: [list(p) for p in t]
                             for m, t in mon.trajectories.items()}}


def monitor_alert_on_injected_rating_step(pkg):
    mon = _mon(pkg)
    rng = np.random.default_rng(1)
    base = np.array([1500.0, 1550.0, 1450.0])
    for _ in range(64):
        mon.observe_ratings(base + rng.normal(0, 2.0, 3))
    assert mon.alerts_fired == 0
    shifted = base + np.array([400.0, 0.0, 0.0])
    mon.observe_ratings(shifted + rng.normal(0, 2.0, 3))
    assert mon.alerts_fired >= 1
    alerts = mon.obs.events.records("quality_alert")
    assert len(alerts) >= 1
    a = alerts[0]
    assert a["alert"] == "rating_drift" and a["model"] == "a"
    assert abs(a["z"]) > mon.cfg.z_threshold
    assert mon.obs.registry.value("quality_alerts_total",
                                  kind="rating_drift") >= 1
    # the same alerts at the same fold with the same z
    return {"alerts": alerts}


def monitor_regret_drift_alert(pkg):
    mon = _mon(pkg)
    rng = np.random.default_rng(2)
    for _ in range(64):
        mon.observe_batch(rng.uniform(4.0, 8.0, 8), [1] * 8)
    mon.flush()
    assert mon.alerts_fired == 0
    mon.observe_batch(rng.uniform(4.0, 8.0, 8), [2] * 8)
    mon.flush()
    assert mon.obs.registry.value("quality_alerts_total",
                                  kind="regret_drift") >= 1
    return {"alerts": mon.obs.events.records("quality_alert"),
            "snapshot": _snapshot(mon)}


def monitor_observe_batch_is_deferred(pkg):
    mon = _mon(pkg)
    mon.observe_batch([5.0, 5.0], [0, 1])
    assert mon.obs.registry.value("quality_decisions_total") == 2
    assert mon.obs.registry.value("quality_selected_total", model="a") == 0
    assert mon._h_regret.count == 0
    assert mon.flush() == 1
    assert mon.obs.registry.value("quality_selected_total", model="a") == 1
    assert mon._h_regret.count == 2
    assert mon.flush() == 0
    return {"snapshot": _snapshot(mon)}


def monitor_max_pending_overflow_flushes_inline(pkg):
    o = pkg.OBS.Observability(enabled=True)
    m = pkg.Q.RouterQualityMonitor(
        ["a", "b"], [1.0, 2.0], [1500.0, 1550.0],
        cfg=pkg.Q.QualityConfig(max_pending=4), obs=o)
    for _ in range(4):
        m.observe_batch([5.0], [0])
    assert m._h_regret.count == 4
    assert len(m._pending) == 0
    return {"snapshot": _snapshot(m)}


def monitor_disabled_scope_emits_no_events(pkg):
    o = pkg.OBS.Observability(enabled=False)
    m = pkg.Q.RouterQualityMonitor(["a", "b"], [1.0, 2.0], [1500.0, 1500.0],
                                   cfg=pkg.Q.QualityConfig(min_samples=2),
                                   obs=o)
    m.observe_batch([5.0], [0])
    m.observe_ratings([1500.0, 1500.0])
    assert o.registry.value("quality_decisions_total") == 1
    for _ in range(8):
        m.observe_ratings([1500.0, 1500.0])
    m.observe_ratings([9999.0, 1500.0])
    assert o.events.records("quality_alert") == []
    return {"alerts_fired": m.alerts_fired}


# ---------------------------------------------------------------------------
# tests/test_quality.py: serving integration
# ---------------------------------------------------------------------------

def _small_router(pkg, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    router = pkg.router(["a", "b"], [1.0, 4.0], pkg.Config(embed_dim=dim),
                        db_capacity=128)
    n = 24
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    ma = rng.integers(0, 2, n)
    router.fit(emb, ma, 1 - ma, rng.integers(0, 2, n).astype(np.float32))
    return router


def _counter_clock(start=1_000_000_000, step=1_000_000):
    c = itertools.count(start, step)
    return lambda: next(c)


def _serve_once(pkg, dim=16):
    o = pkg.OBS.Observability(enabled=True)
    router = _small_router(pkg, dim)
    eng = pkg.ENG.ServingEngine({"a": _StubModel(), "b": _StubModel()},
                                router, compare_rate=0.0, seed=0,
                                quality_oracle=None, obs=o,
                                now_ns=_counter_clock())
    rng = np.random.default_rng(42)
    reqs = [pkg.ENG.Request(tokens=rng.integers(0, 64, 6).astype(np.int32),
                            embedding=rng.normal(size=dim).astype(
                                np.float32),
                            budget=float(b), max_new_tokens=2, rid=k)
            for k, b in enumerate(rng.uniform(0.5, 6.0, 12))]
    for i in range(0, len(reqs), 4):
        eng.serve(reqs[i:i + 4])
    return o.events.records("route")


def decision_log_replay_determinism(pkg):
    a, b = _serve_once(pkg), _serve_once(pkg)
    assert len(a) == 12
    assert a == b
    ts = sorted({r["ts"] for r in a})
    assert ts == [1.0, 1.001, 1.002]
    return {"log": a}


def engine_feeds_quality_monitor(pkg):
    o = pkg.OBS.Observability(enabled=True)
    router = _small_router(pkg)
    mon = pkg.Q.RouterQualityMonitor.for_router(router, obs=o)
    eng = pkg.ENG.ServingEngine({"a": _StubModel(), "b": _StubModel()},
                                router, compare_rate=0.0, obs=o,
                                quality=mon)
    assert router.quality is mon and router.obs is o
    rng = np.random.default_rng(0)
    reqs = [pkg.ENG.Request(tokens=np.arange(4, dtype=np.int32),
                            embedding=rng.normal(size=16).astype(np.float32),
                            budget=5.0, max_new_tokens=2, rid=k)
            for k in range(6)]
    eng.serve(reqs)
    assert o.registry.value("quality_decisions_total") == 6
    share = mon.selection_share()
    assert sum(share.values()) == pytest.approx(1.0)
    snap = _snapshot(mon)
    ratings = snap.pop("ratings")
    regret = snap.pop("regret")
    return {"share": share, "decisions": snap["decisions"],
            "regret_count": regret["count"],
            "approx": {"ratings": list(ratings.values()),
                       "regret_sum": [regret["sum"]]}}


def router_feedback_feeds_quality_monitor(pkg):
    o = pkg.OBS.Observability(enabled=True)
    router = _small_router(pkg)
    router.obs = o
    mon = pkg.Q.RouterQualityMonitor.for_router(router, obs=o)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(4, 16)).astype(np.float32)
    router.feedback(emb, [0, 1, 0, 1], [1, 0, 1, 0], [1.0, 0.0, 1.0, 1.0])
    assert mon.snapshot()["feedback_folds"] == 1
    np.testing.assert_array_equal(
        mon.ratings, np.asarray(router.global_ratings, np.float64))
    assert o.registry.value("quality_comparisons_total", model="a") == 4
    mag = o.registry.find("router_elo_update_magnitude")
    return {"comparisons": [o.registry.value("quality_comparisons_total",
                                             model=m) for m in "ab"],
            "wins": [o.registry.value("quality_win_total", model=m)
                     for m in "ab"],
            "feedback_total": o.registry.value("router_feedback_total"),
            "magnitude_count": mag.count,
            "approx": {"ratings": list(mon.ratings),
                       "magnitude": [mag.sum]}}


# ---------------------------------------------------------------------------
# tests/test_alerts.py
# ---------------------------------------------------------------------------

def hub_fans_out_and_counts(pkg):
    reg = pkg.METRICS.MetricsRegistry()
    a, b = _Capture(), _Capture()
    hub = pkg.ALERTS.AlertSinkHub([a], registry=reg).add_sink(b)
    assert len(hub) == 2
    assert hub.deliver({"kind": "x", "v": 1}) == 2
    assert a.payloads == b.payloads == [{"kind": "x", "v": 1}]
    assert reg.value("alert_sink_delivered_total") == 2
    assert reg.value("alert_sink_errors_total") == 0
    return {"payloads": a.payloads, "prom": reg.prometheus_text()}


def hub_isolates_raising_sink(pkg):
    reg = pkg.METRICS.MetricsRegistry()
    boom, ok = _Boom(), _Capture()
    hub = pkg.ALERTS.AlertSinkHub([boom, ok], registry=reg)
    assert hub.deliver({"kind": "x"}) == 1
    assert boom.calls == 1
    assert ok.payloads == [{"kind": "x"}]
    assert reg.value("alert_sink_errors_total") == 1
    assert reg.value("alert_sink_delivered_total") == 1
    for _ in range(3):
        hub.deliver({"kind": "x"})
    assert reg.value("alert_sink_errors_total") == 4
    return {"prom": reg.prometheus_text()}


def hub_fire_once_key_and_reset(pkg):
    cap = _Capture()
    hub = pkg.ALERTS.AlertSinkHub([cap],
                                  registry=pkg.METRICS.MetricsRegistry())
    got = [hub.deliver({"kind": "p"}, key="k"),
           hub.deliver({"kind": "p"}, key="k"),
           hub.deliver({"kind": "p"}, key="k2")]
    hub.reset("k")
    got.append(hub.deliver({"kind": "p"}, key="k"))
    assert got == [1, 0, 1, 1]
    assert len(cap.payloads) == 3
    return {"delivered": got}


def hub_key_claimed_even_without_sinks(pkg):
    hub = pkg.ALERTS.AlertSinkHub([], registry=pkg.METRICS.MetricsRegistry())
    assert hub.deliver({"kind": "p"}, key="k") == 0
    cap = _Capture()
    hub.add_sink(cap)
    assert hub.deliver({"kind": "p"}, key="k") == 0
    assert cap.payloads == []
    return {"payloads": cap.payloads}


def _paged_engine(pkg, sinks):
    reg = pkg.METRICS.MetricsRegistry()
    g = reg.gauge("depth")
    eng = pkg.SLO.SLOEngine(reg, [pkg.SLO.SLORule("depth", "depth", "<=",
                                                  10.0)],
                            short_window=4, long_window=8, page_burn=0.5,
                            sinks=sinks)
    return reg, g, eng


def slo_page_delivers_once_per_incident(pkg):
    cap = _Capture()
    reg, g, eng = _paged_engine(pkg, [cap])
    g.set(5.0)
    docs = [eng.evaluate() for _ in range(8)]
    assert cap.payloads == []
    g.set(50.0)
    docs += [eng.evaluate() for _ in range(8)]
    assert "page" in [d["rules"][0]["status"] for d in docs[8:]]
    assert len(cap.payloads) == 1
    p = cap.payloads[0]
    assert p["kind"] == "slo_page" and p["rule"] == "depth"
    assert p["value"] == 50.0 and p["bound"] == 10.0
    assert p["burn_short"] >= 0.5 and p["burn_long"] >= 0.5
    return {"evaluations": docs, "payloads": cap.payloads}


def slo_repage_after_recovery_delivers_again(pkg):
    cap = _Capture()
    reg, g, eng = _paged_engine(pkg, [cap])
    g.set(50.0)
    statuses = []
    while not statuses or statuses[-1] != "page":
        statuses.append(eng.evaluate()["rules"][0]["status"])
    assert len(cap.payloads) == 1
    g.set(5.0)
    statuses.append(eng.evaluate()["rules"][0]["status"])
    assert statuses[-1] == "ok"
    g.set(50.0)
    statuses.append(eng.evaluate()["rules"][0]["status"])
    while statuses[-1] != "page":
        statuses.append(eng.evaluate()["rules"][0]["status"])
    assert len(cap.payloads) == 2
    return {"statuses": statuses, "payloads": cap.payloads}


def slo_raising_sink_does_not_break_evaluate(pkg):
    boom = _Boom()
    reg, g, eng = _paged_engine(pkg, [boom])
    g.set(50.0)
    docs = [eng.evaluate() for _ in range(10)]
    assert boom.calls == 1
    assert reg.value("alert_sink_errors_total") == 1
    return {"evaluations": docs}


def _drifting_monitor(pkg, sinks):
    cfg = pkg.Q.QualityConfig(min_samples=8, z_threshold=4.0,
                              ewma_alpha=0.2, min_std=1e-3)
    return pkg.Q.RouterQualityMonitor(["a", "b"], [1.0, 2.0],
                                      [1500.0, 1500.0], cfg=cfg, sinks=sinks)


def quality_alert_pushes_to_sink(pkg):
    cap = _Capture()
    m = _drifting_monitor(pkg, [cap])
    rng = np.random.default_rng(0)
    for _ in range(16):
        m.observe_ratings(1500.0 + rng.normal(0.0, 1.0, 2))
    assert cap.payloads == []
    m.observe_ratings([1500.0, 2500.0])
    assert "rating_drift" in [p["alert"] for p in cap.payloads]
    p = cap.payloads[0]
    assert p["kind"] == "quality_alert" and abs(p["z"]) > 4.0
    return {"payloads": cap.payloads}


def quality_raising_sink_does_not_break_fold(pkg):
    boom, ok = _Boom(), _Capture()
    m = _drifting_monitor(pkg, [boom, ok])
    rng = np.random.default_rng(0)
    for _ in range(16):
        m.observe_ratings(1500.0 + rng.normal(0.0, 1.0, 2))
    m.observe_ratings([1500.0, 2500.0])
    assert boom.calls >= 1
    assert len(ok.payloads) == boom.calls
    assert m.alerts_fired == boom.calls
    return {"payloads": ok.payloads}


def _jsonl(path):
    docs = [json.loads(ln) for ln in path.read_text().strip().splitlines()]
    for d in docs:
        assert isinstance(d.pop("ts"), float)   # wall time: not compared
    return docs


def logfile_sink_webhook_shaped_jsonl(pkg, tmp_path):
    path = tmp_path / f"{pkg.name}.jsonl"
    sink = pkg.ALERTS.LogFileSink(path)
    sink({"kind": "quality_alert", "alert": "rating_drift", "z": 7.5})
    sink({"kind": "slo_page", "rule": "depth"})
    docs = _jsonl(path)
    assert [d["event"] for d in docs] == ["quality_alert", "slo_page"]
    assert [d["seq"] for d in docs] == [1, 2]
    assert docs[0]["payload"]["z"] == 7.5
    assert docs[1]["payload"]["rule"] == "depth"
    return {"docs": docs}


def logfile_sink_on_engine_end_to_end(pkg, tmp_path):
    path = tmp_path / f"{pkg.name}.jsonl"
    reg, g, eng = _paged_engine(pkg, [pkg.ALERTS.LogFileSink(path)])
    g.set(50.0)
    for _ in range(8):
        eng.evaluate()
    docs = _jsonl(path)
    assert len(docs) == 1 and docs[0]["event"] == "slo_page"
    return {"docs": docs}


# ---------------------------------------------------------------------------
# tests/test_exporter.py: the endpoints over a populated scope
# ---------------------------------------------------------------------------

def _world(pkg):
    """Populated scope + an exporter on an ephemeral port (not started)."""
    o = pkg.OBS.Observability(enabled=True)
    o.registry.counter("req_total", "requests", model="a").inc(5)
    h = o.registry.histogram("lat_us", "latency", bounds=[1.0, 10.0])
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    with o.span("outer"):
        with o.span("inner"):
            pass
    for i in range(6):
        o.events.emit({"kind": "route", "rid": i, "model": "a"})
    o.events.emit({"kind": "swap", "gen": 1})
    mon = pkg.Q.RouterQualityMonitor(["a", "b"], [1.0, 2.0],
                                     [1500.0, 1500.0], obs=o)
    mon.observe_batch([5.0, 5.0], [0, 1])
    slo = pkg.SLO.SLOEngine(o.registry, pkg.SLO.default_serving_rules(),
                            obs=o)
    return o, pkg.EXP.ObsExporter(o, slo=slo, quality=mon)


def _json_shape(doc):
    """The keys of a JSON document, recursively (values dropped)."""
    if isinstance(doc, dict):
        return {k: _json_shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_json_shape(v) for v in doc]
    return type(doc).__name__


def exporter_all_endpoints_smoke(pkg):
    o, ex = _world(pkg)
    with ex:
        assert ex.port > 0
        got = {}
        for path in pkg.EXP.ROUTES:
            status, ct, body = _get(ex.url(path))
            assert status == 200, path
            got[path] = ct
        for path in pkg.EXP.ROUTES:
            assert o.registry.value("exporter_scrapes_total",
                                    path=path) == 1
    return {"content_types": got, "routes": list(pkg.EXP.ROUTES)}


def exporter_metrics_endpoint(pkg):
    o, ex = _world(pkg)
    with ex:
        status, ct, body = _get(ex.url("/metrics"))
    assert ct == "text/plain; version=0.0.4; charset=utf-8"
    text = body.decode()
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            assert _PROM_SAMPLE.match(line), line
    assert 'req_total{model="a"} 5' in text
    assert "lat_us_count 3" in text
    assert "slo_status{" in text
    # the scrape counts itself once the body is rendered: the samples
    # are the same text on both packages
    return {"text": text}


def exporter_trace_endpoint(pkg):
    _, ex = _world(pkg)
    with ex:
        _, ct, body = _get(ex.url("/trace"))
    assert ct.startswith("application/json")
    doc = json.loads(body)
    names = [e["name"] for e in doc["traceEvents"]]
    assert {"outer", "inner"} <= set(names)
    return {"names": sorted(names),
            "keys": sorted({k for e in doc["traceEvents"] for k in e}),
            "shape": sorted(k for k in doc)}


def exporter_decisions_endpoint(pkg):
    _, ex = _world(pkg)
    with ex:
        _, ct, body = _get(ex.url("/decisions?n=3"))
        recs = [json.loads(ln) for ln in body.decode().splitlines()]
        assert ct.startswith("application/x-ndjson")
        assert [r["rid"] for r in recs] == [3, 4, 5]
        assert all(r["kind"] == "route" for r in recs)
        _, _, body = _get(ex.url("/decisions?n=100&kind=all"))
    kinds = [json.loads(ln)["kind"] for ln in body.decode().splitlines()]
    assert "swap" in kinds
    return {"tail": recs, "kinds": kinds}


def exporter_healthz_slo_quality(pkg):
    o, ex = _world(pkg)
    with ex:
        _, _, body = _get(ex.url("/healthz"))
        health = json.loads(body)
        _, _, body = _get(ex.url("/slo"))
        slo = json.loads(body)
        _, _, body = _get(ex.url("/quality"))
        quality = json.loads(body)
    assert health["status"] == "ok" and health["enabled"]
    assert health["events"]["emitted"] == o.events.emitted
    assert sorted(health["endpoints"]) == sorted(pkg.EXP.ROUTES)
    assert {r["rule"] for r in slo["rules"]} == {
        r.name for r in pkg.SLO.default_serving_rules()}
    by = {r["rule"]: r for r in slo["rules"]}
    assert by["queue_wait_p99"]["status"] == "no_data"
    assert by["queue_wait_p99"]["breaches_total"] == 0
    assert quality["decisions"] == 2
    assert quality["selection_share"] == {"a": 0.5, "b": 0.5}
    uptime = health.pop("uptime_s")
    assert uptime >= 0.0
    return {"healthz": health, "healthz_shape": _json_shape(health),
            "slo": slo, "quality": quality}


def exporter_404_and_stop(pkg):
    _, ex = _world(pkg)
    ex.start()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(ex.url("/nope"))
    assert ei.value.code == 404
    url = ex.url("/metrics")
    ex.stop()
    with pytest.raises(urllib.error.URLError):
        _get(url, timeout=2)
    ex.stop()
    return {"code": ei.value.code}


def start_exporter_helper(pkg):
    o = pkg.OBS.Observability(enabled=True)
    ex = pkg.EXP.start_exporter(o)
    try:
        status, _, body = _get(ex.url("/slo"))
        slo = json.loads(body)
        assert status == 200 and slo["status"] == "no_rules"
        _, _, body = _get(ex.url("/quality"))
        quality = json.loads(body)
        assert quality["status"] == "no_monitor"
    finally:
        ex.stop()
    return {"slo": slo, "quality": quality}


# ---------------------------------------------------------------------------
# tests/test_exporter.py: SLO engine semantics
# ---------------------------------------------------------------------------

def slo_rule_roundtrip_and_validation(pkg):
    R = pkg.SLO.SLORule
    r = R("r1", "m", "<=", 5.0, stat="p99", help="h")
    assert R.from_dict(r.as_dict()) == r
    assert "labels" not in r.as_dict()
    with pytest.raises(AssertionError):
        R("bad", "m", "==", 1.0)
    with pytest.raises(AssertionError):
        R("bad", "m", "<=", 1.0, stat="p12")
    return {"dict": r.as_dict()}


def slo_rule_value_stats_and_ratio(pkg):
    R = pkg.SLO.SLORule
    reg = pkg.METRICS.MetricsRegistry()
    h = reg.histogram("wait_us", bounds=[1.0, 10.0, 100.0])
    for v in [2.0] * 9 + [50.0]:
        h.observe(v)
    reg.counter("shed_total").inc(5)
    reg.counter("sub_total").inc(100)
    eng = pkg.SLO.SLOEngine(reg, [
        R("p99", "wait_us", "<=", 40.0, stat="p99"),
        R("mean", "wait_us", "<=", 10.0, stat="mean"),
        R("n", "wait_us", ">=", 10.0, stat="count"),
        R("rate", "shed_total", "<=", 0.1, per="sub_total"),
        R("ghost", "absent_metric", "<=", 1.0),
    ])
    values = [eng.rule_value(r) for r in eng.rules]
    assert values[1] == pytest.approx(6.8)
    assert values[2] == 10.0
    assert values[3] == pytest.approx(0.05)
    assert values[4] is None
    doc = eng.evaluate()
    by = {r["rule"]: r for r in doc["rules"]}
    assert by["p99"]["status"] == "breach"
    assert by["mean"]["status"] == "ok"
    assert by["n"]["status"] == "ok"
    assert by["rate"]["status"] == "ok"
    assert by["ghost"]["status"] == "no_data"
    assert doc["status"] == "breach"
    return {"values": values, "evaluation": doc}


def slo_ratio_zero_denominator_is_no_data(pkg):
    reg = pkg.METRICS.MetricsRegistry()
    reg.counter("shed_total").inc(3)
    reg.counter("sub_total")
    eng = pkg.SLO.SLOEngine(reg, [pkg.SLO.SLORule(
        "r", "shed_total", "<=", 0.1, per="sub_total")])
    assert eng.rule_value(eng.rules[0]) is None
    return {"evaluation": eng.evaluate()}


def slo_burn_rate_transitions(pkg):
    reg = pkg.METRICS.MetricsRegistry()
    g = reg.gauge("depth")
    eng = pkg.SLO.SLOEngine(reg, [pkg.SLO.SLORule("depth", "depth", "<=",
                                                  10.0)],
                            short_window=4, long_window=8, page_burn=0.5)
    docs = []

    def status():
        docs.append(eng.evaluate())
        return docs[-1]["rules"][0]["status"]

    g.set(5.0)
    assert [status() for _ in range(8)] == ["ok"] * 8
    g.set(50.0)
    assert [status() for _ in range(5)] == ["breach"] * 3 + ["page"] * 2
    assert reg.value("slo_breach_total", rule="depth") == 5
    assert reg.value("slo_status", rule="depth") == 2.0
    g.set(5.0)
    assert status() == "ok"
    assert reg.value("slo_status", rule="depth") == 0.0
    assert reg.value("slo_breach_total", rule="depth") == 5
    assert reg.value("slo_evaluations_total") == 14
    return {"evaluations": docs, "prom": reg.prometheus_text()}


def slo_duplicate_rule_names_rejected(pkg):
    R = pkg.SLO.SLORule
    with pytest.raises(AssertionError):
        pkg.SLO.SLOEngine(pkg.METRICS.MetricsRegistry(),
                          [R("x", "m", "<=", 1.0), R("x", "m2", "<=", 1.0)])
    return {}


SCENARIOS = [
    regret_randomized, regret_zero_when_choice_is_best_feasible,
    regret_infeasible_budget_uses_cheapest_fallback,
    regret_boundary_cost_equals_budget,
    drift_detector_quiet_on_stationary_noise,
    drift_detector_fires_once_then_readapts,
    drift_detector_respects_min_samples,
    drift_detector_variance_floor_on_flat_series,
    monitor_score_batch_accounting, monitor_win_rate_and_feedback,
    monitor_trajectories_bounded_and_refreshed,
    monitor_alert_on_injected_rating_step, monitor_regret_drift_alert,
    monitor_observe_batch_is_deferred,
    monitor_max_pending_overflow_flushes_inline,
    monitor_disabled_scope_emits_no_events,
    decision_log_replay_determinism, engine_feeds_quality_monitor,
    router_feedback_feeds_quality_monitor,
    hub_fans_out_and_counts, hub_isolates_raising_sink,
    hub_fire_once_key_and_reset, hub_key_claimed_even_without_sinks,
    slo_page_delivers_once_per_incident,
    slo_repage_after_recovery_delivers_again,
    slo_raising_sink_does_not_break_evaluate,
    quality_alert_pushes_to_sink, quality_raising_sink_does_not_break_fold,
    exporter_all_endpoints_smoke, exporter_metrics_endpoint,
    exporter_trace_endpoint, exporter_decisions_endpoint,
    exporter_healthz_slo_quality, exporter_404_and_stop,
    start_exporter_helper,
    slo_rule_roundtrip_and_validation, slo_rule_value_stats_and_ratio,
    slo_ratio_zero_denominator_is_no_data, slo_burn_rate_transitions,
    slo_duplicate_rule_names_rejected,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    _assert_traces_equal(got, want)


@pytest.mark.parametrize("scenario", [logfile_sink_webhook_shaped_jsonl,
                                      logfile_sink_on_engine_end_to_end],
                         ids=lambda f: f.__name__)
def test_file_sink_scenario_matches_jax(scenario, tmp_path):
    want = scenario(PKGS["jax"], tmp_path)
    got = scenario(PKGS["torch"], tmp_path)
    _assert_traces_equal(got, want)


# ---------------------------------------------------------------------------
# regret and drift across the packages on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_regret_bit_equal_across_packages_and_oracles(seed):
    """Same ratings, costs, budgets and choices: the two packages' regret
    are equal bit for bit, and each equals its own oracle, including the
    cheapest-model fallback (budgets below every cost) and cost ==
    budget (budgets drawn from the costs)."""
    rng = np.random.default_rng(100 + seed)
    m, b = 10, 257
    ratings = rng.normal(1500.0, 150.0, m)
    costs = rng.uniform(0.5, 10.0, m)
    budgets = np.concatenate([rng.uniform(0.0, 12.0, b - 20),
                              rng.choice(costs, 10),
                              np.full(10, costs.min() / 2)])
    choices = rng.integers(0, m, b)
    out = {}
    for name, pkg in PKGS.items():
        got = pkg.Q.routing_regret(ratings, costs, budgets, choices)
        assert np.array_equal(got, pkg.Q.routing_regret_oracle(
            ratings, costs, budgets, choices))
        out[name] = got
    assert out["torch"].tobytes() == out["jax"].tobytes()


def test_drift_alerts_at_the_same_fold_with_the_same_z():
    """A stationary run then a +400 step on one model and a regret
    regression: each package's alerts land at the same fold, for the
    same model, with the same z."""
    alerts = {}
    for name, pkg in PKGS.items():
        o = pkg.OBS.Observability(enabled=True)
        mon = pkg.Q.RouterQualityMonitor(
            [f"m{i}" for i in range(5)], np.linspace(1.0, 8.0, 5),
            np.full(5, 1500.0), obs=o)
        rng = np.random.default_rng(9)
        base = rng.normal(1500.0, 50.0, 5)
        for step in range(150):
            mon.observe_batch(rng.uniform(1.0, 8.0, 16),
                              rng.integers(0, 5, 16) if step != 140
                              else np.full(16, 0))
            if step % 2:
                r = base + rng.normal(0.0, 1.0, 5)
                if step >= 120:           # past 32 folds of warmup
                    r[2] += 400.0
                mon.observe_ratings(r)
        alerts[name] = o.events.records("quality_alert")
        assert any(a["alert"] == "rating_drift" and a["model"] == "m2"
                   for a in alerts[name])
    assert _canon(alerts["torch"]) == _canon(alerts["jax"])


# ---------------------------------------------------------------------------
# the core's write-side counters
# ---------------------------------------------------------------------------

_COUNTERS = ("vectordb_records_total", "vectordb_size", "vectordb_capacity",
             "vectordb_grow_total", "dbuf_swaps_total", "dbuf_dirty_backlog",
             "router_feedback_total", "serve_requests_total",
             "serve_feedback_total", "serve_commits_total")
_HIST_COUNTS = ("router_elo_update_magnitude", "dbuf_commit_us",
                "serve_route_us", "serve_feedback_us", "serve_commit_us")


def _counters(default_obs, obs):
    """The new counters' values and the histograms' counts (their
    times differ, their counts do not), from the engine's scope and the
    process default scope (the VectorDB's)."""
    out = {}
    for name in _COUNTERS:
        v = obs.registry.value(name)
        out[name] = default_obs.registry.value(name) if v is None else v
    for name in _HIST_COUNTS:
        h = obs.registry.find(name)
        out[name] = None if h is None else h.count
    out["db_grow_events"] = [
        {k: e[k] for k in ("from", "to", "size")}
        for e in default_obs.events.records("db_grow")]
    return out


def test_core_counters_after_fit_feedback_serve_match_jax():
    """A seeded fit -> feedback x 3 -> serve() on each package (a DB that
    grows on the way, a stub fleet: routing and feedback do not read the
    tokens) leaves equal values in the core's new counters, and an
    update-magnitude histogram whose sum agrees within the ratings
    tolerance."""
    dim, names = 16, ["a", "b", "c"]
    rng0 = np.random.default_rng(5)
    emb = rng0.normal(size=(60, dim)).astype(np.float32)
    ma = rng0.integers(0, 3, 60)
    mb = (ma + 1 + rng0.integers(0, 2, 60)) % 3
    outcome = rng0.choice([0.0, 0.5, 1.0], 60).astype(np.float32)
    fb = [(rng0.normal(size=(12, dim)).astype(np.float32),
           rng0.integers(0, 3, 12), rng0.integers(0, 3, 12),
           rng0.choice([0.0, 1.0], 12).astype(np.float32))
          for _ in range(3)]
    reqs = [(rng0.normal(size=dim).astype(np.float32),
             float(rng0.uniform(0.5, 6.0))) for _ in range(10)]
    out, approx = {}, {}
    for name, pkg in PKGS.items():
        pkg.OBS.DEFAULT.enable()          # the db_grow events
        o = pkg.OBS.Observability(enabled=True)
        router = pkg.router(names, [1.0, 2.0, 4.0],
                            pkg.Config(embed_dim=dim), db_capacity=32)
        router.fit(emb, ma, mb, outcome)
        eng = pkg.ENG.ServingEngine(
            {n: _StubModel() for n in names}, router, compare_rate=0.5,
            seed=0, quality_oracle=lambda e, mi: float(mi) / 3, obs=o)
        for a in fb:
            router.feedback(*a)
        eng.serve([pkg.ENG.Request(tokens=np.arange(4, dtype=np.int32),
                                   embedding=e, budget=b, max_new_tokens=2,
                                   rid=k)
                   for k, (e, b) in enumerate(reqs)])
        out[name] = _counters(pkg.OBS.DEFAULT, o)
        approx[name] = o.registry.find("router_elo_update_magnitude").sum
    assert out["torch"] == out["jax"]
    assert out["torch"]["vectordb_grow_total"] >= 1
    assert out["torch"]["router_feedback_total"] > 36
    assert out["torch"]["dbuf_swaps_total"] == 1
    np.testing.assert_allclose(approx["torch"], approx["jax"], rtol=R_RTOL,
                               atol=R_ATOL)


def test_feedback_with_obs_disabled_takes_no_readout():
    """Obs disabled: the counter still counts, no magnitude is observed
    and no monitor is fed (the JAX gating)."""
    out = {}
    for name, pkg in PKGS.items():
        o = pkg.OBS.Observability(enabled=False)
        router = _small_router(pkg)
        router.obs = o
        mon = pkg.Q.RouterQualityMonitor.for_router(router, obs=o)
        router.feedback(np.ones((2, 16), np.float32), [0, 1], [1, 0],
                        [1.0, 0.0])
        out[name] = (o.registry.value("router_feedback_total"),
                     o.registry.find("router_elo_update_magnitude"),
                     mon.snapshot()["feedback_folds"])
    assert out["torch"] == out["jax"] == (2, None, 0)


# ---------------------------------------------------------------------------
# the exporter's routes, and the launcher's obs plane
# ---------------------------------------------------------------------------

#: the port's name for the JAX package's process-wide compile count: its
#: counterpart counts CUDA graph captures (graphs.capture_count)
_PORT_NAMES = {"graph_captures_total": "xla_compiles_total"}


def _metric_names(text):
    return sorted({_PORT_NAMES.get(n, n) for n in (
        ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
        if not ln.startswith("#"))})


def _scrape_all(ex, routes):
    """route -> (content type, the JSON shape or the metric names). The
    trace's events by their keys and span names: the port's launcher
    warms its route graphs at build, so its dispatch.compile spans and
    their count differ."""
    out = {}
    for path in routes:
        status, ct, body = _get(ex.url(path))
        assert status == 200, path
        if path == "/metrics":
            shape = _metric_names(body.decode())
        elif path == "/trace":
            doc = json.loads(body)
            evs = doc.pop("traceEvents")
            shape = (_json_shape(doc),
                     sorted({k for e in evs for k in e}),
                     sorted({e["name"] for e in evs
                             if not e["name"].startswith(
                                 "dispatch.compile")}))
        elif path == "/decisions":
            shape = [sorted(json.loads(ln)) for ln in
                     body.decode().splitlines()]
        else:
            shape = _json_shape(json.loads(body))
        out[path] = (ct, shape)
    return out


def test_build_obs_plane_over_build_engine_matches_jax():
    """`build_obs_plane` over each package's launcher engine (reduced
    ARCH_IDS[:2]: whisper-large-v3 and olmo-1b, routers fitted on the
    same corpus): equal choices over two serve() calls, an equal
    `/quality` snapshot but for its float ratings (within the ratings
    tolerance), the same content types, JSON keys and metric names on
    every route, and equal core counters."""
    from repro.launch import serve as JSERVE
    from repro_torch.launch import serve as TSERVE
    engines = {"jax": JSERVE.build_engine(n_fleet=2,
                                          obs=JOBS.Observability(
                                              enabled=True)),
               "torch": TSERVE.build_engine(n_fleet=2, device="cpu",
                                            obs=TOBS.Observability(
                                                enabled=True))}
    build = {"jax": JSERVE.build_obs_plane, "torch": TSERVE.build_obs_plane}
    # the JAX launcher's simulated user hashes with Python's salted
    # `hash`; both take the port's (crc32) so their feedback is the same
    engines["jax"][0].quality_oracle = TSERVE.quality_oracle
    corpus = engines["jax"][1]
    rng = np.random.default_rng(11)
    budgets = [1.0, 2.5, 3.5, 5.5, 6.5, 8.0, 9.0, 10.0]
    args = [(rng.integers(0, 100, rng.integers(4, 12)).astype(np.int32),
             corpus.embeddings[i], b)
            for i, b in zip(corpus.test_idx[:16], budgets * 2)]
    out = {}
    for name, (eng, _) in engines.items():
        pkg = PKGS[name]
        ex = build[name](eng)
        before = _counters(pkg.OBS.DEFAULT, eng.obs)
        try:
            assert eng.router.quality is eng.quality
            models = []
            for lo in (0, 8):
                res = eng.serve([pkg.ENG.Request(
                    tokens=t, embedding=e, budget=b, max_new_tokens=2,
                    rid=lo + k) for k, (t, e, b) in enumerate(
                        args[lo:lo + 8])])
                models += [r.model for r in res]
            _, _, body = _get(ex.url("/quality"))
            quality = json.loads(body)
            shapes = _scrape_all(ex, pkg.EXP.ROUTES)
        finally:
            ex.stop()
        counters = _counters(pkg.OBS.DEFAULT, eng.obs)
        # the port's launcher warms at build with a commit per replica
        for key in ("dbuf_swaps_total", "dbuf_commit_us"):
            counters[key] -= before[key] or 0
        out[name] = dict(models=models, quality=quality, shapes=shapes,
                         counters=counters)
    got, want = out["torch"], out["jax"]
    assert got["models"] == want["models"]
    assert len(set(got["models"])) == 2
    assert got["quality"]["decisions"] == 16
    g_r, w_r = got["quality"].pop("ratings"), want["quality"].pop("ratings")
    assert list(g_r) == list(w_r)
    np.testing.assert_allclose(list(g_r.values()), list(w_r.values()),
                               rtol=R_RTOL, atol=R_ATOL)
    # trajectories and regret ride the ratings: allclose, not bitwise
    for key in ("trajectory_tail", "regret"):
        g, w = got["quality"].pop(key), want["quality"].pop(key)
        np.testing.assert_allclose(_floats(g), _floats(w), rtol=R_RTOL,
                                   atol=R_ATOL, err_msg=key)
    assert got["quality"] == want["quality"]
    assert got["shapes"] == want["shapes"]
    assert got["counters"] == want["counters"]


def _floats(doc):
    """Every number of a JSON document, in key order."""
    if isinstance(doc, dict):
        return [x for k in sorted(doc) for x in _floats(doc[k])]
    if isinstance(doc, list):
        return [x for v in doc for x in _floats(v)]
    return [float(doc)]


def test_launcher_cli_serves_the_obs_plane(monkeypatch, capsys, tmp_path):
    """`--serve-obs 0 --alert-log PATH`: the engine's scope is enabled,
    the plane's URL line is printed, and the exporter is stopped at the
    end (build_engine bound to the CPU here; the CLI defaults to the
    card)."""
    from repro_torch.launch import serve as TSERVE
    built = {}
    orig = TSERVE.build_engine

    def on_cpu(*a, **kw):
        built["engine"], corpus = orig(*a, device="cpu", **kw)
        return built["engine"], corpus
    monkeypatch.setattr(TSERVE, "build_engine", on_cpu)
    made = []
    orig_plane = TSERVE.build_obs_plane
    monkeypatch.setattr(TSERVE, "build_obs_plane",
                        lambda *a, **kw: made.append(orig_plane(*a, **kw))
                        or made[-1])
    TSERVE.main(["--serve-obs", "0", "--alert-log",
                 str(tmp_path / "alerts.jsonl"), "--fleet", "2",
                 "--requests", "6", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    port = made[0]._requested_port
    assert port == 0
    assert any(re.fullmatch(r"obs plane at http://127\.0\.0\.1:\d+ "
                            r"\(/metrics /trace /decisions /healthz /slo "
                            r"/quality\)", ln) for ln in out)
    assert out[-1].startswith("stats:")
    eng = built["engine"]
    assert eng.obs.enabled and eng.quality is not None
    assert eng.quality.snapshot()["decisions"] == 6
    assert made[0]._httpd is None           # stopped


def test_decision_columns_as_arrays_read_as_lists():
    """The port's engine hands `emit_columns` host arrays and the log
    converts them when it is read: the records, and their JSON, equal
    those of the JAX package's list columns."""
    rng = np.random.default_rng(4)
    budgets = rng.uniform(0.5, 9.0, 37).astype(np.float32)
    choices = rng.integers(0, 3, 37).astype(np.int32)
    names = np.asarray(["a", "b", "c"], dtype=object)
    logs = {"jax": JOBS.Observability(enabled=True).events,
            "torch": TOBS.Observability(enabled=True).events}
    logs["jax"].emit_columns(
        "route", 37, {"ts": 1.5, "batch": 37},
        {"rid": list(range(37)), "model": [names[c] for c in choices],
         "model_idx": choices.tolist(), "budget": budgets.tolist()})
    logs["torch"].emit_columns(
        "route", 37, {"ts": 1.5, "batch": 37},
        {"rid": list(range(37)), "model": names[choices],
         "model_idx": choices, "budget": budgets})
    got, want = (logs[k].records("route") for k in ("torch", "jax"))
    assert got == want
    assert [json.dumps(r) for r in got] == [json.dumps(r) for r in want]
    assert logs["torch"].tail(5) == want[-5:]
