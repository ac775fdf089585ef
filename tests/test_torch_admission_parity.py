"""The port's admission frontend and traffic harness
(`serving/admission.py`, `serving/traffic.py`) against the JAX package's,
on the CPU: every scenario of tests/test_admission.py (size and deadline
triggers, drain, priority, shed, reject, metrics and flush log, arrival
processes, the open-loop driver's conservation and overload, the sim
backend) runs on both packages with the same injectable clock, holding
each package to the scenario's own assertions; the flush decisions,
rejections, flush logs and completions of the two must be equal, and so
must the arrival traces. Then an AdmissionQueue in front of the port's
ServingEngine answers exactly what direct serve() calls on the same
coalesced batches answer.
"""
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro import obs as JOBS
from repro.core.dispatch import RouteDispatcher as JDispatcher
from repro.core.router import EagleConfig as JConfig
from repro.core.router import EagleRouter as JRouter
from repro.serving import admission as JADM
from repro.serving import engine as JENG
from repro.serving import traffic as JTR
from repro_torch import obs as TOBS
from repro_torch.configs import get_reduced_config
from repro_torch.core.dispatch import RouteDispatcher as TDispatcher
from repro_torch.core.router import EagleConfig as TConfig
from repro_torch.core.router import EagleRouter as TRouter
from repro_torch.data.routerbench import make_corpus, pairwise_feedback
from repro_torch.serving import admission as TADM
from repro_torch.serving import engine as TENG
from repro_torch.serving import traffic as TTR

jax.config.update("jax_platform_name", "cpu")

PKGS = {
    "jax": SimpleNamespace(
        ADM=JADM, ENG=JENG, TR=JTR, OBS=JOBS,
        router=lambda *a, **kw: JRouter(*a, **kw),
        dispatcher=lambda r, **kw: JDispatcher.for_router(
            r, obs=JOBS.Observability(), **kw)),
    "torch": SimpleNamespace(
        ADM=TADM, ENG=TENG, TR=TTR, OBS=TOBS,
        router=lambda *a, **kw: TRouter(*a, device="cpu", **kw),
        dispatcher=lambda r, **kw: TDispatcher.for_router(r, **kw)),
}


class Clock:
    """Injectable deterministic clock (ns)."""

    def __init__(self, t: int = 0):
        self.t = t

    def __call__(self) -> int:
        return self.t

    def advance_ms(self, ms: float):
        self.t += int(ms * 1e6)


class EchoServer:
    """serve() stub recording every flushed batch."""

    def __init__(self, pkg, latency_s: float = 0.001):
        self.pkg = pkg
        self.batches = []
        self.latency_s = latency_s

    def serve(self, reqs):
        self.batches.append(list(reqs))
        return [self.pkg.ENG.Response(r.rid, "m0", np.empty(0, np.int32),
                                      self.latency_s) for r in reqs]


def _req(pkg, rid, budget=5.0, deadline_ms=math.inf, priority=0, dim=4):
    return pkg.ENG.Request(tokens=np.empty(0, np.int32),
                           embedding=np.full(dim, rid, np.float32),
                           budget=budget, rid=rid, deadline_ms=deadline_ms,
                           priority=priority)


def _queue(pkg, server, clock, obs=None, **cfg_kw):
    cfg_kw.setdefault("window_bucket", 8)
    cfg_kw.setdefault("max_wait_ms", 5.0)
    cfg_kw.setdefault("min_bucket", 8)
    return pkg.ADM.AdmissionQueue(server.serve,
                                  pkg.ADM.AdmissionConfig(**cfg_kw),
                                  obs=obs or pkg.OBS.Observability(),
                                  now_ns=clock)


def _trace(q, out, srv=None, rejections=()):
    """Everything the two packages must agree on, as plain values."""
    return {
        "completed": [(c.rid, c.flush_reason, c.wait_us, c.service_us,
                       c.shed, c.priority) for c in out],
        "rejections": [(r.rid, r.reason, r.depth, r.priority)
                       for r in rejections],
        "flush_log": [(f.reason, f.n, f.bucket, f.t_ns, f.depth_after,
                       None if f.requests is None else
                       [(r.rid, r.budget) for r in f.requests])
                      for f in q.flush_log],
        "summary": q.summary(),
        "batches": None if srv is None else
        [[(r.rid, r.budget) for r in b] for b in srv.batches],
    }


# ---------------------------------------------------------------------------
# scenarios: each runs on one package, asserts what tests/test_admission.py
# asserts, and returns its trace
# ---------------------------------------------------------------------------

def size_trigger(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk)
    for i in range(7):
        assert q.submit(_req(pkg, i)) is None
    assert q.pump() == []
    assert q.depth == 7
    q.submit(_req(pkg, 7))
    out = q.pump()
    assert [c.rid for c in out] == list(range(8))
    assert all(c.flush_reason == "full" for c in out)
    assert q.depth == 0 and len(srv.batches) == 1
    return _trace(q, out, srv)


def deadline_trigger(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk)
    for i in range(3):
        q.submit(_req(pkg, i))
    clk.advance_ms(4.999)
    assert q.pump() == []
    clk.advance_ms(0.001)
    out = q.pump()
    assert [c.rid for c in out] == [0, 1, 2]
    assert all(c.flush_reason == "deadline" for c in out)
    assert all(abs(c.wait_us - 5000.0) < 1.0 for c in out)
    return _trace(q, out, srv)


def per_request_deadline(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk)
    q.submit(_req(pkg, 0, deadline_ms=1.0))
    q.submit(_req(pkg, 1))
    assert q.next_flush_ns() == int(1e6)
    clk.advance_ms(1.0)
    out = q.pump()
    assert [c.rid for c in out] == [0, 1]
    assert out[0].flush_reason == "deadline"
    return _trace(q, out, srv)


def oversized_backlog(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk)
    for i in range(20):
        q.submit(_req(pkg, i))
    out = q.pump()
    assert len(out) == 16
    clk.advance_ms(5.0)
    out += q.pump()
    assert [len(b) for b in srv.batches] == [8, 8, 4]
    assert sorted(c.rid for c in out) == list(range(20))
    return _trace(q, out, srv)


def drain(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk)
    for i in range(3):
        q.submit(_req(pkg, i))
    out = q.drain()
    assert [c.rid for c in out] == [0, 1, 2]
    assert all(c.flush_reason == "drain" for c in out)
    assert q.depth == 0
    return _trace(q, out, srv)


def priority(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk, window_bucket=8)
    for rid, prio in [(0, 0), (1, 2), (2, 1), (3, 2)]:
        q.submit(_req(pkg, rid, priority=prio))
    out = q.drain()
    assert [c.rid for c in out] == [1, 3, 2, 0]
    assert [c.priority for c in out] == [2, 2, 1, 0]
    return _trace(q, out, srv)


def shed(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk, window_bucket=64, max_wait_ms=50.0,
               shed_watermark=4, reject_cap=8, shed_budget=0.0)
    for i in range(6):
        assert q.submit(_req(pkg, i, budget=9.0)) is None
    out = q.drain()
    flushed = {r.rid: r for r in srv.batches[0]}
    assert [flushed[i].budget for i in range(4)] == [9.0] * 4
    assert [flushed[i].budget for i in (4, 5)] == [0.0, 0.0]
    assert {c.rid for c in out if c.shed} == {4, 5}
    assert q.summary()["shed"] == 2
    return _trace(q, out, srv)


def reject(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    q = _queue(pkg, srv, clk, window_bucket=64, max_wait_ms=50.0,
               shed_watermark=2, reject_cap=4)
    rejs = [q.submit(_req(pkg, i)) for i in range(6)]
    assert rejs[:4] == [None] * 4
    assert all(isinstance(r, pkg.ADM.Rejection) for r in rejs[4:])
    assert rejs[4].reason == "queue_full" and rejs[4].depth == 4
    assert q.depth == 4
    assert q.summary()["rejected"] == 2
    out = q.drain()
    assert sorted(c.rid for c in out) == [0, 1, 2, 3]
    return _trace(q, out, srv, rejs[4:])


def metrics_and_flush_log(pkg):
    clk, srv = Clock(), EchoServer(pkg)
    ob = pkg.OBS.Observability()
    q = _queue(pkg, srv, clk, obs=ob, keep_flushed_requests=True)
    for i in range(8):
        q.submit(_req(pkg, i))
    out = q.pump()
    q.submit(_req(pkg, 8))
    assert ob.registry.value("admission_queue_depth") == 1
    clk.advance_ms(5.0)
    out += q.pump()
    assert ob.registry.value("admission_flush_total", reason="full") == 1
    assert ob.registry.value("admission_flush_total",
                             reason="deadline") == 1
    assert ob.registry.find("admission_wait_us").count == 9
    assert [f.n for f in q.flush_log] == [8, 1]
    assert [len(f.requests) for f in q.flush_log] == [8, 1]
    assert q.flush_log[0].bucket == 8 and q.flush_log[1].bucket == 8
    tr = _trace(q, out, srv)
    tr["metrics"] = {k: v for k, v in ob.registry.json_snapshot().items()
                     if k != "gauges"}
    return tr


def driver_conservation(pkg):
    srv = EchoServer(pkg, latency_s=0.002)
    cfg = pkg.ADM.AdmissionConfig(window_bucket=8, max_wait_ms=5.0,
                                  min_bucket=8, shed_watermark=16,
                                  reject_cap=32)
    q = pkg.ADM.AdmissionQueue(srv.serve, cfg, obs=pkg.OBS.Observability())
    n = 200
    reqs = [_req(pkg, i) for i in range(n)]
    res = pkg.TR.OpenLoopDriver(q, reqs,
                                pkg.TR.poisson_arrivals(2000.0, n,
                                                        seed=5)).run()
    assert len(res.completed) + len(res.rejections) == n
    assert q.depth == 0
    assert (res.wait_us() >= 0).all()
    for c in res.completed:
        assert c.e2e_us == c.wait_us + c.service_us
        assert c.service_us == pytest.approx(2000.0)
    assert res.goodput_hz(1e9) == pytest.approx(
        len(res.completed) / (res.horizon_ns / 1e9))
    tr = _trace(q, res.completed, srv, res.rejections)
    tr["driver"] = (res.depth_series, res.horizon_ns, res.offered)
    return tr


def driver_overload(pkg):
    srv = EchoServer(pkg, latency_s=0.010)
    cfg = pkg.ADM.AdmissionConfig(window_bucket=8, max_wait_ms=5.0,
                                  min_bucket=8, shed_watermark=16,
                                  reject_cap=64)
    q = pkg.ADM.AdmissionQueue(srv.serve, cfg, obs=pkg.OBS.Observability())
    n = 600
    reqs = [_req(pkg, i, budget=9.0) for i in range(n)]
    res = pkg.TR.OpenLoopDriver(q, reqs,
                                pkg.TR.poisson_arrivals(3200.0, n,
                                                        seed=6)).run()
    summ = q.summary()
    assert summ["shed"] > 0
    assert max(d for _, d in res.depth_series) <= 64
    shed_reqs = [r for b in srv.batches for r in b if r.budget == 0.0]
    assert len(shed_reqs) == summ["shed"]
    tr = _trace(q, res.completed, srv, res.rejections)
    tr["driver"] = (res.depth_series, res.horizon_ns, res.offered)
    return tr


def arrivals(pkg):
    tr = pkg.TR
    a = tr.poisson_arrivals(1000.0, 500, seed=3)
    np.testing.assert_array_equal(a, tr.poisson_arrivals(1000.0, 500,
                                                         seed=3))
    assert (np.diff(a) >= 0).all()
    assert 0.7e-3 < (np.diff(a) / 1e9).mean() < 1.3e-3
    b = tr.burst_arrivals(1000.0, 2000, seed=3, cv=3.0)
    bg = np.diff(b) / 1e9
    assert bg.std() / bg.mean() > 1.8
    with pytest.raises(ValueError):
        tr.make_arrivals("uniform", 1.0, 1)
    r = tr.replay_arrivals([10.0, 10.5, 12.0], rate_scale=2.0)
    np.testing.assert_array_equal(r, [0, int(0.25e9), int(1.0e9)])
    recs = [{"ts": 5.0, "rid": 0}, {"ts": 6.0, "rid": 1}, {"rid": 2}]
    d = tr.arrivals_from_decision_log(recs)
    np.testing.assert_array_equal(d, [0, int(1e9)])
    return {"arrays": [x.tolist() for x in
                       (a, b, r, d, tr.make_arrivals("burst", 50.0, 20,
                                                     seed=1))]}


def sim_server(pkg):
    rng = np.random.default_rng(0)
    n_models, dim = 4, 8
    r = pkg.router([f"m{i}" for i in range(n_models)],
                   np.asarray([1.0, 2.0, 4.0, 8.0]),
                   (TConfig if pkg.TR is TTR else JConfig)(embed_dim=dim),
                   db_capacity=64)
    emb = rng.normal(size=(40, dim)).astype(np.float32)
    a = rng.integers(0, n_models, 40)
    b = (a + 1) % n_models
    r.fit(emb, a, b, rng.choice([0.0, 0.5, 1.0], 40),
          query_id=np.arange(40))
    d = pkg.dispatcher(r, max_bucket=16)
    srv = pkg.TR.SimServer(d, r.state, r.model_names, r.costs)
    reqs = [pkg.ENG.Request(tokens=np.empty(0, np.int32), embedding=emb[i],
                            budget=9.0, rid=i) for i in range(10)]
    resps = srv.serve(reqs)
    want = d.route(r.state, emb[:10], np.full(10, 9.0, np.float32))
    assert [x.model for x in resps] == [r.model_names[c] for c in want]
    assert len({x.latency_s for x in resps}) == 1
    poor = [pkg.ENG.Request(tokens=np.empty(0, np.int32), embedding=emb[i],
                            budget=0.0, rid=i) for i in range(10)]
    cheap = srv.serve(poor)
    assert cheap[0].latency_s < resps[0].latency_s
    assert srv.serve([]) == []
    return {"models": [x.model for x in resps + cheap],
            "latency_s": [resps[0].latency_s, cheap[0].latency_s]}


SCENARIOS = [size_trigger, deadline_trigger, per_request_deadline,
             oversized_backlog, drain, priority, shed, reject,
             metrics_and_flush_log, driver_conservation, driver_overload,
             arrivals, sim_server]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want


# ---------------------------------------------------------------------------
# end to end: AdmissionQueue -> the port's ServingEngine
# ---------------------------------------------------------------------------

def test_admission_responses_bit_identical_to_direct_serve():
    """The JAX suite's end-to-end check on the port: coalesced windows
    through a reduced olmo-1b + mamba2-780m engine answer exactly what
    serve() answers on the same batches (no feedback: routing is pure)."""
    names = ["olmo-1b", "mamba2-780m"]
    corpus = make_corpus(seed=0, n_per_dataset=30, dim=32,
                         model_names=names, costs=np.asarray([4.0, 1.0]))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    router = TRouter(names, corpus.costs, TConfig(embed_dim=32),
                     db_capacity=512, device="cpu")
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
               query_id=fb["query_idx"])
    fleet = {n: TENG.FleetModel(get_reduced_config(n), seed=i, max_len=32,
                                device="cpu")
             for i, n in enumerate(names)}
    engine = TENG.ServingEngine(fleet, router, compare_rate=0.0, seed=0,
                                obs=TOBS.Observability())
    clk = Clock()
    q = TADM.AdmissionQueue.for_engine(
        engine, now_ns=clk, window_bucket=8, max_wait_ms=2.0,
        shed_watermark=32, reject_cap=64, keep_flushed_requests=True)
    rng = np.random.default_rng(3)
    reqs = [TENG.Request(tokens=rng.integers(0, 64, 6).astype(np.int32),
                         embedding=corpus.embeddings[corpus.test_idx[k]],
                         budget=float(b), max_new_tokens=2, rid=k)
            for k, b in enumerate(rng.uniform(1.0, 8.0, 12))]
    completed = []
    for r in reqs:
        clk.advance_ms(0.3)
        q.submit(r)
        completed += q.pump()
    clk.advance_ms(5.0)
    completed += q.pump()
    assert sorted(c.rid for c in completed) == list(range(12))
    assert [f.n for f in q.flush_log] == [8, 4]
    assert {c.response.model for c in completed} == set(names)
    direct = {}
    for fr in q.flush_log:
        for resp in engine.serve(fr.requests):
            direct[resp.rid] = resp
    for c in completed:
        d = direct[c.rid]
        assert d.model == c.response.model
        np.testing.assert_array_equal(d.tokens, c.response.tokens)
