"""The port's ServingEngine against the JAX package's, on the CPU: the same
reduced dense fleet (olmo-1b and qwen3-8b, fp32, the JAX weights carried
across), routers fitted on the same feedback, the same seeded requests and
quality oracle, every request compared (compare_rate = 1.0).

Choices, generated tokens, `stats` and the decision log must be equal;
the global ratings after the online feedback within rtol 1e-5 / atol 1e-3
(the JAX suite's bar between its backends, tests/test_router_state.py).
"""
import zlib

import jax
import numpy as np
import pytest

from repro import obs as JOBS
from repro.configs import get_reduced_config as j_reduced
from repro.core.router import EagleConfig as JConfig
from repro.core.router import EagleRouter as JRouter
from repro.data.routerbench import make_corpus, pairwise_feedback
from repro.serving import engine as JENG
from repro_torch import convert
from repro_torch import obs as TOBS
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core.router import EagleConfig as TConfig
from repro_torch.core.router import EagleRouter as TRouter
from repro_torch.serving import engine as TENG

jax.config.update("jax_platform_name", "cpu")

NAMES = ["olmo-1b", "qwen3-8b"]
DIM = 64
MAX_LEN = 64
R_RTOL, R_ATOL = 1e-5, 1e-3


def oracle(emb, mi):
    """The serving launcher's simulated user, with a deterministic hash
    (crc32) in place of Python's salted one."""
    return float(np.random.default_rng(
        zlib.crc32(emb[:2].tobytes() + bytes([mi]))).random())


@pytest.fixture(scope="module")
def world():
    corpus = make_corpus(seed=0, n_per_dataset=60, dim=DIM, model_names=NAMES,
                         costs=np.linspace(1.0, 8.0, len(NAMES)))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    jfleet = {n: JENG.FleetModel(j_reduced(n, dtype="float32"), seed=i,
                                 max_len=MAX_LEN)
              for i, n in enumerate(NAMES)}
    return corpus, fb, jfleet


def _engines(world, **kw):
    corpus, fb, jfleet = world
    args = (fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    jr = JRouter(NAMES, corpus.costs, JConfig(embed_dim=DIM),
                 db_capacity=1 << 12)
    jr.fit(*args)
    tr = TRouter(NAMES, corpus.costs, TConfig(embed_dim=DIM),
                 db_capacity=1 << 12, device="cpu")
    tr.fit(*args)
    tfleet = {n: TENG.FleetModel(
        t_reduced(n, dtype="float32"), max_len=MAX_LEN, device="cpu",
        params=convert.model_params_from_numpy(
            t_reduced(n, dtype="float32"), m.params, device="cpu"))
        for n, m in jfleet.items()}
    je = JENG.ServingEngine(jfleet, jr, compare_rate=1.0, seed=0,
                            quality_oracle=oracle,
                            obs=JOBS.Observability(enabled=True), **kw)
    te = TENG.ServingEngine(tfleet, tr, compare_rate=1.0, seed=0,
                            quality_oracle=oracle,
                            obs=TOBS.Observability(enabled=True), **kw)
    return je, te


def _requests(corpus, cls, seed, n):
    rng = np.random.default_rng(seed)
    idx = rng.choice(corpus.test_idx, n, replace=False)
    return [cls(tokens=rng.integers(0, 500, rng.integers(3, 14)).astype(
                    np.int32),
                embedding=corpus.embeddings[i],
                budget=float(rng.uniform(1.0, 10.0)),
                max_new_tokens=int(rng.integers(1, 5)), rid=k)
            for k, i in enumerate(idx)]


def _assert_same_responses(jres, tres):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert (t.rid, t.model) == (j.rid, j.model)
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))


def test_serve_matches_jax(world):
    corpus = world[0]
    je, te = _engines(world)
    for step in range(2):
        jres = je.serve(_requests(corpus, JENG.Request, step, 12))
        tres = te.serve(_requests(corpus, TENG.Request, step, 12))
        _assert_same_responses(jres, tres)
    models = {r.model for r in tres}
    assert models == set(NAMES), models          # both models got a group
    assert te.stats == je.stats
    assert te.stats["feedback"] == 24 and te.stats["commits"] == 2
    np.testing.assert_allclose(te.router.global_ratings.numpy(),
                               np.asarray(je.router.global_ratings),
                               rtol=R_RTOL, atol=R_ATOL)
    assert te.router.db.size == je.router.db.size
    assert int(te.dbuf.front.size) == int(je.dbuf.front.size)
    drop_ts = lambda recs: [{k: v for k, v in r.items() if k != "ts"}
                            for r in recs]
    assert drop_ts(te.obs.events.records("route")) == \
        drop_ts(je.obs.events.records("route"))


def test_serve_with_generation_buckets_matches_jax(world):
    corpus = world[0]
    je, te = _engines(world, gen_bucket=True, gen_pad_len=16)
    jres = je.serve(_requests(corpus, JENG.Request, 7, 5))
    tres = te.serve(_requests(corpus, TENG.Request, 7, 5))
    _assert_same_responses(jres, tres)
    assert te.stats == je.stats


def test_gen_min_bucket_matches_jax(world):
    """tests/test_admission.py's row-padding case on both packages:
    groups padded to a floor of 4 rows (5 requests -> 8) answer as the
    unpadded engine does, and as the JAX engine with the same option."""
    corpus = world[0]
    je, te = _engines(world, gen_bucket=True, gen_min_bucket=4)
    _, t_plain = _engines(world)
    assert (te.gen_min_bucket, te.gen_max_bucket) == (4, 64)
    jres = je.serve(_requests(corpus, JENG.Request, 2, 5))
    tres = te.serve(_requests(corpus, TENG.Request, 2, 5))
    _assert_same_responses(jres, tres)
    _assert_same_responses(tres, t_plain.serve(_requests(corpus,
                                                         TENG.Request, 2,
                                                         5)))
    rows = {r.model for r in tres}
    assert all(te.fleet[m].cache_stats()["keys"][-1] >= 4 for m in rows)


def test_warmup_batch_sizes_matches_jax(world):
    """ServingEngine(warmup_batch_sizes=...) warms the dispatcher at
    construction: the same entries as the JAX engine's (on the CPU the
    port's key has no replica), every one taken by warmup."""
    je, te = _engines(world, warmup_batch_sizes=[3, 20])
    want = je.dispatch.cache_stats()
    got = te.dispatch.cache_stats()
    for k in ("hits", "misses", "warmed", "entries"):
        assert got[k] == want[k], k
    assert got["misses"] == got["warmed"] == 2
    assert te.warmup([3, 20]) == 0


def test_injected_clock_matches_jax_decision_log(world):
    """An injected now_ns stamps the decision log on both engines: the
    same records, timestamps included."""
    corpus = world[0]
    ticks = {"jax": iter(range(10**9, 10**12, 10**9)),
             "torch": iter(range(10**9, 10**12, 10**9))}
    je, te = _engines(world)
    je.now_ns = lambda: next(ticks["jax"])
    for step in range(2):
        je.serve(_requests(corpus, JENG.Request, 20 + step, 6))
    _, te = _engines(world, now_ns=lambda: next(ticks["torch"]))
    for step in range(2):
        te.serve(_requests(corpus, TENG.Request, 20 + step, 6))
    got, want = (e.obs.events.records("route") for e in (te, je))
    assert [r["ts"] for r in got] == [1.0] * 6 + [2.0] * 6
    assert got == want


def test_warmup_and_metrics(world):
    _, te = _engines(world)
    assert te.warmup([3, 20]) == 2
    te.warmup_generate(8, batch_sizes=[1, 3], max_new=2)
    assert te.serve([]) == []
    snap = te.metrics_snapshot()
    assert snap["counters"]["serve_commits_total"] == 0
    assert "serve_route_us" in snap["histograms"]


def test_commit_that_grows_the_db_is_warmed_before_routing(world):
    """A warmed engine whose feedback grows the DB: the commit warms the
    grown replica for the warmed sizes, so no route captures (every
    miss is a warmup's) and the new capacity has every warmed bucket."""
    corpus, fb, _ = world
    _, te = _engines(world)
    tr = TRouter(NAMES, corpus.costs, TConfig(embed_dim=DIM),
                 db_capacity=16, device="cpu")
    n = 250                               # rows, of a 256-row DB
    tr.fit(fb["emb"][:n], fb["model_a"][:n], fb["model_b"][:n],
           fb["outcome"][:n])
    cap = tr.db.capacity
    te = TENG.ServingEngine(te.fleet, tr, compare_rate=1.0, seed=0,
                            quality_oracle=oracle,
                            obs=TOBS.Observability(),
                            warmup_batch_sizes=[12])
    for step in range(4):
        te.serve(_requests(corpus, TENG.Request, 40 + step, 12))
        if tr.db.capacity != cap:
            break
    assert tr.db.capacity > cap
    te.serve(_requests(corpus, TENG.Request, 99, 12))
    st = te.dispatch.cache_stats()
    assert st["misses"] == st["warmed"] == 2 and st["hits"] == step + 2
    assert [k[1] for k in st["keys"]] == [cap, tr.db.capacity]


def test_unported_options_raise(world):
    """No engine option is left unported: quality=, the last one, is
    accepted and wired as in JAX (the monitor on the router, the
    engine's scope on the router and the double buffer; the monitor
    itself: tests/test_torch_obs_parity.py)."""
    from repro_torch.obs.quality import RouterQualityMonitor
    _, te = _engines(world)
    mon = RouterQualityMonitor.for_router(te.router, attach=False)
    eng = TENG.ServingEngine(te.fleet, te.router, quality=mon)
    assert eng.quality is mon and te.router.quality is mon
    assert te.router.obs is eng.obs is eng.dbuf.obs


def test_launcher_build_engine_matches_jax():
    """The two launchers' default engines (ARCH_IDS[:4] at their reduced
    configs: whisper-large-v3, olmo-1b, mamba2-780m, qwen3-8b, behind
    routers fitted on the same corpus) route the same requests to the
    same models, and every response has its rid and max_new tokens in
    the vocabulary. Random weights differ between the frameworks, so
    tokens are not compared."""
    from repro.launch import serve as JSERVE
    from repro_torch.launch import serve as TSERVE
    je, corpus = JSERVE.build_engine()
    te, _ = TSERVE.build_engine(device="cpu")
    assert list(te.fleet) == list(je.fleet) == [
        "whisper-large-v3", "olmo-1b", "mamba2-780m", "qwen3-8b"]
    rng = np.random.default_rng(11)
    budgets = [1.0, 2.5, 3.5, 5.5, 6.5, 8.0, 9.0, 10.0] * 2
    args = [(rng.integers(0, 100, rng.integers(4, 12)).astype(np.int32),
             corpus.embeddings[i], b)
            for i, b in zip(corpus.test_idx[:16], budgets)]
    jres = je.serve([JENG.Request(tokens=t, embedding=e, budget=b,
                                  max_new_tokens=2, rid=k)
                     for k, (t, e, b) in enumerate(args)])
    tres = te.serve([TENG.Request(tokens=t, embedding=e, budget=b,
                                  max_new_tokens=2, rid=k)
                     for k, (t, e, b) in enumerate(args)])
    assert [r.model for r in tres] == [r.model for r in jres]
    assert len({r.model for r in tres}) >= 3
    for k, r in enumerate(tres):
        vocab = te.fleet[r.model].cfg.vocab
        assert r.rid == k and r.tokens.shape == (2,)
        assert 0 <= r.tokens.min() and r.tokens.max() < vocab


def test_launcher_flags_not_ported_raise(monkeypatch):
    """The obs plane's flags, the last ones that raised, are ported:
    `--serve-obs` builds the engine over an enabled scope, `--alert-log`
    alone changes nothing, as in JAX (the plane itself and the CLI end
    to end: tests/test_torch_obs_parity.py)."""
    from repro_torch.launch import serve as TSERVE

    class Built(Exception):
        pass
    seen = []

    def build_engine(*a, obs=None, **kw):
        seen.append(obs)
        raise Built
    monkeypatch.setattr(TSERVE, "build_engine", build_engine)
    for argv in (["--serve-obs", "0"], ["--alert-log", "x.jsonl"]):
        with pytest.raises(Built):
            TSERVE.main(argv)
    assert seen[0].enabled and seen[1] is None
