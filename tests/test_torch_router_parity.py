"""The port's router core against the JAX package, on the CPU: the ELO
engine, commit(), routing over a state carried across with convert.py,
the DoubleBuffer, the dispatcher, the copied corpus generator, and
EagleRouter end to end on the benchmark regime.

Integer outputs must be equal; ratings match at rtol 1e-5 / atol 1e-3
(the JAX suite's bar between its backends, tests/test_router_state.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.eagle import BENCH_CONFIG as J_BENCH
from repro.core import elo as JELO
from repro.core import dispatch as JDISP
from repro.core import router as JROUTER
from repro.core import state as JSTATE
from repro.core.vectordb import VectorDB as JVectorDB
from repro.data import routerbench as JRB
from repro_torch import convert
from repro_torch.configs.eagle import BENCH_CONFIG as T_BENCH
from repro_torch.core import dispatch as TDISP
from repro_torch.core import elo as TELO
from repro_torch.core import router as TROUTER
from repro_torch.core import state as TSTATE
from repro_torch.core.vectordb import VectorDB as TVectorDB
from repro_torch.data import routerbench as TRB

jax.config.update("jax_platform_name", "cpu")

R_RTOL, R_ATOL = 1e-5, 1e-3
CPU = "cpu"
FIELDS = [f.name for f in dataclasses.fields(JSTATE.RouterState)]


def _log(seed, t, m):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, m, t).astype(np.int32)
    b = ((a + rng.integers(1, m, t)) % m).astype(np.int32)
    s = rng.choice([0.0, 0.5, 1.0], t).astype(np.float32)
    return a, b, s


def _assert_state_equal(t_state, j_state, live_only=False):
    """All 7 fields equal. With live_only, the panels are compared on the
    live rows: rows past `size` hold stale content that routing masks,
    and a JAX CPU array may alias the host buffer it was made from."""
    size = int(t_state.size)
    for f in FIELDS:
        got = getattr(t_state, f).cpu().numpy()
        want = np.asarray(getattr(j_state, f))
        assert got.shape == want.shape, f
        if live_only and got.ndim == 2:
            got, want = got[:size], want[:size]
        if f == "global_ratings":
            np.testing.assert_allclose(got, want, rtol=R_RTOL, atol=R_ATOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


# ---------------------------------------------------------------------------
# ELO engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 63, 200, 700])
def test_fit_and_update_global_match_jax(t):
    m = 7
    a, b, s = _log(t, t, m)
    want = JELO.fit_global(m, jnp.asarray(a), jnp.asarray(b), jnp.asarray(s))
    got = TELO.fit_global(m, a, b, s, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=R_RTOL,
                               atol=R_ATOL)
    a2, b2, s2 = _log(t + 1, 37, m)
    want = JELO.update_global(want, jnp.asarray(a2), jnp.asarray(b2),
                              jnp.asarray(s2))
    got = TELO.update_global(got, a2, b2, s2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=R_RTOL,
                               atol=R_ATOL)


def test_elo_primitives_match_jax():
    rng = np.random.default_rng(3)
    q, t, m = 5, 12, 6
    r = (1000 + 50 * rng.normal(size=(q, m))).astype(np.float32)
    a = rng.integers(0, m, (t, q)).astype(np.int32)
    b = rng.integers(0, m, (t, q)).astype(np.int32)
    s = rng.choice([0.0, 0.5, 1.0], (t, q)).astype(np.float32)
    v = rng.random((t, q)) < 0.7
    np.testing.assert_allclose(
        TELO.expected_score(torch.tensor(r[:, 0]), torch.tensor(r[:, 1])),
        np.asarray(JELO.expected_score(r[:, 0], r[:, 1])), rtol=1e-6)
    np.testing.assert_allclose(
        TELO.elo_step(*(torch.tensor(x) for x in (r, a[0], b[0], s[0])),
                      32.0, torch.tensor(v[0])).numpy(),
        np.asarray(JELO.elo_step(r, a[0], b[0], s[0], 32.0, v[0])),
        rtol=R_RTOL, atol=R_ATOL)
    np.testing.assert_allclose(
        TELO.elo_scan(*(torch.tensor(x) for x in (r, a, b, s, v))).numpy(),
        np.asarray(JELO.elo_scan(r, a, b, s, v)), rtol=R_RTOL, atol=R_ATOL)
    g = r[0]
    np.testing.assert_allclose(
        TELO.local_elo(*(torch.tensor(x) for x in
                         (g, a.T, b.T, s.T, v.T))).numpy(),
        np.asarray(JELO.local_elo(g, a.T, b.T, s.T, v.T)), rtol=R_RTOL,
        atol=R_ATOL)
    for n in (0, 1, 64, 65, 1000):
        assert TELO._pad_bucket(n) == JELO._pad_bucket(n)
        assert TELO._pad_bucket(n, floor=8) == JELO._pad_bucket(n, floor=8)


# ---------------------------------------------------------------------------
# commit(), DoubleBuffer
# ---------------------------------------------------------------------------

def _add_both(dbs, rng, n_prompts, m, dim, qid0, per=3):
    emb = rng.normal(size=(n_prompts * per, dim)).astype(np.float32)
    qid = np.repeat(np.arange(qid0, qid0 + n_prompts), per)
    emb = emb[np.repeat(np.arange(0, n_prompts * per, per), per)]
    a, b, s = _log(int(qid0) + 1, n_prompts * per, m)
    for db in dbs:
        db.add(emb, a, b, s, query_id=qid)
    return a, b, s


def test_commit_matches_jax_including_growth_and_clear():
    rng = np.random.default_rng(0)
    m, dim = 5, 8
    jdb, tdb = JVectorDB(dim, 16, 4), TVectorDB(dim, 16, 4)
    _add_both((jdb, tdb), rng, 6, m, dim, 0)
    g = np.linspace(990, 1010, m).astype(np.float32)
    js = JSTATE.commit(jdb, g)
    ts = TSTATE.commit(tdb, g, device=CPU)
    _assert_state_equal(ts, js)
    # incremental: new prompts and extra records on old ones
    _add_both((jdb, tdb), rng, 4, m, dim, 3)
    js = JSTATE.commit(jdb, g + 1, js)
    ts = TSTATE.commit(tdb, g + 1, ts)
    _assert_state_equal(ts, js)
    # nothing dirty: ratings and size only
    js = JSTATE.commit(jdb, g + 2, js)
    ts = TSTATE.commit(tdb, g + 2, ts)
    _assert_state_equal(ts, js)
    # past capacity (C 16 -> 32) and past R (4 -> 8): full re-upload
    shape_before = tuple(ts.emb.shape)
    _add_both((jdb, tdb), rng, 12, m, dim, 20, per=5)
    js = JSTATE.commit(jdb, g, js)
    ts = TSTATE.commit(tdb, g, ts)
    assert tuple(ts.emb.shape) != shape_before
    assert tdb.capacity == jdb.capacity == 32 and tdb.rcap == 8
    for need in (None, 20, 33, 90):
        assert tdb.next_capacity(need) == jdb.next_capacity(need)
    _assert_state_equal(ts, js)
    # clear + re-add: stale ledger rows are dropped by the rows < size guard
    for db in (jdb, tdb):
        db.clear()
    _add_both((jdb, tdb), rng, 2, m, dim, 100)
    js = JSTATE.commit(jdb, g, js)
    ts = TSTATE.commit(tdb, g, ts)
    assert int(ts.size) == 2
    _assert_state_equal(ts, js, live_only=True)


def test_double_buffer_matches_jax():
    rng = np.random.default_rng(1)
    m, dim = 4, 6
    jdb, tdb = JVectorDB(dim, 32, 4), TVectorDB(dim, 32, 4)
    _add_both((jdb, tdb), rng, 5, m, dim, 0)
    g = np.full(m, 1000.0, np.float32)
    jbuf = JSTATE.DoubleBuffer(jdb, g)
    tbuf = TSTATE.DoubleBuffer(tdb, g, device=CPU)
    _assert_state_equal(tbuf.front, jbuf.front)
    for rnd in range(4):
        _add_both((jdb, tdb), rng, 2, m, dim, 10 + 5 * rnd)
        g = g + 1.0
        jf = jbuf.commit(g)
        tf = tbuf.commit(g)
        _assert_state_equal(tf, jf)
        # each front equals a fresh full upload of the buffer
        _assert_state_equal(tf, JSTATE.state_from_buffer(jdb, g))


def test_convert_round_trips_a_jax_state():
    rng = np.random.default_rng(2)
    jdb = JVectorDB(8, 16, 4)
    emb = rng.normal(size=(7, 8)).astype(np.float32)
    a, b, s = _log(2, 7, 3)
    jdb.add(emb, a, b, s)
    js = JSTATE.commit(jdb, np.asarray([990.0, 1000.0, 1010.0]))
    ts = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in FIELDS}, device=CPU)
    _assert_state_equal(ts, js)
    assert ts.valid.dtype == torch.bool and ts.model_a.dtype == torch.int32
    with pytest.raises(ValueError):
        convert.state_from_numpy({"emb": emb}, device=CPU)
    r = convert.ratings_from_numpy(np.asarray(js.global_ratings), CPU)
    assert r.dtype == torch.float32 and r.shape == (3,)


# ---------------------------------------------------------------------------
# routing over a carried-across state
# ---------------------------------------------------------------------------

def _jax_router(seed=0, m=6, dim=16, n_prompts=60, capacity=64,
                cls=JROUTER.EagleRouter):
    rng = np.random.default_rng(seed)
    r = cls([f"m{i}" for i in range(m)], np.asarray([3, 1, 2, 1, 5, 4.0]),
            JROUTER.EagleConfig(embed_dim=dim), db_capacity=capacity)
    emb = rng.normal(size=(n_prompts, dim)).astype(np.float32)
    emb[n_prompts // 2:] = emb[:n_prompts - n_prompts // 2]   # exact ties
    a, b, s = _log(seed, n_prompts, m)
    r.fit(emb, a, b, s)
    q = emb[rng.integers(0, n_prompts, 24)] + 0.1 * rng.normal(
        size=(24, dim)).astype(np.float32)
    return r, q, rng


@pytest.mark.parametrize("mode", TSTATE.MODES)
def test_route_batch_matches_jax_on_converted_state(mode):
    jr, q, rng = _jax_router()
    js = jr.state
    ts = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in FIELDS}, device=CPU)
    costs = np.asarray(jr.costs)
    bud = rng.choice([0.5, 1.0, 2.5, 4.0, 9.0], len(q)).astype(np.float32)
    want = JSTATE.route_batch(js, q, bud, costs, mode=mode)
    got = TSTATE.route_batch(ts, q, bud, costs, mode=mode)
    np.testing.assert_array_equal(got.choices.numpy(),
                                  np.asarray(want.choices))
    np.testing.assert_array_equal(got.topk_idx.numpy(),
                                  np.asarray(want.topk_idx))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=R_RTOL, atol=R_ATOL)
    lean = TSTATE.route_batch_choices(ts, q, bud, costs, mode=mode)
    assert torch.equal(lean.choices, got.choices)
    np.testing.assert_allclose(
        TSTATE.batch_scores(ts, q, mode=mode).numpy(),
        np.asarray(JSTATE.batch_scores(js, q, mode=mode)), rtol=R_RTOL,
        atol=R_ATOL)
    # the standalone selection is the epilogue's oracle
    sel, _ = TSTATE.select_within_budget(got.scores,
                                         torch.tensor(costs),
                                         torch.tensor(bud))
    np.testing.assert_array_equal(sel.numpy(), got.choices.numpy())


def test_route_on_empty_state_matches_jax():
    js = JSTATE.init_state(4, 8, capacity=32)
    ts = TSTATE.init_state(4, 8, capacity=32, device=CPU)
    _assert_state_equal(ts, js)
    q = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    costs = np.asarray([2.0, 1.0, 1.0, 3.0], np.float32)
    want = JSTATE.route_batch(js, q, 0.5, costs)      # nothing affordable
    got = TSTATE.route_batch(ts, q, 0.5, costs)
    np.testing.assert_array_equal(got.choices.numpy(), [1] * 5)
    np.testing.assert_array_equal(got.topk_idx.numpy(),
                                  np.asarray(want.topk_idx))
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def test_bucket_policy_matches_jax():
    for n in (0, 1, 7, 8, 9, 100, 1024, 1025, 5000):
        assert TDISP.batch_bucket(n) == JDISP.batch_bucket(n)
        assert TDISP.batch_bucket(n, 4, 64) == JDISP.batch_bucket(n, 4, 64)
    assert TDISP.bucket_ladder() == JDISP.bucket_ladder()
    assert TDISP.bucket_ladder(2, 32) == JDISP.bucket_ladder(2, 32)


@pytest.mark.parametrize("nq", [1, 5, 16, 37])
def test_dispatcher_chunking_and_bucket_invariance(nq):
    jr, q, rng = _jax_router(seed=4)
    q = np.concatenate([q, q])[:nq]
    js = jr.state
    ts = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in FIELDS}, device=CPU)
    bud = rng.uniform(0.5, 6.0, nq).astype(np.float32)
    want = JSTATE.route_batch_choices(js, q, bud, jr.costs)
    disp = TDISP.RouteDispatcher(np.asarray(jr.costs), min_bucket=2,
                                 max_bucket=8)
    assert disp.warmup(ts) == 3
    ch, top = disp.route_result(ts, q, bud)
    np.testing.assert_array_equal(ch, np.asarray(want.choices))
    np.testing.assert_array_equal(top, np.asarray(want.topk_idx))
    np.testing.assert_array_equal(disp.route(ts, q, bud), ch)
    # each query routed alone gets the same choice as inside the batch
    alone = [int(disp.route(ts, q[i], bud[i])[0]) for i in range(nq)]
    np.testing.assert_array_equal(alone, ch)


# ---------------------------------------------------------------------------
# copied corpus generator, end to end
# ---------------------------------------------------------------------------

def test_routerbench_copy_matches_jax():
    names, costs = JRB.default_fleet()
    t_names, t_costs = TRB.default_fleet()
    assert t_names == names
    np.testing.assert_array_equal(t_costs, costs)
    assert TRB.DATASETS == JRB.DATASETS
    jc = JRB.make_corpus(seed=3, n_per_dataset=20, dim=12)
    tc = TRB.make_corpus(seed=3, n_per_dataset=20, dim=12)
    for f in ("embeddings", "quality", "p_quality", "dataset_id",
              "topic_id", "costs", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.model_names == jc.model_names
    np.testing.assert_array_equal(tc.stage_indices(0.85),
                                  jc.stage_indices(0.85))
    jf = JRB.pairwise_feedback(jc, jc.train_idx, seed=3, pairs_per_query=4)
    tf = TRB.pairwise_feedback(tc, tc.train_idx, seed=3, pairs_per_query=4)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k])
    np.testing.assert_array_equal(TRB.budget_grid(tc.costs),
                                  JRB.budget_grid(jc.costs))


@pytest.mark.parametrize("cls", ["EagleRouter", "GlobalOnlyRouter",
                                 "LocalOnlyRouter"])
def test_eagle_router_end_to_end_matches_jax(cls):
    """BENCH_CONFIG regime, small: per-query test choices equal to JAX's
    at every budget of the grid, hence the same AUC; then one online
    update, after which they still agree."""
    corpus = JRB.make_corpus(seed=1, n_per_dataset=60, dim=64)
    fb = JRB.pairwise_feedback(corpus, corpus.stage_indices(0.85), seed=1,
                               pairs_per_query=8)
    jr = getattr(JROUTER, cls)(corpus.model_names, corpus.costs, J_BENCH,
                               db_capacity=256)
    tr = getattr(TROUTER, cls)(corpus.model_names, corpus.costs, T_BENCH,
                               db_capacity=256, device=CPU)
    for r in (jr, tr):
        r.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
              query_id=fb["query_idx"])
    np.testing.assert_allclose(tr.global_ratings.numpy(),
                               np.asarray(jr.global_ratings), rtol=R_RTOL,
                               atol=R_ATOL)
    test = corpus.embeddings[corpus.test_idx]
    for b in JRB.budget_grid(corpus.costs):
        np.testing.assert_array_equal(tr.route(test, float(b)).numpy(),
                                      np.asarray(jr.route(test, float(b))))
    j_auc = JRB.evaluate_router(lambda e, b: jr.route(e, b), corpus)["auc"]
    t_auc = TRB.evaluate_router(lambda e, b: tr.route(e, b).numpy(),
                                corpus)["auc"]
    assert t_auc == pytest.approx(j_auc, abs=1e-12)

    new = corpus.train_idx[len(corpus.stage_indices(0.85)):]
    fb2 = JRB.pairwise_feedback(corpus, new, seed=2, pairs_per_query=8)
    for r in (jr, tr):
        r.feedback(fb2["emb"], fb2["model_a"], fb2["model_b"],
                   fb2["outcome"])
    np.testing.assert_allclose(tr.global_ratings.numpy(),
                               np.asarray(jr.global_ratings), rtol=R_RTOL,
                               atol=R_ATOL)
    b = float(np.median(corpus.costs))
    np.testing.assert_array_equal(tr.route(test, b).numpy(),
                                  np.asarray(jr.route(test, b)))
    np.testing.assert_allclose(tr.scores(test[:16]).numpy(),
                               np.asarray(jr.scores(test[:16])),
                               rtol=R_RTOL, atol=R_ATOL)
    np.testing.assert_array_equal(tr.rank(test[:16]).numpy(),
                                  np.asarray(jr.rank(test[:16])))
    np.testing.assert_allclose(tr.local_ratings(test[:16]).numpy(),
                               np.asarray(jr.local_ratings(test[:16])),
                               rtol=R_RTOL, atol=R_ATOL)
