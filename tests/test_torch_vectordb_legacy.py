"""The legacy object-path retrieval of the vector DB (`VectorDB.query`,
`VectorDB.gather_feedback`; the route benchmark's baseline) on the port
against the JAX package's, on the same seeded inputs, on the CPU.

Integers (rows, records, masks) must be equal; scores within 1e-5 (the
two packages' fp32 products round apart, ROADMAP §4.5). Covered: tied
rows (duplicate prompts), an empty DB, n past the capacity, a DB after
`clear()` and after a grow.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.vectordb import VectorDB as JDB
from repro_torch.core.vectordb import VectorDB as TDB

jax.config.update("jax_platform_name", "cpu")

D, M = 16, 6


def _feed(rng, n_prompts, recs=3, dup_every=0):
    """Seeded feedback: n_prompts prompts of `recs` records each; with
    dup_every, every dup_every-th prompt repeats the one before it (its
    scores tie)."""
    emb = rng.normal(size=(n_prompts, D)).astype(np.float32)
    if dup_every:
        emb[dup_every::dup_every] = emb[dup_every - 1::dup_every][
            :len(emb[dup_every::dup_every])]
    e = np.repeat(emb, recs, axis=0)
    a = rng.integers(0, M, len(e))
    b = (a + rng.integers(1, M, len(e))) % M
    s = rng.choice([0.0, 0.5, 1.0], len(e))
    qid = np.repeat(np.arange(n_prompts), recs)
    return e, a, b, s, qid


def _both(capacity, *feeds):
    j = JDB(D, capacity, records_per_query=4, backend="reference")
    t = TDB(D, capacity, records_per_query=4)
    for f in feeds:
        e, a, b, s, qid = f
        j.add(e, a, b, s, query_id=qid)
        t.add(e, a, b, s, query_id=qid)
    return j, t


def _check(j, t, q, n):
    ji, js, jh = (np.asarray(x) for x in j.query(q, n))
    ti, ts, th = t.query(q, n)
    nq = 1 if np.ndim(q) == 1 else len(q)
    assert ti.shape == ji.shape == (nq, min(n, t.capacity))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(th.numpy(), jh)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
    np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=1e-5,
                               atol=1e-5)
    jf = [np.asarray(x) for x in j.gather_feedback(ji, jh)]
    tf = t.gather_feedback(ti, th)
    for x, y in zip(tf, jf):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x.numpy(), y)
    return ti, th


@pytest.mark.parametrize("n", [1, 5, 20])
@pytest.mark.parametrize("dup_every", [0, 3])
def test_query_and_gather_equal_jax(n, dup_every):
    rng = np.random.default_rng(n + dup_every)
    j, t = _both(64, _feed(rng, 40, dup_every=dup_every))
    q = rng.normal(size=(7, D)).astype(np.float32)
    if dup_every:
        q[:3] = t.emb[[dup_every - 1, 2 * dup_every - 1, 5]] * 3.0
    _check(j, t, q, n)
    ti, _ = _check(j, t, q[0], n)                  # one query, 1-D
    assert ti.shape[0] == 1


def test_ties_go_to_the_lowest_row():
    """Prompts that all repeat one embedding: every score ties, and both
    packages return rows 0..n-1."""
    rng = np.random.default_rng(1)
    e, a, b, s, qid = _feed(rng, 12)
    e[:] = e[0]
    j, t = _both(32, (e, a, b, s, qid))
    ti, _ = _check(j, t, e[:2], 8)
    np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(8), (2, 1)))


def test_empty_db_and_n_past_capacity():
    """No live row: every score -inf, nothing hit, no record valid; n
    above the capacity takes the capacity; after a grow the snapshot is
    renewed."""
    rng = np.random.default_rng(2)
    j, t = _both(16)
    q = rng.normal(size=(3, D)).astype(np.float32)
    ti, th = _check(j, t, q, 40)
    assert ti.shape == (3, 16) and not bool(th.any())
    assert not bool(t.gather_feedback(ti, th)[3].any())
    f = _feed(rng, 5)
    for db in (j, t):
        db.add(*f[:4], query_id=f[4])
    _check(j, t, q, 40)
    grow = _feed(np.random.default_rng(3), 20)
    for db in (j, t):
        db.add(*grow[:4], query_id=grow[4] + 100)
    assert t.capacity == j.capacity == 32
    _check(j, t, q, 40)


def test_after_clear():
    """After clear() and new adds, only the new prompts are live (the
    stale rows are masked), as in JAX."""
    rng = np.random.default_rng(4)
    j, t = _both(32, _feed(rng, 20))
    q = rng.normal(size=(4, D)).astype(np.float32)
    _check(j, t, q, 10)
    j.clear()
    t.clear()
    ti, th = _check(j, t, q, 10)
    assert not bool(th.any())
    f = _feed(rng, 6)
    for db in (j, t):
        db.add(*f[:4], query_id=f[4] + 500)
    ti, th = _check(j, t, q, 10)
    assert int(th.sum()) == 4 * 6 and int(ti[th].max()) < 6
