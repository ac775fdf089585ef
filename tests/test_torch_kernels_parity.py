"""The port's plain kernel versions (what its wrappers run on CPU tensors)
against the JAX package, on the same seeded numpy inputs.

The JAX side runs both its jnp oracle ("reference") and its Pallas
kernels in interpret mode ("pallas_interpret"), at tiny shapes. Integer
outputs (top-k indices, choices) must be equal; floats match at the JAX
suite's own bars between its backends: similarity 1e-5
(tests/test_kernels.py), ratings rtol 1e-5 / atol 1e-3
(tests/test_router_state.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.elo_scan import elo_scan_select_pallas
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.elo_scan import elo_scan_cuda, elo_scan_select_cuda
from repro_torch.kernels.similarity_topk import similarity_cuda

jax.config.update("jax_platform_name", "cpu")

SIM_TOL = 1e-5
R_RTOL, R_ATOL = 1e-5, 1e-3
JAX_BACKENDS = ("reference", "pallas_interpret")


def _t(*xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


def _records(rng, q, t, m, p_valid=0.7):
    a = rng.integers(0, m, (q, t)).astype(np.int32)
    b = ((a + 1 + rng.integers(0, max(m - 1, 1), (q, t))) % m).astype(
        np.int32)
    s = rng.choice([0.0, 0.5, 1.0], (q, t)).astype(np.float32)
    v = rng.random((q, t)) < p_valid
    return a, b, s, v


# ---------------------------------------------------------------------------
# similarity + top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("nq,n,d", [(1, 17, 8), (4, 64, 32), (16, 300, 64)])
def test_similarity_matches_jax(backend, nq, n, d):
    rng = np.random.default_rng(nq * n + d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(JOPS.similarity(q, db, backend=backend))
    got = similarity_cuda(*_t(q, db))       # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=SIM_TOL, atol=SIM_TOL)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_similarity_topk_ties_match_jax(backend):
    """Duplicate embeddings tie exactly; the lowest index comes first."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(30, 16)).astype(np.float32)
    db = np.concatenate([base, base, base[:10]])      # 2-3 way ties
    q = base[[0, 3, 7, 11, 29]]
    want_s, want_i = JOPS.similarity_topk(q, db, 12, backend=backend)
    got_s, got_i = TOPS.similarity_topk(*_t(q, db), 12)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=SIM_TOL, atol=SIM_TOL)


def test_stable_topk_matches_lax_top_k_on_ties():
    rng = np.random.default_rng(9)
    for trial in range(25):
        scores = rng.integers(0, 4, (6, 50)).astype(np.float32)
        if trial % 5 == 0:
            scores[:] = -np.inf                          # an empty DB
        want = jax.lax.top_k(jnp.asarray(scores), 8)
        got = TREF.stable_topk(torch.tensor(scores), 8)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# ELO replay (+ budget-selection epilogue)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("nq,t,m", [(3, 1, 2), (16, 40, 10), (5, 33, 32)])
def test_elo_scan_matches_jax(backend, nq, t, m):
    rng = np.random.default_rng(nq + t + m)
    r0 = (1000 + 50 * rng.normal(size=(nq, m))).astype(np.float32)
    a, b, s, v = _records(rng, nq, t, m)
    want = np.asarray(JOPS.elo_scan(r0, a, b, s, v, backend=backend))
    got = elo_scan_cuda(*_t(r0, a, b, s, v))
    np.testing.assert_allclose(got.numpy(), want, rtol=R_RTOL, atol=R_ATOL)


def test_elo_scan_invalid_records_are_exact_noops():
    rng = np.random.default_rng(2)
    r0 = (1000 + 50 * rng.normal(size=(4, 6))).astype(np.float32)
    a, b, s, _ = _records(rng, 4, 20, 6)
    got = TOPS.elo_scan(*_t(r0, a, b, s, np.zeros((4, 20), bool)))
    np.testing.assert_array_equal(got.numpy(), r0)


def _select_case(seed, nq=12, t=24, m=6, flat=False):
    rng = np.random.default_rng(seed)
    r0 = np.full((nq, m), 1000.0, np.float32) if flat else \
        (1000 + 50 * rng.normal(size=(nq, m))).astype(np.float32)
    a, b, s, v = _records(rng, nq, t, m, p_valid=0.0 if flat else 0.7)
    g = np.full(m, 1000.0, np.float32) if flat else \
        (1000 + 30 * rng.normal(size=m)).astype(np.float32)
    costs = np.asarray([3.0, 1.0, 2.0, 1.0, 5.0, 1.0], np.float32)[:m]
    # budgets below the cheapest model exercise the fallback
    bud = rng.choice([0.5, 1.0, 2.5, 4.0, 10.0], nq).astype(np.float32)
    return r0, a, b, s, v, g, costs, bud


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("p", [0.5, 0.0])
def test_elo_scan_select_matches_jax(flat, p):
    args = _select_case(int(flat) + 10 * int(p * 10), flat=flat)
    r0, a, b, s, v, g, costs, bud = args
    want_pal = elo_scan_select_pallas(*(jnp.asarray(x) for x in args), p=p,
                                      interpret=True)
    local = JREF.elo_replay_ref(*(jnp.asarray(x) for x in (r0, a, b, s, v)))
    want_ref = JREF.budget_select_ref(p * g[None] + (1 - p) * local,
                                      jnp.asarray(costs), jnp.asarray(bud))
    got_r, got_c = elo_scan_select_cuda(*_t(*args), p=p)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_pal[0]),
                               rtol=R_RTOL, atol=R_ATOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_pal[1]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_ref))
    if flat:   # ties everywhere: first feasible index, else first cheapest
        first = [int(np.flatnonzero(costs <= x)[0]) if (costs <= x).any()
                 else 1 for x in bud]
        np.testing.assert_array_equal(got_c.numpy(), first)


def test_budget_select_and_gather_match_jax():
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 3, (9, 5)).astype(np.float32)   # ties
    costs = np.asarray([2.0, 1.0, 3.0, 1.0, 4.0], np.float32)
    bud = np.asarray([0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 0.5, 2.5, 9.0],
                     np.float32)
    want = JREF.budget_select_ref(*(jnp.asarray(x) for x in
                                    (scores, costs, bud)))
    got = TREF.budget_select_ref(*_t(scores, costs, bud))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    c, r, m = 20, 3, 4
    a, b, s, v = _records(rng, c, r, m)
    idx = rng.integers(0, c, (6, 5)).astype(np.int32)
    hit = rng.random((6, 5)) < 0.8
    want = JREF.gather_records(*(jnp.asarray(x) for x in
                                 (a, b, s, v, idx, hit)))
    got = TREF.gather_records(*_t(a, b, s, v, idx, hit))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


# ---------------------------------------------------------------------------
# the retrieval chain
# ---------------------------------------------------------------------------

def _chain_case(seed, size, dup=False, q_n=10, c=120, d=16, r=4, m=6):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(c, d)).astype(np.float32)
    if dup:                           # duplicate rows tie in score
        emb[c // 2:] = emb[:c - c // 2]
    q = emb[rng.integers(0, c, q_n)] + 0.05 * rng.normal(
        size=(q_n, d)).astype(np.float32)
    a, b, s, v = _records(rng, c, r, m)
    init = (1000 + 40 * rng.normal(size=m)).astype(np.float32)
    g = (1000 + 40 * rng.normal(size=m)).astype(np.float32)
    costs = rng.uniform(1, 10, m).astype(np.float32)
    bud = rng.uniform(0, 12, q_n).astype(np.float32)
    return q, emb, a, b, s, v, np.int32(size), init, g, costs, bud


# (seed, size, duplicate embeddings): an empty DB, fewer live rows than
# n = 20 (misses), a part-full and a full DB, ties from duplicate rows
CHAIN_CASES = [(0, 0, False), (4, 7, False), (1, 70, False), (2, 120, False),
               (3, 120, True)]


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("seed,size,dup", CHAIN_CASES)
def test_retrieve_replay_matches_jax(backend, seed, size, dup):
    q, emb, a, b, s, v, sz, init, *_ = _chain_case(seed, size, dup)
    want = JOPS.retrieve_replay(q, emb, a, b, s, v, jnp.int32(sz), init,
                                n=20, backend=backend)
    got = TOPS.retrieve_replay(*_t(q, emb, a, b, s, v, sz, init), n=20)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=R_RTOL, atol=R_ATOL)
    if size == 0:                     # empty DB: local == init, all misses
        assert not torch.isfinite(got[2]).any()
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.broadcast_to(init, got[0].shape))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("seed,size,dup", CHAIN_CASES)
def test_retrieve_replay_select_matches_jax(backend, seed, size, dup):
    case = _chain_case(seed, size, dup)
    q, emb, a, b, s, v, sz, init, g, costs, bud = case
    want = JOPS.retrieve_replay_select(q, emb, a, b, s, v, jnp.int32(sz),
                                       init, g, costs, bud, n=20,
                                       backend=backend)
    got = TOPS.retrieve_replay_select(*_t(*case), n=20)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=R_RTOL, atol=R_ATOL)


def test_reference_backend_equals_cpu_wrappers():
    """On CPU tensors the kernel backend IS the plain version."""
    case = _t(*_chain_case(7, 90))
    a = TOPS.retrieve_replay_select(*case, n=20)
    b = TOPS.retrieve_replay_select(*case, n=20, backend="reference")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        TOPS.similarity(case[0], case[1], backend="pallas")
