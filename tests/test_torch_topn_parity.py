"""The retrieve stage's two-stage algorithm (the kernels' `retrieve_topn`
split top-n, then `topn_merge`; the plain versions `ref.split_topn_ref` /
`ref.topn_merge_ref`, which the wrappers run on CPU tensors) against
`jax.lax.top_k` over the JAX package's similarity and against one stable
sort of the whole panel (`ref.stable_topk`), on seeded numpy inputs.

The JAX similarity runs as the JAX suite runs it on the CPU: its jnp
oracle ("reference") and its Pallas kernel in interpret mode. Top-n rows
must be equal exactly: the order (score descending, row ascending) is a
strict total order, so the top-n of the splits' (or shards') top-n is the
top-n of the whole, at any split width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as JOPS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import retrieve_topn as RT

jax.config.update("jax_platform_name", "cpu")

JAX_BACKENDS = ("reference", "pallas_interpret")
R, M = 4, 6


def _jax_topk(q, db, size, k, backend):
    """jax.lax.top_k over the JAX similarity, rows past `size` at -inf."""
    s = JOPS.similarity(q, db, backend=backend)
    live = jnp.arange(db.shape[0]) < size
    s = jnp.where(live[None, :], s, -jnp.inf)
    return np.asarray(jax.lax.top_k(s, k)[1])


def _tied_db(rng, c, d, boundaries):
    """A DB whose row b is a copy of row b - 1 at each boundary, and
    queries that are those rows (their two best scores tie exactly)."""
    db = rng.normal(size=(c, d)).astype(np.float32)
    rows = sorted({b for b in boundaries if 0 < b < c})
    for b in rows:
        db[b] = db[b - 1]
    q = rng.normal(size=(len(rows) + 3, d)).astype(np.float32)
    q[:len(rows)] = db[[b - 1 for b in rows]]
    return q, db


def _two_stage(q, db, size, n, width):
    return TREF.two_stage_topn_ref(torch.tensor(q), torch.tensor(db), size,
                                   n, width)


# ---------------------------------------------------------------------------
# against jax.lax.top_k over the JAX similarity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("width", [1, 7, 32, 100, 128, 301])
@pytest.mark.parametrize("n,size", [(12, 300), (20, 157), (12, 5)])
def test_two_stage_equals_jax_top_k(backend, width, n, size):
    """Split widths that do and do not divide C = 300, duplicate rows on
    both sides of every split boundary (and of the 2- and 4-shard
    boundaries), the queries that tie on them, size < C and size < n."""
    rng = np.random.default_rng(width + n)
    c, d = 300, 16
    q, db = _tied_db(rng, c, d, list(range(width, c, width))[:8]
                     + [75, 150, 225])
    k = min(n, c)
    want = _jax_topk(q, db, size, k, backend)
    top_s, top_i, hit = _two_stage(q, db, size, n, width)
    np.testing.assert_array_equal(top_i.numpy(), want)
    panel = TREF.panel_topn_ref(torch.tensor(q), torch.tensor(db), size, n)
    for got, ref_ in zip((top_s, top_i, hit), panel):
        assert torch.equal(got, ref_)
    assert bool((~hit).sum(dim=1).eq(max(0, k - size)).all())


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_zero_rows_and_orthogonal_rows(backend):
    """Zero DB rows score 0 (rsqrt(0 + 1e-18) * 0, never NaN), as do rows
    orthogonal to a query: their ties go to the lowest row, across split
    boundaries."""
    rng = np.random.default_rng(5)
    c, d = 96, 8
    db = rng.normal(size=(c, d)).astype(np.float32)
    db[[3, 31, 32, 33, 64, 95]] = 0.0
    q = rng.normal(size=(5, d)).astype(np.float32)
    q[:, 0] = 0.0
    db[[10, 40, 70], :] = 0.0
    db[[10, 40, 70], 0] = 1.0                 # orthogonal to every query
    q[4] = -np.abs(q[4])                      # every score of q[4] <= 0
    q[4, 0] = 0.0
    for n, width in ((20, 32), (c, 7), (12, 96)):
        top_s, top_i, _ = _two_stage(q, db, c, n, width)
        assert bool(torch.isfinite(top_s).all())
        np.testing.assert_array_equal(top_i.numpy(),
                                      _jax_topk(q, db, c, n, backend))


def test_empty_db():
    """No live row: every score -inf, rows 0.. in ascending order, no hit;
    no row at all: an empty result."""
    rng = np.random.default_rng(6)
    q, db = (rng.normal(size=s).astype(np.float32) for s in ((3, 8),
                                                            (50, 8)))
    for width in (1, 8, 64):
        top_s, top_i, hit = _two_stage(q, db, 0, 20, width)
        assert torch.equal(top_i, torch.arange(20).expand(3, 20))
        assert not bool(hit.any()) and bool(torch.isinf(top_s).all())
    np.testing.assert_array_equal(
        _two_stage(q, db, 0, 20, 7)[1].numpy(),
        _jax_topk(q, db, 0, 20, "reference"))
    top_s, top_i, hit = _two_stage(q, db[:0], 0, 20, 8)
    assert top_s.shape == top_i.shape == hit.shape == (3, 0)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("n_of", ["c_l", "above c_l"])
def test_sharded_glue_equals_jax_and_panel(shards, n_of):
    """The sharded retrieve through the kernels' glue (per shard kernel 1's
    and kernel 2's plain versions into the leader's pool, then the merge)
    at n = C_l and n > C_l: top-n rows equal to jax.lax.top_k over the
    whole panel, and every output (scores, rows, hit, the merged records
    in the replay's layout) equal to the panel route's."""
    rng = np.random.default_rng(shards)
    c, d = 64, 16
    c_l = c // shards
    n = c_l if n_of == "c_l" else min(c, c_l + 3)
    q, db = _tied_db(rng, c, d, [c_l * s for s in range(1, shards)] + [5])
    size = c - 9
    a = rng.integers(0, M, (c, R)).astype(np.int32)
    b = ((a + 1) % M).astype(np.int32)
    s = rng.choice([0.0, 0.5, 1.0], (c, R)).astype(np.float32)
    v = rng.random((c, R)) < 0.7

    def split(x):
        return [torch.tensor(x[i * c_l:(i + 1) * c_l]) for i in range(shards)]
    emb = split(db)
    panels = tuple(split(x) for x in (a, b, s, v))
    sizes = [torch.tensor(size, dtype=torch.int32)] * shards
    qt = torch.tensor(q)
    got = RT.sharded_topn_cuda(qt, emb, panels, sizes, n)
    want = TREF.sharded_panel_topn_ref(qt, emb, panels, sizes, n)
    np.testing.assert_array_equal(got[1].numpy(),
                                  _jax_topk(q, db, size, n, "reference"))
    for x, y in zip(got[:3] + got[3], want[:3] + want[3]):
        assert torch.equal(x, y)


def test_route_through_the_kernels_glue_equals_panel_route():
    """retrieve_replay_select on CPU tensors through the kernel backend
    (the two-stage plain versions) against the reference backend (the
    panel and its stable sort): every output equal, ties included."""
    rng = np.random.default_rng(9)
    c, d, n = 200, 16, 20
    q, db = _tied_db(rng, c, d, [40, 128, 160])
    a = torch.tensor(rng.integers(0, M, (c, R)), dtype=torch.int32)
    b = (a + 1) % M
    s = torch.tensor(rng.choice([0.0, 0.5, 1.0], (c, R)), dtype=torch.float32)
    v = torch.tensor(rng.random((c, R)) < 0.7)
    g = torch.tensor(1000 + 30 * rng.normal(size=M), dtype=torch.float32)
    costs = torch.tensor(rng.uniform(1, 8, M), dtype=torch.float32)
    bud = torch.tensor(rng.uniform(0, 9, len(q)), dtype=torch.float32)
    size = torch.tensor(170, dtype=torch.int32)
    args = (torch.tensor(q), torch.tensor(db), a, b, s, v, size, g, g, costs,
            bud)
    got = TOPS.retrieve_replay_select(*args, n=n)
    want = TOPS.retrieve_replay_select(*args, n=n, backend="reference")
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_knn_call_site_equals_jax():
    """KNN's call (ops.similarity_topk, no live-row mask) through the
    kernels' glue, n = 40 over fewer and more rows than n."""
    rng = np.random.default_rng(11)
    for c in (30, 150):
        q = rng.normal(size=(9, 8)).astype(np.float32)
        db = rng.normal(size=(c, 8)).astype(np.float32)
        db[c // 2] = db[c // 2 - 1]
        _, got = TOPS.similarity_topk(torch.tensor(q), torch.tensor(db), 40)
        k = min(40, c)
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_topk(q, db, c, k, "reference"))


# ---------------------------------------------------------------------------
# the order itself: tied panels
# ---------------------------------------------------------------------------

_VALUES = (float("-inf"), -1.0, -0.0, 0.0, 0.25, 1.0)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 5), st.integers(1, 70), st.integers(1, 80),
       st.integers(1, 90), st.integers(0, 2 ** 31 - 1))
def test_tied_panels_two_stage_equals_stable_sort(nq, c, n, width, seed):
    """Panels of a few values (-inf, -0.0 and 0.0 among them, compared as
    floats): the splits' pool, then its merge, equal one stable sort of
    the panel, scores and rows; and so does a shard split (each shard's
    top min(n, C_l), their pool merged)."""
    rng = np.random.default_rng(seed)
    panel = torch.tensor(rng.choice(_VALUES, (nq, c)), dtype=torch.float32)
    k = min(n, c)
    want_s, want_i = TREF.stable_topk(panel, n)
    pool = TREF.panel_pool_ref(panel, n, width)
    top_s, top_i, hit, _ = TREF.topn_merge_ref(*pool, k)
    assert torch.equal(top_i, want_i) and torch.equal(top_s, want_s)
    assert torch.equal(hit, torch.isfinite(want_s))
    # shards of `width` rows: each reduced to min(n, C_l), then merged
    parts = [TREF.topn_merge_ref(*TREF.panel_pool_ref(
        panel[:, c0:c0 + width], n, 1 + seed % 13, offset=c0),
        min(n, panel[:, c0:c0 + width].shape[1]))
        for c0 in range(0, c, width)]
    merged = TREF.topn_merge_ref(torch.cat([p[0] for p in parts], 1),
                                 torch.cat([p[1].int() for p in parts], 1),
                                 k)
    assert torch.equal(merged[1], want_i) and torch.equal(merged[0], want_s)


def test_negative_zero_ties_positive_zero():
    """-0.0 == 0.0 in the order: they tie, lowest row first (a stable
    sort's order, not a sign-aware total order)."""
    panel = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, -0.0]])
    top_s, top_i, _, _ = TREF.topn_merge_ref(
        *TREF.panel_pool_ref(panel, 6, 2), 6)
    assert top_i.tolist() == [[4, 0, 1, 2, 3, 5]]


# ---------------------------------------------------------------------------
# the payload and the plan
# ---------------------------------------------------------------------------

def test_merge_payload_layouts():
    """Kernel 2's plain version: records gathered by row from a shard's
    panels in rank order, and carried by pool position into the replay's
    layout (farthest first, valid &= hit), as gather_records lays them
    out."""
    rng = np.random.default_rng(13)
    c, nq, n, off = 40, 4, 6, 100
    panels = (torch.tensor(rng.integers(0, M, (c, R)), dtype=torch.int32),
              torch.tensor(rng.integers(0, M, (c, R)), dtype=torch.int32),
              torch.tensor(rng.random((c, R)), dtype=torch.float32),
              torch.tensor(rng.random((c, R)) < 0.5))
    panel = torch.tensor(rng.normal(size=(nq, c)), dtype=torch.float32)
    panel[:, 30:] = float("-inf")
    pool = TREF.panel_pool_ref(panel, n, 9, offset=off)
    top_s, top_i, hit, recs = TREF.topn_merge_ref(*pool, n, panels=panels,
                                                  offset=off)
    want_i = TREF.stable_topk(panel, n)[1]
    assert torch.equal(top_i, want_i + off)
    for x, p in zip(recs, panels):
        assert torch.equal(x, p[want_i])
    carried = tuple(p[torch.clamp(pool[1].long() - off, 0, c - 1)]
                    for p in panels)
    *_, flat = TREF.topn_merge_ref(*pool, n, carried=carried,
                                   farthest_first=True)
    want = TREF.gather_records(*panels, want_i, hit)
    for x, y in zip(flat, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("nq,tile", [(1, 8), (8, 8), (9, 32), (32, 32),
                                     (33, 64), (64, 64), (65, 128),
                                     (1024, 128)])
def test_plan_takes_similarity_tiles_and_covers_the_db(nq, tile):
    """The tile per bucket is the similarity kernel's; the splits cover C
    in whole tiles, about two blocks an SM."""
    for c in (1, 100, 8192, 32768):
        t, rows, splits = RT.plan(nq, c, 1536)
        assert t == tile
        unit = 32 if tile == 8 else 128
        assert rows % unit == 0 and (splits - 1) * rows < c <= splits * rows
        blocks = splits * (1 if tile == 8 else -(-nq // tile))
        assert blocks <= 2 * RT.H100_SMS or rows == unit
    assert RT.plan(1024, 32768, 1536) == (128, 1024, 32)
    assert RT.plan(8, 32768, 1536) == (8, 128, 256)
