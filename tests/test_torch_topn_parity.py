"""The retrieve stage against `jax.lax.top_k` over the JAX package's
similarity and against one stable sort of the whole panel
(`ref.stable_topk`), on seeded numpy inputs: its two kernels' plain
versions (the masked panel, `ref.panel_ref`; kernel 2's radix select,
`ref.topn_select_ref`, and the stable sorts the wrappers run in its place
on CPU tensors, `ref.topn_merge_ref`), the sharded route's per-shard
reduce and cross-shard merge, and the plan.

The JAX similarity runs as the JAX suite runs it on the CPU: its jnp
oracle ("reference") and its Pallas kernel in interpret mode. Top-n rows
must be equal exactly: the order (score descending, row ascending) is a
strict total order, so the top-n of the shards' top-n is the top-n of
the whole, and a select by a key that orders as the ranking takes
exactly the top-n.
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


def _two_stage(q, db, size, n):
    """The retrieve's two stages on CPU tensors: through the wrappers' glue
    (the masked panel, then the stable sorts) and through the select's
    plain version, which must agree exactly; returns the first."""
    qt, dbt = torch.tensor(q), torch.tensor(db)
    live = None if size is None else torch.tensor(size, dtype=torch.int32)
    got = RT.topn_cuda(qt, dbt, live, n)
    sel = TREF.panel_select_topn_ref(qt, dbt, size, n)
    for x, y in zip(got, sel):
        assert torch.equal(x, y)
    return got


# ---------------------------------------------------------------------------
# against jax.lax.top_k over the JAX similarity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("c", [5, 12, 20, 128, 129, 300])
@pytest.mark.parametrize("n,size", [(12, 300), (20, 157), (12, 5)])
def test_two_stage_equals_jax_top_k(backend, c, n, size):
    """The masked panel, then kernel 2 (the select's plain version and the
    wrappers' stable sorts), over DBs smaller than n, of n rows, and on
    both sides of a 128-column tile; duplicate rows on the tiles' and the
    2- and 4-shard boundaries, the queries that tie on them, size < C and
    size < n."""
    rng = np.random.default_rng(c + n)
    d = 16
    q, db = _tied_db(rng, c, d, [1, 4, 11, 19, 64, 75, 128, 150, 225])
    k = min(n, c)
    live = min(size, c)
    want = _jax_topk(q, db, size, k, backend)
    top_s, top_i, hit = _two_stage(q, db, size, n)
    np.testing.assert_array_equal(top_i.numpy(), want)
    panel = TREF.panel_topn_ref(torch.tensor(q), torch.tensor(db), size, n)
    for got, ref_ in zip((top_s, top_i, hit), panel):
        assert torch.equal(got, ref_)
    assert bool((~hit).sum(dim=1).eq(max(0, k - live)).all())


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
    for n in (20, c, 12):
        top_s, top_i, _ = _two_stage(q, db, c, n)
        assert bool(torch.isfinite(top_s).all())
        np.testing.assert_array_equal(top_i.numpy(),
                                      _jax_topk(q, db, c, n, backend))


def test_empty_db():
    """No live row: every score -inf, rows 0.. in ascending order, no hit;
    no row at all: an empty result."""
    rng = np.random.default_rng(6)
    q, db = (rng.normal(size=s).astype(np.float32) for s in ((3, 8),
                                                            (50, 8)))
    for c in (20, 32, 50):
        top_s, top_i, hit = _two_stage(q, db[:c], 0, 20)
        assert torch.equal(top_i, torch.arange(20).expand(3, 20))
        assert not bool(hit.any()) and bool(torch.isinf(top_s).all())
    np.testing.assert_array_equal(
        _two_stage(q, db, 0, 20)[1].numpy(),
        _jax_topk(q, db, 0, 20, "reference"))
    top_s, top_i, hit = RT.topn_cuda(torch.tensor(q), torch.tensor(db[:0]),
                                     torch.tensor(0, dtype=torch.int32), 20)
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
    floats): a shard split of `width` rows (each shard's select to
    min(n, C_l) over its panel, their pool of explicit rows merged by the
    select and by the wrappers' stable sorts) equals one stable sort of
    the panel, scores, rows and hits; and so do the select and the stable
    sort over the whole panel."""
    rng = np.random.default_rng(seed)
    panel = torch.tensor(rng.choice(_VALUES, (nq, c)), dtype=torch.float32)
    k = min(n, c)
    want_s, want_i = TREF.stable_topk(panel, n)
    parts = [TREF.topn_select_ref(panel[:, c0:c0 + width], None,
                                  min(n, panel[:, c0:c0 + width].shape[1]),
                                  row0=c0)
             for c0 in range(0, c, width)]
    pool = (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1].int() for p in parts], 1))
    for merge in (TREF.topn_select_ref, TREF.topn_merge_ref):
        top_s, top_i, hit, _ = merge(*pool, k)
        assert torch.equal(top_i, want_i) and torch.equal(top_s, want_s)
        assert torch.equal(hit, torch.isfinite(want_s))
    # the panel route: kernel 2's select over the panel itself, and the
    # stable sort the wrappers' CPU glue runs in its place
    sel = TREF.topn_select_ref(panel, None, k)
    assert torch.equal(sel[1], want_i) and torch.equal(sel[0], want_s)
    glue = TREF.topn_merge_ref(panel, None, k)
    assert torch.equal(glue[1], want_i) and torch.equal(glue[0], want_s)


@pytest.mark.parametrize("route", ["shards", "select"])
@pytest.mark.parametrize("k", [6, 3, 2])
def test_negative_zero_ties_positive_zero(route, k):
    """-0.0 == 0.0 in the order: they tie, lowest row first (a stable
    sort's order, not a sign-aware total order), also where k cuts among
    them; each keeps its own sign: kernel 2's select over the panel, and
    over three shards' selects merged by the select over their rows."""
    panel = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, -0.0]])
    if route == "shards":
        parts = [TREF.topn_select_ref(panel[:, c0:c0 + 2], None, 2, row0=c0)
                 for c0 in (0, 2, 4)]
        top_s, top_i, _, _ = TREF.topn_select_ref(
            torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1].int() for p in parts], 1), k)
    else:
        top_s, top_i, _, _ = TREF.topn_select_ref(panel, None, k)
    assert top_i.tolist() == [[4, 0, 1, 2, 3, 5][:k]]
    want_s = TREF.stable_topk(panel, k)[0]
    assert torch.equal(torch.signbit(top_s), torch.signbit(want_s))


# ---------------------------------------------------------------------------
# the payload and the plan
# ---------------------------------------------------------------------------

def test_merge_payload_layouts():
    """Kernel 2's plain version: records gathered by row from a shard's
    panels in rank order, and carried by pool position (a pool of shards'
    candidates: each 9-column shard's select) into the replay's layout
    (farthest first, valid &= hit), as gather_records lays them out."""
    rng = np.random.default_rng(13)
    c, nq, n, off = 40, 4, 6, 100
    panels = (torch.tensor(rng.integers(0, M, (c, R)), dtype=torch.int32),
              torch.tensor(rng.integers(0, M, (c, R)), dtype=torch.int32),
              torch.tensor(rng.random((c, R)), dtype=torch.float32),
              torch.tensor(rng.random((c, R)) < 0.5))
    panel = torch.tensor(rng.normal(size=(nq, c)), dtype=torch.float32)
    panel[:, 30:] = float("-inf")
    parts = [TREF.topn_select_ref(panel[:, c0:c0 + 9], None,
                                  min(n, panel[:, c0:c0 + 9].shape[1]),
                                  row0=c0 + off) for c0 in range(0, c, 9)]
    pool = (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1].int() for p in parts], 1))
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
    """The tile per bucket is the similarity kernel's, at every C and n:
    the panel takes C whole, so no split of the DB depends on the card."""
    for c in (1, 100, 8192, 32768):
        for n in (1, 20, 128, 512):
            assert RT.plan(nq, c, 1536, n=n) == (tile, RT.PANEL)
    assert RT.tile_for(nq, 1536) == tile
    # the streaming kernel holds its 8 queries in shared memory, up to D =
    # 7,263; past that the GEMM takes even one query
    assert RT.plan(nq, 100, 7263).tile == tile
    assert RT.plan(nq, 100, 7264).tile == max(tile, 32)


@pytest.mark.parametrize("nq", [8, 64, 1024])
@pytest.mark.parametrize("n", [129, 256, 512])
@pytest.mark.parametrize("size", [1900, 300])
def test_large_n_two_stage_at_the_plan_equals_jax_top_k(nq, n, size):
    """n past 128 takes the panel route at the similarity kernel's tile:
    its plain version (the masked panel, then kernel 2's radix select)
    equals `jax.lax.top_k` and one stable sort over the same masked panel,
    ties on the GEMM tiles' boundaries, size below C and below n. (`lax.
    top_k` runs over the port's panel: 512 ranks of 2,000 scores hold gaps
    near fp32's rounding, which the two packages' similarities may order
    either way, ROADMAP §4.5.)"""
    rng = np.random.default_rng(nq + n + size)
    c, d = 2000, 16
    pl = RT.plan(nq, c, 1536, n=n)
    assert pl.route == RT.PANEL and pl.tile == RT.tile_for(nq, 1536)
    q, db = _tied_db(rng, c, d, [128 * i for i in range(1, 6)] + [999])
    q = np.concatenate([q, rng.normal(size=(nq - len(q), d))
                        .astype(np.float32)]) if nq > len(q) else q[:nq]
    scores = TREF.panel_ref(torch.tensor(q), torch.tensor(db), size)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()), n)[1])
    top_s, top_i, hit = TREF.panel_select_topn_ref(
        torch.tensor(q), torch.tensor(db), size, n)
    np.testing.assert_array_equal(top_i.numpy(), want)
    panel = TREF.panel_topn_ref(torch.tensor(q), torch.tensor(db), size, n)
    for got, ref_ in zip((top_s, top_i, hit), panel):
        assert torch.equal(got, ref_)
    assert int((~hit).sum()) == len(q) * max(0, n - size)
    # and through the wrappers' glue on CPU tensors
    got = RT.topn_cuda(torch.tensor(q), torch.tensor(db),
                       torch.tensor(size, dtype=torch.int32), n)
    for x, y in zip(got, panel):
        assert torch.equal(x, y)


def test_plan_past_128_neighbours():
    """Past n = 128 the plan is what it is below: the panel route with the
    similarity kernel's tile (no list sets it), at every bucket, and at
    KNN's call (Q = 84, C = 1,470, D = 64, top-40)."""
    for n in (20, 128, 129, 256, 512):
        for nq, tile in ((8, 8), (64, 64), (1024, 128)):
            assert RT.plan(nq, 32768, 1536, n=n) == (tile, RT.PANEL)
    assert RT.tile_for(1024, 1536) == 128 and RT.tile_for(64, 1536) == 64
    assert RT.plan(84, 1470, 64, n=40) == (128, RT.PANEL)


@pytest.mark.parametrize("nq,c,d,n,tile", [
    (1024, 32768, 1536, 20, 128),     # the route's buckets, C = 32768
    (64, 32768, 1536, 20, 64),
    (8, 32768, 1536, 20, 8),
    (1024, 65536, 1536, 20, 128),     # the graph phase's grow
    (8, 65536, 1536, 20, 8),
    (1024, 8192, 1536, 20, 128),      # a shard at S = 4
    (8, 8192, 1536, 20, 8),
    (84, 1470, 64, 40, 128),          # KNN's call
    (64, 8192, 1536, 20, 64),         # a shard at S = 4, bucket 64
    (8, 4096, 1536, 20, 8),
    (1024, 32768, 1536, 129, 128),    # past n = 128
])
def test_plan_route_switch(nq, c, d, n, tile):
    """The route from (Q, C, D, n) alone, at each shape the list route
    used to take (n <= 128 on a grid that filled the card) and at those
    it did not: the panel, at the tile the lists scored at, which is
    `tile_for`'s (so every score stays bit-equal to the parent's)."""
    pl = RT.plan(nq, c, d, n=n)
    assert pl == (tile, RT.PANEL)
    assert pl.tile == RT.tile_for(nq, d)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_knn_shape_takes_the_panel_and_equals_jax_top_k(backend):
    """KNN's call at its Fig. 2 shape (Q = 84 test rows, C = 1,470
    win-rate rows, D = 64, top-40): the panel route, its top-40 rows equal
    to `jax.lax.top_k` over the port's panel and, with the scores, to one
    stable sort of it, ties on the tiles' boundaries; against `lax.top_k`
    over the JAX similarity (its oracle and its Pallas kernel in
    interpret mode) a row may differ only at a near-tie (two of its 41
    best scores within 1e-5: the two similarities round apart)."""
    rng = np.random.default_rng(84)
    c, d, n = 1470, 64, 40
    assert RT.plan(84, c, d, n=n).route == RT.PANEL
    q, db = _tied_db(rng, c, d, [128, 256, 640, 1024, 1280])
    q = np.concatenate([q, rng.normal(size=(84 - len(q), d))
                        .astype(np.float32)])
    qt, dbt = torch.tensor(q), torch.tensor(db)
    got_s, got_i = TOPS.similarity_topk(qt, dbt, n)
    panel = TREF.panel_ref(qt, dbt, None)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(
        jax.lax.top_k(jnp.asarray(panel.numpy()), n)[1]))
    want = TREF.stable_topk(panel, n)
    assert torch.equal(got_s, want[0]) and torch.equal(got_i, want[1])
    differ = (got_i.numpy() != _jax_topk(q, db, c, n, backend)).any(axis=1)
    best = TREF.stable_topk(panel, n + 1)[0].numpy()
    near = (np.abs(np.diff(best, axis=1)) < 1e-5).any(axis=1)
    assert not (differ & ~near).any()
    assert differ.sum() <= 2


@pytest.mark.parametrize("n", [129, 256, 512, 600])
@pytest.mark.parametrize("size", [None, 450, 100])
def test_panel_route_ties_dead_rows_and_small_db(n, size):
    """The panel route's plain version at n past 128 against one stable
    sort of the masked panel and `jax.lax.top_k`: rows tied across the
    128-column tiles, size below C and below n (dead rows in ascending
    row order), and a DB smaller than n (k = C)."""
    rng = np.random.default_rng(n + (size or 0))
    for c in (520, 300):
        q, db = _tied_db(rng, c, 8, [128, 256, 384, 511])
        qt, dbt = torch.tensor(q), torch.tensor(db)
        k = min(n, c)
        got = TREF.panel_select_topn_ref(qt, dbt, size, n)
        want = TREF.panel_topn_ref(qt, dbt, size, n)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        assert got[1].shape == (len(q), k)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(
            jax.lax.top_k(jnp.asarray(TREF.panel_ref(qt, dbt, size)
                                      .numpy()), k)[1]))


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4), st.integers(1, 300), st.integers(1, 300),
       st.integers(0, 2 ** 31 - 1))
def test_select_over_tied_pools_equals_stable_sort(nq, p, k, seed):
    """Kernel 2's select over pools of few distinct scores (-inf, -0.0 and
    0.0 among them), explicit rows with repeated empty slots (-inf,
    EMPTY_ROW) and rows that tie: equal to the rounds' plain version (a
    stable sort by row, then by score), scores, rows and positions; the
    radix passes stop once the k-th's bin is exactly what is needed."""
    rng = np.random.default_rng(seed)
    k = min(k, p)
    pool_s = torch.tensor(rng.choice(_VALUES, (nq, p)), dtype=torch.float32)
    rows = rng.integers(0, 3 * p, (nq, p)).astype(np.int32)
    empty = rng.random((nq, p)) < 0.2
    rows[empty] = TREF.EMPTY_ROW
    pool_s[torch.tensor(empty)] = float("-inf")
    pool_i = torch.tensor(rows)
    want = TREF.topn_merge_ref(pool_s, pool_i, k)
    got = TREF.topn_select_ref(pool_s, pool_i, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    carried = tuple(torch.tensor(rng.integers(0, 9, (nq, p, 2)),
                                 dtype=torch.int32) for _ in range(2)) + (
        torch.tensor(rng.random((nq, p, 2)), dtype=torch.float32),
        torch.tensor(rng.random((nq, p, 2)) < 0.5))
    want = TREF.topn_merge_ref(pool_s, pool_i, k, carried=carried)
    got = TREF.topn_select_ref(pool_s, pool_i, k, carried=carried)
    for x, y in zip(got[3], want[3]):
        assert torch.equal(x, y)
    passes = TREF.key_select_ref(pool_s, pool_i, k)[1]
    assert bool(((passes >= 1) & (passes <= 9)).all())


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("n", [129, 300])
def test_cross_shard_select_past_128(shards, n):
    """The sharded retrieve past k = 128 through the kernels' glue on CPU
    tensors (per shard the panel and the select with records gathered by
    row in rank order, then the cross-shard select with records carried
    by position into the replay's layout): rows equal to `jax.lax.top_k`
    over the whole panel, every output equal to the sharded panel + stable
    sort; each layout of kernel 2's select against the rounds' plain
    version on the same pool."""
    rng = np.random.default_rng(shards + n)
    c, d = 640, 16
    c_l = c // shards
    q, db = _tied_db(rng, c, d, [c_l * s for s in range(1, shards)] + [77])
    size = c - 41
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
    # one shard's panel: the select by row, rank order
    kl = min(n, c_l)
    panel = TREF.panel_ref(qt, emb[1], sizes[1], offset=c_l)
    sel = TREF.topn_select_ref(panel, None, kl, row0=c_l,
                               panels=tuple(x[1] for x in panels),
                               offset=c_l)
    order = TREF.stable_topk(panel, kl)[1]
    assert torch.equal(sel[1], order + c_l)
    for x, y in zip(sel[3], panels):
        assert torch.equal(x, y[1][order])
    # the CPU glue's stable sort over the same panel: every output equal
    glue = TREF.topn_merge_ref(panel, None, kl, row0=c_l,
                               panels=tuple(x[1] for x in panels),
                               offset=c_l)
    for x, y in zip(glue[:3] + glue[3], sel[:3] + sel[3]):
        assert torch.equal(x, y)
