"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: without a CUDA device every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.elo_scan import (MAX_MODELS, elo_scan_cuda,
                                          elo_scan_gather_cuda,
                                          elo_scan_gather_select_cuda,
                                          elo_scan_select_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.similarity_topk import similarity_cuda

pytestmark = pytest.mark.gpu

# similarity: the JAX suite's own bar between its backends
SIM_TOL = 1e-5
# ratings: the JAX suite's bar (tests/test_router_state.py). The kernel
# replays in the reference's order and applies r + delta * coef as it
# does; it takes 10^x from one ex2.approx and 1 / x from one rcp.approx
# (a few ulp each, where the plain version rounds powf and a division
# once), and the ELO update damps an error in one step's expected score,
# so the two stay far inside this bar at every T tested
R_RTOL, R_ATOL = 1e-5, 1e-3
# attention: the JAX suite's bars between its backends
# (tests/test_kernels.py), 2e-3 in fp32 and 3e-2 in bf16, where the
# output's own rounding is 2^-9 of its size
ATT_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _records(rng, q, t, m, dev, p_valid=0.7):
    a = rng.integers(0, m, (q, t)).astype(np.int32)
    b = ((a + 1 + rng.integers(0, m - 1, (q, t))) % m).astype(np.int32) \
        if m > 1 else a.copy()
    s = rng.choice([0.0, 0.5, 1.0], (q, t)).astype(np.float32)
    v = rng.random((q, t)) < p_valid
    return tuple(torch.tensor(x, device=dev) for x in (a, b, s, v))


@pytest.mark.parametrize("nq,n,d", [(1, 17, 64), (8, 300, 1536),
                                    (130, 1000, 50), (257, 2049, 384),
                                    # every tile at the path's D, ragged N
                                    (1, 1001, 1536), (8, 1001, 1536),
                                    (16, 1001, 1536), (64, 1001, 1536),
                                    (65, 1001, 1536), (128, 1001, 1536),
                                    (1024, 1001, 1536)])
def test_similarity_kernel_matches_plain(dev, nq, n, d):
    rng = np.random.default_rng(nq + n)
    q = torch.tensor(rng.normal(size=(nq, d)), dtype=torch.float32,
                     device=dev)
    db = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                      device=dev)
    got = similarity_cuda(q, db)
    want = ref.similarity_ref(q, db)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SIM_TOL, atol=SIM_TOL)


@pytest.mark.parametrize("tile", [8, 32, 64, 128])
@pytest.mark.parametrize("nq,n,d", [(5, 259, 1536), (3, 130, 50)])
def test_similarity_every_tile_matches_plain(dev, tile, nq, n, d):
    """Each tile the kernel can take (chip_smoke.py times them to place the
    switch between them), with vector and scalar loads."""
    rng = np.random.default_rng(tile + d)
    q = torch.tensor(rng.normal(size=(nq, d)), dtype=torch.float32,
                     device=dev)
    db = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                      device=dev)
    out = torch.empty((nq, n), device=dev)
    lib = _build.library("similarity")
    _build.check(lib.similarity_launch_tile(
        q.data_ptr(), db.data_ptr(), out.data_ptr(), nq, n, d, tile,
        _build.stream_handle(dev)), "similarity_launch_tile")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.similarity_ref(q, db), rtol=SIM_TOL,
                               atol=SIM_TOL)


def test_similarity_topk_ties_lowest_index_first(dev):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(40, 64)).astype(np.float32)
    db = torch.tensor(np.repeat(base, 5, axis=0), device=dev)  # 5-way ties
    q = torch.tensor(base[:6], device=dev)
    _, got = KOPS.similarity_topk(q, db, 12)
    _, want = KOPS.similarity_topk(q, db, 12, backend="reference")
    assert torch.equal(got[:, :5], want[:, :5])
    assert torch.equal(got[:, :5], torch.arange(5, device=dev)
                       + 5 * torch.arange(6, device=dev)[:, None])


# and every segment width (M <= 8, 16, 32: 4, 2, 1 queries a warp) at
# every chunk tail (T below, just above and at multiples of the
# 32-record chunk), at 37 queries, which fill no whole warp or block
@pytest.mark.parametrize("nq,t,m", [(1, 1, 1), (5, 33, 10), (300, 160, 10),
                                    (64, 70, MAX_MODELS)]
                         + [(37, t, m) for m in (1, 2, 10, 16, 17, 32)
                            for t in (1, 31, 33, 160, 4097)])
def test_elo_scan_kernel_matches_plain(dev, nq, t, m):
    rng = np.random.default_rng(t * m)
    r0 = torch.tensor(1000 + 50 * rng.normal(size=(nq, m)),
                      dtype=torch.float32, device=dev)
    a, b, s, v = _records(rng, nq, t, m, dev)
    got = elo_scan_cuda(r0, a, b, s, v)
    want = ref.elo_scan_ref(r0, a, b, s, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=R_RTOL, atol=R_ATOL)


def test_elo_scan_invalid_records_are_exact_noops(dev):
    rng = np.random.default_rng(7)
    r0 = torch.tensor(1000 + 50 * rng.normal(size=(9, 10)),
                      dtype=torch.float32, device=dev)
    a, b, s, v = _records(rng, 9, 50, 10, dev)
    assert torch.equal(elo_scan_cuda(r0, a, b, s, torch.zeros_like(v)), r0)


def test_elo_scan_select_matches_plain(dev):
    rng = np.random.default_rng(11)
    nq, t, m = 1024, 160, 10
    r0 = torch.tensor(1000 + 50 * rng.normal(size=(nq, m)),
                      dtype=torch.float32, device=dev)
    a, b, s, v = _records(rng, nq, t, m, dev)
    g = torch.tensor(1000 + 30 * rng.normal(size=m), dtype=torch.float32,
                     device=dev)
    costs = torch.tensor(rng.uniform(0.5, 40, m), dtype=torch.float32,
                         device=dev)
    # budgets below the cheapest model exercise the fallback
    bud = torch.tensor(rng.uniform(0.0, 45, nq), dtype=torch.float32,
                       device=dev)
    got_r, got_c = elo_scan_select_cuda(r0, a, b, s, v, g, costs, bud, p=0.5)
    want_r, want_c = ref.elo_scan_select_ref(r0, a, b, s, v, g, costs, bud,
                                             p=0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_r, want_r, rtol=R_RTOL, atol=R_ATOL)
    comb = 0.5 * g[None] + 0.5 * want_r
    comb = torch.where(costs[None] <= bud[:, None], comb,
                       torch.full_like(comb, float("-inf")))
    top2 = torch.topk(comb, 2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]).abs() < 1e-3
    assert torch.equal(got_c[~near_tie], want_c[~near_tie])


def test_elo_scan_select_ties_and_fallback(dev):
    m = 6
    r0 = torch.full((3, m), 1000.0, device=dev)
    a = torch.zeros((3, 1), dtype=torch.int32, device=dev)
    s = torch.zeros((3, 1), device=dev)
    v = torch.zeros((3, 1), dtype=torch.bool, device=dev)
    g = torch.full((m,), 1000.0, device=dev)
    costs = torch.tensor([3.0, 1.0, 2.0, 1.0, 5.0, 1.0], device=dev)
    bud = torch.tensor([0.5, 2.5, 10.0], device=dev)
    _, ch = elo_scan_select_cuda(r0, a, a, s, v, g, costs, bud)
    # nothing fits -> first cheapest (1); ties -> first feasible index
    assert ch.tolist() == [1, 1, 0]


def test_elo_scan_rejects_too_many_models(dev):
    r0 = torch.zeros((2, MAX_MODELS + 1), device=dev)
    a = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        elo_scan_cuda(r0, a, a, a.float(), a.bool())


@pytest.mark.parametrize("size", [0, 5, 19, 700, 1500])
def test_retrieve_replay_select_matches_reference(dev, size):
    rng = np.random.default_rng(size)
    nq, c, d, r, m, n = 64, 1500, 256, 8, 10, 20
    q = torch.tensor(rng.normal(size=(nq, d)), dtype=torch.float32,
                     device=dev)
    emb = torch.tensor(rng.normal(size=(c, d)), dtype=torch.float32,
                       device=dev)
    a, b, s, v = _records(rng, c, r, m, dev)
    init = torch.tensor(1000 + 40 * rng.normal(size=m), dtype=torch.float32,
                        device=dev)
    costs = torch.tensor(rng.uniform(0.5, 40, m), dtype=torch.float32,
                         device=dev)
    bud = torch.tensor(rng.uniform(0.0, 45, nq), dtype=torch.float32,
                       device=dev)
    sz = torch.tensor(size, dtype=torch.int32, device=dev)
    args = (q, emb, a, b, s, v, sz, init, init, costs, bud)
    got = KOPS.retrieve_replay_select(*args, n=n)
    want = KOPS.retrieve_replay_select(*args, n=n, backend="reference")
    torch.cuda.synchronize()
    # rows may differ only where two of the n+1 best scores sit within
    # the similarity tolerance of each other
    panel = ref.similarity_ref(q, emb)
    panel[:, size:] = float("-inf")
    best = ref.stable_topk(panel, n + 1)[0]
    gaps = (best[:, :-1] - best[:, 1:]).abs().nan_to_num(0.0)
    tied = (gaps < SIM_TOL).any(dim=1)
    same = (got[1] == want[1]).all(dim=1)
    assert bool((same | tied).all())
    assert int(same.sum()) >= nq - 2
    torch.testing.assert_close(got[0][same], want[0][same], rtol=R_RTOL,
                               atol=R_ATOL)
    if size == 0:
        assert torch.equal(got[0], init.expand(nq, m))


@pytest.mark.parametrize("m", [5, 10, 17])
def test_elo_scan_select_segments_do_not_leak(dev, m):
    """Neighbouring queries of one warp, each in its own segment: exact
    ties (flat scores), budgets that fit nothing (the first cheapest
    model), and distinct scores, side by side. Without records the
    ratings are the inputs exactly, so the choices must equal the plain
    version's exactly, ties included."""
    nq = 24
    rng = np.random.default_rng(m)
    r0 = np.full((nq, m), 1000.0, np.float32)
    r0[1::3] += rng.normal(size=(nq // 3, m)).astype(np.float32) * 50
    costs = np.asarray(rng.permutation(np.arange(1, m + 1) % 4 + 1),
                       np.float32)
    bud = np.tile(np.asarray([2.5, 0.5, 10.0], np.float32), nq // 3)
    bud[2::6] = 0.0                                    # nothing fits
    args = [torch.tensor(x, device=dev) for x in (r0, np.full(m, 1000.0,
                                                              np.float32),
                                                  costs, bud)]
    a = torch.zeros((nq, 4), dtype=torch.int32, device=dev)
    s = torch.zeros((nq, 4), device=dev)
    v = torch.zeros((nq, 4), dtype=torch.bool, device=dev)
    got_r, got_c = elo_scan_select_cuda(args[0], a, a, s, v, *args[1:])
    want_r, want_c = ref.elo_scan_select_ref(args[0], a, a, s, v,
                                             *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got_r, args[0])
    assert torch.equal(got_c, want_c)


def _panels(rng, c, r, m, dev):
    return _records(rng, c, r, m, dev, p_valid=0.8)


@pytest.mark.parametrize("m,nq,n,p_hit", [(10, 1024, 20, 1.0),
                                          (10, 37, 20, 0.7), (4, 9, 3, 0.7),
                                          (32, 5, 40, 0.7), (10, 13, 20, 0.0)])
def test_gather_route_equals_pregathered(dev, m, nq, n, p_hit):
    """The gather route reads the records in place through the top-n rows,
    farthest first, with a miss (hit False) as invalid records: the same
    records through the same arithmetic as `gather_records` + the
    pre-gathered kernel, so ratings and choices are equal bit for bit;
    with every row a miss, the ratings are the prior exactly."""
    rng = np.random.default_rng(nq + n)
    c, r = 300, 8
    panels = _panels(rng, c, r, m, dev)
    top_i = torch.tensor(rng.integers(0, c, (nq, n)), device=dev)
    hit = torch.tensor(rng.random((nq, n)) < p_hit, device=dev)
    g = torch.tensor(1000 + 30 * rng.normal(size=m), dtype=torch.float32,
                     device=dev)
    costs = torch.tensor(rng.uniform(0.5, 40, m), dtype=torch.float32,
                         device=dev)
    bud = torch.tensor(rng.uniform(0.0, 45, nq), dtype=torch.float32,
                       device=dev)
    recs = ref.gather_records(*panels, top_i, hit)
    prior = g.expand(nq, m)
    got = elo_scan_gather_select_cuda(g, panels, top_i, hit, g, costs, bud)
    want = elo_scan_select_cuda(prior, *recs, g, costs, bud)
    local = elo_scan_gather_cuda(g, panels, top_i, hit)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(local, elo_scan_cuda(prior, *recs))
    torch.testing.assert_close(local, ref.elo_scan_gather_ref(
        g, panels, top_i, hit), rtol=R_RTOL, atol=R_ATOL)
    if p_hit == 0.0:
        assert torch.equal(local, prior)


def test_fold_of_262144_steps_matches_host_folds(dev):
    """A fold at the fit's shape (Q = 1, 262,144 steps, the first 196,000
    valid) against host folds of the plain formula: no farther from the
    float64 fold than max(2 x the float32 fold's distance, R_ATOL +
    R_RTOL |r|) per model. The float32 host fold measures what fp32
    rounding alone does over this many steps, so the bar scales with it;
    dropping the last valid record misses it by orders of magnitude."""
    rng = np.random.default_rng(262144)
    t, valid, m = 262144, 196000, 10
    a = rng.integers(0, m, t).astype(np.int32)
    b = ((a + rng.integers(1, m, t)) % m).astype(np.int32)
    s = rng.choice([0.0, 0.5, 1.0], t).astype(np.float32)
    v = np.arange(t) < valid
    r0 = np.full(m, 1000.0)
    host = {dt: ref.elo_fold_host(r0, a[:valid], b[:valid], s[:valid],
                                  v[:valid], dtype=dt)
            for dt in (np.float32, np.float64)}
    r64 = host[np.float64]
    bar = np.maximum(2 * np.abs(host[np.float32] - r64),
                     R_ATOL + R_RTOL * np.abs(r64))
    recs = [torch.tensor(x, device=dev)[None] for x in (a, b, s, v)]
    init = torch.full((1, m), 1000.0, device=dev)
    got = elo_scan_cuda(init, *recs)[0].cpu().numpy()
    assert np.all(np.abs(got - r64) <= bar)
    recs[3][0, valid - 1] = False
    ctl = elo_scan_cuda(init, *recs)[0].cpu().numpy()
    assert np.max(np.abs(ctl - r64) / bar) >= 10


def test_wrappers_count_launches(dev):
    _build.reset_launches()
    x = torch.ones((4, 8), device=dev)
    similarity_cuda(x, x)
    elo_scan_cuda(torch.zeros((1, 3), device=dev),
                  *(torch.zeros((1, 2), dtype=dt, device=dev)
                    for dt in (torch.int32, torch.int32, torch.float32,
                               torch.bool)))
    KOPS.similarity(x, x, backend="reference")
    qkv = torch.ones((1, 128, 2, 32), device=dev)
    flash_attention_cuda(qkv, qkv, qkv)
    KOPS.flash_attention(qkv, qkv, qkv, backend="reference")
    decode_attention_cuda(qkv[:, 0], qkv, qkv,
                          torch.ones((1,), dtype=torch.int32, device=dev))
    assert _build.launch_counts() == {"similarity": 1, "elo_scan": 1,
                                      "elo_scan_select": 0,
                                      "flash_attention": 1,
                                      "decode_attention": 1}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _normal(rng, shape, dtype, dev):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=dev).to(dtype)


@pytest.mark.parametrize("b,s,h,hk,dh", [(1, 256, 4, 4, 64),
                                         (2, 200, 8, 2, 32),
                                         (1, 333, 8, 2, 128),
                                         (2, 77, 4, 1, 128),
                                         (1, 512, 8, 1, 128),
                                         (2, 200, 16, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, b, s, h, hk, dh, dtype):
    rng = np.random.default_rng(s + dh)
    q = _normal(rng, (b, s, h, dh), dtype, dev)
    k = _normal(rng, (b, s, hk, dh), dtype, dev)
    v = _normal(rng, (b, s, hk, dh), dtype, dev)
    got = flash_attention_cuda(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("window,causal", [(1, True), (100, True),
                                           (128, True), (0, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_and_noncausal(dev, window, causal, dtype):
    """window = 1 leaves each row its own key: most key tiles are wholly
    masked for most rows, which must contribute nothing. fp32 runs the
    CUDA-core kernel, bf16 the tensor-core one, each held to the JAX
    suite's bar for its type (ATT_TOL: the bf16 kernel also rounds its
    softmax weights to bf16, ~2^-9 of each term, well inside 3e-2). With
    one key a row's weight is exactly 1, so both types give v exactly."""
    rng = np.random.default_rng(window)
    b, s, h, hk, dh = 2, 300, 8, 2, 64
    q = _normal(rng, (b, s, h, dh), dtype, dev)
    k = _normal(rng, (b, s, hk, dh), dtype, dev)
    v = _normal(rng, (b, s, hk, dh), dtype, dev)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=0.3)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=0.3)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    if window == 1:
        torch.testing.assert_close(got, v.repeat_interleave(h // hk, dim=2),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,s,h,hk,dh", [(2, 50, 8, 1, 128),
                                         (3, 1, 8, 1, 64),
                                         (1, 129, 16, 2, 128),
                                         (2, 383, 8, 1, 32),
                                         (1, 1000, 16, 2, 128)])
def test_flash_attention_bf16_tile_edges(dev, b, s, h, hk, dh):
    """The tensor-core kernel's 128-row tiles: S below one tile, S one
    past a tile and S not a multiple of it (TMA zero-fills the rows past
    S, and their scores are masked), with 8 query heads to a KV head."""
    rng = np.random.default_rng(s * h)
    q = _normal(rng, (b, s, h, dh), torch.bfloat16, dev)
    k = _normal(rng, (b, s, hk, dh), torch.bfloat16, dev)
    v = _normal(rng, (b, s, hk, dh), torch.bfloat16, dev)
    got = flash_attention_cuda(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = ATT_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,t,h,hk,dh", [(2, 512, 4, 4, 64),
                                         (3, 1000, 32, 8, 128),
                                         (4, 77, 8, 1, 32),
                                         (2, 300, 16, 2, 128),
                                         (3, 1056, 16, 16, 128)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_decode_attention_kernel_matches_plain(dev, b, t, h, hk, dh,
                                               q_dtype, kv_dtype):
    rng = np.random.default_rng(t + h)
    q = _normal(rng, (b, h, dh), q_dtype, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    lens = rng.integers(1, t + 1, b)
    lens[0] = t                                   # one full cache
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attention_cuda(q, k, v, kv_len)
    # the kernel rounds the cache to q's type, as the model's plain path
    # does (`ck.astype(q.dtype)`) before its product
    want = ref.decode_attention_ref(q, k.to(q_dtype), v.to(q_dtype), kv_len)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    tol = ATT_TOL[q_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_decode_attention_empty_rows_are_zero(dev):
    rng = np.random.default_rng(9)
    b, t, h, hk, dh = 3, 260, 8, 2, 64
    q = _normal(rng, (b, h, dh), torch.float32, dev)
    k = _normal(rng, (b, t, hk, dh), torch.float32, dev)
    v = _normal(rng, (b, t, hk, dh), torch.float32, dev)
    kv_len = torch.tensor([0, 5, 129], dtype=torch.int32, device=dev)
    got = decode_attention_cuda(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got[1:], want[1:], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,hk", [(256, 4), (300, 1)])
def test_decode_matches_flash_last_row(dev, s, hk):
    """decode kernel over a full cache == last row of the prefill kernel
    (the counterpart of tests/test_kernels.py's check on the TPU
    kernels)."""
    rng = np.random.default_rng(s)
    b, h, dh = 2, 4, 64
    q = _normal(rng, (b, s, h, dh), torch.float32, dev)
    k = _normal(rng, (b, s, hk, dh), torch.float32, dev)
    v = _normal(rng, (b, s, hk, dh), torch.float32, dev)
    full = flash_attention_cuda(q, k, v, causal=True)
    dec = decode_attention_cuda(q[:, -1], k, v,
                                torch.full((b,), s, dtype=torch.int32,
                                           device=dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-3, atol=2e-3)


def test_attention_kernels_reject_uncovered_cases(dev):
    x = torch.ones((1, 128, 4, 96), device=dev)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_cuda(x, x, x)
    h16 = torch.ones((1, 128, 16, 64), device=dev)
    with pytest.raises(ValueError, match="up to 8"):
        decode_attention_cuda(h16[:, 0], h16[:, :, :1], h16[:, :, :1],
                              torch.ones((1,), dtype=torch.int32,
                                         device=dev))
    half = torch.ones((1, 128, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(half, half, half)
    q32 = torch.ones((1, 2, 64), device=dev)
    kv16 = torch.ones((1, 128, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 cache"):
        decode_attention_cuda(q32, kv16, kv16,
                              torch.ones((1,), dtype=torch.int32,
                                         device=dev))


# ---------------------------------------------------------------------------
# the model's attention route
# ---------------------------------------------------------------------------

def _reduced_model(dev, arch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import FleetModel
    return FleetModel(get_reduced_config(arch, dtype="float32"), seed=0,
                      max_len=160, device=dev)


def test_attention_cases_the_kernels_do_not_cover_raise_on_cuda(dev):
    from repro_torch.models import layers as L
    m = _reduced_model(dev, "qwen3-8b")
    cfg, p = m.cfg, m.params["blocks"][0]["attn"]
    x = torch.ones((2, 3, cfg.d_model), device=dev)
    pos = torch.arange(3, device=dev).expand(2, 3)
    shape = (2, 16, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, device=dev),
             "v": torch.zeros(shape, device=dev)}
    with pytest.raises(NotImplementedError, match="cache index"):
        L.apply_attention(cfg, p, x, pos + 4, theta=cfg.rope_theta,
                          cache=cache, cache_index=4)
    with pytest.raises(NotImplementedError, match="window"):
        L.apply_attention(cfg, p, x, pos, theta=cfg.rope_theta, window=2)
    # the same calls run the plain attend when asked for it
    L.apply_attention(cfg, p, x, pos, theta=cfg.rope_theta, window=2,
                      backend="reference")


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b"])
def test_model_kernel_path_matches_plain_attention(dev, arch):
    """A reduced fp32 model through the kernels and through the plain
    attend: prefill + 5 decode steps fed the same tokens give logits
    within the fp32 attention bar, and FleetModel.generate launches one
    flash kernel per layer and one decode kernel per layer and step."""
    from repro_torch.models import transformer as T
    m = _reduced_model(dev, arch)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, 500, (3, 130)), device=dev)
    runs = {b: T.prefill(m.cfg, m.params, toks, m.max_len, backend=b,
                         cache_dtype=torch.float32)
            for b in ("cuda", "reference")}
    for i in range(6):
        got, want = runs["cuda"][0], runs["reference"][0]
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        tok = want.argmax(-1)[:, None]
        runs = {b: T.decode_step(m.cfg, m.params, runs[b][1], tok, 130 + i,
                                 backend=b) for b in runs}
    m.warmup([3])       # the decode graph: its eager warm-up run too
    _build.reset_launches()
    m.generate(toks.cpu().numpy(), 6)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == m.cfg.n_layers
    assert counts["decode_attention"] == m.cfg.n_layers * 5


# ---------------------------------------------------------------------------
# whisper's attention: bidirectional, cross-attention (Sq != Sk), cross
# decode over 1500 frames; the encdec and ssm models' kernel path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,h,hk,dh", [(2, 11, 1500, 20, 20, 64),
                                           (2, 1024, 1500, 20, 20, 64),
                                           (1, 1500, 1500, 20, 20, 64),
                                           (1, 130, 77, 8, 2, 128),
                                           (3, 1, 300, 4, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_separate_key_length(dev, b, s, t, h, hk, dh,
                                             dtype):
    """Without the causal mask the keys may number S_kv != S: whisper's
    cross prefill (a prompt against 1500 frames: 11 full 128-key tiles
    and a ragged tail of 92), its encoder (S = S_kv = 1500), and keys
    fewer than the queries. Held to the JAX suite's bar for the type."""
    rng = np.random.default_rng(s + t)
    q = _normal(rng, (b, s, h, dh), dtype, dev)
    k = _normal(rng, (b, t, hk, dh), dtype, dev)
    v = _normal(rng, (b, t, hk, dh), dtype, dev)
    got = flash_attention_cuda(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_flash_attention_causal_needs_one_length(dev):
    q = torch.ones((1, 128, 4, 64), device=dev, dtype=torch.bfloat16)
    kv = torch.ones((1, 256, 4, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="causal mask"):
        flash_attention_cuda(q, kv, kv, causal=True)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_whisper_cross_cache(dev, q_dtype):
    """One token against whisper's cross cache: T = 1500 fp32 rows, all
    valid, H = Hk = 20, dh = 64."""
    rng = np.random.default_rng(1500)
    b, t, h, dh = 16, 1500, 20, 64
    q = _normal(rng, (b, h, dh), q_dtype, dev)
    k = _normal(rng, (b, t, h, dh), torch.float32, dev)
    v = _normal(rng, (b, t, h, dh), torch.float32, dev)
    kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    got = decode_attention_cuda(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k.to(q_dtype), v.to(q_dtype), kv_len)
    torch.cuda.synchronize()
    tol = ATT_TOL[q_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "mamba2-780m"])
def test_encdec_and_ssm_kernel_path_matches_plain(dev, arch):
    """A reduced fp32 whisper (encoder flash, decoder flash, cross flash
    with S_kv != S, self and cross decode) and mamba2 (no attention)
    through the kernels and through the plain attend: prefill + 5 decode
    steps fed the same tokens give logits within the fp32 attention bar,
    and FleetModel.generate launches, per layer, one flash kernel a
    prefill (whisper: encoder, decoder and cross) and one decode kernel
    a step (whisper: self and cross)."""
    from repro_torch.models import transformer as T
    m = _reduced_model(dev, arch)
    cfg = m.cfg
    rng = np.random.default_rng(2)
    toks = torch.tensor(rng.integers(0, 500, (3, 64)), device=dev)
    enc = None
    if cfg.arch_type == "encdec":
        enc = torch.tensor(rng.normal(size=(3, cfg.n_audio_frames,
                                            cfg.d_model)),
                           dtype=torch.float32, device=dev)
    runs = {b: T.prefill(cfg, m.params, toks, m.max_len, backend=b,
                         cache_dtype=torch.float32, enc_embeds=enc)
            for b in ("cuda", "reference")}
    for i in range(6):
        got, want = runs["cuda"][0], runs["reference"][0]
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        tok = want.argmax(-1)[:, None]
        runs = {b: T.decode_step(cfg, m.params, runs[b][1], tok, 64 + i,
                                 backend=b) for b in runs}
    m.warmup([3])       # the decode graph: its eager warm-up run too
    _build.reset_launches()
    m.generate(toks.cpu().numpy(), 6)
    counts = _build.launch_counts()
    if cfg.arch_type == "encdec":
        assert counts["flash_attention"] == cfg.n_enc_layers \
            + 2 * cfg.n_layers
        assert counts["decode_attention"] == 2 * cfg.n_layers * 5
    else:
        assert counts["flash_attention"] == counts["decode_attention"] == 0


# ---------------------------------------------------------------------------
# captured graphs: the dispatcher's route graphs and the decode step's
# ---------------------------------------------------------------------------

def _graph_router(dev, dim=64, capacity=256, n_prompts=200, seed=0):
    from repro_torch.core.router import EagleConfig, EagleRouter
    rng = np.random.default_rng(seed)
    r = EagleRouter([f"m{i}" for i in range(6)], np.linspace(1.0, 8.0, 6),
                    EagleConfig(embed_dim=dim), db_capacity=capacity,
                    device=dev)
    a = rng.integers(0, 6, n_prompts * 4)
    r.fit(rng.normal(size=(n_prompts * 4, dim)).astype(np.float32), a,
          (a + 1 + rng.integers(0, 5, a.size)) % 6,
          rng.choice([0.0, 0.5, 1.0], a.size),
          query_id=np.arange(a.size) // 4)
    return r, rng


def _eager_route(disp, state, q, b):
    """The dispatch without a graph: the padded batch through
    route_batch_choices, as the eager dispatcher ran it."""
    from repro_torch.core.state import route_batch_choices
    nq, qb = q.shape[0], disp.bucket(q.shape[0])
    qp = torch.zeros((qb, q.shape[1]), device=state.device)
    qp[:nq] = torch.from_numpy(q).to(state.device)
    bp = torch.zeros((qb,), device=state.device)
    bp[:nq] = torch.from_numpy(b).to(state.device)
    res = route_batch_choices(state, qp, bp, disp.costs, **disp.kw)
    return res.choices[:nq].cpu().numpy(), res.topk_idx[:nq].cpu().numpy()


def test_route_graphs_equal_eager_routes(dev):
    """At every bucket of the ladder, on both replicas of a DoubleBuffer,
    after a commit and after a grow: the graph's choices and top-n rows
    equal the eager route's on the same state. Once both replicas have
    grown, the old replicas' graphs are evicted: the cache holds the
    live replicas' graphs only."""
    from repro_torch.core.dispatch import (RouteDispatcher, bucket_ladder,
                                           replica)
    from repro_torch.core.state import DoubleBuffer
    r, rng = _graph_router(dev)
    dbuf = DoubleBuffer(r.db, r.global_ratings, device=dev)
    disp = RouteDispatcher.for_router(r, max_bucket=256)
    rounds, seen = 0, set()
    while r.db.capacity == 256 or rounds < 4:
        st = dbuf.front
        seen.add(replica(st))
        disp.warmup(st)
        for qb in bucket_ladder(8, 256):
            for nq in (qb, qb // 2 + 1):
                q = rng.normal(size=(nq, 64)).astype(np.float32)
                b = rng.uniform(0.5, 9.0, nq).astype(np.float32)
                ch, top = disp.route_result(st, q, b)
                want_ch, want_top = _eager_route(disp, st, q, b)
                np.testing.assert_array_equal(ch, want_ch)
                np.testing.assert_array_equal(top, want_top)
                np.testing.assert_array_equal(disp.route(st, q, b), ch)
        n = 40
        a = rng.integers(0, 6, n)
        r.update(rng.normal(size=(n, 64)).astype(np.float32), a, (a + 1) % 6,
                 np.ones(n), query_id=10_000 + rounds * n + np.arange(n))
        dbuf.commit(r.global_ratings)
        rounds += 1
    assert r.db.capacity == 512
    del st
    for _ in range(2):            # both replicas at the grown capacity
        seen.add(replica(dbuf.front))
        disp.warmup(dbuf.front)
        dbuf.commit(r.global_ratings)
    ladder = len(bucket_ladder(8, 256))
    stats = disp.cache_stats()
    assert len(seen) == 4         # two replicas, before and after the grow
    assert stats["misses"] == stats["warmed"] == 4 * ladder
    assert stats["hits"] > 0 and stats["entries"] == 2 * ladder
    assert {k[-1] for k in stats["keys"]} == {replica(dbuf.front),
                                              replica(dbuf._back[0])}
    assert disp.telemetry()["cache_evicted"] == 2 * ladder


def test_ragged_run_after_warmup_captures_nothing(dev):
    """Batches of 1..300 with feedback committed between them, across
    both replicas and a grow, each replica warmed when it becomes the
    front: every capture is a warmup's, none is traffic's, and the
    process-wide count agrees."""
    from repro_torch import graphs
    from repro_torch.core.dispatch import RouteDispatcher
    from repro_torch.core.state import DoubleBuffer
    r, rng = _graph_router(dev, seed=1)
    dbuf = DoubleBuffer(r.db, r.global_ratings, device=dev)
    disp = RouteDispatcher.for_router(r, max_bucket=128)
    c0 = graphs.capture_count()
    for i in range(12):
        disp.warmup(dbuf.front)
        nq = int(rng.integers(1, 301))
        q = rng.normal(size=(nq, 64)).astype(np.float32)
        got = disp.route(dbuf.front, q, 5.0)
        assert got.shape == (nq,)
        a = rng.integers(0, 6, 20)
        r.update(rng.normal(size=(20, 64)).astype(np.float32), a,
                 (a + 2) % 6, np.zeros(20),
                 query_id=20_000 + 20 * i + np.arange(20))
        dbuf.commit(r.global_ratings)
    assert r.db.capacity == 512
    st = disp.cache_stats()
    assert st["misses"] == st["warmed"] == graphs.capture_count() - c0


def test_route_graph_launches_are_credited_on_replay(dev):
    from repro_torch.core.dispatch import RouteDispatcher
    r, rng = _graph_router(dev, seed=2)
    disp = RouteDispatcher.for_router(r)
    st = r.state
    assert disp.warmup(st, [8]) == 1
    (entry,) = disp._cache.entries.values()
    assert entry.step.launches == {("similarity", None): 1,
                                   ("elo_scan_select", None): 1}
    _build.reset_launches()
    for _ in range(3):
        disp.route(st, rng.normal(size=(5, 64)).astype(np.float32), 4.0)
    assert _build.launch_counts() == {"similarity": 3, "elo_scan": 0,
                                      "elo_scan_select": 3,
                                      "flash_attention": 0,
                                      "decode_attention": 0}


def test_serving_engine_warms_a_grown_replica(dev):
    """A warmed ServingEngine whose feedback grows the DB on the card:
    each commit that makes a grown replica warms it, so no route
    captures, and the process captured only what the warmups did."""
    from repro_torch import graphs
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import FleetModel, Request, ServingEngine
    r, rng = _graph_router(dev, n_prompts=250)
    assert (r.db.capacity, r.db.size) == (256, 250)
    names = r.model_names
    fleet = {n: FleetModel(get_reduced_config("olmo-1b"), seed=i,
                           max_len=32, device=dev)
             for i, n in enumerate(names)}
    c0 = graphs.capture_count()
    engine = ServingEngine(fleet, r, compare_rate=1.0, seed=0,
                           quality_oracle=lambda e, m: float(m % 3),
                           warmup_batch_sizes=[16])
    for i in range(6):
        engine.serve([Request(tokens=rng.integers(0, 100, 6).astype(
            np.int32), embedding=rng.normal(size=64).astype(np.float32),
            budget=8.0, max_new_tokens=2, rid=16 * i + j)
            for j in range(16)])
    assert r.db.capacity == 512
    st = engine.dispatch.cache_stats()
    decode = sum(m.cache_stats()["misses"] for m in fleet.values())
    assert st["misses"] == st["warmed"] == 4 and st["hits"] == 6
    assert graphs.capture_count() - c0 == st["misses"] + decode


def _full_width(arch, n_layers=2):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=n_layers,
                               n_enc_layers=min(cfg.n_enc_layers, n_layers))


def _eager_tokens(m, toks, max_new):
    """Greedy tokens through the eager prefill and decode_step (an int
    position, a fresh cache), the path the graph was captured from."""
    from repro_torch.models import transformer as T
    t = torch.tensor(toks, dtype=torch.int64, device=m.device)
    enc = None
    if m.cfg.arch_type == "encdec":
        enc = torch.zeros((t.shape[0], m.cfg.n_audio_frames,
                           m.cfg.d_model), device=m.device)
    with torch.inference_mode():
        logits, cache = T.prefill(m.cfg, m.params, t, m.max_len,
                                  cache_dtype=torch.float32, enc_embeds=enc)
        tok = logits.argmax(-1)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = T.decode_step(m.cfg, m.params, cache, tok,
                                          toks.shape[1] + i)
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1).int().cpu().numpy()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "olmo-1b",
                                  "mamba2-780m", "qwen3-8b"])
def test_captured_decode_tokens_equal_eager(dev, arch):
    """The launcher fleet's models at full width and two layers, bf16:
    generate through the captured decode graphs gives the eager path's
    greedy tokens, at each warmed row count, with its launches credited
    per replay and nothing captured after warmup."""
    from repro_torch.serving import FleetModel
    cfg = _full_width(arch)
    m = FleetModel(cfg, seed=3, max_len=320, device=dev)
    assert m.warmup([1, 2, 4]) == 3 and m.rows == 4
    rng = np.random.default_rng(4)
    s = 256     # a multiple of mamba2's SSD chunk
    per_step = 0 if cfg.arch_type == "ssm" else \
        cfg.n_layers * (2 if cfg.arch_type == "encdec" else 1)
    for b in (4, 1, 2):
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        want = _eager_tokens(m, toks, 8)
        _build.reset_launches()
        got = m.generate(toks, 8)
        assert _build.launch_counts()["decode_attention"] == 7 * per_step
        np.testing.assert_array_equal(got, want)
    st = m.cache_stats()
    assert st["misses"] == st["warmed"] == 3 and st["hits"] == 3


def test_failed_capture_raises(dev):
    """A step that reads a device value on the host cannot be captured:
    the capture raises, and nothing falls back to running eagerly. In a
    process of its own, as a failed capture leaves PyTorch's capture
    stream behind."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    script = (
        "import torch\n"
        "from repro_torch import graphs\n"
        "x = torch.ones((4,), device='cuda')\n"
        "try:\n"
        "    graphs.Step(lambda t: t.sum().item(), x, device=x.device)\n"
        "except RuntimeError:\n"
        "    print('raised', graphs.capture_count())\n"
        "else:\n"
        "    print('captured')\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.stdout.split() == ["raised", "0"], out.stdout + out.stderr


# ---------------------------------------------------------------------------
# the paper's baselines and experiments
# ---------------------------------------------------------------------------

def _frozen_regime():
    """benchmarks_torch.common's regime at seed 0 (300 prompts per
    dataset, D = 64): the corpus and the online win-rate targets."""
    from repro_torch.data.routerbench import (make_corpus, pairwise_feedback,
                                              winrate_targets)
    corpus = make_corpus(seed=0, n_per_dataset=300, dim=64)
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=8)
    return corpus, fb, winrate_targets(fb, corpus.n_models)


def test_knn_kernel_matches_reference_backend(dev):
    """KNN at its Fig. 2 shape (Q = 90 test rows of a dataset, C = 1470
    win-rate rows, D = 64, top-40): the kernel's scores within SIM_TOL of
    the plain backend's, neighbours equal except at near-ties, the
    predictions within 1e-6 where the neighbours agree."""
    corpus, _, (emb, tgt, mask) = _frozen_regime()
    from repro_torch.routing.baselines import KNNRouter
    got_r = KNNRouter(corpus.costs, device=dev)
    want_r = KNNRouter(corpus.costs, backend="reference", device=dev)
    for r in (got_r, want_r):
        r.fit(emb, tgt, mask)
    assert got_r.emb.shape == (1470, 64)
    test = corpus.test_idx[corpus.dataset_id[corpus.test_idx] == 0]
    q = torch.tensor(corpus.embeddings[test], device=dev)
    assert 80 <= q.shape[0] <= 100
    _build.reset_launches()
    gs, gi = KOPS.similarity_topk(q, got_r.emb, 40)
    assert _build.launch_counts()["similarity"] == 1
    ws, wi = KOPS.similarity_topk(q, want_r.emb, 40, backend="reference")
    torch.testing.assert_close(gs, ws, rtol=SIM_TOL, atol=SIM_TOL)
    panel = ref.similarity_ref(q, want_r.emb)
    best = ref.stable_topk(panel, 41)[0]
    tied = ((best[:, :-1] - best[:, 1:]).abs() < SIM_TOL).any(dim=1)
    same = (gi == wi).all(dim=1)
    assert bool((same | tied).all())
    torch.testing.assert_close(got_r.predict(q)[same],
                               want_r.predict(q)[same], rtol=0, atol=1e-6)


def test_evaluate_router_takes_eagle_route_on_the_card(dev):
    """`evaluate_router` over `EagleRouter.route`, which returns a device
    tensor, gives the curve of the host choices it was given."""
    from repro_torch.core.router import EagleConfig, EagleRouter
    from repro_torch.data.routerbench import evaluate_router
    corpus, fb, _ = _frozen_regime()
    r = EagleRouter(corpus.model_names, corpus.costs,
                    EagleConfig(embed_dim=64), db_capacity=4096, device=dev)
    r.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
          query_id=fb["query_idx"])
    assert r.route(corpus.embeddings[:3], 5.0).is_cuda
    got = evaluate_router(lambda e, b: r.route(e, b), corpus, dataset=2)
    want = evaluate_router(lambda e, b: r.route(e, b).cpu().numpy(),
                           corpus, dataset=2)
    np.testing.assert_array_equal(got["quality"], want["quality"])
    assert got["auc"] == want["auc"] and 0 < got["auc"] < 1


@pytest.mark.parametrize("name", ["mlp", "svm"])
def test_captured_fit_equals_eager_fit(dev, name):
    """A fit through the captured step takes exactly `epochs` steps from
    the initial weights (the capture's eager warm-up step is undone):
    its parameters and losses equal an eager TrainStep loop's on the
    card within 1e-6; its first fit captured one graph, a second fit of
    the same shape captures none and gives the same parameters."""
    from repro_torch import graphs
    from repro_torch.routing.baselines import MLPRouter, SVMRouter, TrainStep
    corpus, _, (emb, tgt, mask) = _frozen_regime()
    cls = MLPRouter if name == "mlp" else SVMRouter
    r = cls(corpus.costs, epochs=50, device=dev)
    c0 = graphs.capture_count()
    r.fit(emb, tgt, mask)
    assert graphs.capture_count() - c0 == 1
    x, y, mk = (r._f32(a) for a in (emb, tgt, mask))
    init = r._init(x.shape[1], y.shape[1])
    eager = TrainStep(r, x, y, init).load(x, y, mk, init)
    for _ in range(50):
        eager()
    torch.cuda.synchronize()
    assert int(eager.state["step"]) == int(r._steps.entries[
        (1470, 64, 10)][0].state["step"]) == 50
    for k, v in eager.params.items():
        torch.testing.assert_close(r.params[k].detach(), v.detach(),
                                   rtol=0, atol=1e-6)
    torch.testing.assert_close(r.losses, eager.losses, rtol=0, atol=1e-6)
    first = {k: v.detach().clone() for k, v in r.params.items()}
    c1 = graphs.capture_count()
    r.fit(emb, tgt, mask)
    assert graphs.capture_count() == c1
    st = r.cache_stats()
    assert (st["hits"], st["misses"]) == (1, 1)
    for k, v in first.items():
        torch.testing.assert_close(r.params[k].detach(), v, rtol=0, atol=0)
