"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: without a CUDA device every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from functools import partial

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
from repro_torch.kernels import retrieve_topn as RT
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
    out = similarity_cuda(q, db, tile=tile)
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
    RT.topn_cuda(x, x, None, 2)
    KOPS.similarity_topk(x, x, 2, backend="reference")
    assert _build.launch_counts() == {"similarity": 1, "elo_scan": 1,
                                      "elo_scan_select": 0,
                                      "flash_attention": 1,
                                      "decode_attention": 1,
                                      "retrieve_topn": 1, "topn_merge": 1}


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
                                           (128, True), (0, False),
                                           # a key tile that holds no key
                                           # of one consumer's 64 rows
                                           (64, True), (65, True)])
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
                                         (1, 1000, 16, 2, 128),
                                         # the consumers' turns: one work
                                         # item, fewer items than SMs
                                         (1, 100, 1, 1, 128),
                                         (2, 256, 4, 2, 64),
                                         # items of one and of two key
                                         # tiles (128 keys; 64 at 256)
                                         (1, 128, 4, 1, 128),
                                         (1, 256, 4, 1, 128),
                                         (1, 64, 2, 1, 256),
                                         (1, 128, 2, 1, 256),
                                         # S = 1, 127, 129 at each width
                                         (2, 1, 4, 2, 32),
                                         (2, 127, 4, 2, 32),
                                         (2, 129, 4, 2, 64),
                                         (2, 1, 4, 2, 112),
                                         (2, 127, 4, 4, 112),
                                         (2, 129, 4, 2, 112),
                                         (2, 127, 4, 2, 128),
                                         (2, 1, 4, 2, 256),
                                         (2, 127, 4, 2, 256),
                                         (2, 129, 4, 2, 256)])
def test_flash_attention_bf16_tile_edges(dev, b, s, h, hk, dh):
    """The tensor-core kernel's 128-row tiles: S below one tile, S one
    past a tile and S not a multiple of it (TMA zero-fills the rows past
    S, and their scores are masked), with 8 query heads to a KV head; the
    two consumers' turns at the tensor cores with one work item, fewer
    items than SMs, and items of one key tile (no tile-ahead product) and
    of two. The blocks draw their items from two counters, which the
    last block resets: they are 0 again after the call."""
    from repro_torch.kernels import flash_attention as FA
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
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    assert int(FA._SCHED[idx].count_nonzero()) == 0


@pytest.mark.parametrize("b,t,h,hk,dh", [(2, 512, 4, 4, 64),
                                         (3, 1000, 32, 8, 128),
                                         (4, 77, 8, 1, 32),
                                         (2, 300, 16, 2, 128),
                                         (3, 1056, 16, 16, 128),
                                         # internlm2-20b's 48 / 8 (rep 6)
                                         (2, 700, 48, 8, 128)])
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


# the decode kernel's edges, (B, T, H, Hk, dh): lengths at 1, at a stage
# boundary +-1 and at a split boundary +-1 of the wrapper's plan, and a
# cache shorter than one stage
DECODE_EDGES = [(3, 2048, 32, 8, 128), (3, 1056, 20, 20, 64),
                (3, 1500, 8, 1, 32), (3, 20, 16, 4, 128)]


@pytest.mark.parametrize("b,t,h,hk,dh", DECODE_EDGES)
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_decode_attention_edge_lengths(dev, b, t, h, hk, dh, q_dtype,
                                       kv_dtype):
    from repro_torch.kernels import decode_attention as DA
    rng = np.random.default_rng(t + dh)
    q = _normal(rng, (b, h, dh), q_dtype, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    size = torch.finfo(kv_dtype).bits // 8
    stage = DA.stage_rows(dh, size)
    _, split = DA.split_plan(b, t, hk, dh, size, DA._sm_count(dev))
    lens = sorted({min(max(x, 1), t) for x in
                   (1, stage - 1, stage, stage + 1, split - 1, split,
                    split + 1, t)})
    lens += [t] * (-len(lens) % b)
    for i in range(0, len(lens), b):
        kv_len = torch.tensor(lens[i:i + b], dtype=torch.int32, device=dev)
        got = decode_attention_cuda(q, k, v, kv_len)
        want = ref.decode_attention_ref(q, k.to(q_dtype), v.to(q_dtype),
                                        kv_len)
        torch.cuda.synchronize()
        tol = ATT_TOL[q_dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b,t,h,hk,dh,kv_dtype", [
    (16, 1056, 32, 8, 128, torch.float32),
    (8, 4096, 8, 8, 128, torch.bfloat16)])
def test_decode_attention_graph_replays_equal_eager(dev, b, t, h, hk, dh,
                                                    kv_dtype):
    """One captured graph of the kernel, replayed 3 times into a zeroed
    output, equals the eager call bit for bit, and the arrival counters
    are zero after each replay: the last split of a (b, KV head) resets
    its counter (else a replay merges too early or never)."""
    from repro_torch.kernels import decode_attention as DA
    rng = np.random.default_rng(t)
    q = _normal(rng, (b, h, dh), torch.bfloat16, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    kv_len = torch.tensor(rng.integers(1, t + 1, b), dtype=torch.int32,
                          device=dev)
    eager = decode_attention_cuda(q, k, v, kv_len)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_cuda(q, k, v, kv_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_cuda(q, k, v, kv_len)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        assert all(int(x.count_nonzero()) == 0 for x in DA._ARRIVALS[idx])


# gemma3-12b's head width (dh = 256) on both flash routes, with and
# without its sliding window (window 1: a row's own key alone)
@pytest.mark.parametrize("window", [0, 1, 64, 100, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dh256_matches_plain(dev, window, dtype):
    """dh = 256: the tensor-core route's 64-key tiles and the CUDA-core
    route's 213 KB of tiles, at gemma3's 2 query heads a KV head, S past
    the window and not a multiple of a tile; the JAX suite's bars."""
    rng = np.random.default_rng(window + 256)
    b, s, h, hk, dh = 2, 1100, 4, 2, 256
    q = _normal(rng, (b, s, h, dh), dtype, dev)
    k = _normal(rng, (b, s, hk, dh), dtype, dev)
    v = _normal(rng, (b, s, hk, dh), dtype, dev)
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    if window == 1:
        torch.testing.assert_close(got, v.repeat_interleave(h // hk, dim=2),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [0, 1, 100, 1024])
@pytest.mark.parametrize("rep", [2, 6, 8])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("lens", ["window", "stage edges"])
def test_decode_attention_dh256_and_windows(dev, window, rep, q_dtype,
                                            kv_dtype, lens):
    """dh = 256 over both cache types at rep 2 (gemma3: the tensor-core
    route for a bf16 query), 6 and 8, with a window below kv_len, equal
    to it and far above it, and a row whose window starts past the end of
    its first splits (those splits exit; the merge takes the rest); and
    lengths across a stage's edges (16 rows over an fp32 cache, 32 over
    a bf16 one: every warp takes the whole stage there), 0 giving zeros."""
    from repro_torch.kernels import decode_attention as DA
    rng = np.random.default_rng(window + rep)
    b, t, hk, dh = 4, 1056, 2, 256
    size = torch.finfo(kv_dtype).bits // 8
    n_split, split = DA.split_plan(b, t, hk, dh, size, DA._sm_count(dev))
    assert n_split >= 4
    w = window or 100
    kv = ([max(w // 2, 1), min(w, t), t, 3 * split + 5] if lens == "window"
          else [0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33])
    b = len(kv)
    h = rep * hk
    q = _normal(rng, (b, h, dh), q_dtype, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
    got = decode_attention_cuda(q, k, v, kv_len, window=window)
    want = ref.decode_attention_ref(q, k.to(q_dtype), v.to(q_dtype), kv_len,
                                    window=window)
    torch.cuda.synchronize()
    empty = kv_len == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    tol = ATT_TOL[q_dtype]
    torch.testing.assert_close(got[~empty].float(), want[~empty].float(),
                               rtol=tol, atol=tol)
    if window == 1:     # the newest row alone: its v, exactly
        rows = (kv_len.long() - 1).clamp(min=0)
        newest = v.to(q_dtype)[torch.arange(b, device=dev), rows]
        torch.testing.assert_close(
            got[~empty], newest.repeat_interleave(rep, dim=1)[~empty],
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,t,h,hk,dh,kv_dtype,window", [
    (16, 1056, 16, 8, 256, torch.float32, 1024),
    (8, 4096, 8, 8, 128, torch.bfloat16, 1024),
    (4, 1056, 12, 2, 256, torch.bfloat16, 37),
    # dh = 256 at rep 8 over both caches, and gemma3's ring (every slot)
    (4, 1056, 16, 2, 256, torch.bfloat16, 0),
    (4, 1056, 16, 2, 256, torch.float32, 100),
    (16, 1024, 16, 8, 256, torch.float32, 0)])
def test_decode_attention_windowed_graph_replays_equal_eager(
        dev, b, t, h, hk, dh, kv_dtype, window):
    """A windowed call captured once: three replays into a zeroed output
    equal the eager call bit for bit, the arrival counters back at 0 after
    each (only the splits in each row's window count there), and a replay
    after kv_len moves follows it (each row's first key is computed on
    the device)."""
    from repro_torch.kernels import decode_attention as DA
    rng = np.random.default_rng(t + dh)
    q = _normal(rng, (b, h, dh), torch.bfloat16, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    kv_len = torch.tensor(rng.integers(1, t + 1, b), dtype=torch.int32,
                          device=dev)
    eager = decode_attention_cuda(q, k, v, kv_len, window=window)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_cuda(q, k, v, kv_len, window=window)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_cuda(q, k, v, kv_len, window=window)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert all(int(x.count_nonzero()) == 0 for x in DA._ARRIVALS[idx])
    kv_len.copy_(torch.tensor(rng.integers(1, t + 1, b), dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, decode_attention_cuda(q, k, v, kv_len,
                                                  window=window))
    assert all(int(x.count_nonzero()) == 0 for x in DA._ARRIVALS[idx])


# zamba2-7b's head width (dh = 112: staged 128 wide, TMA's zero fill on
# the tensor cores) and deepseek-v3's MLA prefill (query/key 192, value
# 128), on both flash routes, causal and not, S ragged against the tiles
@pytest.mark.parametrize("dk,dv,h,hk", [(112, 112, 8, 8), (112, 112, 8, 2),
                                        (192, 128, 4, 4)])
@pytest.mark.parametrize("s,causal", [(333, True), (1000, True),
                                      (77, False), (1, True), (127, True),
                                      (129, True), (1500, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dh112_and_value_width(dev, dk, dv, h, hk, s, causal,
                                               dtype):
    rng = np.random.default_rng(s + dk + dv + h // hk)
    b = 2
    t = s if causal else 150
    q = _normal(rng, (b, s, h, dk), dtype, dev)
    k = _normal(rng, (b, t, hk, dk), dtype, dev)
    v = _normal(rng, (b, t, hk, dv), dtype, dev)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (b, s, h, dv) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_decode_attention_dh112_edge_lengths(dev, rep, q_dtype, kv_dtype):
    """dh = 112 at rep 1 (zamba2-7b: the CUDA-core route) and rep 4 (a
    bf16 query takes the tensor-core route there), lengths at 1, at a
    stage boundary +-1, at a split boundary +-1 of the wrapper's plan and
    the full cache, each against the plain version at the JAX suite's
    bar."""
    from repro_torch.kernels import decode_attention as DA
    rng = np.random.default_rng(112 + rep)
    b, t, hk, dh = 4, 1056, 4, 112
    h = rep * hk
    q = _normal(rng, (b, h, dh), q_dtype, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    size = torch.finfo(kv_dtype).bits // 8
    stage = DA.stage_rows(dh, size)
    assert stage == DA.stage_rows(128, size)
    _, split = DA.split_plan(b, t, hk, dh, size, DA._sm_count(dev))
    lens = sorted({min(max(x, 1), t) for x in
                   (1, stage - 1, stage, stage + 1, split - 1, split,
                    split + 1, t)})
    lens += [t] * (-len(lens) % b)
    for i in range(0, len(lens), b):
        kv_len = torch.tensor(lens[i:i + b], dtype=torch.int32, device=dev)
        got = decode_attention_cuda(q, k, v, kv_len)
        want = ref.decode_attention_ref(q, k.to(q_dtype), v.to(q_dtype),
                                        kv_len)
        torch.cuda.synchronize()
        assert got.shape == (b, h, dh)
        tol = ATT_TOL[q_dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("h,hk,kv_dtype", [(32, 32, torch.float32),
                                           (16, 4, torch.bfloat16)])
def test_decode_attention_dh112_graph_replays_equal_eager(dev, h, hk,
                                                          kv_dtype):
    """zamba2-7b's self decode (32 heads of 112 over an fp32 cache) and a
    rep-4 layout over a bf16 cache, captured once: three replays equal
    the eager call bit for bit, the arrival counters back at 0."""
    from repro_torch.kernels import decode_attention as DA
    rng = np.random.default_rng(h)
    b, t, dh = 16, 1056, 112
    q = _normal(rng, (b, h, dh), torch.bfloat16, dev)
    k = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    v = _normal(rng, (b, t, hk, dh), kv_dtype, dev)
    kv_len = torch.tensor(rng.integers(1, t + 1, b), dtype=torch.int32,
                          device=dev)
    eager = decode_attention_cuda(q, k, v, kv_len)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_cuda(q, k, v, kv_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_cuda(q, k, v, kv_len)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert all(int(x.count_nonzero()) == 0 for x in DA._ARRIVALS[idx])


def test_attention_kernels_refuse_widths_they_do_not_take(dev):
    """The flash wrapper takes (dh, dh) and (192, 128) only, the decode
    wrapper its HEAD_DIMS; nothing falls back."""
    ones = lambda *shape: torch.ones(shape, device=dev,
                                     dtype=torch.bfloat16)
    for dk, dv in ((192, 192), (128, 64), (112, 128), (96, 96)):
        with pytest.raises(ValueError, match="head width"):
            flash_attention_cuda(ones(1, 64, 2, dk), ones(1, 64, 2, dk),
                                 ones(1, 64, 2, dv))
    lens = torch.ones((1,), dtype=torch.int32, device=dev)
    for dh in (96, 192, 576):
        with pytest.raises(ValueError, match="head width"):
            decode_attention_cuda(ones(1, 2, dh), ones(1, 64, 2, dh),
                                  ones(1, 64, 2, dh), lens)


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

#: reduced configs of the model tests: gemma3 with its 5 local layers and
#: one global, a window that bites at prompts of 130 tokens
REDUCED = {"gemma3-12b": dict(n_layers=6, sliding_window=50)}


def _reduced_model(dev, arch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import FleetModel
    return FleetModel(get_reduced_config(arch, dtype="float32",
                                         **REDUCED.get(arch, {})),
                      seed=0, max_len=160, device=dev)


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
    # a window on bidirectional attention: the JAX model sets none there
    with pytest.raises(NotImplementedError, match="window"):
        L.apply_attention(cfg, p, x, pos, theta=cfg.rope_theta, window=2,
                          causal=False)
    # the same call runs the plain attend when asked for it
    L.apply_attention(cfg, p, x, pos, theta=cfg.rope_theta, window=2,
                      causal=False, backend="reference")
    # a causal window runs through the kernels: a prefill through the
    # flash kernel, a decode through the decode kernel, each equal to the
    # plain path (the JAX suite's fp32 bar)
    plain = {k: v.clone() for k, v in cache.items()}
    x = torch.randn((2, 11, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    pos = torch.arange(11, device=dev).expand(2, 11)
    for lo, hi in ((0, 10), (10, 11)):
        _build.reset_launches()
        got = L.apply_attention(cfg, p, x[:, lo:hi], pos[:, lo:hi],
                                theta=cfg.rope_theta, window=3, cache=cache,
                                cache_index=lo)
        counts = _build.launch_counts()
        assert (counts["flash_attention"], counts["decode_attention"]) == \
            ((1, 0) if lo == 0 else (0, 1))
        want = L.apply_attention(cfg, p, x[:, lo:hi], pos[:, lo:hi],
                                 theta=cfg.rope_theta, window=3, cache=plain,
                                 cache_index=lo, backend="reference")
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b",
                                  "phi3.5-moe-42b-a6.6b", "internlm2-20b",
                                  "gemma3-12b", "llava-next-mistral-7b"])
def test_model_kernel_path_matches_plain_attention(dev, arch):
    """A reduced fp32 model (dense, phi3.5-moe's mixture of experts,
    gemma3's windowed local layers, llava's image rows in generate)
    through the kernels and through the plain attend: prefill + 5 decode
    steps fed the same tokens give logits within the fp32 attention bar,
    and FleetModel.generate launches one flash kernel per layer and one
    decode kernel per layer and step."""
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


def _attention_layers(cfg):
    """(flash launches a prefill, decode launches a step) of a model:
    zamba2's shared block once a group; MLA's absorbed decode is plain
    PyTorch, no kernel."""
    from repro_torch.models import transformer as T
    if cfg.arch_type == "ssm":
        return 0, 0
    if cfg.arch_type == "hybrid":
        return T.hybrid_shape(cfg)[0], T.hybrid_shape(cfg)[0]
    n = cfg.n_layers * (2 if cfg.arch_type == "encdec" else 1)
    return n, 0 if cfg.attn_kind == "mla" else n


@pytest.mark.parametrize("arch,layers", [("zamba2-7b", 6),
                                         ("zamba2-7b", 8),
                                         ("deepseek-v3-671b", 2)])
def test_hybrid_and_mla_kernel_path_matches_plain_attention(dev, arch,
                                                            layers):
    """The reduced fp32 zamba2 (with and without a tail) and deepseek
    (MLA: its prefill through the flash kernel at its query/key and
    value widths) through the kernels and through the plain attend:
    prefill + 5 decode steps fed the same tokens within the fp32
    attention bar; FleetModel.generate launches the flash kernel once an
    attention layer (zamba2: once a group) and the decode kernel once an
    attention layer and step (deepseek: none, its absorbed decode is
    plain PyTorch)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import FleetModel
    m = FleetModel(get_reduced_config(arch, dtype="float32",
                                      n_layers=layers),
                   seed=0, max_len=160, device=dev)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, 500, (3, 128)), device=dev)
    runs = {b: T.prefill(m.cfg, m.params, toks, m.max_len, backend=b,
                         cache_dtype=torch.float32)
            for b in ("cuda", "reference")}
    for i in range(6):
        got, want = runs["cuda"][0], runs["reference"][0]
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        tok = want.argmax(-1)[:, None]
        runs = {b: T.decode_step(m.cfg, m.params, runs[b][1], tok, 128 + i,
                                 backend=b) for b in runs}
    m.warmup([3])
    _build.reset_launches()
    m.generate(toks.cpu().numpy(), 6)
    counts = _build.launch_counts()
    flash, decode = _attention_layers(m.cfg)
    assert counts["flash_attention"] == flash
    assert counts["decode_attention"] == decode * 5


# ---------------------------------------------------------------------------
# whisper's attention: bidirectional, cross-attention (Sq != Sk), cross
# decode over 1500 frames; the encdec and ssm models' kernel path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,h,hk,dh", [(2, 11, 1500, 20, 20, 64),
                                           (2, 1024, 1500, 20, 20, 64),
                                           (1, 1500, 1500, 20, 20, 64),
                                           (1, 130, 77, 8, 2, 128),
                                           (3, 1, 300, 4, 4, 32),
                                           (2, 127, 1500, 4, 2, 128),
                                           (2, 129, 1500, 4, 4, 256),
                                           (1, 1500, 1, 4, 2, 112)])
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


def test_stale_padding_graph_routes_equal_eager_routes(dev):
    """A full bucket through the captured graph of each replica of a
    DoubleBuffer, then qb//2 + 1 other rows with budgets at the grid's
    other end through each: the choices and top-n rows equal the
    zero-padded eager route's bit for bit. Past the live rows the pinned
    staging still holds the last full batch (nothing is zero-filled) and
    each graph's query buffer its own replica's full batch (only the live
    rows are copied in). The staged bytes count the live rows alone."""
    from repro_torch import obs as OBS
    from repro_torch.core.dispatch import RouteDispatcher, replica
    from repro_torch.core.state import DoubleBuffer
    r, rng = _graph_router(dev, seed=2)
    dbuf = DoubleBuffer(r.db, r.global_ratings, device=dev)
    disp = RouteDispatcher.for_router(r, obs=OBS.Observability())
    for _ in range(2):            # each replica
        disp.warmup(dbuf.front, batch_sizes=(64, 1024))
        dbuf.commit(r.global_ratings)
    for qb in (64, 1024):
        full = {}
        for _ in range(2):
            q1 = rng.normal(size=(qb, 64)).astype(np.float32)
            full[replica(dbuf.front)] = q1
            disp.route_result(dbuf.front, q1,
                              rng.uniform(8.0, 9.0, qb).astype(np.float32))
            dbuf.commit(r.global_ratings)
        nq = qb // 2 + 1
        for _ in range(2):
            st = dbuf.front
            q2 = rng.normal(size=(nq, 64)).astype(np.float32)
            b2 = rng.uniform(0.5, 1.5, nq).astype(np.float32)
            ch, top = disp.route_result(st, q2, b2)
            want_ch, want_top = _eager_route(disp, st, q2, b2)
            np.testing.assert_array_equal(ch, want_ch)
            np.testing.assert_array_equal(top, want_top)
            q_host = disp._staging[(qb, 64, True)][0]
            np.testing.assert_array_equal(q_host[nq:].numpy(), q1[nq:])
            entry = disp._cache.entries[disp._key(st, qb)]
            np.testing.assert_array_equal(entry.q[nq:].cpu().numpy(),
                                          full[replica(st)][nq:])
            dbuf.commit(r.global_ratings)
        assert len(full) == 2
    assert disp.stats.misses == disp.stats.warmed == 4
    rows = 2 * sum(qb + qb // 2 + 1 for qb in (64, 1024))
    assert disp.telemetry()["staged_bytes"] == rows * (64 + 1) * 4


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
    assert entry.step.launches == {("retrieve_topn", None): 1,
                                   ("topn_merge", None): 1,
                                   ("elo_scan_select", None): 1}
    _build.reset_launches()
    for _ in range(3):
        disp.route(st, rng.normal(size=(5, 64)).astype(np.float32), 4.0)
    assert _build.launch_counts() == {"similarity": 0, "elo_scan": 0,
                                      "elo_scan_select": 3,
                                      "flash_attention": 0,
                                      "decode_attention": 0,
                                      "retrieve_topn": 3, "topn_merge": 3}


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
    """Full width, cut depth; llava's 2,880 image rows cut to 32, so its
    cache stays short."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=n_layers,
                               n_enc_layers=min(cfg.n_enc_layers, n_layers),
                               n_image_tokens=min(cfg.n_image_tokens, 32))


def _eager_tokens(m, toks, max_new):
    """Greedy tokens through the eager prefill and decode_step (an int
    position, a fresh cache), the path the graph was captured from."""
    from repro_torch.models import transformer as T
    t = torch.tensor(toks, dtype=torch.int64, device=m.device)
    enc = img = None
    n_img = m.cfg.n_image_tokens if m.cfg.arch_type == "vlm" else 0
    if m.cfg.arch_type == "encdec":
        enc = torch.zeros((t.shape[0], m.cfg.n_audio_frames,
                           m.cfg.d_model), device=m.device)
    if n_img:
        img = torch.zeros((t.shape[0], n_img, m.cfg.d_model),
                          device=m.device)
    with torch.inference_mode():
        logits, cache = T.prefill(m.cfg, m.params, t, m.max_len,
                                  cache_dtype=torch.float32, enc_embeds=enc,
                                  img_embeds=img)
        tok = logits.argmax(-1)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = T.decode_step(m.cfg, m.params, cache, tok,
                                          n_img + toks.shape[1] + i)
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1).int().cpu().numpy()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "olmo-1b",
                                  "mamba2-780m", "qwen3-8b",
                                  "phi3.5-moe-42b-a6.6b", "internlm2-20b",
                                  "gemma3-12b", "llava-next-mistral-7b",
                                  "zamba2-7b", "deepseek-v3-671b"])
def test_captured_decode_tokens_equal_eager(dev, arch):
    """The launcher fleet's models (`--fleet 10`) at full width and two
    layers (gemma3 six: five local, one global; zamba2 eight: a group of
    five mamba2 blocks and the shared block, a tail of two; deepseek one
    dense layer and one MoE layer of its 256 experts), bf16: generate
    through the captured decode graphs gives the
    eager path's greedy tokens, at each warmed row count, with its
    launches credited per replay and nothing captured after warmup (the
    MoE's routing, slots and combine, the mamba2 states and MLA's
    absorbed decode run inside the graph)."""
    import dataclasses
    from repro_torch.serving import FleetModel
    cfg = _full_width(arch, {"gemma3-12b": 6, "zamba2-7b": 8}.get(arch, 2))
    if cfg.attn_kind == "mla":
        cfg = dataclasses.replace(cfg, first_k_dense=1)
    m = FleetModel(cfg, seed=3, max_len=320, device=dev)
    assert m.warmup([1, 2, 4]) == 3 and m.rows == 4
    rng = np.random.default_rng(4)
    s = 256     # a multiple of mamba2's SSD chunk
    per_step = _attention_layers(cfg)[1]
    for b in (4, 1, 2):
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        want = _eager_tokens(m, toks, 8)
        _build.reset_launches()
        got = m.generate(toks, 8)
        assert _build.launch_counts()["decode_attention"] == 7 * per_step
        np.testing.assert_array_equal(got, want)
    st = m.cache_stats()
    assert st["misses"] == st["warmed"] == 3 and st["hits"] == 3


@pytest.mark.parametrize("s,steps", [(100, 6), (30, 25)])
def test_ring_kernel_path_matches_plain_attention(dev, s, steps):
    """gemma3's ring caches (window_cache) on the card: the reduced fp32
    gemma3 of 6 layers (5 local, 1 global) with a window of 50, a
    prefill of two rings (100 rows: the flash kernel over the in-flight
    keys, with the window) or of part of one (30 rows), then decode
    steps past a wrap through the decode kernel over the 50 slots
    (kv_len = min(index + 1, 50), no window): logits within the fp32
    attention bar of the plain attend over the rings' positions, the
    rings equal; FleetModel.generate launches one flash kernel a layer
    and one decode kernel a layer and step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import FleetModel
    m = FleetModel(get_reduced_config("gemma3-12b", dtype="float32",
                                      window_cache=True,
                                      **REDUCED["gemma3-12b"]),
                   seed=0, max_len=160, device=dev)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, 500, (3, s)), device=dev)
    runs = {b: T.prefill(m.cfg, m.params, toks, m.max_len, backend=b,
                         cache_dtype=torch.float32)
            for b in ("cuda", "reference")}
    assert tuple(runs["cuda"][1]["kv_local"]["k"].shape[:3]) == (5, 3, 50)
    for i in range(steps + 1):
        got, want = runs["cuda"][0], runs["reference"][0]
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        tok = want.argmax(-1)[:, None]
        runs = {b: T.decode_step(m.cfg, m.params, runs[b][1], tok, s + i,
                                 backend=b) for b in runs}
    rings = [runs[b][1]["kv_local"] for b in ("cuda", "reference")]
    assert torch.equal(rings[0]["pos"], rings[1]["pos"])
    torch.testing.assert_close(rings[0]["k"], rings[1]["k"], rtol=2e-3,
                               atol=2e-3)
    m.warmup([3])
    _build.reset_launches()
    m.generate(toks.cpu().numpy(), steps)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == m.cfg.n_layers
    assert counts["decode_attention"] == m.cfg.n_layers * (steps - 1)


def test_ring_captured_decode_tokens_equal_eager(dev):
    """gemma3 at full width, six layers (five local, one global), bf16,
    with ring caches of 128 slots (its window cut from 1,024 so the ring
    wraps inside a cache of 320 rows): generate through the captured
    decode graphs gives the eager path's greedy tokens at each warmed
    row count, past the wrap (prompts of 256 rows, two rings; slot 0
    takes position 256), with the launches credited per replay and
    nothing captured after warmup."""
    import dataclasses
    from repro_torch.serving import FleetModel
    cfg = dataclasses.replace(_full_width("gemma3-12b", 6),
                              sliding_window=128, window_cache=True)
    m = FleetModel(cfg, seed=3, max_len=320, device=dev)
    assert m.warmup([1, 2, 4]) == 3 and m.rows == 4
    assert tuple(m._cache["kv_local"]["k"].shape[:3]) == (5, 4, 128)
    rng = np.random.default_rng(4)
    for b in (4, 1, 2):
        toks = rng.integers(0, cfg.vocab, (b, 256)).astype(np.int32)
        want = _eager_tokens(m, toks, 8)
        _build.reset_launches()
        got = m.generate(toks, 8)
        assert _build.launch_counts()["decode_attention"] == 7 * 6
        np.testing.assert_array_equal(got, want)
    st = m.cache_stats()
    assert st["misses"] == st["warmed"] == 3 and st["hits"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,cf", [(3, 7, 1.25), (8, 1024, 1.25),
                                    (8, 1, 1.25), (2, 50, 0.5)])
def test_apply_moe_on_cuda_matches_cpu(dev, dtype, b, s, cf):
    """The MoE FFN of the reduced phi3.5-moe on CUDA tensors against the
    same inputs on the CPU: the same experts and the same pairs dropped,
    y within 1e-4 in fp32 (TF32 off) and within 2^-5 of the largest |y|
    in bf16 (tests/test_torch_moe_parity.py's bar against JAX), aux
    within 1e-5."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import moe as MOE
    torch.backends.cuda.matmul.allow_tf32 = False
    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = get_reduced_config("phi3.5-moe-42b-a6.6b", dtype=name,
                             capacity_factor=cf)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32)
    p = {k: v if k == "router" else v.to(dtype) for k, v in p.items()}
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    want, aux_want = MOE.apply_moe(cfg, p, x)
    got, aux = MOE.apply_moe(cfg, {k: v.to(dev) for k, v in p.items()},
                             x.to(dev))
    dp_cpu = MOE.dispatch(cfg, p["router"], x.reshape(b * s, -1))
    dp_gpu = MOE.dispatch(cfg, p["router"].to(dev),
                          x.to(dev).reshape(b * s, -1))
    torch.cuda.synchronize()
    assert torch.equal(dp_gpu.top_e.cpu(), dp_cpu.top_e)
    assert torch.equal(dp_gpu.keep.cpu(), dp_cpu.keep)
    if cf < 1:
        assert int((~dp_cpu.keep).sum()) > 0
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    else:
        bar = 2.0 ** -5 * float(want.float().abs().max())
        assert float((got.cpu().float() - want.float()).abs().max()) <= bar
    torch.testing.assert_close(aux.cpu(), aux_want, rtol=1e-5, atol=1e-5)


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


def test_capture_survives_a_collection_of_dead_graphs(dev):
    """A graph kept alive only by a reference cycle becomes garbage in the
    middle of a capture, which then makes enough surviving objects for a
    full collection to come due (the thresholds at (100, 1, 1)): no
    collection runs while the stream captures (one would destroy the
    dead graph, which a capturing stream does not permit, and invalidate
    the capture). In a process of its own, as a failed capture leaves
    PyTorch's capture stream behind."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    script = (
        "import gc, torch\n"
        "from repro_torch import graphs\n"
        "x = torch.ones((64,), device='cuda')\n"
        "def dead():\n"
        "    d = {'step': graphs.Step(lambda t: t * 2, x, device=x.device)}\n"
        "    d['self'] = d\n"
        "    return d\n"
        "box, keep = [dead(), dead()], []\n"
        "def fn(t):\n"
        "    box.pop()       # the warm-up run's, then the capture's\n"
        "    # survivors enough for a full collection to come due\n"
        "    keep.extend([[] for _ in range(len(gc.get_objects()))])\n"
        "    return t + 200\n"
        "gc.set_threshold(100, 1, 1)\n"
        "step = graphs.Step(fn, x, device=x.device)\n"
        "print('captured', float(step(x)[0]))\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.stdout.split() == ["captured", "201.0"], \
        out.stdout + out.stderr[-3000:]


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
    counts = _build.launch_counts()
    assert counts["retrieve_topn"] == counts["topn_merge"] == 1
    assert counts["similarity"] == 0
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


# ---------------------------------------------------------------------------
# the capacity-sharded route, its commit and the capacity prebaker
# ---------------------------------------------------------------------------

def _tie_router(dev, dim, capacity, n_prompts, shards, seed=0):
    """A router whose DB has duplicate embeddings on the row pairs that
    straddle every boundary of `shards`' contiguous split (equal scores
    across shards), and the queries that land exactly on them."""
    from repro_torch.core.router import EagleConfig, EagleRouter
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n_prompts, dim)).astype(np.float32)
    ties = [c * capacity // s for s in shards for c in range(1, s)
            if c * capacity // s < n_prompts]
    for row in ties:
        emb[row] = emb[row - 1]
    r = EagleRouter([f"m{i}" for i in range(6)], np.linspace(1.0, 8.0, 6),
                    EagleConfig(embed_dim=dim), db_capacity=capacity,
                    device=dev)
    a = rng.integers(0, 6, n_prompts * 4)
    r.fit(np.repeat(emb, 4, axis=0), a,
          (a + 1 + rng.integers(0, 5, a.size)) % 6,
          rng.choice([0.0, 0.5, 1.0], a.size),
          query_id=np.arange(a.size) // 4)
    return r, rng, emb[[row - 1 for row in ties]]


@pytest.mark.parametrize("dim,capacity,n_prompts", [(64, 256, 200),
                                                    (1536, 4096, 3000)])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("mode", ["combined", "global", "local"])
def test_sharded_route_bit_equal_to_unsharded(dev, dim, capacity, n_prompts,
                                              shards, mode):
    """Through the route graphs, at buckets 8, 64 and 1024 (ragged sizes),
    the tie queries first: choices and topk_idx of the sharded route equal
    the unsharded route's bit for bit; each shard's similarity panel
    equals its columns of the unsharded kernel's panel bit for bit (at
    C/S = 64, not a multiple of the kernel's 128-column block, too), and
    lies within SIM_TOL of the plain version; a dead shard (every row past
    size) ties at -inf like the unsharded tail."""
    from repro_torch.core.dispatch import RouteDispatcher
    from repro_torch.core.state import shard_state
    from repro_torch.launch.mesh import make_db_mesh
    r, rng, tie_q = _tie_router(dev, dim, capacity, n_prompts, [shards])
    mesh = make_db_mesh(shards, [dev] * shards)
    st = r.state
    sst = shard_state(st, mesh)
    r.mode = mode
    base = RouteDispatcher.for_router(r)
    disp = RouteDispatcher.for_router(r, mesh=mesh)
    q = rng.normal(size=(1024, dim)).astype(np.float32)
    q[:len(tie_q)] = tie_q
    for c, emb in enumerate(sst.emb):
        panel = similarity_cuda(torch.tensor(q, device=dev), emb)
        lo = c * sst.shard_rows
        full = similarity_cuda(torch.tensor(q, device=dev), st.emb)
        assert torch.equal(panel, full[:, lo:lo + sst.shard_rows])
        torch.testing.assert_close(panel, ref.similarity_ref(
            torch.tensor(q, device=dev), emb), rtol=SIM_TOL, atol=SIM_TOL)
    for qb in (8, 64, 1024):
        for nq in (qb, qb // 2 + 1):
            b = rng.uniform(0.5, 9.0, nq).astype(np.float32)
            ch, top = disp.route_result(sst, q[:nq], b)
            want_ch, want_top = base.route_result(st, q[:nq], b)
            np.testing.assert_array_equal(ch, want_ch)
            np.testing.assert_array_equal(top, want_top)


def test_sharded_commit_in_place_equals_unsharded(dev):
    """Appends and touches of rows in every shard, committed over a
    4-shard mesh on the card: each shard written in place (its tensors
    keep their addresses), their concatenation equal to the unsharded
    commit's field for field, the ratings and size on the device."""
    from repro_torch.core.dispatch import replica
    from repro_torch.core.state import DoubleBuffer
    from repro_torch.launch.mesh import make_db_mesh
    r, rng, _ = _tie_router(dev, 64, 256, 150, [4])
    mesh = make_db_mesh(4, [dev] * 4)
    want = DoubleBuffer(r.db, r.global_ratings, device=dev,
                        tags=("u_a", "u_b"))
    got = DoubleBuffer(r.db, r.global_ratings, mesh=mesh)
    ptrs = [replica(got.front), replica(got._back[0])]
    for i in range(6):
        n = 10
        e = rng.normal(size=(n, 64)).astype(np.float32)
        rows = np.concatenate([rng.integers(0, r.db.size, n // 2),
                               r.db.size + np.arange(n - n // 2)])
        a = rng.integers(0, 6, n)
        # prompt k was fitted under query id k, so its row is k
        r.update(e, a, (a + 1) % 6, np.ones(n), query_id=rows)
        for d in (want, got):
            d.commit(r.global_ratings)
        for w, g in ((want.front, got.front), (want._back[0], got._back[0])):
            for f in ("emb", "model_a", "model_b", "outcome", "valid"):
                assert torch.equal(getattr(w, f), torch.cat(getattr(g, f)))
            assert torch.equal(w.global_ratings, g.global_ratings[0])
            assert int(w.size) == int(g.size[0])
        assert int(got.front.size[-1]) == r.db.size
    assert (r.db.capacity, r.db.rcap) == (256, 8)
    assert {replica(got.front), replica(got._back[0])} == set(ptrs)


@pytest.mark.parametrize("shards", [0, 2])
def test_prebaker_grow_captures_nothing_on_traffic(dev, shards):
    """A warmed dispatcher over a DoubleBuffer (unsharded, or over a
    2-shard mesh on the card) with a CapacityPrebaker polled after each
    commit, routing (each route's choices equal to the eager route's)
    and committing: across the grow 256 -> 512 traffic captures nothing,
    the grown replicas are the prebaked ones (same addresses), the freed
    replicas' graphs are evicted, and every capture of the process is a
    warmup's or the bake's."""
    from repro_torch import graphs
    from repro_torch import obs as OBS
    from repro_torch.core.dispatch import (CapacityPrebaker, RouteDispatcher,
                                           replica)
    from repro_torch.core.state import DoubleBuffer
    from repro_torch.launch.mesh import make_db_mesh
    r, rng = _graph_router(dev, n_prompts=150, seed=3)
    mesh = make_db_mesh(shards, [dev] * shards) if shards else None
    dbuf = DoubleBuffer(r.db, r.global_ratings, device=dev, mesh=mesh)
    disp = RouteDispatcher.for_router(r, max_bucket=64, mesh=mesh)
    pb = CapacityPrebaker(disp, r.db, dbuf=dbuf, obs=OBS.Observability())
    c0 = graphs.capture_count()
    for _ in range(2):
        disp.warmup(dbuf.front)
        dbuf.commit(r.global_ratings)
    warm = disp.cache_stats()["misses"]
    qid = 50_000
    while r.db.capacity == 256 or r.db.size < 300:
        for _ in range(3):
            nq = int(rng.integers(1, 65))
            q = rng.normal(size=(nq, 64)).astype(np.float32)
            b = rng.uniform(0.5, 9.0, nq).astype(np.float32)
            got = disp.route(dbuf.front, q, b)
            want = _eager_route(disp, dbuf.front, q, b)[0] if not shards \
                else _eager_sharded(disp, dbuf.front, q, b)
            np.testing.assert_array_equal(got, want)
        a = rng.integers(0, 6, 8)
        r.update(rng.normal(size=(8, 64)).astype(np.float32), a, (a + 1) % 6,
                 np.ones(8), query_id=qid + np.arange(8))
        qid += 8
        dbuf.commit(r.global_ratings)
        pb.poll()
    assert r.db.capacity == 512 and set(pb.prepared) == {512}
    assert {replica(dbuf.front), replica(dbuf._back[0])} == \
        set(pb.prepared[512])
    st = disp.cache_stats()
    ladder = 4                          # buckets 8..64
    assert st["misses"] == st["warmed"] == warm + 2 * ladder
    assert graphs.capture_count() - c0 == st["misses"]
    assert pb.obs.registry.counter("dispatch_prebake_total").value == 1
    assert st["entries"] == 2 * ladder  # the old replicas' graphs evicted


def _eager_sharded(disp, state, q, b):
    from repro_torch.core.state import route_batch_choices_sharded
    nq, qb = q.shape[0], disp.bucket(q.shape[0])
    qp = torch.zeros((qb, q.shape[1]), device=state.device)
    qp[:nq] = torch.from_numpy(q).to(state.device)
    bp = torch.zeros((qb,), device=state.device)
    bp[:nq] = torch.from_numpy(b).to(state.device)
    res = route_batch_choices_sharded(state, qp, bp, disp.costs, **disp.kw)
    return res.choices[:nq].cpu().numpy()


# ---------------------------------------------------------------------------
# the fused retrieve: retrieve_topn (kernel 1) and topn_merge (kernel 2)
# ---------------------------------------------------------------------------

TIE_CONTROL = ("TOPN_CONTROL_TIE_HIGH",)


def _tie_inputs(dev, nq, c, d, boundaries, seed=0):
    """A DB with row b a copy of row b - 1 at each boundary (equal scores
    on the two sides), queries equal to those rows first."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(c, d)).astype(np.float32)
    rows = [b for b in boundaries if 0 < b < c]
    for b in rows:
        db[b] = db[b - 1]
    q = rng.normal(size=(nq, d)).astype(np.float32)
    k = min(nq, len(rows))
    q[:k] = db[[b - 1 for b in rows[:k]]]
    return (torch.tensor(q, device=dev), torch.tensor(db, device=dev), rng,
            k)


@pytest.mark.parametrize("nq", [1, 8, 9, 32, 33, 64, 65, 1024])
@pytest.mark.parametrize("n", [20, 64, 80])
def test_retrieve_topn_kernel_matches_plain(dev, nq, n):
    """The retrieve at n <= 128 at every tile (streaming at Q <= 8, GEMM
    of 32, 64, 128 rows) over a C large enough that each grid fills the
    card: kernel 1's panel equals the similarity kernel's masked panel at
    the plan's tile bit for bit, the pair's top-n one stable sort of it,
    and its scores lie within SIM_TOL of the plain version's at the rows
    it returns; ties straddle the tiles' boundaries, C is ragged, and rows
    past `size` score -inf."""
    c, d = 17001, 1536
    pl = RT.plan(nq, c, d, n=n)
    assert pl == (RT.tile_for(nq, d), RT.PANEL)
    q, db, _, _ = _tie_inputs(dev, nq, c, d, [1024 * i for i in
                                              range(1, 4)] + [700])
    size = torch.tensor(c - 100, dtype=torch.int32, device=dev)
    panel = RT.retrieve_topn_cuda(q, db, size)
    want = ref.mask_dead(similarity_cuda(q, db, tile=pl.tile), 0, size)
    top_s, top_i, hit = RT.topn_cuda(q, db, size, n)
    want_s, want_i = ref.stable_topk(want, n)
    torch.cuda.synchronize()
    assert torch.equal(panel, want)
    assert torch.equal(top_s, want_s) and torch.equal(top_i, want_i)
    assert bool(hit.all())
    plain = torch.gather(ref.similarity_ref(q, db), 1, top_i)
    torch.testing.assert_close(top_s, plain, rtol=SIM_TOL, atol=SIM_TOL)


@pytest.mark.parametrize("nq", [1, 8, 9, 32, 33, 64, 65, 1024])
@pytest.mark.parametrize("c,n", [(1470, 20), (17001, 129)])
def test_retrieve_panel_kernel_matches_plain(dev, nq, c, n):
    """Kernel 1 (a grid smaller than the card at C = 1470, or n past 128)
    at every tile: the masked panel equals the similarity kernel's at the
    plan's tile bit for bit, rows past `size` at -inf, and the plain panel
    within SIM_TOL; with vector and scalar loads and stores (D = 1536, C
    ragged; D = 50)."""
    for d in (1536, 50):
        pl = RT.plan(nq, c, d, n=n)
        assert pl.route == RT.PANEL and pl.tile == RT.tile_for(nq, d)
        q, db, _, _ = _tie_inputs(dev, nq, c, d, [128, 256, 700])
        size = torch.tensor(c - 100, dtype=torch.int32, device=dev)
        panel = RT.retrieve_topn_cuda(q, db, size, offset=5)
        want = ref.mask_dead(similarity_cuda(q, db, tile=pl.tile), 5, size)
        plain = ref.panel_ref(q, db, size, offset=5)
        torch.cuda.synchronize()
        assert panel.shape == (nq, c)
        assert torch.equal(panel, want)
        assert bool(torch.isinf(panel[:, c - 105:]).all())
        torch.testing.assert_close(panel[:, :c - 105], plain[:, :c - 105],
                                   rtol=SIM_TOL, atol=SIM_TOL)


@pytest.mark.parametrize("p,k,r", [(640, 20, 8), (5120, 20, 8), (60, 57, 3),
                                   (128, 64, 16), (1280, 128, 8)])
def test_topn_merge_kernel_matches_plain(dev, p, k, r):
    """Kernel 2's select at k <= 128 over pools of explicit rows (the
    cross-shard merge's form) of few distinct scores (ties, -inf, empty
    slots): the top k, the hit mask and both payload routes (carried by
    position into the replay's layout; by row from a shard's panels in
    rank order, the same scores read as a panel) equal the plain
    version's exactly."""
    rng = np.random.default_rng(p + k)
    nq, c = 37, 4 * p
    vals = np.asarray([-np.inf, -1.0, 0.0, 0.5, 1.0], np.float32)
    pool_s = torch.tensor(rng.choice(vals, (nq, p)), device=dev)
    rows = np.stack([rng.permutation(c)[:p] for _ in range(nq)])
    pool_i = torch.tensor(rows, dtype=torch.int32, device=dev)
    pool_i[:, -3:] = ref.EMPTY_ROW              # unfilled slots
    pool_s[:, -3:] = float("-inf")
    panels = (torch.tensor(rng.integers(0, 10, (c, r)), dtype=torch.int32,
                           device=dev),
              torch.tensor(rng.integers(0, 10, (c, r)), dtype=torch.int32,
                           device=dev),
              torch.tensor(rng.random((c, r)), dtype=torch.float32,
                           device=dev),
              torch.tensor(rng.random((c, r)) < 0.5, device=dev))
    got = RT.topn_merge_cuda(pool_s, pool_i, k)
    want = ref.topn_merge_ref(pool_s, pool_i, k)
    for x, y in zip(got, want[:3]):
        assert torch.equal(x, y)
    out = RT.shard_reduce_cuda(pool_s, k, panels, 0)
    want = ref.topn_merge_ref(pool_s, None, k, panels=panels)
    assert torch.equal(out[0], want[0])
    assert torch.equal(out[1].long(), want[1])
    for x, y in zip(out[2], want[3]):
        assert torch.equal(x, y)
    carried = tuple(x[pool_i.clamp(0, c - 1).long()] for x in panels)
    got = RT.topn_merge_cuda(pool_s, pool_i, k, carried=carried)
    want = ref.topn_merge_ref(pool_s, pool_i, k, carried=carried,
                              farthest_first=True)
    for x, y in zip(got[:3] + got[3], want[:3] + want[3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("runs,run,k,r", [(8, 512, 512, 8),
                                           (54, 512, 512, 8),
                                           (3, 200, 129, 3),
                                           (205, 129, 129, 8),
                                           (40, 300, 300, 16)])
def test_topn_merge_runs_kernel_matches_plain(dev, runs, run, k, r):
    """Kernel 2 past k = 128 selects (a radix select over the entries'
    keys, then a bitonic sort of the k survivors), over pools of runs x
    run entries of few distinct scores in no order (ties, -inf dead rows,
    unfilled slots repeated): the top k, the hit mask and both payload
    routes (by row from a shard's panels in rank order; carried by
    position into the replay's layout) equal the plain versions' (the
    rounds' stable sorts, and the select's own) exactly; and the same
    pool's scores read as a panel (rows row0 + column)."""
    rng = np.random.default_rng(runs + k)
    nq, p = 9, runs * run
    c = 2 * p
    vals = np.asarray([-np.inf, -1.0, -0.0, 0.0, 0.5, 1.0], np.float32)
    pool_s = rng.choice(vals, (nq, p)).astype(np.float32)
    pool_i = np.stack([rng.permutation(c)[:p] for _ in range(nq)]
                      ).astype(np.int32)
    pool_s[:, run - 3:run] = -np.inf             # unfilled slots
    pool_i[:, run - 3:run] = ref.EMPTY_ROW
    pool_s = torch.tensor(pool_s, device=dev)
    pool_i = torch.tensor(pool_i, device=dev)
    panels = (torch.tensor(rng.integers(0, 10, (c, r)), dtype=torch.int32,
                           device=dev),
              torch.tensor(rng.integers(0, 10, (c, r)), dtype=torch.int32,
                           device=dev),
              torch.tensor(rng.random((c, r)), dtype=torch.float32,
                           device=dev),
              torch.tensor(rng.random((c, r)) < 0.5, device=dev))
    got = RT.topn_merge_cuda(pool_s, pool_i, k)
    want = ref.topn_merge_ref(pool_s, pool_i, k)
    for x, y in zip(got, want[:3]):
        assert torch.equal(x, y)
    out = RT.shard_reduce_cuda(pool_s, k, panels, 0)
    want = ref.topn_select_ref(pool_s, None, k, panels=panels)
    assert torch.equal(out[0], want[0])
    assert torch.equal(out[1].long(), want[1])
    for x, y in zip(out[2], want[3]):
        assert torch.equal(x, y)
    carried = tuple(x[pool_i.clamp(0, c - 1).long()] for x in panels)
    got = RT.topn_merge_cuda(pool_s, pool_i, k, carried=carried)
    want = ref.topn_merge_ref(pool_s, pool_i, k, carried=carried,
                              farthest_first=True)
    for x, y in zip(got[:3] + got[3], want[:3] + want[3]):
        assert torch.equal(x, y)
    # the panel form: rows 7 + column, records by row at row - 7
    got = RT.topn_merge_cuda(pool_s, None, k, offset=7)
    want = ref.stable_topk(pool_s, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1] + 7)
    out = RT.shard_reduce_cuda(pool_s, k, panels, 7)
    for x, y in zip(out[2], panels):
        assert torch.equal(x, y[want[1]])


def test_retrieve_kernels_refuse_what_they_do_not_take(dev):
    x = torch.ones((4, 8), device=dev)
    with pytest.raises(ValueError, match="k = 513.*512"):
        RT.topn_cuda(torch.ones((4, 8), device=dev),
                     torch.ones((600, 8), device=dev), None, 513)
    with pytest.raises(ValueError, match="k = 513.*512"):
        RT.topn_merge_cuda(torch.zeros((2, 600), device=dev),
                           torch.zeros((2, 600), dtype=torch.int32,
                                       device=dev), 513)
    with pytest.raises(ValueError, match="one CUDA device"):
        RT.retrieve_topn_cuda(x, x.cpu(), None)


@pytest.mark.parametrize("nq", [1, 8, 9, 64, 65, 1024])
@pytest.mark.parametrize("n", [129, 256, 512])
def test_retrieve_large_n_equals_panel_and_stable_sort(dev, nq, n):
    """n past 128 takes the panel route at the similarity kernel's tile:
    kernel 1's panel equals the similarity kernel's masked panel at that
    tile, kernel 2 its plain version (the select) over it, and the pair
    one stable sort of it (`ref.panel_topn_ref`), bit for bit, ties on the
    tiles' boundaries, rows past `size` dead; and a DB smaller than n."""
    c, d = 3001, 1536
    tile, route = RT.plan(nq, c, d, n=n)
    assert route == RT.PANEL and tile == RT.tile_for(nq, d)
    q, db, _, _ = _tie_inputs(dev, nq, c, d, [128 * i for i in
                                              range(1, 4)] + [700], n)
    sim = partial(similarity_cuda, tile=tile)     # scores of the same tile
    size = torch.tensor(c - 100, dtype=torch.int32, device=dev)
    panel = RT.retrieve_topn_cuda(q, db, size)
    assert torch.equal(panel, ref.mask_dead(sim(q, db), 0, size))
    top = RT.topn_merge_cuda(panel, None, n)
    want = ref.topn_select_ref(panel, None, n)
    for x, y in zip(top, want[:3]):
        assert torch.equal(x, y)
    got = RT.topn_cuda(q, db, size, n)
    want = ref.panel_topn_ref(q, db, size, n, similarity_fn=sim)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    small = db[:n - 37]                      # C < n: k = C, none dead
    got = RT.topn_cuda(q, small, None, n)
    want = ref.panel_topn_ref(q, small, None, n, similarity_fn=sim)
    torch.cuda.synchronize()
    assert got[1].shape == (nq, n - 37)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("nq", [84, 8, 1])
def test_knn_shape_and_small_grids_take_the_panel(dev, nq):
    """KNN's call (Q = 84, C = 1,470, D = 64, top-40) and other grids
    smaller than the card take the panel route: two launches, the pair
    equal to the similarity kernel's panel and its stable sort bit for
    bit, also with rows past `size` and ties on the tiles' boundaries."""
    c, d, n = 1470, 64, 40
    assert RT.plan(nq, c, d, n=n).route == RT.PANEL
    q, db, _, _ = _tie_inputs(dev, nq, c, d, [128, 256, 1280], nq)
    for size in (None, torch.tensor(1000, dtype=torch.int32, device=dev)):
        _build.reset_launches()
        got = RT.topn_cuda(q, db, size, n)
        counts = _build.launch_counts()
        want = ref.panel_topn_ref(q, db, size, n,
                                  similarity_fn=similarity_cuda)
        torch.cuda.synchronize()
        assert counts["retrieve_topn"] == counts["topn_merge"] == 1
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    gs, gi = KOPS.similarity_topk(q, db, n)
    assert torch.equal(gi, ref.stable_topk(similarity_cuda(q, db), n)[1])


@pytest.mark.parametrize("n", [129, 256, 512])
def test_retrieve_large_n_tied_panels(dev, n):
    """A DB of few distinct rows (every score tied many times over, the
    ties deciding which rows the select keeps: its row digits): the pair
    equals one stable sort of the panel bit for bit at buckets 8, 64 and
    1024."""
    rng = np.random.default_rng(n)
    c, d = 4096, 64
    base = rng.normal(size=(5, d)).astype(np.float32)
    db = torch.tensor(base[rng.integers(0, 5, c)], device=dev)
    for nq in (8, 64, 1024):
        q = torch.tensor(base[rng.integers(0, 5, nq)], device=dev)
        size = torch.tensor(c - 77, dtype=torch.int32, device=dev)
        got = RT.topn_cuda(q, db, size, n)
        want = ref.panel_topn_ref(q, db, size, n, similarity_fn=partial(
            similarity_cuda, tile=RT.tile_for(nq, d)))
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("n", [129, 256, 512])
def test_sharded_retrieve_large_n_equals_panel(dev, shards, n):
    """The capacity-sharded retrieve at n past 128 on one card (per shard
    kernel 1 and the reduce with records, then the merge on the leader)
    equals `ref.sharded_panel_topn_ref` over the similarity kernel's
    panels bit for bit: rows, scores, hits and the pre-gathered records;
    with n above a shard's rows too (C_l = 256 at S = 4)."""
    c = 1024
    q, db, recs, _, _, _, _ = _route_inputs(dev, 64, c, n + shards)
    size = torch.tensor(c - 50, dtype=torch.int32, device=dev)
    emb = _split(db, shards)
    panels = tuple(_split(x, shards) for x in recs)
    got = RT.sharded_topn_cuda(q, emb, panels, [size] * shards, n)
    want = ref.sharded_panel_topn_ref(q, emb, panels, [size] * shards, n,
                                      similarity_fn=partial(
                                          similarity_cuda,
                                          tile=RT.tile_for(64, 1536)))
    torch.cuda.synchronize()
    for x, y in zip(got[:3] + got[3], want[:3] + want[3]):
        assert torch.equal(x, y)


def test_routers_refuse_more_neighbours_than_the_kernels_keep(dev):
    """An EagleRouter or a RouteDispatcher on the card with n_neighbors
    past MAX_N raises when it is built, not at its first route; the
    reference backend and the CPU take any n."""
    from repro_torch.core.dispatch import RouteDispatcher
    from repro_torch.core.router import EagleConfig, EagleRouter
    with pytest.raises(ValueError, match="513.*512"):
        EagleRouter(["a", "b"], [1.0, 2.0], EagleConfig(n_neighbors=513),
                    device=dev)
    with pytest.raises(ValueError, match="513.*512"):
        RouteDispatcher(torch.ones(2, device=dev), n_neighbors=513)
    EagleRouter(["a", "b"], [1.0, 2.0], EagleConfig(n_neighbors=512),
                device=dev)
    EagleRouter(["a", "b"], [1.0, 2.0],
                EagleConfig(n_neighbors=513, backend="reference"),
                device=dev)
    RouteDispatcher(torch.ones(2), n_neighbors=513)


def _route_inputs(dev, nq, c, seed):
    d, r, m = 1536, 8, 10
    q, db, rng, k = _tie_inputs(dev, nq, c, d,
                                [c // 4, c // 2, 3 * c // 4, 5 * 128,
                                 7 * 32], seed)
    recs = _records(rng, c, r, m, dev)
    g = torch.tensor(1000 + 30 * rng.normal(size=m), dtype=torch.float32,
                     device=dev)
    costs = torch.tensor(rng.uniform(0.5, 40, m), dtype=torch.float32,
                         device=dev)
    bud = torch.tensor(rng.uniform(0.0, 45, nq), dtype=torch.float32,
                       device=dev)
    return q, db, recs, g, costs, bud, k


def _split(x, s):
    cl = x.shape[0] // s
    return [x[i * cl:(i + 1) * cl].clone() for i in range(s)]


def _panel_route(q, db, recs, size, g, costs, bud, n, shards):
    """The panel + stable_topk composition on the card: the similarity
    kernel's panel, the live mask and a stable sort, then the same replay
    kernel as the route."""
    from functools import partial
    if shards == 0:
        replay = partial(elo_scan_gather_select_cuda, global_ratings=g,
                         costs=costs, budgets=bud)
        return ref.retrieve_replay_pipeline(
            partial(ref.panel_topn_ref, similarity_fn=similarity_cuda),
            replay, q, db, *recs, size, g, n=n)
    replay = partial(elo_scan_select_cuda, global_ratings=g, costs=costs,
                     budgets=bud)
    return ref.sharded_retrieve_replay_pipeline(
        partial(ref.sharded_panel_topn_ref, similarity_fn=similarity_cuda),
        replay, q, _split(db, shards), *(_split(x, shards) for x in recs),
        [size] * shards, g, n=n)


def _kernel_route(q, db, recs, size, g, costs, bud, n, shards):
    if shards == 0:
        return KOPS.retrieve_replay_select(q, db, *recs, size, g, g, costs,
                                           bud, n=n)
    return KOPS.retrieve_replay_select_sharded(
        q, _split(db, shards), *(_split(x, shards) for x in recs),
        [size] * shards, g, g, costs, bud, n=n)


@pytest.mark.parametrize("bucket", [8, 64, 1024])
@pytest.mark.parametrize("shards", [0, 1, 2, 4])
def test_route_equals_panel_and_stable_sort(dev, bucket, shards):
    """The route over the kernel pair (unsharded: shards 0; and S = 1, 2,
    4 on the card) against the panel + stable_topk composition on the same
    inputs: topk_idx, topk_scores, ratings and choices equal bit for bit,
    the tie queries first (duplicates on the shard and split boundaries);
    also with size below C and below n."""
    c, n = 4096, 20
    q, db, recs, g, costs, bud, _ = _route_inputs(dev, bucket, c, bucket)
    for live in (c - 300, 13):
        size = torch.tensor(live, dtype=torch.int32, device=dev)
        got = _kernel_route(q, db, recs, size, g, costs, bud, n, shards)
        want = _panel_route(q, db, recs, size, g, costs, bud, n, shards)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        if live < n:
            assert int((~torch.isfinite(got[2])).sum()) == bucket * (n - live)


def test_route_controls_fail(dev):
    """The checks above catch a kernel 2 that drops the panel's last
    columns (over all but the last 1,024) and a select that gives a tie to
    the higher row (a build with TOPN_CONTROL_TIE_HIGH): queries equal to
    a row copied n + 5 times, so that the tie decides which rows are
    kept."""
    from unittest import mock
    c, n, nq = 4096, 20, 1024
    q, db, recs, g, costs, bud, _ = _route_inputs(dev, nq, c, 5)
    db[100:100 + n + 5] = db[99]             # rows 99..124 tie
    k = 8
    q[:k] = db[99]
    size = torch.tensor(c, dtype=torch.int32, device=dev)
    want = _panel_route(q, db, recs, size, g, costs, bud, n, 0)[1]
    panel = RT.retrieve_topn_cuda(q, db, size)
    dropped = RT.topn_merge_cuda(panel[:, :-1024], None, n)[1]
    share = float((dropped != want).any(dim=1).float().mean())
    assert share > 0.2
    library = _build.library

    def tie_high(name, defines=()):
        return library(name, TIE_CONTROL if name == "retrieve_topn"
                       else defines)
    with mock.patch.object(_build, "library", tie_high):
        ctl = _kernel_route(q, db, recs, size, g, costs, bud, n, 0)[1]
    torch.cuda.synchronize()
    assert torch.equal(want[:k], torch.arange(99, 99 + n, device=dev)
                       .expand(k, n))
    assert bool((ctl[:k] != want[:k]).any(dim=1).all())


def test_route_graph_reads_size_after_a_commit(dev):
    """A route graph captured over the kernel pair, replayed after commits
    that add prompts in place (the live-row count changes on the device,
    the replica keeps its tensors): the new prompts are retrieved (a query
    equal to a new prompt's embedding has it as its first neighbour) and
    the choices and top-n rows equal the eager route's."""
    from repro_torch.core.dispatch import RouteDispatcher, replica
    from repro_torch.core.state import DoubleBuffer
    r, rng = _graph_router(dev, n_prompts=150, seed=4)
    dbuf = DoubleBuffer(r.db, r.global_ratings, device=dev)
    disp = RouteDispatcher.for_router(r, max_bucket=64)
    for _ in range(2):
        disp.warmup(dbuf.front)
        dbuf.commit(r.global_ratings)
    keys = {replica(dbuf.front), replica(dbuf._back[0])}
    misses = disp.cache_stats()["misses"]
    for rnd in range(3):
        e = rng.normal(size=(8, 64)).astype(np.float32)
        a = rng.integers(0, 6, 8)
        first = r.db.size
        r.update(e, a, (a + 1) % 6, np.ones(8),
                 query_id=90_000 + 8 * rnd + np.arange(8))
        dbuf.commit(r.global_ratings)
        st = dbuf.front
        b = rng.uniform(0.5, 9.0, 8).astype(np.float32)
        ch, top = disp.route_result(st, e, b)
        want_ch, want_top = _eager_route(disp, st, e, b)
        np.testing.assert_array_equal(ch, want_ch)
        np.testing.assert_array_equal(top, want_top)
        np.testing.assert_array_equal(top[:, 0], first + np.arange(8))
    assert r.db.capacity == 256
    assert {replica(dbuf.front), replica(dbuf._back[0])} == keys
    assert disp.cache_stats()["misses"] == misses


# ---------------------------------------------------------------------------
# training: the kernels refuse gradients; a CUDA train step against the
# CPU's; a checkpoint round trip on the card
# ---------------------------------------------------------------------------

def test_attention_wrappers_refuse_inputs_that_require_grad(dev):
    """Neither kernel has a backward: a CUDA input that requires grad,
    under grad mode, raises (the output would carry no gradient to q, k
    or v); under no_grad the same call launches."""
    q = torch.randn(2, 16, 4, 64, device=dev, requires_grad=True)
    kv = torch.randn(2, 16, 2, 64, device=dev)
    lens = torch.full((2,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q.detach(), kv.requires_grad_(True), kv)
    kv.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_cuda(q[:, 0], kv, kv, lens)
    with torch.no_grad():
        flash_attention_cuda(q, kv, kv)
        decode_attention_cuda(q[:, 0], kv, kv, lens)
    torch.cuda.synchronize()


# the card against the CPU in fp32 (TF32 off): the metrics at
# chip_smoke.py's bar (TRAIN_METRIC_RTOL, derived there); the parameters
# after the steps at the CPU tests' bar against JAX (STEP_ATOL of
# tests/_torch_training_common.py: Adam moves an entry whose gradient
# rounds to the other sign by lr the other way)
TRAIN_METRIC_RTOL, TRAIN_PARAM_ATOL = 1e-5, 5e-4


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-7b",
                                  "deepseek-v3-671b"])
def test_cuda_train_steps_match_the_cpu(dev, arch):
    """3 steps of make_train_step on the card and on the CPU from the
    same weights and batches: the metrics within TRAIN_METRIC_RTOL, the
    parameters within TRAIN_PARAM_ATOL of each leaf's scale, and no
    kernel launched (the step's attention is the plain attend)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.training import loop as TL
    from repro_torch import tree as TR
    from repro_torch.training.optim import AdamW
    cfg = get_reduced_config(arch, dtype="float32")
    cpu_p = T.init_params(cfg, torch.Generator().manual_seed(0), train=True)
    card_p = TR.map_tree(lambda x: x.to(dev, copy=True), cpu_p)
    data = TL.synthetic_lm_batches(cfg, 2, 32, seed=1, device="cpu")
    batches = [next(data) for _ in range(3)]
    _build.reset_launches()
    out = {}
    for where, p, d in (("cpu", cpu_p, "cpu"), ("card", card_p, dev)):
        opt = AdamW(lr=1e-3)
        st, step = opt.init(p), TL.make_train_step(cfg, opt)
        rows = []
        for b in batches:
            p, st, m = step(p, st, {k: v.to(d) for k, v in b.items()})
            rows.append({k: float(v) for k, v in m.items()})
        out[where] = (rows, p)
    torch.cuda.synchronize()
    assert not any(_build.launch_counts().values())
    for got, want in zip(out["card"][0], out["cpu"][0]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=TRAIN_METRIC_RTOL)
    for a, b in zip(TR.leaves(out["card"][1]), TR.leaves(out["cpu"][1])):
        assert a.is_cuda and not a.requires_grad
        scale = float(b.abs().max())
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=TRAIN_PARAM_ATOL * scale)


def test_cuda_checkpoint_round_trip(dev, tmp_path):
    """A training tree on the card (fp32 masters, bf16 AdamW moments, the
    int32 step) saved and restored into a tree on the card: every leaf
    equal bit for bit, on the card, in its type."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import loop as TL
    from repro_torch import tree as TR
    from repro_torch.training.optim import AdamW
    cfg = get_reduced_config("deepseek-v3-671b")
    opt = AdamW(state_dtype=torch.bfloat16)
    p = T.init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                      train=True)
    st = opt.init(p)
    step = TL.make_train_step(cfg, opt)
    data = TL.synthetic_lm_batches(cfg, 2, 32, seed=1, device=dev)
    for _ in range(2):
        p, st, _ = step(p, st, next(data))
    tree = {"params": p, "opt": st}
    CKPT.save(tmp_path / "step_2.npz", tree, step=2)
    like = TR.map_tree(torch.zeros_like, tree)
    got = CKPT.restore(tmp_path / f"step_{CKPT.latest_step(tmp_path)}.npz",
                       like)
    dtypes = set()
    for a, b in zip(TR.leaves(got), TR.leaves(tree)):
        assert a.is_cuda and a.dtype == b.dtype
        assert torch.equal(a, b.detach())
        dtypes.add(a.dtype)
    assert dtypes == {torch.float32, torch.bfloat16, torch.int32}
