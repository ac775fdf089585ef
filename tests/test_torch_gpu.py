"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: without a CUDA device every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.elo_scan import (MAX_MODELS, elo_scan_cuda,
                                          elo_scan_select_cuda)
from repro_torch.kernels.similarity_topk import similarity_cuda

pytestmark = pytest.mark.gpu

# similarity: the JAX suite's own bar between its backends
SIM_TOL = 1e-5
# ratings: the JAX suite's bar (tests/test_router_state.py); the kernel
# computes 10^x with powf and sums in the same order as the reference
R_RTOL, R_ATOL = 1e-5, 1e-3


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
                                    (130, 1000, 50), (257, 2049, 384)])
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


@pytest.mark.parametrize("nq,t,m", [(1, 1, 1), (5, 33, 10), (300, 160, 10),
                                    (64, 70, MAX_MODELS)])
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


@pytest.mark.parametrize("size", [0, 700, 1500])
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


def test_wrappers_count_launches(dev):
    _build.reset_launches()
    x = torch.ones((4, 8), device=dev)
    similarity_cuda(x, x)
    elo_scan_cuda(torch.zeros((1, 3), device=dev),
                  *(torch.zeros((1, 2), dtype=dt, device=dev)
                    for dt in (torch.int32, torch.int32, torch.float32,
                               torch.bool)))
    KOPS.similarity(x, x, backend="reference")
    assert _build.launch_counts() == {"similarity": 1, "elo_scan": 1,
                                      "elo_scan_select": 0}
