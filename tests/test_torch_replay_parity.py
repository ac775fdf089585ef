"""The replay's host-side pieces against the JAX package, on the CPU: the
host fold that `chip_smoke.py` holds the fit's fold against, the plain
gather stage of the retrieval chain, and the global fold's single-buffer
upload.

Integer outputs must be equal; ratings match at rtol 1e-5 / atol 1e-3
(the JAX suite's bar between its backends, tests/test_router_state.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import elo as JELO
from repro.kernels import ref as JREF
from repro.kernels.elo_scan import elo_scan_pallas
from repro_torch.core import elo as TELO
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.elo_scan import elo_scan_gather_cuda

jax.config.update("jax_platform_name", "cpu")

R_RTOL, R_ATOL = 1e-5, 1e-3


def _log(rng, t, m, p_valid=0.8, self_pairs=0):
    a = rng.integers(0, m, t).astype(np.int32)
    b = ((a + rng.integers(1, m, t)) % m).astype(np.int32)
    b[:self_pairs] = a[:self_pairs]          # a == b: no change
    s = rng.choice([0.0, 0.5, 1.0], t).astype(np.float32)
    v = rng.random(t) < p_valid
    return a, b, s, v


# ---------------------------------------------------------------------------
# the host fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,m,self_pairs", [(1, 2, 0), (37, 10, 3),
                                            (300, 10, 0), (129, 32, 5)])
def test_host_fold_matches_jax_kernel_and_plain(t, m, self_pairs):
    """float32 host fold == the Pallas kernel (interpret mode) and the
    plain replay, at the ratings bar; invalid and a == b records included."""
    rng = np.random.default_rng(t + m)
    r0 = (1000 + 50 * rng.normal(size=m)).astype(np.float32)
    a, b, s, v = _log(rng, t, m, self_pairs=self_pairs)
    got = TREF.elo_fold_host(r0, a, b, s, v, dtype=np.float32)
    assert got.dtype == np.float32
    want = elo_scan_pallas(*(jnp.asarray(x[None]) for x in (r0, a, b, s, v)),
                           interpret=True)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=R_RTOL,
                               atol=R_ATOL)
    plain = TREF.elo_scan_ref(*(torch.tensor(x[None]) for x in
                                (r0, a, b, s, v)))[0]
    np.testing.assert_allclose(got, plain.numpy(), rtol=R_RTOL, atol=R_ATOL)


def test_host_fold_float64_and_invalid_records():
    rng = np.random.default_rng(3)
    r0 = np.full(6, 1000.0)
    a, b, s, v = _log(rng, 500, 6)
    r32 = TREF.elo_fold_host(r0, a, b, s, v, dtype=np.float32)
    r64 = TREF.elo_fold_host(r0, a, b, s, v, dtype=np.float64)
    assert r64.dtype == np.float64
    np.testing.assert_allclose(r32, r64, rtol=R_RTOL, atol=R_ATOL)
    # the sum of ratings is conserved; invalid records change nothing
    assert abs(r64.sum() - 6000.0) < 1e-9
    none = TREF.elo_fold_host(r0, a, b, s, np.zeros_like(v))
    np.testing.assert_array_equal(none, r0.astype(np.float32))


# ---------------------------------------------------------------------------
# the plain gather stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_gather_stage_matches_jax_gather_and_replay(seed):
    """The plain gather stage == JAX's gather_records + elo_replay_ref on
    the same rows and hits, misses included."""
    rng = np.random.default_rng(seed)
    c, r, m, nq, n = 40, 3, 5, 7, 6
    a = rng.integers(0, m, (c, r)).astype(np.int32)
    b = ((a + 1 + rng.integers(0, m - 1, (c, r))) % m).astype(np.int32)
    s = rng.choice([0.0, 0.5, 1.0], (c, r)).astype(np.float32)
    v = rng.random((c, r)) < 0.8
    idx = rng.integers(0, c, (nq, n)).astype(np.int32)
    hit = rng.random((nq, n)) < 0.7
    init = (1000 + 40 * rng.normal(size=m)).astype(np.float32)
    recs = JREF.gather_records(*(jnp.asarray(x) for x in
                                 (a, b, s, v, idx, hit)))
    want = JREF.elo_replay_ref(jnp.broadcast_to(init, (nq, m)), *recs)
    t = [torch.tensor(x) for x in (init, a, b, s, v, idx, hit)]
    got = elo_scan_gather_cuda(t[0], tuple(t[1:5]), t[5], t[6])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=R_RTOL,
                               atol=R_ATOL)
    assert torch.equal(got, TREF.elo_scan_gather_ref(t[0], tuple(t[1:5]),
                                                     t[5], t[6]))


# ---------------------------------------------------------------------------
# the global fold's single-buffer upload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 1, 63, 64, 65, 400, 1000])
def test_padded_records_are_the_old_padding(t):
    """One host buffer, one copy: the same padded steps as three padded
    columns and an `arange` mask (the JAX package's padding)."""
    rng = np.random.default_rng(t)
    a, b, s, _ = _log(rng, t, 7)
    tb = TELO._pad_bucket(t)
    got = TELO._padded_records(a, b, torch.tensor(s), torch.device("cpu"))
    want = (np.pad(a, (0, tb - t)), np.pad(b, (0, tb - t)),
            np.pad(s, (0, tb - t)), np.arange(tb) < t)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.tensor(w_).dtype
        np.testing.assert_array_equal(g_.numpy(), w_)
    # a second log does not write through the first one's tensors
    TELO._padded_records(a[::-1].copy(), b, s, torch.device("cpu"))
    np.testing.assert_array_equal(got[0].numpy(), want[0])


@pytest.mark.parametrize("t", [5, 200])
def test_scan_padded_ratings_unchanged(t):
    """_scan_padded gives the ratings of the old three-copy padding
    exactly, and matches JAX's fold."""
    rng = np.random.default_rng(t + 1)
    a, b, s, _ = _log(rng, t, 10)
    r0 = torch.tensor((1000 + 30 * rng.normal(size=10)).astype(np.float32))
    got = TELO._scan_padded(r0, a, b, s, 32.0)
    tb = TELO._pad_bucket(t)
    old = [torch.tensor(np.pad(x, (0, tb - t)))[None] for x in (a, b, s)]
    want = TREF.elo_scan_ref(r0[None], *old,
                             (torch.arange(tb) < t)[None])[0]
    assert torch.equal(got, want)
    jax_r = JELO.update_global(jnp.asarray(r0.numpy()), jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_r), rtol=R_RTOL,
                               atol=R_ATOL)
