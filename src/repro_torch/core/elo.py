"""ELO rating engine (Eq. 1-2 of the paper) on PyTorch tensors.

    E  = 1 / (1 + 10^((R_opp - R) / 400))        (expected score)
    R' = R + K * (S - E)                          (update, K=32)

  * global: one long fold over the whole feedback log (initialisation),
    or over only the NEW records (incremental update) — the paper's
    claim that updating is O(new records), with no retraining.
  * local: a batched fold — Q queries each replay their N retrieved
    neighbour records starting from the global ratings (Eagle-Local).

The plain versions are loops over T. On the card, the global fold runs
through the replay kernel as one query (Q = 1) over the (1, T) record
row: the same recurrence, where a Python loop would cost several tiny
launches per record.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops as KOPS

DEFAULT_RATING = 1000.0


def expected_score(r_a, r_b):
    """P(a beats b) under the ELO model."""
    return 1.0 / (1.0 + torch.pow(10.0, (r_b - r_a) / 400.0))


def elo_step(ratings, a_idx, b_idx, outcome, k, valid=True):
    """One pairwise update on a (..., M) rating tensor.

    a_idx/b_idx: model indices (...,); outcome: S for model a (1 win /
    0.5 draw / 0 loss); valid: mask, False leaves ratings as they are."""
    m = ratings.shape[-1]
    a_idx, b_idx = a_idx.long(), b_idx.long()
    r_a = torch.gather(ratings, -1, a_idx[..., None])[..., 0]
    r_b = torch.gather(ratings, -1, b_idx[..., None])[..., 0]
    e_a = expected_score(r_a, r_b)
    delta = k * (outcome - e_a)
    v = torch.as_tensor(valid, dtype=ratings.dtype, device=ratings.device)
    one_a = torch.nn.functional.one_hot(a_idx, m).to(ratings.dtype)
    one_b = torch.nn.functional.one_hot(b_idx, m).to(ratings.dtype)
    return ratings + (v * delta)[..., None] * (one_a - one_b)


def elo_scan(ratings, a_idx, b_idx, outcome, valid=None, *, k: float = 32.0):
    """Replay T records in arrival order (plain loop).

    ratings: (..., M) initial; a_idx/b_idx/outcome/valid: (T, ...) —
    leading time axis, the rest broadcast against ratings' batch dims
    ((T,) for global, (T, Q) for per-query local replays)."""
    if valid is None:
        valid = torch.ones(a_idx.shape, dtype=torch.bool, device=a_idx.device)
    r = ratings
    for i in range(a_idx.shape[0]):
        r = elo_step(r, a_idx[i], b_idx[i], outcome[i], k, valid[i])
    return r


def local_elo(global_ratings, nbr_a, nbr_b, nbr_outcome, nbr_valid,
              *, k: float = 32.0):
    """Eagle-Local: per-query replay of retrieved neighbour feedback.
    global_ratings: (M,); nbr_*: (Q, N). Returns (Q, M)."""
    q = nbr_a.shape[0]
    init = global_ratings.expand(q, global_ratings.shape[-1])
    return elo_scan(init, nbr_a.T, nbr_b.T, nbr_outcome.T, nbr_valid.T, k=k)


def _pad_bucket(t: int, floor: int = 64) -> int:
    """Round a count up to a power-of-two bucket (floor 64 for record
    folds; the dispatcher uses a smaller floor for query batches)."""
    b = floor
    while b < t:
        b *= 2
    return b


def _host(x, dtype) -> np.ndarray:
    """Flat host copy of a record column given as a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype).reshape(-1)


def _padded_records(a_idx, b_idx, outcome, dev):
    """The record log padded to its pow-2 bucket, exactly as the JAX
    package pads it (zeros past T, `valid` = step < T), in one host
    buffer of int32 a | int32 b | float32 s | bool v, moved to `dev` in
    one copy. Returns (a, b, s, v), each (T_bucket,) on `dev`.

    For a CUDA device the buffer is pinned, so the copy is one DMA that
    does not wait for the host; PyTorch's pinned-memory allocator reuses
    it only after that copy has run."""
    a = _host(a_idx, np.int32)
    t = a.size
    tb = _pad_bucket(t)
    host = torch.empty(13 * tb, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    cols = host.numpy()
    cols[:12 * tb].view(np.int32).reshape(3, tb)[:, t:] = 0
    cols[:4 * tb].view(np.int32)[:t] = a
    cols[4 * tb:8 * tb].view(np.int32)[:t] = _host(b_idx, np.int32)
    cols[8 * tb:12 * tb].view(np.float32)[:t] = _host(outcome, np.float32)
    cols[12 * tb:12 * tb + t] = 1
    cols[12 * tb + t:] = 0
    buf = host.to(dev, non_blocking=True)
    return (buf[:4 * tb].view(torch.int32), buf[4 * tb:8 * tb].view(
        torch.int32), buf[8 * tb:12 * tb].view(torch.float32),
        buf[12 * tb:].view(torch.bool))


def _scan_padded(ratings, a_idx, b_idx, outcome, k):
    """Global fold over a record log padded to its pow-2 bucket with a
    `valid` mask, exactly as the JAX package pads it, so both packages
    run the same steps: one query (Q = 1) through the replay kernel, or
    through its plain version for CPU tensors."""
    a, b, s, v = _padded_records(a_idx, b_idx, outcome, ratings.device)
    return KOPS.elo_scan(ratings[None], a[None], b[None], s[None], v[None],
                         k=k)[0]


def fit_global(n_models: int, a_idx, b_idx, outcome, *, k: float = 32.0,
               init: float = DEFAULT_RATING, device: DeviceLike = None):
    """Eagle-Global initialisation: one pass over the full history."""
    ratings = torch.full((n_models,), init, dtype=torch.float32,
                         device=resolve_device(device))
    return _scan_padded(ratings, a_idx, b_idx, outcome, k)


def update_global(ratings, new_a, new_b, new_outcome, *, k: float = 32.0):
    """Incremental Eagle-Global update: fold only the NEW records, on the
    device the ratings lie on."""
    return _scan_padded(ratings, new_a, new_b, new_outcome, k)
