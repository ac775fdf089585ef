"""Batched ELO replay: the CUDA kernel `csrc/elo_scan.cu` (port of the TPU
kernels `elo_scan_pallas` and `elo_scan_select_pallas`) and its two
wrappers, which share the device code and differ by the epilogue flag.

One warp replays one query with lane m holding rating m, so the number
of models is at most MAX_MODELS. Model indices must lie in [0, M): the
kernel reads them from the records on the device and does not check
them (the host buffer that holds them is filled by `VectorDB.add`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_MODELS = 32


def _check_replay_args(name, ratings, a_idx, b_idx, outcome, valid):
    dev = ratings.device
    for x in (a_idx, b_idx, outcome, valid):
        if x.device != dev:
            raise ValueError(f"{name}: inputs lie on {x.device} and {dev}")
    q, m = ratings.shape
    if not 1 <= m <= MAX_MODELS:
        raise ValueError(f"{name}: {m} models; the kernel takes 1.."
                         f"{MAX_MODELS} (one warp lane per model)")
    for x in (a_idx, b_idx, outcome, valid):
        if x.ndim != 2 or x.shape[0] != q:
            raise ValueError(f"{name}: records of shape {tuple(x.shape)} "
                             f"for {q} queries")
    if a_idx.shape != b_idx.shape or a_idx.shape != outcome.shape \
            or a_idx.shape != valid.shape:
        raise ValueError(f"{name}: record shapes differ")


def _launch(ratings, a_idx, b_idx, outcome, valid, g, costs, budgets, *,
            k, p, select):
    q, m = ratings.shape
    t = a_idx.shape[1]
    dev = ratings.device
    ratings = ratings.float().contiguous()
    a = a_idx.to(torch.int32).contiguous()
    b = b_idx.to(torch.int32).contiguous()
    s = outcome.float().contiguous()
    v = valid.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((q, m), dtype=torch.float32, device=dev)
    choices = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out, choices
    lib = _build.library("elo_scan")
    err = lib.elo_scan_launch(
        ratings.data_ptr(), a.data_ptr(), b.data_ptr(), s.data_ptr(),
        v.data_ptr(), g.data_ptr() if select else None,
        costs.data_ptr() if select else None,
        budgets.data_ptr() if select else None, out.data_ptr(),
        choices.data_ptr(), q, t, m, float(k), float(p), float(1.0 - p),
        int(select), _build.stream_handle(dev))
    name = "elo_scan_select" if select else "elo_scan"
    _build.check(err, name)
    _build.count_launch(name)
    return out, choices


def elo_scan_cuda(ratings, a_idx, b_idx, outcome, valid, *,
                  k: float = 32.0) -> torch.Tensor:
    """ratings: (Q, M) initial; records (Q, T). Returns (Q, M) replayed.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.elo_scan_ref`)."""
    if ratings.device.type == "cpu":
        return ref.elo_scan_ref(ratings, a_idx, b_idx, outcome, valid, k=k)
    _check_replay_args("elo_scan_cuda", ratings, a_idx, b_idx, outcome,
                       valid)
    return _launch(ratings, a_idx, b_idx, outcome, valid, None, None, None,
                   k=k, p=0.0, select=False)[0]


def elo_scan_select_cuda(ratings, a_idx, b_idx, outcome, valid,
                         global_ratings, costs, budgets, *, p: float = 0.5,
                         k: float = 32.0):
    """Replay with the budget-selection epilogue fused into the kernel:
    Score = p*Global + (1-p)*Local, masked by cost <= budget, first-index
    argmax, first cheapest model as fallback.

    ratings: (Q, M) replay init; records (Q, T); global_ratings (M,);
    costs (M,); budgets (Q,). Returns (ratings (Q, M) fp32,
    choices (Q,) int32)."""
    if ratings.device.type == "cpu":
        return ref.elo_scan_select_ref(ratings, a_idx, b_idx, outcome,
                                       valid, global_ratings, costs,
                                       budgets, p=p, k=k)
    _check_replay_args("elo_scan_select_cuda", ratings, a_idx, b_idx,
                       outcome, valid)
    q, m = ratings.shape
    dev = ratings.device
    g = global_ratings.float().contiguous()
    c = costs.float().contiguous()
    bud = budgets.float().contiguous()
    if g.shape != (m,) or c.shape != (m,) or bud.shape != (q,):
        raise ValueError("elo_scan_select_cuda: global_ratings and costs "
                         "must be (M,), budgets (Q,)")
    if not (g.device == c.device == bud.device == dev):
        raise ValueError("elo_scan_select_cuda: inputs on several devices")
    return _launch(ratings, a_idx, b_idx, outcome, valid, g, c, bud, k=k,
                   p=p, select=True)
