"""Batched ELO replay: the CUDA kernel `csrc/elo_scan.cu` (port of the TPU
kernels `elo_scan_pallas` and `elo_scan_select_pallas`) and its wrappers,
which share the device code and differ by two flags: the budget-selection
epilogue, and where the records come from (pre-gathered (Q, T) records,
or the (C, R) panels read in place through each query's top-n rows).

A W-lane segment of a warp replays one query with lane m holding rating
m, so the number of models is at most MAX_MODELS. Model indices must lie
in [0, M): the kernel reads them from the records on the device and does
not check them (the host buffer that holds them is filled by
`VectorDB.add`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_MODELS = 32
#: the gather route stages each query's top-n rows in shared memory
#: beside its decoded records: 16 queries a block x (512 records of 16
#: bytes + 512 rows of 4 bytes) stays under the 48 KB a launch may take
MAX_NEIGHBOURS = 512


def _check_models(name, m):
    if not 1 <= m <= MAX_MODELS:
        raise ValueError(f"{name}: {m} models; the kernel takes 1.."
                         f"{MAX_MODELS} (one warp lane per model)")


def _check_replay_args(name, ratings, a_idx, b_idx, outcome, valid):
    dev = ratings.device
    for x in (a_idx, b_idx, outcome, valid):
        if x.device != dev:
            raise ValueError(f"{name}: inputs lie on {x.device} and {dev}")
    q, m = ratings.shape
    _check_models(name, m)
    for x in (a_idx, b_idx, outcome, valid):
        if x.ndim != 2 or x.shape[0] != q:
            raise ValueError(f"{name}: records of shape {tuple(x.shape)} "
                             f"for {q} queries")
    if a_idx.shape != b_idx.shape or a_idx.shape != outcome.shape \
            or a_idx.shape != valid.shape:
        raise ValueError(f"{name}: record shapes differ")


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as a contiguous `dtype` tensor; x itself when it is one, without
    a call (a route's replay takes a dozen inputs, and each call costs
    the host microseconds)."""
    if x.dtype == dtype and x.is_contiguous():
        return x
    return x.to(dtype).contiguous()


def _select_args(name, m, q, dev, global_ratings, costs, budgets):
    g = _as(global_ratings, torch.float32)
    c = _as(costs, torch.float32)
    bud = budgets if budgets.dtype == torch.float32 else budgets.float()
    if g.shape != (m,) or c.shape != (m,) or bud.shape != (q,):
        raise ValueError(f"{name}: global_ratings and costs must be (M,), "
                         "budgets (Q,)")
    if not (g.device == c.device == bud.device == dev):
        raise ValueError(f"{name}: inputs on several devices")
    return g, c, bud


def _rows(x: torch.Tensor) -> torch.Tensor:
    """fp32 with unit column stride; a broadcast row (stride 0) stays one
    row in memory."""
    if x.dtype != torch.float32:
        x = x.float()
    return x if x.stride(-1) == 1 else x.contiguous()


def _launch(ratings, records, g, costs, budgets, *, k, p, select,
            rows=None):
    """ratings (Q, M) at any row stride; records (a, b, s, v), (Q, T), or
    with `rows` = (top_i, hit) the (C, R) panels read in place."""
    q, m = ratings.shape
    dev = ratings.device
    ratings = _rows(ratings)
    a, b, s, v = records
    a, b = _as(a, torch.int32), _as(b, torch.int32)
    s = _as(s, torch.float32)
    v = _as(v, torch.bool).view(torch.uint8)
    out = torch.empty((q, m), dtype=torch.float32, device=dev)
    choices = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out, choices
    if rows is None:
        top_i = hit = None
        n, r, t = 0, 0, a.shape[1]
    else:
        top_i = _as(rows[0], torch.int64)
        hit = _as(rows[1], torch.bool).view(torch.uint8)
        n, r = top_i.shape[1], a.shape[1]
        t = n * r
    if select:
        budgets = budgets if budgets.stride(0) in (0, 1) \
            else budgets.contiguous()
    lib = _build.library("elo_scan")
    err = lib.elo_scan_launch(
        ratings.data_ptr(), ratings.stride(0), a.data_ptr(), b.data_ptr(),
        s.data_ptr(), v.data_ptr(),
        None if top_i is None else top_i.data_ptr(),
        None if hit is None else hit.data_ptr(), n, r,
        g.data_ptr() if select else None,
        costs.data_ptr() if select else None,
        budgets.data_ptr() if select else None,
        budgets.stride(0) if select else 0, out.data_ptr(),
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
    return _launch(ratings, (a_idx, b_idx, outcome, valid), None, None,
                   None, k=k, p=0.0, select=False)[0]


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
    name = "elo_scan_select_cuda"
    _check_replay_args(name, ratings, a_idx, b_idx, outcome, valid)
    q, m = ratings.shape
    g, c, bud = _select_args(name, m, q, ratings.device, global_ratings,
                             costs, budgets)
    return _launch(ratings, (a_idx, b_idx, outcome, valid), g, c, bud, k=k,
                   p=p, select=True)


def _check_gather_args(name, init, panels, top_i, hit):
    dev = init.device
    if init.ndim != 1:
        raise ValueError(f"{name}: the prior must be (M,), not "
                         f"{tuple(init.shape)}")
    _check_models(name, init.shape[0])
    shape = panels[0].shape
    for x in (*panels, top_i, hit):
        if x.device != dev:
            raise ValueError(f"{name}: inputs lie on {x.device} and {dev}")
    if len(shape) != 2 or any(x.shape != shape for x in panels):
        raise ValueError(f"{name}: the panels must share one (C, R) shape")
    if top_i.ndim != 2 or hit.shape != top_i.shape:
        raise ValueError(f"{name}: top_i and hit must share one (Q, n) "
                         "shape")
    if top_i.shape[1] > MAX_NEIGHBOURS:
        raise ValueError(f"{name}: {top_i.shape[1]} neighbours; the kernel "
                         f"takes at most {MAX_NEIGHBOURS}")


def elo_scan_gather_cuda(init, panels, top_i, hit, *, k: float = 32.0):
    """The replay with its records read in place: query q replays the
    (C, R) panels (model_a, model_b, outcome, valid) of its rows
    top_i[q], farthest first, a row with hit False as invalid records,
    from the (M,) prior `init`. Returns (Q, M) ratings.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.elo_scan_gather_ref`: `gather_records`, then the replay)."""
    if init.device.type == "cpu":
        return ref.elo_scan_gather_ref(init, panels, top_i, hit, k=k)
    _check_gather_args("elo_scan_gather_cuda", init, panels, top_i, hit)
    q = top_i.shape[0]
    prior = _rows(init).expand(q, init.shape[0])
    return _launch(prior, panels, None, None, None, k=k, p=0.0,
                   select=False, rows=(top_i, hit))[0]


def elo_scan_gather_select_cuda(init, panels, top_i, hit, global_ratings,
                                costs, budgets, *, p: float = 0.5,
                                k: float = 32.0):
    """elo_scan_gather_cuda with the budget-selection epilogue: the routing
    path's replay. Returns (ratings (Q, M) fp32, choices (Q,) int32)."""
    if init.device.type == "cpu":
        return ref.elo_scan_gather_select_ref(init, panels, top_i, hit,
                                              global_ratings, costs,
                                              budgets, p=p, k=k)
    name = "elo_scan_gather_select_cuda"
    _check_gather_args(name, init, panels, top_i, hit)
    q, m = top_i.shape[0], init.shape[0]
    g, c, bud = _select_args(name, m, q, init.device, global_ratings, costs,
                             budgets)
    prior = _rows(init).expand(q, m)
    return _launch(prior, panels, g, c, bud, k=k, p=p, select=True,
                   rows=(top_i, hit))
