"""Plain reference of the Eagle router (arXiv:2409.15518, §2.2, Eq. 1-2).

  E  = 1 / (1 + 10^((R_b - R_a) / 400))     expected score of model a
  R' = R + K (S - E) for a, R - K (S - E) for b

  * the DB: one row a prompt, in the order prompts first appear in the
    feedback stream, its embedding L2-normalised, its records in slots
    in arrival order;
  * Eagle-Global: one fold over every record, in arrival order;
  * Eagle-Local: the N live rows most similar to the query by cosine
    (ties to the lower row), their records replayed from the global
    ratings, the farthest neighbour first (the nearest is replayed last,
    so it weighs most);
  * Score = P Global + (1 - P) Local; the choice is the highest score
    among the models of cost <= budget (the first on ties), else the
    cheapest model.

Written from the paper's equations in plain numpy and PyTorch, in
float64; it imports nothing of the program. Two lower precisions put the
reference in the program's place, as controls of the comparison that
decides `correct`:

  "control"       the same arithmetic one precision below the
                  configuration's float32: the similarity's inputs
                  rounded to TF32, the folds and the normalisation in
                  bfloat16, the replay in float32;
  "control_tf32"  the similarity's inputs rounded to TF32 alone, all the
                  rest in float64 (a TF32 similarity GEMM, nothing else).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

PRECISIONS = ("reference", "control", "control_tf32")


def _check(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")


def _bf16(x):
    return torch.tensor(x, dtype=torch.bfloat16).item()


def elo_fold(ratings: Sequence[float], a, b, s, *, k: float,
             precision: str = "reference") -> np.ndarray:
    """Eq. 1-2 over the records in order, from `ratings`. A record with
    a == b changes nothing. Float64, or every operation rounded to
    bfloat16 for the control."""
    _check(precision)
    rnd = _bf16 if precision == "control" else float
    r = [rnd(x) for x in np.asarray(ratings, np.float64)]
    kk = rnd(k)
    for ai, bi, si in zip(np.asarray(a).tolist(), np.asarray(b).tolist(),
                          np.asarray(s, np.float64).tolist()):
        if ai == bi:
            continue
        ra, rb = r[ai], r[bi]
        e = rnd(1.0 / rnd(1.0 + rnd(10.0 ** rnd(rnd(rb - ra) / 400.0))))
        delta = rnd(kk * rnd(si - e))
        r[ai] = rnd(ra + delta)
        r[bi] = rnd(rb - delta)
    return np.asarray(r, np.float64)


@dataclasses.dataclass
class DB:
    emb: np.ndarray        # (rows, D) float64, unit norm
    model_a: np.ndarray    # (rows, R) int64
    model_b: np.ndarray    # (rows, R) int64
    outcome: np.ndarray    # (rows, R) float64
    valid: np.ndarray      # (rows, R) bool
    prompt: np.ndarray     # (rows,) the prompt id of each row


def build_db(prompt, a, b, s, embeddings: np.ndarray, slots: int,
             precision: str = "reference") -> DB:
    """The DB after the records (prompt ids and pairs in arrival order)
    were appended: rows in order of each prompt's first record, slots in
    arrival order; `embeddings[p]` is prompt p's embedding."""
    _check(precision)
    prompt = np.asarray(prompt, np.int64)
    uniq, first, inv = np.unique(prompt, return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    row = rank[inv]
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=len(uniq))
    if counts.max(initial=0) > slots:
        raise ValueError(f"a prompt has {counts.max()} records, over the "
                         f"{slots} slots of a row")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(len(prompt), np.int64)
    slot[order] = np.arange(len(prompt)) - np.repeat(start, counts)
    rows = len(uniq)
    db = DB(np.zeros((rows, embeddings.shape[1])),
            np.zeros((rows, slots), np.int64),
            np.zeros((rows, slots), np.int64),
            np.zeros((rows, slots)), np.zeros((rows, slots), bool),
            np.empty(rows, np.int64))
    db.prompt[row] = prompt
    db.model_a[row, slot] = a
    db.model_b[row, slot] = b
    db.outcome[row, slot] = s
    db.valid[row, slot] = True
    e = np.asarray(embeddings[db.prompt], np.float64)
    if precision == "control":
        t = torch.from_numpy(e).to(torch.bfloat16)
        e = (t / torch.linalg.norm(t, dim=-1, keepdim=True)).double().numpy()
    else:
        e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    db.emb = e
    return db


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest,
    ties to even): what a TF32 tensor-core product reads."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _emb(db: DB, precision: str, dev) -> torch.Tensor:
    emb = torch.as_tensor(db.emb, device=dev)
    return _tf32(emb) if precision != "reference" else emb.double()


def _similarity(qb, emb: torch.Tensor, live, precision: str):
    """Cosines of the queries qb (B, D) with the DB's rows (float64, or
    float32 from TF32-rounded inputs); rows at or past a query's live
    count read -inf."""
    qb = torch.as_tensor(np.asarray(qb, np.float64), device=emb.device)
    qb = qb / torch.linalg.norm(qb, dim=-1, keepdim=True)
    if precision != "reference":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        sim = _tf32(qb) @ emb.T
        torch.backends.cuda.matmul.allow_tf32 = prev
    else:
        sim = qb @ emb.T
    rows = torch.arange(emb.shape[0], device=emb.device)
    live = torch.as_tensor(np.asarray(live), device=emb.device)
    return torch.where(rows[None, :] < live[:, None], sim,
                       torch.full_like(sim, float("-inf")))


def _top(sim: torch.Tensor, n: int) -> torch.Tensor:
    """The n rows of highest similarity, the nearest first (ties to the
    lower row)."""
    _, top = torch.sort(sim, dim=-1, descending=True, stable=True)
    return top[:, :n]


def route(q, db: DB, size, g, costs, budgets, *, n: int, k: float,
          p: float, precision: str = "reference", device="cpu",
          block: int = 1024):
    """Scores and choices for queries q (Q, D). Query i sees the DB's
    first size[i] rows and the global ratings g[i] (M,). Returns
    (combined scores (Q, M) float64, choices (Q,) int64)."""
    _check(precision)
    dev = torch.device(device)
    ft = torch.float32 if precision == "control" else torch.float64
    emb = _emb(db, precision, dev)
    panels = [torch.as_tensor(x, device=dev) for x in
              (db.model_a, db.model_b, db.outcome, db.valid)]
    costs_t = torch.as_tensor(np.asarray(costs, np.float64), device=dev)
    out_s, out_c = [], []
    for lo in range(0, len(q), block):
        sim = _similarity(q[lo:lo + block], emb, size[lo:lo + block],
                          precision)
        top = _top(sim, n)
        hit = torch.gather(sim, 1, top) > float("-inf")
        ra = torch.as_tensor(np.asarray(g[lo:lo + block]), device=dev).to(ft)
        for j in range(n - 1, -1, -1):          # the farthest first
            rj = top[:, j]
            for slot in range(panels[0].shape[1]):
                a, b, s, v = (x[rj, slot] for x in panels)
                v = v & hit[:, j] & (a != b)
                r_a = torch.gather(ra, 1, a[:, None])[:, 0]
                r_b = torch.gather(ra, 1, b[:, None])[:, 0]
                e = 1.0 / (1.0 + torch.pow(10.0, (r_b - r_a) / 400.0))
                d = torch.where(v, k * (s.to(ft) - e), torch.zeros_like(e))
                ra = ra.scatter_add(1, a[:, None], d[:, None])
                ra = ra.scatter_add(1, b[:, None], -d[:, None])
        gb = torch.as_tensor(np.asarray(g[lo:lo + block]), device=dev).to(ft)
        comb = (p * gb + (1.0 - p) * ra).double()
        bud = torch.as_tensor(np.asarray(budgets[lo:lo + block], np.float64),
                              device=dev)
        feas = costs_t[None, :] <= bud[:, None]
        masked = torch.where(feas, comb, torch.full_like(comb, float("-inf")))
        choice = torch.where(feas.any(dim=-1), torch.argmax(masked, dim=-1),
                             torch.argmin(costs_t))
        out_s.append(comb.cpu().numpy())
        out_c.append(choice.cpu().numpy())
    return np.concatenate(out_s), np.concatenate(out_c)


def neighbours(q, db: DB, size, *, n: int, precision: str = "reference",
               device="cpu", block: int = 1024):
    """The n nearest live rows of each query (Q, n), the nearest first,
    and the cosines of the n + 1 nearest (Q, n + 1), as `route` finds
    them at `precision`."""
    _check(precision)
    emb = _emb(db, precision, torch.device(device))
    rows, cos = [], []
    for lo in range(0, len(q), block):
        sim = _similarity(q[lo:lo + block], emb, size[lo:lo + block],
                          precision)
        top = _top(sim, n + 1)
        rows.append(top[:, :n].cpu().numpy())
        cos.append(torch.gather(sim, 1, top).double().cpu().numpy())
    return np.concatenate(rows), np.concatenate(cos)


def topn_gaps(q, db: DB, size, got, *, device="cpu", block: int = 1024):
    """For each query, how far the least float64 cosine among the rows
    `got` (Q, n) lies below the reference's n-th best: 0 where `got` is
    the reference's top n (in any order), the cosine gap of the worst
    swap where a nearer row was passed over, inf where a row repeats or
    is not live. Returns (gaps (Q,), the reference's n + 1 best cosines
    (Q, n + 1) and their rows (Q, n + 1), the nearest first)."""
    emb = _emb(db, "reference", torch.device(device))
    got = np.asarray(got, np.int64)
    n = got.shape[1]
    gaps, best, best_rows = [], [], []
    for lo in range(0, len(q), block):
        sim = _similarity(q[lo:lo + block], emb, size[lo:lo + block],
                          "reference")
        top_rows = _top(sim, min(n + 1, sim.shape[1]))
        top = torch.gather(sim, 1, top_rows)
        g = torch.as_tensor(got[lo:lo + block], device=sim.device)
        bad = (g < 0) | (g >= sim.shape[1])
        mine = torch.gather(sim, 1, g.clamp(0, sim.shape[1] - 1))
        mine = torch.where(bad, torch.full_like(mine, float("-inf")), mine)
        srt = torch.sort(g, dim=-1).values
        dup = (srt[:, 1:] == srt[:, :-1]).any(dim=-1)
        least = mine.min(dim=-1).values
        gap = torch.where(least == float("-inf"),
                          torch.full_like(least, float("inf")),
                          (top[:, n - 1] - least).clamp(min=0.0))
        gaps.append(torch.where(dup, torch.full_like(gap, float("inf")),
                                gap).cpu().numpy())
        best.append(top.cpu().numpy())
        best_rows.append(top_rows.cpu().numpy())
    return (np.concatenate(gaps), np.concatenate(best),
            np.concatenate(best_rows))


def choice_gaps(scores: np.ndarray, choices, costs, budgets) -> np.ndarray:
    """For each query, how far the reference's score of the choice lies
    below the reference's best score among the affordable models (0 for
    the best; inf for a model over the budget while one fits, or a choice
    that is not a model)."""
    costs = np.asarray(costs, np.float64)
    feas = costs[None, :] <= np.asarray(budgets, np.float64)[:, None]
    best = np.where(feas, scores, -np.inf).max(axis=1)
    choices = np.asarray(choices, np.int64)
    ok = (choices >= 0) & (choices < scores.shape[1])
    c = np.where(ok, choices, 0)
    own = scores[np.arange(len(c)), c]
    none = ~feas.any(axis=1)
    gap = np.where(ok & feas[np.arange(len(c)), c], best - own, np.inf)
    return np.where(none, np.where(c == np.argmin(costs), 0.0, np.inf), gap)
