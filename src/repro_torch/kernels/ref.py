"""Plain PyTorch versions of every kernel of the routing and serving paths.

Ports of the jnp oracles in the JAX package's `kernels/ref.py`, formula
for formula (`norm + 1e-9`, `10 ** (d / 400)`): the CPU tests hold these
against the JAX oracle, and `chip_smoke.py` holds the CUDA kernels
against these on the card. They run on whatever device their inputs lie
on.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch


def stable_topk(scores: torch.Tensor, n: int):
    """Top-n along the last axis, ties broken toward the LOWEST index —
    the `jax.lax.top_k` contract that replay order and `topk_idx` rely
    on. `torch.topk` does not keep it (an all -inf panel comes back in
    scrambled order), a stable descending sort does."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :n], i[..., :n]


def similarity_ref(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity score panel. q: (Q,D), db: (N,D) -> (Q,N) fp32."""
    if q.is_cuda:
        # full fp32 product: a top-k over near-tied scores must agree
        # with the CPU oracle, which TF32's 10-bit mantissa does not
        torch.backends.cuda.matmul.allow_tf32 = False
    q = q.float()
    db = db.float()
    qn = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-9)
    dn = db / (torch.linalg.norm(db, dim=-1, keepdim=True) + 1e-9)
    return qn @ dn.T


def elo_scan_ref(ratings, a_idx, b_idx, outcome, valid, k: float = 32.0):
    """Batched ELO replay, one step per record column.
    ratings: (Q,M); records: (Q,T). Returns (Q,M) fp32."""
    r = ratings.float()
    m = r.shape[-1]
    a_all, b_all = a_idx.long(), b_idx.long()
    s_all, v_all = outcome.float(), valid.float()
    for i in range(a_all.shape[1]):
        a, b = a_all[:, i:i + 1], b_all[:, i:i + 1]
        r_a = torch.gather(r, 1, a)[:, 0]
        r_b = torch.gather(r, 1, b)[:, 0]
        e_a = 1.0 / (1.0 + torch.pow(10.0, (r_b - r_a) / 400.0))
        delta = k * (s_all[:, i] - e_a) * v_all[:, i]
        one_a = torch.nn.functional.one_hot(a[:, 0], m).float()
        one_b = torch.nn.functional.one_hot(b[:, 0], m).float()
        r = r + delta[:, None] * (one_a - one_b)
    return r


#: the JAX package keeps a `lax.scan` twin of elo_scan_ref for trace
#: size; eager PyTorch has no trace, so both names are the same loop
elo_replay_ref = elo_scan_ref


def gather_records(model_a, model_b, outcome, valid, idx, hit):
    """Neighbour-record gather: (Q,N) prompt rows -> flattened (Q, N*R)
    records, on the device of the panels.

    Replay order is FARTHEST neighbour first: ELO is recency-weighted,
    so the most similar prompts are replayed last to carry the most
    influence."""
    idx = torch.flip(idx, dims=[1]).long()
    hit = torch.flip(hit, dims=[1])
    nq = idx.shape[0]
    a = model_a[idx].reshape(nq, -1)
    b = model_b[idx].reshape(nq, -1)
    s = outcome[idx].reshape(nq, -1)
    v = (valid[idx] & hit[..., None]).reshape(nq, -1)
    return a, b, s, v


def budget_select_ref(scores, costs, budgets):
    """Highest-scoring model with cost <= budget, first index on ties;
    the first cheapest model when nothing fits.
    scores: (Q,M); costs: (M,); budgets: (Q,). Returns (Q,) int32."""
    feasible = costs[None, :] <= budgets[:, None]
    masked = torch.where(feasible, scores,
                         torch.full_like(scores, float("-inf")))
    choice = torch.argmax(masked, dim=-1)
    fallback = torch.argmin(costs)
    return torch.where(feasible.any(dim=-1), choice, fallback).int()


def elo_scan_gather_ref(init, panels, top_i, hit, *, k=32.0):
    """The replay stage of the retrieval chain, plain: gather each query's
    records from the (C, R) panels (model_a, model_b, outcome, valid)
    through its top-n rows (`gather_records`), then replay them from the
    (M,) prior. Returns (Q, M)."""
    a, b, s, v = gather_records(*panels, top_i, hit)
    prior = init.float().expand(top_i.shape[0], init.shape[-1])
    return elo_replay_ref(prior, a, b, s, v, k=k)


def elo_scan_gather_select_ref(init, panels, top_i, hit, global_ratings,
                               costs, budgets, *, p=0.5, k=32.0):
    """elo_scan_gather_ref with the budget-selection epilogue. Returns
    (local (Q,M), choices (Q,) int32)."""
    a, b, s, v = gather_records(*panels, top_i, hit)
    prior = init.float().expand(top_i.shape[0], init.shape[-1])
    return elo_scan_select_ref(prior, a, b, s, v, global_ratings, costs,
                               budgets, p=p, k=k)


#: the global row of a pool slot that holds no candidate: it ranks after
#: every real one (csrc/retrieve_topn.cu:EMPTY_ROW)
EMPTY_ROW = 2 ** 31 - 1


def mask_dead(scores, offset, size):
    """scores (Q, C) of global rows offset.., the rows at or past `size`
    (the live-row count; None: every row live) at -inf."""
    if size is None:
        return scores
    live = torch.arange(offset, offset + scores.shape[-1],
                        device=scores.device) < size
    return torch.where(live[None, :], scores,
                       torch.full_like(scores, float("-inf")))


def panel_topn_ref(q, emb, size, n, *, offset=0,
                   similarity_fn=similarity_ref):
    """The retrieve stage as one stable sort of the masked (Q, C) panel:
    returns (top_s (Q, k), top_i (Q, k) int64 global rows, hit (Q, k)),
    k = min(n, C); ties go to the lowest row, dead rows score -inf.
    `similarity_fn` scores the panel (the plain version, or the similarity
    kernel for the panel route on the card)."""
    scores = mask_dead(similarity_fn(q, emb), offset, size)
    top_s, top_i = stable_topk(scores, n)
    return top_s, top_i + offset, torch.isfinite(top_s)


def panel_pool_ref(scores, n, split_rows, *, offset=0):
    """A (Q, C) panel of global rows offset.. cut into splits of
    `split_rows` columns, each split's stable top-n, a split of fewer than
    n columns padded with (-inf, EMPTY_ROW): the pool (pool_s (Q, splits
    * n) fp32, pool_i (Q, splits * n) int32 global rows)."""
    parts_s, parts_i = [], []
    for c0 in range(0, scores.shape[1], split_rows):
        top_s, top_i = stable_topk(scores[:, c0:c0 + split_rows], n)
        pad = (0, n - top_s.shape[1])
        parts_s.append(torch.nn.functional.pad(top_s, pad,
                                               value=float("-inf")))
        parts_i.append(torch.nn.functional.pad(
            (top_i + c0 + offset).int(), pad, value=EMPTY_ROW))
    if not parts_s:
        return (scores.new_empty((scores.shape[0], 0)),
                torch.empty((scores.shape[0], 0), dtype=torch.int32,
                            device=scores.device))
    return torch.cat(parts_s, dim=1), torch.cat(parts_i, dim=1)


def split_topn_ref(q, emb, size, n, split_rows, *, offset=0):
    """Plain version of kernel 1 (`retrieve_topn`): the masked panel's
    pool of per-split top-n lists (`panel_pool_ref`)."""
    return panel_pool_ref(mask_dead(similarity_ref(q, emb), offset, size),
                          n, split_rows, offset=offset)


def topn_merge_ref(pool_s, pool_i, k, *, panels=None, offset=0,
                   carried=None, farthest_first=False):
    """Plain version of kernel 2 (`topn_merge`): the top k of each pool row
    in the order (score descending, global row ascending): a stable sort
    by row, then a stable sort by score. Returns (top_s (Q, k), top_i
    (Q, k) int64, hit (Q, k), records): records None, or the winners'
    (model_a, model_b, outcome, valid) records gathered by row - offset
    from the (C_l, R) `panels` or by pool position from the (Q, P, R)
    `carried`, in rank order (Q, k, R) or, with farthest_first, the
    replay's pre-gathered layout (Q, k * R), farthest first, valid &=
    hit."""
    by_row = torch.argsort(pool_i.long(), dim=-1, stable=True)
    s, o = torch.sort(torch.gather(pool_s, 1, by_row), dim=-1,
                      descending=True, stable=True)
    pos = torch.gather(by_row, 1, o[:, :k])
    top_s = s[:, :k]
    top_i = torch.gather(pool_i, 1, pos).long()
    hit = torch.isfinite(top_s)
    if panels is not None:
        recs = tuple(x[top_i - offset] for x in panels)
    elif carried is not None:
        idx = pos[..., None].expand(-1, -1, carried[0].shape[-1])
        recs = tuple(torch.gather(x, 1, idx) for x in carried)
    else:
        return top_s, top_i, hit, None
    if farthest_first:
        nq = top_s.shape[0]
        a, b, sc, v = (torch.flip(x, dims=[1]) for x in recs)
        v = v & torch.flip(hit, dims=[1])[..., None]
        recs = tuple(x.reshape(nq, -1) for x in (a, b, sc, v))
    return top_s, top_i, hit, recs


def two_stage_topn_ref(q, emb, size, n, split_rows, *, offset=0):
    """The kernels' algorithm in plain PyTorch: split_topn_ref, then
    topn_merge_ref over its pool. Equal to panel_topn_ref exactly: the
    order is a strict total order (every candidate its own row), so the
    top-n of the union is the top-n of the splits' top-n."""
    pool_s, pool_i = split_topn_ref(q, emb, size, n, split_rows,
                                    offset=offset)
    return topn_merge_ref(pool_s, pool_i, min(n, emb.shape[0]))[:3]


def retrieve_replay_pipeline(retrieve_fn, replay_fn, q, emb, model_a,
                             model_b, outcome, valid, size, init_ratings,
                             *, n):
    """The retrieval chain — live-row masked top-n by similarity -> replay
    of the neighbours' records, farthest first, from the prior — with the
    two stages injected, so the plain and the kernel routes share ONE
    copy of the glue.

    retrieve_fn(q, emb, size, n) returns (top_s, top_i, hit): the panel
    and its stable sort (`panel_topn_ref`), or the kernel pair
    (`retrieve_topn.topn_cuda`). replay_fn(init_ratings, (model_a,
    model_b, outcome, valid), top_i, hit) gathers and replays
    (`elo_scan_gather_ref`, or the kernel's fused gather); it returns
    `local` or a `(local, *extras)` tuple, whose extras are appended to
    the returned (local, topk_idx, topk_scores)."""
    top_s, top_i, hit = retrieve_fn(q, emb, size, n)
    out = replay_fn(init_ratings, (model_a, model_b, outcome, valid), top_i,
                    hit)
    local, extras = (out[0], tuple(out[1:])) if isinstance(out, tuple) \
        else (out, ())
    return (local, top_i, top_s) + extras


def retrieve_replay_ref(q, emb, model_a, model_b, outcome, valid, size,
                        init_ratings, *, n, k=32.0):
    """Returns (local (Q,M), topk_idx (Q,n), topk_scores (Q,n))."""
    return retrieve_replay_pipeline(
        panel_topn_ref, partial(elo_scan_gather_ref, k=k), q, emb, model_a,
        model_b, outcome, valid, size, init_ratings, n=n)


def elo_scan_select_ref(ratings, a_idx, b_idx, outcome, valid,
                        global_ratings, costs, budgets, *, p=0.5, k=32.0):
    """Replay + budget-selection epilogue: Score = p*Global + (1-p)*Local,
    then budget_select_ref. Returns (local (Q,M), choices (Q,) int32)."""
    local = elo_replay_ref(ratings, a_idx, b_idx, outcome, valid, k=k)
    combined = p * global_ratings[None, :].float() + (1.0 - p) * local
    return local, budget_select_ref(combined, costs.float(), budgets.float())


def retrieve_replay_select_ref(q, emb, model_a, model_b, outcome, valid,
                               size, init_ratings, global_ratings, costs,
                               budgets, *, n, k=32.0, p=0.5):
    """retrieve_replay with the budget-selection epilogue. Returns
    (local (Q,M), topk_idx (Q,n), topk_scores (Q,n), choices (Q,))."""
    replay = partial(elo_scan_gather_select_ref,
                     global_ratings=global_ratings, costs=costs,
                     budgets=budgets, p=p, k=k)
    return retrieve_replay_pipeline(
        panel_topn_ref, replay, q, emb, model_a, model_b, outcome, valid,
        size, init_ratings, n=n)


def sharded_panel_topn_ref(q, emb, panels, size, n, *,
                           similarity_fn=similarity_ref):
    """The capacity-sharded retrieve stage (DESIGN.md §12) with a panel
    and a stable sort per shard: per shard s, the masked panel of its rows
    (global rows [s*C_l, (s+1)*C_l)), its stable top min(n, C_l)
    (`shard_local_topk`) and their records gathered from its panels; on
    the leader (q's device), the merge (`shard_merge_topk`, records
    carried by position) and the farthest-first flatten. emb, the four
    `panels` (model_a, model_b, outcome, valid) and size are per-shard
    sequences. Returns (top_s (Q, k), top_i (Q, k) int64 global rows,
    hit, (a, b, s, v) (Q, k * R) farthest first, valid &= hit)."""
    from repro_torch.kernels.similarity_topk import (shard_local_topk,
                                                     shard_merge_topk)
    leader = q.device
    c_local = emb[0].shape[0]
    cand_s, cand_i, records = [], [], []
    for s, e in enumerate(emb):
        offset = s * c_local
        scores = mask_dead(similarity_fn(q.to(e.device), e), offset,
                           size[s])
        loc_s, loc_i = shard_local_topk(scores, n)
        cand_s.append(loc_s)
        cand_i.append(loc_i + offset)
        records.append(tuple(x[s][loc_i] for x in panels))
    top_s, top_i, (ca, cb, cs, cv) = shard_merge_topk(
        cand_s, cand_i, records, n, leader)
    hit = torch.isfinite(top_s)
    nq = q.shape[0]
    # farthest-first flatten of the MERGED candidates: gather_records'
    # replay order, minus the row gather the shards already did
    a = torch.flip(ca, dims=[1]).reshape(nq, -1)
    b = torch.flip(cb, dims=[1]).reshape(nq, -1)
    s = torch.flip(cs, dims=[1]).reshape(nq, -1)
    v = (torch.flip(cv, dims=[1])
         & torch.flip(hit, dims=[1])[..., None]).reshape(nq, -1)
    return top_s, top_i, hit, (a, b, s, v)


def sharded_retrieve_replay_pipeline(retrieve_fn, replay_fn, q, emb,
                                     model_a, model_b, outcome, valid,
                                     size, init_ratings, *, n):
    """The capacity-sharded retrieval chain (DESIGN.md §12), driven by one
    process over every shard, the counterpart of the JAX package's
    per-shard body under shard_map. emb, model_a, model_b, outcome and
    valid are sequences of S per-shard tensors, shard s holding global
    rows [s*C_l, (s+1)*C_l) on its device; size[s] is the live-row count
    on shard s's device; q and init_ratings lie on shard 0's device (the
    leader). Stages:

      retrieve_fn(q, emb, (model_a, model_b, outcome, valid), size, n):
      per shard its top min(n, C_l) candidates with their records, the
      merge on the leader, the merged records in the replay's
      pre-gathered layout (`sharded_panel_topn_ref`, or the kernel pair:
      `retrieve_topn.sharded_topn_cuda`);
      on the leader: the replay from the broadcast prior (+ epilogue).

    The replay reads pre-gathered (Q, n*R) records: the merged winners'
    records come from several shards' panels. Equal to
    retrieve_replay_pipeline over the whole panels bit for bit, as long
    as a shard's rows score as they score in the whole (one allocation
    per shard). Both routes share this one copy of the glue. Returns
    (local, topk_idx (GLOBAL rows), topk_scores) + the replay's
    extras."""
    top_s, top_i, _, (a, b, s, v) = retrieve_fn(
        q, emb, (model_a, model_b, outcome, valid), size, n)
    nq = q.shape[0]
    init = init_ratings.float().expand(nq, init_ratings.shape[-1])
    out = replay_fn(init, a, b, s, v)
    local, extras = (out[0], tuple(out[1:])) if isinstance(out, tuple) \
        else (out, ())
    return (local, top_i, top_s) + extras


def sharded_retrieve_replay_select_ref(q, emb, model_a, model_b, outcome,
                                       valid, size, init_ratings,
                                       global_ratings, costs, budgets, *,
                                       n, k=32.0, p=0.5):
    """The sharded chain with the budget-selection epilogue, plain. The
    per-shard arguments as in sharded_retrieve_replay_pipeline;
    global_ratings, costs and budgets on the leader. Returns (local
    (Q,M), topk_idx (Q,n) GLOBAL rows, topk_scores, choices (Q,))."""
    replay = partial(elo_scan_select_ref, global_ratings=global_ratings,
                     costs=costs, budgets=budgets, p=p, k=k)
    return sharded_retrieve_replay_pipeline(
        sharded_panel_topn_ref, replay, q, emb, model_a, model_b, outcome,
        valid, size, init_ratings, n=n)


def elo_fold_host(ratings, a_idx, b_idx, outcome, valid, *, k=32.0,
                  dtype=np.float32):
    """One query's replay on the host, a scalar at a time in `dtype`
    (numpy float32 or float64 scalars), the plain formula
    1 / (1 + 10 ** ((r_b - r_a) / 400)): the yardstick of a fold too long
    for the plain version's per-step launches (the fit's 262,144 steps
    take well under a second). A record with valid False, or with
    a == b, changes nothing, as in the replay. Returns (M,) in `dtype`."""
    r = [dtype(x) for x in np.asarray(ratings).reshape(-1)]
    one, ten, c400, kk = dtype(1), dtype(10), dtype(400), dtype(k)
    for ai, bi, si, vi in zip(np.asarray(a_idx).tolist(),
                              np.asarray(b_idx).tolist(),
                              np.asarray(outcome, dtype).tolist(),
                              np.asarray(valid).tolist()):
        if not vi or ai == bi:
            continue
        ra, rb = r[ai], r[bi]
        delta = kk * (dtype(si) - one / (one + ten ** ((rb - ra) / c400)))
        r[ai] = ra + delta
        r[bi] = rb - delta
    return np.asarray(r, dtype)


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, T, Hk, dh) -> (B, T, Hk * rep, dh): query head h reads KV head
    h // rep (`jnp.repeat` along the head axis)."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B,S,H,dh), k/v: (B,T,Hk,dh). fp32 softmax; causal masks are
    bottom-right aligned; `window` > 0 keeps the last `window` keys of
    each row. `scale` defaults to dh ** -0.5. Returns (B,S,H,dh) in q's
    type. A row with no key left is NaN (softmax of all -inf)."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = dh ** -0.5 if scale is None else scale
    kk = _repeat_kv(k, rep).float()
    vv = _repeat_kv(v, rep).float()
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kk) * scale
    if causal:
        qp = torch.arange(s, device=q.device)[:, None]
        kp = torch.arange(t, device=q.device)[None, :]
        mask = kp <= qp + (t - s)
        if window:
            mask &= kp > qp + (t - s) - window
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, float("-inf")))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w, vv).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len, *, scale=None):
    """Single-token decode. q: (B,H,dh); k/v: (B,T,Hk,dh); kv_len: (B,)
    number of valid cache entries per sequence. Returns (B,H,dh) in q's
    type."""
    b, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = dh ** -0.5 if scale is None else scale
    kk = _repeat_kv(k, rep).float()
    vv = _repeat_kv(v, rep).float()
    scores = torch.einsum("bhd,bthd->bht", q.float(), kk) * scale
    mask = torch.arange(t, device=q.device)[None, :] < \
        kv_len.to(q.device)[:, None]
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, float("-inf")))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bthd->bhd", w, vv).to(q.dtype)
