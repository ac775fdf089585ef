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


#: a global row past every real one: a pool slot that holds no candidate
#: ranks after every real one (csrc/retrieve_topn.cu:EMPTY_ROW)
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
    kernel at the retrieve's tile on the card)."""
    scores = mask_dead(similarity_fn(q, emb), offset, size)
    top_s, top_i = stable_topk(scores, n)
    return top_s, top_i + offset, torch.isfinite(top_s)


def topn_merge_ref(pool_s, pool_i, k, *, row0=0, panels=None, offset=0,
                   carried=None, farthest_first=False):
    """Plain version of kernel 2 (`topn_merge`) by stable sorts: the top k
    of each pool row in the order (score descending, global row
    ascending): a stable sort by row, then a stable sort by score (pool_i
    None: a panel, column x global row row0 + x, so one stable sort by
    score). Equal to the select (`topn_select_ref`) exactly. Returns
    (top_s (Q, k), top_i (Q, k) int64, hit (Q, k), records): records None,
    or the winners' (model_a, model_b, outcome, valid) records gathered by
    row - offset from the (C_l, R) `panels` or by pool position from the
    (Q, P, R) `carried`, in rank order (Q, k, R) or, with farthest_first,
    the replay's pre-gathered layout (Q, k * R), farthest first, valid &=
    hit."""
    if pool_i is None:
        pos = stable_topk(pool_s, k)[1]
    else:
        by_row = torch.argsort(pool_i.long(), dim=-1, stable=True)
        _, o = torch.sort(torch.gather(pool_s, 1, by_row), dim=-1,
                          descending=True, stable=True)
        pos = torch.gather(by_row, 1, o[:, :k])
    return _winners(pool_s, pool_i, pos, row0, panels, offset, carried,
                    farthest_first)


def _winners(pool_s, pool_i, pos, row0, panels, offset, carried,
             farthest_first):
    """Kernel 2's outputs for the winners at pool positions `pos` (Q, k),
    in rank order (pool_i None: position x is global row row0 + x)."""
    top_s = torch.gather(pool_s, 1, pos)
    top_i = pos + row0 if pool_i is None \
        else torch.gather(pool_i, 1, pos).long()
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


#: kernel 2's select: 11-bit digits of each 32-bit word, most significant
#: first (shift, bins)
SELECT_DIGITS = ((21, 2048), (10, 2048), (0, 1024))
_WORD = 0xFFFFFFFF


def select_words(pool_s, pool_i, row0=0):
    """The three 32-bit words (as int64) of each entry's key, which orders
    like the ranking: the score's bits made order-preserving (-0.0 as
    0.0), the global row complemented (the lower row ranks first; pool_i
    None: row0 + position), the position complemented (equal (score, row)
    pairs in position order)."""
    bits = pool_s.contiguous().view(torch.int32).long() & _WORD
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    w0 = torch.where(bits >= 0x80000000, ~bits & _WORD, bits | 0x80000000)
    pos = torch.arange(pool_s.shape[1], device=pool_s.device).expand_as(w0)
    rows = pos + row0 if pool_i is None else pool_i.long()
    return w0, ~rows & _WORD, ~pos & _WORD


def key_select_ref(pool_s, pool_i, k, *, row0=0):
    """Kernel 2's select (`topn_select_kernel`), plain: per query row a
    radix select over the key's words (`select_words`) by SELECT_DIGITS,
    each pass histogramming the digit of the entries that match the
    digits fixed so far and fixing the digit of the bin that holds the
    k-th largest, until that bin holds exactly the entries still needed;
    then the entries at or above that prefix (exactly k), sorted by key
    descending. Returns (positions (Q, k) in rank order, passes (Q,) the
    radix passes each row took)."""
    words = select_words(pool_s, pool_i, row0)
    nq, dev = pool_s.shape[0], pool_s.device
    prefix = torch.zeros((nq, 3), dtype=torch.long, device=dev)
    mask = torch.zeros((nq, 3), dtype=torch.long, device=dev)
    need = torch.full((nq,), k, dtype=torch.long, device=dev)
    done = torch.zeros(nq, dtype=torch.bool, device=dev)
    passes = torch.zeros(nq, dtype=torch.long, device=dev)
    for w in range(3):
        for shift, bins in SELECT_DIGITS:
            match = torch.ones_like(words[0], dtype=torch.bool)
            for v in range(w + 1):
                match &= (words[v] & mask[:, v:v + 1]) == prefix[:, v:v + 1]
            digit = (words[w] >> shift) & (bins - 1)
            hist = torch.zeros((nq, bins), dtype=torch.long, device=dev)
            hist.scatter_add_(1, digit, match.long())
            suffix = hist.flip(1).cumsum(1).flip(1)
            at = ((suffix >= need[:, None]).sum(1) - 1).clamp(min=0)
            above = torch.where(at + 1 < bins, suffix.gather(
                1, (at + 1).clamp(max=bins - 1)[:, None])[:, 0], 0)
            bucket = hist.gather(1, at[:, None])[:, 0]
            live = ~done
            prefix[:, w] += torch.where(live, at << shift, 0)
            mask[:, w] |= torch.where(live, torch.full_like(at, (
                bins - 1) << shift), 0)
            need -= torch.where(live, above, 0)
            passes += live.long()
            done |= bucket == need
    a = [words[v] & mask[:, v:v + 1] for v in range(3)]
    p = [prefix[:, v:v + 1] for v in range(3)]
    take = (a[0] > p[0]) | ((a[0] == p[0]) & (
        (a[1] > p[1]) | ((a[1] == p[1]) & (a[2] >= p[2]))))
    if not bool((take.sum(1) == k).all()):
        raise AssertionError("key_select_ref: the prefix does not hold k "
                             "entries")
    pos = take.nonzero()[:, 1].reshape(nq, k)
    for word in (words[1], words[0]):       # stable: key descending
        order = torch.sort(torch.gather(word, 1, pos), dim=1,
                           descending=True, stable=True)[1]
        pos = torch.gather(pos, 1, order)
    return pos, passes


def topn_select_ref(pool_s, pool_i, k, *, row0=0, panels=None, offset=0,
                    carried=None, farthest_first=False):
    """Plain version of kernel 2 by selection (`topn_select_kernel`): the
    top k of each pool row (pool_i None: a panel, column x global row row0
    + x) by `key_select_ref`, and kernel 2's outputs, as `topn_merge_ref`
    returns them."""
    pos = key_select_ref(pool_s, pool_i, k, row0=row0)[0]
    return _winners(pool_s, pool_i, pos, row0, panels, offset, carried,
                    farthest_first)


def panel_ref(q, emb, size, *, offset=0):
    """Plain version of kernel 1 (`retrieve_topn`): the (Q, C) score panel
    of global rows offset.., rows at or past `size` at -inf."""
    return mask_dead(similarity_ref(q, emb), offset, size)


def panel_select_topn_ref(q, emb, size, n, *, offset=0):
    """The retrieve in plain PyTorch: panel_ref, then topn_select_ref
    over it. Returns (top_s (Q, k), top_i (Q, k) int64 global rows, hit),
    k = min(n, C): panel_topn_ref's result, exactly."""
    k = min(n, emb.shape[0])
    panel = panel_ref(q, emb, size, offset=offset)
    return topn_select_ref(panel, None, k, row0=offset)[:3]


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
    """q: (B,S,H,dk), k: (B,T,Hk,dk), v: (B,T,Hk,dv). fp32 softmax; causal
    masks are bottom-right aligned; `window` > 0 keeps the last `window`
    keys of each row. `scale` defaults to dk ** -0.5. Returns (B,S,H,dv)
    in q's type. A row with no key left is NaN (softmax of all -inf)."""
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


def decode_attention_ref(q, k, v, kv_len, *, scale=None, window=0):
    """Single-token decode. q: (B,H,dh); k/v: (B,T,Hk,dh); kv_len: (B,)
    number of valid cache entries per sequence. `window` > 0 keeps only
    rows r with kv_len - window <= r < kv_len: the query at position
    kv_len - 1 under the causal window of `flash_attention_ref`. Returns
    (B,H,dh) in q's type."""
    b, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = dh ** -0.5 if scale is None else scale
    kk = _repeat_kv(k, rep).float()
    vv = _repeat_kv(v, rep).float()
    scores = torch.einsum("bhd,bthd->bht", q.float(), kk) * scale
    rows = torch.arange(t, device=q.device)[None, :]
    lens = kv_len.to(q.device)[:, None]
    mask = rows < lens
    if window:
        mask &= rows >= lens - window
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, float("-inf")))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bthd->bhd", w, vv).to(q.dtype)
