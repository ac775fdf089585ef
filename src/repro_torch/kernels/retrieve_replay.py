"""The routing retrieval chain on the card: the fused retrieve (similarity
+ live-row mask + top-n, `retrieve_topn.topn_cuda`: two kernels, no
(Q, C) panel, no sort) -> replay kernel, which reads the neighbours'
records in place (farthest first) through the top-n rows: three launches
a route.

Composes the retrieve and the replay kernel's gather route through the
glue the plain version uses too (`ref.retrieve_replay_pipeline`), so the
two routes cannot drift. Everything between the query embeddings and the
choices stays on the device. The capacity-sharded chain
(`sharded_retrieve_replay_select_cuda`) runs the retrieve's two kernels
per shard, its merge kernel on the leader, and the replay kernel over the
merged, pre-gathered records: 2 S + 2 launches.
"""
from __future__ import annotations

from functools import partial

from repro_torch.kernels.elo_scan import (elo_scan_gather_cuda,
                                          elo_scan_gather_select_cuda,
                                          elo_scan_select_cuda)
from repro_torch.kernels.ref import (retrieve_replay_pipeline,
                                     sharded_retrieve_replay_pipeline)
from repro_torch.kernels.retrieve_topn import sharded_topn_cuda, topn_cuda


def retrieve_replay_cuda(q, emb, model_a, model_b, outcome, valid, size,
                         init_ratings, *, n, k: float = 32.0):
    """q: (Q,D); emb: (C,D); records: (C,R); size: live-row count;
    init_ratings: (M,) replay starting point.

    Returns (local_ratings (Q,M), topk_idx (Q,n), topk_scores (Q,n));
    rows past `size` score -inf and their records are masked out."""
    return retrieve_replay_pipeline(topn_cuda,
                                    partial(elo_scan_gather_cuda, k=k), q,
                                    emb, model_a, model_b, outcome, valid,
                                    size, init_ratings, n=n)


def retrieve_replay_select_cuda(q, emb, model_a, model_b, outcome, valid,
                                size, init_ratings, global_ratings, costs,
                                budgets, *, n, k: float = 32.0,
                                p: float = 0.5):
    """retrieve_replay_cuda with the budget-selection epilogue fused into
    the replay kernel. Returns (local_ratings (Q,M), topk_idx (Q,n),
    topk_scores (Q,n), choices (Q,) int32)."""
    replay = partial(elo_scan_gather_select_cuda,
                     global_ratings=global_ratings, costs=costs,
                     budgets=budgets, p=p, k=k)
    return retrieve_replay_pipeline(topn_cuda, replay, q, emb,
                                    model_a, model_b, outcome, valid, size,
                                    init_ratings, n=n)


def sharded_retrieve_replay_select_cuda(q, emb, model_a, model_b, outcome,
                                        valid, size, init_ratings,
                                        global_ratings, costs, budgets, *,
                                        n, k: float = 32.0, p: float = 0.5):
    """The capacity-sharded chain on the card (DESIGN.md §12): the fused
    retrieve on each shard's own rows (its top min(n, C_l) with their
    records) and the cross-shard merge (`retrieve_topn.sharded_topn_cuda`)
    through the glue the plain version uses too
    (`ref.sharded_retrieve_replay_pipeline`), then the replay kernel with
    its select epilogue, once on the leader, over the merged records
    pre-gathered (they come from several shards' panels, so the gather
    route, which reads one (C, R) panel, cannot take them).

    emb, model_a, model_b, outcome, valid and size are per-shard
    sequences (shard s: global rows [s*C_l, (s+1)*C_l), on its device);
    the rest lie on the leader. Returns (local (Q,M), topk_idx (Q,n)
    GLOBAL rows, topk_scores (Q,n), choices (Q,) int32)."""
    replay = partial(elo_scan_select_cuda, global_ratings=global_ratings,
                     costs=costs, budgets=budgets, p=p, k=k)
    return sharded_retrieve_replay_pipeline(sharded_topn_cuda, replay, q,
                                            emb, model_a, model_b, outcome,
                                            valid, size, init_ratings, n=n)
