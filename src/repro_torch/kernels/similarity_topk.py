"""Cosine-similarity score panel (the TPU kernel `similarity_pallas`):
its wrapper over kernel 1 of `csrc/retrieve_topn.cu` with no live-row
count, and the capacity-sharded route's plain per-shard top-k and
cross-shard merge.

No route runs `similarity_cuda`: the routing path and KNN retrieve
through `retrieve_topn.py`, whose kernel 1 is this panel with the
live-row mask. The legacy retrieval (`VectorDB.query`) and the checks
call it. The panel and a stable sort (`ref.stable_topk`, which keeps the
lowest-index-first tie order) are what the retrieve is held against,
with the capacity-sharded route's per-shard top-k and cross-shard merge
(`shard_local_topk`, `shard_merge_topk`) that `ref.sharded_panel_topn_ref`
runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import retrieve_topn as RT


def similarity_cuda(q: torch.Tensor, db: torch.Tensor, *,
                    tile: int = 0) -> torch.Tensor:
    """q: (Q, D), db: (N, D) -> (Q, N) fp32 cosine scores.

    CUDA tensors launch kernel 1 of `retrieve_topn.cu` with no live-row
    count (counted as "similarity"); CPU tensors take the plain version
    (`ref.similarity_ref`). `tile` 0 takes the retrieve's tile for Q
    (`retrieve_topn.tile_for`); 8 forces the streaming kernel and 32, 64,
    128 the GEMM of that many query rows. Scores across tiles may differ
    in the last place, so a check of the retrieve at another Q passes the
    plan's tile here."""
    if q.device.type == "cpu" and db.device.type == "cpu":
        return ref.similarity_ref(q, db)
    if not (q.is_cuda and db.is_cuda and q.device == db.device):
        raise ValueError(f"similarity_cuda: q on {q.device}, db on "
                         f"{db.device}; both must be on one CUDA device")
    if q.ndim != 2 or db.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"similarity_cuda: shapes {tuple(q.shape)} and "
                         f"{tuple(db.shape)} are not (Q, D) and (N, D)")
    out = RT.panel_launch(q, db, None, 0,
                          tile or RT.tile_for(q.shape[0], q.shape[1]))
    if out.numel():
        _build.count_launch("similarity")
    return out


# ---------------------------------------------------------------------------
# capacity-sharded retrieval: local top-k + cross-shard merge (DESIGN.md §12)
# ---------------------------------------------------------------------------

def shard_local_topk(scores: torch.Tensor, n: int):
    """Per-shard candidate reduce over a LOCAL score panel (Q, C_l): keep
    min(n, C_l) candidates, ties to the lowest local row. That k is exact:
    one shard can hold at most min(n, C_l) rows of the global top-n.
    Returns (top_scores (Q, kl), top_local_idx (Q, kl))."""
    return ref.stable_topk(scores, min(n, scores.shape[-1]))


def shard_merge_topk(top_s, top_i, payloads, n: int, device):
    """Cross-shard top-n merge on `device` (the mesh's leader): each
    shard's candidates (top_s[s], top_i[s] as GLOBAL rows, and the tuple
    payloads[s] of (Q, kl, ...) tensors carried by position) are copied
    there and pooled per query in (shard ascending, local rank ascending)
    order, the counterpart of the JAX package's all_gather; then a stable
    top-n over the pool. Under the contiguous capacity split equal scores
    sit in the pool in ascending global row, so ties (the -inf rows of a
    dead shard too) break as the single-device top-n breaks them.
    Returns (merged_s (Q, n), merged_i (Q, n), merged_payloads)."""
    def pool(parts):   # S x (Q, kl, ...) -> (Q, S*kl, ...)
        return torch.cat([p.to(device) for p in parts], dim=1)

    merged_s, pos = ref.stable_topk(pool(top_s), n)
    merged_i = torch.gather(pool(top_i), 1, pos)
    merged = []
    for field in zip(*payloads):
        x = pool(field)
        idx = pos.reshape(pos.shape + (1,) * (x.ndim - 2)).expand(
            pos.shape + x.shape[2:])
        merged.append(torch.gather(x, 1, idx))
    return merged_s, merged_i, tuple(merged)
