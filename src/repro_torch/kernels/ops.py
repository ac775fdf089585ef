"""Dispatch over the CUDA kernels and their plain PyTorch versions.

backend:
  "cuda"       the hand-written kernel on CUDA tensors (default). Each
               wrapper takes its plain version for CPU tensors, which is
               how the port runs on the CPU.
  "reference"  the plain version on any device: only so that a check on
               the card can hold a kernel against it. Nothing on the
               routing or serving path passes it.

There is no fallback: a kernel that fails on a CUDA tensor raises.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.elo_scan import elo_scan_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.retrieve_replay import (
    retrieve_replay_cuda, retrieve_replay_select_cuda,
    sharded_retrieve_replay_select_cuda)
from repro_torch.kernels.retrieve_topn import topn_cuda
from repro_torch.kernels.similarity_topk import similarity_cuda

BACKENDS = ("cuda", "reference")


def _pick(backend: str, ref_fn, kernel_fn):
    if backend == "cuda":
        return kernel_fn
    if backend == "reference":
        return ref_fn
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def similarity(q, db, *, backend: str = "cuda"):
    """(Q,D) x (N,D) -> (Q,N) cosine scores."""
    return _pick(backend, ref.similarity_ref, similarity_cuda)(q, db)


def similarity_topk(q, db, n: int, *, backend: str = "cuda"):
    """The top min(n, N) rows of db for each query by cosine similarity,
    ties to the lowest row: the kernel pair (no panel) or the panel and
    its stable sort. Returns (top_scores, top_idx)."""
    fn = _pick(backend, ref.panel_topn_ref, topn_cuda)
    return fn(q, db, None, n)[:2]


def elo_scan(ratings, a_idx, b_idx, outcome, valid, *, k: float = 32.0,
             backend: str = "cuda"):
    """Batched ELO replay: (Q,M) ratings x (Q,T) records -> (Q,M)."""
    fn = _pick(backend, ref.elo_scan_ref, elo_scan_cuda)
    return fn(ratings, a_idx, b_idx, outcome, valid, k=k)


def retrieve_replay(q, emb, model_a, model_b, outcome, valid, size,
                    init_ratings, *, n: int, k: float = 32.0,
                    backend: str = "cuda"):
    """Returns (local_ratings (Q,M), topk_idx (Q,n), topk_scores (Q,n))."""
    fn = _pick(backend, ref.retrieve_replay_ref, retrieve_replay_cuda)
    return fn(q, emb, model_a, model_b, outcome, valid, size, init_ratings,
              n=n, k=k)


def retrieve_replay_select(q, emb, model_a, model_b, outcome, valid, size,
                           init_ratings, global_ratings, costs, budgets, *,
                           n: int, k: float = 32.0, p: float = 0.5,
                           backend: str = "cuda"):
    """retrieve_replay with the budget-selection epilogue. Returns
    (local (Q,M), topk_idx (Q,n), topk_scores (Q,n), choices (Q,))."""
    fn = _pick(backend, ref.retrieve_replay_select_ref,
               retrieve_replay_select_cuda)
    return fn(q, emb, model_a, model_b, outcome, valid, size, init_ratings,
              global_ratings, costs, budgets, n=n, k=k, p=p)


def retrieve_replay_select_sharded(q, emb, model_a, model_b, outcome,
                                   valid, size, init_ratings,
                                   global_ratings, costs, budgets, *,
                                   n: int, k: float = 32.0, p: float = 0.5,
                                   backend: str = "cuda"):
    """The capacity-sharded retrieve_replay_select (DESIGN.md §12): emb,
    model_a, model_b, outcome, valid and size are per-shard sequences
    (shard s holds global rows [s*C_l, (s+1)*C_l) on its device), the
    rest lie on shard 0's device. Returns (local (Q,M), topk_idx (Q,n)
    GLOBAL rows, topk_scores (Q,n), choices (Q,))."""
    fn = _pick(backend, ref.sharded_retrieve_replay_select_ref,
               sharded_retrieve_replay_select_cuda)
    return fn(q, emb, model_a, model_b, outcome, valid, size, init_ratings,
              global_ratings, costs, budgets, n=n, k=k, p=p)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "cuda"):
    """q: (B,S,H,dh); k/v: (B,S,Hk,dh) -> (B,S,H,dh). The kernel backend
    keeps the TPU kernel's contract that S is a multiple of its 128-row
    blocks."""
    if backend == "cuda" and (q.shape[1] % 128 or k.shape[1] != q.shape[1]):
        raise ValueError(f"flash_attention: S = {q.shape[1]} (keys "
                         f"{k.shape[1]}) is not one length, a multiple of "
                         "128")
    fn = _pick(backend, ref.flash_attention_ref, flash_attention_cuda)
    return fn(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len, *, backend: str = "cuda"):
    """q: (B,H,dh); k/v: (B,T,Hk,dh); kv_len: (B,) -> (B,H,dh). The kernel
    backend keeps the TPU kernel's contract that T is a multiple of its
    256-row blocks."""
    if backend == "cuda" and k.shape[1] % 256:
        raise ValueError(f"decode_attention: T = {k.shape[1]} is not a "
                         "multiple of 256")
    fn = _pick(backend, ref.decode_attention_ref, decode_attention_cuda)
    return fn(q, k, v, kv_len)
