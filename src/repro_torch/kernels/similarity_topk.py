"""Cosine-similarity score panel: the CUDA kernel `csrc/similarity.cu`
(port of the TPU kernel `similarity_pallas`) and its wrapper.

The top-k over the panel stays in PyTorch (`ref.stable_topk`): a stable
descending sort, which keeps the lowest-index-first tie order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def similarity_cuda(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """q: (Q, D), db: (N, D) -> (Q, N) fp32 cosine scores.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.similarity_ref`)."""
    if q.device.type == "cpu" and db.device.type == "cpu":
        return ref.similarity_ref(q, db)
    if not (q.is_cuda and db.is_cuda and q.device == db.device):
        raise ValueError(f"similarity_cuda: q on {q.device}, db on "
                         f"{db.device}; both must be on one CUDA device")
    if q.ndim != 2 or db.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"similarity_cuda: shapes {tuple(q.shape)} and "
                         f"{tuple(db.shape)} are not (Q, D) and (N, D)")
    q = q.float().contiguous()
    db = db.float().contiguous()
    nq, d = q.shape
    n = db.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library("similarity")
    err = lib.similarity_launch(q.data_ptr(), db.data_ptr(), out.data_ptr(),
                                nq, n, d, _build.stream_handle(q.device))
    _build.check(err, "similarity_cuda")
    _build.count_launch("similarity")
    return out
