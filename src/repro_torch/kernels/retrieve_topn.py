"""The routing path's retrieve stage: the CUDA kernels of
`csrc/retrieve_topn.cu` (with the replay kernel, the port of the TPU
kernel `similarity_pallas` and the top-k after it on the routing path,
and of the sharded composite's reduce and merge), their wrappers, and the
compositions the routes call.

  retrieve_topn_cuda  kernel 1: the (Q, C) similarity panel, rows past
                      the live-row count at -inf
  topn_merge_cuda     kernel 2: the top-k of each row of a panel (the
                      unsharded reduce) or of a pool of explicit rows
                      with records carried by pool position (the
                      cross-shard merge), by a radix select
  shard_reduce_cuda   kernel 2 on a shard: its top min(n, C_l) with the
                      candidates' records gathered from its panels
  topn_cuda           the unsharded retrieve: kernel 1, kernel 2
  sharded_topn_cuda   the capacity-sharded retrieve: per shard kernel 1
                      and shard_reduce_cuda into the leader's pool, then
                      merge_shards_cuda (kernel 2) on the leader

This is the TPU kernel's own shape: the panel, then `lax.top_k`.
Candidates are ranked by (score descending, global row ascending),
scores compared as floats. Every candidate has its own row, so the order
is a strict total order and the top-n of a union is the top-n of the
parts' top-n: the unsharded and the sharded retrieve equal one stable
sort of the whole masked panel (`ref.panel_topn_ref`), ties and dead
rows included.

CUDA tensors launch the kernels, and n is at most MAX_N (512, the replay
kernel's `elo_scan.MAX_NEIGHBOURS`) there; CPU tensors take the plain
versions through the same glue: kernel 1's (`ref.panel_ref`), then kernel
2's stable sorts (`ref.topn_merge_ref`; `ref.topn_select_ref`, the
select's mirror, returns the same, and the tests hold the two equal).
Nothing here reads `size` on the host or branches on data, so the
retrieve captures into CUDA graphs: a commit changes the live-row count
in place, and the next replay reads it on the device. The panel comes
from the caching allocator and is freed once kernel 2 has read it, so
the graphs of one memory pool hold about one largest panel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

#: the largest n the kernels take: the replay kernel's bound (the paper's
#: ablation, Fig. 4, routes with up to 80 neighbours; the JAX package has
#: no bound)
MAX_N = 512
#: the streaming kernel's query rows; a block's shared memory
QT = 8
MAX_SMEM = 227 * 1024
#: the route: the panel, then the select
PANEL = "panel"
#: the records' element types (core/state.py's DB panels)
RECORD_DTYPES = (torch.int32, torch.int32, torch.float32, torch.bool)


def gemv_smem(d: int) -> int:
    """Shared memory of the streaming kernel (`similarity_tile.cuh:
    gemv_smem`): QT query rows and their norms."""
    return (QT * d + QT) * 4


def tile_for(nq: int, d: int) -> int:
    """Kernel 1's tile: the streaming kernel (8) for Q <= 8 while its
    queries fit in shared memory, else the GEMM with 32, 64 or 128 query
    rows."""
    if nq <= QT and gemv_smem(d) <= MAX_SMEM:
        return QT
    return 32 if nq <= 32 else 64 if nq <= 64 else 128


class Plan(NamedTuple):
    """Kernel 1's tile, and the route."""
    tile: int
    route: str


def plan(nq: int, c: int, d: int, n: int = 1) -> Plan:
    """The retrieve of n neighbours over C >= 1 rows: the panel route, at
    `tile_for`'s tile, at every shape. Timed beside a route that kept a
    top-n per column split in kernel 1 and merged the splits' lists
    (`scripts/retrieve_rows.py`; PERF.md's kernel table), the panel route
    was at or under it at n = 20 at every bucket of the ladder over C =
    32768, at buckets 8, 64 and 1024 over C = 65536, and on 1, 2 and 4
    shards, bit-equal. The plan depends on nothing but the shape, never
    on `size` or on data, so a captured graph holds it."""
    return Plan(tile_for(nq, d), PANEL)


def check_neighbours(n: int, device) -> None:
    """Raise if a route of n neighbours on `device` would exceed the
    kernels' bound (CUDA only; the plain versions take any n). Called
    where a router or a dispatcher is built, ahead of its first route."""
    if torch.device(device).type == "cuda" and n > MAX_N:
        raise ValueError(f"n_neighbors = {n}: the CUDA retrieve keeps at "
                         f"most {MAX_N} neighbours a query")


def _check_on(name, dev, *xs):
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: inputs on "
                         f"{sorted({str(x.device) for x in xs})}; all must "
                         "be on one CUDA device")


def _size_arg(size, dev) -> Optional[torch.Tensor]:
    """The live-row count as an int32 scalar on `dev` (read there by the
    kernel); None: every row live."""
    if size is None:
        return None
    if not torch.is_tensor(size):
        return torch.tensor(int(size), dtype=torch.int32, device=dev)
    if size.device != dev or size.numel() != 1:
        raise ValueError(f"retrieve_topn_cuda: size {tuple(size.shape)} on "
                         f"{size.device}, not one count on {dev}")
    return size if size.dtype == torch.int32 else size.to(torch.int32)


def retrieve_topn_cuda(q: torch.Tensor, emb: torch.Tensor, size, *,
                       offset: int = 0) -> torch.Tensor:
    """Kernel 1. q: (Q, D); emb: (C, D), global rows offset..offset+C-1;
    size: the live-row count (global rows at or past it score -inf; a
    device int32 scalar the kernel reads, or None: every row live).

    Returns the masked (Q, C) fp32 panel (column x is global row offset +
    x), scored at `tile_for`'s tile. CUDA tensors launch the kernel; CPU
    tensors take `ref.panel_ref`."""
    nq, c = q.shape[0], emb.shape[0]
    if q.device.type == "cpu" and emb.device.type == "cpu":
        return ref.panel_ref(q, emb, size, offset=offset)
    name = "retrieve_topn_cuda"
    _check_on(name, q.device, q, emb)
    if q.ndim != 2 or emb.ndim != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} and "
                         f"{tuple(emb.shape)} are not (Q, D) and (C, D)")
    live = _size_arg(size, q.device)
    panel = panel_launch(q, emb, None if live is None else live.data_ptr(),
                         offset, tile_for(nq, q.shape[1]))
    if panel.numel():
        _build.count_launch("retrieve_topn")
    return panel


def panel_launch(q, emb, size_ptr, offset: int, tile: int) -> torch.Tensor:
    """Kernel 1's launch on CUDA tensors, uncounted: the (Q, C) panel of
    q against emb at `tile`, rows at or past *size_ptr at -inf (None:
    none). The wrappers count their launches."""
    q = q.float().contiguous()
    emb = emb.float().contiguous()
    (nq, d), c = q.shape, emb.shape[0]
    panel = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    if panel.numel():
        err = _build.library("retrieve_topn").retrieve_panel_launch(
            q.data_ptr(), emb.data_ptr(), nq, c, d, offset, size_ptr, tile,
            panel.data_ptr(), _build.stream_handle(q.device))
        _build.check(err, "retrieve_panel_launch")
    return panel


def _check_pool(name, pool_s, pool_i, k):
    if pool_s.ndim != 2 or (pool_i is not None
                            and pool_i.shape != pool_s.shape):
        raise ValueError(f"{name}: pools {tuple(pool_s.shape)} and "
                         f"{None if pool_i is None else tuple(pool_i.shape)}"
                         " are not one (Q, P)")
    if pool_s.dtype != torch.float32 or pool_s.stride(1) != 1 or (
            pool_i is not None and (pool_i.dtype != torch.int32
                                    or pool_i.stride(1) != 1
                                    or pool_s.stride(0) != pool_i.stride(0))):
        raise ValueError(f"{name}: the pool must be fp32 scores and int32 "
                         "rows, unit column stride, one row stride")
    if not 1 <= k <= min(MAX_N, pool_s.shape[1]):
        raise ValueError(f"{name}: k = {k} of a pool of "
                         f"{pool_s.shape[1]} (at most {MAX_N})")


def _check_records(name, recs):
    for x, dt in zip(recs, RECORD_DTYPES):
        if x.dtype != dt or x.stride(-1) != 1:
            raise ValueError(f"{name}: records of {[x.dtype for x in recs]}"
                             ", unit column stride; the kernel takes int32, "
                             "int32, float32, bool")


def _merge_launch(pool_s, pool_i, k, row0, top_s, top_i, hit, src=None,
                  by_row=0, offset=0, ld_src=0, dst=None, farthest=0,
                  ld_dst=0):
    nq, p = pool_s.shape
    r = src[0].shape[-1] if src is not None else 0
    ptr = (lambda xs: [x.data_ptr() for x in xs] if xs is not None
           else [None] * 4)
    dev = pool_s.device
    lib = _build.library("retrieve_topn")
    err = lib.topn_merge_launch(
        pool_s.data_ptr(), None if pool_i is None else pool_i.data_ptr(), nq,
        p, pool_s.stride(0), row0, k, top_s.data_ptr(), top_i.data_ptr(),
        int(top_i.dtype == torch.int64), top_s.stride(0),
        None if hit is None else hit.data_ptr(), *ptr(src), r, by_row,
        offset, ld_src, *ptr(dst), farthest, ld_dst,
        _build.stream_handle(dev))
    _build.check(err, "topn_merge_cuda")
    _build.count_launch("topn_merge")


def topn_merge_cuda(pool_s: torch.Tensor, pool_i: Optional[torch.Tensor],
                    k: int, *, carried=None, offset: int = 0):
    """Kernel 2: the top k of each row of a (Q, P) candidate pool (pool_s
    fp32, pool_i int32 global rows, any row stride; pool_i None: a panel,
    column x global row offset + x) in the order (score descending, row
    ascending), by a radix select.

    Returns (top_s (Q, k), top_i (Q, k) int64, hit (Q, k) bool) and, with
    `carried` = the pool's (model_a, model_b, outcome, valid) records, each
    (Q, P, R), the winners' records in the replay's pre-gathered layout:
    (Q, k * R) each, farthest first, valid &= hit. CPU tensors take
    `ref.topn_merge_ref` (stable sorts, equal to the select)."""
    if pool_s.device.type == "cpu":
        out = ref.topn_merge_ref(pool_s, pool_i, k, row0=offset,
                                 carried=carried, farthest_first=True)
        return out[:3] if carried is None else out
    name = "topn_merge_cuda"
    _check_on(name, pool_s.device, pool_s,
              *(() if pool_i is None else (pool_i,)), *(carried or ()))
    dev, nq = pool_s.device, pool_s.shape[0]
    top_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((nq, k), dtype=torch.int64, device=dev)
    hit = torch.empty((nq, k), dtype=torch.bool, device=dev)
    recs = None
    if carried is not None:
        _check_records(name, carried)
        r = carried[0].shape[-1]
        recs = tuple(torch.empty((nq, k * r), dtype=x.dtype, device=dev)
                     for x in carried)
    if nq and k:
        _check_pool(name, pool_s, pool_i, k)
        if carried is None:
            _merge_launch(pool_s, pool_i, k, offset, top_s, top_i,
                          hit.view(torch.uint8))
        else:
            _merge_launch(pool_s, pool_i, k, offset, top_s, top_i,
                          hit.view(torch.uint8), src=_bytes(carried),
                          ld_src=carried[0].stride(0), dst=_bytes(recs),
                          farthest=1, ld_dst=recs[0].stride(0))
    return (top_s, top_i, hit) if recs is None else (top_s, top_i, hit, recs)


def _bytes(recs):
    """The records with `valid` viewed as bytes, as the kernel reads it."""
    return tuple(recs[:3]) + (recs[3].view(torch.uint8),)


def shard_reduce_cuda(panel, k: int, panels, offset: int, *, out=None):
    """Kernel 2 on a shard: the top k of its masked panel (kernel 1's,
    column x global row offset + x) with each winner's records gathered
    from the shard's (C_l, R) `panels` (model_a, model_b, outcome, valid)
    at row - offset, in rank order. Writes
    (cand_s (Q, k) fp32, cand_i (Q, k) int32 global rows, records (Q, k,
    R) each) into `out` (views, e.g. the shard's columns of the leader's
    pool) or new tensors, and returns them. CPU tensors take kernel 2's
    plain version."""
    nq, r = panel.shape[0], panels[0].shape[-1]
    dev = panel.device
    if out is None:
        out = (torch.empty((nq, k), dtype=torch.float32, device=dev),
               torch.empty((nq, k), dtype=torch.int32, device=dev),
               tuple(torch.empty((nq, k, r), dtype=x.dtype, device=dev)
                     for x in panels))
    cand_s, cand_i, recs = out
    if dev.type == "cpu":
        top_s, top_i, _, got = ref.topn_merge_ref(
            panel, None, k, row0=offset, panels=panels, offset=offset)
        cand_s.copy_(top_s)
        cand_i.copy_(top_i)
        for x, y in zip(recs, got):
            x.copy_(y)
        return out
    name = "shard_reduce_cuda"
    _check_on(name, dev, panel, *panels, cand_s, cand_i, *recs)
    _check_records(name, panels)
    _check_records(name, recs)
    if any(x.stride(1) != r for x in recs) or cand_s.stride(1) != 1 or \
            cand_i.stride(0) != cand_s.stride(0) or cand_i.stride(1) != 1 \
            or any(x.stride(0) != recs[0].stride(0) for x in recs):
        raise ValueError(f"{name}: outputs not laid out as (Q, k) and "
                         "(Q, k, R) rows")
    if nq and k:
        _check_pool(name, panel, None, k)
        _merge_launch(panel, None, k, offset, cand_s, cand_i, None,
                      src=_bytes(panels), by_row=1, offset=offset,
                      dst=_bytes(recs), ld_dst=recs[0].stride(0))
    return out


def topn_cuda(q, emb, size, n: int):
    """The unsharded retrieve: kernel 1, then kernel 2 over its panel.
    Returns (top_s (Q, k), top_i (Q, k) int64, hit (Q, k)), k = min(n,
    C): what `ref.panel_topn_ref` returns, exactly."""
    return topn_merge_cuda(retrieve_topn_cuda(q, emb, size), None,
                           min(n, emb.shape[0]))


def merge_shards_cuda(pool_s, pool_i, records, n: int):
    """The cross-shard merge on the leader: kernel 2 over the shards'
    pooled candidates (`sharded_topn_cuda`'s pool), their records carried
    by pool position. Returns topn_merge_cuda's (top_s, top_i, hit,
    records in the replay's layout)."""
    return topn_merge_cuda(pool_s, pool_i, min(n, pool_s.shape[1]),
                           carried=records)


def sharded_topn_cuda(q, emb, panels, size, n: int):
    """The capacity-sharded retrieve (DESIGN.md §12). emb, the four
    `panels` (model_a, model_b, outcome, valid) and size are per-shard
    sequences, shard s holding global rows [s*C_l, (s+1)*C_l) on its
    device; q lies on the leader. Per shard: kernel 1, then kernel 2's
    reduce to min(n, C_l) candidates with their records, written into the
    shard's columns of the leader's pool (copied there from another
    card); then the merge (`merge_shards_cuda`) on the leader. Returns
    (top_s (Q, k), top_i (Q, k) int64 global rows, hit, (a, b, s, v) in
    the replay's pre-gathered layout), k = min(n, C): what
    `ref.sharded_panel_topn_ref` returns, exactly."""
    leader = q.device
    c_local, nq = emb[0].shape[0], q.shape[0]
    kl, r = min(n, c_local), panels[0][0].shape[1]
    width = len(emb) * kl
    pool_s = torch.empty((nq, width), dtype=torch.float32, device=leader)
    pool_i = torch.empty((nq, width), dtype=torch.int32, device=leader)
    recs = tuple(torch.empty((nq, width, r), dtype=x[0].dtype, device=leader)
                 for x in panels)
    for s, e in enumerate(emb):
        cols = slice(s * kl, (s + 1) * kl)
        dst = (pool_s[:, cols], pool_i[:, cols],
               tuple(x[:, cols] for x in recs))
        here = e.device == leader
        panel = retrieve_topn_cuda(q if here else q.to(e.device), e,
                                   size[s], offset=s * c_local)
        got = shard_reduce_cuda(panel, kl, tuple(x[s] for x in panels),
                                s * c_local, out=dst if here else None)
        del panel          # freed before the next shard's is made
        if not here:
            for x, y in zip(dst[:2] + dst[2], got[:2] + got[2]):
                x.copy_(y)
    return merge_shards_cuda(pool_s, pool_i, recs, n)
