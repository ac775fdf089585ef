"""Vector database: host-side append buffer for prompt embeddings and
their grouped pairwise feedback.

The retrieval unit is the PROMPT (paper §2.2): each stored prompt
carries all pairwise feedback collected for it, and Eagle-Local replays
the FULL feedback of the N retrieved prompts.

Storage lives in host numpy: appends are the online hot path and must
cost microseconds, not device round trips. Retrieval runs on the device
against a RouterState (core/state.py): the buffer tracks which rows were
touched since each replica's last sync, and `state.commit()` copies just
those rows into the device tensors. The `query`/`gather_feedback`
methods are the LEGACY object-path retrieval, as the JAX package keeps
them: the route benchmark (`benchmarks_torch/route_batch_bench.py`)
holds the fused route against them; no serving path calls them.

Appends and grows are counted in the process default telemetry scope
(`obs.get_obs(None)`), as in the JAX package: `vectordb_records_total`,
the `vectordb_size` and `vectordb_capacity` gauges, `vectordb_grow_total`
and a `db_grow` event.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.ref import stable_topk


def _l2norm_np(x, eps=1e-9):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class VectorDB:
    def __init__(self, dim: int, capacity: int = 4096,
                 records_per_query: int = 8, backend: str = "cuda"):
        self.dim = dim
        self.capacity = capacity
        self.rcap = records_per_query
        self.backend = backend             # kernels.ops backend of query()
        self.size = 0                      # prompts stored
        self._alloc(capacity, records_per_query)
        self._row_of: Dict[int, int] = {}
        self._device: Optional[Tuple[torch.Tensor]] = None  # emb snapshot
        # rows touched since last commit, ONE ledger per device replica:
        # every registered consumer sees every touch until it drains, so
        # double-buffered states absorb rows landing between their turns
        self._dirty: Dict[str, set] = {"default": set()}

    def _alloc(self, cq, r):
        self.emb = np.zeros((cq, self.dim), np.float32)
        self.model_a = np.zeros((cq, r), np.int32)
        self.model_b = np.zeros((cq, r), np.int32)
        self.outcome = np.zeros((cq, r), np.float32)
        self.valid = np.zeros((cq, r), bool)
        self.n_rec = np.zeros((cq,), np.int32)

    def _grow(self, need_q: int = 0, need_r: int = 0):
        """Reallocate larger (doubling). A grow is a shape change: the next
        commit() answers it with a full re-upload."""
        new_q = max(self.capacity, need_q,
                    self.capacity * 2 if need_q > self.capacity else self.capacity)
        new_r = max(self.rcap, need_r,
                    self.rcap * 2 if need_r > self.rcap else self.rcap)
        if (new_q, new_r) == (self.capacity, self.rcap):
            return
        # rare at steady state, so an event worth logging
        o = OBS.get_obs(None)
        o.registry.counter(
            "vectordb_grow_total",
            "buffer reallocs (shape change -> full re-upload)").inc()
        o.emit({"kind": "db_grow", "from": [self.capacity, self.rcap],
                "to": [new_q, new_r], "size": self.size})
        self._device = None
        emb = np.zeros((new_q, self.dim), np.float32)
        emb[:self.capacity] = self.emb
        self.emb = emb

        def grow2(a, dtype):
            out = np.zeros((new_q, new_r), dtype)
            out[:self.capacity, :self.rcap] = a
            return out

        self.model_a = grow2(self.model_a, np.int32)
        self.model_b = grow2(self.model_b, np.int32)
        self.outcome = grow2(self.outcome, np.float32)
        self.valid = grow2(self.valid, bool)
        n_rec = np.zeros((new_q,), np.int32)
        n_rec[:self.capacity] = self.n_rec
        self.n_rec = n_rec
        self.capacity, self.rcap = new_q, new_r

    def add(self, emb, model_a, model_b, outcome, query_id=None):
        """Append feedback records (host-side, O(batch)). emb: (B, D);
        query_id: (B,) — records sharing an id group under one prompt."""
        emb = np.atleast_2d(np.asarray(emb, np.float32))
        model_a = np.asarray(model_a, np.int32).reshape(-1)
        model_b = np.asarray(model_b, np.int32).reshape(-1)
        outcome = np.asarray(outcome, np.float32).reshape(-1)
        b = emb.shape[0]
        if query_id is None:
            base = -1 - len(self._row_of)
            query_id = np.arange(base, base - b, -1)
        query_id = np.asarray(query_id).reshape(-1)

        for i in range(b):
            qid = int(query_id[i])
            row = self._row_of.get(qid)
            if row is None:
                if self.size >= self.capacity:
                    self._grow(need_q=self.size + 1)
                row = self.size
                self._row_of[qid] = row
                self.size += 1
                self.emb[row] = _l2norm_np(emb[i])
            slot = self.n_rec[row]
            if slot >= self.rcap:
                self._grow(need_r=slot + 1)
            self.model_a[row, slot] = model_a[i]
            self.model_b[row, slot] = model_b[i]
            self.outcome[row, slot] = outcome[i]
            self.valid[row, slot] = True
            self.n_rec[row] += 1
            for ledger in self._dirty.values():
                ledger.add(row)
        self._device = None  # invalidate the device snapshot
        o = OBS.get_obs(None)
        o.registry.counter("vectordb_records_total",
                           "feedback records appended").inc(b)
        o.registry.gauge("vectordb_size", "live prompt rows").set(self.size)
        o.registry.gauge("vectordb_capacity",
                         "allocated prompt rows").set(self.capacity)

    def register_consumer(self, name: str):
        """Open a dirty-row ledger for another device replica of this
        buffer (e.g. one half of a core.state.DoubleBuffer). The new
        ledger starts empty: the consumer takes a full upload (commit
        with prev=None) as its first sync."""
        self._dirty.setdefault(name, set())

    def drain_dirty(self, consumer: str = "default") -> np.ndarray:
        """Rows touched since `consumer`'s last drain (sorted), then clear
        that ledger. commit() uploads exactly these rows; a realloc
        (_grow) changes the array shapes, which commit() answers with a
        full re-upload instead."""
        ledger = self._dirty.setdefault(consumer, set())
        rows = np.fromiter(sorted(ledger), np.int32, count=len(ledger))
        ledger.clear()
        return rows

    def drain_dirty_sharded(self, consumer: str = "default",
                            n_shards: int = 1) -> List[np.ndarray]:
        """drain_dirty() grouped by OWNING shard under the contiguous
        capacity split (shard s owns rows [s*C/S, (s+1)*C/S):
        sharding.db_state_specs), for the sharded commit's owner scatter.
        Stale rows at/past the live count are dropped here, the
        unsharded commit's guard."""
        rows = self.drain_dirty(consumer)
        rows = rows[rows < self.size]
        c_local = self.capacity // n_shards
        return [rows[(rows >= s * c_local) & (rows < (s + 1) * c_local)]
                for s in range(n_shards)]

    def next_capacity(self, need_q: Optional[int] = None) -> int:
        """The capacity _grow() will allocate when the buffer next
        overflows (doubling policy): the capacity prebaker
        (core.dispatch.CapacityPrebaker) prepares replicas of it before
        the grow."""
        if need_q is None:
            need_q = self.capacity + 1
        if need_q <= self.capacity:
            return self.capacity
        return max(need_q, self.capacity * 2)

    def clear(self):
        """Roll the buffer back to empty without reallocating. Device
        states committed before the clear keep stale row contents, but
        `size` masks them; re-added rows are re-dirtied by add() and
        overwritten on the next commit. Stale ledger entries are dropped
        by commit()'s rows < size guard."""
        self.size = 0
        self._row_of.clear()
        self.n_rec[:] = 0
        self.valid[:] = False
        self._device = None
        for ledger in self._dirty.values():
            ledger.clear()

    def _snapshot(self, device: torch.device) -> Tuple[torch.Tensor]:
        """A copy of `emb` on `device`, kept until a write or a query from
        another device."""
        if self._device is None or self._device[0].device != device:
            self._device = (torch.tensor(self.emb, device=device),)
        return self._device

    def query(self, q, n: int):
        """LEGACY object-path retrieval (see module docstring): the top
        min(n, capacity) prompts by cosine similarity among the live rows,
        ties to the lowest row, on q's device (a numpy q: the CPU).
        Returns (idx (Q, k) int64, scores (Q, k), hit (Q, k))."""
        q = torch.as_tensor(q, dtype=torch.float32)
        q = q[None] if q.ndim == 1 else q
        (emb,) = self._snapshot(q.device)
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-9)
        scores = KOPS.similarity(q, emb, backend=self.backend)
        live = torch.arange(self.capacity, device=q.device) < self.size
        scores = torch.where(live[None, :], scores,
                             torch.full_like(scores, float("-inf")))
        top_s, top_i = stable_topk(scores, min(n, self.capacity))
        return top_i, top_s, torch.isfinite(top_s)

    def gather_feedback(self, idx, hit):
        """LEGACY host-side record gather (the indices come back to the
        host for numpy fancy-indexing; the fused route gathers on the
        device). idx: (Q, N) prompt rows -> flattened (Q, N*R) neighbour
        records (model_a, model_b, outcome, valid) for the local ELO
        replay, on idx's device, valid = valid[idx] & hit.

        Replay order is FARTHEST neighbour first: ELO is recency-weighted,
        so the most similar prompts are replayed last to carry the most
        influence."""
        dev = idx.device if torch.is_tensor(idx) else torch.device("cpu")
        idx = np.asarray(torch.as_tensor(idx).cpu())[:, ::-1]
        hit = np.asarray(torch.as_tensor(hit).cpu())[:, ::-1]
        nq = idx.shape[0]

        def out(x):
            return torch.from_numpy(x.reshape(nq, -1)).to(dev)
        return (out(self.model_a[idx]), out(self.model_b[idx]),
                out(self.outcome[idx]),
                out(self.valid[idx] & hit[..., None]))
