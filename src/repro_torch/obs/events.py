"""Structured JSONL event log: per-request route decisions and rare
control-plane events (DB growth, buffer swaps) for offline analysis.

The serving path emits one record per routed request — chosen model,
budget, feasible-set size — which is exactly what RouterBench-style
AUC/cost analysis needs (PAPERS.md: Hu et al. 2024). Two emission
shapes:

  * `emit(record)` — one dict, one bounded-deque append (thread-safe,
    no serialization on the hot path);
  * `emit_columns(kind, n, shared, columns)` — a whole serve batch as
    ONE compact columnar entry (a few list or array refs), expanded to
    n per-request records lazily at `records()`/`dump()` time. This is
    what keeps the decision log inside the <5% hot-path overhead
    budget: the per-request dict construction happens offline, not
    between route dispatches. A column may be a numpy array (the
    port's serving path passes the dispatcher's host arrays): it is
    turned into Python values at expansion too, so the hot path pays
    no per-request conversion. Columns are kept by reference: the
    caller does not write them again.

`dump()` always writes ONE JSON LINE PER RECORD regardless of how the
records were emitted. Passing `path=` streams records eagerly through
a buffered file handle instead — for long-running servers where the
in-memory window would wrap (streaming pays the expansion cost inline).
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class _ColumnBatch:
    """n records sharing `shared` fields, per-record values columnar."""
    __slots__ = ("kind", "n", "shared", "columns")

    def __init__(self, kind: str, n: int, shared: Dict,
                 columns: Dict[str, Sequence]):
        self.kind, self.n = kind, n
        self.shared, self.columns = shared, columns

    def expand(self) -> Iterator[Dict]:
        cols = [(k, v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in self.columns.items()]
        for i in range(self.n):
            rec = {"kind": self.kind, **self.shared}
            for k, v in cols:
                rec[k] = v[i]
            yield rec


class EventLog:
    def __init__(self, capacity: int = 1 << 16, path: Optional[str] = None):
        # capacity bounds buffer ENTRIES (a columnar batch is one
        # entry); emitted/dropped account in RECORDS
        self._buf: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self._emitted = 0
        self._lock = threading.Lock()
        self._fh = open(path, "w", buffering=1 << 16) if path else None
        self.path = path

    def emit(self, record: Dict):
        """Append one event record. O(1), no serialization unless
        streaming to a file."""
        with self._lock:
            self._buf.append(record)
            self._emitted += 1
            if self._fh is not None:
                self._fh.write(json.dumps(record) + "\n")

    def emit_many(self, records: List[Dict]):
        """Batched append under ONE lock acquisition."""
        with self._lock:
            self._buf.extend(records)
            self._emitted += len(records)
            if self._fh is not None:
                self._fh.write("".join(
                    json.dumps(r) + "\n" for r in records))

    def emit_columns(self, kind: str, n: int, shared: Dict,
                     columns: Dict[str, Sequence]):
        """Emit n records as one compact columnar entry (hot path:
        a few list refs + one lock; expansion is deferred)."""
        batch = _ColumnBatch(kind, n, shared, columns)
        with self._lock:
            self._buf.append(batch)
            self._emitted += n
            if self._fh is not None:
                self._fh.write("".join(
                    json.dumps(r) + "\n" for r in batch.expand()))

    # -- accounting ----------------------------------------------------------
    @property
    def emitted(self) -> int:
        """Total records ever emitted (including ones the ring dropped)."""
        return self._emitted

    @property
    def retained(self) -> int:
        return sum(e.n if isinstance(e, _ColumnBatch) else 1
                   for e in self._buf)

    @property
    def dropped(self) -> int:
        return self._emitted - self.retained

    def __len__(self) -> int:
        return self.retained

    # -- readout -------------------------------------------------------------
    def _iter_records(self) -> Iterator[Dict]:
        for e in list(self._buf):
            if isinstance(e, _ColumnBatch):
                yield from e.expand()
            else:
                yield e

    def records(self, kind: Optional[str] = None) -> List[Dict]:
        """Retained records, oldest first (columnar entries expanded);
        optionally filtered by the conventional "kind" field."""
        out = list(self._iter_records())
        if kind is not None:
            out = [r for r in out if r.get("kind") == kind]
        return out

    def tail(self, n: int, kind: Optional[str] = None) -> List[Dict]:
        """The most recent `n` retained records (chronological order),
        optionally filtered by kind — the `/decisions` scrape shape.
        Walks entries newest-first and stops as soon as `n` records are
        collected, so a scrape never expands the whole ring."""
        chunks: List[List[Dict]] = []
        got = 0
        for e in reversed(list(self._buf)):
            recs = list(e.expand()) if isinstance(e, _ColumnBatch) \
                else [e]
            if kind is not None:
                recs = [r for r in recs if r.get("kind") == kind]
            if recs:
                chunks.append(recs)
                got += len(recs)
                if got >= n:
                    break
        out = [r for recs in reversed(chunks) for r in recs]
        return out[-n:] if n >= 0 else out

    def dump(self, path) -> int:
        """Write retained records as JSONL, one line per record;
        returns the line count."""
        n = 0
        with open(path, "w") as f:
            for r in self._iter_records():
                f.write(json.dumps(r) + "\n")
                n += 1
        return n

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._emitted = 0

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
