"""Captured CUDA graphs: the port's counterpart of the JAX package's
compiled executables (`jax.jit`, AOT `lower().compile()`).

A `Step` wraps a function of static tensors. On the card it runs the
function once eagerly on a side stream (libraries loaded, cuBLAS and the
allocator set up for the shapes, as PyTorch's capture recipe asks), then
captures it into a `torch.cuda.CUDAGraph`. Each call then replays the
graph: the same kernels over the same tensors, with no Python and one
host launch. The caller writes the next inputs into the static tensors
in place between calls; the arguments of a call are not read on the
card, so the owner's cache key must pin down what they are. The
wrappers' kernel launches are recorded at capture and credited to their
counts on each replay (`_build.recording`, `_build.credit`).

A `StepCache` keeps an owner's steps by key with the JAX package's
dispatch ledger (hits, misses == captures, warmed, capture seconds): the
route dispatcher's (core/dispatch.py) and each fleet model's decode
steps (serving/engine.py) are two of them. Its entries share one memory
pool per group; an owner evicts the entries whose inputs are gone, and
a group's pool goes with its last entry.

On CPU tensors nothing is captured: each call runs the function on its
arguments. A failed capture raises; nothing falls back to running
eagerly on the card.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import _build

_captures = 0


def capture_count() -> int:
    """Process-wide number of graph captures: the counterpart of the JAX
    package's `xla_compile_count`."""
    return _captures


def pool_handle(device: torch.device):
    """A memory pool for the graphs of one owner (None on the CPU).
    Graphs that share a pool must not replay concurrently; each owner
    replays on one stream and keeps every graph's outputs alive, so a
    later capture never reuses memory an earlier graph still reads."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


class Step:
    """fn(*args) as a captured graph on the card (captured here, from
    `args`), or run as it is on the CPU."""

    def __init__(self, fn: Callable, *args, device: torch.device,
                 pool=None):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.out = None
        self.fn: Optional[Callable] = fn
        if device.type != "cuda":
            return
        global _captures
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no automatic collection while the stream captures: a collected
        # graph's destructor (reset) is not permitted then, and
        # invalidates the capture (`torch.cuda.graph` collects first)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool), \
                    _build.recording() as launches:
                self.out = fn(*args)
        finally:
            if collecting:
                gc.enable()
        self.graph, self.launches = graph, launches
        self.fn = None          # the graph holds no reference to `args`
        _captures += 1

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        self.graph.replay()
        _build.credit(self.launches)
        return self.out


@dataclasses.dataclass
class DispatchStats:
    hits: int = 0
    misses: int = 0          # == entries this cache made (captures)
    warmed: int = 0          # misses taken by warmup, not traffic
    compile_s: float = 0.0   # seconds spent capturing (the JAX package's
                             # seconds spent compiling)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class StepCache:
    """key -> entry (a Step, or an object that holds one), with its
    ledger. `get` makes a missing entry with `make(pool)`, timed, and
    counts it; the hooks let the owner count the same events in its
    telemetry. Entries of one `group` share a graph memory pool."""

    def __init__(self, on_hit: Callable[[], Any] = lambda: None,
                 on_miss: Callable[[Hashable, float], Any] =
                 lambda key, seconds: None):
        self.stats = DispatchStats()
        self.entries: Dict[Hashable, Any] = {}
        self.evicted = 0
        self._groups: Dict[Hashable, Hashable] = {}   # key -> group
        self._pools: Dict[Hashable, Any] = {}         # group -> pool
        self._on_hit, self._on_miss = on_hit, on_miss

    def get(self, key: Hashable, make: Callable[[Any], Any], *,
            device: torch.device, group: Hashable = None,
            warm: bool = False):
        entry = self.entries.get(key)
        if entry is not None:
            if not warm:
                self.stats.hits += 1
                self._on_hit()
            return entry
        t0 = time.perf_counter()
        if group not in self._pools:
            self._pools[group] = pool_handle(device)
        entry = make(self._pools[group])
        dt = time.perf_counter() - t0
        self.entries[key] = entry
        self._groups[key] = group
        self.stats.misses += 1
        self.stats.warmed += bool(warm)
        self.stats.compile_s += dt
        self._on_miss(key, dt)
        return entry

    def evict(self, dead: Callable[[Hashable, Any], bool]) -> int:
        """Drop the entries `dead(key, entry)` names, and the pool of each
        group left without an entry. Returns how many were dropped."""
        gone = [k for k, e in self.entries.items() if dead(k, e)]
        for k in gone:
            del self.entries[k]
            self._groups.pop(k)
        for g in set(self._pools) - set(self._groups.values()):
            del self._pools[g]
        self.evicted += len(gone)
        return len(gone)

    def as_dict(self) -> Dict:
        """The ledger: hits, misses, warmed, compile_s, entries, keys."""
        return {**self.stats.as_dict(), "entries": len(self.entries),
                "keys": sorted(self.entries)}
