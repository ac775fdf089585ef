"""Seeded open-loop schedules: arrival times and batch sizes.

Copied from src/repro_torch/serving/traffic.py at commit 7f915e9
(`poisson_arrivals`: exponential interarrival gaps at a target rate) and
changed in one way: the gaps, and the batch sizes, are the stratified
quantiles of their distributions ((i + 0.5) / n for i < n), put in an
order drawn from the seed. Every seed so offers the same work, the same
gaps and the same sizes, in another order, and two seeds differ only as
two orders of one mix do. The program's copy may change; this one is the
benchmark's yardstick.
"""
from __future__ import annotations

import numpy as np


def _strata(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def poisson_times(rate_hz: float, seconds: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Due times (seconds from the window's start, ascending, all under
    `seconds`) of round(rate_hz * seconds) arrivals whose gaps are the
    exponential distribution's quantiles at `rate_hz`, in a seeded order.
    The first arrival is due at 0."""
    if rate_hz <= 0 or seconds <= 0:
        raise ValueError(f"rate {rate_hz} Hz over {seconds} s")
    n = max(1, int(round(rate_hz * seconds)))
    gaps = -np.log1p(-_strata(n)) / rate_hz
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return due[due < seconds]


def loguniform_sizes(lo: int, hi: int, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """n integer sizes log-uniform on [lo, hi] (the quantiles, rounded),
    in a seeded order."""
    if not 1 <= lo <= hi:
        raise ValueError(f"sizes on [{lo}, {hi}]")
    u = _strata(n)
    sizes = np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
    return sizes.astype(np.int64)[rng.permutation(n)]
