"""The least time the card could take for a piece of work, from the
operations and bytes it needs and the published peaks.

Copied from chip_smoke.py at commit 7f915e9 (`PEAK_*`, `bound_ms`,
`pair_bound`, `REPLAY_STEP_OPS`): the program's copy may change; this one
is the benchmark's yardstick. Every input byte is counted once and every
output byte once, whatever a kernel reads again.
"""
from __future__ import annotations

from typing import Tuple

#: NVIDIA H100 SXM data sheet, dense, at its 700 W power limit (a run
#: states the card's own limit beside every share of these)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
