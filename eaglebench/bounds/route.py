"""Operations and bytes of the route's kernels, from the shapes a call
had. Copied from chip_smoke.py at commit 7f915e9 (`pair_bound`,
`REPLAY_STEP_OPS`)."""
from __future__ import annotations

from typing import Tuple

from eaglebench.bounds import bound_ms

#: fp32 operations of one replay step of one query: difference, divide,
#: pow, add, reciprocal, difference, two products, two updates
REPLAY_STEP_OPS = 10


def retrieve_bytes_ops(nq: int, c: int, d: int, n: int) -> Tuple[float,
                                                                 float]:
    """The fused retrieve (kernel 1 and the select, timed together) over
    nq queries and c live DB rows of width d, keeping n: q and the live
    rows read once, the top-n (fp32 scores, int64 rows, a hit byte)
    written once; the product's fp32 operations and both sides' norms.
    The panel between the two kernels is the design's own and is not
    counted."""
    return (4.0 * (nq * d + c * d) + 13.0 * nq * n,
            2.0 * nq * c * d + 2.0 * (nq + c) * d)


def retrieve_bound_ms(nq: int, c: int, d: int, n: int) -> float:
    return bound_ms(*retrieve_bytes_ops(nq, c, d, n))[0]


def route_useful_ops(nq: int, c: int, d: int, n: int, records: int) -> float:
    """The fp32 operations a route of nq live queries needs: the
    retrieve's, and the replay of n neighbours' `records` records each."""
    return retrieve_bytes_ops(nq, c, d, n)[1] \
        + float(REPLAY_STEP_OPS * nq * n * records)
