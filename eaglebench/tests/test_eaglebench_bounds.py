"""The bound arithmetic against counts made by hand."""
import pytest

from eaglebench import bounds
from eaglebench.bounds import route


def test_bound_takes_the_larger_time():
    assert bounds.bound_ms(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert bounds.bound_ms(0.0, 67e9) == (pytest.approx(1.0), "operations")
    assert bounds.bound_ms(0.0, 989e9, bounds.PEAK_BF16_FLOPS)[0] == \
        pytest.approx(1.0)


def test_retrieve_counts():
    # 2 queries, 3 rows of width 4, keep 1: q (8 floats) and the rows (12
    # floats) read once, one top-1 (fp32 score, int64 row, a byte) a query
    nbytes, ops = route.retrieve_bytes_ops(2, 3, 4, 1)
    assert nbytes == 4 * (8 + 12) + 13 * 2
    assert ops == 2 * 2 * 3 * 4 + 2 * (2 + 3) * 4
    # bucket 1024 over 32,768 rows at D = 1536: the product bounds it
    ms = route.retrieve_bound_ms(1024, 32768, 1536, 20)
    assert ms == pytest.approx((2 * 1024 * 32768 * 1536
                                + 2 * (1024 + 32768) * 1536) / 67e9)
    assert ms == pytest.approx(1.5406, rel=1e-3)   # chip_smoke's 1.540


def test_route_ops_add_the_replay():
    assert route.route_useful_ops(1, 3, 4, 2, 8) == \
        route.retrieve_bytes_ops(1, 3, 4, 2)[1] + 10 * 2 * 8
