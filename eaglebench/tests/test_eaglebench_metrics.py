"""Per-layer readers on slices made by hand."""
import types

import pytest

from eaglebench import spec, tracing
from eaglebench.bounds.route import retrieve_bound_ms


def _ctx(device, routes):
    tr = tracing.Slice(device=device, host=[], t0=0.0, t1=1e6)
    return types.SimpleNamespace(trace=tr, slice_routes=routes, rows_fit=100,
                                 rows_per_batch=10, warm=1, dim=64, n=20)


def _ev(name, ts, dur):
    return tracing.Event(name, ts, dur)


def test_roofline_matches_kernels_to_routes_by_count():
    read = spec.metric("retrieve_roofline").read
    routes = [(50, 64, 0), (700, 1024, 2)]
    # the card's clock runs ahead of the host's: kernels stamped before
    # their routes' marks still count
    dev = [_ev("panel_gemm_kernel<64>", -900.0, 30.0),
           _ev("topn_select_kernel", -860.0, 10.0),
           _ev("panel_gemm_kernel<128>", 100.0, 300.0),
           _ev("topn_select_kernel", 420.0, 60.0),
           _ev("elo_scan_kernel", 500.0, 5.0)]
    want = (retrieve_bound_ms(64, 110, 64, 20)
            + retrieve_bound_ms(1024, 130, 64, 20)) / 0.4
    assert read(_ctx(dev, routes)) == pytest.approx(100.0 * want)
    assert read(_ctx(dev[:3], routes)) is None      # a select missing
    assert read(_ctx(dev, [])) is None


def test_feedback_apply_is_the_mean():
    read = spec.metric("feedback_apply_ms").read
    assert read(types.SimpleNamespace(fb_apply=[0.002, 0.004])) == \
        pytest.approx(3.0)
    assert read(types.SimpleNamespace(fb_apply=[])) is None
