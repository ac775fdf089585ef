"""The readers of the program's inner spans on a `ctx.spans` made by hand
(name -> seconds in record order, as `drivers/route_open.py:_ctx` gathers
them), the cases with nothing to read included. The write side's readers
leave out the set-up's `ctx.warm` feedback batches, the first spans."""
import types

import pytest

from eaglebench import spec

NEW = ("route_host_ms", "route_stage_ms", "route_device_ms", "update_add_ms",
       "update_fold_ms", "commit_host_ms")


def _read(name, ctx):
    return spec.metric(name).read(ctx)


@pytest.mark.parametrize("name", NEW)
def test_no_spans_read_none(name):
    assert _read(name, types.SimpleNamespace(spans={}, warm=0)) is None


def test_route_host_is_the_route_mean_less_the_device_mean():
    ctx = types.SimpleNamespace(spans={
        "dispatch.route": [0.002, 0.003], "dispatch.route_result": [0.004],
        "dispatch.device": [0.001, 0.0015, 0.002]}, warm=1)
    assert _read("route_host_ms", ctx) == pytest.approx(3.0 - 1.5)


def test_route_host_is_none_when_the_counts_differ():
    ctx = types.SimpleNamespace(spans={
        "dispatch.route": [0.002, 0.003], "dispatch.device": [0.001]},
        warm=0)
    assert _read("route_host_ms", ctx) is None
    # no device span at all, as a program without them records
    ctx.spans.pop("dispatch.device")
    assert _read("route_host_ms", ctx) is None


def test_the_route_means_count_every_span():
    ctx = types.SimpleNamespace(spans={
        "dispatch.stage": [0.0002, 0.0004],
        "dispatch.device": [0.001, 0.002]}, warm=1)
    assert _read("route_stage_ms", ctx) == pytest.approx(0.3)
    assert _read("route_device_ms", ctx) == pytest.approx(1.5)


def test_the_write_side_means_leave_out_the_warm_batches():
    ctx = types.SimpleNamespace(spans={
        "router.update.add": [0.02, 0.002, 0.004],
        "state.commit": [0.01, 0.0005, 0.0007]}, warm=1)
    assert _read("update_add_ms", ctx) == pytest.approx(3.0)
    assert _read("commit_host_ms", ctx) == pytest.approx(0.6)
    ctx.warm = 3        # nothing past the warm batches
    assert _read("update_add_ms", ctx) is None
    assert _read("commit_host_ms", ctx) is None


def test_update_fold_is_the_fold_and_the_sync():
    ctx = types.SimpleNamespace(spans={
        "router.update.fold": [0.01, 0.0001, 0.0003],
        "router.update.sync": [0.01, 0.0002, 0.0002]}, warm=1)
    assert _read("update_fold_ms", ctx) == pytest.approx(0.4)
    ctx.spans.pop("router.update.sync")
    assert _read("update_fold_ms", ctx) is None


def test_each_reader_is_listed_for_the_route_cell():
    bench = spec.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == ["paper-route-open"]
        assert m["moves"] == "route_p95_ms"
