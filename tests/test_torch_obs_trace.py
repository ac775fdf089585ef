"""The port's span tracer (`repro_torch.obs.trace`) on the CPU: nesting,
the gate, device spans (a no-op on the CPU; their resolution through
stand-in events), the export's clock against torch.profiler's marks, and
the spans that one routed batch, one `EagleRouter.update` and one
`DoubleBuffer.commit` record. The device spans on the card are in
tests/test_torch_obs_gpu.py."""
import json

import numpy as np
import pytest
import torch

from repro_torch import obs as OBS
from repro_torch.core.dispatch import RouteDispatcher
from repro_torch.core.router import EagleConfig, EagleRouter
from repro_torch.core.state import DoubleBuffer
from repro_torch.obs.trace import NULL_SPAN, SpanTracer

DIM = 8


def _by_name(spans):
    out = {}
    for rec in spans:
        out.setdefault(rec[1], []).append(rec)
    return out


def test_nested_spans_record_their_depth_inner_first():
    tr = SpanTracer(capacity=16)
    with tr.span("outer"):
        with tr.span("inner"):
            with tr.span("leaf"):
                pass
        with tr.span("inner2"):
            pass
    with tr.span("next"):
        pass
    got = [(name, depth) for _, name, _, _, _, depth in tr.spans()]
    assert got == [("leaf", 2), ("inner", 1), ("inner2", 1), ("outer", 0),
                   ("next", 0)]
    s = _by_name(tr.spans())
    outer, inner = s["outer"][0], s["inner"][0]
    assert outer[2] <= inner[2] and \
        inner[2] + inner[3] <= outer[2] + outer[3]
    assert tr.recorded == 5 and tr.dropped == 0


def test_a_disabled_scope_records_nothing_device_spans_included():
    o = OBS.Observability(enabled=False)
    cuda = torch.device("cuda", 0)
    assert o.span("a") is NULL_SPAN
    assert o.device_span("b", cuda) is NULL_SPAN
    o.tracer.enabled = False
    assert o.tracer.device_span("c", cuda) is NULL_SPAN
    with o.span("a"), o.device_span("b", cuda):
        pass
    assert o.tracer.spans() == [] and o.tracer.recorded == 0


def test_device_span_is_a_no_op_on_the_cpu():
    o = OBS.Observability(enabled=True)
    assert o.device_span("dev", torch.device("cpu")) is NULL_SPAN
    with o.span("host"), o.device_span("dev", torch.device("cpu")):
        pass
    assert [s[1] for s in o.tracer.spans()] == ["host"]


class _Event:
    """A stand-in CUDA timing event: complete once `done` (or after a
    synchronise)."""

    def __init__(self, done=False, ms=0.0):
        self.done, self.ms, self.waited = done, ms, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.ms - self.ms


def test_pending_device_spans_resolve_in_order_and_on_spans():
    tr = SpanTracer(capacity=8)
    done = (_Event(True, 0.0), _Event(True, 0.25))
    late = (_Event(True, 1.0), _Event(False, 2.5))
    after = (_Event(True, 3.0), _Event(True, 3.5))
    tr._pending.extend([("a", 100, 1, 0) + done, ("b", 200, 1, 0) + late,
                        ("c", 300, 0, 0) + after])
    tr._resolve(block=False)
    # "b" has not completed: it and what follows it stay pending
    assert [s[1] for s in tr._slots if s is not None] == ["a"]
    assert len(tr._pending) == 2 and tr._free[0] == [done]
    spans = tr.spans()
    assert late[1].waited == 1 and not tr._pending
    assert [(n, t0, dur, tid, depth) for _, n, t0, dur, tid, depth in
            spans] == [("a", 100, 250_000, -1, 1),
                       ("b", 200, 1_500_000, -1, 1),
                       ("c", 300, 500_000, -1, 0)]
    assert tr._free[0] == [done, late, after]


def test_a_host_span_closing_resolves_completed_device_spans():
    tr = SpanTracer(capacity=8)
    ev = (_Event(True, 0.0), _Event(True, 0.5))
    tr._pending.append(("dev", 1, 1, 0) + ev)
    with tr.span("readout"):
        pass
    assert not tr._pending and ev[1].waited == 0
    got = [s for s in tr._slots if s is not None]
    assert [s[1] for s in got] == ["readout", "dev"]
    assert got[1][3] == 500_000


def test_reset_drops_pending_device_spans_into_the_pool():
    tr = SpanTracer(capacity=8)
    ev = (_Event(True, 0.0), _Event(False, 1.0))
    tr._pending.append(("a", 1, 0, 0) + ev)
    tr.reset()
    assert not tr._pending and tr._free[0] == [ev] and tr.spans() == []


def test_export_puts_device_spans_on_their_own_track():
    tr = SpanTracer(capacity=8)
    with tr.span("host"):
        pass
    tr._pending.append(("dev", 5, 1, 0, _Event(True, 0.0),
                        _Event(True, 0.5)))
    doc = tr.chrome_trace()
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["host"]["cat"] == "host" and ev["host"]["tid"] > 0
    assert ev["dev"]["cat"] == "device" and ev["dev"]["tid"] == -1
    assert ev["dev"]["dur"] == pytest.approx(500.0)
    assert ev["thread_name"] == {"name": "thread_name", "ph": "M",
                                 "pid": ev["dev"]["pid"], "tid": -1,
                                 "args": {"name": "cuda:0 (device clock)"}}
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}


def test_export_ts_lies_on_the_profilers_clock(tmp_path):
    """Each span's exported start, put on the epoch through the profiler
    trace's own base, lies within 100 us of its record_function mark at
    the median over 100 spans."""
    o = OBS.Observability(enabled=True, profiler=True)
    x = torch.ones(64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(100):
            with o.span(f"span{i}"):
                x.add_(1.0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    marks = {e["name"]: e["ts"] * 1e3 + base for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation"}
    ours = {e["name"]: e["ts"] * 1e3 + base
            for e in o.tracer.chrome_trace()["traceEvents"]
            if e["ph"] == "X"}
    assert len(ours) == 100 and set(ours) <= set(marks)
    gaps = [abs(ours[n] - marks[n]) for n in ours]
    assert np.median(gaps) < 100e3, np.median(gaps)


def _world():
    rng = np.random.default_rng(3)
    n_models, n = 4, 40
    r = EagleRouter([f"m{i}" for i in range(n_models)],
                    np.arange(1.0, n_models + 1), EagleConfig(embed_dim=DIM),
                    db_capacity=64, device="cpu")
    a = rng.integers(0, n_models, n)
    r.fit(rng.normal(size=(n, DIM)).astype(np.float32), a,
          (a + 1) % n_models, rng.choice([0.0, 0.5, 1.0], n),
          query_id=np.arange(n))
    o = OBS.Observability(enabled=True)
    r.obs = o
    dbuf = DoubleBuffer(r.db, r.global_ratings, device="cpu", obs=o)
    d = RouteDispatcher.for_router(r, obs=o)
    return r, o, dbuf, d, rng


def _children(spans, parent):
    """The spans inside `parent`'s interval one level below it, by
    start."""
    _, _, t0, dur, tid, depth = parent
    kids = [s for s in spans if s[5] == depth + 1 and s[4] == tid
            and t0 <= s[2] and s[2] + s[3] <= t0 + dur]
    return [s[1] for s in sorted(kids, key=lambda s: s[2])]


@pytest.mark.parametrize("with_topk", [False, True])
def test_a_routed_batch_records_stage_launch_readout(with_topk):
    r, o, dbuf, d, rng = _world()
    d.warmup(dbuf.front, [5])
    o.reset()
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    if with_topk:
        d.route_result(dbuf.front, q, 3.0)
    else:
        d.route(dbuf.front, q, 3.0)
    spans = o.tracer.spans()
    name = "dispatch.route_result" if with_topk else "dispatch.route"
    assert sorted((s[1], s[5]) for s in spans) == sorted(
        [(name, 0), ("dispatch.stage", 1), ("dispatch.launch", 1),
         ("dispatch.readout", 1)])
    route = _by_name(spans)[name][0]
    assert _children(spans, route) == ["dispatch.stage", "dispatch.launch",
                                       "dispatch.readout"]


def test_update_and_commit_record_their_steps():
    r, o, dbuf, d, rng = _world()
    o.reset()
    a = rng.integers(0, 4, 6)
    r.update(rng.normal(size=(6, DIM)).astype(np.float32), a, (a + 1) % 4,
             rng.choice([0.0, 1.0], 6))
    dbuf.commit(r.global_ratings)
    spans = o.tracer.spans()
    s = _by_name(spans)
    assert sorted((n, v[0][5]) for n, v in s.items()) == sorted(
        [("router.update", 0), ("router.update.add", 1),
         ("router.update.fold", 1), ("router.update.sync", 1),
         ("state.commit", 0), ("state.commit.rows", 1),
         ("state.commit.copy", 1)])
    assert all(len(v) == 1 for v in s.values())
    assert _children(spans, s["router.update"][0]) == [
        "router.update.add", "router.update.fold", "router.update.sync"]
    assert _children(spans, s["state.commit"][0]) == [
        "state.commit.rows", "state.commit.copy"]
    # the commit copied the new rows into the replica it made the front
    front = dbuf.front
    assert int(front.size) == r.db.size
    np.testing.assert_array_equal(front.emb.numpy()[:r.db.size],
                                  r.db.emb[:r.db.size])
