"""The comparison that decides `correct`, shown to fail: a whole run of
the tiny route cell (the harness's look for a card skipped) with the
timed path broken underneath, once for each fault the cell can have,
and each control in the program's place. The unbroken run passes.
(One card: there is no exchange between cards to leave out.)"""
import numpy as np
import pytest
import torch

from repro_torch.core.dispatch import RouteDispatcher
from repro_torch.core.router import EagleRouter
from repro_torch.core.state import DoubleBuffer


def _correct(checks):
    return all(v <= lim for v, lim in checks.values())


def test_unbroken_run_passes(run_tiny):
    rec = run_tiny(seed=2 ** 31 + 7)
    assert _correct(rec["checks"]), rec["checks"]
    assert rec["checks"]["records_mismatch"][0] == 0


def test_commit_that_leaves_the_state_unchanged(run_tiny, monkeypatch):
    monkeypatch.setattr(DoubleBuffer, "commit", lambda self, g: self.front)
    assert not _correct(run_tiny()["checks"])


def test_half_the_route_batch_left_out(run_tiny, monkeypatch):
    route = RouteDispatcher._route

    def half(self, state, q, b, with_topk):
        h = max(1, len(q) // 2)
        return [tuple(None if x is None else np.resize(x, (len(q),)
                                                       + x.shape[1:])
                      for x in part)
                for part in route(self, state, q[:h], b[:h], with_topk)]
    monkeypatch.setattr(RouteDispatcher, "_route", half)
    assert not _correct(run_tiny()["checks"])


def test_half_the_feedback_batch_left_out(run_tiny, monkeypatch):
    update = EagleRouter.update

    def half(self, emb, a, b, s, query_id=None):
        h = len(a) // 2
        return update(self, emb[:h], a[:h], b[:h], s[:h],
                      query_id=query_id[:h])
    monkeypatch.setattr(EagleRouter, "update", half)
    assert not _correct(run_tiny()["checks"])


def test_an_answer_altered_where_it_is_produced(run_tiny, monkeypatch):
    route = RouteDispatcher._route

    def altered(self, state, q, b, with_topk):
        parts = route(self, state, q, b, with_topk)
        choices = parts[0][0].copy()
        choices[0] = (choices[0] + 1) % 10
        return [(choices,) + tuple(parts[0][1:])] + parts[1:]
    monkeypatch.setattr(RouteDispatcher, "_route", altered)
    assert not _correct(run_tiny()["checks"])


def test_a_neighbour_altered_where_it_is_produced(run_tiny, monkeypatch):
    route = RouteDispatcher._route

    def altered(self, state, q, b, with_topk):
        parts = route(self, state, q, b, with_topk)
        if with_topk:
            top = parts[0][1].copy()
            top[0, -1] = top[0, -1] + 1
            parts[0] = (parts[0][0], top)
        return parts
    monkeypatch.setattr(RouteDispatcher, "_route", altered)
    assert not _correct(run_tiny()["checks"])


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
def test_control_fails(run_tiny, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec = run_tiny(seed=11, control=True)
    assert _correct(rec["checks"])
    assert set(rec["control"]) == {"control", "control_tf32"}
    for checks in rec["control"].values():
        assert not _correct(checks)
    # the TF32 similarity alone is caught by the neighbours' comparison
    tf32 = rec["control"]["control_tf32"]
    assert tf32["topn_gap"][0] > tf32["topn_gap"][1]
