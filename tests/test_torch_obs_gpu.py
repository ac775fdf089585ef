"""The operational obs plane over CUDA state. Marked `gpu`: without a CUDA
device every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs_gpu.py

The plane is host code: its monitor holds host copies of the router's
ratings and costs, and the exporter's thread touches no CUDA state, so a
scrape beside a graph capture neither fails the capture nor adds one.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch import obs as OBS
from repro_torch.core.dispatch import RouteDispatcher
from repro_torch.core.router import EagleConfig, EagleRouter
from repro_torch.core.state import DoubleBuffer
from repro_torch.obs.exporter import ROUTES, ObsExporter
from repro_torch.obs.quality import RouterQualityMonitor
from repro_torch.obs.slo import SLOEngine, default_serving_rules

pytestmark = pytest.mark.gpu

DIM, NAMES, COSTS = 64, ["a", "b", "c", "d"], [1.0, 2.0, 4.0, 8.0]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _router(device, seed=0, n=300):
    rng = np.random.default_rng(seed)
    r = EagleRouter(NAMES, COSTS, EagleConfig(embed_dim=DIM),
                    db_capacity=512, device=device)
    a = rng.integers(0, 4, n)
    r.fit(rng.normal(size=(n, DIM)).astype(np.float32), a, (a + 1) % 4,
          rng.choice([0.0, 0.5, 1.0], n).astype(np.float32))
    return r


def _feedback(rng, n=16):
    a = rng.integers(0, 4, n)
    return (rng.normal(size=(n, DIM)).astype(np.float32), a,
            (a + 1 + rng.integers(0, 3, n)) % 4,
            rng.choice([0.0, 1.0], n).astype(np.float32))


def test_for_router_copies_cuda_ratings_to_the_host(dev):
    r = _router(dev)
    mon = RouterQualityMonitor.for_router(r, obs=OBS.Observability())
    assert r.quality is mon
    assert isinstance(mon.ratings, np.ndarray)
    np.testing.assert_array_equal(mon.ratings,
                                  r.global_ratings.cpu().numpy())
    np.testing.assert_array_equal(mon.costs, np.asarray(COSTS))
    snap = mon.snapshot()
    assert list(snap["ratings"]) == NAMES


class _Scraper:
    """Scrape every route of `exporter` in a loop until stopped."""

    def __init__(self, exporter):
        self.exporter, self.ok, self.errors = exporter, 0, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self.stop.is_set():
            for path in ROUTES:
                try:
                    with urllib.request.urlopen(self.exporter.url(path),
                                                timeout=30) as resp:
                        resp.read()
                        self.ok += resp.status == 200
                except Exception as e:      # reported by the test
                    self.errors.append(repr(e))

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


def test_scrape_during_warmup_captures_nothing_extra(dev):
    """A thread scrapes all six routes while the dispatcher captures its
    route ladder on both replicas: every capture succeeds, the process
    counts exactly the dispatcher's captures, the graphs route as the
    eager path does, and no scrape fails."""
    r = _router(dev)
    ob = OBS.Observability(enabled=True)
    r.obs = ob
    disp = RouteDispatcher.for_router(r, obs=ob, max_bucket=64)
    dbuf = DoubleBuffer(r.db, r.global_ratings, device=dev, obs=ob)
    mon = RouterQualityMonitor.for_router(r, obs=ob)
    slo = SLOEngine(ob.registry, default_serving_rules(), obs=ob)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(40, DIM)).astype(np.float32)
    b = rng.uniform(0.5, 9.0, 40).astype(np.float32)
    with ObsExporter(ob, slo=slo, quality=mon) as ex, _Scraper(ex) as sc:
        c0 = graphs.capture_count()
        n = 0
        for _ in range(2):
            n += disp.warmup(dbuf.front)
            dbuf.commit(r.global_ratings)
        captured = graphs.capture_count() - c0
        got = disp.route(dbuf.front, q, b)
        mon.observe_batch(b, got)
        with urllib.request.urlopen(ex.url("/quality"), timeout=30) as resp:
            decisions = json.loads(resp.read())["decisions"]
    ob.disable()
    want = disp.route(dbuf.front, q, b)
    assert n == captured == 2 * 4          # buckets 8..64 on 2 replicas
    assert np.array_equal(got, want)
    assert decisions == 40
    assert sc.ok > 0 and sc.errors == []
    assert disp.cache_stats()["misses"] == disp.cache_stats()["warmed"]


def test_feedback_with_obs_enabled_matches_disabled_and_captures_nothing(dev):
    """Two routers fitted alike take the same three feedback batches, one
    with obs enabled and a monitor attached, one with obs off: the same
    ratings bit for bit, no capture, and the enabled one's magnitude
    histogram and monitor see each fold."""
    on, off = _router(dev), _router(dev)
    ob = OBS.Observability(enabled=True)
    on.obs, off.obs = ob, OBS.Observability(enabled=False)
    mon = RouterQualityMonitor.for_router(on, obs=ob)
    c0 = graphs.capture_count()
    for seed in range(3):
        batch = _feedback(np.random.default_rng(seed))
        on.feedback(*batch)
        off.feedback(*batch)
    assert graphs.capture_count() == c0
    assert torch.equal(on.global_ratings, off.global_ratings)
    assert ob.registry.find("router_elo_update_magnitude").count == 3
    assert ob.registry.value("router_feedback_total") == 48
    assert off.obs.registry.find("router_elo_update_magnitude") is None
    assert mon.snapshot()["feedback_folds"] == 3
    np.testing.assert_array_equal(mon.ratings,
                                  on.global_ratings.cpu().numpy())
