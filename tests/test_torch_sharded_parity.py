"""The port's capacity-sharded route, its owner-scatter commit, its DB
mesh and the capacity prebaker against the JAX package's (DESIGN.md §12),
on the CPU.

The comparisons over several JAX devices run once, in a subprocess
(tests/_torch_sharded_worker.py under
`XLA_FLAGS=--xla_force_host_platform_device_count=4`, as
tests/test_sharded_state.py runs its own worker); the tests below assert
over its memoized report. The rest runs here: the sharded drain, the
mesh's checks, the prebaker's gating and its zero traffic misses across a
grow (the counterparts of tests/test_dispatch.py's prebaker cases; on
CPU tensors an entry is counted as a capture would be), and the serving
engine and launcher with a mesh and the prebaker against the unsharded
port and the JAX package. Choices and top-n rows must be equal; ratings
within rtol 1e-5 / atol 1e-3 (tests/test_router_state.py's bar).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro import obs as JOBS
from repro import sharding as JSHARD
from repro.core.dispatch import CapacityPrebaker as JPrebaker
from repro.core.dispatch import RouteDispatcher as JDispatcher
from repro.core.router import EagleConfig as JConfig
from repro.core.router import EagleRouter as JRouter
from repro.core.state import DoubleBuffer as JDoubleBuffer
from repro.core.vectordb import VectorDB as JDB
from repro.launch.mesh import make_db_mesh as j_mesh
from repro.serving import engine as JENG
from repro_torch import obs as TOBS
from repro_torch import sharding as TSHARD
from repro_torch.core import state as TS
from repro_torch.core.dispatch import CapacityPrebaker as TPrebaker
from repro_torch.core.dispatch import RouteDispatcher as TDispatcher
from repro_torch.core.router import EagleConfig as TConfig
from repro_torch.core.router import EagleRouter as TRouter
from repro_torch.core.vectordb import VectorDB as TDB
from repro_torch.launch.mesh import DbMesh, make_db_mesh
from repro_torch.serving import engine as TENG
from test_torch_engine_parity import (DIM, NAMES, R_ATOL, R_RTOL,
                                      _assert_same_responses, _engines,
                                      _requests, oracle, world)  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parent.parent
MESHES = ("1", "2", "4")
_REPORT = {}


def report():
    """The worker's memoized report (module-level, not a fixture: the
    hypothesis shim's fallback wrapper takes no pytest fixtures)."""
    if not _REPORT:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO / "src")
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=4"
                            ).strip()
        r = subprocess.run(
            [sys.executable, str(REPO / "tests" / "_torch_sharded_worker.py")],
            env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
        _REPORT.update(json.loads(r.stdout.splitlines()[-1]))
    return _REPORT


def test_worker_saw_forced_devices():
    assert report()["n_devices"] == 4


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_route_equals_jax_and_unsharded(mesh):
    """route_batch_choices_sharded == JAX's sharded route == the port's
    unsharded route (choices and topk_idx) on every mode and both
    backend pairs, the queries landing on rows duplicated across every
    shard boundary."""
    cases = report()["equiv"][mesh]
    assert len(cases) == 6, sorted(cases)
    assert not [k for k, ok in cases.items() if not ok], cases


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_ties_empty_db_flat_ratings(mesh):
    assert report()["ties"][mesh] == {"combined": True, "local": True}


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_commit_equals_unsharded_and_jax(mesh):
    """After appends and touches, the owner-scatter commit's shards,
    concatenated, equal the unsharded commit and JAX's sharded commit
    field for field; every shard tensor kept its storage; the routes
    over the committed states agree."""
    fields = report()["commit"][mesh]
    assert not [f for f, ok in fields.items() if not ok], fields
    assert len(fields) == 9


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_dispatcher_ledger_equals_jax(mesh):
    """A dispatcher over a mesh counts the JAX one's hits, misses, warmed
    entries and keys (bucket, capacity, records, mode), its key carries
    the mesh, warmup returns the same counts (0 when warm), and the
    choices are equal."""
    led = report()["ledger"][mesh]
    assert led["warm"] == [3, 3, 0, 0]
    assert led["routed"] and led["same_keys"] and led["mesh_in_key"]
    assert led["port"] == led["jax"] == {"hits": 10, "misses": 3,
                                         "warmed": 3, "entries": 3}


@settings(max_examples=8)
@given(st.integers(0, 7))
def test_seeded_random_batches_match_jax(seed):
    assert report()["seeded"][str(int(seed))] is True


# ---------------------------------------------------------------------------
# in-process: drain, mesh checks
# ---------------------------------------------------------------------------

def _both_dbs(capacity=64, n=50, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    dbs = (JDB(dim, capacity=capacity, records_per_query=4),
           TDB(dim, capacity=capacity, records_per_query=4))
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    for db in dbs:
        db.register_consumer("c")
        db.add(emb, np.zeros(n), np.ones(n), np.ones(n),
               query_id=np.arange(n))
    return dbs, rng


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_drain_dirty_sharded_matches_jax(shards):
    """Rows grouped by owning shard under the contiguous split, stale rows
    past a clear dropped, the ledger emptied."""
    dbs, rng = _both_dbs()
    got = [db.drain_dirty_sharded("c", shards) for db in dbs]
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)
    assert sum(r.size for r in got[1]) == 50
    for db in dbs:
        db.add(rng.normal(size=(3, 4)).astype(np.float32), [0] * 3, [1] * 3,
               [0.5] * 3, query_id=[2, 40, 49])
        db.clear()
        db.add(np.ones((1, 4), np.float32), [0], [1], [1.0], query_id=[7])
    got = [db.drain_dirty_sharded("c", shards) for db in dbs]
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)
    assert [r.tolist() for r in got[1] if r.size] == [[0]]
    assert all(r.size == 0 for r in dbs[1].drain_dirty_sharded("c", shards))


def test_check_db_mesh_errors():
    mesh = make_db_mesh(4, ["cpu"] * 4)
    assert TSHARD.check_db_mesh(mesh, 128) == 4
    assert TSHARD.db_shard_count(mesh) == mesh.shape["db"] == 4
    assert TSHARD.check_db_mesh(make_db_mesh(1, ["cpu"]), 7) == 1
    assert JSHARD.check_db_mesh(j_mesh(1), 7) == 1
    with pytest.raises(ValueError, match="does not divide over 3"):
        TSHARD.check_db_mesh(make_db_mesh(3, ["cpu"] * 3), 128)

    class _Other:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="'db' axis"):
        TSHARD.check_db_mesh(_Other(), 128)
    with pytest.raises(ValueError, match="does not divide"):
        TS.shard_state(TS.init_state(3, 4, capacity=6, device="cpu"),
                       make_db_mesh(4, ["cpu"] * 4))
    # the field split is the JAX package's
    assert {f for f, ax in TSHARD.db_state_specs().items() if ax} == {
        f for f, sp in JSHARD.db_state_specs().items() if tuple(sp)}


def test_make_db_mesh_takes_cards_and_never_the_cpu():
    """Without devices it takes the first n cards, and raises when there
    are fewer (never a shard on the CPU); with devices it takes those,
    repeats allowed; a device list of the wrong length raises."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"needs {have + 1} CUDA"):
        make_db_mesh(have + 1)
    mesh = make_db_mesh(2, ["cpu", "cpu"])
    assert isinstance(mesh, DbMesh) and mesh.axis_names == ("db",)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh == make_db_mesh(2, ["cpu"] * 2) and hash(mesh)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        make_db_mesh(2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        make_db_mesh(0)


def test_shard_state_owns_contiguous_row_ranges():
    """Each shard is its own allocation of its rows; the ratings and the
    size are held once per device; route_batch_choices_sharded refuses an
    unsharded state."""
    st = TS.init_state(3, 4, capacity=8, device="cpu")
    st.emb.copy_(torch.arange(32.0).reshape(8, 4))
    sst = TS.shard_state(st, make_db_mesh(4, ["cpu"] * 4))
    assert sst.capacity == 8 and sst.shard_rows == 2 and sst.dim == 4
    for s, e in enumerate(sst.emb):
        assert torch.equal(e, st.emb[2 * s:2 * s + 2])
        assert e.data_ptr() != st.emb[2 * s].data_ptr()
    assert len({t.data_ptr() for t in sst.emb}) == 4
    assert len({id(g) for g in sst.global_ratings}) == 1
    assert len({id(n) for n in sst.size}) == 1
    with pytest.raises(TypeError, match="ShardedRouterState"):
        TS.route_batch_choices_sharded(st, np.ones((1, 4)), 1.0,
                                       np.ones(3))


# ---------------------------------------------------------------------------
# the capacity prebaker (tests/test_dispatch.py's cases on both packages)
# ---------------------------------------------------------------------------

def _routers(capacity, n_prompts, dim=8, n_models=5, seed=0):
    """tests/test_dispatch.py's `_router`, fitted the same in both
    packages."""
    rng = np.random.default_rng(seed)
    names = [f"m{i}" for i in range(n_models)]
    costs = np.arange(1, n_models + 1.0)
    jr = JRouter(names, costs, JConfig(embed_dim=dim), db_capacity=capacity)
    tr = TRouter(names, costs, TConfig(embed_dim=dim), db_capacity=capacity,
                 device="cpu")
    emb = rng.normal(size=(n_prompts, dim)).astype(np.float32)
    a = rng.integers(0, n_models, n_prompts)
    b = (a + 1 + rng.integers(0, n_models - 1, n_prompts)) % n_models
    s = rng.choice([0.0, 0.5, 1.0], n_prompts)
    for r in (jr, tr):
        r.fit(emb, a, b, s, query_id=np.arange(n_prompts))
    return jr, tr, rng


@pytest.mark.parametrize("shards", [0, 2])
def test_prebaker_poll_gating(shards):
    """poll() is inert below the watermark, bakes once per capacity and
    not again; the baked entry is the next capacity's, as in JAX; the
    double buffer holds the two prepared replicas of that capacity
    (sharded over the mesh when there is one)."""
    jr, tr, _ = _routers(64, 40)
    mesh = make_db_mesh(shards, ["cpu"] * shards) if shards else None
    jd = JDispatcher.for_router(jr)
    td = TDispatcher.for_router(tr, mesh=mesh, obs=TOBS.Observability())
    tbuf = TS.DoubleBuffer(tr.db, tr.global_ratings, device="cpu", mesh=mesh)
    jp = JPrebaker(jd, jr.db, watermark=0.75, batch_sizes=[4])
    tp = TPrebaker(td, tr.db, dbuf=tbuf, watermark=0.75, batch_sizes=[4],
                   obs=td.obs)
    assert tr.db.size < 0.75 * tr.db.capacity
    assert tp.poll() is jp.poll() is False
    rng = np.random.default_rng(3)
    while tr.db.size < 48:
        e = rng.normal(size=(1, 8)).astype(np.float32)
        for r in (jr, tr):
            r.update(e, [0], [1], [1.0], query_id=[1000 + r.db.size])
    assert tp.poll() is jp.poll() is True
    jp.join()
    tp.join()
    assert tp.poll() is jp.poll() is False
    assert (jd.bucket(4), 128, jr.db.rcap, "combined", "reference",
            None) in jd._cache
    assert [k[:3] for k in td.cache_stats()["keys"]] == [
        (td.bucket(4), 128, tr.db.rcap)]
    assert td.cache_stats()["warmed"] == td.cache_stats()["misses"] == 1
    (pair,) = tbuf._spares.values()
    assert len(pair) == 2 and all(s.capacity == 128 for s in pair)
    assert all(isinstance(s, TS.ShardedRouterState) == bool(shards)
               for s in pair)
    assert td.obs.registry.counter("dispatch_prebake_total").value == 1


@pytest.mark.parametrize("shards", [0, 4])
def test_prebaker_zero_traffic_misses_across_growth(shards):
    """tests/test_dispatch.py's 200-step loop (route + feedback + commit)
    across a VectorDB grow, with the prebaker polled after each commit,
    on both packages: no traffic miss (every miss a warmed one, the
    grown capacity's baked before the grow), the same ledger as JAX's,
    equal choices at every step; the grown replicas are the prepared
    ones."""
    jr, tr, rng = _routers(256, 150)
    mesh = make_db_mesh(shards, ["cpu"] * shards) if shards else None
    jd = JDispatcher.for_router(jr)
    td = TDispatcher.for_router(tr, mesh=mesh, obs=TOBS.Observability())
    jbuf = JDoubleBuffer(jr.db, jr.global_ratings)
    tbuf = TS.DoubleBuffer(tr.db, tr.global_ratings, device="cpu", mesh=mesh)
    jp = JPrebaker(jd, jr.db, watermark=0.75, batch_sizes=[8])
    tp = TPrebaker(td, tr.db, dbuf=tbuf, watermark=0.75, batch_sizes=[8],
                   obs=td.obs)
    q = rng.normal(size=(8, 8)).astype(np.float32)
    budgets = rng.uniform(0.5, 6.0, 8).astype(np.float32)
    jd.warmup(jbuf.front, batch_sizes=[8])
    td.warmup(tbuf.front, batch_sizes=[8])
    next_row = 150
    start = tr.db.capacity
    for step in range(200):
        got = td.route(tbuf.front, q, budgets)
        np.testing.assert_array_equal(got, jd.route(jbuf.front, q, budgets))
        e = rng.normal(size=(1, 8)).astype(np.float32)
        for r in (jr, tr):
            r.update(e, [step % 5], [(step + 1) % 5], [float(step % 2)],
                     query_id=[next_row])
        next_row += 1
        jbuf.commit(jr.global_ratings)
        tbuf.commit(tr.global_ratings)
        if jp.poll():
            jp.join()
        tp.poll()
    assert tr.db.capacity > start and tr.db.size > start
    tst, jst = td.cache_stats(), jd.cache_stats()
    assert tst["misses"] == tst["warmed"] == 2
    assert {k: tst[k] for k in ("hits", "misses", "warmed", "entries")} == \
        {k: jst[k] for k in ("hits", "misses", "warmed", "entries")}
    assert td.telemetry()["cache_hit_rate"] == 1.0
    assert tbuf._spares == {}          # both prepared replicas were taken
    assert tbuf.front.capacity == tbuf._back[0].capacity == 512
    assert set(tp.prepared) == {512}


# ---------------------------------------------------------------------------
# the engine and the launcher with a mesh and the prebaker
# ---------------------------------------------------------------------------

def _jax_engine(world, **kw):
    corpus, fb, jfleet = world
    jr = JRouter(NAMES, corpus.costs, JConfig(embed_dim=DIM),
                 db_capacity=1 << 12)
    jr.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    return JENG.ServingEngine(jfleet, jr, compare_rate=1.0, seed=0,
                              quality_oracle=oracle,
                              obs=JOBS.Observability(enabled=True), **kw)


def _port_engine(world, fleet, **kw):
    corpus, fb, _ = world
    tr = TRouter(NAMES, corpus.costs, TConfig(embed_dim=DIM),
                 db_capacity=1 << 12, device="cpu")
    tr.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    return TENG.ServingEngine(fleet, tr, compare_rate=1.0, seed=0,
                              quality_oracle=oracle,
                              obs=TOBS.Observability(enabled=True), **kw)


def test_sharded_prebaked_engine_equals_unsharded_and_jax(world):
    """ServingEngine(mesh= 2 shards on the CPU, prebake=True) serves the
    same requests as the unsharded port engine and as JAX's
    ServingEngine(mesh=make_db_mesh(1), prebake=True) (the JAX weights
    carried across): equal choices, tokens and stats, the ratings within
    the bar."""
    corpus = world[0]
    _, flat = _engines(world)
    je = _jax_engine(world, mesh=j_mesh(1), prebake=True)
    sharded = _port_engine(world, flat.fleet,
                           mesh=make_db_mesh(2, ["cpu"] * 2), prebake=True)
    assert isinstance(sharded.dbuf.front, TS.ShardedRouterState)
    assert sharded.dispatch.mesh == sharded.mesh and sharded.prebaker
    for step in range(2):
        jres = je.serve(_requests(corpus, JENG.Request, step, 12))
        for eng in (flat, sharded):
            _assert_same_responses(
                jres, eng.serve(_requests(corpus, TENG.Request, step, 12)))
    for eng in (flat, sharded):
        assert eng.stats == je.stats
        np.testing.assert_allclose(eng.router.global_ratings.numpy(),
                                   np.asarray(je.router.global_ratings),
                                   rtol=R_RTOL, atol=R_ATOL)
    assert int(sharded.dbuf.front.size[0]) == sharded.router.db.size


def test_launcher_db_shards_prebake_matches_jax():
    """Both launchers' build_engine(db_shards=1, prebake=True) route the
    same requests to the same models, the port's engine sharded and
    prebaking; `--db-shards` / `--prebake` no longer raise
    NotImplementedError (without a card the launcher's default device
    raises as every entry point's does)."""
    from repro.launch import serve as JSERVE
    from repro_torch.launch import serve as TSERVE
    je, corpus = JSERVE.build_engine(db_shards=1, prebake=True)
    te, _ = TSERVE.build_engine(db_shards=1, prebake=True, device="cpu")
    assert te.mesh == make_db_mesh(1, ["cpu"]) and te.prebaker is not None
    assert isinstance(te.dbuf.front, TS.ShardedRouterState)
    rng = np.random.default_rng(11)
    budgets = [1.0, 2.5, 3.5, 5.5, 6.5, 8.0, 9.0, 10.0] * 2
    args = [(rng.integers(0, 100, rng.integers(4, 12)).astype(np.int32),
             corpus.embeddings[i], b)
            for i, b in zip(corpus.test_idx[:16], budgets)]
    jres = je.serve([JENG.Request(tokens=t, embedding=e, budget=b,
                                  max_new_tokens=2, rid=k)
                     for k, (t, e, b) in enumerate(args)])
    tres = te.serve([TENG.Request(tokens=t, embedding=e, budget=b,
                                  max_new_tokens=2, rid=k)
                     for k, (t, e, b) in enumerate(args)])
    assert [r.model for r in tres] == [r.model for r in jres]
    assert len({r.model for r in tres}) >= 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSERVE.main(["--db-shards", "2", "--prebake"])
