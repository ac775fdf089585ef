"""The port's dispatch cache and decode step against the JAX package's, on
the CPU.

`tests/test_dispatch.py`'s ledger cases run on both packages with the
same inputs: the port's RouteDispatcher must count the same hits, misses
and warmed entries as the JAX one (on CPU tensors its entries run the
eager route and its key has no replica), `warmup` must return the same
counts (0 when warm), and the choices must be equal. `decode_step` with
its position as a device tensor (what a captured graph reads) must equal
`decode_step` with an int bit for bit, and the JAX `decode_step` within
the fp32 bar of tests/test_torch_model_parity.py. A commit made after a
route must be seen by the next route through the same dispatcher (the
replica is written in place, which is what a captured graph reads).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as JOBS
from repro.configs import get_reduced_config as j_reduced
from repro.core.dispatch import RouteDispatcher as JDispatcher
from repro.core.router import EagleConfig as JConfig
from repro.core.router import EagleRouter as JRouter
from repro.core.state import DoubleBuffer as JDoubleBuffer
from repro.core.state import route_batch as j_route_batch
from repro.core.state import state_from_buffer as j_state_from_buffer
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import obs as TOBS
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import dispatch as TDISP
from repro_torch.core.router import EagleConfig as TConfig
from repro_torch.core.router import EagleRouter as TRouter
from repro_torch.core.state import DoubleBuffer as TDoubleBuffer
from repro_torch.models import transformer as TT

jax.config.update("jax_platform_name", "cpu")

F32_TOL = 1e-4
MAX_LEN = 32
JAX_COUNTERS = ("dispatch_calls_total", "dispatch_rows_total",
                "dispatch_padded_rows_total", "dispatch_cache_hits_total",
                "dispatch_cache_misses_total",
                "dispatch_compile_seconds_total",
                "dispatch_bucket_occupancy", "dispatch_occupancy_last")


def _routers(seed=0, n_models=5, dim=8, n_prompts=40, capacity=64):
    """The same fitted router in both packages (tests/test_dispatch.py's
    `_router`)."""
    rng = np.random.default_rng(seed)
    names = [f"m{i}" for i in range(n_models)]
    costs = np.arange(1, n_models + 1.0)
    jr = JRouter(names, costs, JConfig(embed_dim=dim),
                 db_capacity=capacity)
    tr = TRouter(names, costs, TConfig(embed_dim=dim), db_capacity=capacity,
                 device="cpu")
    emb = rng.normal(size=(n_prompts, dim)).astype(np.float32)
    a = rng.integers(0, n_models, n_prompts)
    b = (a + 1 + rng.integers(0, n_models - 1, n_prompts)) % n_models
    s = rng.choice([0.0, 0.5, 1.0], n_prompts)
    for r in (jr, tr):
        r.fit(emb, a, b, s, query_id=np.arange(n_prompts))
    return jr, tr, rng


def _ledger(d):
    st = d.cache_stats()
    return {k: st[k] for k in ("hits", "misses", "warmed", "entries")}


def _dispatchers(jr, tr, **kw):
    return (JDispatcher.for_router(jr, **kw),
            TDISP.RouteDispatcher.for_router(tr, obs=TOBS.Observability(),
                                             **kw))


def test_same_bucket_no_second_compile():
    jr, tr, rng = _routers(seed=4)
    jd, td = _dispatchers(jr, tr)
    for nq in (9, 13):
        q = rng.normal(size=(nq, 8)).astype(np.float32)
        np.testing.assert_array_equal(td.route(tr.state, q, 3.0),
                                      jd.route(jr.state, q, 3.0))
    assert _ledger(td) == _ledger(jd) == {"hits": 1, "misses": 1,
                                          "warmed": 0, "entries": 1}


def test_warmup_prebakes_ladder():
    jr, tr, rng = _routers(seed=5)
    jd, td = _dispatchers(jr, tr, max_bucket=32)
    assert td.warmup(tr.state) == jd.warmup(jr.state) == 3
    assert td.warmup(tr.state) == jd.warmup(jr.state) == 0
    for nq in (1, 5, 8, 9, 16, 17, 31, 32):
        q = rng.normal(size=(nq, 8)).astype(np.float32)
        np.testing.assert_array_equal(td.route(tr.state, q, 2.5),
                                      jd.route(jr.state, q, 2.5))
    assert _ledger(td) == _ledger(jd)
    assert td.cache_stats()["misses"] == td.cache_stats()["warmed"] == 3
    # (bucket, capacity, records, mode); the backends' names differ
    assert [k[:4] for k in td.cache_stats()["keys"]] == \
        [k[:4] for k in jd.cache_stats()["keys"]]
    assert set(td.cache_stats()) == set(jd.cache_stats())


def test_cache_key_tracks_state_shape():
    rng = np.random.default_rng(6)
    args = (["a", "b", "c"], [1.0, 2.0, 3.0])
    jr = JRouter(*args, JConfig(embed_dim=4), db_capacity=4)
    tr = TRouter(*args, TConfig(embed_dim=4), db_capacity=4, device="cpu")
    fit = (rng.normal(size=(3, 4)).astype(np.float32), [0, 1, 2], [1, 2, 0],
           [1.0, 0.5, 0.0])
    upd = (rng.normal(size=(7, 4)).astype(np.float32), [0] * 7, [1] * 7,
           [1.0] * 7)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    for r in (jr, tr):
        r.fit(*fit, query_id=[0, 1, 2])
    jd, td = _dispatchers(jr, tr)
    np.testing.assert_array_equal(td.route(tr.state, q, 5.0),
                                  jd.route(jr.state, q, 5.0))
    assert td.cache_stats()["entries"] == 1
    for r in (jr, tr):
        r.update(*upd, query_id=list(range(3, 10)))   # forces a grow
    got = td.route(tr.state, q, 5.0)
    np.testing.assert_array_equal(got, jd.route(jr.state, q, 5.0))
    np.testing.assert_array_equal(got, tr.route(q, 5.0).numpy())
    assert _ledger(td) == _ledger(jd) == {"hits": 0, "misses": 2,
                                          "warmed": 0, "entries": 2}


def test_double_buffer_routing_equivalence():
    jr, tr, rng = _routers(seed=8)
    jbuf = JDoubleBuffer(jr.db, jr.global_ratings)
    tbuf = TDoubleBuffer(tr.db, tr.global_ratings, device="cpu")
    jd, td = _dispatchers(jr, tr)
    for _ in range(3):
        q = rng.normal(size=(6, 8)).astype(np.float32)
        budgets = rng.uniform(0.5, 6.0, 6).astype(np.float32)
        got = td.route(tbuf.front, q, budgets)
        want = np.asarray(j_route_batch(
            j_state_from_buffer(jr.db, jr.global_ratings), q, budgets,
            jr.costs, **jr._kw()).choices)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jd.route(jbuf.front, q, budgets))
        fb = (rng.normal(size=(2, 8)).astype(np.float32), [0, 1], [2, 3],
              [1.0, 0.0])
        jr.feedback(*fb)
        tr.feedback(*fb)
        jbuf.commit(jr.global_ratings)
        tbuf.commit(tr.global_ratings)
    assert _ledger(td) == _ledger(jd) == {"hits": 2, "misses": 1,
                                          "warmed": 0, "entries": 1}


def test_telemetry_matches_jax_names_and_counts():
    jr, tr, rng = _routers(seed=9)
    jd = JDispatcher.for_router(jr, obs=JOBS.Observability())
    td = TDISP.RouteDispatcher.for_router(tr, obs=TOBS.Observability())
    for d, st in ((jd, jr.state), (td, tr.state)):
        d.warmup(st, batch_sizes=[8])
        for nq in (3, 8, 20):
            d.route(st, rng.normal(size=(nq, 8)).astype(np.float32), 4.0)
    jt, tt = jd.telemetry(), td.telemetry()
    for k in ("calls", "rows", "padded_rows", "pad_waste_ratio",
              "cache_hit_rate", "cache_hits", "cache_misses"):
        assert tt[k] == jt[k], k
    assert tt["graph_captures_process"] == 0     # nothing captured here
    for name in JAX_COUNTERS:
        assert td.obs.registry.find(name) is not None, name
    for qb in (8, 32):
        assert td.obs.registry.value("dispatch_bucket_total",
                                     bucket=str(qb)) == \
            jd.obs.registry.value("dispatch_bucket_total", bucket=str(qb))


def test_commit_after_route_is_seen_by_next_route():
    """Feedback that flips a query's choice, committed in place after a
    route: the next route through the same dispatcher and replica sees
    it, as a from-scratch upload does."""
    jr, tr, rng = _routers(seed=10, n_models=3, n_prompts=12)
    d = TDISP.RouteDispatcher.for_router(tr, obs=TOBS.Observability())
    st = tr.state
    q = rng.normal(size=(4, 8)).astype(np.float32)
    before = d.route(st, q, 10.0)
    # each query as a new prompt, with model 2 beating 0 and 1 in all
    # of its 8 records
    n = 4 * tr.db.rcap
    emb = np.repeat(q, tr.db.rcap, axis=0)
    tr.update(emb, np.full(n, 2), np.arange(n) % 2, np.ones(n),
              query_id=100 + np.arange(n) // tr.db.rcap)
    after = d.route(tr.state, q, 10.0)
    assert tr.state is st                        # written in place
    np.testing.assert_array_equal(after, tr.route(q, 10.0).numpy())
    assert (after == 2).all() and not (before == 2).all()
    assert d.cache_stats()["hits"] == 1 and d.cache_stats()["misses"] == 1


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("mode", ["combined", "local", "global"])
def test_stale_padding_routes_as_a_fresh_dispatcher(mode, threads):
    """A full bucket, then qb//2 + 1 other rows with budgets at the
    grid's other end through the same bucket: the rows past the live
    ones, in the staging and in the entry's buffers, still hold the first
    batch's (nothing is zero-filled), the choices and top-n rows equal a
    fresh dispatcher's (zeros past the live rows) bit for bit, and the
    staged bytes count the live rows alone."""
    dim, qb = 512, 128
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        _, tr, rng = _routers(seed=12, dim=dim)
        tr.mode = mode               # the ablations' class attribute
        d = TDISP.RouteDispatcher.for_router(tr, obs=TOBS.Observability())
        q1 = rng.normal(size=(qb, dim)).astype(np.float32)
        b1 = rng.uniform(4.5, 5.0, qb).astype(np.float32)
        d.route_result(tr.state, q1, b1)
        nq = qb // 2 + 1
        q2 = rng.normal(size=(nq, dim)).astype(np.float32)
        b2 = rng.uniform(0.5, 1.5, nq).astype(np.float32)
        got = d.route_result(tr.state, q2, b2)
        fresh = TDISP.RouteDispatcher.for_router(tr,
                                                 obs=TOBS.Observability())
        want = fresh.route_result(tr.state, q2, b2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        key = (qb, dim, False)
        assert not fresh._staging[key][0][nq:].any()
        q_host, b_host = d._staging[key][:2]
        np.testing.assert_array_equal(q_host[nq:].numpy(), q1[nq:])
        np.testing.assert_array_equal(b_host[nq:].numpy(), b1[nq:])
        entry, = d._cache.entries.values()
        np.testing.assert_array_equal(entry.q[nq:].numpy(), q1[nq:])
        assert d.telemetry()["staged_bytes"] == (qb + nq) * (dim + 1) * 4
        assert d.obs.registry.value("dispatch_staged_bytes_total") == \
            d.telemetry()["staged_bytes"]
    finally:
        torch.set_num_threads(before)


def _models(arch, seed=0):
    cfg_j = j_reduced(arch, dtype="float32")
    cfg_t = t_reduced(arch, dtype="float32")
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    pt = TT.cast_params(cfg_t, convert.model_params_from_numpy(
        cfg_t, pj, device="cpu"))
    return cfg_j, pj, cfg_t, pt


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b", "whisper-large-v3",
                                  "mamba2-780m"])
def test_decode_step_device_index_matches_int_and_jax(arch):
    cfg_j, pj, cfg_t, pt = _models(arch)
    rng = np.random.default_rng(3)
    b, s = 3, 8 if arch != "mamba2-780m" else cfg_t.ssm_chunk
    toks = rng.integers(0, cfg_t.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    enc = None
    if cfg_t.arch_type == "encdec":
        e = rng.normal(size=(b, cfg_t.n_audio_frames, cfg_t.d_model))
        batch["enc_embeds"] = jnp.asarray(e, jnp.float32)
        enc = torch.tensor(e, dtype=torch.float32)
    lj, cj = JT.prefill(cfg_j, pj, batch, MAX_LEN, cache_dtype=jnp.float32)
    t_toks = torch.tensor(toks, dtype=torch.int64)
    runs = {}
    for how in ("int", "tensor"):
        lt, ct = TT.prefill(cfg_t, pt, t_toks, MAX_LEN,
                            cache_dtype=torch.float32, enc_embeds=enc)
        runs[how] = [lt, ct]
    for i in range(3):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), s + i)
        t_tok = torch.tensor(tok, dtype=torch.int64)
        for how, index in (("int", s + i),
                           ("tensor", torch.tensor([s + i]))):
            runs[how] = list(TT.decode_step(cfg_t, pt, runs[how][1], t_tok,
                                            index))
        assert torch.equal(runs["tensor"][0], runs["int"][0]), f"step {i}"
        np.testing.assert_allclose(runs["tensor"][0].numpy(), np.asarray(lj),
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"step {i}")
    for name, a in runs["int"][1].items():
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, runs["tensor"][1][name]), name
    # a 0-d index is taken too
    lt0, _ = TT.decode_step(cfg_t, pt, runs["int"][1], t_tok,
                            torch.tensor(s + 3))
    lt1, _ = TT.decode_step(cfg_t, pt, runs["tensor"][1], t_tok, s + 3)
    assert torch.equal(lt0, lt1)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-large-v3",
                                  "mamba2-780m"])
def test_fleet_model_steps_are_a_ledger(arch):
    """FleetModel on the CPU: one decode step per row count, counted as
    the dispatcher counts its entries; a warmed row count is a hit, a
    larger one reallocates the static state (its steps are captured
    again), and generate's tokens do not depend on the order."""
    from repro_torch.serving.engine import FleetModel
    cfg = t_reduced(arch, dtype="float32")
    s = 8 if arch != "mamba2-780m" else cfg.ssm_chunk
    m = FleetModel(cfg, seed=1, max_len=s + 8, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (4, s)) \
        .astype(np.int32)
    assert m.warmup([2, 4]) == 2 and m.warmup([4]) == 0
    assert m.rows == 4
    first = m.generate(toks, 4)
    np.testing.assert_array_equal(m.generate(toks[:2], 4), first[:2])
    st = m.cache_stats()
    assert (st["hits"], st["misses"], st["warmed"], st["keys"]) == \
        (2, 2, 2, [2, 4])
    m.generate(np.concatenate([toks, toks[:1]]), 2)    # 5 rows: a grow
    assert m.rows == 5 and m.cache_stats()["keys"] == [5]
    np.testing.assert_array_equal(m.generate(toks, 4), first)
    assert m.cache_stats()["misses"] == 4
    with pytest.raises(ValueError, match="do not fit"):
        m.generate(toks, 10)


def test_fleet_model_prefill_starts_from_zero_state():
    """A generate on the static decode state after another one: mamba2
    with a memory that barely decays (A near 0) gives the tokens of a
    fresh model and of the JAX FleetModel, which prefills a fresh cache
    each time, and leaves the state a fresh model leaves (the reduced
    model's greedy tokens are too flat to show a carried state alone;
    the state's conv windows and SSM state do)."""
    from repro.serving.engine import FleetModel as JFleetModel
    from repro_torch.serving.engine import FleetModel
    arch = "mamba2-780m"
    cfg_j = j_reduced(arch, dtype="float32")
    cfg_t = t_reduced(arch, dtype="float32")
    jm = JFleetModel(cfg_j, seed=3, max_len=48)
    mam = jm.params["blocks"]["mamba"]
    jm.params = {**jm.params, "blocks": {**jm.params["blocks"], "mamba": {
        **mam, "A_log": jnp.full_like(mam["A_log"], -9.0),
        "dt_bias": jnp.full_like(mam["dt_bias"], -1.0)}}}

    def model():
        return FleetModel(cfg_t, max_len=48, device="cpu",
                          params=convert.model_params_from_numpy(
                              cfg_t, jm.params, device="cpu"))
    rng = np.random.default_rng(11)
    first, second = (rng.integers(0, cfg_t.vocab, (3, cfg_t.ssm_chunk))
                     .astype(np.int32) for _ in range(2))
    used, fresh = model(), model()
    used.generate(first, 6)
    got = used.generate(second, 6)
    np.testing.assert_array_equal(got, fresh.generate(second, 6))
    np.testing.assert_array_equal(got, jm.generate(second, 6))
    for name, leaf in used._view(3)[0].items():
        assert torch.equal(leaf, fresh._view(3)[0][name]), name


def test_step_cache_ledger_and_eviction():
    """graphs.StepCache, the ledger both the dispatcher and FleetModel
    keep: a miss makes the entry (in its group's pool), a hit counts
    unless warming, an eviction drops entries and the emptied groups'
    pools, and misses keep counting every entry ever made."""
    from repro_torch import graphs
    seen = []
    cache = graphs.StepCache(on_hit=lambda: seen.append("hit"),
                             on_miss=lambda k, dt: seen.append(k))
    cpu = torch.device("cpu")
    made = [cache.get(k, lambda pool, k=k: ("entry", k, pool), device=cpu,
                      group=k % 2, warm=k == 1) for k in (1, 2, 3)]
    assert made[2] == ("entry", 3, None)          # no pool on the CPU
    assert cache.get(2, None, device=cpu) is made[1]
    assert cache.get(2, None, device=cpu, warm=True) is made[1]
    assert seen == [1, 2, 3, "hit"]
    assert cache.evict(lambda k, e: k % 2) == 2
    assert set(cache._pools) == {0}
    assert cache.as_dict() == {"hits": 1, "misses": 3, "warmed": 1,
                               "compile_s": cache.stats.compile_s,
                               "entries": 1, "keys": [2]}
    assert cache.evicted == 2


def test_launch_recording_keeps_call_site_labels():
    """_build's launch counts: a recorded launch (a graph capture) counts
    nowhere until credited, once per replay, under the call-site label
    it was recorded with; recordings do not nest."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    with _build.site("model decode self"):
        with _build.recording() as rec:
            _build.count_launch("decode_attention")
            with pytest.raises(RuntimeError, match="already open"):
                with _build.recording():
                    pass
        _build.count_launch("decode_attention")
    _build.count_launch("similarity")
    assert rec == {("decode_attention", "model decode self"): 1}
    for _ in range(3):
        _build.credit(rec)
    assert _build.launch_counts()["decode_attention"] == 4
    assert _build.credited_counts() == {"decode_attention": 3}
    assert _build.site_counts() == {
        ("decode_attention", "model decode self"): 4,
        ("similarity", None): 1}
    _build.reset_launches()
    assert _build.site_counts() == _build.credited_counts() == {}


def test_dropped_dispatcher_is_freed_without_gc():
    """The cache's hooks hold the dispatcher's counters, not the
    dispatcher: dropping it frees it (and, on the card, its graphs and
    their pools) at once, not at the next cycle collection."""
    import gc
    import weakref
    _, tr, rng = _routers(seed=12)
    d = TDISP.RouteDispatcher.for_router(tr, obs=TOBS.Observability())
    d.route(tr.state, rng.normal(size=(3, 8)).astype(np.float32), 4.0)
    ref = weakref.ref(d)
    gc.disable()
    try:
        del d
        assert ref() is None
    finally:
        gc.enable()
