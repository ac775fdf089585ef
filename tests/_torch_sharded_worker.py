"""Subprocess worker for tests/test_torch_sharded_parity.py: the port's
capacity-sharded route and commit against the JAX package's (DESIGN.md
§12), on the CPU.

The JAX side needs several host devices, and the forced-device XLA flag
must be set before JAX initialises, so the parent spawns THIS script once
with `XLA_FLAGS=--xla_force_host_platform_device_count=4` (as
tests/test_sharded_state.py spawns tests/_sharded_worker.py). It prints
one JSON report line:

  * equiv: on {1,2,4}-shard meshes x every routing mode x both backend
    pairs (JAX reference / port reference, JAX Pallas in interpret mode /
    the port's cuda backend, which takes the plain versions on CPU
    tensors), the port's route_batch_choices_sharded against JAX's
    route_batch_choices_sharded and against the port's unsharded route:
    choices and topk_idx equal;
  * ties: an empty DB (every score -inf) with flat ratings (budget ties),
    the same three-way comparison;
  * commit: after appends and touches of existing rows, the port's
    sharded commit (shards concatenated) against its unsharded commit
    and JAX's sharded commit, field by field (ratings within rtol 1e-5 /
    atol 1e-3, the rest equal), and the routes after it;
  * ledger: the port's RouteDispatcher over a mesh against JAX's over
    its mesh (tests/test_dispatch.py's same-bucket and warmup cases);
  * seeded: random batches of 1..8 queries under random budgets for
    seeds 0-7 on 2- and 4-shard meshes, against both references.

The port's meshes put every shard on the CPU (`make_db_mesh(s,
["cpu"] * s)`); JAX's take s forced host devices.
"""
import json
import sys

import numpy as np

M, D, CAP, RCAP = 4, 16, 128, 6
MESHES = (1, 2, 4)
MODES = ("combined", "global", "local")
BACKENDS = (("reference", "reference"), ("pallas_interpret", "cuda"))
FIELDS = ("global_ratings", "emb", "model_a", "model_b", "outcome", "valid",
          "size")
R_RTOL, R_ATOL = 1e-5, 1e-3


def _fill(dbs, n_rows, rng, dup_pairs=((15, 16), (31, 32), (63, 64))):
    """tests/_sharded_worker.py's seeded feedback, added to every buffer in
    `dbs`: one prompt per row, 1..RCAP-1 records each, bit-identical
    embeddings on row pairs that straddle the shard boundaries of every
    mesh in MESHES."""
    emb = rng.normal(size=(n_rows, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for a, b in dup_pairs:
        if b < n_rows:
            emb[b] = emb[a]
    for i in range(n_rows):
        k = int(rng.integers(1, RCAP))
        a = rng.integers(0, M, k).astype(np.int32)
        b = ((a + rng.integers(1, M, k)) % M).astype(np.int32)
        s = rng.random(k).astype(np.float32).round()
        for db in dbs:
            db.add(np.repeat(emb[i:i + 1], k, axis=0), a, b, s,
                   query_id=np.full(k, i))
    return emb


def main():
    import jax
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core import state as JS
    from repro.core.dispatch import RouteDispatcher as JDispatcher
    from repro.core.vectordb import VectorDB as JDB
    from repro.launch.mesh import make_db_mesh as j_mesh
    from repro_torch.core import state as TS
    from repro_torch.core.dispatch import RouteDispatcher as TDispatcher
    from repro_torch.core.vectordb import VectorDB as TDB
    from repro_torch.launch.mesh import make_db_mesh as t_mesh

    report = {"n_devices": jax.device_count()}
    rng = np.random.default_rng(0)
    costs = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
    # a tie between models 0 and 1: the budget selector must break it
    # identically everywhere
    ratings = np.array([1500.0, 1500.0, 1520.0, 1480.0], np.float32)
    jm = {s: j_mesh(s) for s in MESHES}
    tm = {s: t_mesh(s, ["cpu"] * s) for s in MESHES}

    def rep(mesh, x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    def j_route(s, jstate, q, budgets, **kw):
        return JS.route_batch_choices_sharded(
            JS.shard_state(jstate, jm[s]), rep(jm[s], q),
            rep(jm[s], budgets), rep(jm[s], costs), mesh=jm[s], **kw)

    def same(a, b):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))

    def three_way(s, jstate, tstate, q, budgets, jbk="reference",
                  tbk="reference", **kw):
        """The port's sharded route against JAX's sharded route and the
        port's unsharded route: choices and topk_idx."""
        got = TS.route_batch_choices_sharded(
            TS.shard_state(tstate, tm[s]), q, budgets, costs, backend=tbk,
            **kw)
        jax_ = j_route(s, jstate, q, budgets, backend=jbk, **kw)
        flat = TS.route_batch_choices(tstate, q, budgets, costs,
                                      backend=tbk, **kw)
        return all(same(g.numpy(), w) and same(g.numpy(), f.numpy())
                   for g, w, f in ((got.choices.int(), jax_.choices,
                                    flat.choices.int()),
                                   (got.topk_idx, jax_.topk_idx,
                                    flat.topk_idx)))

    # -- main matrix: meshes x modes x backends --------------------------
    jdb, tdb = JDB(D, capacity=CAP, records_per_query=RCAP), \
        TDB(D, capacity=CAP, records_per_query=RCAP)
    emb = _fill((jdb, tdb), 70, rng)
    jstate = JS.state_from_buffer(jdb, ratings)
    tstate = TS.state_from_buffer(tdb, ratings, device="cpu")
    q = rng.normal(size=(8, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0], q[1] = emb[31], emb[63]     # land exactly on duplicated rows
    budgets = np.array([0.5, 1.0, 2.0, 4.0, 8.0, 3.0, 8.0, 2.0],
                       np.float32)    # infeasible -> full feasibility
    report["equiv"] = {
        str(s): {f"{mode}/{jbk}/{tbk}": three_way(
            s, jstate, tstate, q, budgets, jbk, tbk, mode=mode)
            for mode in MODES for jbk, tbk in BACKENDS}
        for s in MESHES}

    # -- tie stress: empty DB + flat ratings -----------------------------
    flat = np.full(M, 1500.0, np.float32)
    je = JS.state_from_buffer(JDB(D, capacity=CAP, records_per_query=RCAP),
                              flat)
    te = TS.state_from_buffer(TDB(D, capacity=CAP, records_per_query=RCAP),
                              flat, device="cpu")
    report["ties"] = {
        str(s): {mode: three_way(s, je, te, q, budgets, mode=mode)
                 for mode in ("combined", "local")}
        for s in MESHES}

    # -- incremental sharded commit --------------------------------------
    report["commit"] = {}
    for s in MESHES:
        jdb2 = JDB(D, capacity=CAP, records_per_query=RCAP)
        tdb2 = TDB(D, capacity=CAP, records_per_query=RCAP)
        for db in (jdb2, tdb2):
            db.register_consumer("flat")
            db.register_consumer("mesh")
        rng2 = np.random.default_rng(100 + s)
        _fill((jdb2, tdb2), 40, rng2)
        jst = JS.commit(jdb2, ratings, None, consumer="mesh", mesh=jm[s])
        tflat = TS.commit(tdb2, ratings, None, consumer="flat",
                          device="cpu")
        tst = TS.commit(tdb2, ratings, None, consumer="mesh", mesh=tm[s])
        ptrs = [t.data_ptr() for f in FIELDS for t in getattr(tst, f)]
        # touch NEW rows (40..89: every shard but the last of S = 4) and
        # EXISTING rows
        e2 = rng2.normal(size=(50, D)).astype(np.float32)
        for db in (jdb2, tdb2):
            for i in range(50):
                db.add(e2[i], [i % M], [(i + 1) % M], [1.0],
                       query_id=[40 + i])
            for row in (0, 17, 39):
                db.add(db.emb[row], [0], [1], [0.0], query_id=[row])
        new_ratings = ratings + np.float32(3.5)
        jst = JS.commit(jdb2, new_ratings, jst, consumer="mesh",
                        mesh=jm[s])
        tflat = TS.commit(tdb2, new_ratings, tflat, consumer="flat")
        tst = TS.commit(tdb2, new_ratings, tst, consumer="mesh",
                        mesh=tm[s])
        fields = {}
        for f in FIELDS:
            got = torch.cat(getattr(tst, f)) if f not in (
                "global_ratings", "size") else getattr(tst, f)[0]
            want_flat = getattr(tflat, f)
            want_jax = np.asarray(jax.device_get(getattr(jst, f)))
            if f == "global_ratings":
                fields[f] = bool(torch.equal(got, want_flat)) and bool(
                    np.allclose(got.numpy(), want_jax, rtol=R_RTOL,
                                atol=R_ATOL))
            else:
                fields[f] = bool(torch.equal(got, want_flat)) and same(
                    got.numpy(), want_jax)
        fields["in_place"] = ptrs == [t.data_ptr() for f in FIELDS
                                      for t in getattr(tst, f)]
        want = JS.route_batch_choices_sharded(
            jst, rep(jm[s], q), rep(jm[s], budgets), rep(jm[s], costs),
            mesh=jm[s])
        got = TS.route_batch_choices_sharded(tst, q, budgets, costs)
        flat_r = TS.route_batch_choices(tflat, q, budgets, costs)
        fields["route"] = same(got.choices.int().numpy(), want.choices) \
            and same(got.topk_idx.numpy(), want.topk_idx) \
            and same(got.topk_idx.numpy(), flat_r.topk_idx.numpy())
        report["commit"][str(s)] = fields

    # -- the dispatcher's ledger over a mesh -----------------------------
    report["ledger"] = {}
    for s in MESHES:
        jd = JDispatcher(costs, mesh=jm[s], max_bucket=32)
        td = TDispatcher(costs, mesh=tm[s], max_bucket=32)
        jss = JS.shard_state(jstate, jm[s])
        tss = TS.shard_state(tstate, tm[s])
        warm = (td.warmup(tss), jd.warmup(jss), td.warmup(tss),
                jd.warmup(jss))
        routed = True
        for nq in (1, 5, 8, 9, 16, 17, 31, 32, 33):
            qq = rng.normal(size=(nq, D)).astype(np.float32)
            routed &= same(td.route(tss, qq, 2.5), jd.route(jss, qq, 2.5))
        ledgers = [{k: d.cache_stats()[k] for k in ("hits", "misses",
                                                    "warmed", "entries")}
                   for d in (td, jd)]
        keys = [[k[:4] for k in d.cache_stats()["keys"]] for d in (td, jd)]
        report["ledger"][str(s)] = dict(
            warm=list(warm), routed=bool(routed), port=ledgers[0],
            jax=ledgers[1], same_keys=keys[0] == keys[1],
            mesh_in_key=all(k[5] == tm[s] for k in
                            td.cache_stats()["keys"]))

    # -- seeded table (replayed by the parent) ---------------------------
    report["seeded"] = {}
    for seed in range(8):
        r = np.random.default_rng(1000 + seed)
        nq = int(r.integers(1, 9))
        qq = r.normal(size=(nq, D)).astype(np.float32)
        qq /= np.linalg.norm(qq, axis=1, keepdims=True)
        bb = r.uniform(0.0, 10.0, nq).astype(np.float32)
        report["seeded"][str(seed)] = all(
            three_way(s, jstate, tstate, qq, bb) for s in (2, 4))

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
