#!/usr/bin/env python3
"""Time the fused retrieve at the rows of PERF.md's kernel table against
another checkout's kernels, in one call on one CUDA card.

    python3 scripts/retrieve_rows.py [--parent DIR] [--check-only]
                                     [--rows NAME,NAME]

Run from the root of a checkout. DIR (default `build/parent`) is the root
of another checkout, unpacked for instance with `mkdir -p build/parent &&
git archive <commit> src/repro_torch/kernels | tar -x -C build/parent`.
Its `src/repro_torch/kernels/csrc/retrieve_topn.cu` is built as the port
builds its sources, into the git-ignored `build/retrieve_rows/`, and
called through its own wrapper (`kernels/retrieve_topn.py`, with its
`_build.py`'s C signatures), beside this checkout's library. Either
tree's kernel 1 may return the masked panel or a pool of candidates with
their rows; kernel 2 takes what its kernel 1 gave.

It prints both trees' ptxas reports (registers and spills of each
retrieve kernel), then at each row runs the same inputs through each
build and holds the result bit for bit against the similarity kernel's
masked panel at that build's tile and one stable sort of it (the sharded
rows: against `ref.sharded_panel_topn_ref`; the merge rows: against the
plain merge). The rows:
  - the unsharded pair at n = 20 at every bucket of the routing ladder (8
    .. 1024) over C = 32768, and at buckets 8, 64, 1024 over C = 65536
    (the graph phase's grow); at n = 129, 256, 512 at buckets 1024, 64, 8
    (C = 32768); D = 1536, the last 768 rows past the live count, rows
    tied on tile boundaries;
  - KNN's call (Q = 84, C = 1,470, D = 64, top-40, every row live; random
    rows of its shape);
  - the capacity-sharded retrieve of C = 32768 at S = 1, 2, 4 on the card
    (n = 20) at buckets 1024, 64, 8, and at S = 4, n = 512, bucket 1024;
  - the cross-shard merge alone (kernel 2 over a pool of S x 20 explicit
    rows with their records carried, `merge_shards_cuda`) at S = 1, 2, 4
    and buckets 1024, 64, 8;
  - the graph pools: each tree's unsharded pair at n = 20 captured at
    every bucket of the ladder into one CUDA graph memory pool a replica,
    two replicas, over C = 32768 and 65536; the pools' bytes (the caching
    allocator's private-pool segments) after the captures, each tree in a
    fresh set of pools.
Each build's pair is timed by CUDA events over launches queued ahead of
the device, in the order parent, change, change, parent, and each tree's
kernel 1 and kernel 2 alone, beside the library chain (normalize + matmul
+ torch.topk). Each unsharded row also gets its bounds: each kernel's
(`chip_smoke.retrieve_bound`) and the pair's (`chip_smoke.pair_bound`).
With --check-only it checks and does not time. Writes
`chiprun_out/retrieve_rows.json`; exits non-zero if a build's result
differs.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import subprocess
import sys
from functools import partial
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (timing, bounds, the card line)

C, D, DEAD = 32768, 1536, 768
LADDER = (1024, 512, 256, 128, 64, 32, 16, 8)
# (n, bucket, C) of the unsharded rows; (S, n, bucket) of the sharded
# rows; (S, bucket) of the merge rows
UNSHARDED = ([(20, q, C) for q in LADDER]
             + [(20, q, 2 * C) for q in (1024, 64, 8)]
             + [(n, q, C) for n in (129, 256, 512) for q in (1024, 64, 8)])
SHARDED = ([(s, 20, q) for s in (1, 2, 4) for q in (1024, 64, 8)]
           + [(4, 512, 1024)])
MERGE = [(s, q) for s in (1, 2, 4) for q in (1024, 64, 8)]
KNN = (84, 1470, 64, 40)     # Q, C, D, top-n


def module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parent(parent: Path):
    """The parent's retrieve library, built with the port's flags, its C
    signatures set from the parent's `_build.py`. Returns (library, log,
    the parent's wrapper module)."""
    from repro_torch.kernels import _build
    kernels = parent / "src/repro_torch/kernels"
    signatures = module("parent_build", kernels / "_build.py")._SIGNATURES
    wrappers = module("parent_retrieve", kernels / "retrieve_topn.py")
    out = ROOT / "build" / "retrieve_rows"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libretrieve_topn_parent.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
         str(kernels / "csrc" / "retrieve_topn.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise SystemExit(f"retrieve_rows: the parent's retrieve_topn.cu did "
                         f"not build:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures["retrieve_topn"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, log, wrappers


def report(tree, log):
    from repro_torch.kernels import _build
    regs = {name: (e["registers"], e["spill_stores"], e["spill_loads"])
            for name, e in _build.ptxas_entries(log).items()}
    print(f"{tree}: registers, spill stores, spill loads of each retrieve "
          f"kernel: {regs}", flush=True)
    return regs


def through(tree, fn):
    """fn(wrapper module) with its library calls going to the tree's
    library; tree: (library, wrapper module)."""
    from repro_torch.kernels import _build
    lib, mod = tree
    with mock.patch.object(_build, "library", lambda *a, **kw: lib):
        return fn(mod)


def plan_of(mod, nq, c, d, n):
    """Each tree's plan: its tile and route."""
    pl = mod.plan(nq, c, d, n=n)
    return pl.tile, pl.route


def kernel1(mod, q, db, size, n):
    """Each tree's kernel 1 as a (pool_s, pool_i) pair: a pool of
    candidates with their rows, or the masked panel and None."""
    if "n" in inspect.signature(mod.retrieve_topn_cuda).parameters:
        return mod.retrieve_topn_cuda(q, db, size, n)
    return mod.retrieve_topn_cuda(q, db, size), None


def kernel2(mod, pool, k):
    """Each tree's kernel 2 over its kernel 1's pool."""
    return mod.topn_merge_cuda(*pool, k)


def inputs(gen, nq, c, d, dev):
    db = torch.randn((c, d), generator=gen, device=dev)
    ties = [b for b in (1024, 2048, 3072, 4096, 128, 640) if b < c]
    for b in ties:
        db[b] = db[b - 1]
    q = torch.randn((nq, d), generator=gen, device=dev)
    k = min(nq, len(ties))
    q[:k] = db[[b - 1 for b in ties[:k]]]
    return q, db


def records(gen, c, dev):
    return (torch.randint(0, cs.M, (c, cs.R), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randint(0, cs.M, (c, cs.R), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand((c, cs.R), generator=gen, device=dev),
            torch.rand((c, cs.R), generator=gen, device=dev) < 0.8)


def timed(row, libs, key, fn, iters):
    """fn(wrapper module) timed in the order parent, change, change,
    parent."""
    for tree in ("parent", "change", "change", "parent"):
        row[key].setdefault(tree, []).append(through(
            libs[tree], lambda mod: cs.queued_ms(lambda: fn(mod), iters)))


def unsharded_row(libs, nq, c, d, n, dead, gen, dev, timing):
    from repro_torch.kernels import ref
    from repro_torch.kernels.similarity_topk import similarity_cuda
    q, db = inputs(gen, nq, c, d, dev)
    size = torch.tensor(c - dead, dtype=torch.int32, device=dev) if dead \
        else None
    row = dict(q=nq, c=c, d=d, n=n, equal={}, pair_ms={}, k1_ms={},
               k2_ms={}, tile={}, route={})
    k = min(n, c)
    for tree in ("parent", "change"):
        tile, route = through(libs[tree], lambda mod: plan_of(
            mod, nq, c, d, n))
        got = through(libs[tree], lambda mod: mod.topn_cuda(q, db, size, n))
        want = ref.panel_topn_ref(q, db, size, n, similarity_fn=partial(
            similarity_cuda, tile=tile))
        row["equal"][tree] = all(torch.equal(x, y) for x, y in
                                 zip(got, want))
        row["tile"][tree], row["route"][tree] = tile, route
    panel = through(libs["change"], lambda mod: kernel1(
        mod, q, db, size, n))[0]
    passes = int(ref.key_select_ref(panel, None, k)[1].sum())
    del panel
    (b1, by1), (b2, by2) = cs.retrieve_bound(nq, c, d, k, passes)
    bp, byp = cs.pair_bound(nq, c, d, k)
    row.update(bound1_ms=b1, bound1_by=by1, bound2_ms=b2, bound2_by=by2,
               bound_pair_ms=bp, bound_pair_by=byp, passes=passes,
               live=c - dead)
    if not timing:
        return row
    iters = 10 if nq >= 256 else 30
    timed(row, libs, "pair_ms", lambda mod: mod.topn_cuda(q, db, size, n),
          iters)
    for tree in ("parent", "change"):
        pool = through(libs[tree], lambda mod: kernel1(mod, q, db, size, n))
        row["k1_ms"][tree] = through(libs[tree], lambda mod: cs.queued_ms(
            lambda: kernel1(mod, q, db, size, n), iters))
        row["k2_ms"][tree] = through(libs[tree], lambda mod: cs.queued_ms(
            lambda: kernel2(mod, pool, k), iters))
        if tree == "change":
            row["topk_over_panel_ms"] = cs.queued_ms(
                lambda: torch.topk(pool[0], k, dim=-1), iters)
        del pool
    norm = torch.nn.functional.normalize
    row["library_ms"] = cs.queued_ms(lambda: torch.topk(torch.matmul(
        norm(q, dim=-1), norm(db, dim=-1).T), k, dim=-1), 10)
    return row


def sharded_row(libs, shards, n, nq, gen, dev, timing):
    from repro_torch.kernels import ref
    from repro_torch.kernels.similarity_topk import similarity_cuda
    q, db = inputs(gen, nq, C, D, dev)
    recs = records(gen, C, dev)
    size = torch.tensor(C - DEAD, dtype=torch.int32, device=dev)
    emb = cs._shards(db, shards)
    panels = tuple(cs._shards(x, shards) for x in recs)
    sizes = [size] * shards
    row = dict(q=nq, c=C, shards=shards, n=n, equal={}, pair_ms={})
    for tree in ("parent", "change"):
        tile = through(libs[tree], lambda mod: plan_of(
            mod, nq, C // shards, D, n))[0]
        got = through(libs[tree], lambda mod: mod.sharded_topn_cuda(
            q, emb, panels, sizes, n))
        want = ref.sharded_panel_topn_ref(q, emb, panels, sizes, n,
                                          similarity_fn=partial(
                                              similarity_cuda, tile=tile))
        row["equal"][tree] = all(torch.equal(x, y) for x, y in
                                 zip(got[:3] + got[3], want[:3] + want[3]))
    if timing:
        timed(row, libs, "pair_ms", lambda mod: mod.sharded_topn_cuda(
            q, emb, panels, sizes, n), 10 if nq >= 256 else 30)
    return row


def merge_row(libs, shards, nq, gen, dev, timing):
    """The cross-shard merge alone over a pool of `shards` x 20 candidates
    (random scores in descending runs, distinct global rows, a shard's
    tied scores on its first two slots) with their records carried."""
    from repro_torch.kernels import ref
    n, width = 20, shards * 20
    pool_s = torch.rand((nq, shards, n), generator=gen, device=dev)
    pool_s = pool_s.sort(dim=-1, descending=True)[0]
    pool_s[:, :, 1] = pool_s[:, :, 0]
    pool_s = pool_s.reshape(nq, width).contiguous()
    rows = torch.stack([torch.randperm(8192, generator=gen, device=dev)[:n]
                        + 8192 * s for s in range(shards)], 0)
    pool_i = rows.reshape(1, width).expand(nq, width).to(
        torch.int32).contiguous()
    recs = tuple(x.reshape(nq, width, cs.R)
                 for x in records(gen, nq * width, dev))
    row = dict(q=nq, shards=shards, pool=width, equal={}, merge_ms={})
    want = ref.topn_merge_ref(pool_s, pool_i, n, carried=recs,
                              farthest_first=True)
    for tree in ("parent", "change"):
        got = through(libs[tree], lambda mod: mod.merge_shards_cuda(
            pool_s, pool_i, recs, n))
        row["equal"][tree] = all(torch.equal(x, y) for x, y in
                                 zip(got[:3] + got[3], want[:3] + want[3]))
    if timing:
        timed(row, libs, "merge_ms", lambda mod: mod.merge_shards_cuda(
            pool_s, pool_i, recs, n), 50)
    return row


def pools_row(libs, gen, dev, timing):
    """Each tree's graph pools after capturing the pair at n = 20 at every
    bucket of the ladder, two replicas (a pool each, as the dispatcher
    groups a replica's graphs), over C and 2 C rows. The captures' outputs
    are kept, as a route graph keeps them; each graph's replay is held
    equal to the eager pair."""
    from repro_torch import graphs
    row = dict(equal={}, pool_gb={})
    for tree in ("parent", "change"):
        for c in (C, 2 * C):
            steps = []
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = cs.graph_pool_gb()
            for _ in range(2):
                q_all, db = inputs(gen, LADDER[0], c, D, dev)
                size = torch.tensor(c - DEAD, dtype=torch.int32, device=dev)
                pool = graphs.pool_handle(dev)
                for nq in LADDER:
                    args = (q_all[:nq].contiguous(), db, size)
                    steps.append((args, through(
                        libs[tree], lambda mod: graphs.Step(
                            partial(mod.topn_cuda, n=20), *args,
                            device=dev, pool=pool))))
            torch.cuda.synchronize()
            row["pool_gb"][f"{tree} C={c}"] = cs.graph_pool_gb() - before
            row["equal"][f"{tree} C={c}"] = all(
                all(torch.equal(x, y) for x, y in zip(step(*args), through(
                    libs[tree], lambda mod: mod.topn_cuda(*args, 20))))
                for args, step in steps)
            del steps
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--rows", default="",
                    help="comma-separated row names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("retrieve_rows: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import retrieve_topn as RT
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    parent_lib, parent_log, parent_mod = build_parent(Path(args.parent))
    libs = {"parent": (parent_lib, parent_mod),
            "change": (_build.library("retrieve_topn"), RT)}
    out = dict(card=card, build={
        "parent": report("parent", parent_log),
        "change": report("change", _build.build_log("retrieve_topn"))})
    pick = set(filter(None, args.rows.split(",")))
    gen = torch.Generator(device=dev).manual_seed(30)
    timing = not args.check_only
    rows = {f"n={n} Q={nq} C={c}": partial(unsharded_row, libs, nq, c, D,
                                           n, DEAD)
            for n, nq, c in UNSHARDED}
    rows["knn"] = partial(unsharded_row, libs, KNN[0], KNN[1], KNN[2],
                          KNN[3], 0)
    rows.update({f"S={s} n={n} Q={nq}": partial(sharded_row, libs, s, n, nq)
                 for s, n, nq in SHARDED})
    rows.update({f"merge S={s} Q={nq}": partial(merge_row, libs, s, nq)
                 for s, nq in MERGE})
    rows["pools"] = partial(pools_row, libs)
    ok = True
    for name, fn in rows.items():
        if pick and name not in pick:
            continue
        row = fn(gen, dev, timing)
        torch.cuda.empty_cache()
        ok &= all(row["equal"].values())
        out[name] = row
        line = f"{name}: equal {row['equal']}"
        for key in ("pair_ms", "merge_ms"):
            if row.get(key):
                best = {k: min(v) for k, v in row[key].items()}
                line += (f"; {key} {row[key]}; change / parent "
                         f"{best['change'] / best['parent']}")
        for key in ("route", "tile", "passes", "k1_ms", "k2_ms",
                    "bound1_ms", "bound2_ms", "bound_pair_ms",
                    "topk_over_panel_ms", "library_ms", "pool_gb"):
            if key in row:
                line += f"; {key} {row[key]}"
        print(line + f" [{card}]", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "retrieve_rows.json").write_text(
        json.dumps(out, indent=1, default=str))
    print("every build equal to its reference" if ok else
          "a build differs from its reference")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
