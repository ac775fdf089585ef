"""route_open: Eagle as a routing service, driven open loop on the real
clock.

Set-up: the corpus of the configuration's `corpus_seed`, `EagleRouter.fit`
on its records, a `DoubleBuffer` over the router's DB and a
`RouteDispatcher` whose graphs are captured at the buckets this traffic
uses, on both replicas; the feedback path is warmed by the mix's
`warm_feedback` batches (part of the history the check replays).

Window: route requests (micro-batches of prompt embeddings, each query
with its budget) and feedback batches (new prompts' pairwise records)
fall due by a schedule drawn from `--seed`. One thread takes them in due
order, as `ServingEngine.serve` composes its steps:

  route     RouteDispatcher.route(dbuf.front, embs, budgets): the host
            choices (steps 2 and 3)
  feedback  EagleRouter.update(records, prompt ids), then
            DoubleBuffer.commit and a synchronise: the front replica
            holds them (step 5)

Each request is timed from its due time. Every request due in the window
is served, however late. The route rate is the cell's (`rate_hz`, from
the sweep); the mix gives the rest. The sampled route requests (drawn
from the seed) call `RouteDispatcher.route_result`, the same captured
step with its top-n rows read back as well.

Check (after the window, the program's state copied out and freed): the
plain reference (eaglebench/reference/router.py) rebuilds the DB and the
global ratings from the same records, and judges
  choice_gap        the widest gap, in rating points, by which the
                    reference's score of a sampled query's choice lies
                    below its best affordable score, each query against
                    the DB and ratings its route read;
  topn_gap          the widest gap, in cosine, by which the least
                    reference cosine of a sampled query's top-n rows (as
                    the program's retrieve returned them) lies below the
                    reference's n-th best: the similarity and the select
                    alone;
  ratings_gap       the front replica's global ratings against the
                    reference's fold of every record;
  emb_gap           the front replica's embeddings against the
                    reference's;
  records_mismatch  entries of the front replica's records (models,
                    outcomes, slots' masks) and live-row count that
                    differ from the reference's (exact).
"""
from __future__ import annotations

import gc
import sys
import time
import types
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from eaglebench import tracing as TR
from eaglebench.reference import router as REF
from eaglebench.traffic import arrivals, corpus as CORPUS, user

ROUTE, FEEDBACK = 0, 1
PANELS = ("model_a", "model_b", "outcome", "valid")


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


class World:
    """The program under test and everything drawn for one run."""

    def __init__(self, config: Dict, mix: Dict, rate_hz: float, seed: int,
                 device, traced: bool):
        from repro_torch import obs as OBS
        from repro_torch.core.dispatch import RouteDispatcher
        from repro_torch.core.router import EagleConfig, EagleRouter
        from repro_torch.core.state import DoubleBuffer

        self.config, self.mix, self.device = config, mix, device
        rc, fleet, db = config["router"], config["fleet"], config["db"]
        self.costs = np.asarray(fleet["costs"], np.float32)
        self.corpus = CORPUS.make_corpus(config["corpus"], self.costs,
                                         rc["embed_dim"], device)
        self.fit = CORPUS.fit_records(self.corpus, config["corpus"])
        self.router = EagleRouter(
            fleet["names"], self.costs,
            EagleConfig(p_global=rc["p_global"],
                        n_neighbors=rc["n_neighbors"],
                        k_factor=rc["k_factor"],
                        init_rating=rc["init_rating"],
                        embed_dim=rc["embed_dim"]),
            db_capacity=db["capacity"], device=device)
        if self.router.db.rcap != db["records_per_prompt"]:
            raise ValueError(f"the DB holds {self.router.db.rcap} records a "
                             f"prompt, the configuration "
                             f"{db['records_per_prompt']}")
        self.router.fit(self.corpus.embeddings[self.fit.prompt],
                        self.fit.model_a, self.fit.model_b,
                        self.fit.outcome, query_id=self.fit.prompt)
        self.obs = OBS.Observability(enabled=traced, trace_capacity=1 << 16,
                                     profiler=traced)
        self.router.obs = self.obs
        self.dbuf = DoubleBuffer(self.router.db, self.router.global_ratings,
                                 device=self.router.device, obs=self.obs)
        self.dispatch = RouteDispatcher.for_router(self.router, obs=self.obs)
        self._draw(rate_hz, seed)

    def _draw(self, rate_hz: float, seed: int):
        mix, c = self.mix, self.corpus
        rng = np.random.default_rng(seed)
        r, fb = mix["route"], mix["feedback"]
        seconds = mix["seconds"]
        test = c.test_idx
        self.route_due = arrivals.poisson_times(rate_hz, seconds, rng)
        self.sizes = arrivals.loguniform_sizes(
            r["batch_min"], r["batch_max"], len(self.route_due), rng)
        pool = rng.permutation(test)
        self.q_pool = np.concatenate([c.embeddings[pool]] * 2)
        grid = np.linspace(self.costs.min(), self.costs.max(),
                           r["budget_points"]).astype(np.float32)
        self.b_pool = grid[rng.integers(len(grid), size=2 * len(test))]
        self.offsets = rng.integers(0, len(test), size=len(self.route_due))
        self.fb_due = arrivals.poisson_times(fb["rate_hz"], seconds, rng)
        n_batches = mix["warm_feedback"] + len(self.fb_due)
        per = fb["prompts"]
        if n_batches * per > len(test):
            raise ValueError(f"{n_batches} feedback batches of {per} new "
                             f"prompts, but {len(test)} test prompts")
        prompts = rng.permutation(test)
        self.batches = [CORPUS.feedback_records(
            c, prompts[i * per:(i + 1) * per], fb["pairs_per_prompt"], rng,
            user.outcome) for i in range(n_batches)]
        self.fb_emb = [c.embeddings[b.prompt] for b in self.batches]
        self.sample = np.sort(rng.choice(
            len(self.route_due), size=min(mix["check"]["sample_batches"],
                                          len(self.route_due)),
            replace=False))

    def query(self, i: int):
        lo = self.offsets[i]
        hi = lo + self.sizes[i]
        return self.q_pool[lo:hi], self.b_pool[lo:hi]

    def apply(self, j: int):
        """Feedback batch j: the router's update, the commit, a
        synchronise. Returns (update seconds, commit seconds)."""
        b = self.batches[j]
        t0 = time.perf_counter()
        self.router.update(self.fb_emb[j], b.model_a, b.model_b, b.outcome,
                           query_id=b.prompt)
        t1 = time.perf_counter()
        self.dbuf.commit(self.router.global_ratings)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return t1 - t0, time.perf_counter() - t1

    def warm(self):
        """Route graphs at this traffic's buckets on both replicas, each
        route replayed twice, and the feedback path, by the mix's warm
        batches (their commits swap the replicas)."""
        sizes = np.unique(self.sizes)
        buckets = sorted({self.dispatch.bucket(int(s)) for s in sizes})
        for j in range(self.mix["warm_feedback"]):
            self.dispatch.warmup(self.dbuf.front, [int(s) for s in sizes])
            for qb in buckets:
                for _ in range(2):
                    self.dispatch.route(self.dbuf.front, self.q_pool[:qb],
                                        self.b_pool[:qb])
            self.apply(j)


def _wait_until(t: float):
    """Spin until t: a sleeping thread wakes late and on a cold core."""
    while time.perf_counter() < t:
        pass


def _schedule(w: World):
    ev = [(t, ROUTE, i) for i, t in enumerate(w.route_due)]
    ev += [(t, FEEDBACK, j) for j, t in enumerate(w.fb_due)]
    return sorted(ev)


def _window(w: World, seconds: float, traced: bool, slice_s: float,
            trace_path: Path):
    """Serve the schedule; returns what was measured."""
    events = _schedule(w)
    keep = set(int(i) for i in w.sample)
    warm = w.mix["warm_feedback"]
    m = types.SimpleNamespace(
        route_lat=[], route_s=[], fb_apply=[], update_s=[], commit_s=[],
        wake_lag=[], queue_wait=[], epochs={}, choices={}, top={},
        routes=[],
        slice_routes=[], slice_path=None)
    prof = None
    t_slice = seconds - slice_s
    t0 = time.perf_counter() + 0.01
    m.t_open = t0
    free_at = t0
    epoch = 0
    for due, kind, i in events:
        if traced and prof is None and due >= t_slice:
            prof = TR.profiler(w.device)
            prof.start()
        on = prof is not None
        t_due = t0 + due
        with TR.mark(on, "eb.wait"):
            _wait_until(t_due)
        start = time.perf_counter()
        (m.wake_lag if free_at <= t_due else m.queue_wait).append(
            max(0.0, start - t_due))
        if kind == ROUTE:
            q, b = w.query(i)
            with TR.mark(on, "eb.route"):
                if i in keep:
                    choices, m.top[i] = w.dispatch.route_result(
                        w.dbuf.front, q, b)
                else:
                    choices = w.dispatch.route(w.dbuf.front, q, b)
            end = time.perf_counter()
            m.route_lat.append(end - t_due)
            m.route_s.append(end - start)
            shape = (len(q), w.dispatch.bucket(len(q)), epoch)
            m.routes.append(shape)
            if on:
                m.slice_routes.append(shape)
            if i in keep:
                m.choices[i] = choices
                m.epochs[i] = epoch
        else:
            with TR.mark(on, "eb.feedback"):
                du, dc = w.apply(warm + i)
            end = time.perf_counter()
            epoch += 1
            m.fb_apply.append(end - t_due)
            m.update_s.append(du)
            m.commit_s.append(dc)
        free_at = end
        if end > t0 + seconds + 60.0:
            raise RuntimeError(f"the backlog outgrew the window: request "
                               f"due at {due:.3f} s ends at {end - t0:.3f}")
    m.t_close = time.perf_counter()
    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(str(trace_path))
        m.slice_path = trace_path
    return m


def _front_to_host(w: World) -> Dict[str, np.ndarray]:
    st = w.dbuf.front
    out = {f: getattr(st, f).cpu().numpy() for f in ("emb",) + PANELS}
    out["size"] = int(st.size)
    out["global_ratings"] = st.global_ratings.cpu().numpy()
    return out


def _records(w: World):
    """Every record the router was given, in order: the fit's, then the
    feedback batches'."""
    parts = [w.fit] + w.batches
    return [np.concatenate([getattr(p, f) for p in parts])
            for f in ("prompt", "model_a", "model_b", "outcome")]


def judge(w: World, choices: Dict[int, np.ndarray], epochs: Dict[int, int],
          top: Dict[int, np.ndarray], front: Dict,
          precision_under_test: str = "program"):
    """The compared numbers of the program's outputs, or, with
    `precision_under_test` one of the reference's controls ("control",
    "control_tf32"), of that control computed in the program's place.
    Returns {name: value}, and the sampled queries' witness arrays under
    "_witness"."""
    cfg, rc = w.config, w.config["router"]
    k, n, p = rc["k_factor"], rc["n_neighbors"], rc["p_global"]
    slots = cfg["db"]["records_per_prompt"]
    prompt, a, b, s = _records(w)
    dev = w.device
    ref_db = REF.build_db(prompt, a, b, s, w.corpus.embeddings, slots)
    rows_fit = len(np.unique(w.fit.prompt))
    per = w.mix["feedback"]["prompts"]
    warm = w.mix["warm_feedback"]

    def folds(precision):
        g = REF.elo_fold([rc["init_rating"]] * len(w.costs), w.fit.model_a,
                         w.fit.model_b, w.fit.outcome, k=k,
                         precision=precision)
        out = [g] if warm == 0 else []
        for j, bt in enumerate(w.batches):
            g = REF.elo_fold(g, bt.model_a, bt.model_b, bt.outcome, k=k,
                             precision=precision)
            if j + 1 >= warm:
                out.append(g)
        return out                          # out[e]: after epoch e

    def per_query(g_epochs):
        return np.concatenate([np.repeat(g_epochs[epochs[i]][None],
                                         len(w.query(i)[0]), axis=0)
                               for i in ids])

    g_ref = folds("reference")
    ids = sorted(choices)
    qs = np.concatenate([w.query(i)[0] for i in ids])
    bs = np.concatenate([w.query(i)[1] for i in ids])
    size = np.concatenate([np.full(len(w.query(i)[0]),
                                   rows_fit + per * (warm + epochs[i]))
                           for i in ids])
    scores, ref_choice = REF.route(qs, ref_db, size, per_query(g_ref),
                                   w.costs, bs, n=n, k=k, p=p, device=dev)
    if precision_under_test == "program":
        got = np.concatenate([choices[i] for i in ids])
        got_top = np.concatenate([top[i] for i in ids])
        ratings = front["global_ratings"]
        got_size = front["size"]
        rows = min(got_size, len(ref_db.prompt))
        emb = front["emb"][:rows]
        got_panels = {f: front[f][:rows] for f in PANELS}
    else:
        ctl = precision_under_test
        g_ctl = folds(ctl)
        ctl_db = REF.build_db(prompt, a, b, s, w.corpus.embeddings, slots,
                              precision=ctl)
        _, got = REF.route(qs, ctl_db, size, per_query(g_ctl), w.costs, bs,
                           n=n, k=k, p=p, precision=ctl, device=dev)
        got_top, _ = REF.neighbours(qs, ctl_db, size, n=n, precision=ctl,
                                    device=dev)
        ratings = g_ctl[-1]
        emb = ctl_db.emb
        got_panels = {f: getattr(ctl_db, f) for f in PANELS}
        got_size = len(ctl_db.prompt)
    gaps = REF.choice_gaps(scores, got, w.costs, bs)
    nbr_gaps, ref_cos, ref_rows = REF.topn_gaps(qs, ref_db, size, got_top,
                                                device=dev)
    rows = min(got_size, len(ref_db.prompt))
    mismatch = abs(got_size - len(ref_db.prompt)) * slots
    for f in PANELS:
        want = getattr(ref_db, f)[:rows]
        mismatch += int(np.sum(np.asarray(got_panels[f][:rows], np.float64)
                               != np.asarray(want, np.float64)))
    return {
        "choice_gap": float(np.max(gaps)) if np.all(np.isfinite(gaps))
        else 1e9,
        "topn_gap": float(np.max(nbr_gaps)) if np.all(np.isfinite(nbr_gaps))
        else 1e9,
        "ratings_gap": float(np.max(np.abs(np.asarray(ratings, np.float64)
                                           - g_ref[-1]))),
        "emb_gap": float(np.max(np.abs(np.asarray(emb[:rows], np.float64)
                                       - ref_db.emb[:rows]))),
        "records_mismatch": float(mismatch),
        "queries_compared": float(len(qs)),
        "_witness": {"choice_gap": gaps, "topn_gap": nbr_gaps,
                     "ref_cos": ref_cos, "choice": np.asarray(got),
                     "ref_choice": ref_choice,
                     "same_order": np.all(np.asarray(got_top)
                                          == ref_rows[:, :n], axis=1)},
    }


def _log_witness(got: Dict, n: int):
    """The sampled queries' neighbour cosines, and what lies under the
    widest choice gap: its top-n gap, the reference's n-th and (n+1)-th
    cosines, whether the top n came in the reference's order (the replay
    folds the farthest first) and the closest two of them, the two
    choices."""
    wt = got["_witness"]
    cos = wt["ref_cos"]
    q = lambda x: " / ".join(f"{v:.4f}" for v in  # noqa: E731
                             np.quantile(x, [0.05, 0.5, 0.95]))
    _log(f"neighbour cosines (reference, sampled queries, q05 / q50 / q95): "
         f"1st {q(cos[:, 0])}; {n}th {q(cos[:, n - 1])}; {n}th - {n + 1}th "
         f"{np.quantile(cos[:, n - 1] - cos[:, n], 0.5):.3e} median, "
         f"{np.min(cos[:, n - 1] - cos[:, n]):.3e} least")
    i = int(np.argmax(wt["choice_gap"]))
    order = wt["same_order"]
    _log(f"widest choice gap {wt['choice_gap'][i]:.6g} at sampled query {i}: "
         f"top-n gap {wt['topn_gap'][i]:.3e}, reference {n}th / {n + 1}th "
         f"cosine {cos[i, n - 1]:.9f} / {cos[i, n]:.9f}, top n in the "
         f"reference's order {bool(order[i])}, closest two of them "
         f"{np.min(-np.diff(cos[i, :n])):.3e} apart, choice "
         f"{int(wt['choice'][i])}, reference's {int(wt['ref_choice'][i])}; "
         f"{int(np.sum(wt['topn_gap'] > 0))} of {len(cos)} queries with "
         f"another top n, {int(np.sum(~order))} in another order")


def _ctx(w: World, m, slice_, telemetry) -> types.SimpleNamespace:
    spans: Dict[str, List[float]] = defaultdict(list)
    for _, name, _, dur, _, _ in w.obs.tracer.spans():
        spans[name].append(dur / 1e9)
    rc = w.config["router"]
    return types.SimpleNamespace(
        trace=slice_, spans=dict(spans), telemetry=telemetry,
        routes=m.routes, slice_routes=m.slice_routes, route_s=m.route_s,
        update_s=m.update_s, commit_s=m.commit_s, fb_apply=m.fb_apply,
        dim=rc["embed_dim"],
        n=rc["n_neighbors"], records=w.config["db"]["records_per_prompt"],
        rows_fit=len(np.unique(w.fit.prompt)),
        rows_per_batch=w.mix["feedback"]["prompts"],
        warm=w.mix["warm_feedback"])


def run(cell: Dict, config: Dict, mix: Dict, *, seed: int, seconds: float,
        traced: bool, device: torch.device, t_start: float, out_dir: Path,
        control: bool = False) -> Dict:
    """One run of a route_open cell. Returns the run's record: attempted,
    failed, end_to_end, ctx (what the per-layer readers read), checks
    ({name: (value, limit)}), memory_peak_bytes, and, traced, the slice."""
    mix = dict(mix, seconds=seconds)
    _log(f"set-up: the program imported at {time.perf_counter() - t_start:.3f} s")
    w = World(config, mix, cell["rate_hz"], seed, device, traced)
    _log(f"set-up: fitted and drawn at {time.perf_counter() - t_start:.3f} s")
    w.warm()
    _log(f"set-up: warm at {time.perf_counter() - t_start:.3f} s")
    if traced:   # the profiler's first start sets up its tracer: not in
        with TR.profiler(device):   # the window
            torch.ones(1, device=device).add_(1)
    tel0 = w.dispatch.telemetry()
    # set-up's objects leave the collector's generations: a collection
    # in the window then walks only what the window makes
    gc.collect()
    gc.freeze()
    base = f"{cell['name']}-{seed}"
    m = _window(w, seconds, traced, min(mix["trace_slice_s"], seconds / 2),
                out_dir / f"{base}.trace.json")
    setup_s = m.t_open - t_start
    tel1 = w.dispatch.telemetry()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    _log(f"window {m.t_close - m.t_open:.3f} s: {len(m.route_lat)} routes "
         f"({int(sum(r[0] for r in m.routes))} queries), "
         f"{len(m.fb_apply)} feedback batches")
    lag = m.wake_lag or [0.0]
    _log(f"generator lag behind due (server idle): max {max(lag) * 1e3:.4f} "
         f"ms, mean {np.mean(lag) * 1e3:.4f} ms over {len(m.wake_lag)}; "
         f"queue wait (server busy): max "
         f"{max(m.queue_wait or [0.0]) * 1e3:.4f} ms over "
         f"{len(m.queue_wait)}")
    slice_ = TR.read_slice(m.slice_path) if m.slice_path else None
    ctx = _ctx(w, m, slice_, {k: tel1[k] - tel0[k]
                              for k in ("calls", "rows", "padded_rows")})
    samples = {"route_latency_s": m.route_lat, "feedback_apply_s": m.fb_apply,
               "route_call_s": m.route_s, "update_s": m.update_s,
               "commit_s": m.commit_s}
    gc.unfreeze()
    front = _front_to_host(w)
    sampled = (m.choices, m.epochs, m.top)
    # the program's state goes before the reference runs
    w.router = w.dbuf = w.dispatch = w.obs = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    got = judge(w, *sampled, front)
    _log(f"check {time.perf_counter() - t_check:.3f} s over "
         f"{int(got['queries_compared'])} queries")
    _log_witness(got, w.config["router"]["n_neighbors"])
    ctl = {c: judge(w, *sampled, front, c) for c in REF.PRECISIONS[1:]} \
        if control else None
    limits = cell["limits"]
    return {
        "attempted": len(m.route_lat) + len(m.fb_apply),
        "failed": 0,
        "end_to_end": {
            "route_p95_ms": float(np.percentile(m.route_lat, 95)) * 1e3,
            "setup_s": setup_s,
        },
        "ctx": ctx,
        "checks": {k: (got[k], limits[k]) for k in limits},
        "control": None if ctl is None else
        {c: {k: (v[k], limits[k]) for k in limits} for c, v in ctl.items()},
        "memory_peak_bytes": peak,
        "slice": slice_,
        "samples": samples,
        "captures_in_window": tel1["cache_misses"] - tel0["cache_misses"],
    }
