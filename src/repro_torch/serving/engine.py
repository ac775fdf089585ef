"""Serving engine: the Eagle router in front of the model fleet.

Workflow per Fig. 1 of the paper:
  ① requests arrive (prompt tokens + prompt embedding + budget)
  ②/③ Eagle ranks the fleet per request and picks the best model within
     the budget (core/dispatch.py over a DoubleBuffer)
  ④ requests are grouped per chosen model, batch-prefilled and greedily
     decoded (FleetModel: a dense, mamba2 or whisper model, its attention
     in the flash and decode kernels on the card)
  ⑤ with probability `compare_rate` a second model also answers and a
     simulated user preference is appended to the DB + ELO (the online,
     training-free update), then committed into the back buffer

A port of the JAX package's `serving/engine.py`. Where the JAX package
jits prefill and decode and serves routes from compiled executables, the
port captures CUDA graphs: the dispatcher's route graphs
(core/dispatch.py) and, per fleet model, one graph of the decode step
per row count (`FleetModel`); prefill stays eager, as its length varies.
`warmup()` and `warmup_generate()` capture before traffic. With a DB
mesh (`mesh=`, launch/mesh.py) the dispatcher and both buffer replicas
are capacity-sharded; with `prebake=True` a CapacityPrebaker prepares
the next capacity's replicas and their route graphs before a DB grow.
With a router-quality monitor (`quality=`, obs/quality.py) each routed
batch's budgets and choices, host arrays, are queued for it while obs is
enabled, and the router's feedback feeds it each fold.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, graphs, obs as OBS, resolve_device
from repro_torch.core.dispatch import (CapacityPrebaker, RouteDispatcher,
                                       batch_bucket, bucket_ladder)
from repro_torch.core.router import EagleRouter
from repro_torch.core.state import DoubleBuffer
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    tokens: np.ndarray            # (S,) int32 prompt
    embedding: np.ndarray         # (D,) prompt embedding
    budget: float
    max_new_tokens: int = 8
    rid: int = 0
    # admission metadata (serving/admission.py): stamped arrival time
    # (0 = unstamped -> the queue stamps at submit), end-to-end deadline
    # (the coalescing window flushes by min(deadline, max_wait)), and
    # priority class (higher flushes first)
    arrival_ns: int = 0
    deadline_ms: float = math.inf
    priority: int = 0


@dataclasses.dataclass
class Response:
    rid: int
    model: str
    tokens: np.ndarray
    latency_s: float


class FleetModel:
    """One servable model (dense, ssm or encdec): prefill + greedy decode.

    The parameters are made from `seed` on the device (or taken from
    `params`, in `transformer.init_params`' layout, e.g. carried across by
    `convert.model_params_from_numpy`) and cast to the compute type once.
    An encdec model's encoder reads a zero (B, n_audio_frames, d_model)
    stub of frame embeddings, as the JAX FleetModel feeds it.

    Decode runs on one static state: an fp32 cache (as in the JAX
    package's FleetModel) of `rows` rows, a token history and a (1,)
    device step index. A generate of B rows prefills the leading B rows
    in place (eager, as S varies) and runs its steps through the decode
    step for B rows: on the card a CUDA graph captured once per B (the
    counterpart of the JAX FleetModel's jitted decode, compiled per
    shape), so a step is one index update and one replay; on the CPU the
    step runs eagerly. Each prefill starts from a zero state, as a fresh
    cache does (`T.prefill`), so no request sees the last one's. The
    graphs of one model share one memory pool. `stats` is their ledger,
    as the dispatcher's: a row count not warmed is captured on first
    use, as a miss; one past `rows` reallocates the state at that size,
    and the steps captured over the old one are evicted with their pool
    and captured again when next used."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, max_len: int = 128,
                 *, params: Optional[T.Params] = None,
                 device: DeviceLike = None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.max_len = max_len
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = T.init_params(cfg, gen)
        self.params = T.cast_params(cfg, params)
        self._steps = graphs.StepCache()    # row count -> decode step
        self.stats = self._steps.stats
        self.rows = 0                       # of the static decode state
        self._cache = self._hist = self._index = None

    @torch.inference_mode()
    def _alloc(self, rows: int) -> None:
        self._steps.evict(lambda b, step: True)   # over the old state
        self._cache = self._hist = self._index = None   # freed first
        self._cache = T.init_cache(self.cfg, rows, self.max_len,
                                   torch.float32, device=self.device)
        # column p: the token at position p (p >= the prompt length)
        self._hist = torch.zeros((rows, self.max_len + 1), dtype=torch.int64,
                                 device=self.device)
        self._index = torch.zeros((1,), dtype=torch.int64,
                                  device=self.device)
        self.rows = rows

    def _view(self, b: int):
        """The static state's leading b rows; each layer's slice of them
        is contiguous, so the decode kernel reads it in place."""
        def rows(tree):
            return {k: rows(v) if isinstance(v, dict) else v[:, :b]
                    for k, v in tree.items()}
        return rows(self._cache), self._hist[:b], self._index

    def _decode(self, cache, hist, index) -> None:
        """One greedy step on the static state: the token at position
        `index` in, the next one out into the history at index + 1."""
        tok = hist.index_select(1, index)
        logits, _ = T.decode_step(self.cfg, self.params, cache, tok, index)
        hist.index_copy_(1, index + 1, torch.argmax(logits, dim=-1)[:, None])

    @torch.inference_mode()
    def _step(self, b: int, warm: bool = False) -> graphs.Step:
        if b not in self._steps.entries and b > self.rows:
            self._alloc(b)
        # captured before a prefill writes the rows: its eager warm-up
        # run writes the state at the index it holds
        return self._steps.get(
            b, lambda pool: graphs.Step(self._decode, *self._view(b),
                                        device=self.device, pool=pool),
            device=self.device, warm=warm)

    def warmup(self, batch_sizes: Sequence[int]) -> int:
        """Capture the decode step for each row count (the state sized at
        the largest first). Returns the number captured (0 if warm)."""
        before = self.stats.misses
        for b in sorted(set(batch_sizes), reverse=True):
            self._step(b, warm=True)
        return self.stats.misses - before

    def cache_stats(self) -> Dict:
        """The decode steps' ledger: hits, misses (captures), warmed,
        compile_s (capture seconds), entries and their row counts."""
        return self._steps.as_dict()

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, max_new: int) -> np.ndarray:
        """tokens: (B, S) -> (B, max_new) greedy continuation. The tokens
        stay on the device until the end: one readout per call."""
        b, s = tokens.shape
        if s + max_new > self.max_len + 1:
            raise ValueError(f"generate: {s} prompt tokens + {max_new} new "
                             f"ones do not fit a cache of {self.max_len}")
        step = self._step(b)
        cache, hist, index = self._view(b)
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        enc = None
        if self.cfg.arch_type == "encdec":
            enc = torch.zeros((b, self.cfg.n_audio_frames,
                               self.cfg.d_model), device=self.device)
        logits, _ = T.prefill(self.cfg, self.params, toks, self.max_len,
                              enc_embeds=enc, cache=cache)
        hist[:, s] = torch.argmax(logits, dim=-1)
        for i in range(max_new - 1):
            index.fill_(s + i)
            step(cache, hist, index)
        return hist[:, s:s + max_new].to(torch.int32).cpu().numpy()


class ServingEngine:
    """Serving loop: routing runs through the bucketed dispatcher's graph
    cache (core/dispatch.py) over a double-buffered RouterState, so
    feedback commits never write into the replica routing reads, and
    after warmup a serve() step captures nothing."""

    def __init__(self, fleet: Dict[str, FleetModel], router: EagleRouter,
                 compare_rate: float = 0.2, seed: int = 0,
                 quality_oracle: Optional[Callable] = None,
                 dispatcher: Optional[RouteDispatcher] = None,
                 warmup_batch_sizes: Optional[Sequence[int]] = None,
                 obs: Optional[OBS.Observability] = None,
                 gen_bucket: bool = False, gen_min_bucket: int = 1,
                 gen_max_bucket: int = 64,
                 gen_pad_len: Optional[int] = None,
                 quality=None,
                 now_ns: Callable[[], int] = time.time_ns,
                 mesh=None, prebake: bool = False):
        assert list(fleet) == router.model_names, "fleet/router order mismatch"
        self.fleet = fleet
        self.router = router
        self.compare_rate = compare_rate
        # generation-shape bucketing: pad each per-model group's rows to
        # the power-of-two ladder between gen_min_bucket and
        # gen_max_bucket (padded rows are independent in the batch dim,
        # so real rows are untouched; each row count is one decode graph)
        # and optionally floor the token panel length
        self.gen_bucket = gen_bucket
        self.gen_min_bucket = gen_min_bucket
        self.gen_max_bucket = gen_max_bucket
        self.gen_pad_len = gen_pad_len
        self.rng = np.random.default_rng(seed)
        self.quality_oracle = quality_oracle  # (emb, model_idx) -> quality
        # one telemetry scope threads through every layer the engine
        # owns: dispatcher, double buffer, router feedback, serve spans
        self.obs = OBS.get_obs(obs)
        router.obs = self.obs
        # the decision log's clock: injectable, so a replayed run's log
        # repeats (AdmissionQueue takes the same)
        self.now_ns = now_ns
        # optional router-quality monitor (obs/quality.py): fed per routed
        # batch on the obs-enabled path, per fold through router.feedback
        self.quality = quality
        if quality is not None:
            router.quality = quality
        # with a DB mesh (launch.mesh.make_db_mesh) the dispatcher's
        # route and both buffer replicas are capacity-sharded (DESIGN.md
        # §12); everything downstream is mesh-agnostic
        self.mesh = mesh
        self.dispatch = dispatcher or RouteDispatcher.for_router(
            router, obs=self.obs, mesh=mesh)
        # two device replicas over the router's host buffer: route on the
        # front while commits copy into the back, then swap
        self.dbuf = DoubleBuffer(router.db, router.global_ratings,
                                 device=router.device, mesh=mesh,
                                 obs=self.obs)
        # the next capacity's replicas and route graphs, prepared in the
        # background (polled after commits), so a DB grow captures
        # nothing on the hot path
        self.prebaker = CapacityPrebaker(
            self.dispatch, router.db, dbuf=self.dbuf,
            obs=self.obs) if prebake else None
        r = self.obs.registry
        self._m_served = r.counter("serve_requests_total",
                                   "requests served")
        self._m_steps = r.counter("serve_steps_total", "serve() batches")
        self._m_feedback = r.counter("serve_feedback_total",
                                     "online comparisons collected")
        self._m_commits = r.counter("serve_commits_total",
                                    "router commits from the serve path")
        self._m_per_model = {
            m: r.counter("serve_model_requests_total",
                         "requests served per fleet model", model=m)
            for m in fleet}
        self._g_queue = r.gauge("serve_queue_depth",
                                "requests in the current serve() batch")
        self._h_route = r.histogram("serve_route_us",
                                    "routing latency per batch")
        self._h_generate = r.histogram("serve_generate_us",
                                       "per-model-group generate latency")
        self._h_feedback = r.histogram("serve_feedback_us",
                                       "feedback append+ELO-fold latency")
        self._h_commit = r.histogram("serve_commit_us",
                                     "double-buffer commit latency")
        self._sorted_costs = np.sort(router.costs.cpu().numpy())
        self._names = np.asarray(router.model_names, dtype=object)
        self._warm_sizes: Optional[Sequence[int]] = None   # see warmup()
        if warmup_batch_sizes is not None:
            self.warmup(warmup_batch_sizes)

    @property
    def stats(self) -> Dict:
        """Readout of the typed metrics."""
        return {
            "served": int(self._m_served.value),
            "feedback": int(self._m_feedback.value),
            "commits": int(self._m_commits.value),
            "per_model": {m: int(c.value)
                          for m, c in self._m_per_model.items()},
        }

    def metrics_snapshot(self) -> Dict:
        """Full JSON snapshot of this engine's telemetry scope."""
        return self.obs.registry.json_snapshot()

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> int:
        """Fill the dispatcher's graph cache for the bucket ladder (or
        `batch_sizes`) on both buffer replicas, each while it is the
        front, with one commit after each (which runs the commit path
        too). Call at startup; routing then never captures. A commit of
        serve() that grows the DB makes a new replica: serve() warms it
        for the same sizes before it routes on it, so those captures
        are the commit's (counted as warmed), not a route's. Returns the
        number of route graphs captured (on the CPU, where the key has
        no replica: the JAX package's count)."""
        self._warm_sizes = tuple(batch_sizes) if batch_sizes is not None \
            else bucket_ladder(self.dispatch.min_bucket,
                               self.dispatch.max_bucket)
        n = 0
        for _ in range(2):
            n += self.dispatch.warmup(self.dbuf.front, batch_sizes)
            self.dbuf.commit(self.router.global_ratings)
        return n

    def warmup_generate(self, prompt_len: int,
                        batch_sizes: Optional[Sequence[int]] = None,
                        max_new: int = 2) -> int:
        """Capture every fleet model's decode step for the generate-bucket
        ladder (or the buckets of `batch_sizes`), then run a generate of
        `prompt_len` tokens at each, so the kernels are built and the
        allocator has seen the prefill shapes before traffic. Returns the
        number of decode graphs captured."""
        lo, hi = self.gen_min_bucket, self.gen_max_bucket
        if batch_sizes is not None:
            buckets = sorted({batch_bucket(n, lo, hi) for n in batch_sizes})
        else:
            buckets = list(bucket_ladder(lo, hi))
        n = sum(m.warmup(buckets) for m in self.fleet.values())
        for b in buckets:
            toks = np.zeros((b, prompt_len), np.int32)
            for m in self.fleet.values():
                m.generate(toks, max_new)
        return n

    def serve(self, requests: Sequence[Request]) -> List[Response]:
        if not len(requests):
            return []
        obs = self.obs
        self._m_steps.inc()
        self._g_queue.set(len(requests))
        with obs.span("serve.step"):
            t0 = time.perf_counter()
            embs = np.stack([r.embedding for r in requests])
            budgets = np.asarray([r.budget for r in requests], np.float32)
            # ②/③ one bucketed route over the FRONT buffer; the single
            # host readout is the per-request choice
            with obs.span("serve.route"):
                choices = self.dispatch.route(self.dbuf.front, embs,
                                              budgets)
            route_dt = time.perf_counter() - t0
            self._h_route.observe(route_dt * 1e6)
            if obs.enabled:
                self._emit_decisions(requests, budgets, choices)
                if self.quality is not None:
                    self.quality.observe_batch(budgets, choices)

            # ④ group by chosen model, pad to a batch, generate. A
            # request's latency is routing + its OWN group's generation.
            responses: List[Response] = [None] * len(requests)  # type: ignore
            for mi, name in enumerate(self.router.model_names):
                sel = np.nonzero(choices == mi)[0]
                if sel.size == 0:
                    continue
                max_s = max(len(requests[i].tokens) for i in sel)
                rows = int(sel.size)
                if self.gen_bucket:
                    rows = batch_bucket(rows, self.gen_min_bucket,
                                        self.gen_max_bucket)
                    if self.gen_pad_len is not None:
                        max_s = max(max_s, self.gen_pad_len)
                toks = np.zeros((rows, max_s), np.int32)
                for row, i in enumerate(sel):
                    t = requests[i].tokens
                    toks[row, :len(t)] = t
                max_new = max(requests[i].max_new_tokens for i in sel)
                tg = time.perf_counter()
                with obs.span(f"serve.generate.{name}"):
                    gen = self.fleet[name].generate(toks, max_new)
                gen_dt = time.perf_counter() - tg
                self._h_generate.observe(gen_dt * 1e6)
                dt = route_dt + gen_dt
                for row, i in enumerate(sel):
                    responses[i] = Response(
                        requests[i].rid, name,
                        gen[row, :requests[i].max_new_tokens], dt)
                self._m_per_model[name].inc(int(sel.size))
            self._m_served.inc(len(requests))

            # ⑤ optional second-model comparison -> online router update
            # -> commit into the back buffer and swap
            if self.quality_oracle is not None and self.compare_rate > 0:
                cmp_sel = self.rng.random(len(requests)) < self.compare_rate
                idxs = np.nonzero(cmp_sel)[0]
                if idxs.size:
                    a = choices[idxs]
                    b = np.asarray([self.rng.choice(
                        [m for m in range(len(self.fleet)) if m != ai])
                        for ai in a], np.int32)
                    qa = np.asarray([self.quality_oracle(embs[i], int(ai))
                                     for i, ai in zip(idxs, a)])
                    qb = np.asarray([self.quality_oracle(embs[i], int(bi))
                                     for i, bi in zip(idxs, b)])
                    outcome = np.where(qa == qb, 0.5,
                                       (qa > qb).astype(np.float32))
                    tf = time.perf_counter()
                    with obs.span("serve.feedback"):
                        self.router.feedback(embs[idxs], a, b, outcome)
                    self._h_feedback.observe(
                        (time.perf_counter() - tf) * 1e6)
                    self._m_feedback.inc(int(idxs.size))
                    tc = time.perf_counter()
                    with obs.span("serve.commit"):
                        front = self.dbuf.commit(self.router.global_ratings)
                        if self._warm_sizes is not None:
                            # 0 unless the commit grew this replica into
                            # tensors the prebaker did not prepare
                            self.dispatch.warmup(front, self._warm_sizes)
                    self._h_commit.observe(
                        (time.perf_counter() - tc) * 1e6)
                    self._m_commits.inc()
                    if self.prebaker is not None:
                        self.prebaker.poll()
        return responses

    def _emit_decisions(self, requests: Sequence[Request], budgets,
                        choices):
        """One JSONL record per routed request: chosen model, budget,
        feasible-set size (the offline AUC/cost analysis input). The
        columns are host arrays, turned into Python values when the log
        is read (`EventLog.emit_columns`), not here."""
        feas = np.searchsorted(self._sorted_costs, budgets, side="right")
        nb = len(requests)
        self.obs.events.emit_columns(
            "route", nb,
            {"ts": self.now_ns() / 1e9, "batch": nb},
            {"rid": [r.rid for r in requests],
             "model": self._names[choices],
             "model_idx": choices,
             "budget": budgets,
             "feasible": feas})
