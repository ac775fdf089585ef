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

A port of the JAX package's `serving/engine.py`. Not ported yet (ROADMAP
§2.4-2.5): the capacity-sharded route (`mesh=`), the background capacity
prebaker (`prebake=True`) and the router-quality monitor.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, obs as OBS, resolve_device
from repro_torch.core.dispatch import (RouteDispatcher, batch_bucket,
                                       bucket_ladder)
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
    The KV cache is fp32, as in the JAX package's FleetModel. An encdec
    model's encoder reads a zero (B, n_audio_frames, d_model) stub of
    frame embeddings, as the JAX FleetModel feeds it."""

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

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, max_new: int) -> np.ndarray:
        """tokens: (B, S) -> (B, max_new) greedy continuation. The tokens
        stay on the device until the end: one readout per call."""
        b, s = tokens.shape
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        enc = None
        if self.cfg.arch_type == "encdec":
            enc = torch.zeros((b, self.cfg.n_audio_frames,
                               self.cfg.d_model), device=self.device)
        logits, cache = T.prefill(self.cfg, self.params, toks, self.max_len,
                                  cache_dtype=torch.float32, enc_embeds=enc)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs = [tok]
        for i in range(max_new - 1):
            logits, cache = T.decode_step(self.cfg, self.params, cache, tok,
                                          s + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
            outs.append(tok)
        return torch.cat(outs, dim=1).to(torch.int32).cpu().numpy()


class ServingEngine:
    """Serving loop: routing runs through the bucketed dispatcher
    (core/dispatch.py) over a double-buffered RouterState, so feedback
    commits never write into the replica routing reads."""

    #: generation row buckets: the power-of-two ladder between these
    GEN_MIN_BUCKET, GEN_MAX_BUCKET = 1, 64

    def __init__(self, fleet: Dict[str, FleetModel], router: EagleRouter,
                 compare_rate: float = 0.2, seed: int = 0,
                 quality_oracle: Optional[Callable] = None,
                 obs: Optional[OBS.Observability] = None,
                 gen_bucket: bool = False,
                 gen_pad_len: Optional[int] = None,
                 mesh=None, prebake: bool = False):
        if mesh is not None:
            raise NotImplementedError("ServingEngine(mesh=...): the "
                                      "capacity-sharded route is not ported "
                                      "yet (ROADMAP §2.5)")
        if prebake:
            raise NotImplementedError("ServingEngine(prebake=True): the "
                                      "capacity prebaker is not ported yet "
                                      "(ROADMAP §2.5)")
        assert list(fleet) == router.model_names, "fleet/router order mismatch"
        self.fleet = fleet
        self.router = router
        self.compare_rate = compare_rate
        # generation-shape bucketing: pad each per-model group's rows to
        # the power-of-two ladder (padded rows are independent in the
        # batch dim, so real rows are untouched) and optionally floor the
        # token panel length
        self.gen_bucket = gen_bucket
        self.gen_pad_len = gen_pad_len
        self.rng = np.random.default_rng(seed)
        self.quality_oracle = quality_oracle  # (emb, model_idx) -> quality
        self.obs = OBS.get_obs(obs)
        self.dispatch = RouteDispatcher.for_router(router)
        # two device replicas over the router's host buffer: route on the
        # front while commits copy into the back, then swap
        self.dbuf = DoubleBuffer(router.db, router.global_ratings,
                                 device=router.device)
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
        """One route per bucket of the dispatcher's ladder (kernels built
        and loaded before traffic) and one commit per buffer replica.
        Returns the number of buckets routed."""
        n = self.dispatch.warmup(self.dbuf.front, batch_sizes)
        for _ in range(2):
            self.dbuf.commit(self.router.global_ratings)
        return n

    def warmup_generate(self, prompt_len: int,
                        batch_sizes: Optional[Sequence[int]] = None,
                        max_new: int = 2) -> None:
        """Run every fleet model's prefill and decode once per generate
        bucket at a fixed padded prompt length, so the kernels are built
        and the allocator has seen those shapes before traffic."""
        lo, hi = self.GEN_MIN_BUCKET, self.GEN_MAX_BUCKET
        if batch_sizes is not None:
            buckets = sorted({batch_bucket(n, lo, hi) for n in batch_sizes})
        else:
            buckets = list(bucket_ladder(lo, hi))
        for b in buckets:
            toks = np.zeros((b, prompt_len), np.int32)
            for m in self.fleet.values():
                m.generate(toks, max_new)

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
                    rows = batch_bucket(rows, self.GEN_MIN_BUCKET,
                                        self.GEN_MAX_BUCKET)
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
                        self.dbuf.commit(self.router.global_ratings)
                    self._h_commit.observe(
                        (time.perf_counter() - tc) * 1e6)
                    self._m_commits.inc()
        return responses

    def _emit_decisions(self, requests: Sequence[Request], budgets,
                        choices):
        """One JSONL record per routed request: chosen model, budget,
        feasible-set size (the offline AUC/cost analysis input)."""
        feas = np.searchsorted(self._sorted_costs, budgets, side="right")
        names = self.router.model_names
        nb = len(requests)
        idx = choices.tolist()
        self.obs.events.emit_columns(
            "route", nb,
            {"ts": time.time_ns() / 1e9, "batch": nb},
            {"rid": [r.rid for r in requests],
             "model": [names[c] for c in idx],
             "model_idx": idx,
             "budget": budgets.tolist(),
             "feasible": feas.tolist()})
