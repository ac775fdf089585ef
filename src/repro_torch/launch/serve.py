"""Serving launcher: an Eagle-routed multi-LLM fleet on the card (reduced
configs, as the JAX package's launcher builds them).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --fleet 4 \
      --max-new 2
  PYTHONPATH=src python -m repro_torch.launch.serve --admission --rate 500
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-obs 9100 \
      --alert-log alerts.jsonl

A port of the JAX package's `launch/serve.py`, with the same CLI and
defaults. The default fleet is `ARCH_IDS[:4]`: whisper-large-v3 (encdec),
olmo-1b, mamba2-780m (ssm) and qwen3-8b; `--fleet 5` adds phi3.5-moe
(moe), `--fleet 6` internlm2-20b (dense), `--fleet 7` gemma3-12b (dense,
local:global windows), `--fleet 8` llava-next-mistral-7b (vlm), `--fleet
9` zamba2-7b (hybrid) and `--fleet 10` deepseek-v3-671b (moe with MLA):
every model of ARCH_IDS. `--db-shards N`
splits the routing DB's capacity over the first N cards (a
`launch.mesh.DbMesh`), `--prebake` prepares the next capacity's
replicas and route graphs before the DB grows. `--serve-obs PORT` enables spans and events and
starts the operational plane (`build_obs_plane`: the quality monitor, the
stock SLO rules and the scrape exporter on 127.0.0.1:PORT, 0 for an
ephemeral port); `--alert-log PATH` adds a JSONL alert sink to both
monitors.
"""
from __future__ import annotations

import argparse
import time
import zlib

import numpy as np

from repro_torch import DeviceLike
from repro_torch import obs as OBS
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.core.router import EagleConfig, EagleRouter
from repro_torch.data.routerbench import make_corpus, pairwise_feedback
from repro_torch.launch.mesh import make_db_mesh
from repro_torch.obs.alerts import LogFileSink
from repro_torch.obs.exporter import ObsExporter
from repro_torch.obs.quality import RouterQualityMonitor
from repro_torch.obs.slo import SLOEngine, default_serving_rules
from repro_torch.serving.admission import AdmissionQueue
from repro_torch.serving.engine import FleetModel, Request, ServingEngine

#: the batch sizes build_engine warms (route graphs for their buckets,
#: decode graphs for their row counts): the launcher's traffic at its
#: defaults, one serve() of --requests 16 or --admission windows of
#: --window 8, groups of 1..16 rows
WARM_SIZES = (1, 2, 4, 8, 16)
#: the prompt length of the warm-up generate (main's prompts: 4..11)
WARM_PROMPT_LEN = 11


def quality_oracle(emb, mi) -> float:
    """The launcher's simulated user: a quality in [0, 1) per (prompt,
    model). The JAX launcher hashes with Python's `hash`, which is salted
    per process; crc32 makes runs repeat."""
    return float(np.random.default_rng(
        zlib.crc32(emb[:2].tobytes() + bytes([mi]))).random())


def build_engine(n_fleet: int = 4, dim: int = 64, seed: int = 0,
                 compare_rate: float = 0.25, obs=None, db_shards: int = 0,
                 prebake: bool = False, device: DeviceLike = None):
    """The JAX launcher's engine: a router fitted on a synthetic
    RouterBench corpus at `dim`, costs linspace(1, 8, n_fleet), in front
    of `ARCH_IDS[:n_fleet]` at their reduced configs (max_len 64), on
    `device` (the card by default). Unlike the JAX launcher's, it pads
    each model's group to the row ladder (gen_bucket) and warms before
    traffic: the dispatcher's route graphs on both buffer replicas and
    each model's decode graphs for WARM_SIZES, so the default traffic
    captures nothing. `db_shards` > 0 splits the routing DB's capacity
    over a DB mesh: the first `db_shards` cards, or that many shards on
    `device` when one is named. Returns (engine, corpus)."""
    names = ARCH_IDS[:n_fleet]
    corpus = make_corpus(seed=seed, n_per_dataset=60, dim=dim,
                         model_names=names,
                         costs=np.linspace(1.0, 8.0, n_fleet))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=seed,
                           pairs_per_query=4)
    router = EagleRouter(names, corpus.costs, EagleConfig(embed_dim=dim),
                         db_capacity=1 << 15, device=device)
    router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    fleet = {n: FleetModel(get_reduced_config(n), seed=i, max_len=64,
                           device=device)
             for i, n in enumerate(names)}
    mesh = None
    if db_shards:
        mesh = make_db_mesh(db_shards, None if device is None
                            else [device] * db_shards)
    engine = ServingEngine(fleet, router, compare_rate=compare_rate,
                           seed=seed, quality_oracle=quality_oracle,
                           obs=obs, gen_bucket=True,
                           warmup_batch_sizes=WARM_SIZES, mesh=mesh,
                           prebake=prebake)
    engine.warmup_generate(WARM_PROMPT_LEN, batch_sizes=WARM_SIZES)
    return engine, corpus


def build_obs_plane(engine: ServingEngine, *, port: int = 0,
                    deadline_ms: float = 50.0,
                    regret_bound: float = 50.0,
                    alert_log: str = None) -> ObsExporter:
    """The operational plane over a launcher-built engine: a quality
    monitor attached to the router's feedback leg (its ratings and costs
    copied to the host here), the stock SLO rules over the engine's
    registry and a started scrape daemon. Returns the running exporter
    (stop() when done; port 0 picks an ephemeral port, read it back from
    `.port`). `alert_log` attaches a `LogFileSink` to both monitors:
    drift alerts and SLO page transitions append webhook-shaped JSONL
    there."""
    sinks = [LogFileSink(alert_log)] if alert_log else []
    quality = RouterQualityMonitor.for_router(engine.router,
                                              obs=engine.obs,
                                              sinks=sinks)
    engine.quality = quality
    slo = SLOEngine(engine.obs.registry,
                    default_serving_rules(deadline_ms=deadline_ms,
                                          regret_bound=regret_bound),
                    sinks=sinks)
    return ObsExporter(engine.obs, slo=slo, quality=quality,
                       port=port).start()


def build_admission(engine: ServingEngine, *, window_bucket: int = 32,
                    max_wait_ms: float = 5.0, shed_watermark: int = 128,
                    reject_cap: int = 512, **cfg_kw) -> AdmissionQueue:
    """Admission frontend in front of a launcher-built engine, sharing
    its telemetry scope and its dispatcher's bucket ladder so coalesced
    windows land on warmed bucket shapes."""
    return AdmissionQueue.for_engine(
        engine, window_bucket=window_bucket, max_wait_ms=max_wait_ms,
        shed_watermark=shed_watermark, reject_cap=reject_cap, **cfg_kw)


def _serve_admitted(engine, reqs, rate_hz: float, window: int,
                    max_wait_ms: float):
    """Real-clock demo loop: submit at Poisson gaps, pump the queue,
    sleep until its next flush deadline, then drain."""
    queue = build_admission(engine, window_bucket=window,
                            max_wait_ms=max_wait_ms)
    rng = np.random.default_rng(0)
    responses = []
    for req in reqs:
        time.sleep(float(rng.exponential(1.0 / rate_hz)))
        rej = queue.submit(req)
        if rej is not None:
            print(f"rejected rid={rej.rid} at depth {rej.depth}")
        responses += [c.response for c in queue.pump()]
        due = queue.next_flush_ns()
        if due is not None:
            time.sleep(max(0.0, (due - queue.now_ns()) / 1e9) * 0.5)
    responses += [c.response for c in queue.drain()]
    print("admission:", queue.summary())
    return sorted(responses, key=lambda r: r.rid)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--fleet", type=int, default=4)
    ap.add_argument("--budget", type=float, default=5.0)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--admission", action="store_true",
                    help="stream requests through the admission queue "
                         "on the real clock instead of one serve() call")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="mean offered load (req/s) for --admission")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--serve-obs", type=int, default=None, metavar="PORT",
                    help="start the observability exporter on PORT "
                         "(0 = ephemeral) and enable span/event capture")
    ap.add_argument("--alert-log", type=str, default=None, metavar="PATH",
                    help="append webhook-shaped JSONL alerts (quality "
                         "drift + SLO page transitions) to PATH "
                         "(needs --serve-obs)")
    ap.add_argument("--db-shards", type=int, default=0,
                    help="capacity-shard the routing DB over the first N "
                         "cards")
    ap.add_argument("--prebake", action="store_true",
                    help="prepare the next capacity's replicas and route "
                         "graphs in the background before the DB grows")
    args = ap.parse_args(argv)

    obs = OBS.Observability(enabled=True) if args.serve_obs is not None \
        else None
    engine, corpus = build_engine(args.fleet, seed=args.seed, obs=obs,
                                  db_shards=args.db_shards,
                                  prebake=args.prebake)
    exporter = None
    if args.serve_obs is not None:
        exporter = build_obs_plane(engine, port=args.serve_obs,
                                   alert_log=args.alert_log)
        print(f"obs plane at http://127.0.0.1:{exporter.port} "
              f"(/metrics /trace /decisions /healthz /slo /quality)")
    rng = np.random.default_rng(args.seed)
    test = corpus.test_idx[:args.requests]
    reqs = [Request(tokens=rng.integers(0, 100, rng.integers(4, 12)).astype(
                        np.int32),
                    embedding=corpus.embeddings[i],
                    budget=float(args.budget), max_new_tokens=args.max_new,
                    rid=k)
            for k, i in enumerate(test)]
    try:
        if args.admission:
            responses = _serve_admitted(engine, reqs, args.rate,
                                        args.window, args.max_wait_ms)
        else:
            responses = engine.serve(reqs)
        for r in responses[:8]:
            print(f"req {r.rid:3d} -> {r.model:24s} tokens "
                  f"{r.tokens.tolist()}")
        print("stats:", engine.stats)
    finally:
        if exporter is not None:
            exporter.stop()


if __name__ == "__main__":
    main()
