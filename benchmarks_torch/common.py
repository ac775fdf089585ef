"""Shared harness of the paper's experiments on the port: corpus and
feedback construction, the router zoo, result persistence. Imports
`torch`, never `jax`, and nothing of `repro` or `benchmarks`.

Every function that fits a router takes `device` (default: the card).
Results go to `results/torch/`."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.router import EagleConfig, EagleRouter
from repro_torch.data.routerbench import (DATASETS, evaluate_router,
                                          make_corpus, pairwise_feedback,
                                          winrate_targets)
from repro_torch.routing.baselines import KNNRouter, MLPRouter, SVMRouter

RESULTS = Path(__file__).resolve().parent.parent / "results" / "torch"

# frozen benchmark regime (DESIGN.md §7), as in benchmarks/common.py
N_PER_DATASET = 300
DIM = 64
PAIRS_PER_QUERY = 8
SEEDS = (0, 1, 2, 3, 4)


def build(seed: int, device: DeviceLike = None):
    """The corpus (N_PER_DATASET prompts per dataset, DIM) and its train
    split's pairwise feedback, host arrays. `device` is the run's: it is
    resolved first, so a run without the card fails before it builds."""
    resolve_device(device)
    corpus = make_corpus(seed=seed, n_per_dataset=N_PER_DATASET, dim=DIM)
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=seed,
                           pairs_per_query=PAIRS_PER_QUERY)
    return corpus, fb


def fit_eagle(corpus, fb, cls=EagleRouter, device: DeviceLike = None,
              **cfg_kw):
    cfg = EagleConfig(embed_dim=DIM, **cfg_kw)
    r = cls(corpus.model_names, corpus.costs, cfg, db_capacity=4096,
            device=device)
    secs = r.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
                 query_id=fb["query_idx"])
    return r, secs


def baselines(costs, device: DeviceLike = None):
    """The paper's three baselines, fresh: (name, router) pairs."""
    return (("knn", KNNRouter(costs, device=device)),
            ("mlp", MLPRouter(costs, device=device)),
            ("svm", SVMRouter(costs, device=device)))


def fit_baselines(corpus, fb, regime: str = "online",
                  device: DeviceLike = None) -> Dict:
    """regime 'online': win-rate targets from the same pairwise feedback
    Eagle sees (the paper's deployment scenario, §1 challenge 2).
    regime 'offline': the full binary quality matrix (RouterBench-style)."""
    out = {}
    if regime == "online":
        emb, tgt, mask = winrate_targets(fb, corpus.n_models)
    else:
        tr = corpus.train_idx
        emb, tgt, mask = corpus.embeddings[tr], corpus.quality[tr], None
    for name, r in baselines(corpus.costs, device):
        secs = r.fit(emb, tgt, mask)
        out[name] = (r, secs)
    return out


def sum_auc(router, corpus) -> float:
    return float(sum(
        evaluate_router(lambda e, b: router.route(e, b), corpus,
                        dataset=d)["auc"]
        for d in range(len(DATASETS))))


def per_dataset_auc(router, corpus):
    return {DATASETS[d]: evaluate_router(
        lambda e, b: router.route(e, b), corpus, dataset=d)["auc"]
        for d in range(len(DATASETS))}


def save_json(name: str, payload) -> Path:
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / name
    path.write_text(json.dumps(payload, indent=1, default=float))
    return path


def timer(fn, *args, repeat: int = 3, **kw):
    """Median wall microseconds per call, each call ended by a synchronise
    of the card where it is in use."""
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts)), out
