"""Synthetic RouterBench-like corpus, a copy of the JAX package's
`data/routerbench.py` (same generator, same seeds, same arrays), so that
the port runs without importing `repro`.

The real RouterBench dump and the stella embedder are unavailable
offline, so the corpus has the same *structure* and the paper's
evaluation protocol: 7 datasets, 70/30 split, cost-quality AUC.

  * M fleet models, each with a base ability ~ log(cost) plus a
    per-dataset specialisation offset.
  * each dataset owns `topics` embedding subclusters; a query embedding is
    its subcluster centre + noise, with per-subcluster skill jitter that
    Eagle-Local can see and Eagle-Global cannot.
  * per-query per-model quality is BINARY correctness sampled from
    p = sigmoid(skill + noise).
  * pairwise feedback samples model pairs per train query; outcome is
    1 / 0.5 / 0 by comparing the binary qualities.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

DATASETS = ["mmlu", "hellaswag", "gsm8k", "arc_challenge", "winogrande",
            "mbpp", "mt_bench"]

#: the repo's 10-model fleet, and each model's cost proxy: active
#: parameters in billions ($ per 1k queries ~ B params), as the JAX
#: package derives them from its model configs
FLEET_NAMES = ["whisper-large-v3", "olmo-1b", "mamba2-780m", "qwen3-8b",
               "phi3.5-moe-42b-a6.6b", "internlm2-20b", "gemma3-12b",
               "llava-next-mistral-7b", "zamba2-7b", "deepseek-v3-671b"]
FLEET_COSTS = [1.9538252353668213, 1.1767643690109253, 0.7799116969108582,
               8.19042682647705, 6.64010763168335, 19.860553741455078,
               11.765022277832031, 7.241466045379639, 5.621969699859619,
               37.55127716064453]

@dataclasses.dataclass
class Corpus:
    embeddings: np.ndarray     # (N, D) float32, unit-norm
    quality: np.ndarray        # (N, M) float32 {0,1} — binary correctness
    p_quality: np.ndarray      # (N, M) float32 — latent P(correct) (internal)
    dataset_id: np.ndarray     # (N,) int32
    topic_id: np.ndarray       # (N,) int32 (global topic index)
    costs: np.ndarray          # (M,) float32 $/query
    model_names: List[str]
    datasets: List[str]
    train_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def n_models(self) -> int:
        return self.quality.shape[1]

    def stage_indices(self, frac: float) -> np.ndarray:
        """First `frac` of the train split (arrival order) — the paper's
        70/85/100% online stages are fractions OF THE TRAIN SET."""
        n = int(round(len(self.train_idx) * frac))
        return self.train_idx[:n]


def default_fleet() -> Tuple[List[str], np.ndarray]:
    """The 10 fleet models with their cost proxies."""
    return list(FLEET_NAMES), np.asarray(FLEET_COSTS, np.float32)


def make_corpus(seed: int = 0, n_per_dataset: int = 300, dim: int = 64,
                topics_per_dataset: int = 4, model_names=None, costs=None,
                train_frac: float = 0.7, noise: float = 0.35,
                emb_noise: float = 0.55, topic_strength: float = 0.45,
                special_strength: float = 0.9,
                base_strength: float = 0.25) -> Corpus:
    rng = np.random.default_rng(seed)
    if model_names is None:
        model_names, costs = default_fleet()
    m = len(model_names)
    nd = len(DATASETS)

    # base ability grows (sub-linearly, noisily) with cost — but the fleet
    # is frontier-ish: general abilities are CLOSE and per-domain
    # specialization dominates (the paper's CodeQwen-vs-GPT4 premise).
    # Routing quality is then about *specialization*, not size.
    base = base_strength * np.log1p(costs / costs.min()) \
        + 0.3 * rng.normal(size=m)
    special = special_strength * rng.normal(size=(nd, m))   # dataset specialization
    topic_jitter = topic_strength * rng.normal(size=(nd, topics_per_dataset, m))

    centers = rng.normal(size=(nd, topics_per_dataset, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)

    embs, ps, quals, ds_ids, topic_ids = [], [], [], [], []
    for d in range(nd):
        for q in range(n_per_dataset):
            t = rng.integers(topics_per_dataset)
            # emb_noise mixes neighborhoods across topics: real text
            # embeddings cluster imperfectly, so retrieval is imperfect —
            # pure-local routers inherit that noise (paper's motivation
            # for combining Global + Local).
            e = centers[d, t] + emb_noise * rng.normal(size=dim)
            e = e / np.linalg.norm(e)
            skill = base + special[d] + topic_jitter[d, t]
            p = 1.0 / (1.0 + np.exp(-(skill + noise * rng.normal(size=m))))
            embs.append(e)
            ps.append(p)
            quals.append((rng.random(m) < p).astype(np.float32))
            ds_ids.append(d)
            topic_ids.append(d * topics_per_dataset + t)

    n = len(embs)
    perm = rng.permutation(n)
    embeddings = np.asarray(embs, np.float32)[perm]
    p_quality = np.asarray(ps, np.float32)[perm]
    quality = np.asarray(quals, np.float32)[perm]
    dataset_id = np.asarray(ds_ids, np.int32)[perm]
    topic_id = np.asarray(topic_ids, np.int32)[perm]
    n_train = int(round(n * train_frac))
    idx = np.arange(n)
    return Corpus(embeddings, quality, p_quality, dataset_id, topic_id,
                  np.asarray(costs, np.float32), list(model_names),
                  list(DATASETS), idx[:n_train], idx[n_train:])


def pairwise_feedback(corpus: Corpus, query_idx: np.ndarray, *, seed: int = 0,
                      pairs_per_query: int = 2, label_noise: float = 0.08):
    """Sample user-style pairwise comparisons for the given queries.

    Returns dict with emb (K,D), model_a/model_b (K,), outcome (K,) in
    arrival order (repeated queries interleaved like an online stream).
    """
    rng = np.random.default_rng(seed + 1)
    m = corpus.n_models
    rows = []
    for qi in query_idx:
        for _ in range(pairs_per_query):
            a, b = rng.choice(m, size=2, replace=False)
            qa, qb = corpus.quality[qi, a], corpus.quality[qi, b]
            if qa == qb:
                s = 0.5                     # both right / both wrong: a draw
            else:
                s = 1.0 if qa > qb else 0.0
            if rng.random() < label_noise:  # occasional unreliable raters
                s = rng.choice([0.0, 0.5, 1.0])
            rows.append((qi, a, b, s))
    rng.shuffle(rows)
    qis = np.asarray([r[0] for r in rows], np.int64)
    return {
        "emb": corpus.embeddings[qis],
        "model_a": np.asarray([r[1] for r in rows], np.int32),
        "model_b": np.asarray([r[2] for r in rows], np.int32),
        "outcome": np.asarray([r[3] for r in rows], np.float32),
        "query_idx": qis,
    }


# ---------------------------------------------------------------------------
# Evaluation protocol (paper §3.1): cost->quality curve + trapezoid AUC
# ---------------------------------------------------------------------------

def budget_grid(costs: np.ndarray, n: int = 21) -> np.ndarray:
    return np.linspace(costs.min(), costs.max(), n)


def evaluate_router(route_fn, corpus: Corpus, *, budgets=None,
                    dataset: Optional[int] = None, idx=None):
    """route_fn(emb (Q,D), budget scalar) -> (Q,) model choice.

    Returns dict(budgets, quality (per budget), auc). Quality is the mean
    oracle quality of the chosen models over the test split.
    """
    if idx is None:
        idx = corpus.test_idx
    if dataset is not None:
        idx = idx[corpus.dataset_id[idx] == dataset]
    embs = corpus.embeddings[idx]
    qual = corpus.quality[idx]
    if budgets is None:
        budgets = budget_grid(corpus.costs)
    ys = []
    for b in budgets:
        choice = np.asarray(route_fn(embs, float(b)))
        ys.append(float(qual[np.arange(len(idx)), choice].mean()))
    x = (np.asarray(budgets) - budgets[0]) / max(budgets[-1] - budgets[0], 1e-9)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    auc = float(trapezoid(ys, x))
    return {"budgets": np.asarray(budgets), "quality": np.asarray(ys),
            "auc": auc}
