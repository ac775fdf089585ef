"""The router's corpus, made from a configuration's `corpus` block.

The structure is that of the port's synthetic RouterBench generator
(src/repro_torch/data/routerbench.py:make_corpus at commit 7f915e9): M
fleet models, each with a base ability that grows with log(cost) plus a
per-dataset specialisation; each dataset owns `topics_per_dataset` topic
centres, a prompt's embedding is its unit centre plus noise, with a
per-topic jitter of skill; each (prompt, model) quality is binary, drawn from
sigmoid(skill + noise); the pairwise records compare two qualities (1 /
0.5 / 0, and a share `label_noise` of raters answer at random). Here it
is drawn vectorised, the embeddings on the device, so set-up stays
short; the arrays are not the port's (another order of draws).

The generator's `emb_noise` was set for `emb_noise_dim` coordinates
(0.55 at the port's D = 64). At another width the noise per coordinate
is scaled by sqrt(emb_noise_dim / dim), so the noise keeps its norm
against the unit centre, and a prompt keeps the cosine to its centre
(about 0.22), at any width.

Everything is a function of `corpus_seed` alone: the DB and the learned
ratings are a property of the configuration. The run's `--seed` draws
only the traffic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Corpus:
    embeddings: np.ndarray   # (N, D) float32, unit norm
    quality: np.ndarray      # (N, M) float32 in {0, 1}
    train_idx: np.ndarray    # (N_train,) prompt ids, arrival order
    test_idx: np.ndarray     # (N_test,)


@dataclasses.dataclass
class Records:
    """Pairwise records in arrival order; `prompt` is the prompt id (the
    DB groups a prompt's records in one row)."""
    prompt: np.ndarray       # (T,) int64
    model_a: np.ndarray      # (T,) int32
    model_b: np.ndarray      # (T,) int32
    outcome: np.ndarray      # (T,) float32

    def __len__(self) -> int:
        return len(self.prompt)


def make_corpus(spec: dict, costs, dim: int, device) -> Corpus:
    """The corpus of a configuration's `corpus` block at width `dim`; the
    embeddings are drawn on `device` (a torch.Generator there, seeded from
    corpus_seed) and returned on the host."""
    rng = np.random.default_rng(spec["corpus_seed"])
    costs = np.asarray(costs, np.float64)
    m, nd = len(costs), spec["datasets"]
    nt, per = spec["topics_per_dataset"], spec["prompts_per_dataset"]
    base = spec["base_strength"] * np.log1p(costs / costs.min()) \
        + 0.3 * rng.normal(size=m)
    special = spec["special_strength"] * rng.normal(size=(nd, m))
    jitter = spec["topic_strength"] * rng.normal(size=(nd, nt, m))
    n = nd * per
    ds = np.repeat(np.arange(nd), per)
    topic = rng.integers(nt, size=n)
    skill = base[None] + special[ds] + jitter[ds, topic]
    p = 1.0 / (1.0 + np.exp(-(skill + spec["noise"]
                               * rng.normal(size=(n, m)))))
    quality = (rng.random((n, m)) < p).astype(np.float32)

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(spec["corpus_seed"])
    centers = torch.randn((nd * nt, dim), generator=gen, device=dev)
    centers /= torch.linalg.norm(centers, dim=-1, keepdim=True)
    emb = torch.randn((n, dim), generator=gen, device=dev)
    emb.mul_(spec["emb_noise"] * np.sqrt(spec["emb_noise_dim"] / dim)).add_(
        centers[torch.as_tensor(ds * nt + topic, device=dev)])
    emb /= torch.linalg.norm(emb, dim=-1, keepdim=True)
    embeddings = emb.cpu().numpy()

    perm = rng.permutation(n)
    n_train = int(round(n * spec["train_frac"]))
    return Corpus(embeddings, quality, perm[:n_train], perm[n_train:])


def _pairs(m: int, count: int, rng: np.random.Generator):
    """`count` ordered pairs of distinct models, each uniform."""
    a = rng.integers(m, size=count)
    b = (a + 1 + rng.integers(m - 1, size=count)) % m
    return a.astype(np.int32), b.astype(np.int32)


def fit_records(corpus: Corpus, spec: dict) -> Records:
    """The history the router is fitted on: `pairs_per_prompt` records a
    train prompt, compared by the corpus's binary qualities (a share
    `label_noise` answered at random), shuffled into one arrival order."""
    rng = np.random.default_rng(spec["corpus_seed"] + 1)
    r = spec["pairs_per_prompt"]
    prompt = np.repeat(corpus.train_idx, r)
    a, b = _pairs(corpus.quality.shape[1], len(prompt), rng)
    qa, qb = corpus.quality[prompt, a], corpus.quality[prompt, b]
    s = np.where(qa == qb, 0.5, (qa > qb).astype(np.float32))
    noisy = rng.random(len(prompt)) < spec["label_noise"]
    s[noisy] = rng.choice(np.asarray([0.0, 0.5, 1.0]), size=int(noisy.sum()))
    order = rng.permutation(len(prompt))
    return Records(prompt[order].astype(np.int64), a[order], b[order],
                   s[order].astype(np.float32))


def feedback_records(corpus: Corpus, prompts: np.ndarray, pairs: int,
                     rng: np.random.Generator, outcome) -> Records:
    """One feedback batch: `pairs` records for each of `prompts` (new
    prompt ids), each pair's outcome from the simulated user
    (`outcome(emb, a, b)`), in a seeded order."""
    prompt = np.repeat(np.asarray(prompts, np.int64), pairs)
    a, b = _pairs(corpus.quality.shape[1], len(prompt), rng)
    s = np.asarray([outcome(corpus.embeddings[p], int(x), int(y))
                    for p, x, y in zip(prompt, a, b)], np.float32)
    order = rng.permutation(len(prompt))
    return Records(prompt[order], a[order], b[order], s[order])
