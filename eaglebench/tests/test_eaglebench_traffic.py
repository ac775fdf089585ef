"""The seeded generators: a seed repeats, and every seed offers the same
work in another order."""
import numpy as np

from eaglebench.traffic import arrivals, corpus, user


def test_schedules_repeat_for_a_seed():
    a = arrivals.poisson_times(400.0, 10.0, np.random.default_rng(3))
    b = arrivals.poisson_times(400.0, 10.0, np.random.default_rng(3))
    assert np.array_equal(a, b)
    s1 = arrivals.loguniform_sizes(64, 1024, 500, np.random.default_rng(3))
    s2 = arrivals.loguniform_sizes(64, 1024, 500, np.random.default_rng(3))
    assert np.array_equal(s1, s2)


def test_seeds_share_the_work():
    big = 2 ** 31 + 12345
    a = arrivals.poisson_times(400.0, 10.0, np.random.default_rng(1))
    b = arrivals.poisson_times(400.0, 10.0, np.random.default_rng(big))
    assert not np.array_equal(a, b)
    assert np.allclose(np.sort(np.diff(a)), np.sort(np.diff(b)), atol=0.02) \
        or abs(len(a) - len(b)) <= 1
    assert a[0] == 0.0 and a[-1] < 10.0 and abs(len(a) - 4000) <= 1
    s1 = arrivals.loguniform_sizes(64, 1024, 999, np.random.default_rng(1))
    s2 = arrivals.loguniform_sizes(64, 1024, 999, np.random.default_rng(big))
    assert np.array_equal(np.sort(s1), np.sort(s2))
    assert s1.min() >= 64 and s1.max() <= 1024
    # the mean of a log-uniform size on [64, 1024]: 960 / ln 16
    assert abs(s1.mean() - 960 / np.log(16)) < 2


def test_corpus_repeats_and_splits():
    spec = {"corpus_seed": 7, "datasets": 7, "prompts_per_dataset": 20,
            "topics_per_dataset": 4, "train_frac": 0.7, "pairs_per_prompt": 8,
            "label_noise": 0.08, "noise": 0.35, "emb_noise": 0.55,
            "emb_noise_dim": 16, "topic_strength": 0.45, "special_strength": 0.9,
            "base_strength": 0.25}
    costs = [1.0, 2.0, 5.0]
    c1 = corpus.make_corpus(spec, costs, 16, "cpu")
    c2 = corpus.make_corpus(spec, costs, 16, "cpu")
    assert np.array_equal(c1.embeddings, c2.embeddings)
    assert np.allclose(np.linalg.norm(c1.embeddings, axis=1), 1, atol=1e-5)
    assert len(c1.train_idx) == 98 and len(c1.test_idx) == 42
    assert not set(c1.train_idx) & set(c1.test_idx)
    r = corpus.fit_records(c1, spec)
    assert len(r) == 98 * 8 and np.all(r.model_a != r.model_b)
    assert np.array_equal(np.bincount(r.prompt)[c1.train_idx],
                          np.full(98, 8))
    fb = corpus.feedback_records(c1, c1.test_idx[:5], 8,
                                 np.random.default_rng(2), user.outcome)
    fb2 = corpus.feedback_records(c1, c1.test_idx[:5], 8,
                                  np.random.default_rng(2), user.outcome)
    assert np.array_equal(fb.outcome, fb2.outcome) and len(fb) == 40
    assert set(np.unique(fb.outcome)) <= {0.0, 0.5, 1.0}


def test_noise_keeps_its_norm_across_widths():
    """One topic centre: two prompts' mean cosine is 1 / (1 + |noise|^2)
    (0.049 for the generator's 0.55 at 64 coordinates), at any width."""
    spec = {"corpus_seed": 3, "datasets": 1, "prompts_per_dataset": 300,
            "topics_per_dataset": 1, "train_frac": 0.7, "noise": 0.35,
            "emb_noise": 0.55, "emb_noise_dim": 64, "topic_strength": 0.45,
            "special_strength": 0.9, "base_strength": 0.25}
    want = 1 / (1 + 0.55 ** 2 * 64)
    for dim in (64, 1536):
        e = corpus.make_corpus(spec, [1.0, 2.0], dim, "cpu").embeddings
        cos = (e @ e.T)[np.triu_indices(len(e), 1)]
        assert abs(cos.mean() - want) < 0.006, (dim, cos.mean())


def test_user_is_the_launchers():
    e = np.asarray([0.25, -0.5, 1.0], np.float32)
    q = user.quality_oracle(e, 3)
    assert 0 <= q < 1 and q == user.quality_oracle(e, 3)
    assert user.outcome(e, 3, 3) == 0.5
    assert user.outcome(e, 1, 2) == 1.0 - user.outcome(e, 2, 1)
