"""The port's baseline routers and their optimiser against the JAX
package, on the CPU: `winrate_targets`, `cosine_schedule`, `AdamW`, the
KNN, MLP and SVM routers, and `evaluate_router` over a route function
that returns a tensor.

Tolerances: the schedule within 1e-7 at every step; AdamW's parameters
within 1e-6 over 20 steps with fp32 moments, and with bf16 moments the
moments within one bf16 ulp and the parameters within 1e-5; KNN's
neighbours, choices and AUCs equal, its predictions within 1e-6; the
MLP (from JAX's initial weights, carried across by
`convert.router_params_from_numpy`) and the SVM within 1e-5 in
parameters and loss history after 50 epochs at the frozen regime
(measured: ~2e-7 and ~1e-6). The 300-epoch fits are not held: over 300
epochs Adam's normalisation of near-zero gradients amplifies fp32
rounding, and the two frameworks' parameters part by 0.06 (MLP) and
0.003 (SVM).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import routerbench as JRB
from repro.kernels import ops as JOPS
from repro.routing import baselines as JB
from repro.training import optim as JOPT
from repro_torch import convert
from repro_torch.data import routerbench as TRB
from repro_torch.kernels import ops as TOPS
from repro_torch.routing import baselines as TB
from repro_torch.training import optim as TOPT

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
FIT_EPOCHS = 50
FIT_TOL = 1e-5


def _frozen_regime():
    """benchmarks/common.py's regime at seed 0: 300 prompts per dataset,
    D = 64, 8 pairs per query; the online (win-rate) targets."""
    corpus = JRB.make_corpus(seed=0, n_per_dataset=300, dim=64)
    fb = JRB.pairwise_feedback(corpus, corpus.train_idx, seed=0,
                               pairs_per_query=8)
    return corpus, JRB.winrate_targets(fb, corpus.n_models)


@pytest.mark.parametrize("stage", [0.7, 1.0])
def test_winrate_targets_equal(stage):
    corpus = JRB.make_corpus(seed=1, n_per_dataset=40, dim=16)
    fb = JRB.pairwise_feedback(corpus, corpus.stage_indices(stage), seed=3,
                               pairs_per_query=8)
    want = JRB.winrate_targets(fb, corpus.n_models)
    got = TRB.winrate_targets(fb, corpus.n_models)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("warmup,total", [(0, 10), (5, 40), (10, 10)])
def test_cosine_schedule_matches_jax(warmup, total):
    steps = np.arange(total + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(JOPT.cosine_schedule(warmup, total))(
        jnp.asarray(steps)))
    got = TOPT.cosine_schedule(warmup, total)(torch.tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype):
    """20 steps over a dict with a 2-D and a 1-D leaf, with clip, decay and
    a schedule on; the gradients, made from a seed, are large enough that
    the clip binds on some steps."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * rng.choice([0.1, 3.0]))
              .astype(np.float32) for k, v in p0.items()}
             for _ in range(20)]
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jopt = JOPT.AdamW(state_dtype=getattr(jnp, state_dtype),
                      schedule=JOPT.cosine_schedule(3, 20), **kw)
    topt = TOPT.AdamW(state_dtype=getattr(torch, state_dtype),
                      schedule=TOPT.cosine_schedule(3, 20), **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = convert.router_params_from_numpy(p0, device=CPU)
    ts = topt.init(tp)
    step = jax.jit(jopt.update)
    clipped = 0
    for g in grads:
        clipped += np.sqrt(sum((v ** 2).sum() for v in g.values())) > 1.0
        jp, js = step({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.update({k: torch.tensor(v) for k, v in g.items()},
                             ts, tp)
    assert 0 < clipped < 20
    assert int(ts["step"]) == int(js["step"]) == 20
    assert ts["step"].dtype == torch.int32
    p_tol = 1e-6 if state_dtype == "float32" else 1e-5
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=p_tol)
        for mom in ("m", "v"):
            got = ts[mom][k]
            want = np.asarray(js[mom][k].astype(jnp.float32))
            assert got.dtype == getattr(torch, state_dtype)
            got = got.float().numpy()
            if state_dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
            else:
                assert (np.abs(got - want) <= _bf16_ulp(want)).all(), mom


def test_adamw_decays_matrices_only():
    """Zero gradients: only the 2-D leaf moves, by lr * wd * p."""
    opt = TOPT.AdamW(lr=0.1, weight_decay=0.5)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    s = opt.init(p)
    opt.update({"w": torch.zeros(2, 2), "b": torch.zeros(2)}, s, p)
    torch.testing.assert_close(p["w"], torch.full((2, 2), 0.95))
    torch.testing.assert_close(p["b"], torch.ones(2))


@pytest.mark.parametrize("regime", ["online", "offline"])
def test_knn_router_matches_jax(regime):
    corpus = JRB.make_corpus(seed=0, n_per_dataset=40, dim=16)
    if regime == "online":
        fb = JRB.pairwise_feedback(corpus, corpus.train_idx, seed=0,
                                   pairs_per_query=8)
        emb, tgt, mask = JRB.winrate_targets(fb, corpus.n_models)
    else:
        tr = corpus.train_idx
        emb, tgt, mask = corpus.embeddings[tr], corpus.quality[tr], None
    jr = JB.KNNRouter(corpus.costs)
    tr_ = TB.KNNRouter(corpus.costs, device=CPU)
    jr.fit(emb, tgt, mask)
    tr_.fit(emb, tgt, mask)
    q = corpus.embeddings[corpus.test_idx]
    n = min(40, len(emb))
    _, j_idx = JOPS.similarity_topk(jnp.asarray(q), jr.emb, n)
    _, t_idx = TOPS.similarity_topk(torch.tensor(q), tr_.emb, n)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(tr_.predict(q).numpy(),
                               np.asarray(jr.predict(q)), rtol=0, atol=1e-6)
    for b in JRB.budget_grid(corpus.costs):
        np.testing.assert_array_equal(tr_.route(q, float(b)).numpy(),
                                      np.asarray(jr.route(q, float(b))))
    for d in range(len(JRB.DATASETS)):
        want = JRB.evaluate_router(lambda e, b: jr.route(e, b), corpus,
                                   dataset=d)
        got = TRB.evaluate_router(lambda e, b: tr_.route(e, b), corpus,
                                  dataset=d)
        np.testing.assert_array_equal(got["quality"], want["quality"])
        assert got["auc"] == want["auc"]


def _jax_fit(name, costs, emb, tgt, mask, epochs):
    """The JAX router fitted for `epochs`, and its loss before each step:
    the loop of its `fit`, rebuilt from the router's own loss pieces and
    optimiser (its `fit` keeps no losses); the rebuilt loop's parameters
    must equal the `fit`'s exactly."""
    x = jnp.asarray(emb, jnp.float32)
    y = jnp.asarray(tgt, jnp.float32)
    m = jnp.asarray(mask, jnp.float32)
    if name == "mlp":
        r = JB.MLPRouter(costs, epochs=epochs)
        params = r._init(x.shape[1], y.shape[1])
        opt = r.opt

        def loss(p):
            se = (r._fwd(p, x) - y) ** 2 * m
            return se.sum() / jnp.maximum(m.sum(), 1.0)
    else:
        r = JB.SVMRouter(costs, epochs=epochs)
        params = {"w": jnp.zeros((x.shape[1], y.shape[1])),
                  "b": jnp.zeros((y.shape[1],))}
        opt = JOPT.AdamW(lr=r.lr, weight_decay=0.0, grad_clip=0.0)

        def loss(p):
            res = x @ p["w"] + p["b"] - y
            hinge = jnp.maximum(jnp.abs(res) - r.epsilon, 0.0) * m
            return hinge.sum() / jnp.maximum(m.sum(), 1.0) \
                + r.reg * jnp.sum(p["w"] ** 2)

    @jax.jit
    def step(p, s):
        val, g = jax.value_and_grad(loss)(p)
        return (*opt.update(g, s, p), val)

    init = {k: np.asarray(v) for k, v in params.items()}
    s = opt.init(params)
    losses = []
    for _ in range(epochs):
        params, s, val = step(params, s)
        losses.append(float(val))
    r.fit(emb, tgt, mask)
    fitted = {"w1": r.params["w1"], "b1": r.params["b1"],
              "w2": r.params["w2"], "b2": r.params["b2"]} \
        if name == "mlp" else {"w": r.w, "b": r.b}
    for k, v in fitted.items():
        np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(v))
    return {k: np.asarray(v) for k, v in fitted.items()}, \
        np.asarray(losses), init


def _torch_router(name, costs, epochs, init):
    if name == "mlp":
        r = TB.MLPRouter(costs, epochs=epochs, device=CPU)
        r._init = lambda d, m: convert.router_params_from_numpy(init, CPU)
        return r
    return TB.SVMRouter(costs, epochs=epochs, device=CPU)


@pytest.mark.parametrize("name", ["mlp", "svm"])
def test_gradient_router_matches_jax_over_50_epochs(name):
    corpus, (emb, tgt, mask) = _frozen_regime()
    want, want_loss, init = _jax_fit(name, corpus.costs, emb, tgt, mask,
                                     FIT_EPOCHS)
    r = _torch_router(name, corpus.costs, FIT_EPOCHS, init)
    r.fit(emb, tgt, mask)
    for k, v in want.items():
        np.testing.assert_allclose(r.params[k].detach().numpy(), v, rtol=0,
                                   atol=FIT_TOL, err_msg=k)
    np.testing.assert_allclose(r.losses.numpy(), want_loss, rtol=0,
                               atol=FIT_TOL)
    q = corpus.embeddings[corpus.test_idx]
    np.testing.assert_allclose(r.predict(q).numpy(),
                               np.asarray(_jax_predict(name, want, q)),
                               rtol=0, atol=1e-4)


def _jax_predict(name, params, q):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    if name == "mlp":
        return JB.MLPRouter._fwd(p, jnp.asarray(q))
    return jnp.asarray(q) @ p["w"] + p["b"]


def test_svm_first_epoch_needs_jax_subgradient():
    """At w = b = 0 every target of 0 gives r = 0 exactly. The port's hinge
    takes JAX's subgradient there (slope 0.5) and agrees after one epoch;
    torch's own (abs and clamp_min: slope 0) does not."""
    corpus, (emb, tgt, mask) = _frozen_regime()
    assert (tgt[mask] == 0).any()
    want, _, _ = _jax_fit("svm", corpus.costs, emb, tgt, mask, 1)
    r = TB.SVMRouter(corpus.costs, epochs=1, device=CPU)
    r.fit(emb, tgt, mask)
    for k in ("w", "b"):
        np.testing.assert_allclose(getattr(r, k).numpy(), want[k], rtol=0,
                                   atol=FIT_TOL)

    class Naive(TB.SVMRouter):
        def _loss(self, p, x, y, mk):
            res = x @ p["w"] + p["b"] - y
            hinge = torch.clamp_min(res.abs() - self.epsilon, 0.0) * mk
            return hinge.sum() / torch.clamp_min(mk.sum(), 1.0) \
                + self.reg * torch.sum(p["w"] ** 2)

    naive = Naive(corpus.costs, epochs=1, device=CPU)
    naive.fit(emb, tgt, mask)
    off = max(np.abs(getattr(naive, k).numpy() - want[k]).max()
              for k in ("w", "b"))
    assert off > 1e-3, off


def test_second_fit_of_a_shape_reuses_its_step():
    """The step cache: one entry per (Q, D, M); a second fit of the same
    shape is a hit and starts again from the initial weights. A step
    past `epochs` writes its loss into the ring of `epochs` slots."""
    corpus, (emb, tgt, mask) = _frozen_regime()
    r = TB.MLPRouter(corpus.costs, epochs=5, device=CPU)
    r.fit(emb, tgt, mask)
    first = {k: v.detach().clone() for k, v in r.params.items()}
    r.fit(emb, tgt, mask)
    for k, v in first.items():
        torch.testing.assert_close(r.params[k].detach(), v, rtol=0, atol=0)
    r.fit(emb[:100], tgt[:100], mask[:100])
    stats = r.cache_stats()
    assert (stats["hits"], stats["misses"]) == (1, 2)
    assert stats["keys"] == [(100, 64, 10), (len(emb), 64, 10)]
    train, step = r._steps.entries[(100, 64, 10)]
    losses = train.losses.clone()
    step()
    assert int(train.state["step"]) == 6
    assert train.losses[0] < losses[0]
    torch.testing.assert_close(train.losses[1:], losses[1:], rtol=0, atol=0)


def test_evaluate_router_accepts_a_tensor():
    """A route function that returns a torch tensor gives the same curve
    and AUC as one that returns the same choices as an array, and as the
    JAX package's evaluate_router over them."""
    corpus = JRB.make_corpus(seed=2, n_per_dataset=40, dim=16)
    rng = np.random.default_rng(0)
    table = {}

    def route_np(e, b):
        key = (len(e), b)
        if key not in table:
            table[key] = rng.integers(0, corpus.n_models, len(e))
        return table[key]

    for d in (None, 3):
        want = JRB.evaluate_router(route_np, corpus, dataset=d)
        got = TRB.evaluate_router(lambda e, b: torch.tensor(route_np(e, b)),
                                  corpus, dataset=d)
        np.testing.assert_array_equal(got["quality"], want["quality"])
        assert got["auc"] == want["auc"]
