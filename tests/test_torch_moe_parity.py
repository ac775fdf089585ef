"""The port's MoE family against the JAX package, on the CPU: the MoE FFN
(`models/moe.py:apply_moe`) against both single-device JAX paths,
`_small_moe` and `_local_moe(..., None, 1, 0)`, called directly, and
the reduced phi3.5-moe (2 layers, 4 experts, top-2, expert width 128)
through prefill, decode_step, FleetModel and a padded ServingEngine,
with the JAX `init_params` weights carried across by
`convert.model_params_from_numpy`.

Bars:
  * apply_moe in fp32: y within 1e-5 (rtol and atol; the same
    arithmetic up to summation order, 1e-6 seen), aux within 1e-6, and
    the two JAX paths equal to each other bit for bit;
  * apply_moe in bf16: both sides take the same experts and slots (the
    router runs in fp32 on the same bf16 activations), and round the
    products, silu, the gated product, the weighted outputs and their
    sum to bf16 at the same points. Where their fp32 accumulations
    straddle a rounding boundary an intermediate moves by one bf16 step
    (2^-8 relative), and through the down projection of ff = 128 such
    terms and the combine that gives a few steps of the output's scale:
    the bar is 2^-5 of the largest |y| (two steps of the largest value,
    doubled), and aux within 1e-6 (fp32 from the same gates);
  * model logits in fp32 within 1e-4 (rtol and atol) and greedy tokens
    equal, as for the dense family (tests/test_torch_model_parity.py);
    bf16 logits within that file's 0.1;
  * the engines' choices and tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import engine as JENG
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TENG

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread: its tensors are small, and
    the suite runs several test processes on one CPU, where more threads
    only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

PHI = "phi3.5-moe-42b-a6.6b"
F32_TOL, AUX_TOL = 1e-5, 1e-6
BF16_REL = 2.0 ** -5
LOGIT_TOL, BF16_LOGIT_TOL = 1e-4, 0.1
MAX_LEN = 48
#: the MoE cases: config overrides and the router's treatment
CASES = {
    "no drops": dict(capacity_factor=4.0),     # C = k T: nothing dropped
    "drops": dict(capacity_factor=0.5),
    "biased router": dict(),                   # every token on expert 0
    "tied gates": dict(),                      # a zero router: all 1/E
    "shared expert": dict(n_shared_experts=1, first_k_dense=1),
}


def _cfgs(dtype="float32", **kw):
    return j_reduced(PHI, dtype=dtype, **kw), t_reduced(PHI, dtype=dtype,
                                                        **kw)


def _models(dtype="float32", seed=0, **kw):
    cfg_j, cfg_t = _cfgs(dtype, **kw)
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    pt = TT.cast_params(cfg_t, convert.model_params_from_numpy(
        cfg_t, pj, device="cpu"))
    return cfg_j, pj, cfg_t, pt


def _ffn(case, dtype):
    """A MoE layer's parameters on both sides, and the two configs."""
    cfg_j, pj, cfg_t, pt = _models(dtype, **CASES[case])
    fj = jax.tree.map(lambda a: a[0], pj["moe_blocks"]["ffn"])
    ft = pt["blocks"][cfg_t.first_k_dense]["ffn"]
    if case in ("biased router", "tied gates"):
        r = np.zeros(ft["router"].shape, np.float32)
        if case == "biased router":     # the drawn router, expert 0 first
            r = ft["router"].float().numpy().copy()
            r[:, 0] += 1.0
        fj = {**fj, "router": jnp.asarray(r)}
        ft = {**ft, "router": torch.tensor(r)}
    return cfg_j, fj, cfg_t, ft


def _x(cfg, b, s, seed=0):
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
    if cfg.dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x.astype(np.float32) + 0.5      # a mean for the biased router


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _dropped(cfg_t, ft, x):
    t = x.shape[0] * x.shape[1]
    dp = TM.dispatch(cfg_t, ft["router"], torch.tensor(x).reshape(t, -1))
    return int((~dp.keep).sum())


def _jax_paths(cfg_j, fj, x):
    """_small_moe and _local_moe(..., None, 1, 0) on the (T, d) tokens,
    each with the shared experts added as the JAX apply_moe adds them."""
    b, s, d = x.shape
    xt = jnp.asarray(x, cfg_j.dtype).reshape(b * s, d)
    routed = {k: fj[k] for k in ("router", "w_gate", "w_up", "w_down")}
    out = {"small": JM._small_moe(cfg_j, routed, xt, None),
           "local": JM._local_moe(cfg_j, routed, xt, None, 1, 0)}
    if cfg_j.n_shared_experts:     # as the JAX apply_moe adds them
        sp = {k: v.astype(xt.dtype) for k, v in fj["shared"].items()}
        g = jnp.einsum("td,df->tf", xt, sp["w_gate"])
        u = jnp.einsum("td,df->tf", xt, sp["w_up"])
        shared = jnp.einsum("tf,fd->td", jax.nn.silu(g) * u, sp["w_down"])
        out = {k: (y + shared, aux) for k, (y, aux) in out.items()}
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("b,s", [(3, 7), (1, 1)])
def test_apply_moe_matches_both_jax_paths(case, dtype, b, s):
    cfg_j, fj, cfg_t, ft = _ffn(case, dtype)
    x = _x(cfg_t, b, s)
    y, aux = TM.apply_moe(cfg_t, ft, torch.tensor(x).to(
        TT.torch_dtype(cfg_t.dtype)))
    assert y.shape == x.shape and y.dtype == TT.torch_dtype(cfg_t.dtype)
    assert aux.dtype == torch.float32
    paths = _jax_paths(cfg_j, fj, x)
    np.testing.assert_array_equal(_np(paths["small"][0]),
                                  _np(paths["local"][0]))
    for name, (yj, auxj) in paths.items():
        want = _np(yj).reshape(x.shape)
        if dtype == "float32":
            np.testing.assert_allclose(_np(y), want, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)
        else:
            bar = BF16_REL * np.abs(want).max()
            assert np.abs(_np(y) - want).max() <= bar, name
        np.testing.assert_allclose(float(aux), float(auxj), rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=name)


def test_cases_drop_as_named():
    """The cases do what they are named for: nothing dropped at a
    capacity of k T, pairs dropped at 0.5; with 21 tokens and a capacity
    of 13, the biased router's expert 0 drops at least 8 pairs, and tied
    gates take experts 0 and 1 for every token, each dropping 8."""
    drops = {}
    for case in CASES:
        _, _, cfg_t, ft = _ffn(case, "float32")
        drops[case] = _dropped(cfg_t, ft, _x(cfg_t, 3, 7))
    assert TM.capacity(cfg_t, 21) == 13
    assert drops["no drops"] == 0 and drops["drops"] > 0
    assert drops["biased router"] >= 21 - 13
    assert drops["tied gates"] == 2 * (21 - 13)
    _, _, cfg_t, ft = _ffn("tied gates", "float32")
    _, top_e, _ = TM.route(cfg_t, ft["router"], torch.zeros((5, 128)))
    assert top_e.tolist() == [[0, 1]] * 5


@pytest.mark.parametrize("t", [8192, 8200])
def test_apply_moe_matches_jax_apply_moe_either_side_of_small_t(t):
    """The JAX apply_moe takes _small_moe up to 8192 tokens and
    _local_moe above: the port's one function equals both (fp32)."""
    cfg_j, fj, cfg_t, ft = _ffn("drops", "float32")
    x = _x(cfg_t, 1, t, seed=3)
    yj, auxj = JM.apply_moe(cfg_j, fj, jnp.asarray(x))
    y, aux = TM.apply_moe(cfg_t, ft, torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), _np(yj), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=AUX_TOL,
                               atol=AUX_TOL)
    assert _dropped(cfg_t, ft, x) > 0


def test_capacity_is_the_jax_formula():
    cfg = t_reduced(PHI)
    k, e = cfg.experts_per_tok, cfg.n_experts
    for t in (1, 2, 3, 7, 21, 100, 8192, 16384):
        assert TM.capacity(cfg, t) == int(max(k, 1.25 * k * t / e))
    full = t_config(PHI)
    assert TM.capacity(full, 8 * 1024) == 1280
    assert TM.capacity(full, 8) == 2


def test_init_moe_shapes_and_scales():
    cfg = t_reduced(PHI, n_shared_experts=2)
    p = TM.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
    assert p["router"].shape == (d, e)
    assert p["w_gate"].shape == p["w_up"].shape == (e, d, ff)
    assert p["w_down"].shape == (e, ff, d)
    assert p["shared"]["w_down"].shape == (2 * ff, d)
    assert abs(float(p["w_down"].std()) - ff ** -0.5) < 0.05 * ff ** -0.5
    assert abs(float(p["shared"]["w_down"].std()) - (2 * ff) ** -0.5) \
        < 0.1 * (2 * ff) ** -0.5


@pytest.mark.parametrize("arch,kw", [(PHI, {}),
                                     (PHI, CASES["shared expert"]),
                                     ("olmo-1b", {})])
def test_init_params_cast_equals_init_then_cast(arch, kw):
    """init_params(cast=True) casts each block as it is drawn: the values
    of init_params then cast_params, the router kept in fp32 and the
    shared experts cast."""
    cfg = t_reduced(arch, **kw)
    a = TT.cast_params(cfg, TT.init_params(
        cfg, torch.Generator().manual_seed(5)))
    b = TT.init_params(cfg, torch.Generator().manual_seed(5), cast=True)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree
    got, want = dict(leaves(b)), dict(leaves(a))
    assert list(got) == list(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert torch.equal(got[path], w), path
        if path.endswith("/router"):
            assert w.dtype == torch.float32
        elif "/ffn/" in path:
            assert w.dtype == torch.bfloat16, path
    if kw:
        assert "shared" in b["blocks"][1]["ffn"] \
            and "router" not in b["blocks"][0]["ffn"]


def test_model_params_from_numpy_layout():
    cfg_j, pj, cfg_t, pt = _models(**CASES["shared expert"])
    assert len(pt["blocks"]) == cfg_t.n_layers == 2
    dense, moe = (b["ffn"] for b in pt["blocks"])
    assert set(dense) == {"w_gate", "w_up", "w_down"}
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    e, d, ff = cfg_t.n_experts, cfg_t.d_model, cfg_t.expert_ff
    assert moe["w_gate"].shape == (e, d, ff) and moe["router"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        moe["shared"]["w_up"].float().numpy(),
        np.asarray(pj["moe_blocks"]["ffn"]["shared"]["w_up"][0], np.float32))
    np.testing.assert_array_equal(
        pt["blocks"][0]["attn"]["wo"].numpy(),
        np.asarray(pj["dense_blocks"]["attn"]["wo"][0]).reshape(-1, d))
    _, pj, cfg_t, pt = _models()
    assert pj["dense_blocks"] is None and len(pt["blocks"]) == 2


@pytest.mark.parametrize("kw", [{}, CASES["shared expert"],
                                CASES["drops"]],
                         ids=["phi", "shared expert", "drops"])
def test_prefill_and_decode_match_jax(kw):
    cfg_j, pj, cfg_t, pt = _models(**kw)
    toks = np.random.default_rng(1).integers(
        0, cfg_j.vocab, (3, 11)).astype(np.int32)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for i in range(4):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 11 + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64), 11 + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj, -1)))
    k = cfg_t.first_k_dense
    np.testing.assert_allclose(ct["k"][k:].numpy(),
                               np.asarray(cj["kv_moe"]["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if k:
        np.testing.assert_allclose(ct["v"][:k].numpy(),
                                   np.asarray(cj["kv_dense"]["v"]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_bf16_logits_match_jax():
    cfg_j, pj, cfg_t, pt = _models("bfloat16")
    assert pt["blocks"][0]["ffn"]["w_up"].dtype == torch.bfloat16
    assert pt["blocks"][0]["ffn"]["router"].dtype == torch.float32
    toks = np.random.default_rng(7).integers(
        0, cfg_j.vocab, (2, 10)).astype(np.int32)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_LOGIT_TOL,
                               atol=BF16_LOGIT_TOL)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
    lj, _ = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 10)
    lt, _ = TT.decode_step(cfg_t, pt, ct,
                           torch.tensor(tok, dtype=torch.int64), 10)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_LOGIT_TOL,
                               atol=BF16_LOGIT_TOL)


@pytest.mark.parametrize("b", [1, 4])
def test_fleet_model_generate_tokens_equal_jax(b):
    cfg_j, cfg_t = _cfgs()
    jm = JENG.FleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TENG.FleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                         params=convert.model_params_from_numpy(
                             cfg_t, jm.params, device="cpu"))
    toks = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (b, 14)).astype(np.int32)
    got = tm.generate(toks, 6)
    assert got.shape == (b, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 6))


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

NAMES = ["olmo-1b", PHI]
DIM = 64


@pytest.fixture(scope="module")
def world():
    from repro.data.routerbench import make_corpus, pairwise_feedback
    corpus = make_corpus(seed=0, n_per_dataset=60, dim=DIM, model_names=NAMES,
                         costs=np.linspace(1.0, 8.0, len(NAMES)))
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=4)
    jfleet = {n: JENG.FleetModel(j_reduced(n, dtype="float32"), seed=i,
                                 max_len=MAX_LEN)
              for i, n in enumerate(NAMES)}
    return corpus, fb, jfleet


def _engines(world, **kw):
    """The JAX engine and the port's over the same fleet weights and
    routers fitted on the same feedback (the launcher's oracle)."""
    from repro import obs as JOBS
    from repro.core.router import EagleConfig as JConfig
    from repro.core.router import EagleRouter as JRouter
    from repro_torch import obs as TOBS
    from repro_torch.core.router import EagleConfig as TConfig
    from repro_torch.core.router import EagleRouter as TRouter
    from repro_torch.launch.serve import quality_oracle
    corpus, fb, jfleet = world
    args = (fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"])
    jr = JRouter(NAMES, corpus.costs, JConfig(embed_dim=DIM),
                 db_capacity=1 << 12)
    jr.fit(*args)
    tr = TRouter(NAMES, corpus.costs, TConfig(embed_dim=DIM),
                 db_capacity=1 << 12, device="cpu")
    tr.fit(*args)
    tfleet = {n: TENG.FleetModel(
        t_reduced(n, dtype="float32"), max_len=MAX_LEN, device="cpu",
        params=convert.model_params_from_numpy(
            t_reduced(n, dtype="float32"), m.params, device="cpu"))
        for n, m in jfleet.items()}
    common = dict(compare_rate=1.0, seed=0, quality_oracle=quality_oracle)
    return (JENG.ServingEngine(jfleet, jr, obs=JOBS.Observability(),
                               **common, **kw),
            TENG.ServingEngine(tfleet, tr, obs=TOBS.Observability(),
                               **common, **kw))


def _requests(corpus, cls, seed, n):
    rng = np.random.default_rng(seed)
    idx = rng.choice(corpus.test_idx, n, replace=False)
    return [cls(tokens=rng.integers(0, 500, rng.integers(3, 14)).astype(
                    np.int32),
                embedding=corpus.embeddings[i],
                budget=float(rng.uniform(1.0, 10.0)),
                max_new_tokens=int(rng.integers(1, 5)), rid=k)
            for k, i in enumerate(idx)]


def _tokens(res):
    return [(r.rid, r.model, np.asarray(r.tokens).tolist()) for r in res]


@pytest.mark.parametrize("kw", [{}, dict(gen_bucket=True, gen_pad_len=16)],
                         ids=["unpadded", "padded"])
def test_serve_matches_jax(world, kw):
    """Both engines route the same requests to the same models and phi
    answers with the same tokens, unpadded and with its groups padded to
    the row ladder and 16 tokens (gen_bucket, gen_pad_len): the padded
    rows and positions raise the call's token count, and with it phi's
    capacity, in both packages alike."""
    corpus = world[0]
    je, te = _engines(world, **kw)
    for step in range(2):
        jres = je.serve(_requests(corpus, JENG.Request, step, 11))
        tres = te.serve(_requests(corpus, TENG.Request, step, 11))
        assert _tokens(tres) == _tokens(jres)
        assert {r.model for r in tres} == set(NAMES)
    assert te.stats == je.stats


def test_padding_changes_what_phi_answers(world):
    """The padded engine's phi group runs at a larger token count than
    the unpadded one's (a larger capacity, the padded positions taking
    slots): its tokens differ from the unpadded engine's for some
    request, and equal the JAX padded engine's (above)."""
    corpus = world[0]
    _, plain = _engines(world)
    _, padded = _engines(world, gen_bucket=True, gen_pad_len=16)
    reqs = lambda: _requests(corpus, TENG.Request, 0, 11)
    a, b = plain.serve(reqs()), padded.serve(reqs())
    phi = [i for i, r in enumerate(a) if r.model == PHI]
    assert phi and [r.model for r in a] == [r.model for r in b]
    rows = len(phi)
    longest = max(len(reqs()[i].tokens) for i in phi)
    cfg = padded.fleet[PHI].cfg
    assert TM.capacity(cfg, rows * longest) < TM.capacity(
        cfg, (1 << (rows - 1).bit_length()) * 16)
    assert any(not np.array_equal(a[i].tokens, b[i].tokens) for i in phi)


def test_launcher_fleet_of_five_matches_jax():
    """Both launchers' `build_engine(n_fleet=5)`: ARCH_IDS[:5] at their
    reduced configs, phi3.5-moe last, behind routers fitted on the same
    corpus, route the same requests to the same models, and every
    response has its rid and max_new tokens in the vocabulary. phi, the
    dearest (cost 8) and rated lowest of the five, is chosen for one of
    the corpus's first 17 test prompts at a budget of 10, the last one
    here. Random weights differ between the frameworks, so tokens are
    not compared."""
    from repro.launch import serve as JSERVE
    from repro_torch.launch import serve as TSERVE
    je, corpus = JSERVE.build_engine(n_fleet=5)
    te, _ = TSERVE.build_engine(n_fleet=5, device="cpu")
    assert list(te.fleet) == list(je.fleet) == [
        "whisper-large-v3", "olmo-1b", "mamba2-780m", "qwen3-8b", PHI]
    assert te.fleet[PHI].cache_stats()["warmed"] == len(TSERVE.WARM_SIZES)
    rng = np.random.default_rng(11)
    budgets = [1.0, 2.5, 3.5, 5.5, 6.5, 8.0, 9.0, 10.0] * 2 + [10.0]
    args = [(rng.integers(0, 100, rng.integers(4, 12)).astype(np.int32),
             corpus.embeddings[i], b)
            for i, b in zip(corpus.test_idx[:17], budgets)]
    jres = je.serve([JENG.Request(tokens=t, embedding=e, budget=b,
                                  max_new_tokens=2, rid=k)
                     for k, (t, e, b) in enumerate(args)])
    tres = te.serve([TENG.Request(tokens=t, embedding=e, budget=b,
                                  max_new_tokens=2, rid=k)
                     for k, (t, e, b) in enumerate(args)])
    assert [r.model for r in tres] == [r.model for r in jres]
    assert tres[-1].model == PHI and len({r.model for r in tres}) >= 4
    for k, r in enumerate(tres):
        vocab = te.fleet[r.model].cfg.vocab
        assert r.rid == k and r.tokens.shape == (2,)
        assert 0 <= r.tokens.min() and r.tokens.max() < vocab
