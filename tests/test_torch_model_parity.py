"""The port's dense model against the JAX package, on the CPU: layers
(norms, RoPE, MLP, attention with and without a cache), prefill,
decode_step and FleetModel.generate on the reduced olmo-1b, qwen3-8b and
internlm2-20b, with the JAX `init_params` weights carried across by
`convert.model_params_from_numpy`.

Bars: fp32 logits within 1e-4 (rtol and atol), the same arithmetic up to
summation order through two layers (1.7e-6 seen); greedy tokens equal.
bf16 logits within 0.1 of logits up to ~7 in size (0.023 seen): the two
frameworks round the matmul outputs, the softmax weights and the
residual adds to bf16 at their own points, and one bf16 step at 4..8 is
2^-5 = 0.031.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import FleetModel as JFleetModel
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import FleetModel as TFleetModel

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["olmo-1b", "qwen3-8b", "internlm2-20b"]
#: internlm2-20b keeps its six query heads per KV head (48 / 8), which
#: the reduced defaults (4 / 2) would lose
SHAPES = {"internlm2-20b": dict(n_heads=6, n_kv_heads=1, d_model=192)}
F32_TOL = 1e-4
BF16_TOL = 0.1
MAX_LEN = 48


def _models(arch, dtype="float32", seed=0):
    cfg_j = j_reduced(arch, dtype=dtype, **SHAPES.get(arch, {}))
    cfg_t = t_reduced(arch, dtype=dtype, **SHAPES.get(arch, {}))
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    pt = TT.cast_params(cfg_t, convert.model_params_from_numpy(
        cfg_t, pj, device="cpu"))
    return cfg_j, pj, cfg_t, pt


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_configs_are_the_jax_packages():
    from repro.configs import ARCH_IDS as J_IDS, get_config as j_config
    from repro_torch.configs import ARCH_IDS as T_IDS
    assert T_IDS == J_IDS
    for arch in J_IDS:
        assert vars(t_config(arch)) == vars(j_config(arch)), arch


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "gemma3-12b",
                                  "llava-next-mistral-7b", "zamba2-7b",
                                  "deepseek-v3-671b"])
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TFleetModel(t_reduced(arch), device="cpu")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_jax(norm):
    rng = np.random.default_rng(2)
    cfg_j = j_reduced("qwen3-8b", norm=norm)
    cfg_t = t_reduced("qwen3-8b", norm=norm)
    x = rng.normal(size=(2, 5, cfg_j.d_model)).astype(np.float32)
    p = {"scale": rng.normal(size=cfg_j.d_model).astype(np.float32),
         "bias": rng.normal(size=cfg_j.d_model).astype(np.float32)}
    want = JL.apply_norm(cfg_j, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = TL.apply_norm(cfg_t, {k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = JL.rms_norm_headwise(jnp.asarray(x), jnp.asarray(p["scale"]))
    got = TL.rms_norm_headwise(torch.tensor(x), torch.tensor(p["scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [1000]])).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.tensor(x), torch.tensor(pos, dtype=torch.int64),
                        theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_layer_with_cache_matches_jax(arch):
    """apply_attention on the CPU: prefill into a cache, then one decode
    row, against the JAX layer (which returns a new cache; the port's
    is written in place)."""
    cfg_j, pj, cfg_t, pt = _models(arch)
    pa_j = jax.tree.map(lambda a: a[0], pj["blocks"]["attn"])
    pa_t = pt["blocks"][0]["attn"]
    rng = np.random.default_rng(4)
    b, s, t = 2, 9, 16
    x = rng.normal(size=(b, s + 1, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1), (b, s + 1)).astype(np.int32)
    shape = (b, t, cfg_j.n_kv_heads, cfg_j.hd)
    cj = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    ct = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for lo, hi in ((0, s), (s, s + 1)):
        yj, cj = JL.apply_attention(cfg_j, pa_j, jnp.asarray(x[:, lo:hi]),
                                    jnp.asarray(pos[:, lo:hi]),
                                    theta=cfg_j.rope_theta, cache=cj,
                                    cache_index=lo)
        yt = TL.apply_attention(cfg_t, pa_t, torch.tensor(x[:, lo:hi]),
                                torch.tensor(pos[:, lo:hi],
                                             dtype=torch.int64),
                                theta=cfg_t.rope_theta, cache=ct,
                                cache_index=lo)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg_j, pj, cfg_t, pt = _models(arch)
    toks = _tokens(cfg_j, 3, 11)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    assert lt.shape == (3, cfg_t.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)
    for i in range(4):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 11 + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64), 11 + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {i}")
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["kv"]["k"]),
                               rtol=F32_TOL, atol=F32_TOL)


def test_forward_without_cache_matches_jax():
    cfg_j, pj, cfg_t, pt = _models("qwen3-8b")
    toks = _tokens(cfg_j, 2, 13, seed=5)
    lj = JT.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)})[0]
    lt, _ = TT.forward(cfg_t, pt, torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_model_generate_tokens_equal_jax(arch):
    cfg_j = j_reduced(arch, dtype="float32", **SHAPES.get(arch, {}))
    cfg_t = t_reduced(arch, dtype="float32", **SHAPES.get(arch, {}))
    jm = JFleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    toks = _tokens(cfg_j, 4, 14, seed=6)
    got = tm.generate(toks, 6)
    assert got.shape == (4, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 6))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax(arch):
    cfg_j, pj, cfg_t, pt = _models(arch, dtype="bfloat16")
    assert pt["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(cfg_j, 2, 10, seed=7)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    assert lt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
    lj, _ = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 10)
    lt, _ = TT.decode_step(cfg_t, pt, ct,
                           torch.tensor(tok, dtype=torch.int64), 10)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_model_params_from_numpy_layout():
    cfg_j, pj, cfg_t, pt = _models("qwen3-8b")
    assert len(pt["blocks"]) == cfg_t.n_layers
    a = pt["blocks"][1]["attn"]
    d, h, hk, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.hd
    assert a["wq"].shape == (d, h * hd) and a["wk"].shape == (d, hk * hd)
    assert a["wo"].shape == (h * hd, d) and a["q_norm"].shape == (hd,)
    np.testing.assert_array_equal(
        a["wo"].numpy(),
        np.asarray(pj["blocks"]["attn"]["wo"][1]).reshape(h * hd, d))
    assert "lm_head" in pt and pt["lm_head"].shape == (d, cfg_t.vocab)


def test_init_params_shapes_and_scales():
    cfg = t_reduced("olmo-1b")
    gen = torch.Generator().manual_seed(0)
    p = TT.init_params(cfg, gen)
    assert p["embed"].dtype == torch.float32 and "lm_head" not in p
    assert p["blocks"][0]["attn_norm"] == {}
    w = p["blocks"][0]["ffn"]["w_down"]
    assert w.shape == (cfg.d_ff, cfg.d_model)
    assert abs(float(w.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    TT.cast_params(cfg, p)
    assert p["embed"].dtype == torch.bfloat16
    assert p["blocks"][0]["ffn"]["w_down"].dtype == torch.bfloat16
