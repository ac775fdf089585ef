"""The port's Mamba2 block and SSM model against the JAX package, on the
CPU: `apply_mamba2` on the reduced mamba2-780m config (prefill shorter
than a chunk and two chunks long, then 4 recurrent decode steps from the
prefill's state), the whole reduced model through prefill and
decode_step, and FleetModel.generate, with the JAX `init_params` weights
carried across by `convert.model_params_from_numpy`.

Bars: fp32 within 1e-4 (rtol and atol): the same arithmetic up to
summation order (the block's outputs agree to ~1e-6); greedy tokens
equal. bf16 logits within 0.1 of logits up to ~7 in size, as for the
dense models (tests/test_torch_model_parity.py): the frameworks round
to bf16 at their own points, one bf16 step at 4..8 is 2^-5.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.serving.engine import FleetModel as JFleetModel
from repro_torch import convert
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import FleetModel as TFleetModel

jax.config.update("jax_platform_name", "cpu")

ARCH = "mamba2-780m"
F32_TOL = 1e-4
BF16_TOL = 0.1
MAX_LEN = 96


def _models(dtype="float32", seed=0):
    cfg_j = j_reduced(ARCH, dtype=dtype)
    cfg_t = t_reduced(ARCH, dtype=dtype)
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    pt = TT.cast_params(cfg_t, convert.model_params_from_numpy(
        cfg_t, pj, device="cpu"))
    return cfg_j, pj, cfg_t, pt


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def f32_models():
    return _models()


@pytest.mark.parametrize("s", [20, 64])     # below one chunk (32), two
def test_apply_mamba2_prefill_and_decode_match_jax(f32_models, s):
    cfg_j, pj, cfg_t, pt = f32_models
    assert cfg_t.ssm_chunk == 32
    pm_j = jax.tree.map(lambda a: a[0], pj["blocks"]["mamba"])
    pm_t = pt["blocks"][0]["mamba"]
    rng = np.random.default_rng(s)
    b = 2
    x = rng.normal(size=(b, s + 4, cfg_t.d_model)).astype(np.float32)
    cj = jax.tree.map(lambda a: a[0], JT.init_cache(cfg_j, b, MAX_LEN,
                                                    jnp.float32)["ssm"])
    ct = {k: v[0] for k, v in TT.init_cache(cfg_t, b, MAX_LEN).items()}
    j_apply = jax.jit(partial(JSSM.apply_mamba2, cfg_j))
    for lo, hi in ((0, s),) + tuple((i, i + 1) for i in range(s, s + 4)):
        yj, cj = j_apply(pm_j, jnp.asarray(x[:, lo:hi]), cache=cj)
        yt, ct2 = TSSM.apply_mamba2(cfg_t, pm_t, torch.tensor(x[:, lo:hi]),
                                    cache=ct)
        assert ct2 is ct                         # updated in place
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"tokens {lo}:{hi}")
        for name in ("conv_x", "conv_B", "conv_C", "ssm"):
            np.testing.assert_allclose(ct[name].numpy(),
                                       np.asarray(cj[name]), rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)


def test_apply_mamba2_without_cache_matches_jax(f32_models):
    cfg_j, pj, cfg_t, pt = f32_models
    pm_j = jax.tree.map(lambda a: a[1], pj["blocks"]["mamba"])
    x = np.random.default_rng(3).normal(
        size=(3, 96, cfg_t.d_model)).astype(np.float32)
    yj, cj = jax.jit(partial(JSSM.apply_mamba2, cfg_j))(pm_j,
                                                       jnp.asarray(x))
    yt, ct = TSSM.apply_mamba2(cfg_t, pt["blocks"][1]["mamba"],
                               torch.tensor(x))
    assert cj is None and ct is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ssd_keeps_the_chunk_contract(f32_models):
    """S must be a multiple of min(ssm_chunk, S): 40 tokens over chunks
    of 32 fail in both packages; the module does not pad."""
    cfg_j, pj, cfg_t, pt = f32_models
    x = np.zeros((1, 40, cfg_t.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        JSSM.apply_mamba2(cfg_j, jax.tree.map(lambda a: a[0],
                                              pj["blocks"]["mamba"]),
                          jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible"):
        TSSM.apply_mamba2(cfg_t, pt["blocks"][0]["mamba"], torch.tensor(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    cfg_j, pj, cfg_t, pt = _models(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    toks = np.random.default_rng(1).integers(
        0, cfg_j.vocab, (3, 64)).astype(np.int32)
    j_decode = jax.jit(partial(JT.decode_step, cfg_j))
    lj, cj = jax.jit(partial(JT.prefill, cfg_j, max_len=MAX_LEN,
                             cache_dtype=jnp.float32))(
        pj, {"tokens": jnp.asarray(toks)})
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    assert lt.shape == (3, cfg_t.vocab)
    assert ct["ssm"].dtype == torch.float32
    for i in range(5):
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol,
                                   err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(_np(lt).argmax(-1), tok)
        if i == 4:
            break
        lj, cj = j_decode(pj, cj, jnp.asarray(tok[:, None]), 64 + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok[:, None],
                                             dtype=torch.int64), 64 + i)
    np.testing.assert_allclose(ct["ssm"].numpy(),
                               np.asarray(cj["ssm"]["ssm"], np.float32),
                               rtol=tol, atol=tol)


def test_fleet_model_generate_tokens_equal_jax():
    cfg_j = j_reduced(ARCH, dtype="float32")
    cfg_t = t_reduced(ARCH, dtype="float32")
    jm = JFleetModel(cfg_j, seed=3, max_len=48)
    tm = TFleetModel(cfg_t, max_len=48, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    toks = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (4, 16)).astype(np.int32)
    got = tm.generate(toks, 6)
    assert got.shape == (4, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 6))


def test_init_params_and_cache_shapes():
    cfg = t_reduced(ARCH)
    p = TT.init_params(cfg, torch.Generator().manual_seed(0))
    m = p["blocks"][0]["mamba"]
    h, gn = cfg.ssm_nheads, cfg.ssm_ngroups * cfg.ssm_state
    assert m["in_x"].shape == (cfg.d_model, cfg.d_inner)
    assert m["in_B"].shape == (cfg.d_model, gn)
    assert m["conv_x_w"].shape == (cfg.ssm_conv, cfg.d_inner)
    assert m["A_log"].shape == (h,) and "lm_head" not in p
    TT.cast_params(cfg, p)
    assert p["blocks"][1]["mamba"]["out_proj"].dtype == torch.bfloat16
    assert p["blocks"][1]["norm"]["scale"].dtype == torch.float32
    c = TT.init_cache(cfg, 3, 64, torch.bfloat16)
    assert c["ssm"].shape == (cfg.n_layers, 3, h, cfg.ssm_head_dim,
                              cfg.ssm_state)
    assert c["conv_C"].shape == (cfg.n_layers, 3, cfg.ssm_conv - 1, gn)
    assert all(v.dtype == torch.float32 for v in c.values())
