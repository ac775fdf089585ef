"""llava-next-mistral-7b (the vlm family) against the JAX package, on the
CPU: the reduced config (8 stub image tokens before the text) through
forward, prefill + decode_step and FleetModel.generate, with the JAX
weights carried across by `convert.model_params_from_numpy`.

The image embeddings are cast to the compute type and put before the
embedded text (the sqrt(d) scale is the text's alone); the image rows
take positions 0..N-1 and the text N.. (JAX `forward`); decode positions
count the image rows, as the JAX FleetModel's do.

Bars (`tests/test_torch_model_parity.py`): fp32 logits within 1e-4,
greedy tokens equal; bf16 logits within 0.1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import transformer as JT
from repro.serving.engine import FleetModel as JFleetModel
from repro_torch import convert
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import FleetModel as TFleetModel

jax.config.update("jax_platform_name", "cpu")

ARCH = "llava-next-mistral-7b"
F32_TOL = 1e-4
BF16_TOL = 0.1
MAX_LEN = 48


def _models(dtype="float32", seed=0):
    cfg_j = j_reduced(ARCH, dtype=dtype)
    cfg_t = t_reduced(ARCH, dtype=dtype)
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    pt = TT.cast_params(cfg_t, convert.model_params_from_numpy(
        cfg_t, pj, device="cpu"))
    return cfg_j, pj, cfg_t, pt


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _images(cfg, b, seed=2):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_reduced_config_is_the_dense_stack_with_images():
    cfg = t_reduced(ARCH)
    assert cfg.arch_type == "vlm" and cfg.n_image_tokens == 8
    assert "vlm" in TT.FAMILIES and "vlm" not in TT.QUEUED
    gen = torch.Generator().manual_seed(0)
    p = TT.init_params(cfg, gen)
    assert len(p["blocks"]) == cfg.n_layers and "lm_head" in p
    cache = TT.init_cache(cfg, 2, 16)
    assert cache["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("with_images", [True, False])
def test_forward_without_cache_matches_jax(with_images):
    """The whole (B, N + S, V) panel with the image rows, and a forward
    of text alone (JAX takes img_embeds as optional)."""
    cfg_j, pj, cfg_t, pt = _models()
    toks = _tokens(cfg_j, 2, 13, seed=5)
    bj, kw = {"tokens": jnp.asarray(toks)}, {}
    if with_images:
        img = _images(cfg_j, 2)
        bj["img_embeds"] = jnp.asarray(img)
        kw["img_embeds"] = torch.tensor(img)
    lj = JT.forward(cfg_j, pj, bj)[0]
    lt, _ = TT.forward(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                       **kw)
    n = cfg_t.n_image_tokens if with_images else 0
    assert lt.shape == (2, n + 13, cfg_t.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)


def test_given_text_positions_follow_the_image_rows():
    """Text positions handed to forward are prefixed with 0..N-1 for the
    image rows, as JAX prefixes them."""
    cfg_j, pj, cfg_t, pt = _models()
    toks = _tokens(cfg_j, 2, 9, seed=3)
    img = _images(cfg_j, 2, seed=4)
    pos = np.broadcast_to(np.arange(9) + 20, (2, 9)).astype(np.int32)
    lj = JT.forward(cfg_j, pj, {"tokens": jnp.asarray(toks),
                                "img_embeds": jnp.asarray(img),
                                "positions": jnp.asarray(pos)})[0]
    lt, _ = TT.forward(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                       img_embeds=torch.tensor(img),
                       positions=torch.tensor(pos, dtype=torch.int64))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("s", [5, 11])
def test_prefill_and_decode_match_jax(s):
    cfg_j, pj, cfg_t, pt = _models()
    toks = _tokens(cfg_j, 3, s)
    img = _images(cfg_j, 3)
    n = cfg_t.n_image_tokens
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks),
                                    "img_embeds": jnp.asarray(img)},
                        MAX_LEN, cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32,
                        img_embeds=torch.tensor(img))
    assert lt.shape == (3, cfg_t.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)
    for i in range(5):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), n + s + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64),
                                n + s + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {i}")
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["kv"]["k"]),
                               rtol=F32_TOL, atol=F32_TOL)


def test_fleet_model_generate_tokens_equal_jax():
    cfg_j = j_reduced(ARCH, dtype="float32")
    cfg_t = t_reduced(ARCH, dtype="float32")
    jm = JFleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    toks = _tokens(cfg_j, 4, 14, seed=6)
    got = tm.generate(toks, 6)
    assert got.shape == (4, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 6))


def test_generate_fit_check_counts_the_image_rows():
    """S + n_image_tokens + max_new <= max_len + 1: the last fit
    generates (equal to JAX's tokens), one more token raises naming the
    image rows."""
    cfg_j = j_reduced(ARCH, dtype="float32")
    cfg_t = t_reduced(ARCH, dtype="float32")
    jm = JFleetModel(cfg_j, seed=5, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    s = 20
    room = MAX_LEN + 1 - s - cfg_t.n_image_tokens
    toks = _tokens(cfg_j, 2, s, seed=8)
    np.testing.assert_array_equal(tm.generate(toks, room),
                                  jm.generate(toks, room))
    with pytest.raises(ValueError, match="8 image rows"):
        tm.generate(toks, room + 1)


def test_bf16_logits_match_jax():
    cfg_j, pj, cfg_t, pt = _models(dtype="bfloat16")
    toks = _tokens(cfg_j, 2, 10, seed=7)
    img = _images(cfg_j, 2)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks),
                                    "img_embeds": jnp.asarray(img)},
                        MAX_LEN, cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32,
                        img_embeds=torch.tensor(img))
    assert lt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
    n = cfg_t.n_image_tokens
    lj, _ = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), n + 10)
    lt, _ = TT.decode_step(cfg_t, pt, ct,
                           torch.tensor(tok, dtype=torch.int64), n + 10)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_model_params_from_numpy_layout():
    cfg_j, pj, cfg_t, pt = _models()
    assert len(pt["blocks"]) == cfg_t.n_layers
    a = pt["blocks"][1]["attn"]
    d, h, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.hd
    assert a["wq"].shape == (d, h * hd)
    np.testing.assert_array_equal(
        a["wo"].numpy(),
        np.asarray(pj["blocks"]["attn"]["wo"][1]).reshape(h * hd, d))
    assert pt["lm_head"].shape == (d, cfg_t.vocab)
