"""The port's encoder-decoder (whisper-large-v3, reduced) against the JAX
package, on the CPU: the sinusoidal positions, the cross-attention layer
(prefill from a source, then decode over the stored K/V), the encoder,
prefill and decode_step of the whole model, and FleetModel.generate with
its zero stub of frame embeddings, with the JAX `init_params` weights
carried across by `convert.model_params_from_numpy`.

Bars: fp32 within 1e-4 (rtol and atol): the same arithmetic up to
summation order (the logits agree to ~2e-6); greedy tokens equal. bf16
logits within 0.1 of logits up to ~5 in size, as for the dense models
(tests/test_torch_model_parity.py); greedy tokens equal on these inputs.
"""
from functools import partial

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
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import FleetModel as TFleetModel

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
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


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def f32_models():
    return _models()


def test_sinusoidal_positions_match_jax():
    pos = (np.arange(9)[None] + np.array([[0], [1000]])).astype(np.int32)
    want = JT._sinusoidal_pos(jnp.asarray(pos), 128)
    got = TT._sinusoidal_pos(torch.tensor(pos, dtype=torch.int64), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cross_attention_layer_matches_jax(f32_models):
    """Prefill from a (B, F, d) source fills the port's cross cache in
    place with the K/V the JAX layer returns; decode over the stored K/V
    matches the JAX layer's `precomputed_kv` route."""
    cfg_j, pj, cfg_t, pt = f32_models
    pa_j = jax.tree.map(lambda a: a[1], pj["blocks"]["cross"])
    pa_t = pt["blocks"][1]["cross"]
    rng = np.random.default_rng(4)
    b, s, f = 2, 7, cfg_t.n_audio_frames
    x = rng.normal(size=(b, s + 1, cfg_t.d_model)).astype(np.float32)
    src = rng.normal(size=(b, f, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1), (b, s + 1)).astype(np.int32)
    tpos = torch.tensor(pos, dtype=torch.int64)
    kw = dict(theta=cfg_j.rope_theta, causal=False, rope=False)
    yj, cj = JL.apply_attention(cfg_j, pa_j, jnp.asarray(x[:, :s]),
                                jnp.asarray(pos[:, :s]),
                                kv_source=jnp.asarray(src), **kw)
    shape = (b, f, cfg_t.n_kv_heads, cfg_t.hd)
    ct = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    yt = TL.apply_attention(cfg_t, pa_t, torch.tensor(x[:, :s]),
                            tpos[:, :s], kv_source=torch.tensor(src),
                            cache=ct, **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   rtol=1e-5, atol=1e-5)
    yj, _ = JL.apply_attention(cfg_j, pa_j, jnp.asarray(x[:, s:]),
                               jnp.asarray(pos[:, s:]), precomputed_kv=cj,
                               **kw)
    yt = TL.apply_attention(cfg_t, pa_t, torch.tensor(x[:, s:]),
                            tpos[:, s:], precomputed_kv=ct, **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


def test_encoder_matches_jax(f32_models):
    cfg_j, pj, cfg_t, pt = f32_models
    emb = np.random.default_rng(5).normal(
        size=(2, cfg_t.n_audio_frames, cfg_t.d_model)).astype(np.float32)
    want = JT._encode(cfg_j, pj, jnp.asarray(emb), None,
                      lambda x, a: x, False)
    got = TT._encode(cfg_t, pt, torch.tensor(emb), backend="cuda")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    cfg_j, pj, cfg_t, pt = _models(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    b, s, f = 3, 11, cfg_t.n_audio_frames
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab, (b, s)).astype(np.int32)
    emb = rng.normal(size=(b, f, cfg_t.d_model)).astype(np.float32)
    j_decode = jax.jit(partial(JT.decode_step, cfg_j))
    lj, cj = jax.jit(partial(JT.prefill, cfg_j, max_len=MAX_LEN,
                             cache_dtype=jnp.float32))(
        pj, {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(emb)})
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32,
                        enc_embeds=torch.tensor(emb))
    assert lt.shape == (b, cfg_t.vocab)
    assert ct["cross"]["k"].shape == (cfg_t.n_layers, b, f,
                                      cfg_t.n_kv_heads, cfg_t.hd)
    np.testing.assert_allclose(ct["cross"]["v"].numpy(),
                               _np(cj["cross"]["v"]), rtol=tol, atol=tol)
    for i in range(5):
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol,
                                   err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(_np(lt).argmax(-1), tok)
        if i == 4:
            break
        lj, cj = j_decode(pj, cj, jnp.asarray(tok[:, None]), s + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok[:, None],
                                             dtype=torch.int64), s + i)
    np.testing.assert_allclose(ct["k"].numpy(), _np(cj["kv"]["k"]),
                               rtol=tol, atol=tol)


def test_decode_without_a_cache_raises(f32_models):
    cfg_t, pt = f32_models[2:]
    with pytest.raises(ValueError, match="enc_embeds"):
        TT.forward(cfg_t, pt, torch.zeros((1, 3), dtype=torch.int64))


def test_fleet_model_generate_tokens_equal_jax():
    cfg_j = j_reduced(ARCH, dtype="float32")
    cfg_t = t_reduced(ARCH, dtype="float32")
    jm = JFleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    toks = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (4, 14)).astype(np.int32)
    got = tm.generate(toks, 6)
    assert got.shape == (4, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 6))


def test_init_params_layout():
    cfg = t_reduced(ARCH)
    p = TT.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(p["enc_blocks"]) == cfg.n_enc_layers
    assert len(p["blocks"]) == cfg.n_layers and "lm_head" not in p
    blk = p["blocks"][0]
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    assert blk["cross"]["wq"].shape == (d, h * hd)
    assert set(blk["cross_norm"]) == {"scale", "bias"}    # layernorm
    assert "cross" not in p["enc_blocks"][0]
    TT.cast_params(cfg, p)
    assert blk["cross"]["wo"].dtype == torch.bfloat16
    assert p["enc_blocks"][1]["ffn"]["w_up"].dtype == torch.bfloat16
    assert p["enc_norm"]["scale"].dtype == torch.float32
