"""gemma3-12b's local:global stack against the JAX package, on the CPU: a
reduced gemma3 of 6 layers (5 local, 1 global) with a sliding window of
8, so the window bites at prompts of 16-24 tokens and at every decode
step, and one case at its full head width of 256. The JAX weights are
carried across by `convert.model_params_from_numpy`; the port's full
caches serve the local layers (JAX's path without `window_cache`).

Bars (`tests/test_torch_model_parity.py`): fp32 logits within 1e-4,
greedy tokens equal; bf16 logits within 0.1.
"""
import dataclasses

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

ARCH = "gemma3-12b"
WINDOW = 8
#: the reduced gemma3 (head_dim 32 by `reduced`), and at gemma3's own
#: head width
SHAPES = {"hd32": dict(n_layers=6, sliding_window=WINDOW),
          "hd256": dict(n_layers=6, sliding_window=WINDOW, head_dim=256)}
F32_TOL = 1e-4
BF16_TOL = 0.1
MAX_LEN = 48


def _models(shape, dtype="float32", seed=0):
    kw = SHAPES[shape]
    cfg_j = j_reduced(ARCH, dtype=dtype, **kw)
    cfg_t = t_reduced(ARCH, dtype=dtype, **kw)
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


def test_reduced_config_has_local_and_global_layers():
    cfg = t_reduced(ARCH, **SHAPES["hd32"])
    assert cfg.layer_kinds() == ("local",) * 5 + ("global",)
    assert cfg.hd == 32 and t_reduced(ARCH, **SHAPES["hd256"]).hd == 256


@pytest.mark.parametrize("shape", list(SHAPES))
def test_layer_schedules_match_jax(shape):
    """theta and window per layer: local layers 10k and the window,
    the global layer 1M and no window (JAX `_layer_schedules`)."""
    cfg_j = j_reduced(ARCH, **SHAPES[shape])
    cfg_t = t_reduced(ARCH, **SHAPES[shape])
    theta, window = JT._layer_schedules(cfg_j, cfg_j.layer_kinds())
    got = TT.layer_schedules(cfg_t)
    np.testing.assert_array_equal([th for th, _ in got], np.asarray(theta))
    np.testing.assert_array_equal([w for _, w in got], np.asarray(window))
    assert got[0] == (10_000.0, WINDOW)
    assert got[-1] == (1_000_000.0, TL.NO_WINDOW) == (
        1_000_000.0, JL.NO_WINDOW)


@pytest.mark.parametrize("hd", [32, 256])
def test_windowed_attention_layer_with_cache_matches_jax(hd):
    """A local layer's apply_attention over a full cache: a prefill of 20
    rows (the window of 8 bites), then 3 decode rows past it."""
    cfg_j, pj, cfg_t, pt = _models(f"hd{hd}")
    pa_j = jax.tree.map(lambda a: a[0], pj["blocks"]["attn"])
    pa_t = pt["blocks"][0]["attn"]
    rng = np.random.default_rng(4)
    b, s, t = 2, 20, 32
    x = rng.normal(size=(b, s + 3, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 3), (b, s + 3)).astype(np.int32)
    shape = (b, t, cfg_j.n_kv_heads, cfg_j.hd)
    cj = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    ct = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2), (s + 2, s + 3)):
        yj, cj = JL.apply_attention(cfg_j, pa_j, jnp.asarray(x[:, lo:hi]),
                                    jnp.asarray(pos[:, lo:hi]),
                                    theta=cfg_j.rope_theta, window=WINDOW,
                                    cache=cj, cache_index=lo)
        yt = TL.apply_attention(cfg_t, pa_t, torch.tensor(x[:, lo:hi]),
                                torch.tensor(pos[:, lo:hi],
                                             dtype=torch.int64),
                                theta=cfg_t.rope_theta, window=WINDOW,
                                cache=ct, cache_index=lo)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rows {lo}:{hi}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_without_cache_matches_jax(shape):
    cfg_j, pj, cfg_t, pt = _models(shape)
    toks = _tokens(cfg_j, 2, 21, seed=5)
    lj = JT.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)})[0]
    lt, _ = TT.forward(cfg_t, pt, torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("shape,s", [("hd32", 16), ("hd32", 24),
                                     ("hd256", 17)])
def test_prefill_and_decode_past_the_window_match_jax(shape, s):
    """Prefill of s > window tokens, then 10 decode steps: every step's
    window drops keys, the global layer keeps them all."""
    cfg_j, pj, cfg_t, pt = _models(shape)
    toks = _tokens(cfg_j, 3, s)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)
    for i in range(10):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), s + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64), s + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {i}")
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["kv"]["k"]),
                               rtol=F32_TOL, atol=F32_TOL)


def test_the_window_changes_the_logits():
    """The same weights with the window opened to the whole cache give
    other logits: the window is what the two packages agree on, not a
    no-op."""
    cfg_j, pj, cfg_t, pt = _models("hd32")
    toks = torch.tensor(_tokens(cfg_t, 2, 20), dtype=torch.int64)
    wide = dataclasses.replace(cfg_t, sliding_window=MAX_LEN)
    narrow = TT.forward(cfg_t, pt, toks)[0]
    full = TT.forward(wide, pt, toks)[0]
    assert float((narrow - full).abs().max()) > 100 * F32_TOL


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fleet_model_generate_tokens_equal_jax(shape):
    """generate decodes 12 tokens past prompts of 14: positions up to 25,
    three windows' worth."""
    cfg_j = j_reduced(ARCH, dtype="float32", **SHAPES[shape])
    cfg_t = t_reduced(ARCH, dtype="float32", **SHAPES[shape])
    jm = JFleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    toks = _tokens(cfg_j, 4, 14, seed=6)
    got = tm.generate(toks, 12)
    assert got.shape == (4, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 12))


def test_bf16_logits_match_jax():
    cfg_j, pj, cfg_t, pt = _models("hd32", dtype="bfloat16")
    toks = _tokens(cfg_j, 2, 18, seed=7)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    assert lt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
    lj, _ = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 18)
    lt, _ = TT.decode_step(cfg_t, pt, ct,
                           torch.tensor(tok, dtype=torch.int64), 18)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_ring_cache_stays_refused():
    """window_cache (the dry-run's ring caches for local layers) is not
    ported: it raises, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP §2.8"):
        TFleetModel(t_reduced(ARCH, window_cache=True), device="cpu")
