"""zamba2-7b's hybrid stack against the JAX package, on the CPU: the
reduced zamba2 at its registry config (6 layers, period 3: two groups of
two mamba2 blocks and the shared attention block, no tail) and with
`n_layers=8` (a tail of two mamba2 blocks), with the JAX weights carried
across by `convert.model_params_from_numpy` (the (G, per, ...) groups
split into per-group lists, the shared block taken once).

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
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import FleetModel as TFleetModel

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2-7b"
#: the registry's reduced zamba2 (no tail) and one with a tail of two
SHAPES = {"no_tail": {}, "tail": dict(n_layers=8)}
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


def test_hybrid_shapes():
    """The full-width zamba2 is 13 groups of 5 mamba2 blocks and the
    shared block, and 3 tail blocks: 68 mamba2 blocks, 32 heads of 112;
    the reduced ones 2 groups of 2 with a tail of 0 and 2."""
    full = t_config(ARCH)
    assert TT.hybrid_shape(full) == (13, 5, 3)
    assert full.layer_kinds().count("ssm") == 68 and full.hd == 112
    assert full.n_heads == full.n_kv_heads == 32
    assert TT.hybrid_shape(t_reduced(ARCH)) == (2, 2, 0)
    assert TT.hybrid_shape(t_reduced(ARCH, **SHAPES["tail"])) == (2, 2, 2)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_params_layout_and_the_shared_tie(shape):
    """groups[g][i] is the JAX (G, per, ...) leaf [g, i]; the shared
    block is one dict, the attention projections flattened; the tail a
    list; init_params makes the same layout, and init_cache one state
    row per mamba2 block and one KV buffer per group."""
    cfg_j, pj, cfg_t, pt = _models(shape)
    n_groups, per, tail = TT.hybrid_shape(cfg_t)
    assert "blocks" not in pt and "mtp" not in pt
    assert [len(g) for g in pt["groups"]] == [per] * n_groups
    assert len(pt["tail"]) == tail
    for g in range(n_groups):
        for i in range(per):
            np.testing.assert_array_equal(
                pt["groups"][g][i]["mamba"]["in_x"].numpy(),
                np.asarray(pj["groups"]["mamba"]["in_x"][g, i]))
    d, h, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.hd
    a = pt["shared_attn"]["attn"]
    assert a["wq"].shape == (d, h * hd) and a["wo"].shape == (h * hd, d)
    np.testing.assert_array_equal(
        a["wq"].numpy(),
        np.asarray(pj["shared_attn"]["attn"]["wq"]).reshape(d, h * hd))
    if tail:
        np.testing.assert_array_equal(
            pt["tail"][1]["mamba"]["out_proj"].numpy(),
            np.asarray(pj["tail"]["mamba"]["out_proj"][1]))
    p = TT.init_params(cfg_t, torch.Generator().manual_seed(0))
    assert [len(g) for g in p["groups"]] == [per] * n_groups
    assert len(p["tail"]) == tail and "attn" in p["shared_attn"]
    # the shared block counts once among the blocks
    assert sum(b is p["shared_attn"] for b in TT.all_blocks(p)) == 1
    c = TT.init_cache(cfg_t, 3, MAX_LEN, torch.float32)
    n_ssm = n_groups * per + tail
    assert c["ssm"]["ssm"].shape == (n_ssm, 3, cfg_t.ssm_nheads,
                                     cfg_t.ssm_head_dim, cfg_t.ssm_state)
    assert c["ssm"]["conv_x"].dtype == torch.float32
    assert c["attn"]["k"].shape == (n_groups, 3, MAX_LEN, cfg_t.n_kv_heads,
                                    hd)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_without_cache_matches_jax(shape):
    cfg_j, pj, cfg_t, pt = _models(shape)
    toks = _tokens(cfg_j, 2, 13, seed=5)
    lj = JT.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)})[0]
    lt, _ = TT.forward(cfg_t, pt, torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_prefill_and_decode_match_jax(shape):
    """Logits of the prefill and of four decode steps, and the states
    after them: every mamba2 block's (the JAX groups_ssm, then tail_ssm)
    and each group's K cache."""
    cfg_j, pj, cfg_t, pt = _models(shape)
    toks = _tokens(cfg_j, 3, 11)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                               atol=F32_TOL)
    for i in range(4):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 11 + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64), 11 + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj, -1)))
    n_groups, per, tail = TT.hybrid_shape(cfg_t)
    want = np.asarray(cj["groups_ssm"]["ssm"]).reshape(
        (n_groups * per,) + ct["ssm"]["ssm"].shape[1:])
    if tail:
        want = np.concatenate([want, np.asarray(cj["tail_ssm"]["ssm"])])
    np.testing.assert_allclose(ct["ssm"]["ssm"].numpy(), want, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(ct["attn"]["k"].numpy(),
                               np.asarray(cj["attn"]["k"]), rtol=F32_TOL,
                               atol=F32_TOL)


def test_decode_at_a_device_index_equals_the_int_index():
    """decode_step with its position as a (1,) int64 tensor (what a
    captured graph reads) gives the int index's logits and states bit
    for bit."""
    _, _, cfg_t, pt = _models("tail")
    toks = torch.tensor(_tokens(cfg_t, 2, 9), dtype=torch.int64)
    _, c1 = TT.prefill(cfg_t, pt, toks, MAX_LEN, cache_dtype=torch.float32)
    _, c2 = TT.prefill(cfg_t, pt, toks, MAX_LEN, cache_dtype=torch.float32)
    tok = toks[:, -1:]
    l1, _ = TT.decode_step(cfg_t, pt, c1, tok, 9)
    l2, _ = TT.decode_step(cfg_t, pt, c2, tok,
                           torch.tensor([9], dtype=torch.int64))
    assert torch.equal(l1, l2)
    for part in ("ssm", "attn"):
        for k in c1[part]:
            assert torch.equal(c1[part][k], c2[part][k]), (part, k)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fleet_model_generate_tokens_equal_jax(shape):
    cfg_j = j_reduced(ARCH, dtype="float32", **SHAPES[shape])
    cfg_t = t_reduced(ARCH, dtype="float32", **SHAPES[shape])
    jm = JFleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    toks = _tokens(cfg_j, 4, 14, seed=6)
    got = tm.generate(toks, 6)
    assert got.shape == (4, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jm.generate(toks, 6))
    # a second generate on the reused state starts from zeros again
    np.testing.assert_array_equal(tm.generate(toks, 6), got)


def test_bf16_logits_match_jax():
    cfg_j, pj, cfg_t, pt = _models("tail", dtype="bfloat16")
    assert pt["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert pt["groups"][0][0]["mamba"]["in_x"].dtype == torch.bfloat16
    toks = _tokens(cfg_j, 2, 10, seed=7)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
    lj, _ = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 10)
    lt, _ = TT.decode_step(cfg_t, pt, ct,
                           torch.tensor(tok, dtype=torch.int64), 10)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)
