"""deepseek-v3's multi-head latent attention against the JAX package, on
the CPU: `apply_mla` in its expanded form (without a cache, and a
prefill into a partly filled cache) and its absorbed form (one token
against a partly filled latent cache), then the reduced deepseek-v3
(MLA, first_k_dense 1, a MoE layer with its shared expert, mtp_depth 1)
through forward, prefill, decode_step and FleetModel, with the JAX
weights carried across by `convert.model_params_from_numpy`; its
multi-token-prediction head is carried (the training loss reads it:
`test_torch_training_grads_fleet10.py`), the served model holds none,
and the serving forward is shown not to read it.

Bars (`tests/test_torch_model_parity.py`): fp32 within 1e-4, greedy
tokens equal; bf16 logits within 0.1.
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

ARCH = "deepseek-v3-671b"
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


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL, **kw):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, **kw)


def test_mla_shapes():
    """The full-width MLA: 128 heads of query/key width 128 + 64 against
    a value width of 128, a latent of 512 and a rope key of 64 a
    position; the reduced one keeps MLA with first_k_dense 1."""
    full = t_config(ARCH)
    assert full.attn_kind == "mla" and full.n_heads == 128
    assert (full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim) == (192,
                                                                      128)
    assert (full.kv_lora_rank, full.qk_rope_dim) == (512, 64)
    red = t_reduced(ARCH)
    assert red.attn_kind == "mla" and red.first_k_dense == 1
    assert red.mtp_depth == 1 and red.layer_kinds() == ("attn", "moe")
    assert TT.rope_dim(red) == red.qk_rope_dim != red.hd


def test_params_layout_and_cache():
    """The MLA leaves as the JAX package's (wo flattened to (H dv, d)),
    and the cache: the latent and the rope key per layer, no K/V."""
    cfg_j, pj, cfg_t, pt = _models()
    a = pt["blocks"][1]["attn"]
    h, dv, d = cfg_t.n_heads, cfg_t.v_head_dim, cfg_t.d_model
    assert set(a) == set(pj["moe_blocks"]["attn"])
    assert a["wo"].shape == (h * dv, d)
    assert a["w_uk"].shape == (cfg_t.kv_lora_rank, h, cfg_t.qk_nope_dim)
    np.testing.assert_array_equal(
        a["w_uq"].numpy(), np.asarray(pj["moe_blocks"]["attn"]["w_uq"][0]))
    p = TT.init_params(cfg_t, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in p["blocks"][0]["attn"].items()} == \
        {k: v.shape for k, v in pt["blocks"][0]["attn"].items()}
    c = TT.init_cache(cfg_t, 3, MAX_LEN, torch.float32)
    assert set(c) == {"c_kv", "k_rope"}
    assert c["c_kv"].shape == (2, 3, MAX_LEN, cfg_t.kv_lora_rank)
    assert c["k_rope"].shape == (2, 3, MAX_LEN, cfg_t.qk_rope_dim)


def _layer_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return x


def test_apply_mla_expanded_without_cache_matches_jax():
    cfg_j, pj, cfg_t, pt = _models()
    pa_j = jax.tree.map(lambda a: a[0], pj["dense_blocks"]["attn"])
    pa_t = pt["blocks"][0]["attn"]
    b, s = 2, 9
    x = _layer_inputs(cfg_t, b, s, 3)
    pos = (np.arange(s)[None] + np.array([[0], [5]])).astype(np.int32)
    yj, _ = JL.apply_mla(cfg_j, pa_j, jnp.asarray(x), jnp.asarray(pos),
                         theta=cfg_j.rope_theta)
    yt = TL.apply_mla(cfg_t, pa_t, torch.tensor(x),
                      torch.tensor(pos, dtype=torch.int64),
                      theta=cfg_t.rope_theta)
    _close(yt, yj)


def test_apply_mla_both_forms_over_a_partly_filled_cache_match_jax():
    """Expanded: a prefill of 7 rows, then 4 more rows at index 7 (the
    multi-token form over a cache whose first rows hold the prefill's
    latents); absorbed: single tokens at 11 and 12. Each against JAX's
    output and cache."""
    cfg_j, pj, cfg_t, pt = _models()
    pa_j = jax.tree.map(lambda a: a[0], pj["moe_blocks"]["attn"])
    pa_t = pt["blocks"][1]["attn"]
    b, t = 2, 16
    x = _layer_inputs(cfg_t, b, 13, 4)
    pos = np.broadcast_to(np.arange(13), (b, 13)).astype(np.int32)
    cj = {"c_kv": jnp.zeros((b, t, cfg_j.kv_lora_rank)),
          "k_rope": jnp.zeros((b, t, cfg_j.qk_rope_dim))}
    ct = {"c_kv": torch.zeros((b, t, cfg_t.kv_lora_rank)),
          "k_rope": torch.zeros((b, t, cfg_t.qk_rope_dim))}
    for lo, hi in ((0, 7), (7, 11), (11, 12), (12, 13)):
        yj, cj = JL.apply_mla(cfg_j, pa_j, jnp.asarray(x[:, lo:hi]),
                              jnp.asarray(pos[:, lo:hi]),
                              theta=cfg_j.rope_theta, cache=cj,
                              cache_index=lo)
        yt = TL.apply_mla(cfg_t, pa_t, torch.tensor(x[:, lo:hi]),
                          torch.tensor(pos[:, lo:hi], dtype=torch.int64),
                          theta=cfg_t.rope_theta, cache=ct, cache_index=lo)
        _close(yt, yj, err_msg=f"rows {lo}..{hi}")
        _close(ct["c_kv"], cj["c_kv"])
        _close(ct["k_rope"], cj["k_rope"])


def test_absorbed_form_at_a_device_index_equals_the_int_index():
    _, _, cfg_t, pt = _models()
    pa = pt["blocks"][0]["attn"]
    x = torch.tensor(_layer_inputs(cfg_t, 2, 1, 5))
    rng = np.random.default_rng(6)
    cache = {"c_kv": torch.tensor(rng.normal(size=(2, 16, 32)),
                                  dtype=torch.float32),
             "k_rope": torch.tensor(rng.normal(size=(2, 16, 16)),
                                    dtype=torch.float32)}
    other = {k: v.clone() for k, v in cache.items()}
    pos = torch.full((2, 1), 9, dtype=torch.int64)
    y1 = TL.apply_mla(cfg_t, pa, x, pos, theta=cfg_t.rope_theta,
                      cache=cache, cache_index=9)
    y2 = TL.apply_mla(cfg_t, pa, x, pos, theta=cfg_t.rope_theta,
                      cache=other,
                      cache_index=torch.tensor([9], dtype=torch.int64))
    assert torch.equal(y1, y2)
    assert all(torch.equal(cache[k], other[k]) for k in cache)


def test_forward_without_cache_matches_jax():
    cfg_j, pj, cfg_t, pt = _models()
    toks = _tokens(cfg_j, 2, 13, seed=5)
    lj = JT.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)})[0]
    lt, _ = TT.forward(cfg_t, pt, torch.tensor(toks, dtype=torch.int64))
    _close(lt, lj)


def test_prefill_and_decode_match_jax():
    cfg_j, pj, cfg_t, pt = _models()
    toks = _tokens(cfg_j, 3, 11)
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                        cache_dtype=jnp.float32)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(toks, dtype=torch.int64),
                        MAX_LEN, cache_dtype=torch.float32)
    _close(lt, lj)
    for i in range(4):
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), 11 + i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64), 11 + i)
        _close(lt, lj, err_msg=f"step {i}")
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj, -1)))
    # the port's one (L, ...) stack: the JAX kv_dense then kv_moe
    for name in ("c_kv", "k_rope"):
        want = np.concatenate([np.asarray(cj["kv_dense"][name]),
                               np.asarray(cj["kv_moe"][name])])
        _close(ct[name], want)


def _nan_tree(tree):
    return {k: _nan_tree(v) if isinstance(v, dict)
            else torch.full(v.shape, float("nan")) for k, v in tree.items()}


def test_mtp_head_is_dropped_and_never_read():
    """The JAX pytree carries deepseek's multi-token-prediction head,
    which only its training loss reads. The converter carries it, equal
    to JAX's leaf by leaf (its block unstacked, wq/wo flattened as every
    block's); the served model drops it (`init_params` draws it only to
    train, FleetModel holds none); and a head of NaNs put into the
    port's parameters leaves the serving forward's logits as they were,
    as removing it leaves JAX's."""
    cfg_j, pj, cfg_t, pt = _models()
    assert "mtp" in pj and "mtp" in pt
    jm, tm = pj["mtp"], pt["mtp"]
    _close(tm["proj"], jm["proj"], tol=0)
    for name in ("norm_h", "norm_e"):
        _close(tm[name]["scale"], jm[name]["scale"], tol=0)
    for path, want in jax.tree_util.tree_leaves_with_path(jm["block"]):
        got = tm["block"]
        for key in path:
            got = got[key.key]
        _close(got, np.asarray(want, np.float32).reshape(got.shape), tol=0)
    assert "mtp" not in TT.init_params(cfg_t, torch.Generator().manual_seed(0))
    assert "mtp" not in TFleetModel(cfg_t, max_len=8, device="cpu").params
    toks = _tokens(cfg_j, 2, 9, seed=8)
    served = {k: v for k, v in pt.items() if k != "mtp"}
    lt, _ = TT.forward(cfg_t, served, torch.tensor(toks, dtype=torch.int64))
    d = cfg_t.d_model
    poisoned = dict(pt, mtp={"proj": torch.full((2 * d, d), float("nan")),
                             "block": _nan_tree(pt["blocks"][0]),
                             "norm_h": {"scale": torch.full((d,),
                                                            float("nan"))},
                             "norm_e": {"scale": torch.full((d,),
                                                            float("nan"))}})
    lp, _ = TT.forward(cfg_t, poisoned,
                       torch.tensor(toks, dtype=torch.int64))
    assert torch.equal(lp, lt)
    no_mtp = {k: v for k, v in pj.items() if k != "mtp"}
    lj = JT.forward(cfg_j, pj, {"tokens": jnp.asarray(toks)})[0]
    lj2 = JT.forward(cfg_j, no_mtp, {"tokens": jnp.asarray(toks)})[0]
    np.testing.assert_array_equal(np.asarray(lj), np.asarray(lj2))
    _close(lt, lj)


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


def test_bf16_logits_match_jax():
    cfg_j, pj, cfg_t, pt = _models(dtype="bfloat16")
    a = pt["blocks"][0]["attn"]
    assert a["w_uk"].dtype == a["kv_norm"].dtype == torch.bfloat16
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
