"""gemma3-12b's local:global stack against the JAX package, on the CPU: a
reduced gemma3 of 6 layers (5 local, 1 global) with a sliding window of
8, so the window bites at prompts of 16-24 tokens and at every decode
step, and one case at its full head width of 256. The JAX weights are
carried across by `convert.model_params_from_numpy`; the port's full
caches serve the local layers (JAX's path without `window_cache`).

The ring caches of `window_cache` (the dry-run's option: a local layer
keeps W = min(window, max_len) slots, slot p % W holding position p)
against JAX's `_run_windowed_dense`: the setup of JAX's own
`test_windowed_ring_cache_matches_full_cache` (6 layers, 2 local to a
global, W = 4, a prompt of 8, steps 8-13 across the wrap), the rings'
K, V and positions, the port's full cache, and FleetModel on both.

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


# ---------------------------------------------------------------------------
# ring caches (window_cache)
# ---------------------------------------------------------------------------

#: JAX's test_windowed_ring_cache_matches_full_cache: 6 layers, two local
#: layers to a global one, a ring of W = 4 slots, caches of 16 rows
RING = dict(n_layers=6, local_global_ratio=2, sliding_window=4)
RING_LEN = 16


def _ring_models(dtype="float32", ring=True, seed=7):
    cfg_j = j_reduced(ARCH, dtype=dtype, window_cache=ring, **RING)
    cfg_t = t_reduced(ARCH, dtype=dtype, window_cache=ring, **RING)
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    pt = TT.cast_params(cfg_t, convert.model_params_from_numpy(
        cfg_t, pj, device="cpu"))
    return cfg_j, pj, cfg_t, pt


def _ring_state(cache):
    """The port's ring leaves as JAX lays them out: (G, R, B, W, ...)."""
    g, r = 2, 2
    return {k: v.float().numpy().reshape((g, r) + tuple(v.shape[1:]))
            if k != "pos" else v.numpy().reshape((g, r) + tuple(v.shape[1:]))
            for k, v in cache["kv_local"].items()}


def _run_ring(cfg_j, pj, cfg_t, pt, prompt, steps, cache_dt):
    """Prefill `prompt`, then greedy steps at `steps`, on both packages;
    yields (what, port logits, JAX logits, port cache, JAX cache)."""
    jdt = jnp.float32 if cache_dt == torch.float32 else jnp.bfloat16
    lj, cj = JT.prefill(cfg_j, pj, {"tokens": jnp.asarray(prompt)},
                        RING_LEN, cache_dtype=jdt)
    lt, ct = TT.prefill(cfg_t, pt, torch.tensor(prompt, dtype=torch.int64),
                        RING_LEN, cache_dtype=cache_dt)
    yield "prefill", lt, lj, ct, cj
    for i in steps:
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, cj = JT.decode_step(cfg_j, pj, cj, jnp.asarray(tok), i)
        lt, ct = TT.decode_step(cfg_t, pt, ct,
                                torch.tensor(tok, dtype=torch.int64), i)
        yield f"step {i}", lt, lj, ct, cj


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_ring_cache_matches_jax_across_the_wrap(dtype, tol):
    """JAX's own ring test's setup on both packages: the prefill of 8
    rows (two rings), then steps 8-13 (slot 0 takes position 8, the
    ring wraps again at 12)."""
    cfg_j, pj, cfg_t, pt = _ring_models(dtype)
    prompt = np.random.default_rng(7).integers(0, cfg_j.vocab, (1, 8)) \
        .astype(np.int32)
    cache_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    for what, lt, lj, _, _ in _run_ring(cfg_j, pj, cfg_t, pt, prompt,
                                         range(8, 14), cache_dt):
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol,
                                   err_msg=what)


def test_ring_state_matches_jax_after_the_prefill_and_the_wrap():
    """The rings' K, V and positions against JAX's (G, R, B, W, ...)
    leaves, and the global layers' full caches, after the prefill and
    after each step; the positions exactly, the slot p % W holding p."""
    cfg_j, pj, cfg_t, pt = _ring_models()
    prompt = np.random.default_rng(8).integers(0, cfg_j.vocab, (2, 8)) \
        .astype(np.int32)
    for what, _, _, ct, cj in _run_ring(cfg_j, pj, cfg_t, pt, prompt,
                                         range(8, 14), torch.float32):
        got = _ring_state(ct)
        np.testing.assert_array_equal(got["pos"],
                                      np.asarray(cj["kv_local"]["pos"]))
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k], np.asarray(cj["kv_local"][k]),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"{what} ring {k}")
            np.testing.assert_allclose(
                ct["kv_global"][k].numpy(), np.asarray(cj["kv_global"][k]),
                rtol=F32_TOL, atol=F32_TOL, err_msg=f"{what} global {k}")
    last = int(what.split()[-1])
    assert sorted(got["pos"][0, 0, 0]) == list(range(last - 3, last + 1))
    assert all(p % 4 == slot for slot, p in enumerate(got["pos"][0, 0, 0]))


@pytest.mark.parametrize("s,steps", [(8, range(8, 14)), (3, range(3, 12))])
def test_ring_matches_the_ports_full_cache(s, steps):
    """The ring against the port's own full cache on the same weights: a
    prefill of two rings (8 rows) or of less than one (3 rows, the ring's
    slots past it never written), then steps across the wrap."""
    _, _, cfg_t, pt = _ring_models()
    full = dataclasses.replace(cfg_t, window_cache=False)
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, cfg_t.vocab, (2, s)), dtype=torch.int64)
    lr, cr = TT.prefill(cfg_t, pt, toks, RING_LEN, cache_dtype=torch.float32)
    lf, cf = TT.prefill(full, pt, toks, RING_LEN, cache_dtype=torch.float32)
    assert set(cr) == {"kv_local", "kv_global"} and set(cf) == {"k", "v"}
    assert tuple(cr["kv_local"]["k"].shape[:3]) == (4, 2, 4)
    np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    for i in steps:
        tok = lf.argmax(-1)[:, None]
        lr, cr = TT.decode_step(cfg_t, pt, cr, tok, i)
        lf, cf = TT.decode_step(full, pt, cf, tok, i)
        np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {i}")
        assert torch.equal(lr.argmax(-1), lf.argmax(-1))


def test_ring_refuses_a_prefill_of_part_of_a_ring():
    """A prefill longer than the ring must fill whole rings (JAX asserts
    S % W == 0): 6 rows into 4 slots raise."""
    _, _, cfg_t, pt = _ring_models()
    toks = torch.zeros((1, 6), dtype=torch.int64)
    with pytest.raises(ValueError, match="whole number of rings"):
        TT.prefill(cfg_t, pt, toks, RING_LEN)
    TT.prefill(cfg_t, pt, toks[:, :4], RING_LEN)       # one whole ring


@pytest.mark.parametrize("given", [False, True], ids=["none", "kv_len"])
@pytest.mark.parametrize("on_device", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("index", [2, 3, 4, 9])
def test_ring_kernel_route_reads_the_written_slots(monkeypatch, index,
                                                   on_device, given):
    """The kernel route's view of a one-token decode (the decode kernel's
    wrapper recorded, so it runs here): a ring of W slots is read with
    kv_len = min(index + 1, W) and no window, whether the caller passes
    the rows written or not; a full cache with index + 1 and the
    layer's window."""
    calls = []

    def decode(q, k, v, kv_len, **kw):
        calls.append((kv_len.tolist(), kw["window"], k.shape[1]))
        return torch.zeros_like(q)

    monkeypatch.setattr(TL, "decode_attention_cuda", decode)
    b, h, hk, hd, w = 2, 4, 2, 8, 4
    q = torch.randn(b, 1, h, hd)
    idx = torch.tensor([index]) if on_device else index
    written = torch.full((b,), index + 1, dtype=torch.int32)
    for cache in ({"k": torch.zeros(b, w, hk, hd),
                   "v": torch.zeros(b, w, hk, hd),
                   "pos": torch.zeros(b, w, dtype=torch.int32)},
                  {"k": torch.zeros(b, 16, hk, hd),
                   "v": torch.zeros(b, 16, hk, hd)}):
        TL._attend_kernels(q, None, None, cache, idx, w, True,
                           written if given else None, None)
    assert calls == [([min(index + 1, w)] * b, 0, w),
                     ([index + 1] * b, w, 16)]


def test_ring_init_cache_matches_jax():
    """init_cache's ring tree: JAX's leaves with the (G, R) axes
    flattened, pos filled with -(1 << 30); W = min(window, max_len)."""
    cfg_j = j_reduced(ARCH, window_cache=True, **RING)
    cfg_t = t_reduced(ARCH, window_cache=True, **RING)
    for max_len in (RING_LEN, 3):
        cj = JT.init_cache(cfg_j, 2, max_len, jnp.bfloat16)
        ct = TT.init_cache(cfg_t, 2, max_len, device="cpu")
        for k in ("k", "v", "pos"):
            want = np.asarray(cj["kv_local"][k])
            got = ct["kv_local"][k]
            assert tuple(got.shape) == (4,) + want.shape[2:]
            np.testing.assert_array_equal(_np(got), want.reshape(
                got.shape).astype(np.float32))
        assert int(ct["kv_local"]["pos"][0, 0, 0]) == -(1 << 30) == \
            TL.RING_EMPTY
        for k in ("k", "v"):
            assert tuple(ct["kv_global"][k].shape) == \
                cj["kv_global"][k].shape


@pytest.mark.parametrize("s", [16, 6])
def test_ring_fleet_model_generate_tokens_equal_jax(s):
    """FleetModel with window_cache against JAX's on the same requests,
    the reduced gemma3 of 6 layers and a window of 8: prompts of two
    rings (16) and of less than one (6), 12 new tokens across the wrap;
    then a second, shorter request on the same static state (the ring's
    positions start again from a fresh cache's)."""
    cfg_j = j_reduced(ARCH, dtype="float32", window_cache=True,
                      **SHAPES["hd32"])
    cfg_t = t_reduced(ARCH, dtype="float32", window_cache=True,
                      **SHAPES["hd32"])
    jm = JFleetModel(cfg_j, seed=3, max_len=MAX_LEN)
    tm = TFleetModel(cfg_t, max_len=MAX_LEN, device="cpu",
                     params=convert.model_params_from_numpy(
                         cfg_t, jm.params, device="cpu"))
    assert "kv_local" in TT.init_cache(cfg_t, 1, MAX_LEN, device="cpu")
    for seed, (b, n) in ((6, (4, s)), (7, (2, 5))):
        toks = _tokens(cfg_j, b, n, seed=seed)
        got = tm.generate(toks, 12)
        np.testing.assert_array_equal(got, jm.generate(toks, 12))
    assert tm.rows == 4
