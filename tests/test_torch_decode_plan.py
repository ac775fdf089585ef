"""The decode kernel's split plan (`decode_attention.split_plan`) on the
CPU: every cache row in exactly one split, the same plan on every call,
about `WAVES` waves of blocks on the H100 at the serving layouts, and the
kernel's combine at the plan's splits (each active split's running max,
sum and unnormalised accumulator, merged as the last split to arrive
merges them) against the JAX package's decode oracle.

Bar of the combine: 1e-5, the JAX suite's fp32 bar for one formula in
another summation order (`tests/test_torch_attention_parity.py`: EXACT).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import decode_attention as DA

jax.config.update("jax_platform_name", "cpu")

GRID_B = (1, 2, 8, 13, 16)
GRID_T = (1, 7, 33, 77, 128, 300, 1000, 1056, 1500, 2048, 8192)
GRID_HK = (1, 2, 8, 16, 20)
# (dh, bytes a cache value): the instances the kernel is built for
WIDTHS = [(32, 4), (64, 4), (112, 4), (128, 4), (256, 4), (32, 2), (64, 2),
          (112, 2), (128, 2), (256, 2)]
# the main path's layouts (B, T, Hk, dh, cache bytes): qwen3-8b, olmo-1b,
# whisper self and cross, phi3.5-moe, the bf16 8k row
LAYOUTS = {"qwen3-8b": (16, 2048, 8, 128, 4),
           "olmo-1b": (13, 1056, 16, 128, 4),
           "whisper self": (16, 1056, 20, 64, 4),
           "whisper cross": (16, 1500, 20, 64, 4),
           "phi3.5-moe": (16, 1056, 8, 128, 4),
           "bf16 8k": (8, 8192, 8, 128, 2),
           "internlm2-20b": (16, 1056, 8, 128, 4),
           "gemma3-12b": (16, 1056, 8, 256, 4),
           "llava-next-mistral-7b": (16, 3936, 8, 128, 4),
           "zamba2-7b": (16, 1056, 32, 112, 4),
           "gemma3-12b ring": (16, 1024, 8, 256, 4),
           "gemma3-12b long_500k local": (1, 1024, 8, 256, 2),
           "gemma3-12b long_500k global": (1, 524288, 8, 256, 2)}
EXACT = 1e-5


@pytest.mark.parametrize("dh,itemsize", WIDTHS)
def test_split_plan_takes_every_row_once(dh, itemsize):
    """Every cache row in one split, none empty, whole stages a split, and
    the same plan on every call: it depends on the shapes and the SM
    count alone, never on kv_len (it never sees one), so a captured graph
    stays valid."""
    rows = DA.stage_rows(dh, itemsize)
    for b, t, hk in itertools.product(GRID_B, GRID_T, GRID_HK):
        plan = DA.split_plan(b, t, hk, dh, itemsize)
        assert DA.split_plan(b, t, hk, dh, itemsize) == plan
        n_split, split_rows = plan
        assert n_split >= 1 and split_rows % rows == 0
        owners = np.zeros(t, np.int64)
        for s in range(n_split):
            lo, hi = s * split_rows, min((s + 1) * split_rows, t)
            assert lo < hi, (b, t, hk, plan)      # no split without rows
            owners[lo:hi] += 1
        assert (owners == 1).all(), (b, t, hk, plan)
        # no more splits than MIN_STAGES stages of rows each can make
        assert n_split <= max(1, -(-t // (DA.MIN_STAGES * rows)))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_plan_fills_the_card(layout):
    """At the main path's layouts: about WAVES waves of BLOCKS_PER_SM
    blocks on the H100's 132 SMs, or as many splits as MIN_STAGES allows."""
    b, t, hk, dh, size = LAYOUTS[layout]
    n_split, split_rows = DA.split_plan(b, t, hk, dh, size)
    rows = DA.stage_rows(dh, size)
    waves = b * hk * n_split / (DA.BLOCKS_PER_SM * DA.H100_SMS)
    capped = n_split == -(-t // (DA.MIN_STAGES * rows))
    assert capped or DA.WAVES / 2 <= waves <= DA.WAVES * 2, (n_split, waves)
    assert split_rows >= rows


def _combine(q, k, v, kv_len, split_rows, window=0):
    """The kernel's arithmetic at split granularity, in float64: each
    active split's (max, sum, accumulator) of exp2 over scores scaled by
    log2(e), merged by the last to arrive; kv_len = 0 gives zeros. With
    a window the active splits are those that hold a row of [lo,
    kv_len), lo = max(0, kv_len - window), each over its rows there."""
    b, h, dh = q.shape
    hk = k.shape[2]
    rep = h // hk
    scale2 = dh ** -0.5 * np.log2(np.e)
    out = np.zeros((b, h, dh))
    for bb, head in itertools.product(range(b), range(h)):
        length = int(kv_len[bb])
        lo = max(0, length - window) if window else 0
        s_lo = lo // split_rows
        n_active = -(-length // split_rows) - s_lo if length > 0 else 1
        parts = []
        for s in range(s_lo, s_lo + n_active):
            rows = slice(max(s * split_rows, lo),
                         min((s + 1) * split_rows, length))
            kk, vv = k[bb, rows, head // rep], v[bb, rows, head // rep]
            sc = kk @ q[bb, head] * scale2
            m = sc.max() if sc.size else -np.inf
            p = np.exp2(sc - m) if sc.size else sc
            parts.append((m, p.sum(), p @ vv))
        mx = max(m for m, _, _ in parts)
        if mx == -np.inf:
            continue
        f = [np.exp2(m - mx) for m, _, _ in parts]
        l_tot = sum(fi * l for fi, (_, l, _) in zip(f, parts))
        a_tot = sum(fi * a for fi, (_, _, a) in zip(f, parts))
        out[bb, head] = a_tot / max(l_tot, 1e-30)
    return out


@pytest.mark.parametrize("b,t,h,hk,dh", [(3, 300, 8, 2, 64),
                                         (2, 1056, 6, 1, 128),
                                         (4, 77, 4, 4, 32),
                                         (2, 600, 4, 4, 112),
                                         (2, 1056, 4, 2, 256),
                                         (3, 300, 16, 2, 256)])
def test_combine_at_the_plans_splits_matches_jax(b, t, h, hk, dh):
    rng = np.random.default_rng(t + h)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    # few SMs: several splits even at these small shapes
    n_split, split_rows = DA.split_plan(b, t, hk, dh, 4, sms=2)
    rows = DA.stage_rows(dh, 4)
    lens = [t, 1, rows - 1, rows + 1, split_rows - 1, split_rows,
            split_rows + 1, t - 1]
    for i in range(0, len(lens), b):
        kv = np.array([min(max(x, 1), t) for x in (lens[i:i + b] + [t] * b)
                       [:b]], np.int32)
        got = _combine(q.astype(np.float64), k.astype(np.float64),
                       v.astype(np.float64), kv, split_rows)
        want = np.asarray(JREF.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv)))
        np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    zero = _combine(q.astype(np.float64), k.astype(np.float64),
                    v.astype(np.float64), np.zeros(b, np.int32), split_rows)
    assert (zero == 0).all()


@pytest.mark.parametrize("window", [1, 100, 128, 129, 500])
@pytest.mark.parametrize("dh", [128, 256])
def test_windowed_combine_at_the_plans_splits_matches_jax(window, dh):
    """The kernel's windowed arithmetic: splits wholly before the
    window's first row take no part (they exit, and the arrival count
    and the merge start at the first split holding a row), the first
    active split starts mid-split; against JAX `layers.attend` over the
    full cache at the query position kv_len - 1."""
    from repro.models import layers as JL
    b, t, h, hk = 4, 1056, 8, 2
    rng = np.random.default_rng(window + dh)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    n_split, split_rows = DA.split_plan(b, t, hk, dh, 4)
    assert n_split >= 8     # windows that skip whole splits
    kv = np.array([t, 2 * split_rows + 3, split_rows, 5], np.int32)
    got = _combine(q.astype(np.float64), k.astype(np.float64),
                   v.astype(np.float64), kv, split_rows, window)
    kv_pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    want = np.asarray(JL.attend(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray((kv - 1)[:, None]), jnp.asarray(kv_pos),
        window=window))[:, 0]
    np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    plain = DA.decode_attention_cuda(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), torch.tensor(kv),
                                     window=window)
    np.testing.assert_allclose(plain.numpy(), want, rtol=EXACT, atol=EXACT)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_dh112_is_staged_as_dh128(itemsize):
    """dh = 112 is staged 128 wide (`csrc/decode_attention.cu:staged`):
    its stages hold the rows of dh = 128, so its plan is dh = 128's."""
    assert [DA.staged_width(d) for d in DA.HEAD_DIMS] == [32, 64, 128, 128,
                                                          256]
    assert DA.stage_rows(112, itemsize) == DA.stage_rows(128, itemsize)
    for b, t, hk in itertools.product(GRID_B, GRID_T, GRID_HK):
        assert DA.split_plan(b, t, hk, 112, itemsize) == \
            DA.split_plan(b, t, hk, 128, itemsize)


def test_cpu_wrapper_takes_the_plain_version():
    """A CPU tensor takes `ref.decode_attention_ref` (the wrapper plans
    nothing and allocates no counters there)."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(2, 8, 64)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(2, 100, 2, 64)), dtype=torch.float32)
    kv = torch.tensor([100, 3], dtype=torch.int32)
    got = DA.decode_attention_cuda(q, k, k, kv)
    want = np.asarray(JREF.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(k.numpy()), jnp.asarray(kv.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=EXACT, atol=EXACT)
    assert DA._ARRIVALS == {}


# decode's bar on the card (chip_smoke.py: DECODE_ATOL, DECODE_RTOL)
DECODE_ATOL, DECODE_RTOL = 1e-4, 2.0 ** -6


def _bf16(x):
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


def _mma256(q, k, v, kv_len, split_rows, stage, window=0):
    """The dh = 256 tensor-core path's arithmetic (`stream_mma256`), in
    float32: q and the cache rounded to bf16; per stage of `stage` rows,
    four partial scores over 64 columns each (one a warp), added in warp
    order; the stage's online softmax (exp2 of scores scaled by
    log2(e)); P split into bf16 hi + lo, both multiplied by V; the
    splits merged as `_combine` merges them."""
    b, h, dh = q.shape
    hk = k.shape[2]
    rep = h // hk
    scale2 = np.float32(dh ** -0.5 * np.log2(np.e))
    qb, kb, vb = _bf16(q), _bf16(k), _bf16(v)
    out = np.zeros((b, h, dh), np.float32)
    for bb, kh in itertools.product(range(b), range(hk)):
        length = int(kv_len[bb])
        lo = max(0, length - window) if window else 0
        s_lo = lo // split_rows
        n_active = -(-length // split_rows) - s_lo if length > 0 else 0
        heads = slice(kh * rep, (kh + 1) * rep)
        parts = []
        for sp in range(s_lo, s_lo + n_active):
            r0 = max(sp * split_rows, lo)
            r1 = min((sp + 1) * split_rows, length)
            m = np.full(rep, -np.inf, np.float32)
            l_run = np.zeros(rep, np.float32)
            o = np.zeros((rep, dh), np.float32)
            for a in range(r0, r1, stage):
                rows = slice(a, min(a + stage, r1))
                kk, vv = kb[bb, rows, kh], vb[bb, rows, kh]
                sc = np.zeros((rep, kk.shape[0]), np.float32)
                for w in range(4):
                    cols = slice(64 * w, 64 * w + 64)
                    sc += (qb[bb, heads, cols].astype(np.float64)
                           @ kk[:, cols].T.astype(np.float64)
                           ).astype(np.float32)
                sc = sc * scale2
                m_new = np.maximum(m, sc.max(axis=1))
                corr = np.exp2(m - m_new)
                p = np.exp2(sc - m_new[:, None]).astype(np.float32)
                hi = _bf16(p)
                lo_p = _bf16(p - hi)
                l_run = l_run * corr + p.sum(axis=1)
                o = o * corr[:, None] + (hi @ vv) + (lo_p @ vv)
                m = m_new
            parts.append((m, l_run, o))
        if not parts:
            continue
        mx = np.max([pm for pm, _, _ in parts], axis=0)
        f = [np.exp2(pm - mx) for pm, _, _ in parts]
        l_tot = sum(fi * pl for fi, (_, pl, _) in zip(f, parts))
        a_tot = sum(fi[:, None] * po for fi, (_, _, po) in zip(f, parts))
        out[bb, heads] = a_tot / np.maximum(l_tot, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("lens,window", [((1, 15, 16, 17), 0),
                                         ((31, 33, 300, 1056), 0),
                                         ((1056, 700, 129, 64), 100)])
def test_dh256_partial_scores_match_jax(itemsize, lens, window):
    """A check of the dh = 256 design's arithmetic, not of the kernel:
    `_mma256`, a numpy mirror of `stream_mma256`'s order of operations
    (every warp takes every row of a stage, 16 rows over an fp32 cache
    and 32 over a bf16 one; the stage's scores as four 64-column partial
    sums added in warp order, one softmax state a stage, P V in bf16 hi
    + lo), run at the port's own `split_plan` and `stage_rows`, against
    JAX's decode oracle over the bf16-rounded query and cache (the
    model's plain path rounds the cache to the query's type), within
    decode's bar. The CUDA kernel itself is held to its plain version by
    the `gpu` tests and chip_smoke.py."""
    from repro.models import layers as JL
    b, t, h, hk, dh = 4, 1056, 4, 2, 256
    rng = np.random.default_rng(sum(lens) + itemsize)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    kv = np.array(lens, np.int32)
    _, split_rows = DA.split_plan(b, t, hk, dh, itemsize, sms=4)
    stage = DA.stage_rows(dh, itemsize)
    assert stage == {4: 16, 2: 32}[itemsize]
    got = _mma256(q, k, v, kv, split_rows, stage, window)
    kv_pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    want = np.asarray(JL.attend(
        jnp.asarray(_bf16(q)[:, None]), jnp.asarray(_bf16(k)),
        jnp.asarray(_bf16(v)), jnp.asarray((kv - 1)[:, None]),
        jnp.asarray(kv_pos), window=window or JL.NO_WINDOW))[:, 0]
    err = np.abs(got - want)
    assert (err <= DECODE_ATOL + DECODE_RTOL * np.abs(want)).all(), \
        float((err / (DECODE_ATOL + DECODE_RTOL * np.abs(want))).max())
