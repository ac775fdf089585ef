"""The port's attention against the JAX package, on the CPU: the plain
versions of the two attention kernels (`ref.flash_attention_ref`,
`ref.decode_attention_ref`, which the kernel wrappers take for CPU
tensors) against the TPU kernels run in interpret mode and against the
JAX oracles, and the model's plain `attend` against JAX `L.attend`.

Bars: the JAX suite's own (tests/test_kernels.py), 2e-3 in fp32 and 3e-2
in bf16 between the kernels and their oracle; the port's fp32 plain
versions compute the same formula as the JAX oracle, so they are held to
1e-5 against it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as JL
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import layers as TL

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
EXACT = 1e-5     # same formula, same fp32 arithmetic up to summation order


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounds to
    nearest even on both sides)."""
    x = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,hk,dh", [(1, 256, 4, 4, 64),
                                         (2, 256, 4, 2, 32),
                                         (1, 512, 8, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_tpu_kernel(b, s, h, hk, dh, dtype):
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (b, s, h, dh), dtype)
    kj, kt = _pair(rng, (b, s, hk, dh), dtype)
    vj, vt = _pair(rng, (b, s, hk, dh), dtype)
    kernel = flash_attention_pallas(qj, kj, vj, causal=True, block_q=128,
                                    block_k=128, interpret=True)
    oracle = JREF.flash_attention_ref(qj, kj, vj, causal=True)
    got = flash_attention_cuda(qt, kt, vt, causal=True)   # CPU: plain
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle),
                               rtol=EXACT if dtype == "float32" else tol,
                               atol=EXACT if dtype == "float32" else tol)


def test_flash_attention_sliding_window_matches_tpu_kernel():
    rng = np.random.default_rng(5)
    b, s, h, dh, w = 1, 512, 2, 64, 128
    qj, qt = _pair(rng, (b, s, h, dh), "float32")
    kj, kt = _pair(rng, (b, s, h, dh), "float32")
    vj, vt = _pair(rng, (b, s, h, dh), "float32")
    kernel = flash_attention_pallas(qj, kj, vj, causal=True, window=w,
                                    interpret=True)
    got = KOPS.flash_attention(qt, kt, vt, causal=True, window=w)
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=2e-3, atol=2e-3)
    ref = KOPS.flash_attention(qt, kt, vt, causal=True, window=w,
                               backend="reference")
    assert torch.equal(got, ref)


@pytest.mark.parametrize("b,t,h,hk,dh", [(2, 512, 4, 4, 64),
                                         (1, 1024, 8, 2, 128),
                                         (3, 256, 2, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_tpu_kernel(b, t, h, hk, dh, dtype):
    rng = np.random.default_rng(6)
    qj, qt = _pair(rng, (b, h, dh), dtype)
    kj, kt = _pair(rng, (b, t, hk, dh), dtype)
    vj, vt = _pair(rng, (b, t, hk, dh), dtype)
    lens = rng.integers(1, t, (b,))
    kernel = decode_attention_pallas(qj, kj, vj, jnp.asarray(lens, jnp.int32),
                                     block_k=256, interpret=True)
    oracle = JREF.decode_attention_ref(qj, kj, vj,
                                       jnp.asarray(lens, jnp.int32))
    got = decode_attention_cuda(qt, kt, vt,
                                torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle),
                               rtol=EXACT if dtype == "float32" else tol,
                               atol=EXACT if dtype == "float32" else tol)


def test_decode_matches_flash_last_row():
    """decode over a full cache == last row of prefill (the port's
    counterpart of the JAX suite's check on its kernels)."""
    rng = np.random.default_rng(7)
    b, s, h, dh = 1, 256, 4, 64
    _, q = _pair(rng, (b, s, h, dh), "float32")
    _, k = _pair(rng, (b, s, h, dh), "float32")
    _, v = _pair(rng, (b, s, h, dh), "float32")
    full = KOPS.flash_attention(q, k, v, causal=True)
    dec = KOPS.decode_attention(q[:, -1], k, v,
                                torch.full((b,), s, dtype=torch.int32))
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-3, atol=2e-3)


def test_ops_keep_the_tpu_kernels_block_contract():
    q = torch.zeros((1, 100, 2, 32))
    with pytest.raises(ValueError, match="multiple of 128"):
        KOPS.flash_attention(q, q, q)
    KOPS.flash_attention(q, q, q, backend="reference")  # the oracle takes any S
    with pytest.raises(ValueError, match="multiple of 256"):
        KOPS.decode_attention(q[:, 0], q, q, torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        KOPS.flash_attention(q, q, q, backend="pallas")


@pytest.mark.parametrize("b,s,t,h,hk,dh,offset", [
    (2, 16, 16, 4, 4, 32, 0),       # MHA prefill
    (2, 40, 64, 8, 2, 32, 0),       # GQA, keys past the queries masked
    (1, 600, 600, 4, 1, 32, 0),     # S > 512: JAX's query-block loop
    (3, 1, 64, 8, 2, 32, 23),       # one decode row
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_matches_jax(b, s, t, h, hk, dh, offset, dtype):
    rng = np.random.default_rng(s + t)
    qj, qt = _pair(rng, (b, s, h, dh), dtype)
    kj, kt = _pair(rng, (b, t, hk, dh), dtype)
    vj, vt = _pair(rng, (b, t, hk, dh), dtype)
    q_pos = np.broadcast_to(np.arange(s) + offset, (b, s)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    want = JL.attend(qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(kv_pos))
    got = TL.attend(qt, kt, vt, torch.tensor(q_pos, dtype=torch.int64),
                    torch.tensor(kv_pos, dtype=torch.int64))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    # fp32: the same formula; bf16: both round q*scale, the weights and
    # the output to bf16, and may land one bf16 step apart
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_attend_window_matches_jax():
    rng = np.random.default_rng(11)
    b, s, h, hk, dh, w = 2, 96, 4, 2, 32, 17
    qj, qt = _pair(rng, (b, s, h, dh), "float32")
    kj, kt = _pair(rng, (b, s, hk, dh), "float32")
    vj, vt = _pair(rng, (b, s, hk, dh), "float32")
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    want = JL.attend(qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos),
                     window=w)
    pt = torch.tensor(pos, dtype=torch.int64)
    got = TL.attend(qt, kt, vt, pt, pt, window=w)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,t,h,hk,dh", [
    (2, 11, 16, 4, 4, 32),          # the reduced whisper's cross shape
    (1, 40, 150, 8, 2, 64),         # GQA, keys outnumber queries
    (2, 600, 1500, 4, 4, 64),       # S > 512: JAX's query-block loop
    (1, 300, 77, 4, 4, 64),         # queries outnumber keys
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_cross_matches_jax_attend(b, s, t, h, hk, dh,
                                                        dtype):
    """Sq != Sk without the causal mask (whisper's cross-attention
    prefill): the flash wrapper's plain version, which CPU tensors take,
    against JAX `layers.attend`, the function JAX's cross-attention runs.
    fp32: the same formula up to where q is scaled (1e-5); bf16: JAX
    rounds q * scale and the weights to bf16 (3e-2, the bf16 bar)."""
    rng = np.random.default_rng(s * t)
    qj, qt = _pair(rng, (b, s, h, dh), dtype)
    kj, kt = _pair(rng, (b, t, hk, dh), dtype)
    vj, vt = _pair(rng, (b, t, hk, dh), dtype)
    q_pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    want = JL.attend(qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                     causal=False)
    got = flash_attention_cuda(qt, kt, vt, causal=False)   # CPU: plain
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = EXACT if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_noncausal_matches_tpu_kernel(dtype):
    """One S without the causal mask (whisper's encoder), against the TPU
    kernel in interpret mode (the JAX suite's bars) and its oracle."""
    rng = np.random.default_rng(8)
    b, s, h, hk, dh = 2, 256, 4, 4, 64
    qj, qt = _pair(rng, (b, s, h, dh), dtype)
    kj, kt = _pair(rng, (b, s, hk, dh), dtype)
    vj, vt = _pair(rng, (b, s, hk, dh), dtype)
    kernel = flash_attention_pallas(qj, kj, vj, causal=False, interpret=True)
    oracle = JREF.flash_attention_ref(qj, kj, vj, causal=False)
    got = KOPS.flash_attention(qt, kt, vt, causal=False)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle),
                               rtol=EXACT if dtype == "float32" else tol,
                               atol=EXACT if dtype == "float32" else tol)


def test_ops_keep_one_length_for_q_and_kv():
    """The separate key length is the model's (flash_attention_cuda),
    not the TPU kernel's contract, which `ops` keeps."""
    q = torch.zeros((1, 128, 2, 32))
    kv = torch.zeros((1, 256, 2, 32))
    with pytest.raises(ValueError, match="one length"):
        KOPS.flash_attention(q, kv, kv, causal=False)
    KOPS.flash_attention(q, kv, kv, causal=False, backend="reference")
