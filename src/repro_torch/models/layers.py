"""Transformer layers of the serving path: norms, RoPE, the gated MLP and
attention, as plain functions on tensors.

A port of the JAX package's `models/layers.py`: `apply_norm` (rmsnorm,
layernorm, non-parametric LayerNorm, eps 1e-6, in fp32),
`rms_norm_headwise`, split-half RoPE, `apply_mlp`, `attend` /
`_attend_block`, and `apply_attention` for self-attention with and without
a contiguous cache, bidirectional attention, and cross-attention
(`kv_source`, `precomputed_kv`, no RoPE). Parameters come in the port's
layout (`transformer.py`): projections as 2-D matrices, already in the
compute type.

On CUDA tensors `apply_attention` runs its attention through the
hand-written kernels:
  * causal prefill (cache_index 0: the S in-flight keys, no window) ->
    `flash_attention_cuda`;
  * bidirectional attention over the S in-flight keys (whisper's
    encoder) and cross-attention prefill over the source's S_kv keys ->
    `flash_attention_cuda` with causal=False;
  * one token against the cache -> `decode_attention_cuda` with
    kv_len = index + 1 (the index a Python int, or a (1,) int64 device
    tensor, which a captured CUDA graph reads at each replay);
  * one token against the cached cross K/V -> `decode_attention_cuda`
    with kv_len = every row;
and raises for any other case. On CPU tensors, or with
backend="reference", it runs the plain `attend` over the cache exactly as
the JAX package does: that is what the CPU tests hold against JAX, and
what the card's check holds the kernels against.
"""
from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.config import ModelConfig

NO_WINDOW = 1 << 30  # "disabled" sliding window
_Q_BLOCK = 512       # query-chunk size: caps score memory at (B,H,blk,T)
_MASKED = -1e30      # the plain path's masked score (finite, as in JAX)
BACKENDS = ("cuda", "reference")


def normal(gen: torch.Generator, shape, scale: float, dtype):
    """A parameter of N(0, scale^2) values in `dtype`, drawn on the
    generator's device (the JAX package's `jax.random.normal * scale`)."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(cfg: ModelConfig, params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(dt)
    if cfg.norm not in ("layernorm", "nonparam_ln"):
        raise ValueError(cfg.norm)
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


def rms_norm_headwise(x, scale, eps: float = 1e-6):
    """qk_norm (qwen3): RMS-norm over the head_dim of (..., H, hd)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_tables(positions, dim: int, theta: float):
    """(cos, sin) of the rotation angles, each (..., S, dim//2) fp32: one
    pair serves every layer of a forward pass."""
    freqs = rope_frequencies(dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return angles.cos(), angles.sin()


def apply_rope(x, positions, theta: float, tables=None):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S). `tables`:
    rope_tables(positions, hd, theta), when the caller has them."""
    cos, sin = tables if tables is not None else \
        rope_tables(positions, x.shape[-1], theta)
    if x.ndim == cos.ndim + 1:                          # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense (gated) MLP
# ---------------------------------------------------------------------------

def apply_mlp(cfg: ModelConfig, params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


# ---------------------------------------------------------------------------
# Attention: the plain version
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def rounded(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a Python number: multiplying a tensor of
    that type by it is the JAX model's product with `dtype.type(x)`, and
    unlike a device scalar it costs no host-to-device copy (a blocking
    copy per layer would stall the launch queue)."""
    return float(torch.tensor(x, dtype=dtype))


def _scale_q(q):
    """q * hd^-0.5 with the scale rounded to q's type first, as the JAX
    model does (`q.dtype.type(hd ** -0.5)`)."""
    return q * rounded(q.shape[-1] ** -0.5, q.dtype)


def _attend_block(q, k, v, q_pos, kv_pos, window, softcap, causal):
    """One query block. q: (B,S,H,hd)  k,v: (B,T,Hk,hd). Products in fp32
    on the inputs' values; the softmax weights are rounded to v's type
    before the second product, as in the JAX model."""
    b, s, h, hd = q.shape
    hk = k.shape[2]
    rep = h // hk
    qg = _scale_q(q).reshape(b, s, hk, rep, hd)
    scores = torch.einsum("bskrd,btkd->bkrst", qg.float(), k.float())
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        m = (kv_pos[:, None, :] <= q_pos[:, :, None]) & \
            (kv_pos[:, None, :] > q_pos[:, :, None] - window)   # (B,S,T)
        scores = torch.where(m[:, None, None], scores,
                             torch.full_like(scores, _MASKED))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def attend(q, k, v, q_pos, kv_pos, *, window=NO_WINDOW, softcap=0.0,
           causal=True, q_block: int = _Q_BLOCK):
    """Query-chunked attention: peak score memory (B,H,q_block,T) instead
    of (B,H,S,T). Padded query rows (position -1) are cut off."""
    s = q.shape[1]
    if s <= q_block:
        return _attend_block(q, k, v, q_pos, kv_pos, window, softcap, causal)
    pad = (-s) % q_block
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    outs = [_attend_block(q[:, i:i + q_block], k, v,
                          q_pos[:, i:i + q_block], kv_pos, window, softcap,
                          causal)
            for i in range(0, q.shape[1], q_block)]
    return torch.cat(outs, dim=1)[:, :s]


# ---------------------------------------------------------------------------
# Attention: projections, cache, and the kernel route
# ---------------------------------------------------------------------------

def _attend_kernels(q, k, v, cache, cache_index, window, causal,
                    kv_len, cross):
    """The cases the kernels cover (module docstring); anything else
    raises. `cross`: None (self-attention), "prefill" (k/v: the source's
    projections) or "decode" (k/v: the cached cross K/V). q is scaled in
    its own type first, as the plain path does, and the kernels get
    scale = 1.0."""
    b, s = q.shape[:2]
    if window != NO_WINDOW:
        raise NotImplementedError(
            "attention on CUDA: a sliding window does not run through the "
            "kernels; gemma3's local layers need a window over the full "
            "cache (ROADMAP §2.6, item 3: gemma3-12b)")
    qs = _scale_q(q)
    if cross == "decode":
        if s != 1:
            raise NotImplementedError(
                f"attention on CUDA: {s} new tokens against cached cross "
                "K/V; the decode kernel takes one")
        if kv_len is None:
            kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                                device=q.device)
        return decode_attention_cuda(qs[:, 0], k, v, kv_len,
                                     scale=1.0)[:, None]
    if cross == "prefill" or (not causal and cache is None):
        # every key is visible to every query: the source's frames, or
        # the S in-flight keys of an encoder
        return flash_attention_cuda(qs, k, v, causal=False, scale=1.0)
    if not causal:
        raise NotImplementedError(
            "attention on CUDA: bidirectional attention over a cache does "
            "not run through the kernels")
    on_device = isinstance(cache_index, torch.Tensor)
    if not on_device and cache_index == 0:
        # prefill: the S in-flight keys are all the keys there are
        if cache is not None and cache["k"].dtype not in (torch.float32,
                                                          q.dtype):
            # attend over the values the cache holds, as the plain path
            k, v = (x.to(cache["k"].dtype).to(q.dtype) for x in (k, v))
        return flash_attention_cuda(qs, k, v, causal=True, scale=1.0)
    if s == 1 and cache is not None:
        if kv_len is None:
            kv_len = (cache_index + 1).to(torch.int32).expand(b) \
                if on_device else torch.full((b,), cache_index + 1,
                                             dtype=torch.int32,
                                             device=q.device)
        return decode_attention_cuda(qs[:, 0], cache["k"], cache["v"],
                                     kv_len, scale=1.0)[:, None]
    raise NotImplementedError(
        f"attention on CUDA: {s} new tokens at cache index {cache_index}; "
        "the kernels cover a prefill from index 0 and a one-token decode")


def apply_attention(cfg: ModelConfig, params, x, positions, *, theta,
                    window=NO_WINDOW, cache=None, cache_index=0,
                    causal: bool = True, backend: str = "cuda",
                    tables=None, kv_len=None, rope: bool = True,
                    kv_source=None, precomputed_kv=None):
    """Attention. x: (B,S,d); positions: (B,S); tables: the rope_tables
    of `positions`, and kv_len: the (B,) int32 count of valid cache rows
    after this call's write (for cross-attention decode: of cross rows),
    when the caller has them (one tensor serves every layer). rope=False
    rotates neither q nor k (whisper's absolute positions).

    Self-attention: cache is None, or dict(k, v) of one layer's (B, T,
    Hk, hd) buffers, into which this call writes its S new keys and
    values at `cache_index` IN PLACE (the JAX function returns a new
    cache). `cache_index` is a Python int, or for one new token a (1,)
    int64 tensor on x's device (written with `index_copy_`, so the host
    never reads it).
    Cross-attention (non-causal, no RoPE, as in the JAX function):
    `kv_source` (B, T, d) gives the keys and values, written IN PLACE
    into `cache` (one layer's (B, T, Hk, hd) cross buffers) when it is
    given, as the JAX prefill caches what it returns; or
    `precomputed_kv` dict(k, v) holds them (decode), read in its stored
    type and rounded to the compute type, as the JAX function's
    `astype(q.dtype)`.
    Returns (B,S,d)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"]).view(b, s, h, hd)
    cross = "decode" if precomputed_kv is not None else \
        "prefill" if kv_source is not None else None
    if cross == "decode":
        k, v = precomputed_kv["k"], precomputed_kv["v"]
    else:
        src = x if kv_source is None else kv_source
        t = src.shape[1]
        k = (src @ params["wk"]).view(b, t, hk, hd)
        v = (src @ params["wv"]).view(b, t, hk, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_norm"])
        if cross != "decode":
            k = rms_norm_headwise(k, params["k_norm"])
    if rope and cross is None:
        tables = tables if tables is not None else \
            rope_tables(positions, hd, theta)
        q = apply_rope(q, positions, theta, tables)
        k = apply_rope(k, positions, theta, tables)
    if cache is not None:
        if cross == "decode":
            raise ValueError("apply_attention: precomputed_kv takes no "
                             "cache to write")
        if isinstance(cache_index, torch.Tensor) and not cross:
            if s != 1:
                raise ValueError(f"apply_attention: {s} new tokens at a "
                                 "device index; it takes one")
            cache["k"].index_copy_(1, cache_index, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, cache_index, v.to(cache["v"].dtype))
        else:
            lo = 0 if cross else cache_index
            cache["k"][:, lo:lo + k.shape[1]] = k
            cache["v"][:, lo:lo + k.shape[1]] = v

    if x.is_cuda and backend == "cuda":
        out = _attend_kernels(q, k, v, cache, cache_index, window, causal,
                              kv_len, cross)
    elif cross:
        t = k.shape[1]
        kv_pos = torch.arange(t, device=x.device).expand(b, t)
        out = attend(q, k.to(q.dtype), v.to(q.dtype), positions, kv_pos,
                     causal=False)
    elif cache is None:
        out = attend(q, k, v, positions, positions, window=window,
                     causal=causal)
    else:
        t = cache["k"].shape[1]
        kv_pos = torch.arange(t, device=x.device).expand(b, t)
        out = attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                     positions, kv_pos, window=window, causal=causal)
    return out.reshape(b, s, h * hd) @ params["wo"]
