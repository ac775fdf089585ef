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

`apply_mla` is deepseek-v3's multi-head latent attention
(`init_mla` / `apply_mla` of the JAX module), in both its forms (below).

On CUDA tensors `apply_attention` runs its attention through the
hand-written kernels:
  * causal prefill (cache_index 0: the S in-flight keys, with the
    layer's sliding window if it has one) -> `flash_attention_cuda`;
  * bidirectional attention over the S in-flight keys (whisper's
    encoder) and cross-attention prefill over the source's S_kv keys ->
    `flash_attention_cuda` with causal=False;
  * one token against the cache -> `decode_attention_cuda` with
    kv_len = index + 1 (the index a Python int, or a (1,) int64 device
    tensor, which a captured CUDA graph reads at each replay), and the
    layer's window: gemma3's local layers keep the rows index - window <
    r <= index of the full cache;
  * one token against the cached cross K/V -> `decode_attention_cuda`
    with kv_len = every row;
  * a local layer's ring cache (`transformer.ring_cache`): a prefill of
    S >= W rows -> `flash_attention_cuda` over the S in-flight keys with
    the window, then the last W rows stored; a prefill of S < W rows ->
    as a full cache's; one token -> `decode_attention_cuda` over the W
    slots with kv_len = min(index + 1, W) and no window (the ring holds
    exactly the window's keys, and once it wraps a slot is not a
    position, so a window over slots would cut the wrong ones);
and raises for any other case (a window on cross-attention or
bidirectional attention among them: the JAX model sets none there). On
CPU tensors, or with
backend="reference", it runs the plain `attend` over the cache exactly as
the JAX package does: that is what the CPU tests hold against JAX, what
the card's check holds the kernels against, and what training
differentiates on the card (`transformer.TRAIN_ATTENTION`), as the JAX
train step differentiates the jnp `attend`: the kernels have no
backward, and their wrappers refuse inputs that require grad.
`apply_mla`'s expanded
form (a prefill from index 0, or a call without a cache) runs through
`flash_attention_cuda` with a query/key width of qk_nope + qk_rope (192)
against a value width of v_head (128); its absorbed form (one token
against the latent cache) is plain PyTorch on the card too, as it is jnp
in the JAX package (no TPU kernel computes it; ROADMAP §3.4).
"""
from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.config import ModelConfig

NO_WINDOW = 1 << 30  # "disabled" sliding window
RING_EMPTY = -(1 << 30)  # the position of a ring slot never written
_Q_BLOCK = 512       # query-chunk size: caps score memory at (B,H,blk,T)
_MASKED = -1e30      # the plain path's masked score (finite, as in JAX)
BACKENDS = ("cuda", "reference")


class MetaGenerator:
    """A stand-in for a generator on the meta device, which has none:
    `init_params(cfg, MetaGenerator())` builds the parameter tree's
    shapes and dtypes and draws nothing (the JAX dry-run's `eval_shape`
    of `init_params`), so deepseek-v3's 671 B parameters cost no
    memory."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype):
    """A parameter of N(0, scale^2) values in `dtype`, drawn on the
    generator's device (the JAX package's `jax.random.normal * scale`);
    on the meta device (`MetaGenerator`) its shape and dtype alone."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    # scaled in place: a draw holds one fp32 copy (an expert stack of
    # deepseek-v3 is 15 GB in fp32)
    return torch.randn(shape, generator=gen, device=gen.device).mul_(
        scale).to(dtype)


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
    win = 0 if window == NO_WINDOW else int(window)
    if win and (cross or not causal):
        raise NotImplementedError(
            "attention on CUDA: a sliding window runs through the kernels "
            "on causal self-attention only, not on cross-attention or "
            "bidirectional attention")
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
        return flash_attention_cuda(qs, k, v, causal=True, window=win,
                                    scale=1.0)
    if s == 1 and cache is not None:
        ring = "pos" in cache
        if kv_len is None:
            kv_len = (cache_index + 1).to(torch.int32).expand(b) \
                if on_device else torch.full((b,), cache_index + 1,
                                             dtype=torch.int32,
                                             device=q.device)
        if ring:        # the slots written: min(index + 1, W)
            kv_len = torch.clamp_max(kv_len, cache["k"].shape[1])
        return decode_attention_cuda(qs[:, 0], cache["k"], cache["v"],
                                     kv_len, scale=1.0,
                                     window=0 if ring else win)[:, None]
    raise NotImplementedError(
        f"attention on CUDA: {s} new tokens at cache index {cache_index}; "
        "the kernels cover a prefill from index 0 and a one-token decode")


def _ring_write(cache, k, v, positions, cache_index) -> bool:
    """Write S new keys, values and positions into a ring of W slots (one
    layer's {k, v of (B, W, Hk, hd), pos (B, W)}), IN PLACE, as the JAX
    ring branch does: S >= W (a prefill) stores the last W rows, slot p %
    W holding position p, which needs S % W == 0 (the JAX assertion);
    fewer rows go in from slot cache_index % W (on the device for a
    tensor index; JAX's `dynamic_update_slice` clamps the start to W - S).
    Returns whether the attention reads the S in-flight keys (S >= W)
    rather than the ring."""
    w, s = cache["k"].shape[1], k.shape[1]
    if s >= w:
        if s % w:
            raise ValueError(f"ring cache: a prefill of {s} rows into {w} "
                             "slots; it takes a whole number of rings")
        cache["k"].copy_(k[:, -w:])
        cache["v"].copy_(v[:, -w:])
        cache["pos"].copy_(positions[:, -w:])
        return True
    if isinstance(cache_index, torch.Tensor):
        if s != 1:
            raise ValueError(f"apply_attention: {s} new tokens at a device "
                             "index; it takes one")
        slot = torch.remainder(cache_index, w)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        cache["pos"].index_copy_(1, slot, positions.to(cache["pos"].dtype))
    else:
        lo = min(cache_index % w, w - s)
        cache["k"][:, lo:lo + s] = k
        cache["v"][:, lo:lo + s] = v
        cache["pos"][:, lo:lo + s] = positions
    return False


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
    never reads it). A cache that also holds "pos" (B, W) is a local
    layer's ring of W slots (`_ring_write`; the kernel route clamps
    kv_len to W): the plain path masks its keys by the positions `pos`
    holds, with the layer's window, as the JAX function does.
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
    in_flight = False       # a ring prefill: attend over k, v as given
    if cache is not None and "pos" in cache:
        if cross:
            raise ValueError("apply_attention: a ring cache is a local "
                             "layer's self-attention")
        in_flight = _ring_write(cache, k, v, positions, cache_index)
    elif cache is not None:
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
        out = _attend_kernels(q, k, v, None if in_flight else cache,
                              0 if in_flight else cache_index, window,
                              causal, kv_len, cross)
    elif in_flight:
        out = attend(q, k, v, positions, positions, window=window,
                     causal=causal)
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
        kv_pos = cache["pos"] if "pos" in cache else \
            torch.arange(t, device=x.device).expand(b, t)
        out = attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                     positions, kv_pos, window=window, causal=causal)
    return out.reshape(b, s, h * hd) @ params["wo"]


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------
# The cache holds the latent c_kv (kv_lora_rank) and the shared rope key
# k_rope (qk_rope_dim) of each position. Prefill runs the expanded form:
# K and V expanded from the latent per head, the attention of width
# qk_nope + qk_rope against a value width of v_head. A one-token decode
# runs the absorbed form: W_uk folded into the query and W_uv into the
# output, the scores taken in the latent space, so the cache is never
# expanded.

def init_mla(cfg: ModelConfig, gen: torch.Generator, dtype):
    """Random MLA parameters with the JAX package's shapes and scales:
    w_dq (d, r_q), q_norm (r_q,), w_uq (r_q, H, dn + dr), w_dkv (d, r_kv),
    kv_norm (r_kv,), w_kr (d, dr), w_uk (r_kv, H, dn), w_uv (r_kv, H,
    dv), and wo flattened to (H * dv, d) as the other attention's."""
    d, h = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ones = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    s = d ** -0.5
    return {
        "w_dq": normal(gen, (d, r_q), s, dtype),
        "q_norm": ones(r_q),
        "w_uq": normal(gen, (r_q, h, dn + dr), r_q ** -0.5, dtype),
        "w_dkv": normal(gen, (d, r_kv), s, dtype),
        "kv_norm": ones(r_kv),
        "w_kr": normal(gen, (d, dr), s, dtype),
        "w_uk": normal(gen, (r_kv, h, dn), r_kv ** -0.5, dtype),
        "w_uv": normal(gen, (r_kv, h, dv), r_kv ** -0.5, dtype),
        "wo": normal(gen, (h * dv, d), (h * dv) ** -0.5, dtype),
    }


def _mla_norm(x, scale, eps: float = 1e-6):
    """RMS norm of the latents, in fp32, as the JAX `_mla_norm`."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _dotf32(spec: str, a, b):
    """An einsum over fp32 copies of its operands: fp32 products and sums
    whatever their type (the JAX `_dotf32` on the CPU)."""
    return torch.einsum(spec, a.float(), b.float())


def apply_mla(cfg: ModelConfig, params, x, positions, *, theta,
              cache=None, cache_index=0, backend: str = "cuda",
              tables=None):
    """MLA. x: (B,S,d); positions: (B,S); tables: rope_tables(positions,
    qk_rope_dim, theta) when the caller has them. cache: None, or
    dict(c_kv (B,T,r_kv), k_rope (B,T,dr)) of one layer, into which this
    call writes its S new latents and rope keys at `cache_index` IN PLACE
    (a Python int, or for one token a (1,) int64 device tensor). One token
    with a cache takes the absorbed form, any other call the expanded one
    (module notes above). Returns (B,S,d)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    p = params
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (dn + dr) ** -0.5
    if tables is None:
        tables = rope_tables(positions, dr, theta)

    cq = _mla_norm(x @ p["w_dq"], p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, theta, tables)
    c_kv = _mla_norm(x @ p["w_dkv"], p["kv_norm"])
    k_r = apply_rope(x @ p["w_kr"], positions, theta, tables)

    if cache is not None:
        if isinstance(cache_index, torch.Tensor):
            if s != 1:
                raise ValueError(f"apply_mla: {s} new tokens at a device "
                                 "index; it takes one")
            cache["c_kv"].index_copy_(1, cache_index,
                                      c_kv.to(cache["c_kv"].dtype))
            cache["k_rope"].index_copy_(1, cache_index,
                                        k_r.to(cache["k_rope"].dtype))
        else:
            cache["c_kv"][:, cache_index:cache_index + s] = c_kv
            cache["k_rope"][:, cache_index:cache_index + s] = k_r
        t = cache["c_kv"].shape[1]
        kv_pos = torch.arange(t, device=x.device).expand(b, t)
        c_use = cache["c_kv"].to(x.dtype)
        r_use = cache["k_rope"].to(x.dtype)
    else:
        kv_pos = positions
        c_use, r_use = c_kv, k_r

    if s == 1 and cache is not None:
        # absorbed: scores in the latent space, never the expanded cache
        q_lat = _dotf32("bshk,rhk->bshr", q_nope, p["w_uk"]).to(x.dtype)
        scores = (_dotf32("bshr,btr->bhst", q_lat, c_use)
                  + _dotf32("bshk,btk->bhst", q_rope, r_use)) * scale
        mask = (kv_pos[:, None, :] <= positions[:, :, None])[:, None]
        scores = torch.where(mask, scores,
                             torch.full_like(scores, _MASKED))
        w = torch.softmax(scores, dim=-1)
        o_lat = _dotf32("bhst,btr->bshr", w.to(x.dtype), c_use)
        out = _dotf32("bshr,rhv->bshv", o_lat.to(x.dtype),
                      p["w_uv"]).to(x.dtype)
    else:
        on_card = x.is_cuda and backend == "cuda"
        if on_card and cache is not None:
            if isinstance(cache_index, torch.Tensor) or cache_index != 0:
                raise NotImplementedError(
                    f"MLA on CUDA: {s} new tokens at cache index "
                    f"{cache_index}; the kernels cover a prefill from "
                    "index 0 and a one-token decode")
            # the S in-flight rows are every key a causal prefill reads:
            # the rest of the cache is masked
            c_use, r_use = c_use[:, :s], r_use[:, :s]
        t = c_use.shape[1]
        k_nope = torch.einsum("btr,rhk->bthk", c_use, p["w_uk"])
        vv = torch.einsum("btr,rhv->bthv", c_use, p["w_uv"])
        k_full = torch.cat([k_nope, r_use[:, :, None, :].expand(
            b, t, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if on_card:
            # q scaled in its own type first, as attend does
            out = flash_attention_cuda(_scale_q(q_full), k_full, vv,
                                       causal=True, scale=1.0)
        else:
            # attend scales by (dn + dr) ** -0.5, the width of q_full
            out = attend(q_full, k_full, vv, positions, kv_pos)
    return out.reshape(b, s, -1) @ p["wo"]
