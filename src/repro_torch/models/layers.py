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

from repro_torch import sharding as SH
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
    before the second product, as in the JAX model. On DTensors it runs
    on each rank's batch rows and KV heads (`sharding.run_sharded`)."""
    if SH.is_dtensor(q):
        return _attend_sharded(q, k, v, q_pos, kv_pos, window, softcap,
                               causal)
    scores = _scores(q, k, q_pos, kv_pos, window, softcap, causal)
    w = torch.softmax(scores, dim=-1)
    return _weighted(w, v, q)


def _scores(q, k, q_pos, kv_pos, window, softcap, causal):
    """(B, Hk, rep, S, T) fp32 scores of the query block, masked."""
    b, s, h, hd = q.shape
    hk = k.shape[2]
    qg = _scale_q(q).reshape(b, s, hk, h // hk, hd)
    scores = torch.einsum("bskrd,btkd->bkrst", qg.float(), k.float())
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        m = (kv_pos[:, None, :] <= q_pos[:, :, None]) & \
            (kv_pos[:, None, :] > q_pos[:, :, None] - window)   # (B,S,T)
        scores = torch.where(m[:, None, None], scores,
                             torch.full_like(scores, _MASKED))
    return scores


def _weighted(w, v, q, dtype=None):
    """sum_t w v: the weights rounded to v's type, the product in fp32,
    the (B, S, H, dv) result in `dtype` (q's type when None)."""
    b, s, h = q.shape[:3]
    out = torch.einsum("bkrst,btkd->bskrd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(dtype or q.dtype)


#: the attention's logical axes at the JAX constraint points
HEADS = ("batch", "seq", "heads", "head_dim")


def _no_constrain(x, axes):
    return x


def _split_kv(q, k, v, q_pos, kv_pos, partial):
    """Attention over keys split along their rows (dim 1: a cache whose
    sequence `make_cache_specs` puts on "model"), flash-decoding style:
    each rank takes its batch rows with every query head, and its slice
    of the keys; `partial(q, k, v, q_pos, kv_pos)` gives its unnormalised
    fp32 output, row max and sum of exponentials (scores - max), which
    the ranks combine by a max and two sums over the mesh dims that split
    the keys. Returns the (B, S, H, dv) DTensor in q's type, batch rows
    split, heads whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k.device_mesh
    on = lambda t, d: [i for i, p in enumerate(t.placements)
                       if isinstance(p, Shard) and p.dim == d]
    bmesh, smesh = on(k, 0), on(k, 1)
    rows = [Shard(0) if i in bmesh else Replicate()
            for i in range(mesh.ndim)]
    keys = [Shard(1) if i in smesh else p for i, p in enumerate(rows)]
    bi, nb = SH.mesh_coord(mesh, bmesh)
    si, ns = SH.mesh_coord(mesh, smesh)

    def local(t, split_keys):
        if SH.is_dtensor(t):
            return SH.local_shard(t, mesh, keys if split_keys else rows)
        n = t.shape[0] // nb
        t = t.narrow(0, bi * n, n)
        if split_keys:
            n = t.shape[1] // ns
            t = t.narrow(1, si * n, n)
        return t

    out, mx, den = partial(local(q, False), local(k, True), local(v, True),
                           local(q_pos, False), local(kv_pos, True))
    groups = [mesh.get_group(i) for i in smesh]
    top = mx.detach().clone()
    for g in groups:
        torch.distributed.all_reduce(top, torch.distributed.ReduceOp.MAX,
                                     group=g)
    scale = torch.exp(mx.detach() - top)
    den = SH.sum_over(den * scale, groups)
    out = SH.sum_over(out * scale[..., None], groups) / den[..., None]
    return DTensor.from_local(out.to(q.dtype), mesh, rows)


def _attend_partial(window, softcap, causal):
    """`_split_kv`'s partial for `_attend_block`: out (B, S, H, dv), max
    and sum (B, S, H), fp32."""
    def partial(q, k, v, q_pos, kv_pos):
        b, s, h = q.shape[:3]
        scores = _scores(q, k, q_pos, kv_pos, window, softcap, causal)
        mx = scores.amax(-1, keepdim=True).detach()
        w = torch.exp(scores - mx)
        flat = lambda t: t[..., 0].permute(0, 3, 1, 2).reshape(b, s, h)
        return (_weighted(w, v, q, torch.float32), flat(mx),
                flat(w.sum(-1, keepdim=True)))
    return partial


def _attend_sharded(q, k, v, q_pos, kv_pos, window, softcap, causal):
    """`_attend_block` on DTensors. Keys split along their rows go through
    `_split_kv`; otherwise each rank takes its batch rows and its share
    of the query heads over "model" (`sharding.run_sharded`), the KV
    heads split alike where they divide the axis, else taken whole, each
    rank keeping the groups its query heads read."""
    from torch.distributed.tensor import Shard
    if SH.is_dtensor(k) and any(isinstance(p, Shard) and p.dim == 1
                                for p in k.placements):
        return _split_kv(q, k, v, q_pos, kv_pos,
                         _attend_partial(window, softcap, causal))
    h, hk = q.shape[2], k.shape[2]
    sizes = SH.axis_sizes(q.device_mesh)
    kv_split = "model" in sizes and hk % sizes["model"] == 0
    m = q.device_mesh.get_local_rank("model") if "model" in sizes else 0

    def local(q, k, v, q_pos, kv_pos):
        hl = q.shape[2]
        if k.shape[2] == hk and hl < h:       # the KV groups of my heads
            lo, hi = m * hl * hk // h, ((m + 1) * hl - 1) * hk // h + 1
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return _attend_block(q, k, v, q_pos, kv_pos, window, softcap,
                             causal)

    kv = (0, 2) if kv_split else (0, None)
    return SH.run_sharded(local, (q, k, v, q_pos, kv_pos),
                          ((0, 2), kv, kv, (0, None), (0, None)), (0, 2),
                          heads=h)


def _pad_rows(t, pad: int, value=0):
    """t with `pad` rows of `value` after its dim 1; a DTensor padded on
    its local shards, dim 1 whole (DTensor's own pad fails to plan its
    redistribution in torch 2.11)."""
    widths = (0, 0) * (t.ndim - 2) + (0, pad)
    if not SH.is_dtensor(t):
        return F.pad(t, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = t.device_mesh
    keep = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in t.placements]
    return DTensor.from_local(F.pad(SH.local_shard(t, mesh, keep), widths,
                                    value=value), mesh, keep)


def attend(q, k, v, q_pos, kv_pos, *, window=NO_WINDOW, softcap=0.0,
           causal=True, q_block: int = _Q_BLOCK, constrain=None):
    """Query-chunked attention: peak score memory (B,H,q_block,T) instead
    of (B,H,S,T). Padded query rows (position -1) are cut off.
    `constrain(x, axes)` pins the chunks' and the output's placement
    where the JAX `attend` does (the identity on plain tensors)."""
    c = constrain or _no_constrain
    b, s, h, hd = q.shape
    if s <= q_block:
        return _attend_block(q, k, v, q_pos, kv_pos, window, softcap, causal)
    pad = (-s) % q_block
    if pad:
        q = _pad_rows(q, pad)
        q_pos = _pad_rows(q_pos, pad, value=-1)
    nblk = q.shape[1] // q_block
    q_r = c(q.reshape(b, nblk, q_block, h, hd),
            ("batch", "seq", "seq", "heads", "head_dim"))
    outs = [c(_attend_block(q_r[:, j], k, v,
                            q_pos[:, j * q_block:(j + 1) * q_block], kv_pos,
                            window, softcap, causal), HEADS)
            for j in range(nblk)]
    return c(torch.cat(outs, dim=1), HEADS)[:, :s]


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


def write_rows(buf, new, index) -> None:
    """buf[:, index:index + n] = new, IN PLACE, for a cache buffer whose
    dim 1 holds its rows (positions or ring slots): `index` a Python int,
    or for one row a (1,) int64 device tensor (`index_copy_`, read on
    the device). A DTensor buffer (the dry-run's meshes, its rows maybe
    split over "model", `sharding.make_cache_specs`) is written on each
    rank's own shard (`_write_local`): DTensor has no in-place write of
    a slice of a sharded dim."""
    if SH.is_dtensor(buf):
        _write_local(buf, new, index)
    elif isinstance(index, torch.Tensor):
        buf.index_copy_(1, index, new.to(buf.dtype))
    else:
        buf[:, index:index + new.shape[1]] = new


def _write_local(buf, new, index) -> None:
    """`write_rows` on a DTensor: `new` redistributed whole along dim 1
    (as `buf` on the other dims), then each rank writes the rows that
    fall in its own shard's range [off, off + rows) into its local
    tensor -- for a device index, the one row where it owns it (a
    masked write of the row it holds there otherwise)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = buf.device_mesh
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in buf.placements]
    if SH.is_dtensor(new):
        new = new.redistribute(mesh, whole)
    else:
        new = distribute_tensor(new, mesh, whole)
    new, local = new.to_local().to(buf.dtype), buf.to_local()
    off, rows = 0, buf.shape[1]
    for i, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == 1:
            rows //= mesh.size(i)
            off += mesh.get_local_rank(i) * rows
    if isinstance(index, torch.Tensor):
        if SH.is_dtensor(index):          # held whole on every rank
            index = index.to_local()
        li = index - off
        owned = ((li >= 0) & (li < rows)).reshape(
            (1, 1) + (1,) * (new.ndim - 2))
        li = li.clamp(0, rows - 1)
        local.index_copy_(1, li, torch.where(
            owned, new, local.index_select(1, li)))
    else:
        lo, hi = max(index, off), min(index + new.shape[1], off + rows)
        if lo < hi:
            local[:, lo - off:hi - off] = new[:, lo - index:hi - index]


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
        for name, rows in (("k", k), ("v", v), ("pos", positions)):
            write_rows(cache[name], rows[:, -w:], 0)
        return True
    if isinstance(cache_index, torch.Tensor):
        if s != 1:
            raise ValueError(f"apply_attention: {s} new tokens at a device "
                             "index; it takes one")
        slot = torch.remainder(cache_index, w)
    else:
        slot = min(cache_index % w, w - s)
    for name, rows in (("k", k), ("v", v), ("pos", positions)):
        write_rows(cache[name], rows, slot)
    return False


def apply_attention(cfg: ModelConfig, params, x, positions, *, theta,
                    window=NO_WINDOW, cache=None, cache_index=0,
                    causal: bool = True, backend: str = "cuda",
                    tables=None, kv_len=None, rope: bool = True,
                    kv_source=None, precomputed_kv=None, constrain=None):
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
    `astype(q.dtype)`. `constrain`: the JAX constraint points' callback
    (the queries' heads, and the plain attend's).
    Returns (B,S,d)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    c = constrain or _no_constrain
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = c((x @ params["wq"]).view(b, s, h, hd), HEADS)
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
        if isinstance(cache_index, torch.Tensor) and not cross and s != 1:
            raise ValueError(f"apply_attention: {s} new tokens at a "
                             "device index; it takes one")
        lo = 0 if cross else cache_index
        write_rows(cache["k"], k, lo)
        write_rows(cache["v"], v, lo)

    if x.is_cuda and backend == "cuda":
        out = _attend_kernels(q, k, v, None if in_flight else cache,
                              0 if in_flight else cache_index, window,
                              causal, kv_len, cross)
    elif in_flight:
        out = attend(q, k, v, positions, positions, window=window,
                     causal=causal, constrain=constrain)
    elif cross:
        t = k.shape[1]
        kv_pos = torch.arange(t, device=x.device).expand(b, t)
        out = attend(q, k.to(q.dtype), v.to(q.dtype), positions, kv_pos,
                     causal=False, constrain=constrain)
    elif cache is None:
        out = attend(q, k, v, positions, positions, window=window,
                     causal=causal, constrain=constrain)
    else:
        t = cache["k"].shape[1]
        kv_pos = cache["pos"] if "pos" in cache else \
            torch.arange(t, device=x.device).expand(b, t)
        out = attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                     positions, kv_pos, window=window, causal=causal,
                     constrain=constrain)
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


def _expand(c, w):
    """The latents (B, T, r) expanded per head: einsum("btr,rhk->bthk").
    On DTensors, on each rank's rows of the latents (a cache's may be
    split over "model"), the weight whole: DTensor cannot flatten a split
    row dim into the product's rows."""
    if not SH.is_dtensor(c):
        return torch.einsum("btr,rhk->bthk", c, w)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = c.device_mesh
    keep = list(c.placements)
    local = torch.einsum("btr,rhk->bthk", SH.local_shard(c, mesh, keep),
                         SH.local_shard(w, mesh, [Replicate()] * mesh.ndim))
    return DTensor.from_local(local, mesh, keep)


def _mla_absorbed(q_nope, q_rope, c_use, r_use, w_uk, w_uv, positions,
                  kv_pos, scale):
    """The absorbed form: scores in the latent space, never the expanded
    cache. On DTensors the latents' rows are split (`_split_kv`)."""
    dt = q_nope.dtype
    if SH.is_dtensor(q_nope):
        # the latents split along their rows: each rank's share of the
        # latent output, combined (`_split_kv`), then W_uv on every rank
        q_lat = _dotf32("bshk,rhk->bshr", q_nope, w_uk).to(dt)
        r = c_use.shape[-1]

        def partial(q, kv, _, q_pos, kv_pos):
            scores = _mla_scores(q[..., :r], q[..., r:], kv[..., :r],
                                 kv[..., r:], q_pos, kv_pos, scale)
            mx = scores.amax(-1, keepdim=True).detach()
            w = torch.exp(scores - mx)
            flat = lambda t: t[..., 0].transpose(1, 2)
            return (_dotf32("bhst,btr->bshr", w.to(dt), kv[..., :r]),
                    flat(mx), flat(w.sum(-1, keepdim=True)))

        kv = torch.cat([c_use, r_use], dim=-1)
        o_lat = _split_kv(torch.cat([q_lat, q_rope], dim=-1), kv, kv,
                          positions, kv_pos, partial)
        return _dotf32("bshr,rhv->bshv", o_lat, w_uv).to(dt)
    q_lat = _dotf32("bshk,rhk->bshr", q_nope, w_uk).to(dt)
    w = torch.softmax(_mla_scores(q_lat, q_rope, c_use, r_use, positions,
                                  kv_pos, scale), dim=-1)
    o_lat = _dotf32("bhst,btr->bshr", w.to(dt), c_use)
    return _dotf32("bshr,rhv->bshv", o_lat.to(dt), w_uv).to(dt)


def _mla_scores(q_lat, q_rope, c_use, r_use, positions, kv_pos, scale):
    """(B, H, S, T) fp32 scores in the latent space, causally masked."""
    scores = (_dotf32("bshr,btr->bhst", q_lat, c_use)
              + _dotf32("bshk,btk->bhst", q_rope, r_use)) * scale
    mask = (kv_pos[:, None, :] <= positions[:, :, None])[:, None]
    return torch.where(mask, scores, torch.full_like(scores, _MASKED))


def apply_mla(cfg: ModelConfig, params, x, positions, *, theta,
              cache=None, cache_index=0, backend: str = "cuda",
              tables=None, constrain=None):
    """MLA. x: (B,S,d); positions: (B,S); tables: rope_tables(positions,
    qk_rope_dim, theta) when the caller has them. cache: None, or
    dict(c_kv (B,T,r_kv), k_rope (B,T,dr)) of one layer, into which this
    call writes its S new latents and rope keys at `cache_index` IN PLACE
    (a Python int, or for one token a (1,) int64 device tensor). One token
    with a cache takes the absorbed form, any other call the expanded one
    (module notes above). `constrain` as `apply_attention` takes it.
    Returns (B,S,d)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    c = constrain or _no_constrain
    p = params
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (dn + dr) ** -0.5
    if tables is None:
        tables = rope_tables(positions, dr, theta)

    cq = _mla_norm(x @ p["w_dq"], p["q_norm"])
    q = c(torch.einsum("bsr,rhk->bshk", cq, p["w_uq"]), HEADS)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, theta, tables)
    c_kv = _mla_norm(x @ p["w_dkv"], p["kv_norm"])
    k_r = apply_rope(x @ p["w_kr"], positions, theta, tables)

    if cache is not None:
        if isinstance(cache_index, torch.Tensor) and s != 1:
            raise ValueError(f"apply_mla: {s} new tokens at a device "
                             "index; it takes one")
        write_rows(cache["c_kv"], c_kv, cache_index)
        write_rows(cache["k_rope"], k_r, cache_index)
        t = cache["c_kv"].shape[1]
        kv_pos = torch.arange(t, device=x.device).expand(b, t)
        c_use = cache["c_kv"].to(x.dtype)
        r_use = cache["k_rope"].to(x.dtype)
    else:
        kv_pos = positions
        c_use, r_use = c_kv, k_r

    if s == 1 and cache is not None:
        out = _mla_absorbed(q_nope, q_rope, c_use, r_use, p["w_uk"],
                            p["w_uv"], positions, kv_pos, scale)
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
        k_nope = c(_expand(c_use, p["w_uk"]), HEADS)
        vv = c(_expand(c_use, p["w_uv"]), HEADS)
        k_full = c(torch.cat([k_nope, r_use[:, :, None, :].expand(
            b, t, h, dr)], dim=-1), HEADS)
        q_full = c(torch.cat([q_nope, q_rope], dim=-1), HEADS)
        if on_card:
            # q scaled in its own type first, as attend does
            out = flash_attention_cuda(_scale_q(q_full), k_full, vv,
                                       causal=True, scale=1.0)
        else:
            # attend scales by (dn + dr) ** -0.5, the width of q_full
            out = attend(q_full, k_full, vv, positions, kv_pos,
                         constrain=constrain)
    return out.reshape(b, s, -1) @ p["wo"]
