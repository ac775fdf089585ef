"""Model assembly for the serving path: parameters, the decode cache,
forward, prefill and decode_step.

A port of the JAX package's `models/transformer.py` for its six families:

  dense                   embed -> blocks(L) -> norm -> head; gemma3's
                          local:global stacks among them (local layers:
                          a sliding window over the full cache and rope
                          theta 10k; global layers: every key and 1M)
  vlm (llava)             the dense stack over stub image embeddings
                          prepended to the embedded text, positions
                          0..N-1 for the image rows, N.. for the text
  moe (phi3.5-moe,        embed -> blocks(L) -> norm -> head, each block's
  deepseek-v3)            FFN dense below first_k_dense and a mixture of
                          experts from there on (models/moe.py);
                          deepseek's attention is MLA (layers.apply_mla)
  ssm (mamba2)            embed -> ssm blocks(L) -> norm -> head
  hybrid (zamba2)         embed -> G groups of [(period - 1) ssm blocks +
                          the one weight-SHARED attention block] -> an ssm
                          tail -> norm -> head
  encdec (whisper)        enc blocks(Le, bidirectional) over stub frame
                          embeddings -> dec blocks(L) with
                          cross-attention; sinusoidal absolute positions
                          on both stacks, no RoPE

Where it differs:

  * each layer stack is a Python loop over a list of per-layer parameter
    dicts (the JAX package scans stacked (L, ...) leaves; its moe family
    keeps two stacks, dense_blocks and moe_blocks, which the port's one
    list holds in that order; the hybrid family's groups are a list of
    per-group lists, and its shared block one dict that every group
    applies);
  * the cache is preallocated and written IN PLACE by prefill and
    decode_step, which return it; the JAX functions return a new cache.
    Dense and moe: one (L, B, max_len, Hk, hd) buffer for K and one for
    V (the JAX moe cache splits it into kv_dense and kv_moe); with MLA
    c_kv (L, B, max_len, kv_lora_rank) and k_rope (L, B, max_len,
    qk_rope_dim) in their place.
    encdec: the same, and "cross": {k, v} of (L, B, n_audio_frames, Hk,
    hd), filled at prefill from the encoder's output. ssm: the JAX
    package's fp32 decode state, conv_x / conv_B / conv_C (L, B, k-1, C)
    and ssm (L, B, H, P, N). hybrid: "ssm", that state for every mamba2
    block in order (the groups' then the tail's: the JAX package's
    groups_ssm (G, per, ...) and tail_ssm stacked into one), and "attn":
    {k, v} of (G, B, max_len, Hk, hd), one buffer a group;
  * `cast_params` casts the parameters to the compute type once, at load,
    where the JAX layers cast at each use (`_cast`): the values are the
    same, and a decode step then reads the weights once in bf16 instead
    of reading fp32, writing bf16 and reading that again. The MoE router
    is not cast: the JAX package reads it in fp32.
    `init_params(..., cast=True)` casts each block as it is drawn, so a
    full-width model never exists in fp32 whole;
  * the serving calls never read what only training reads: forward
    returns the summed MoE auxiliary loss only when it is called with
    `train=True` (as `loss_fn` calls it); `init_params` draws
    deepseek-v3's multi-token-prediction head ("mtp") only with
    `train=True`, so a served model holds none; prefill computes the
    logits of the last position only (the JAX prefill keeps row -1 of
    the full (B, S, V) panel, the same row), while `loss_fn` takes the
    full panel;
  * training (`loss_fn`) casts the fp32 masters to the compute type at
    every call, on a copy of the tree (`compute_tree`), with
    `cast_params`' rules: the casts are differentiable, so the
    gradients reach the masters, which keep `cfg.param_dtype` as in the
    JAX package. With `cfg.remat` each block call of a training forward
    (an attention or mamba2 block, a hybrid group, an encoder block) is
    rematerialised by `torch.utils.checkpoint`, where the JAX stacks
    wrap their scanned bodies in `jax.checkpoint`.

With `window_cache` (the dry-run's option, `ring_cache`), a local:global
stack keeps ring caches for its local layers, as the JAX package's
`_run_windowed_dense` does: {"kv_local": {k, v of (G * R, B, W, Hk, hd),
pos (G * R, B, W) int32}, "kv_global": {k, v of (G, B, max_len, Hk,
hd)}}, the JAX (G, R) layer axes flattened into one and the batch on axis
1 (as every cache leaf of the port, so FleetModel's row views slice
them alike). W = min(sliding_window, max_len); slot p % W holds position
p, and `pos` says which position each slot holds (RING_EMPTY where none
has been written). The layers run in their stack's order, each on its
own buffer (`_layer_cache`).

decode_step takes its position as a Python int or as a (1,) int64
tensor on the device: the positions, the valid cache length and the
cache write are then computed on the device, so a CUDA graph captured
over one step serves every position (serving/engine.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as TR
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


#: the architecture families this port runs: every family of the JAX
#: package
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
#: the item of ROADMAP §2.6 each other family waits for: none is left
QUEUED: Dict[str, str] = {}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    run; it never falls back on another path."""
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported "
            f"(ROADMAP §2.6, {QUEUED.get(cfg.arch_type, 'not queued')})")


def ring_cache(cfg: ModelConfig) -> bool:
    """Whether the decode cache keeps ring caches for the local layers:
    `window_cache` on a dense or vlm local:global stack (where the JAX
    forward takes `_run_windowed_dense`)."""
    return bool(cfg.window_cache and cfg.local_global_ratio
                and cfg.sliding_window
                and cfg.arch_type in ("dense", "vlm"))


def ring_shape(cfg: ModelConfig, max_len: int):
    """(groups G, local layers a group R, ring slots W) of a ring cache:
    G groups of R local layers and one global layer, W = min(window,
    max_len)."""
    period = cfg.local_global_ratio + 1
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {period} (window_cache)")
    return (cfg.n_layers // period, period - 1,
            min(cfg.sliding_window, max_len))


def hybrid_shape(cfg: ModelConfig):
    """(groups, mamba2 blocks a group, tail blocks) of a hybrid stack: G =
    n_layers // period groups of period - 1 mamba2 blocks and the shared
    attention block, then the n_layers - G * period mamba2 blocks left."""
    n_groups = cfg.n_layers // cfg.hybrid_period
    return (n_groups, cfg.hybrid_period - 1,
            cfg.n_layers - n_groups * cfg.hybrid_period)


def rope_dim(cfg: ModelConfig) -> int:
    """The width RoPE rotates: MLA's rope key, else a head."""
    return cfg.qk_rope_dim if cfg.attn_kind == "mla" else cfg.hd


def layer_schedules(cfg: ModelConfig):
    """[(rope theta, window)] of each layer, as the JAX package's
    `_layer_schedules` computes them: gemma3's global layers take
    rope_theta_global, its local layers sliding_window; every other
    layer rope_theta and no window (layers.NO_WINDOW)."""
    return [(cfg.rope_theta_global if k == "global" and cfg.rope_theta_global
             else cfg.rope_theta,
             cfg.sliding_window if k == "local" and cfg.sliding_window
             else L.NO_WINDOW) for k in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, dtype, device) -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if cfg.norm == "nonparam_ln":   # OLMo: LayerNorm without affine params
        return {}
    raise ValueError(cfg.norm)


def _init_attention(cfg: ModelConfig, gen: torch.Generator,
                    dtype) -> Params:
    if cfg.attn_kind == "mla":
        return L.init_mla(cfg, gen, dtype)
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {
        "wq": L.normal(gen, (d, h * hd), d ** -0.5, dtype),
        "wk": L.normal(gen, (d, hk * hd), d ** -0.5, dtype),
        "wv": L.normal(gen, (d, hk * hd), d ** -0.5, dtype),
        "wo": L.normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        attn["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return attn


def _init_block(cfg: ModelConfig, gen: torch.Generator, dtype,
                cross: bool = False, moe: bool = False) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dev = gen.device
    p = {"attn_norm": _init_norm(cfg, dtype, dev),
         "mlp_norm": _init_norm(cfg, dtype, dev),
         "attn": _init_attention(cfg, gen, dtype)}
    if cross:
        p["cross_norm"] = _init_norm(cfg, dtype, dev)
        p["cross"] = _init_attention(cfg, gen, dtype)
    if moe:
        p["ffn"] = MOE.init_moe(cfg, gen, dtype)
    else:
        p["ffn"] = {"w_gate": L.normal(gen, (d, ff), d ** -0.5, dtype),
                    "w_up": L.normal(gen, (d, ff), d ** -0.5, dtype),
                    "w_down": L.normal(gen, (ff, d), ff ** -0.5, dtype)}
    return p


def _init_ssm_block(cfg: ModelConfig, gen: torch.Generator,
                    dtype) -> Params:
    return {"norm": _init_norm(cfg, dtype, gen.device),
            "mamba": SSM.init_mamba2(cfg, gen, dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                cast: bool = False, train: bool = False) -> Params:
    """Random parameters in `cfg.param_dtype` on the generator's device,
    with the JAX package's shapes and scales (its numbers differ: a
    torch.Generator is not a JAX key). With `cast`, each block and the
    embedding and head are cast as `cast_params` casts them as soon as
    they are drawn: the same values, and the peak stays one block above
    the model in the compute type.

    Layout: {"embed": (V, d), "final_norm", ["lm_head": (d, V)],
    "blocks": [per layer {"attn_norm", "mlp_norm", "attn": {"wq": (d,
    H*hd), "wk"/"wv": (d, Hk*hd), "wo": (H*hd, d), ["q_norm", "k_norm"]},
    "ffn": {"w_gate"/"w_up": (d, ff), "w_down": (ff, d)}}]}; a moe
    block's "ffn" from first_k_dense on is `moe.init_moe`'s dict, and
    with MLA its "attn" is `layers.init_mla`'s; encdec
    adds "cross_norm" and "cross" (an "attn" dict) to each decoder block,
    and "enc_blocks" (Le blocks as dense ones) and "enc_norm"; an ssm
    block is {"norm", "mamba": the JAX package's mamba2 dict}; hybrid has
    no "blocks" but "groups" (G lists of period - 1 ssm blocks),
    "shared_attn" (one dense block) and "tail" (ssm blocks). With
    `train` and `cfg.mtp_depth` it also draws the multi-token-prediction
    head, last, in `cfg.param_dtype` whatever `cast` says (a trainer's
    masters; `cast_params` casts it): "mtp" {"proj": (2d, d), "block": a
    dense block, "norm_h", "norm_e"}; only the training loss reads it."""
    check_supported(cfg)
    cfg.validate()
    dtype = torch_dtype(cfg.param_dtype)
    done = (lambda blk: _cast_block(cfg, blk)) if cast else (lambda blk: blk)
    p: Params = {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                         dtype),
        "final_norm": _init_norm(cfg, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, dtype)
    if cast:
        _cast_heads(cfg, p)
    if cfg.arch_type == "ssm":
        p["blocks"] = [done(_init_ssm_block(cfg, gen, dtype))
                       for _ in range(cfg.n_layers)]
    elif cfg.arch_type == "hybrid":
        n_groups, per, tail = hybrid_shape(cfg)
        p["groups"] = [[done(_init_ssm_block(cfg, gen, dtype))
                        for _ in range(per)] for _ in range(n_groups)]
        p["shared_attn"] = done(_init_block(cfg, gen, dtype))
        p["tail"] = [done(_init_ssm_block(cfg, gen, dtype))
                     for _ in range(tail)]
    elif cfg.arch_type == "encdec":
        p["enc_blocks"] = [done(_init_block(cfg, gen, dtype))
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = _init_norm(cfg, dtype, gen.device)
        p["blocks"] = [done(_init_block(cfg, gen, dtype, cross=True))
                       for _ in range(cfg.n_layers)]
    else:
        p["blocks"] = [done(_init_block(cfg, gen, dtype, moe=kind == "moe"))
                       for kind in cfg.layer_kinds()]
    if train and cfg.mtp_depth:
        d = cfg.d_model
        p["mtp"] = {"proj": L.normal(gen, (2 * d, d), (2 * d) ** -0.5, dtype),
                    "block": _init_block(cfg, gen, dtype),
                    "norm_h": _init_norm(cfg, dtype, gen.device),
                    "norm_e": _init_norm(cfg, dtype, gen.device)}
    return p


#: parameters that keep their type: the MoE router, which the JAX package
#: reads in fp32 (a bf16 router would change the experts chosen)
_KEEP = ("router",)


def _cast_tree(tree: Params, dt) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _cast_tree(leaf, dt)
        elif name not in _KEEP:
            tree[name] = leaf.to(dt)


def _cast_block(cfg: ModelConfig, blk: Params) -> Params:
    dt = torch_dtype(cfg.dtype)
    for group in ("attn", "cross", "ffn", "mamba"):
        if group in blk:
            _cast_tree(blk[group], dt)
    return blk


def _cast_heads(cfg: ModelConfig, params: Params) -> None:
    dt = torch_dtype(cfg.dtype)
    for name in ("embed", "lm_head"):
        if name in params:
            params[name] = params[name].to(dt)


def _cast_mtp(cfg: ModelConfig, mtp: Params) -> None:
    """The mtp head as the JAX loss casts it at use: the projection and
    the block; its two norms are read in fp32."""
    mtp["proj"] = mtp["proj"].to(torch_dtype(cfg.dtype))
    _cast_block(cfg, mtp["block"])


def all_blocks(params: Params):
    """Every block dict of a parameter tree, each once (the hybrid
    family's shared block too; not the mtp head's)."""
    blocks = params.get("blocks", []) + params.get("enc_blocks", [])
    for group in params.get("groups", []):
        blocks = blocks + group
    if "shared_attn" in params:
        blocks = blocks + [params["shared_attn"]]
    return blocks + params.get("tail", [])


def decay_flags(params: Params):
    """The tree of `params` with True where the JAX package's AdamW
    decays the leaf: where its leaf has two dimensions or more
    (`training/optim.py`). Every leaf of a layer stack (a list here:
    blocks, enc_blocks, groups, tail) has a layer axis in the JAX
    layout, so it is decayed whatever its rank here (norm scales,
    qk-norms, mamba2's A_log / D / dt_bias among them); the unstacked
    leaves (embed, lm_head, final_norm, enc_norm, shared_attn, mtp) keep
    the rank rule. The JAX attention projections are 3-D where the
    port's are 2-D: both decayed."""
    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, stacked) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, True) for v in tree]
        return stacked or tree.ndim >= 2
    return walk(params, False)


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """Cast, IN PLACE, every parameter the JAX layers cast to the compute
    type at use (embedding, head, the attention dicts with their qk-norm
    scales, the MLP, the MoE's experts with its shared experts, the
    mamba2 dict, the mtp head's projection and block) to that type,
    once. Norm parameters and the MoE router stay as they are: the norms
    and the router read them in fp32. Each old tensor is released as its
    cast replaces it, so the peak is one leaf above the larger copy."""
    _cast_heads(cfg, params)
    for blk in all_blocks(params):
        _cast_block(cfg, blk)
    if "mtp" in params:
        _cast_mtp(cfg, params["mtp"])
    return params


def compute_tree(cfg: ModelConfig, params: Params) -> Params:
    """`cast_params` on a copy of the tree's dicts and lists: the masters
    are not touched, and each cast (`Tensor.to`) is differentiable, so a
    loss over the copy sends its gradients to the masters. A leaf
    already in its type is shared, not copied."""
    return cast_params(cfg, TR.map_tree(lambda leaf: leaf, params))


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed decode state (module docstring). The ssm state is fp32
    whatever `dtype` says, as in the JAX package."""
    check_supported(cfg)
    zeros = lambda n, shape, dt=dtype: torch.zeros((n,) + shape, dtype=dt,
                                                   device=device)

    def ssm_state(n):
        gn, k, f32 = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_conv, \
            torch.float32
        return {"conv_x": zeros(n, (batch, k - 1, cfg.d_inner), f32),
                "conv_B": zeros(n, (batch, k - 1, gn), f32),
                "conv_C": zeros(n, (batch, k - 1, gn), f32),
                "ssm": zeros(n, (batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                                 cfg.ssm_state), f32)}

    def kv(n, rows):
        if cfg.attn_kind == "mla":      # the latent and the rope key
            return {"c_kv": zeros(n, (batch, rows, cfg.kv_lora_rank)),
                    "k_rope": zeros(n, (batch, rows, cfg.qk_rope_dim))}
        shape = (batch, rows, cfg.n_kv_heads, cfg.hd)
        return {"k": zeros(n, shape), "v": zeros(n, shape)}

    if cfg.arch_type == "ssm":
        return ssm_state(cfg.n_layers)
    if ring_cache(cfg):
        n_groups, per, w = ring_shape(cfg, max_len)
        local = kv(n_groups * per, w)
        local["pos"] = torch.full((n_groups * per, batch, w), L.RING_EMPTY,
                                  dtype=torch.int32, device=device)
        return {"kv_local": local, "kv_global": kv(n_groups, max_len)}
    if cfg.arch_type == "hybrid":
        n_groups, per, tail = hybrid_shape(cfg)
        return {"ssm": ssm_state(n_groups * per + tail),
                "attn": kv(n_groups, max_len)}
    cache = kv(cfg.n_layers, max_len)
    if cfg.arch_type == "encdec":
        cache["cross"] = kv(cfg.n_layers, cfg.n_audio_frames)
    return cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: Params, tokens):
    dt = torch_dtype(cfg.dtype)
    return params["embed"][tokens].to(dt) * L.rounded(cfg.d_model ** 0.5, dt)


def _logits(cfg: ModelConfig, params: Params, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _sinusoidal_pos(positions, d: int):
    """Absolute sinusoidal embedding computed from (B,S) positions, fp32
    (whisper has no RoPE)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() / torch.pow(10000.0, 2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _remat(cfg: ModelConfig, train: bool, fn, *args):
    """fn(*args), rematerialised in the backward pass when `cfg.remat`
    and `train` (the JAX package's `_maybe_ckpt`)."""
    if cfg.remat and train:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _encode(cfg: ModelConfig, params: Params, enc_embeds, backend: str,
            train: bool = False):
    """Whisper's encoder over stub frame embeddings (B, F, d): blocks of
    bidirectional self-attention without RoPE, then enc_norm."""
    x = enc_embeds.to(torch_dtype(cfg.dtype))
    b, f, _ = x.shape
    positions = torch.arange(f, device=x.device).expand(b, f)
    x = x + _sinusoidal_pos(positions, cfg.d_model).to(x.dtype)

    def block(x, blk):
        h = L.apply_norm(cfg, blk["attn_norm"], x)
        x = x + L.apply_attention(cfg, blk["attn"], h, positions,
                                  theta=cfg.rope_theta, causal=False,
                                  rope=False, backend=backend)
        h = L.apply_norm(cfg, blk["mlp_norm"], x)
        return x + L.apply_mlp(cfg, blk["ffn"], h)

    for blk in params["enc_blocks"]:
        x = _remat(cfg, train, block, x, blk)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _layer(cache, i: int):
    """Layer i's views of a cache tree of (L, ...) buffers."""
    return None if cache is None else {
        k: _layer(v, i) if isinstance(v, dict) else v[i]
        for k, v in cache.items()}


def _layer_cache(cfg: ModelConfig, cache, i: int):
    """Layer i's views of a cache: of a ring cache, its ring (a local
    layer) or its full buffer (a global one)."""
    if cache is None or "kv_local" not in cache:
        return _layer(cache, i)
    period = cfg.local_global_ratio + 1
    g, j = divmod(i, period)
    if j == period - 1:
        return _layer(cache["kv_global"], g)
    return _layer(cache["kv_local"], g * (period - 1) + j)


def _self_attention(cfg: ModelConfig, blk: Params, x, positions, *, theta,
                    window, cache, cache_index, backend, tables, kv_len,
                    rope=True):
    """x + the block's self-attention (MLA where the config says so)."""
    h = L.apply_norm(cfg, blk["attn_norm"], x)
    if cfg.attn_kind == "mla":
        return x + L.apply_mla(cfg, blk["attn"], h, positions, theta=theta,
                               cache=cache, cache_index=cache_index,
                               backend=backend, tables=tables)
    return x + L.apply_attention(
        cfg, blk["attn"], h, positions, theta=theta, window=window,
        cache=cache, cache_index=cache_index, backend=backend,
        tables=tables, kv_len=kv_len, rope=rope)


def _ffn(cfg: ModelConfig, blk: Params, x, moe: bool = False):
    """(x + the block's FFN, the MoE's fp32 aux loss or None): its gated
    MLP, or its mixture of experts."""
    h = L.apply_norm(cfg, blk["mlp_norm"], x)
    if moe:
        y, aux = MOE.apply_moe(cfg, blk["ffn"], h)
        return x + y, aux
    return x + L.apply_mlp(cfg, blk["ffn"], h), None


def _ssm_block(cfg: ModelConfig, blk: Params, x, cache):
    h = L.apply_norm(cfg, blk["norm"], x)
    return x + SSM.apply_mamba2(cfg, blk["mamba"], h, cache=cache)[0]


def _run_hybrid(cfg: ModelConfig, params: Params, x, positions, cache,
                cache_index, backend: str, kv_len, train: bool = False):
    """The JAX `_run_hybrid`: each group's mamba2 blocks, then the shared
    block (its one set of weights, at rope_theta, no window) over that
    group's KV buffer; then the tail's mamba2 blocks. Rematerialised as
    the JAX stacks are: each group, and each mamba2 block within it."""
    ssm = None if cache is None else cache["ssm"]
    tables = L.rope_tables(positions, cfg.hd, cfg.rope_theta)
    shared = params["shared_attn"]
    ssm_block = lambda x, blk, i: _ssm_block(cfg, blk, x, _layer(ssm, i))

    def group(x, g, blocks, first):
        for i, blk in enumerate(blocks, first):
            x = _remat(cfg, train, ssm_block, x, blk, i)
        x = _self_attention(
            cfg, shared, x, positions, theta=cfg.rope_theta,
            window=L.NO_WINDOW,
            cache=None if cache is None else _layer(cache["attn"], g),
            cache_index=cache_index, backend=backend, tables=tables,
            kv_len=kv_len)
        return _ffn(cfg, shared, x)[0]

    i = 0                   # the mamba2 block's row of the state stack
    for g, blocks in enumerate(params["groups"]):
        x = _remat(cfg, train, group, x, g, blocks, i)
        i += len(blocks)
    for blk in params["tail"]:
        x = _remat(cfg, train, ssm_block, x, blk, i)
        i += 1
    return x


def forward(cfg: ModelConfig, params: Params, tokens, *, positions=None,
            cache: Optional[Dict[str, Any]] = None,
            cache_index=0, backend: str = "cuda",
            last_only: bool = False, enc_embeds=None, img_embeds=None,
            train: bool = False):
    """tokens: (B, S) -> (logits (B, S or 1, V), hidden (B, S or 1, d)),
    and with `train` -> (logits, hidden, aux): aux the fp32 sum of the
    MoE layers' auxiliary losses (0.0 without MoE layers), and each
    block rematerialised in the backward pass where `cfg.remat` says so.

    With a cache, the S new keys and values (ssm: the state after the S
    tokens) are written into it at `cache_index`, in place: a Python
    int, or for one token a (1,) int64 device tensor. encdec takes
    `enc_embeds` (B, F, d), runs the encoder and, with a cache, stores
    each decoder layer's cross K/V in it; without `enc_embeds` it reads
    them from the cache (decode). vlm takes `img_embeds` (B, N, d),
    cast to the compute type and put before the embedded text (the
    sqrt(d) scale is the text's alone); the image rows take positions
    0..N-1 and given text `positions` follow them (the JAX forward's
    concatenation), so the S new rows are N + S_text. `last_only` runs
    the final norm and the head on the last position alone. `backend`
    selects the attention route on CUDA tensors
    (layers.apply_attention)."""
    check_supported(cfg)
    at = cfg.arch_type
    b, s_tok = tokens.shape
    x = _embed(cfg, params, tokens)
    if at == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    elif s != s_tok:
        positions = torch.cat([torch.arange(
            s - s_tok, dtype=positions.dtype,
            device=x.device).expand(b, s - s_tok), positions], dim=1)
    # the valid cache rows after this call's write, once for every
    # attention layer
    if cache is None or at == "ssm":
        kv_len = None
    elif isinstance(cache_index, torch.Tensor):
        kv_len = (cache_index + s).to(torch.int32).expand(b).contiguous()
    else:
        kv_len = torch.full((b,), cache_index + s, dtype=torch.int32,
                            device=x.device)
    aux = []
    if at == "ssm":
        ssm_block = lambda x, blk, i: _ssm_block(cfg, blk, x,
                                                 _layer(cache, i))
        for i, blk in enumerate(params["blocks"]):
            x = _remat(cfg, train, ssm_block, x, blk, i)
    elif at == "hybrid":
        x = _run_hybrid(cfg, params, x, positions, cache, cache_index,
                        backend, kv_len, train)
    else:
        enc_out = cross_len = None
        schedule = layer_schedules(cfg)
        tables = {}
        if at == "encdec":
            x = x + _sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
            if enc_embeds is not None:
                enc_out = _encode(cfg, params, enc_embeds, backend, train)
            elif cache is None:
                raise ValueError(f"{cfg.name}: forward needs enc_embeds or "
                                 "a cache holding the cross K/V")
            else:
                cross_len = torch.full((b,), cfg.n_audio_frames,
                                       dtype=torch.int32, device=x.device)
        else:
            # one table per distinct theta, for every layer that takes it
            tables = {th: L.rope_tables(positions, rope_dim(cfg), th)
                      for th in sorted({th for th, _ in schedule})}
        moe = [kind == "moe" for kind in cfg.layer_kinds()]

        def layer(x, blk, i):
            c = _layer_cache(cfg, cache, i)
            theta, window = schedule[i]
            x = _self_attention(
                cfg, blk, x, positions, theta=theta, window=window,
                cache=c, cache_index=cache_index, backend=backend,
                tables=tables.get(theta),
                kv_len=kv_len, rope=at != "encdec")
            if at == "encdec":
                h = L.apply_norm(cfg, blk["cross_norm"], x)
                cc = None if c is None else c["cross"]
                if enc_out is not None:   # prefill: compute, then store
                    kw = dict(kv_source=enc_out, cache=cc)
                else:                     # decode: read the stored K/V
                    kw = dict(precomputed_kv=cc, kv_len=cross_len)
                x = x + L.apply_attention(
                    cfg, blk["cross"], h, positions, theta=cfg.rope_theta,
                    causal=False, backend=backend, rope=False, **kw)
            return _ffn(cfg, blk, x, moe[i])

        for i, blk in enumerate(params["blocks"]):
            x, a = _remat(cfg, train, layer, x, blk, i)
            if a is not None:
                aux.append(a)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(cfg, params["final_norm"], x)
    if not train:
        return _logits(cfg, params, x), x
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    return _logits(cfg, params, x), x, total


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

#: the weight of deepseek-v3's multi-token-prediction loss in the total
MTP_WEIGHT = 0.3

#: the attention route of the training forward: the plain `attend`, the
#: counterpart of the jnp `attend` the JAX train step differentiates (the
#: CUDA attention kernels have no backward; their wrappers refuse inputs
#: that require grad)
TRAIN_ATTENTION = "reference"


def cross_entropy(logits, targets, mask):
    """The mean over the rows `mask` keeps of -log softmax(logits)[target],
    in fp32."""
    lse = torch.log_softmax(logits.float(), dim=-1)
    ll = lse.gather(-1, targets[..., None].long())[..., 0]
    m = mask.float()
    return -(ll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def _mtp_loss(cfg: ModelConfig, params: Params, hidden, tokens, targets,
              mask):
    """DeepSeek's multi-token prediction (the JAX `loss_fn`): predict t+2
    from (hidden_t, embed(token_{t+1})) through one dense block at
    rope_theta, no window."""
    mp = params["mtp"]
    h = L.apply_norm(cfg, mp["norm_h"], hidden[:, :-1])
    e_next = L.apply_norm(cfg, mp["norm_e"], _embed(cfg, params,
                                                    tokens[:, 1:]))
    hm = torch.cat([h, e_next], dim=-1) @ mp["proj"]
    b, s, _ = hm.shape
    pos = torch.arange(s, device=hm.device).expand(b, s)
    hm = _self_attention(
        cfg, mp["block"], hm, pos, theta=cfg.rope_theta, window=L.NO_WINDOW,
        cache=None, cache_index=0, backend=TRAIN_ATTENTION,
        tables=L.rope_tables(pos, rope_dim(cfg), cfg.rope_theta),
        kv_len=None)
    hm = _ffn(cfg, mp["block"], hm)[0]
    tgt = targets[:, 1:]
    logits = _logits(cfg, params, hm)[:, -tgt.shape[1]:]
    return cross_entropy(logits, torch.clamp_min(tgt, 0), mask[:, 1:])


def loss_fn(cfg: ModelConfig, params: Params, batch):
    """The JAX `loss_fn`: (total, metrics) for a batch {"tokens" (B, S),
    "targets" (B, S_t), optional "positions", "enc_embeds" (encdec),
    "img_embeds" (vlm)} from the master parameters, cast to the compute
    type on a copy at this call (`compute_tree`). The cross entropy
    covers the last S_t positions (vlm: the text's), targets < 0
    masked; total = ce + aux_loss_coef * aux (+ MTP_WEIGHT * mtp where
    the tree holds deepseek's "mtp" head). metrics: "ce", "aux" and
    "total" (and "mtp"), fp32 scalars on the device. The forward runs in
    training mode (`forward(train=True)`), its attention through
    TRAIN_ATTENTION."""
    params = compute_tree(cfg, params)
    tokens, targets = batch["tokens"], batch["targets"]
    logits, hidden, aux = forward(
        cfg, params, tokens, positions=batch.get("positions"),
        backend=TRAIN_ATTENTION, enc_embeds=batch.get("enc_embeds"),
        img_embeds=batch.get("img_embeds"), train=True)
    mask = targets >= 0
    ce = cross_entropy(logits[:, -targets.shape[1]:],
                       torch.clamp_min(targets, 0), mask)
    metrics = {"ce": ce, "aux": aux}
    total = ce + cfg.aux_loss_coef * aux
    if cfg.mtp_depth and "mtp" in params:
        mtp = _mtp_loss(cfg, params, hidden, tokens, targets, mask)
        metrics["mtp"] = mtp
        total = total + MTP_WEIGHT * mtp
    metrics["total"] = total
    return total, metrics


def prefill(cfg: ModelConfig, params: Params, tokens, max_len: int, *,
            cache_dtype=torch.bfloat16, backend: str = "cuda",
            enc_embeds=None, img_embeds=None, cache=None):
    """Run the prompt through the model, filling a fresh cache of size
    max_len, or `cache` (init_cache's tree for B rows, or views of its
    leading B rows) in place, from the state a fresh cache holds.
    tokens: (B, S); enc_embeds: encdec's (B, F, d) frame embeddings;
    img_embeds: vlm's (B, N, d) image embeddings, whose N rows the cache
    holds before the prompt's. Returns (last_logits (B, V), cache)."""
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                           device=tokens.device)
    elif "kv_local" in cache:
        # a ring's attention masks by the positions its slots hold
        cache["kv_local"]["pos"].fill_(L.RING_EMPTY)
    elif cfg.arch_type in ("ssm", "hybrid"):
        # the prefill reads the recurrent state it starts from (the conv
        # windows and the SSM state): a reused cache starts from zeros,
        # as a fresh one does. Attention K/V past the prompt are masked.
        for leaf in (cache if cfg.arch_type == "ssm"
                     else cache["ssm"]).values():
            leaf.zero_()
    logits, _ = forward(cfg, params, tokens, cache=cache, cache_index=0,
                        backend=backend, last_only=True,
                        enc_embeds=enc_embeds, img_embeds=img_embeds)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: Params, cache, tokens, index, *,
                backend: str = "cuda"):
    """One decode step. tokens: (B, 1); index: the position written, a
    Python int or a 0-d or (1,) int64 tensor on the tokens' device (read
    on the device only; an int gives the same results bit for bit).
    Returns (logits (B, V), cache), the cache updated in place."""
    b = tokens.shape[0]
    if not isinstance(index, torch.Tensor):
        # a fill, not a copy from the host (which would wait for the
        # stream)
        index = torch.full((1,), int(index), dtype=torch.int64,
                           device=tokens.device)
    index = index.reshape(1)
    logits, _ = forward(cfg, params, tokens, positions=index.expand(b, 1),
                        cache=cache, cache_index=index, backend=backend)
    return logits[:, -1], cache
