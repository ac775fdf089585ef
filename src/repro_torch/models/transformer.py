"""Model assembly for the serving path: parameters, the decode cache,
forward, prefill and decode_step.

A port of the JAX package's `models/transformer.py` for three families:

  dense (full attention)  embed -> blocks(L) -> norm -> head
  ssm (mamba2)            embed -> ssm blocks(L) -> norm -> head
  encdec (whisper)        enc blocks(Le, bidirectional) over stub frame
                          embeddings -> dec blocks(L) with
                          cross-attention; sinusoidal absolute positions
                          on both stacks, no RoPE

Where it differs:

  * each layer stack is a Python loop over a list of per-layer parameter
    dicts (the JAX package scans stacked (L, ...) leaves);
  * the cache is preallocated and written IN PLACE by prefill and
    decode_step, which return it; the JAX functions return a new cache.
    Dense: one (L, B, max_len, Hk, hd) buffer for K and one for V.
    encdec: the same, and "cross": {k, v} of (L, B, n_audio_frames, Hk,
    hd), filled at prefill from the encoder's output. ssm: the JAX
    package's fp32 decode state, conv_x / conv_B / conv_C (L, B, k-1, C)
    and ssm (L, B, H, P, N);
  * `cast_params` casts the parameters to the compute type once, at load,
    where the JAX layers cast at each use (`_cast`): the values are the
    same, and a decode step then reads the weights once in bf16 instead
    of reading fp32, writing bf16 and reading that again;
  * prefill computes the logits of the last position only: the JAX
    prefill keeps row -1 of the full (B, S, V) panel, the same row.

Hybrid, MoE and VLM architectures, local:global window stacks
(gemma3's local layers, a window over the full cache) and MLA raise
NotImplementedError naming the item of ROADMAP §2.6 that queues them.

decode_step takes its position as a Python int or as a (1,) int64
tensor on the device: the positions, the valid cache length and the
cache write are then computed on the device, so a CUDA graph captured
over one step serves every position (serving/engine.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


#: the architecture families this port runs
FAMILIES = ("dense", "ssm", "encdec")
#: the item of ROADMAP §2.6 each other family waits for
QUEUED = {"moe": "item 1 (phi3.5-moe; deepseek-v3's MoE is item 6)",
          "vlm": "item 4 (llava-next-mistral-7b)",
          "hybrid": "item 5 (zamba2-7b)"}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    run; it never falls back on another path."""
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet "
            f"(ROADMAP §2.6, {QUEUED.get(cfg.arch_type, 'not queued')})")
    if cfg.attn_kind != "full":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn_kind!r} is not ported yet "
            "(ROADMAP §2.6, item 6: deepseek-v3-671b's MLA)")
    if cfg.local_global_ratio or cfg.window_cache:
        raise NotImplementedError(
            f"{cfg.name}: local:global sliding-window stacks need a "
            "window over the full cache in prefill and decode (ROADMAP "
            "§2.6, item 3: gemma3-12b)")


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
                cross: bool = False) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dev = gen.device
    p = {"attn_norm": _init_norm(cfg, dtype, dev),
         "mlp_norm": _init_norm(cfg, dtype, dev),
         "attn": _init_attention(cfg, gen, dtype)}
    if cross:
        p["cross_norm"] = _init_norm(cfg, dtype, dev)
        p["cross"] = _init_attention(cfg, gen, dtype)
    p["ffn"] = {"w_gate": L.normal(gen, (d, ff), d ** -0.5, dtype),
                "w_up": L.normal(gen, (d, ff), d ** -0.5, dtype),
                "w_down": L.normal(gen, (ff, d), ff ** -0.5, dtype)}
    return p


def _init_ssm_block(cfg: ModelConfig, gen: torch.Generator,
                    dtype) -> Params:
    return {"norm": _init_norm(cfg, dtype, gen.device),
            "mamba": SSM.init_mamba2(cfg, gen, dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters in `cfg.param_dtype` on the generator's device,
    with the JAX package's shapes and scales (its numbers differ: a
    torch.Generator is not a JAX key).

    Layout: {"embed": (V, d), "final_norm", ["lm_head": (d, V)],
    "blocks": [per layer {"attn_norm", "mlp_norm", "attn": {"wq": (d,
    H*hd), "wk"/"wv": (d, Hk*hd), "wo": (H*hd, d), ["q_norm", "k_norm"]},
    "ffn": {"w_gate"/"w_up": (d, ff), "w_down": (ff, d)}}]}; encdec adds
    "cross_norm" and "cross" (an "attn" dict) to each decoder block, and
    "enc_blocks" (Le blocks as dense ones) and "enc_norm"; an ssm block
    is {"norm", "mamba": the JAX package's mamba2 dict}."""
    check_supported(cfg)
    cfg.validate()
    dtype = torch_dtype(cfg.param_dtype)
    p: Params = {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                         dtype),
        "final_norm": _init_norm(cfg, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, dtype)
    if cfg.arch_type == "ssm":
        p["blocks"] = [_init_ssm_block(cfg, gen, dtype)
                       for _ in range(cfg.n_layers)]
    elif cfg.arch_type == "encdec":
        p["enc_blocks"] = [_init_block(cfg, gen, dtype)
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = _init_norm(cfg, dtype, gen.device)
        p["blocks"] = [_init_block(cfg, gen, dtype, cross=True)
                       for _ in range(cfg.n_layers)]
    else:
        p["blocks"] = [_init_block(cfg, gen, dtype)
                       for _ in range(cfg.n_layers)]
    return p


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """Cast, IN PLACE, every parameter the JAX layers cast to the compute
    type at use (embedding, head, the attention dicts with their qk-norm
    scales, the MLP, the mamba2 dict) to that type, once. Norm parameters stay as they
    are: the norms read them in fp32. Each old tensor is released as its
    cast replaces it, so the peak is one leaf above the larger copy."""
    dt = torch_dtype(cfg.dtype)
    for name in ("embed", "lm_head"):
        if name in params:
            params[name] = params[name].to(dt)
    for blk in params["blocks"] + params.get("enc_blocks", []):
        for group in ("attn", "cross", "ffn", "mamba"):
            for name in list(blk.get(group, ())):
                blk[group][name] = blk[group][name].to(dt)
    return params


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed decode state (module docstring). The ssm state is fp32
    whatever `dtype` says, as in the JAX package."""
    check_supported(cfg)
    zeros = lambda shape, dt=dtype: torch.zeros((cfg.n_layers,) + shape,
                                                dtype=dt, device=device)
    if cfg.arch_type == "ssm":
        gn, k = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_conv
        f32 = torch.float32
        return {"conv_x": zeros((batch, k - 1, cfg.d_inner), f32),
                "conv_B": zeros((batch, k - 1, gn), f32),
                "conv_C": zeros((batch, k - 1, gn), f32),
                "ssm": zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                              cfg.ssm_state), f32)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": zeros(shape), "v": zeros(shape)}
    if cfg.arch_type == "encdec":
        shape = (batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)
        cache["cross"] = {"k": zeros(shape), "v": zeros(shape)}
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


def _encode(cfg: ModelConfig, params: Params, enc_embeds, backend: str):
    """Whisper's encoder over stub frame embeddings (B, F, d): blocks of
    bidirectional self-attention without RoPE, then enc_norm."""
    x = enc_embeds.to(torch_dtype(cfg.dtype))
    b, f, _ = x.shape
    positions = torch.arange(f, device=x.device).expand(b, f)
    x = x + _sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    for blk in params["enc_blocks"]:
        h = L.apply_norm(cfg, blk["attn_norm"], x)
        x = x + L.apply_attention(cfg, blk["attn"], h, positions,
                                  theta=cfg.rope_theta, causal=False,
                                  rope=False, backend=backend)
        h = L.apply_norm(cfg, blk["mlp_norm"], x)
        x = x + L.apply_mlp(cfg, blk["ffn"], h)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _layer(cache, i: int):
    """Layer i's views of a cache tree of (L, ...) buffers."""
    return None if cache is None else {
        k: _layer(v, i) if isinstance(v, dict) else v[i]
        for k, v in cache.items()}


def forward(cfg: ModelConfig, params: Params, tokens, *, positions=None,
            cache: Optional[Dict[str, Any]] = None,
            cache_index=0, backend: str = "cuda",
            last_only: bool = False, enc_embeds=None):
    """tokens: (B, S) -> (logits (B, S or 1, V), hidden (B, S or 1, d)).

    With a cache, the S new keys and values (ssm: the state after the S
    tokens) are written into it at `cache_index`, in place: a Python
    int, or for one token a (1,) int64 device tensor. encdec takes
    `enc_embeds` (B, F, d), runs the encoder and, with a cache, stores
    each decoder layer's cross K/V in it; without `enc_embeds` it reads
    them from the cache (decode). `last_only` runs the final norm and
    the head on the last position alone. `backend` selects the attention
    route on CUDA tensors (layers.apply_attention)."""
    check_supported(cfg)
    at = cfg.arch_type
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if at == "ssm":
        for i, blk in enumerate(params["blocks"]):
            h = L.apply_norm(cfg, blk["norm"], x)
            x = x + SSM.apply_mamba2(cfg, blk["mamba"], h,
                                     cache=_layer(cache, i))[0]
    else:
        enc_out = cross_len = tables = None
        if at == "encdec":
            x = x + _sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
            if enc_embeds is not None:
                enc_out = _encode(cfg, params, enc_embeds, backend)
            elif cache is None:
                raise ValueError(f"{cfg.name}: forward needs enc_embeds or "
                                 "a cache holding the cross K/V")
            else:
                cross_len = torch.full((b,), cfg.n_audio_frames,
                                       dtype=torch.int32, device=x.device)
        else:
            tables = L.rope_tables(positions, cfg.hd, cfg.rope_theta)
        # the valid cache rows after this call's write, once for every
        # layer
        if cache is None:
            kv_len = None
        elif isinstance(cache_index, torch.Tensor):
            kv_len = (cache_index + s).to(torch.int32).expand(b) \
                .contiguous()
        else:
            kv_len = torch.full((b,), cache_index + s, dtype=torch.int32,
                                device=x.device)
        for i, blk in enumerate(params["blocks"]):
            c = _layer(cache, i)
            h = L.apply_norm(cfg, blk["attn_norm"], x)
            x = x + L.apply_attention(
                cfg, blk["attn"], h, positions, theta=cfg.rope_theta,
                cache=c, cache_index=cache_index, backend=backend,
                tables=tables, kv_len=kv_len, rope=at != "encdec")
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
            h = L.apply_norm(cfg, blk["mlp_norm"], x)
            x = x + L.apply_mlp(cfg, blk["ffn"], h)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), x


def prefill(cfg: ModelConfig, params: Params, tokens, max_len: int, *,
            cache_dtype=torch.bfloat16, backend: str = "cuda",
            enc_embeds=None, cache=None):
    """Run the prompt through the model, filling a fresh cache of size
    max_len, or `cache` (init_cache's tree for B rows, or views of its
    leading B rows) in place, from the state a fresh cache holds. tokens: (B, S); enc_embeds: encdec's (B,
    F, d) frame embeddings. Returns (last_logits (B, V), cache)."""
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                           device=tokens.device)
    elif cfg.arch_type == "ssm":
        # the prefill reads the recurrent state it starts from (the conv
        # windows and the SSM state): a reused cache starts from zeros,
        # as a fresh one does. Attention K/V past the prompt are masked.
        for leaf in cache.values():
            leaf.zero_()
    logits, _ = forward(cfg, params, tokens, cache=cache, cache_index=0,
                        backend=backend, last_only=True,
                        enc_embeds=enc_embeds)
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
