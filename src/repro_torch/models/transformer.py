"""Model assembly for the dense serving path: parameters, the KV cache,
forward, prefill and decode_step.

A port of the JAX package's `models/transformer.py` for arch_type "dense"
with full attention (embed -> blocks(L) -> norm -> head). Where it
differs:

  * the layer stack is a Python loop over a list of per-layer parameter
    dicts (the JAX package scans stacked (L, ...) leaves);
  * the KV cache is one preallocated (L, B, max_len, Hk, hd) buffer for K
    and one for V, which prefill and decode_step write IN PLACE and
    return; the JAX functions return a new cache;
  * `cast_params` casts the parameters to the compute type once, at load,
    where the JAX layers cast at each use (`_cast`): the values are the
    same, and a decode step then reads the weights once in bf16 instead
    of reading fp32, writing bf16 and reading that again;
  * prefill computes the logits of the last position only: the JAX
    prefill keeps row -1 of the full (B, S, V) panel, the same row.

MoE, SSM, hybrid, encoder-decoder and VLM architectures, local:global
window stacks (gemma3's ring cache) and MLA raise NotImplementedError;
ROADMAP §2.2 queues them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    run; it never falls back on another path."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet "
            "(ROADMAP §2.2: moe, ssm, hybrid, encdec, vlm)")
    if cfg.attn_kind != "full":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn_kind!r} is not ported yet "
            "(ROADMAP §2.2: MLA)")
    if cfg.local_global_ratio or cfg.window_cache:
        raise NotImplementedError(
            f"{cfg.name}: local:global sliding-window stacks need a "
            "windowed decode over a ring cache (ROADMAP §2.2)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


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


def _init_block(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    d, h, hk, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    dev = gen.device
    attn = {
        "wq": _normal(gen, (d, h * hd), d ** -0.5, dtype),
        "wk": _normal(gen, (d, hk * hd), d ** -0.5, dtype),
        "wv": _normal(gen, (d, hk * hd), d ** -0.5, dtype),
        "wo": _normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        attn["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return {
        "attn_norm": _init_norm(cfg, dtype, dev),
        "mlp_norm": _init_norm(cfg, dtype, dev),
        "attn": attn,
        "ffn": {"w_gate": _normal(gen, (d, ff), d ** -0.5, dtype),
                "w_up": _normal(gen, (d, ff), d ** -0.5, dtype),
                "w_down": _normal(gen, (ff, d), ff ** -0.5, dtype)},
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters in `cfg.param_dtype` on the generator's device,
    with the JAX package's shapes and scales (its numbers differ: a
    torch.Generator is not a JAX key).

    Layout: {"embed": (V, d), "final_norm", ["lm_head": (d, V)],
    "blocks": [per layer {"attn_norm", "mlp_norm", "attn": {"wq": (d,
    H*hd), "wk"/"wv": (d, Hk*hd), "wo": (H*hd, d), ["q_norm", "k_norm"]},
    "ffn": {"w_gate"/"w_up": (d, ff), "w_down": (ff, d)}}]}."""
    check_supported(cfg)
    cfg.validate()
    dtype = torch_dtype(cfg.param_dtype)
    p: Params = {
        "embed": _normal(gen, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                         dtype),
        "final_norm": _init_norm(cfg, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, dtype)
    p["blocks"] = [_init_block(cfg, gen, dtype) for _ in range(cfg.n_layers)]
    return p


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """Cast, IN PLACE, every parameter the JAX layers cast to the compute
    type at use (embedding, head, the attention dict with its qk-norm
    scales, the MLP) to that type, once. Norm parameters stay as they
    are: the norms read them in fp32. Each old tensor is released as its
    cast replaces it, so the peak is one leaf above the larger copy."""
    dt = torch_dtype(cfg.dtype)
    for name in ("embed", "lm_head"):
        if name in params:
            params[name] = params[name].to(dt)
    for blk in params["blocks"]:
        for group in ("attn", "ffn"):
            for name in list(blk[group]):
                blk[group][name] = blk[group][name].to(dt)
    return params


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """{"k", "v"}: zeroed (L, B, max_len, Hk, hd) buffers."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def forward(cfg: ModelConfig, params: Params, tokens, *, positions=None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: int = 0, backend: str = "cuda",
            last_only: bool = False):
    """tokens: (B, S) -> (logits (B, S or 1, V), hidden (B, S or 1, d)).

    With a cache, the S new keys and values are written into it at
    `cache_index`, in place. `last_only` runs the final norm and the head
    on the last position alone. `backend` selects the attention route on
    CUDA tensors (layers.apply_attention)."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta)
    # the valid cache rows after this call's write, once for every layer
    kv_len = None if cache is None else torch.full(
        (b,), cache_index + s, dtype=torch.int32, device=x.device)
    for i, blk in enumerate(params["blocks"]):
        kv = None if cache is None else {"k": cache["k"][i],
                                         "v": cache["v"][i]}
        h = L.apply_norm(cfg, blk["attn_norm"], x)
        x = x + L.apply_attention(cfg, blk["attn"], h, positions,
                                  theta=cfg.rope_theta, cache=kv,
                                  cache_index=cache_index, backend=backend,
                                  rope=rope, kv_len=kv_len)
        h = L.apply_norm(cfg, blk["mlp_norm"], x)
        x = x + L.apply_mlp(cfg, blk["ffn"], h)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), x


def prefill(cfg: ModelConfig, params: Params, tokens, max_len: int, *,
            cache_dtype=torch.bfloat16, backend: str = "cuda"):
    """Run the prompt through the model, filling a fresh cache of size
    max_len. tokens: (B, S). Returns (last_logits (B, V), cache)."""
    cache = init_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                       device=tokens.device)
    logits, _ = forward(cfg, params, tokens, cache=cache, cache_index=0,
                        backend=backend, last_only=True)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: Params, cache, tokens, index: int,
                *, backend: str = "cuda"):
    """One decode step. tokens: (B, 1); index: the position written.
    Returns (logits (B, V), cache), the cache updated in place."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), int(index), dtype=torch.int64,
                           device=tokens.device)
    logits, _ = forward(cfg, params, tokens, positions=positions,
                        cache=cache, cache_index=int(index), backend=backend)
    return logits[:, -1], cache
