"""Mixture-of-Experts FFN on one device: phi3.5-moe's routed experts and
deepseek-v3's shared experts.

A port of the JAX package's `models/moe.py`. `apply_moe` is ONE function
equal to both of its single-device paths: `_small_moe` (a one-hot
dispatch, taken up to 8192 tokens) and `_local_moe(..., None, 1, 0)` (a
gather, taken above that without a model mesh). They compute the same
thing:

  1. router logits and softmax in fp32, the router read in fp32;
  2. each token's top-k experts by `ref.stable_topk` (ties to the lowest
     expert, the `jax.lax.top_k` contract; `torch.topk` does not keep
     it), weights top_w / max(sum top_w, 1e-9);
  3. a capacity of C = int(max(k, capacity_factor * k * T / E)) slots an
     expert for the T tokens of the call, padded rows included; each
     (token, choice) pair takes the next slot of its expert in flat
     token-major order, and pairs past C are dropped;
  4. the (E, C, d) slot buffer gathered from the tokens: each kept pair
     writes its token's index into its slot (a dropped one into a trash
     slot, as `_local_moe` does; `dispatch`), empty slots read a zero
     row. The
     one-hot (T*k, E, C) dispatch of `_small_moe` is not built: its
     products add exactly one non-zero term, so they give these values;
  5. the batched expert FFN silu(x W_gate) * (x W_up) W_down in the
     compute type (`torch.bmm` over the experts);
  6. each pair's output times its weight cast to the compute type, summed
     over the k choices in choice order (the JAX scatter-add's order);
  7. the shared experts' gated MLP added after the combine.

and the Switch-style auxiliary loss. Every shape is static (no
`nonzero`, boolean indexing or host read), so a decode step that runs it
is captured whole into a CUDA graph.

The JAX package computes the MoE in jnp einsums with no Pallas kernel,
so there is no kernel to port here: on the card the expert products are
PyTorch's batched matmuls, as mamba2's SSD is (models/ssm.py). Not
ported: the expert-parallel `shard_map` over a "model" mesh axis that
the JAX `apply_moe` takes above 8192 tokens on such a mesh (ROADMAP §3,
with the fleet meshes of §2.10).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, normal

Params = Dict[str, Any]


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """Random parameters with the JAX package's shapes and scales, in
    `dtype` on the generator's device: router (d, E), w_gate / w_up (E,
    d, ff), w_down (E, ff, d), and with shared experts a "shared" gated
    MLP of width ff * n_shared_experts."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"router": normal(gen, (d, e), s_in, dtype),
         "w_gate": normal(gen, (e, d, ff), s_in, dtype),
         "w_up": normal(gen, (e, d, ff), s_in, dtype),
         "w_down": normal(gen, (e, ff, d), s_out, dtype)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": normal(gen, (d, sff), s_in, dtype),
                       "w_up": normal(gen, (d, sff), s_in, dtype),
                       "w_down": normal(gen, (sff, d), sff ** -0.5, dtype)}
    return p


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert for a call of t tokens (the JAX formula, in
    Python from the call's static token count)."""
    k = cfg.experts_per_tok
    return int(max(k, cfg.capacity_factor * k * t / cfg.n_experts))


def route(cfg: ModelConfig, router, xt):
    """xt: (T, d) -> (top_w (T, k) fp32, top_e (T, k) int64, gates (T, E)
    fp32): the softmax gates in fp32 and each token's top-k experts,
    ties to the lowest, their weights renormalised."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_w, top_e = ref.stable_topk(gates, cfg.experts_per_tok)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_w, top_e, gates


class Dispatch(NamedTuple):
    """Where a call's (token, choice) pairs go, A = T * k of them in flat
    token-major order: `pair` is each pair's row of the (E * C) slot rows
    (E * C, the trash, where it is dropped), `src` each slot row's token
    (T, a zero row, where the slot is empty)."""
    top_w: Any       # (T, k) fp32
    top_e: Any       # (T, k) int64
    gates: Any       # (T, E) fp32
    keep: Any        # (A,) bool
    pair: Any        # (A,) int64
    src: Any         # (E * C,) int64
    cap: int


def dispatch(cfg: ModelConfig, router, xt) -> Dispatch:
    """Route the (T, d) tokens and give each pair the next slot of its
    expert, counted in flat order; the pair is kept if that slot is
    below the capacity."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.experts_per_tok
    top_w, top_e, gates = route(cfg, router, xt)
    cap = capacity(cfg, t)
    flat_e = top_e.reshape(-1)
    # the (E, A) one-hot, scanned along its inner dim: a scan of the (A,
    # E) one-hot along its outer dim was 25% of a phi prefill on the card
    onehot = (torch.arange(e, device=xt.device)[:, None]
              == flat_e).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1).gather(
        0, flat_e[None])[0].long()
    keep = slot < cap
    pair = torch.where(keep, flat_e * cap + slot, e * cap)
    src = torch.full(((e + 1) * cap,), t, dtype=torch.int64,
                     device=xt.device)
    src.index_copy_(0, pair, torch.arange(t * k, device=xt.device) // k)
    return Dispatch(top_w, top_e, gates, keep, pair, src[:e * cap], cap)


def aux_loss(top_e, gates):
    """E * sum_e (share of the (token, choice) pairs per token on e) *
    (mean gate of e), in fp32 (Switch-style, over the full gates)."""
    e = gates.shape[-1]
    chosen = (top_e[..., None] == torch.arange(
        e, device=top_e.device)).float().sum(1)
    return e * (chosen.mean(0) * gates.mean(0)).sum()


def apply_moe(cfg: ModelConfig, params: Params, x) -> Tuple[Any, Any]:
    """x: (B, S, d) in the compute type -> (y (B, S, d), aux fp32 scalar).
    params: init_moe's dict, its expert weights in x's type (the router
    in any type: it is read in fp32)."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.experts_per_tok
    xt = x.reshape(t, d)
    dp = dispatch(cfg, params["router"], xt)
    # the slot buffer by gather: empty slots read the zero row t
    buf = torch.cat([xt, xt.new_zeros((1, d))])[dp.src].view(e, dp.cap, d)
    h = F.silu(torch.bmm(buf, params["w_gate"])) \
        * torch.bmm(buf, params["w_up"])
    y_buf = torch.bmm(h, params["w_down"]).view(e * dp.cap, d)
    # each pair's output, weighted in the compute type, zero if dropped
    y_pair = y_buf[torch.where(dp.keep, dp.pair, 0)] \
        * dp.top_w.reshape(-1, 1).to(x.dtype)
    y_pair = torch.where(dp.keep[:, None], y_pair, 0).view(t, k, d)
    y = y_pair[:, 0]
    for j in range(1, k):
        y = y + y_pair[:, j]
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + apply_mlp(cfg, params["shared"], x)
    return y, aux_loss(dp.top_e, dp.gates)
