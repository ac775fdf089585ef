"""First-principles FLOPs / HBM-traffic model per (arch x shape).

A copy of the JAX package's `analysis/roofline_model.py` over the port's
`models/config.py`: pure Python, so its numbers are the JAX module's to
the last bit. The dry-run (`launch/dryrun.py`) records it beside the
FLOPs and bytes it counts on the meta device; the roofline report
(`benchmarks_torch/roofline.py`) takes its compute and memory terms from
THIS model, with the counted numbers kept as a cross-check.

Conventions:
  * matmul cost = 2 * tokens * params_touched (MACs x2);
  * train = fwd x 4 (fwd + 2x bwd + 1x remat recompute of the fwd);
  * causal attention scores average S/2 keys per query at train/prefill;
  * MoE compute counts capacity_factor token-dropping headroom;
  * HBM traffic is a step-level estimate with explicit per-term factors
    (documented inline) — it is a roofline bound, not a simulator.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import (ModelConfig, _attn_params,
                                       _ffn_params, _ssm_params)


def _attn_core_flops(cfg: ModelConfig, s_kv_avg: float, window: int = 0
                     ) -> float:
    """Score + value matmul FLOPs per query token for one attention layer."""
    if cfg.attn_kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return 2.0 * cfg.n_heads * (qk + cfg.v_head_dim) * s_kv_avg
    eff = min(window, s_kv_avg) if window else s_kv_avg
    return 4.0 * cfg.n_heads * cfg.hd * eff


def _ssd_core_flops(cfg: ModelConfig, decode: bool) -> float:
    """SSD chunked-scan FLOPs per token for one mamba2 layer."""
    h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    if decode:
        return 2.0 * h * (2 * n * p)          # state update + readout
    q = cfg.ssm_chunk
    # intra-chunk scores/apply (~2*Q*N + 2*Q*P per token-head) + states
    return 2.0 * h * (q * n + q * p + 2 * n * p)


def fwd_flops_per_token(cfg: ModelConfig, s_kv_avg: float,
                        decode: bool = False) -> float:
    """Forward FLOPs per decoder token (excl. logits)."""
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local", "global"):
            w = cfg.sliding_window if kind == "local" else 0
            total += 2.0 * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
            total += _attn_core_flops(cfg, s_kv_avg, w)
        elif kind == "moe":
            total += 2.0 * _attn_params(cfg)
            total += _attn_core_flops(cfg, s_kv_avg)
            act = (cfg.experts_per_tok * cfg.capacity_factor
                   + cfg.n_shared_experts)
            total += 2.0 * act * _ffn_params(cfg, cfg.expert_ff)
            total += 2.0 * cfg.d_model * cfg.n_experts     # router
        elif kind == "ssm":
            total += 2.0 * _ssm_params(cfg)
            total += _ssd_core_flops(cfg, decode)
        elif kind == "shared_attn":
            total += 2.0 * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
            total += _attn_core_flops(cfg, s_kv_avg)
    if cfg.arch_type == "encdec":
        # decoder cross-attention projections + core per token
        total += cfg.n_layers * (2.0 * _attn_params(cfg)
                                 + _attn_core_flops(cfg, cfg.n_audio_frames))
    return total


def _cache_bytes(cfg: ModelConfig, batch: int, s: int,
                 windowed: bool = False) -> float:
    """Decode-step cache traffic. `windowed=False` models the BASELINE
    implementation (full-length cache for every layer, local layers
    included — the mask hides, it does not skip reads). `windowed=True`
    models the §Perf windowed-cache variant for local:global archs."""
    if cfg.arch_type == "ssm":
        per = cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4 \
            + 3 * (cfg.ssm_conv - 1) * cfg.d_inner * 4
        return cfg.n_layers * batch * per
    if cfg.arch_type == "hybrid":
        n_attn = sum(k == "shared_attn" for k in cfg.layer_kinds())
        n_ssm = cfg.n_layers - n_attn
        ssm_per = cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4
        kv = n_attn * batch * s * cfg.n_kv_heads * cfg.hd * 2 * 2
        return kv + n_ssm * batch * ssm_per
    if cfg.attn_kind == "mla":
        return cfg.n_layers * batch * s * (cfg.kv_lora_rank
                                           + cfg.qk_rope_dim) * 2
    kv = cfg.n_layers * batch * s * cfg.n_kv_heads * cfg.hd * 2 * 2
    if cfg.arch_type == "encdec":
        kv += cfg.n_layers * batch * cfg.n_audio_frames \
            * cfg.n_kv_heads * cfg.hd * 2 * 2
    if windowed and cfg.local_global_ratio and cfg.sliding_window:
        # windowed local layers only need `window` cache entries
        kinds = cfg.layer_kinds()
        n_local = sum(k == "local" for k in kinds)
        n_global = len(kinds) - n_local
        per = batch * cfg.n_kv_heads * cfg.hd * 2 * 2
        kv = (n_global * s + n_local * min(s, cfg.sliding_window)) * per
    return kv


def analytic_costs(cfg: ModelConfig, kind: str, global_batch: int,
                   seq_len: int) -> Dict[str, float]:
    """Global (all-chips) FLOPs and HBM bytes for one step."""
    n_params = cfg.total_params()
    p_bytes = n_params * 4.0                     # fp32 master params
    v_logits = 2.0 * cfg.d_model * cfg.vocab

    if kind in ("train", "prefill"):
        tokens = float(global_batch) * seq_len
        fwd = tokens * (fwd_flops_per_token(cfg, seq_len / 2.0) + v_logits)
        if cfg.arch_type == "encdec":
            enc_tokens = float(global_batch) * cfg.n_audio_frames
            enc_per = cfg.n_enc_layers * (
                2.0 * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
                + 4.0 * cfg.n_heads * cfg.hd * cfg.n_audio_frames)
            fwd += enc_tokens * enc_per
        if kind == "train":
            mult = 4.0 if cfg.remat else 3.0     # fwd+bwd(2x)+remat refwd
            flops = fwd * mult
            act_bytes = (cfg.n_layers * tokens * cfg.d_model * 2.0
                         * 8.0)                  # ckpt w/r + recompute traffic
            logits_bytes = tokens * cfg.vocab * 6.0   # bf16 + fp32 passes
            hbm = 7.0 * p_bytes + act_bytes + logits_bytes
        else:
            flops = fwd
            hbm = (p_bytes + _cache_bytes(cfg, global_batch, seq_len)
                   + cfg.n_layers * tokens * cfg.d_model * 2.0 * 4.0)
        return {"flops_global": flops, "hbm_bytes_global": hbm,
                "tokens": tokens}

    # decode: one token per sequence against a seq_len cache
    tokens = float(global_batch)
    flops = tokens * (fwd_flops_per_token(cfg, float(seq_len), decode=True)
                      + v_logits)
    hbm = p_bytes + _cache_bytes(cfg, global_batch, seq_len)
    return {"flops_global": flops, "hbm_bytes_global": hbm, "tokens": tokens}
