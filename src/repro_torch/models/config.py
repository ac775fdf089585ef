"""Model configuration for the serving fleet.

One ModelConfig describes any architecture in the assigned pool: dense
decoder-only, MoE, SSM (Mamba2), hybrid (Zamba2), encoder-decoder
(Whisper) and VLM (LLaVA). A copy of the JAX package's module, so the
port names the same configurations; ``repro_torch.models.transformer``
runs every family (MLA among the attentions) and the dry-run's ring
caches for local layers (`window_cache`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""          # citation for the config numbers

    # -- core dims --------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0          # 0 -> d_model // n_heads

    # -- attention flavour -------------------------------------------------
    attn_kind: str = "full"    # full | mla | none
    qk_norm: bool = False
    sliding_window: int = 0    # 0 -> disabled; >0 -> window size for local layers
    local_global_ratio: int = 0  # e.g. 5 -> 5 local layers then 1 global (gemma3)
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3 uses a larger theta on global layers

    # -- MLA dims (deepseek-v3) --------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0          # per-expert hidden size (0 -> d_ff)
    first_k_dense: int = 0     # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01

    # -- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # -- hybrid (zamba2): every `hybrid_period`-th block is the shared attn --
    hybrid_period: int = 6

    # -- encoder-decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    n_audio_frames: int = 1500   # encoder input length (stub frontend)

    # -- vlm (llava) -----------------------------------------------------------
    n_image_tokens: int = 0      # patch-embedding tokens prepended to text

    # -- serving -------------------------------------------------------------
    # ring-buffer KV cache of size `sliding_window` for local layers
    # (gemma3-style local:global stacks) instead of full-length caches
    window_cache: bool = False

    # -- norms / embeddings ------------------------------------------------------
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # -- training ------------------------------------------------------------
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    # mtp: deepseek-v3 multi-token-prediction auxiliary head (1 extra depth)
    mtp_depth: int = 0

    # ------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        # channels passing through the causal depthwise conv: x + B + C
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack.

        Returns a tuple of: 'attn' (attention+dense ffn), 'moe'
        (attention+moe ffn), 'ssm' (mamba2 block), 'shared_attn'
        (zamba2 weight-tied attention block), 'local'/'global'
        (gemma3 sliding/full attention + dense ffn).
        """
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        if self.arch_type == "hybrid":
            kinds = []
            for i in range(self.n_layers):
                if (i + 1) % self.hybrid_period == 0:
                    kinds.append("shared_attn")
                else:
                    kinds.append("ssm")
            return tuple(kinds)
        if self.arch_type == "moe":
            kinds = []
            for i in range(self.n_layers):
                kinds.append("attn" if i < self.first_k_dense else "moe")
            return tuple(kinds)
        if self.local_global_ratio:
            kinds = []
            for i in range(self.n_layers):
                if (i + 1) % (self.local_global_ratio + 1) == 0:
                    kinds.append("global")
                else:
                    kinds.append("local")
            return tuple(kinds)
        return ("attn",) * self.n_layers

    def active_params(self) -> float:
        """Parameters touched per token (for MoE cost proxies + MODEL_FLOPS)."""
        return count_params(self, active_only=True)

    def total_params(self) -> float:
        return count_params(self, active_only=False)

    def validate(self) -> None:
        assert self.d_model > 0 and self.n_layers > 0
        if self.arch_type not in ("ssm",):
            assert self.n_heads > 0
            assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.attn_kind == "mla"
        if self.arch_type == "moe":
            assert self.n_experts > 0 and self.experts_per_tok > 0
        if self.arch_type in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.arch_type == "encdec":
            assert self.n_enc_layers > 0
        if self.attn_kind == "mla":
            assert self.kv_lora_rank > 0 and self.qk_rope_dim > 0


def _attn_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    if cfg.attn_kind == "mla":
        qh = cfg.qk_nope_dim + cfg.qk_rope_dim
        p = 0.0
        if cfg.q_lora_rank:
            p += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qh
        else:
            p += d * cfg.n_heads * qh
        p += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        p += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
        p += cfg.n_heads * cfg.v_head_dim * d
        return p
    hd = cfg.hd
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _ffn_params(cfg: ModelConfig, ff: int) -> float:
    # gated (SwiGLU-style): up + gate + down
    return 3 * cfg.d_model * ff


def _ssm_params(cfg: ModelConfig) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    in_proj = d * (2 * di + 2 * g * n + h)
    conv = cfg.ssm_conv * cfg.conv_dim
    out_proj = di * d
    return in_proj + conv + out_proj + 2 * h + di


def count_params(cfg: ModelConfig, active_only: bool = False) -> float:
    """Approximate parameter count from the config (matmul weights only)."""
    kinds = cfg.layer_kinds()
    p = float(cfg.vocab * cfg.d_model)
    if not cfg.tie_embeddings:
        p += cfg.vocab * cfg.d_model
    shared_attn_counted = False
    for k in kinds:
        if k in ("attn", "local", "global"):
            p += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        elif k == "moe":
            p += _attn_params(cfg)
            n_e = (cfg.experts_per_tok + cfg.n_shared_experts) if active_only \
                else (cfg.n_experts + cfg.n_shared_experts)
            p += n_e * _ffn_params(cfg, cfg.expert_ff)
            p += cfg.d_model * cfg.n_experts  # router
        elif k == "ssm":
            p += _ssm_params(cfg)
        elif k == "shared_attn":
            if not shared_attn_counted:
                p += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
                shared_attn_counted = True
    if cfg.arch_type == "encdec":
        p += cfg.n_enc_layers * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        # decoder cross-attention
        p += cfg.n_layers * _attn_params(cfg)
    return p


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        head_dim=32 if cfg.head_dim else 0,
        remat=False,
    )
    if cfg.arch_type == "moe":
        small.update(
            n_experts=min(cfg.n_experts, 4),
            experts_per_tok=min(cfg.experts_per_tok, 2),
            moe_d_ff=min(cfg.expert_ff, 128),
            first_k_dense=min(cfg.first_k_dense, 1),
        )
    if cfg.attn_kind == "mla":
        small.update(
            q_lora_rank=64, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=16,
            v_head_dim=32, head_dim=0,
        )
    if cfg.arch_type in ("ssm", "hybrid"):
        small.update(
            ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
            n_layers=6 if cfg.arch_type == "hybrid" else 2,
            hybrid_period=3,
        )
    if cfg.arch_type == "encdec":
        small.update(n_enc_layers=2, n_audio_frames=16)
    if cfg.arch_type == "vlm":
        small.update(n_image_tokens=8)
    if cfg.n_kv_heads == cfg.n_heads:  # keep MHA families MHA
        small["n_kv_heads"] = small["n_heads"]
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
