"""deepseek-v3-671b [arXiv:2412.19437] — MLA + MoE (1 shared + 256 routed,
top-8) + MTP.

The assigned d_ff=2048 is the per-expert (routed/shared) hidden size; the
first 3 layers are dense with the paper's 18432 hidden (Table 1 of
arXiv:2412.19437). MLA dims follow the paper: q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v_head 128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    moe_d_ff=2048,
    vocab=129280,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=256,
    experts_per_tok=8,
    n_shared_experts=1,
    first_k_dense=3,
    aux_loss_coef=0.001,  # ds3 is aux-free-biased; keep a small seq-wise aux
    mtp_depth=1,
    tie_embeddings=False,
)
