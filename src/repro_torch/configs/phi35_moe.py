"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts top-2."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    moe_d_ff=6400,
    vocab=32064,
    n_experts=16,
    experts_per_tok=2,
    first_k_dense=0,
    rope_theta=10_000.0,
    tie_embeddings=False,
)
