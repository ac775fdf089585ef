"""zamba2-7b [arXiv:2411.15242] — hybrid: Mamba2 backbone + one weight-SHARED
attention block applied every 6th position (81 blocks total)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    hybrid_period=6,
    tie_embeddings=True,
)
