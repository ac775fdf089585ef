"""gemma3-12b [hf:google/gemma-3-1b-pt family] — 5:1 local(sliding-1024):global,
qk-norm, dual rope theta (10k local / 1M global), 262k vocab."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    qk_norm=True,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
)
