"""olmo-1b [arXiv:2402.00838] — dense, non-parametric LayerNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparam_ln",
    tie_embeddings=True,
)
