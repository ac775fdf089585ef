"""The paper's own router configuration (Appendix A.1).

P = 0.5 (global/local mix), N = 20 (neighbour prompts), K = 32 (ELO
sensitivity). The embedding width follows the corpus embedder: 1536 for
stella_en_1.5B_v5 in the paper, 64 for the synthetic benchmark regime.
"""
from repro_torch.core.router import EagleConfig

PAPER_CONFIG = EagleConfig(
    p_global=0.5,
    n_neighbors=20,
    k_factor=32.0,
    init_rating=1000.0,
    embed_dim=1536,
)

BENCH_CONFIG = EagleConfig(
    p_global=0.5,
    n_neighbors=20,
    k_factor=32.0,
    init_rating=1000.0,
    embed_dim=64,
)
