"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf] — VLM.

Mistral-7B language backbone; the SigLIP/CLIP vision tower + anyres tiling
projector is a STUB: input_specs() supplies (B, n_image_tokens, d_model)
patch embeddings (2880 = 576 base + 4x576 anyres tiles), interleaved ahead
of the text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    n_image_tokens=2880,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
