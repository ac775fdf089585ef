"""whisper-large-v3 [arXiv:2212.04356] — audio encoder-decoder backbone.

32 encoder + 32 decoder layers, d_model=1280, 20 heads (MHA, kv=20),
d_ff=5120, vocab=51866. The mel-spectrogram + conv feature extractor is a
STUB: input_specs() supplies (B, 1500, d_model) frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="encdec",
    source="arXiv:2212.04356",
    n_layers=32,
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    n_audio_frames=1500,
    norm="layernorm",
    tie_embeddings=True,
)
