"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356].

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  Encoder-decoder: 12
encoder + 12 decoder layers with cross-attention; the conv/mel frontend
is a stub linear adapter over precomputed 80-dim frames.  Sinusoidal
positions (no RoPE), LayerNorm, GELU, tied embeddings.  Full attention
-> ``long_500k`` skipped (DESIGN.md §6).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    enc_dec=True,
    n_enc_layers=12,
    frontend="audio",
    rope="none",
    norm="layernorm",
    mlp_act="gelu",
    tie_embeddings=True,
)
