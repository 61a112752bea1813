"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936.  Backbone only: the
ViT frontend is a stub linear adapter over precomputed patch features
(``input_specs`` supplies them); M-RoPE positions use a (t, h, w) grid
for the patch prefix and degenerate to standard RoPE for text.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    rope="mrope",
    frontend="vision",
    qkv_bias=True,
)
