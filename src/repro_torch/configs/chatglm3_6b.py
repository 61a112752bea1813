"""chatglm3-6b — RoPE 2d, GQA kv=2 [arXiv:2406.12793; hf].

28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024.  2D RoPE: rotary on
half the head dim, pass-through on the rest; qkv bias on.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope="rope2d",
    qkv_bias=True,
)
