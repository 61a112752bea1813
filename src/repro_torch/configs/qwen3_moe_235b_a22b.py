"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (kv=4) vocab=151936, MoE 128e top-8 with expert
d_ff=1536 on every layer (no dense MLP); head_dim=128.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    moe=True,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    moe_every=1,
    rope_theta=1e6,
)
