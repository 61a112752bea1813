"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (kv=8) vocab=163840, MoE 384e top-8 with expert
d_ff=2048 on every layer.  The heaviest dry-run cell: ~1T params; fitting
512 v5e chips requires FSDP across pods + 8-bit optimizer state
(EXPERIMENTS.md §Dry-run).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=0,
    vocab=163840,
    moe=True,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    moe_every=1,
    rope_theta=5e4,
)
