"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2
every other layer.  Period of 8 blocks: one attention + seven mamba; no
positional encoding (the mamba blocks carry position).  Hybrid -> runs
``long_500k``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=True,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    rope="nope",
    d_state=16,
    d_conv=4,
    ssm_expand=2,
)
