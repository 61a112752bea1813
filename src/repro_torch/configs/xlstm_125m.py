"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  No separate FFN: xLSTM
blocks carry their own up-projection (d_ff=0 in the assignment).  The
block pattern alternates mLSTM/sLSTM; both are streaming recurrences, so
this arch runs the ``long_500k`` cell (O(1) decode state).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    rope="nope",
    norm="layernorm",
    ssm_expand=2,
    tie_embeddings=True,
)
