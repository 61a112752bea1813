"""The language-model stack of the port (counterpart of ``repro.models``):
attention with RoPE and a bf16 or int8 KV cache, the dense MLP, MoE, the
Mamba and mLSTM/sLSTM blocks, the encoder-decoder and the stub
frontends; the sLSTM recurrence and the one-hot embedding gather on the
card's kernels."""

from .model import (GenericLM, decode_step, forward, init_cache, init_model,
                    prefill)

__all__ = ["GenericLM", "decode_step", "forward", "init_cache", "init_model",
           "prefill"]
