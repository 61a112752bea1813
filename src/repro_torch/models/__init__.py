"""The language-model stack of the port (counterpart of ``repro.models``):
attention with RoPE and a bf16 or int8 KV cache, the dense MLP, the
mLSTM/sLSTM blocks, the encoder-decoder and the stub frontends; the
sLSTM recurrence and the one-hot embedding gather on the card's
kernels.  Mamba and MoE are not ported yet."""

from .model import (GenericLM, check_supported, decode_step, forward,
                    init_cache, init_model, prefill)

__all__ = ["GenericLM", "check_supported", "decode_step", "forward",
           "init_cache", "init_model", "prefill"]
