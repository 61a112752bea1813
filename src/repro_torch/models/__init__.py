"""The language-model stack of the port (counterpart of ``repro.models``):
xlstm-125m's mLSTM/sLSTM blocks so far, the sLSTM recurrence and the
one-hot embedding gather on the card's kernels."""

from .model import (GenericLM, check_supported, decode_step, forward,
                    init_cache, init_model, prefill)

__all__ = ["GenericLM", "check_supported", "decode_step", "forward",
           "init_cache", "init_model", "prefill"]
