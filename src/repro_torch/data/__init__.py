"""Data pipelines (counterpart of ``repro.data``): deterministic
synthetic LM tokens."""

from .tokens import TokenDataset, make_lm_batches  # noqa: F401
