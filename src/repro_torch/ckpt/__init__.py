"""Checkpointing (counterpart of ``repro.ckpt``): atomic save and
restore, an async writer."""

from .checkpoint import (  # noqa: F401
    CheckpointManager,
    all_steps,
    load_checkpoint,
    save_checkpoint,
)
