"""Strategy autotuning: sweep, cache and ``strategy="auto"`` resolution
(counterpart of ``repro.tune``).  On the card the candidates run the
port's CUDA kernels and are timed with CUDA events."""

from .cache import (DEFAULT_STRATEGY, KNOWN_OPTION_KEYS, TUNE_SCHEMA_VERSION,
                    TunedConfig, autotune, cache_key, clear_memory_cache,
                    device_identity, filter_strategy_opts, load_tuned,
                    resolve_pallas_config, resolve_strategy, store_tuned,
                    tune_dir)
from .space import (Candidate, default_space, jnp_candidates,
                    kernel_smem_bytes, pallas_batch_fits_smem,
                    pallas_candidates)
from .sweep import SweepResult, Timing, sweep_strategies
from .timing import time_fn

__all__ = [
    "DEFAULT_STRATEGY", "KNOWN_OPTION_KEYS", "TUNE_SCHEMA_VERSION",
    "TunedConfig", "autotune", "cache_key", "clear_memory_cache",
    "device_identity", "filter_strategy_opts", "load_tuned",
    "resolve_pallas_config", "resolve_strategy", "store_tuned", "tune_dir",
    "Candidate", "default_space", "jnp_candidates", "kernel_smem_bytes",
    "pallas_batch_fits_smem", "pallas_candidates",
    "SweepResult", "Timing", "sweep_strategies", "time_fn",
]
