"""Strategy option tables (counterpart of the part of ``repro.tune`` that
validates options; the tuner itself is not ported yet)."""

from .cache import (DEFAULT_STRATEGY, KNOWN_OPTION_KEYS,
                    filter_strategy_opts)

__all__ = ["DEFAULT_STRATEGY", "KNOWN_OPTION_KEYS", "filter_strategy_opts"]
