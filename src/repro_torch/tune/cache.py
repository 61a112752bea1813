"""Which options each back-projection strategy accepts.

The part of ``repro.tune.cache`` that validates options: the strategy
``"auto"`` resolves to before anything is tuned, the option keys each
strategy takes, and :func:`filter_strategy_opts`, which enforces them.
The tuned-decision cache itself is not ported yet.
"""

from __future__ import annotations

__all__ = ["DEFAULT_STRATEGY", "KNOWN_OPTION_KEYS", "filter_strategy_opts"]

# What "auto" means before anyone has tuned.
DEFAULT_STRATEGY = "strip2"

# Options each strategy accepts.  ``pbatch`` is strategy-independent
# (the batch-major loop nest wraps every strategy).
_STRATEGY_KEYS = {
    "scalar": ("pbatch",),
    "gather": ("pbatch",),
    "onehot": ("vox_block", "pbatch"),
    "strip": ("chunk", "band", "width", "strips_per_block", "strip_dtype",
              "pbatch"),
    "strip2": ("group", "gband", "gwidth", "groups_per_block",
               "strip_dtype", "pbatch"),
}

# Every option name some strategy accepts.  A key outside this set is a
# typo (or a kernel tiling key) and always raises.
KNOWN_OPTION_KEYS = frozenset(
    k for keys in _STRATEGY_KEYS.values() for k in keys)


def filter_strategy_opts(strategy: str, opts: dict | None) -> dict:
    """The options ``strategy`` accepts, validated strictly.

    A key no strategy accepts raises, and so does a known key that this
    strategy does not take: a strategy is always named explicitly here.
    """
    allowed = _STRATEGY_KEYS[strategy]
    opts = dict(opts or {})
    for k in opts:
        if k not in KNOWN_OPTION_KEYS:
            raise ValueError(
                f"strategy={strategy!r}: unknown option {k!r} (no strategy "
                f"accepts it); known options: "
                f"{tuple(sorted(KNOWN_OPTION_KEYS))}")
    bad = sorted(k for k in opts if k not in allowed)
    if bad:
        raise ValueError(
            f"option(s) {bad} do not apply to strategy {strategy!r} "
            f"(accepts {tuple(allowed)})")
    return opts
