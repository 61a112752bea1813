"""ExecutionPlan: the one frozen description of how a reconstruction runs.

The counterpart of ``repro.dispatch.plan``: the strategy, its sample
options and the projection batch depth, in one hashable value that the
engine and the fold consume.  Only explicitly named strategies are
ported: ``strategy="auto"`` (the dispatcher and the tuned cache) raises,
and the reference's tuned-kernel fields (``pallas``, ``use_pallas``)
have no counterpart yet.
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.backproject import DEFAULT_PBATCH, STRATEGIES, strip_wire_dtype
from ..tune.cache import filter_strategy_opts

__all__ = ["ExecutionPlan"]


class ExecutionPlan(NamedTuple):
    """Frozen, hashable resolution of one reconstruction configuration.

    * ``strategy``: one of :data:`repro_torch.core.backproject.STRATEGIES`.
    * ``opts``: sorted ``(key, value)`` pairs of the strategy's options
      (``pbatch`` lives in its own field).
    * ``pbatch``: projections folded per volume pass.
    """

    strategy: str
    opts: tuple = ()
    pbatch: int = DEFAULT_PBATCH

    @classmethod
    def explicit(cls, strategy: str, opts: dict | None = None,
                 pbatch: int | None = None) -> "ExecutionPlan":
        """Plan for an explicitly named strategy, strictly validated.

        Unknown option keys raise, and so do known keys the strategy
        does not take, and an unknown ``strip_dtype``.  ``pbatch`` may
        ride in ``opts``.
        """
        if strategy == "auto":
            raise ValueError(
                "strategy 'auto' is not ported (it needs the dispatcher "
                "and the tuned cache); name one of " + str(STRATEGIES))
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; want one of "
                             f"{STRATEGIES}")
        opts = dict(opts or {})
        if pbatch is None:
            pbatch = int(opts.pop("pbatch", DEFAULT_PBATCH))
        else:
            opts.pop("pbatch", None)
        opts = filter_strategy_opts(strategy, opts)
        if "strip_dtype" in opts:
            strip_wire_dtype(str(opts["strip_dtype"]))
        return cls(strategy=strategy, opts=tuple(sorted(opts.items())),
                   pbatch=max(1, int(pbatch)))

    def jnp_opts(self) -> dict:
        """The strategy's sample options as keyword arguments (the
        reference's name)."""
        return dict(self.opts)

    @property
    def strip_dtype(self) -> str:
        """The projection wire: ``"float32"`` unless the options say."""
        return str(dict(self.opts).get("strip_dtype", "float32"))

    @property
    def label(self) -> str:
        txt = ",".join(f"{k}={v}" for k, v in self.opts)
        body = f"{self.strategy}[{txt}]" if txt else self.strategy
        return f"{body}@p{self.pbatch}"

    def as_dict(self) -> dict:
        return {"strategy": self.strategy, "opts": dict(self.opts),
                "pbatch": self.pbatch}
