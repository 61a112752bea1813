"""ExecutionPlan: the one frozen description of how a reconstruction runs.

The counterpart of ``repro.dispatch.plan``: the resolved strategy and
its options, the projection batch depth, and the tuned kernel config
with the flag that says whether it beat the strategies, in one hashable
value the engine and the folds consume.  Plans come from an explicitly
named strategy (:meth:`ExecutionPlan.explicit`) or from a tuned decision
(:meth:`ExecutionPlan.from_tuned`, which the dispatcher calls for
``strategy="auto"``).
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.backproject import DEFAULT_PBATCH, STRATEGIES, strip_wire_dtype
from ..tune.cache import (_PALLAS_KEYS, _STRATEGY_KEYS, DEFAULT_STRATEGY,
                          TunedConfig, filter_strategy_opts)

__all__ = ["ExecutionPlan"]


class ExecutionPlan(NamedTuple):
    """Frozen, hashable resolution of one reconstruction configuration.

    * ``strategy``: one of :data:`repro_torch.core.backproject.STRATEGIES`
      (never ``"auto"``).
    * ``opts``: sorted ``(key, value)`` pairs of the strategy's options
      (``pbatch`` lives in its own field).
    * ``pbatch``: projections folded per volume pass.
    * ``pallas``: sorted ``(key, value)`` pairs of the tuned kernel
      config, or ``None``.  The field keeps the reference's name so that
      plans compare field by field with the reference's; here it names
      the CUDA kernel's keywords (:mod:`repro_torch.kernels.
      backproject_ops`: row 1 with a tile, K3 ``strip_db``, K4
      ``strip_micro`` or K5 ``strip_shared``, and the wire).
    * ``use_pallas``: True when the tuned evidence says that kernel
      config beat the best strategy (``pallas_us < us_per_call``); the
      folds then run it.

    Provenance (cache hit, in-situ selection or fallback) is not a
    field: identical configurations compare equal.  The dispatcher logs
    where a plan came from instead.
    """

    strategy: str
    opts: tuple = ()
    pbatch: int = DEFAULT_PBATCH
    pallas: tuple | None = None
    use_pallas: bool = False

    @classmethod
    def explicit(cls, strategy: str, opts: dict | None = None,
                 pbatch: int | None = None) -> "ExecutionPlan":
        """Plan for an explicitly named strategy, strictly validated.

        Unknown option keys raise, and so do known keys the strategy
        does not take, and an unknown ``strip_dtype``.  ``pbatch`` may
        ride in ``opts``.  ``"auto"`` is not a strategy: the dispatcher
        resolves it.
        """
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r}; want one of {STRATEGIES} "
                f"(or 'auto', resolved via repro_torch.dispatch.Dispatcher)")
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

    @classmethod
    def from_tuned(cls, cfg: TunedConfig, caller_opts: dict | None = None,
                   pbatch: int | None = None) -> "ExecutionPlan":
        """Plan from a cached :class:`TunedConfig` and caller overrides.

        Caller options override tuned ones per key; options the tuned
        strategy does not take are shed with a warning (the cache may
        have resolved another strategy than the caller's options were
        written for); unknown keys raise.
        """
        strategy = (cfg.strategy if cfg.strategy in STRATEGIES
                    else DEFAULT_STRATEGY)
        allowed = _STRATEGY_KEYS[strategy]
        merged = {k: v for k, v in dict(cfg.opts).items() if k in allowed}
        merged.update(filter_strategy_opts(strategy, caller_opts,
                                           strict=False, context="dispatch"))
        if pbatch is None:
            pbatch = int(merged.pop("pbatch", DEFAULT_PBATCH))
        else:
            merged.pop("pbatch", None)
        if "strip_dtype" in merged:
            strip_wire_dtype(str(merged["strip_dtype"]))
        pallas = None
        if cfg.pallas:
            pallas = tuple(sorted(
                (k, cfg.pallas[k]) for k in _PALLAS_KEYS if k in cfg.pallas))
        use_pallas = bool(
            pallas and cfg.pallas_us is not None
            and cfg.us_per_call is not None
            and cfg.pallas_us < cfg.us_per_call)
        return cls(strategy=strategy, opts=tuple(sorted(merged.items())),
                   pbatch=max(1, int(pbatch)), pallas=pallas,
                   use_pallas=use_pallas)

    def jnp_opts(self) -> dict:
        """The strategy's options as keyword arguments (the reference's
        name)."""
        return dict(self.opts)

    def pallas_opts(self) -> dict | None:
        """The tuned kernel config as keyword arguments, or ``None``."""
        return dict(self.pallas) if self.pallas else None

    @property
    def strip_dtype(self) -> str:
        """The strategy's projection wire: ``"float32"`` unless the
        options say."""
        return str(dict(self.opts).get("strip_dtype", "float32"))

    @property
    def label(self) -> str:
        txt = ",".join(f"{k}={v}" for k, v in self.opts)
        body = f"{self.strategy}[{txt}]" if txt else self.strategy
        tail = "+pallas" if self.use_pallas else ""
        return f"{body}@p{self.pbatch}{tail}"

    def as_dict(self) -> dict:
        return {"strategy": self.strategy, "opts": dict(self.opts),
                "pbatch": self.pbatch,
                "pallas": dict(self.pallas) if self.pallas else None,
                "use_pallas": self.use_pallas}
