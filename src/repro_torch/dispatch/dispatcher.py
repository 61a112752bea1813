"""Dispatcher: ``strategy="auto"`` resolved in exactly one place.

The counterpart of ``repro.dispatch.dispatcher``.  State machine per
``(GeomStatic, backend, device_kind)`` key (on the card ``("cuda",
<card name>)``):

1. **Cache hit**: a schema-current :class:`TunedConfig` exists under the
   port's tune directory (``.repro_torch_tune/``, or the in-process
   memo) and passes the audit against today's planner
   (:func:`repro_torch.tune.audit.audit_tuned_config`): resolution is a
   lookup, no timing work.
2. **In-situ first-call selection**: no usable decision, in-situ on (the
   default; ``REPRO_TORCH_DISPATCH_INSITU=0`` turns it off) and the
   caller holds a full :class:`Geometry`: time a deterministic shortlist
   once each (:func:`repro_torch.tune.sweep.sweep_strategies`, one
   warm-up and one sample per candidate, every candidate's windows
   checked over all of the geometry's matrices on the device's
   planner), persist the winner and log the selection.  Every later
   call, in this process or another, is a lookup.
3. **Fallback**: selection unavailable (off, or only a bare
   ``GeomStatic`` in hand): one structured warning naming the key, then
   the untimed ``strip2`` default.

The timing problem is made from the geometry by the sweep (white noise
at the mid-sweep angle), so a streaming engine resolves at construction,
before any projection arrives.
"""

from __future__ import annotations

import functools
import logging
import os
import time

from ..core.backproject import DEFAULT_PBATCH, STRATEGIES, GeomStatic
from ..core.geometry import Geometry
from ..tune.cache import (_PALLAS_KEYS, DEFAULT_STRATEGY, TunedConfig,
                          cache_key, device_identity, filter_strategy_opts,
                          load_tuned, store_tuned, tune_dir)
from ..tune.space import Candidate, jnp_candidates, pallas_candidates
from .plan import ExecutionPlan

__all__ = ["INSITU_ENV", "Dispatcher", "get_dispatcher", "insitu_candidates",
           "reset_dispatcher", "set_dispatcher"]

logger = logging.getLogger("repro_torch.dispatch")

#: Environment switch for first-call selection.  Unset/``1`` = enabled.
INSITU_ENV = "REPRO_TORCH_DISPATCH_INSITU"

# Shortlist order for the strategy families: the likeliest winner first
# (scalar, the known-slow oracle, last).
_JNP_PREFERENCE = ("strip2", "gather", "strip", "onehot", "scalar")


def insitu_candidates(gs: GeomStatic, *, topk: int = 7,
                      include_pallas: bool = False) -> list[Candidate]:
    """Deterministic first-call shortlist for one geometry.

    One representative per strategy family (the first point of
    :func:`jnp_candidates` at :data:`DEFAULT_PBATCH`, preference-ordered)
    plus the bf16- and int8-wire strip2 competitors, truncated to
    ``topk``; with ``include_pallas`` the projection-batched kernel
    configurations ride along (their own ``topk`` budget).  A function
    of ``gs`` alone, so two processes shortlist identically.
    """
    topk = max(1, int(topk))
    by_key: dict[tuple[str, str], Candidate] = {}
    for cand in jnp_candidates(gs, pbatches=(DEFAULT_PBATCH,)):
        dtype = str(dict(cand.opts).get("strip_dtype", "float32"))
        by_key.setdefault((cand.strategy, dtype), cand)
    order = [(s, "float32") for s in _JNP_PREFERENCE]
    order += [("strip2", "bfloat16"), ("strip2", "int8")]
    picked = [by_key[k] for k in order if k in by_key][:topk]
    if include_pallas:
        batched = [c for c in pallas_candidates(gs,
                                                pbatches=(DEFAULT_PBATCH,))
                   if c.pbatch > 1]
        picked += batched[:topk]
    return picked


class Dispatcher:
    """Resolve execution plans; own the first-call selection policy.

    ``insitu=None`` reads :data:`INSITU_ENV` at resolve time (default
    on); ``include_pallas=None`` times the kernel candidates where they
    run, on a CUDA backend.  The backend defaults to ``"cuda"`` where a
    card is visible, else ``"cpu"``; the sweep times on that device.
    ``sweep_fn`` is injectable for tests: it must accept ``(geom, *,
    space, warmup, iters, min_total_s)`` and return a
    :class:`repro_torch.tune.sweep.SweepResult`.
    """

    def __init__(self, *, dirpath=None, insitu: bool | None = None,
                 topk: int = 7, include_pallas: bool | None = None,
                 sweep_fn=None, backend: str | None = None,
                 device_kind: str | None = None):
        self.dirpath = dirpath
        self.insitu = insitu
        self.topk = int(topk)
        self.include_pallas = include_pallas
        self._sweep_fn = sweep_fn
        self.backend, self.device_kind = device_identity(backend,
                                                         device_kind)
        self.device = "cuda" if self.backend == "cuda" else "cpu"
        self._warned: set[tuple[str, str]] = set()
        self._audited: dict[tuple, bool] = {}

    # ------------------------------------------------------------------
    # Public surface
    # ------------------------------------------------------------------
    def resolve(self, geom: Geometry | GeomStatic, strategy: str = "auto",
                opts: dict | None = None, *,
                pbatch: int | None = None) -> ExecutionPlan:
        """One plan for one call site: the only ``auto`` resolver.

        Explicit strategies validate strictly and never touch the cache;
        ``auto`` walks the hit -> in-situ -> fallback machine of the
        module docstring.
        """
        if strategy != "auto":
            return ExecutionPlan.explicit(strategy, opts, pbatch)
        gs, full_geom = self._split(geom)
        cfg, source = self._lookup_or_select(gs, full_geom)
        if cfg is None:
            self._warn_fallback(gs, surface="jnp")
            plan = self._fallback_plan(opts, pbatch)
        else:
            plan = ExecutionPlan.from_tuned(cfg, opts, pbatch)
        logger.debug("dispatch: key=%s via %s -> %s",
                     cache_key(gs, self.backend, self.device_kind),
                     source, plan.label)
        return plan

    def resolve_kernel(self, geom: Geometry | GeomStatic) -> dict | None:
        """Tuned kernel config for this key as keyword arguments, or
        ``None`` (the caller's explicit keywords stand; with no decision
        at all, after the same one-time warning as :meth:`resolve`)."""
        gs, full_geom = self._split(geom)
        cfg, _source = self._lookup_or_select(gs, full_geom)
        if cfg is None:
            self._warn_fallback(gs, surface="kernel")
            return None
        if not cfg.pallas:
            return None
        return {k: cfg.pallas[k] for k in _PALLAS_KEYS if k in cfg.pallas}

    # ------------------------------------------------------------------
    # Resolution machinery
    # ------------------------------------------------------------------
    @staticmethod
    def _split(geom):
        if isinstance(geom, GeomStatic):
            return geom, None
        return GeomStatic.of(geom), geom

    def _insitu_enabled(self) -> bool:
        if self.insitu is not None:
            return bool(self.insitu)
        flag = os.environ.get(INSITU_ENV, "1").strip().lower()
        return flag not in ("0", "false", "off", "")

    def _include_pallas(self) -> bool:
        if self.include_pallas is not None:
            return bool(self.include_pallas)
        return self.backend == "cuda"

    def _lookup_or_select(self, gs, full_geom):
        cfg = load_tuned(gs, self.backend, self.device_kind, self.dirpath)
        if cfg is not None:
            if self._audit_ok(gs, cfg, full_geom):
                return cfg, "cache"
            cfg = None                 # stale decision: never replay it
        if full_geom is not None and self._insitu_enabled():
            cfg = self._select(full_geom)
            if cfg is not None:
                return cfg, "insitu"
        return None, "fallback"

    def _audit_ok(self, gs, cfg, full_geom) -> bool:
        """Re-check a cached decision against today's planner before
        replaying it.  A failing decision gives ONE structured warning
        naming key, file and every reason, and resolution falls through
        to in-situ selection."""
        from ..tune.audit import audit_tuned_config

        memo_key = (cache_key(gs, self.backend, self.device_kind),
                    cfg.strategy, tuple(sorted((cfg.opts or {}).items())),
                    tuple(sorted((cfg.pallas or {}).items())),
                    full_geom is not None)
        hit = self._audited.get(memo_key)
        if hit is not None:
            return hit
        reasons = audit_tuned_config(gs, cfg, geom=full_geom,
                                     device=self.device)
        self._audited[memo_key] = not reasons
        if not reasons:
            return True
        key = cache_key(gs, self.backend, self.device_kind)
        if ("audit", key) not in self._warned:
            self._warned.add(("audit", key))
            d = self.dirpath if self.dirpath is not None else tune_dir()
            logger.warning(
                "dispatch: cached decision for key=%s (file %s) fails "
                "the current planner and will not be replayed: %s — "
                "falling back to in-situ selection; delete the file or "
                "re-run repro_torch.tune.autotune to refresh it",
                key, os.path.join(d, f"{key}.json"), "; ".join(reasons))
        return False

    def _select(self, geom: Geometry) -> TunedConfig | None:
        """First-call selection: time the shortlist once, persist."""
        gs = GeomStatic.of(geom)
        key = cache_key(gs, self.backend, self.device_kind)
        space = insitu_candidates(gs, topk=self.topk,
                                  include_pallas=self._include_pallas())
        if not space:
            return None
        sweep = self._sweep_fn
        if sweep is None:
            from ..tune.sweep import sweep_strategies

            sweep = functools.partial(sweep_strategies, device=self.device)
        t0 = time.perf_counter()
        res = sweep(geom, space=space, warmup=1, iters=1, min_total_s=0.0)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        best = res.best(STRATEGIES)
        if best is None:
            logger.warning(
                "dispatch: in-situ selection for key=%s timed no valid "
                "strategy candidate (skipped: %s); falling back", key,
                res.skipped)
            return None
        best_pallas = res.best(("pallas",))
        cfg = TunedConfig(
            strategy=best.strategy, opts=dict(best.opts),
            backend=self.backend, device_kind=self.device_kind,
            us_per_call=best.us_per_call,
            pallas=dict(best_pallas.opts) if best_pallas else None,
            pallas_us=best_pallas.us_per_call if best_pallas else None,
            timings=[t.as_dict() for t in res.timings])
        path = store_tuned(gs, cfg, self.dirpath)
        logger.info(
            "dispatch: in-situ selection key=%s candidates=%d skipped=%d "
            "elapsed_ms=%.0f winner=%s us_per_proj=%.1f kernel=%s "
            "persisted=%s", key, len(res.timings), len(res.skipped),
            elapsed_ms, best.label, best.us_per_call,
            best_pallas.label if best_pallas else None, path)
        return cfg

    def _fallback_plan(self, opts, pbatch) -> ExecutionPlan:
        filtered = filter_strategy_opts(DEFAULT_STRATEGY, opts,
                                        strict=False, context="dispatch")
        if pbatch is None:
            pbatch = int(filtered.pop("pbatch", DEFAULT_PBATCH))
        else:
            filtered.pop("pbatch", None)
        return ExecutionPlan(strategy=DEFAULT_STRATEGY,
                             opts=tuple(sorted(filtered.items())),
                             pbatch=max(1, int(pbatch)))

    def _warn_fallback(self, gs, *, surface: str) -> None:
        """One structured warning per (surface, key) per dispatcher,
        naming the key, the tune directory consulted and the untimed
        default taken."""
        key = cache_key(gs, self.backend, self.device_kind)
        if (surface, key) in self._warned:
            return
        self._warned.add((surface, key))
        d = self.dirpath if self.dirpath is not None else tune_dir()
        default = (f"strategy={DEFAULT_STRATEGY!r}" if surface == "jnp"
                   else "the caller's explicit kernel parameters")
        logger.warning(
            "dispatch: no tuned decision for key=%s under %s and "
            "in-situ selection is unavailable (%s=0, or no full "
            "Geometry at the call site); falling back to untimed "
            "default %s — run repro_torch.tune.autotune or enable "
            "in-situ selection to replace this guess with a measured "
            "winner", key, d, INSITU_ENV, default)


# ----------------------------------------------------------------------
# Process-wide dispatcher
# ----------------------------------------------------------------------

_DISPATCHER: Dispatcher | None = None


def get_dispatcher() -> Dispatcher:
    """The process-wide dispatcher (created lazily with defaults)."""
    global _DISPATCHER
    if _DISPATCHER is None:
        _DISPATCHER = Dispatcher()
    return _DISPATCHER


def set_dispatcher(d: Dispatcher | None) -> Dispatcher | None:
    """Swap the process-wide dispatcher; returns the previous one."""
    global _DISPATCHER
    old = _DISPATCHER
    _DISPATCHER = d
    return old


def reset_dispatcher() -> None:
    """Drop the process-wide dispatcher (tests; tune-dir swaps)."""
    set_dispatcher(None)
