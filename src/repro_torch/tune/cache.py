"""TunedConfig cache: per-(geometry, backend, device) strategy decisions.

The counterpart of ``repro.tune.cache``.  A tuned decision is keyed on
``(GeomStatic, backend, device_kind)`` — on the card ``("cuda",
torch.cuda.get_device_name())`` — because the winning scheme is a
property of the device, not of the algorithm.  Decisions persist as one
JSON file per key under ``.repro_torch_tune/`` (override with
``REPRO_TORCH_TUNE_DIR``): the port keeps its own directory, apart from
the reference's ``.repro_tune/``, whose files the reference's lint tool
audits.  An in-process dict memoises hits.

``strategy="auto"`` consumers resolve through the dispatcher
(:mod:`repro_torch.dispatch`), which reads this cache; the helpers here
(:func:`resolve_strategy`, :func:`resolve_pallas_config`) fall back to
the untuned defaults when the key was never tuned.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from pathlib import Path

import torch

from ..core.backproject import DEFAULT_PBATCH, STRATEGIES, GeomStatic

__all__ = ["DEFAULT_STRATEGY", "KNOWN_OPTION_KEYS", "TUNE_DIR_ENV",
           "TUNE_SCHEMA_VERSION", "TunedConfig", "autotune", "cache_key",
           "clear_memory_cache", "device_identity", "filter_strategy_opts",
           "load_tuned", "resolve_pallas_config", "resolve_strategy",
           "store_tuned", "tune_dir"]

# What "auto" means before anyone has tuned.
DEFAULT_STRATEGY = "strip2"

# Bumped whenever the persisted TunedConfig layout or the meaning of a
# decision changes; load_tuned treats any other version as untuned, so a
# stale file is ignored, never misread.  (The port's cache has its own
# directory and its own count.)
TUNE_SCHEMA_VERSION = 1

# Environment override of the cache directory.
TUNE_DIR_ENV = "REPRO_TORCH_TUNE_DIR"

# The kernel-config keys a decision carries (the reference's names; on
# the card they are the CUDA kernels' keywords,
# repro_torch.kernels.backproject_ops).  ``micro_*`` ride with
# ``micro``, ``db_depth`` with ``double_buffer`` and ``shared_band``/
# ``shared_width`` with ``shared_window``: a decision was checked and
# timed at those values.  ``strip_dtype`` is its wire.
_PALLAS_KEYS = ("ty", "chunk", "band", "width", "double_buffer",
                "db_depth", "micro", "micro_group", "micro_band",
                "micro_width", "shared_window", "shared_band",
                "shared_width", "strip_dtype", "pbatch")

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


def filter_strategy_opts(strategy: str, opts: dict | None, *,
                         strict: bool = True,
                         context: str | None = None) -> dict:
    """The options ``strategy`` accepts, validated.

    A key no strategy accepts always raises: a typo'd option is never
    dropped.  A known key this strategy does not take raises too
    (``strict=True``: a strategy the caller named), or is shed with a
    ``RuntimeWarning`` (``strict=False``: ``"auto"``, where the cache
    may have resolved another strategy than the one the caller's options
    were written for).
    """
    context = context or f"strategy={strategy!r}"
    allowed = _STRATEGY_KEYS[strategy]
    opts = dict(opts or {})
    for k in opts:
        if k not in KNOWN_OPTION_KEYS:
            raise ValueError(
                f"{context}: unknown option {k!r} (no strategy accepts "
                f"it); known options: {tuple(sorted(KNOWN_OPTION_KEYS))}")
    shed = sorted(k for k in opts if k not in allowed)
    if shed:
        msg = (f"{context}: option(s) {shed} do not apply to strategy "
               f"{strategy!r} (accepts {tuple(allowed)})")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg + "; shedding them", RuntimeWarning,
                      stacklevel=3)
    return {k: v for k, v in opts.items() if k in allowed}


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One cached decision plus the sweep evidence behind it."""

    strategy: str                   # best strategy (in STRATEGIES)
    opts: dict                      # its options (incl. ``pbatch``)
    backend: str
    device_kind: str
    us_per_call: float              # best strategy's time per projection
    pallas: dict | None = None      # best kernel config, when swept
    pallas_us: float | None = None
    timings: list = dataclasses.field(default_factory=list)
    version: int = TUNE_SCHEMA_VERSION

    @property
    def pbatch(self) -> int:
        """Projection batch depth of the winning strategy."""
        return int(self.opts.get("pbatch", DEFAULT_PBATCH))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def tune_dir() -> Path:
    """The cache directory: ``$REPRO_TORCH_TUNE_DIR`` or
    ``.repro_torch_tune``."""
    return Path(os.environ.get(TUNE_DIR_ENV, ".repro_torch_tune"))


def _sanitize(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "-", s)


def device_identity(backend: str | None = None,
                    device_kind: str | None = None) -> tuple[str, str]:
    """The ``(backend, device_kind)`` pair cache keys are built from:
    ``("cuda", <card name>)`` where a card is visible, else ``("cpu",
    "cpu")``."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name() if backend == "cuda"
                       else backend)
    return backend, device_kind


def cache_key(gs: GeomStatic, backend: str, device_kind: str) -> str:
    geom = (f"ct-L{gs.L}-u{gs.n_u}-v{gs.n_v}"
            f"-O{gs.O:g}-MM{gs.MM:g}")
    return f"{geom}--{_sanitize(backend)}--{_sanitize(device_kind)}"


_MEM: dict[tuple[str, str], TunedConfig] = {}


def clear_memory_cache() -> None:
    """Drop in-process memoised decisions (tests; tune-dir swaps)."""
    _MEM.clear()


def _dir(dirpath) -> Path:
    return Path(dirpath) if dirpath is not None else tune_dir()


def store_tuned(gs: GeomStatic, cfg: TunedConfig,
                dirpath: str | os.PathLike | None = None) -> Path:
    d = _dir(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    key = cache_key(gs, cfg.backend, cfg.device_kind)
    path = d / f"{key}.json"
    path.write_text(json.dumps(cfg.as_dict(), indent=2, sort_keys=True))
    _MEM[(str(d), key)] = cfg
    return path


def load_tuned(gs: GeomStatic, backend: str | None = None,
               device_kind: str | None = None,
               dirpath: str | os.PathLike | None = None
               ) -> TunedConfig | None:
    backend, device_kind = device_identity(backend, device_kind)
    d = _dir(dirpath)
    key = cache_key(gs, backend, device_kind)
    hit = _MEM.get((str(d), key))
    if hit is not None:
        return hit
    path = d / f"{key}.json"
    if not path.is_file():
        return None
    try:
        data = json.loads(path.read_text())
        if (not isinstance(data, dict)
                or data.get("version") != TUNE_SCHEMA_VERSION):
            return None             # stale schema: ignored, not misread
        cfg = TunedConfig(**data)
    except (json.JSONDecodeError, TypeError, ValueError):
        return None                 # corrupt cache file: treat as untuned
    _MEM[(str(d), key)] = cfg
    return cfg


# ----------------------------------------------------------------------
# "auto" resolution
# ----------------------------------------------------------------------

def resolve_strategy(gs: GeomStatic, opts: dict | None = None, *,
                     backend: str | None = None,
                     device_kind: str | None = None,
                     dirpath: str | os.PathLike | None = None
                     ) -> tuple[str, dict]:
    """Map ``strategy="auto"`` to a concrete strategy and its options.

    Untuned keys fall back to :data:`DEFAULT_STRATEGY` with the caller's
    options.  Explicitly passed options override tuned ones per key, but
    only those the resolved strategy accepts survive; shedding is loud
    (:func:`filter_strategy_opts`, ``strict=False``).
    """
    cfg = load_tuned(gs, backend, device_kind, dirpath)
    if cfg is None or cfg.strategy not in STRATEGIES:
        strategy, merged = DEFAULT_STRATEGY, {}
    else:
        strategy = cfg.strategy
        allowed = _STRATEGY_KEYS[strategy]
        merged = {k: v for k, v in dict(cfg.opts).items() if k in allowed}
    merged.update(filter_strategy_opts(strategy, opts, strict=False,
                                       context="resolve_strategy"))
    return strategy, merged


def resolve_pallas_config(gs: GeomStatic, *, backend: str | None = None,
                          device_kind: str | None = None,
                          dirpath: str | os.PathLike | None = None
                          ) -> dict | None:
    """Tuned kernel config for this key, or ``None`` when untuned."""
    cfg = load_tuned(gs, backend, device_kind, dirpath)
    if cfg is None or not cfg.pallas:
        return None
    return {k: cfg.pallas[k] for k in _PALLAS_KEYS if k in cfg.pallas}


# ----------------------------------------------------------------------
# End-to-end: sweep this geometry, persist the decision
# ----------------------------------------------------------------------

def autotune(geom, *, image=None, A=None, space=None,
             include_pallas: bool | None = None, warmup: int = 1,
             iters: int = 3, min_total_s: float | None = None,
             dirpath: str | os.PathLike | None = None,
             device="cuda") -> TunedConfig:
    """Sweep ``geom`` on ``device`` and cache the winner."""
    from .sweep import sweep_strategies    # lazy: keeps cache import light

    res = sweep_strategies(geom, image=image, A=A, space=space,
                           include_pallas=include_pallas, warmup=warmup,
                           iters=iters, min_total_s=min_total_s,
                           device=device)
    best = res.best(STRATEGIES)
    if best is None:
        raise RuntimeError(
            "autotune swept no valid strategy candidate for this "
            f"geometry; skipped: {res.skipped}")
    best_pallas = res.best(("pallas",))
    cfg = TunedConfig(
        strategy=best.strategy, opts=dict(best.opts),
        backend=res.backend, device_kind=res.device_kind,
        us_per_call=best.us_per_call,
        pallas=dict(best_pallas.opts) if best_pallas else None,
        pallas_us=best_pallas.us_per_call if best_pallas else None,
        timings=[t.as_dict() for t in res.timings])
    store_tuned(GeomStatic.of(geom), cfg, dirpath)
    return cfg
