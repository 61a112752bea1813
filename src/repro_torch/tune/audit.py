"""Audit of a cached decision against today's planner.

The port's copy of the logic of ``repro.analysis.lint.cache_audit.
audit_tuned_config``, which the dispatcher runs before it replays a
cached decision: the static checks (strategy and option keys, wires, the
kernel's shared-memory bytes), then, with the full geometry, the strip
planner over an even sample of the scan's matrices, exactly as the
wrappers would check them.  A decision tuned before a planner or kernel
change can be schema-current and still name a window the planner now
proves too small; the dispatcher must not replay it.  (The reference's
lint tool around this function is not ported.)
"""

from __future__ import annotations

import numpy as np

from ..core.backproject import STRATEGIES, GeomStatic, validate_strip_opts
from ..kernels.backproject import SMEM_LIMIT
from .cache import _PALLAS_KEYS, _STRATEGY_KEYS
from .space import WIRE_ITEMSIZE, kernel_smem_bytes

__all__ = ["audit_tuned_config"]

# Matrices of the scan the planner re-checks: the footprint extremes move
# smoothly with the angle, so an even angular sample bounds them.
_MAX_AUDIT_MATS = 8


def _sampled_matrices(geom):
    from ..core.geometry import projection_matrices

    mats = np.asarray(projection_matrices(geom), np.float64)
    if len(mats) > _MAX_AUDIT_MATS:
        idx = np.linspace(0, len(mats) - 1, _MAX_AUDIT_MATS).astype(int)
        mats = mats[idx]
    return mats


def audit_tuned_config(gs: GeomStatic, cfg, geom=None,
                       device=None) -> list:
    """Reasons this TunedConfig must not be replayed; empty when sound.

    Static checks always run; with a full ``geom`` the planner (on
    ``device``; default the CPU) re-checks the strategy's window and the
    kernel's windows as the wrappers would: the tile and micro windows
    (none for row 1 without tiling keywords), or, for K5, only its shared
    window (the reference also checks a shared config's tile, a window K5
    never reads, so a shared decision the sweep chose would fail its own
    audit).
    """
    reasons = []
    if cfg.strategy not in STRATEGIES:
        reasons.append(f"strategy {cfg.strategy!r} is not a known "
                       f"strategy {STRATEGIES}")
        return reasons
    allowed = _STRATEGY_KEYS[cfg.strategy]
    opts = dict(cfg.opts or {})
    stray = sorted(k for k in opts if k not in allowed)
    if stray:
        reasons.append(f"opts {stray} are not accepted by strategy "
                       f"{cfg.strategy!r} — the resolver would shed them")
    wire = opts.get("strip_dtype", "float32")
    if wire not in WIRE_ITEMSIZE:
        reasons.append(f"opts strip_dtype {wire!r} is not a known wire "
                       f"dtype {tuple(WIRE_ITEMSIZE)}")
    pallas = dict(cfg.pallas or {})
    pwire_ok = pallas.get("strip_dtype", "float32") in WIRE_ITEMSIZE
    if pallas:
        stray = sorted(k for k in pallas if k not in _PALLAS_KEYS)
        if stray:
            reasons.append(f"pallas keys {stray} are unknown to the "
                           f"kernel config surface {_PALLAS_KEYS}")
        if not pwire_ok:
            reasons.append(f"pallas strip_dtype "
                           f"{pallas.get('strip_dtype')!r} is not a known "
                           f"wire dtype {tuple(WIRE_ITEMSIZE)}")
        else:
            smem = kernel_smem_bytes(gs, pallas)
            if smem > SMEM_LIMIT:
                reasons.append(
                    f"pallas config needs {smem} B of shared memory per "
                    f"block; the card offers {SMEM_LIMIT} B")
    if geom is None:
        return reasons

    mats = _sampled_matrices(geom)
    try:
        validate_strip_opts(geom, mats, cfg.strategy,
                            {k: v for k, v in opts.items() if k in allowed},
                            device=device)
    except ValueError as e:
        reasons.append(f"strategy window fails the current planner: {e}")
    if pallas and pwire_ok:
        from ..kernels.backproject_ops import (check_variant_windows,
                                               clamp_tiles,
                                               shared_window_dims)

        if pallas.get("shared_window", False):
            # K5 reads only its superset window: size it over the group.
            ty, chunk, _, _ = clamp_tiles(
                gs, int(pallas.get("ty", 8)), int(pallas.get("chunk", 128)),
                16, 512)
            try:
                shared_window_dims(
                    geom, mats, ty=ty, chunk=chunk,
                    pbatch=max(1, int(pallas.get("pbatch", 1))),
                    shared_band=pallas.get("shared_band"),
                    shared_width=pallas.get("shared_width"), device=device)
            except ValueError as e:
                reasons.append(
                    f"shared window fails the current planner: {e}")
        else:
            try:
                check_variant_windows(geom, mats, pallas, device=device)
            except ValueError as e:
                reasons.append(f"pallas tile fails the current planner: "
                               f"{e}")
    return reasons
