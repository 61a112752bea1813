"""FDK projection preprocessing: cosine weighting + ramp filtering.

The port's counterpart of ``repro.core.filtering``.  The weight tables
(:func:`ramlak_kernel`, :func:`cosine_weights`, :func:`parker_weights`)
are the reference's numpy host precompute, copied; the filter itself
runs on tensors on the plan's device through ``torch.fft.rfft`` /
``irfft`` (the reference leaves its FFT to XLA, outside any kernel).

1. **Cosine weighting**: each ray is scaled by
   ``sdd / sqrt(sdd^2 + u^2 + v^2)``.
2. **Ramp filter** along detector rows, the band-limited Ram-Lak kernel
   applied via FFT with zero padding to the next power of two
   ``>= 2*n_u`` (linear, not circular, convolution).
3. **FDK constant** ``delta_theta * (sdd / (2 * sid)) * du``; short
   scans (RabbitCT's 200 degree C-arm) get Parker weights, selected by
   *angle index*.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import as_f32, resolve_device
from .geometry import Geometry

__all__ = ["ramlak_kernel", "cosine_weights", "parker_weights",
           "FilterPlan", "make_filter_plan", "apply_filter",
           "filter_projections"]


def ramlak_kernel(n: int, du: float) -> np.ndarray:
    """Band-limited Ram-Lak kernel ``h[-n//2 : n-n//2]`` (spatial domain).

    Kak & Slaney eq. 61: ``h[0] = 1/(4 du^2)``, ``h[k] = -1/(pi k du)^2``
    for odd ``k``, else 0.
    """
    k = np.arange(-(n // 2), n - n // 2)
    h = np.zeros(n, dtype=np.float64)
    h[k == 0] = 1.0 / (4.0 * du * du)
    odd = (np.abs(k) % 2) == 1
    h[odd] = -1.0 / (np.pi * k[odd] * du) ** 2
    return h


def cosine_weights(geom: Geometry) -> np.ndarray:
    """Cone-beam obliquity weights, shape ``(n_v, n_u)`` (host precompute)."""
    u = (np.arange(geom.n_u) - geom.cu) * geom.du
    v = (np.arange(geom.n_v) - geom.cv) * geom.dv
    uu, vv = np.meshgrid(u, v)
    return (geom.sdd / np.sqrt(geom.sdd ** 2 + uu ** 2 + vv ** 2)).astype(
        np.float32)


def parker_weights(geom: Geometry) -> np.ndarray:
    """Parker short-scan weights, shape ``(n_proj, n_u)``.

    For a sweep of ``pi + 2*delta`` each ray is measured once or twice;
    Parker's smooth weights make the doubled wedge sum to one, while full
    ``2*pi`` scans reduce to the constant ``pi / sweep`` (net angular
    measure correct with the FDK ``1/2`` for any sweep).
    """
    u = (np.arange(geom.n_u) - geom.cu) * geom.du
    gamma = np.arctan2(u, geom.sdd)                       # (n_u,)
    delta = float(np.max(np.abs(gamma)))
    betas = geom.angles - geom.angles[0]                  # (n_proj,)
    sweep = float(geom.sweep)

    if sweep >= 2.0 * np.pi - 1e-9:
        return np.full((geom.n_proj, geom.n_u), 2.0 * np.pi / sweep,
                       dtype=np.float32)
    if sweep < np.pi + 2 * delta - 1e-9:
        # Not enough data for exact short-scan weighting: a flat
        # compensation keeps at least the DC level right.
        return np.full((geom.n_proj, geom.n_u), 2.0 * np.pi / sweep,
                       dtype=np.float32)

    b = betas[:, None]
    g = gamma[None, :]
    w = np.ones((geom.n_proj, geom.n_u), dtype=np.float64)
    up = b <= 2.0 * (delta - g)
    with np.errstate(invalid="ignore", divide="ignore"):
        w_up = np.sin(np.pi / 4.0 * b / (delta - g)) ** 2
    w = np.where(up, np.nan_to_num(w_up, nan=0.0), w)
    down = b >= np.pi - 2.0 * g
    with np.errstate(invalid="ignore", divide="ignore"):
        w_dn = np.sin(np.pi / 4.0 * (np.pi + 2 * delta - b)
                      / (delta + g)) ** 2
    w = np.where(down, np.nan_to_num(w_dn, nan=0.0), w)
    w = np.where(b > np.pi + 2 * delta, 0.0, w)
    # Parker weights assume the FDK 1/2 removed; the filter keeps it.
    return (2.0 * w).astype(np.float32)


class FilterPlan(NamedTuple):
    """Precomputed filter state for one geometry, as tensors on one
    device.

    ``parker`` is the *full* ``(n_proj, n_u)`` Parker table (or ``None``
    for full scans): a projection subset selects its rows by **angle
    index**, never by position in the subset.
    """

    pad: int                        # FFT length (power of two >= 2*n_u)
    n_u: int
    n_proj: int
    scale: float                    # FDK constant (delta * sdd/(2 sid) * du)
    hf: torch.Tensor                # (pad//2+1,) complex64 ramp spectrum
    cosw: torch.Tensor              # (n_v, n_u) float32 cosine weights
    parker: torch.Tensor | None     # (n_proj, n_u) float32, or None


def make_filter_plan(geom: Geometry, short_scan: bool | None = None, *,
                     device="cuda") -> FilterPlan:
    """Host precompute for :func:`apply_filter`, cached per (geometry,
    short_scan, device).

    ``short_scan`` adds the Parker table (default: on whenever the sweep
    is below ``2*pi``).  ``hf`` is complex64, as the reference's spectrum
    is with x64 off.
    """
    return _cached_plan(geom, short_scan, resolve_device(device))


@functools.lru_cache(maxsize=32)
def _cached_plan(geom: Geometry, short_scan, dev: torch.device):
    n_u = geom.n_u
    pad = 1
    while pad < 2 * n_u:
        pad *= 2
    h = np.roll(ramlak_kernel(pad, geom.du), -(pad // 2))  # zero lag at 0
    hf = torch.as_tensor(np.fft.rfft(h).astype(np.complex64), device=dev)
    cosw = torch.as_tensor(cosine_weights(geom), device=dev)
    if short_scan is None:
        short_scan = geom.sweep < 2.0 * np.pi - 1e-9
    parker = (torch.as_tensor(parker_weights(geom), device=dev)
              if short_scan else None)
    delta = float(geom.sweep / geom.n_proj)
    scale = delta * (geom.sdd / (2.0 * geom.sid)) * geom.du
    return FilterPlan(pad=pad, n_u=n_u, n_proj=geom.n_proj, scale=scale,
                      hf=hf, cosw=cosw, parker=parker)


def apply_filter(projections: torch.Tensor, plan: FilterPlan,
                 pw_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine + (optional per-row Parker) + ramp filter.

    ``projections`` is ``(k, n_v, n_u)`` float32 on the plan's device;
    ``pw_rows`` the matching ``(k, n_u)`` Parker rows (already *selected
    by angle index*), or ``None`` to skip short-scan weighting.
    """
    w = projections.to(torch.float32) * plan.cosw
    if pw_rows is not None:
        w = w * pw_rows[..., None, :]
    wf = torch.fft.rfft(w, n=plan.pad, dim=-1)
    f = torch.fft.irfft(wf * plan.hf, n=plan.pad, dim=-1)[..., :plan.n_u]
    return f * plan.scale


def filter_projections(projections, geom: Geometry,
                       short_scan: bool | None = None, angle_indices=None,
                       *, device="cuda") -> torch.Tensor:
    """Apply FDK weighting + ramp filter to ``(n_proj, n_v, n_u)`` rays
    (or one ``(n_v, n_u)`` image) on ``device``; returns float32.

    Parker weights depend on the projection *angle*, so a subset of the
    stack passes ``angle_indices`` (indices into ``geom.angles``, one per
    projection; a scalar for a single image).  A short-scan subset whose
    length differs from ``geom.n_proj`` without indices raises.
    """
    dev = resolve_device(device)
    plan = make_filter_plan(geom, short_scan, device=dev)
    projections = as_f32(projections, dev)
    single = projections.ndim == 2
    if single:
        projections = projections[None]
    k = projections.shape[0]

    pw_rows = None
    if angle_indices is not None:
        idx = np.atleast_1d(np.asarray(
            angle_indices.cpu() if torch.is_tensor(angle_indices)
            else angle_indices, dtype=np.int64))
        if idx.shape != (k,):
            raise ValueError(
                f"angle_indices has shape {idx.shape}; want ({k},) — one "
                f"angle index per projection")
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= geom.n_proj:
            raise ValueError(
                f"angle_indices must lie in [0, {geom.n_proj}); got "
                f"range [{lo}, {hi}]")
        if plan.parker is not None:
            pw_rows = plan.parker[torch.as_tensor(idx, device=dev)]
    elif plan.parker is not None:
        if k != geom.n_proj:
            raise ValueError(
                f"{k} projection(s) for a short-scan geometry with "
                f"n_proj={geom.n_proj}: a subset must pass angle_indices "
                f"(Parker weights depend on the projection angle; "
                f"guessing the first {k} angles silently mis-weights "
                f"every non-prefix subset).  Pass angle_indices=..., or "
                f"short_scan=False to skip Parker weighting.")
        pw_rows = plan.parker

    out = apply_filter(projections, plan, pw_rows)
    return out[0] if single else out
