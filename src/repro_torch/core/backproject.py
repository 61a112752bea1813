"""Voxel-driven cone-beam back projection — the paper's kernel, in PyTorch.

The port's counterpart of ``repro.core.backproject``, keeping Listing 1's
three parts:

* **Part 1** (:func:`plane_coords`): VCS->WCS->ICS transform with the
  reciprocal trick (one reciprocal replaces the three divides).
* **Part 2** (:func:`sample_scalar`): the four bounds-checked bilinear
  taps, zero outside the detector.
* **Part 3** (:func:`contribution` / :func:`accumulate`): the ``1/w^2``
  weight and the voxel update.

This slice carries the ``scalar`` strategy only.  The reference's
``gather``, ``onehot``, ``strip`` and ``strip2`` strategies come later;
naming one raises, it is never mapped quietly to another.  On a CUDA
volume every fold runs the hand-written back-projection kernel
(:mod:`repro_torch.kernels.backproject_ops`), which computes the same
Listing-1 semantics; on a CPU volume the fold runs ``scalar`` here.

The reference returns a new volume; the port updates the volume tensor
**in place** (and returns it), so a fold never holds two volumes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import as_f32, resolve_device
from .geometry import Geometry

__all__ = [
    "STRATEGIES",
    "DEFAULT_PBATCH",
    "GeomStatic",
    "plane_coords",
    "sample_scalar",
    "contribution",
    "accumulate",
    "backproject_plane_batch",
    "backproject_batch",
    "fold_projections",
    "reconstruct",
]

STRATEGIES = ("scalar",)

# Projections folded into the volume per volume pass (DESIGN.md §7): the
# volume streams through memory ceil(n_proj / pbatch) times.
DEFAULT_PBATCH = 4

_EPS_W = 1e-6

# z-planes the CPU ``scalar`` fold vectorises at once: bounds the
# (pbatch, slab, L, L) temporaries.
_SLAB = 16


class GeomStatic(NamedTuple):
    """The static scalars a kernel needs."""

    L: int
    n_u: int
    n_v: int
    O: float
    MM: float

    @classmethod
    def of(cls, geom: Geometry) -> "GeomStatic":
        return cls(L=geom.L, n_u=geom.n_u, n_v=geom.n_v,
                   O=float(geom.O), MM=float(geom.MM))


def _gs(geom) -> GeomStatic:
    return geom if isinstance(geom, GeomStatic) else GeomStatic.of(geom)


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(
            f"strategy {strategy!r} is not ported; the port has "
            f"{STRATEGIES}")


# ----------------------------------------------------------------------
# Part 1 — geometry
# ----------------------------------------------------------------------

def plane_coords(A, gs: GeomStatic, z):
    """ICS coordinates ``(ix, iy, w)`` for whole z-planes.

    ``A`` is one ``(3, 4)`` matrix or a ``(P, 3, 4)`` stack (float32
    tensor); ``z`` a global z index or a 1-D tensor of them.  The result
    has shape ``A.shape[:-2] + z.shape + (L, L)``, ``[.., y, x]`` order.
    The float32 operations and their order are the reference's (and the
    CUDA kernel's), so the taps agree bitwise.
    """
    A = torch.as_tensor(A, dtype=torch.float32)
    dev = A.device
    z = torch.as_tensor(z, device=dev)
    lead = A.shape[:-2]
    coords = gs.O + torch.arange(gs.L, dtype=torch.float32,
                                 device=dev) * gs.MM
    wx = coords                                           # (L,)
    wy = coords[:, None]                                  # (L, 1)
    wz = (gs.O + z.to(torch.float32) * gs.MM)[..., None, None]
    wz = wz.reshape((1,) * len(lead) + wz.shape)
    ones = (1,) * (z.ndim + 2)

    def a(i, j):
        return A[..., i, j].reshape(lead + ones)

    u = wx * a(0, 0) + wy * a(0, 1) + wz * a(0, 2) + a(0, 3)
    v = wx * a(1, 0) + wy * a(1, 1) + wz * a(1, 2) + a(1, 3)
    w = wx * a(2, 0) + wy * a(2, 1) + wz * a(2, 2) + a(2, 3)
    r = torch.where(w > _EPS_W, 1.0 / w, 0.0)
    return u * r, v * r, w


def _taps(ix, iy):
    """Floor taps and interpolation weights (Listing 1 lines 17-21)."""
    fx = torch.floor(ix)
    fy = torch.floor(iy)
    return fx.to(torch.int64), fy.to(torch.int64), ix - fx, iy - fy


# ----------------------------------------------------------------------
# Part 2 — the four-tap fetch + bilinear blend
# ----------------------------------------------------------------------

def sample_scalar(image, ix, iy, gs: GeomStatic):
    """Listing-1 transliteration: four bounds-checked loads per voxel.

    ``image`` is the *unpadded* ``(n_v, n_u)`` projection, or a ``(P,
    n_v, n_u)`` stack whose leading axis matches the leading axis of
    ``ix``/``iy``.  Taps outside the detector read 0.
    """
    iix, iiy, sx, sy = _taps(ix, iy)
    nb = image.shape[0] if image.ndim == 3 else 1
    flat = image.reshape(nb, gs.n_v * gs.n_u)

    def tap(r, c):
        ok = (r >= 0) & (r < gs.n_v) & (c >= 0) & (c < gs.n_u)
        idx = r.clamp(0, gs.n_v - 1) * gs.n_u + c.clamp(0, gs.n_u - 1)
        val = torch.gather(flat, 1, idx.reshape(nb, -1)).reshape(r.shape)
        return torch.where(ok, val, 0.0)

    valbl = tap(iiy, iix)
    valbr = tap(iiy, iix + 1)
    valtl = tap(iiy + 1, iix)
    valtr = tap(iiy + 1, iix + 1)
    valb = (1.0 - sx) * valbl + sx * valbr
    valt = (1.0 - sx) * valtl + sx * valtr
    return (1.0 - sy) * valb + sy * valt


# ----------------------------------------------------------------------
# Part 3 — weighting + voxel update
# ----------------------------------------------------------------------

def contribution(val, w):
    """``val / w**2`` with the reciprocal amortised; ``w <= 0`` voxels
    (behind the source) contribute zero."""
    r = torch.where(w > _EPS_W, 1.0 / w, 0.0)
    return val * (r * r)


def accumulate(plane, val, w):
    """``VOL += val / w**2`` (returns a new tensor, as the reference)."""
    return plane + contribution(val, w)


# ----------------------------------------------------------------------
# Folds
# ----------------------------------------------------------------------

def backproject_plane_batch(plane, images, mats, gs: GeomStatic, z,
                            strategy: str = "scalar"):
    """Back-project a *batch* of projections into z-plane(s).

    ``plane`` is ``(L, L)`` for a scalar ``z`` or ``(Z, L, L)`` for a 1-D
    ``z``; ``images`` ``(P, n_v, n_u)``; ``mats`` ``(P, 3, 4)``.  The
    batch's contributions are summed, then added to the plane once (the
    inverted loop nest of DESIGN.md §7).  Returns the new plane.
    """
    _check_strategy(strategy)
    ix, iy, w = plane_coords(mats, gs, z)
    val = sample_scalar(images, ix, iy, gs)
    return plane + torch.sum(contribution(val, w), dim=0)


def _backproject_batch_body(volume, images, mats, gs: GeomStatic, z0: int):
    """One ``scalar`` volume pass for one projection batch, in place.

    ``volume`` may be a z-slab whose first global z index is ``z0``.
    """
    nz = volume.shape[0]
    for s in range(0, nz, _SLAB):
        e = min(s + _SLAB, nz)
        zs = torch.arange(z0 + s, z0 + e, device=volume.device)
        volume[s:e] = backproject_plane_batch(volume[s:e], images, mats,
                                              gs, zs)
    return volume


def _stream_batches(projections, matrices, volume, pbatch: int, call):
    """Fold the projection stack into ``volume``, ``pbatch`` at a time.

    The one batch-chunking loop the scalar fold and the kernel wrapper
    share: full batches first, then a ``pbatch ∤ n_proj`` remainder as
    one final smaller batch.  ``call(vol, imgs, mats)`` performs one
    volume pass for one batch and returns the volume.
    """
    n_proj = int(projections.shape[0])
    pbatch = max(1, min(int(pbatch), n_proj)) if n_proj else 1
    for b0 in range(0, n_proj, pbatch):
        volume = call(volume, projections[b0:b0 + pbatch],
                      matrices[b0:b0 + pbatch])
    return volume


def _fold(volume, images, mats, gs: GeomStatic, strategy: str,
          pbatch: int, z0: int):
    _check_strategy(strategy)
    if not torch.is_tensor(volume) or volume.dtype != torch.float32:
        raise TypeError("volume must be a float32 tensor (updated in place)")
    images = as_f32(images, volume.device)
    mats = as_f32(mats, volume.device)
    if volume.is_cuda:
        from ..kernels.backproject_ops import backproject_batch as kernel

        return kernel(volume, images, mats, gs, pbatch=pbatch, z0=z0)
    return _stream_batches(
        images, mats, volume, pbatch,
        lambda vol, imgs, ms: _backproject_batch_body(vol, imgs, ms, gs,
                                                      z0))


def backproject_batch(volume, images, mats, geom: Geometry | GeomStatic,
                      strategy: str = "scalar",
                      pbatch: int = DEFAULT_PBATCH):
    """Add a stack of projections to ``volume`` in place, ``pbatch`` per
    volume pass; returns ``volume``.

    ``images`` is ``(n_proj, n_v, n_u)`` (filtered), ``mats`` ``(n_proj,
    3, 4)``; both are moved to the volume's device.  A CUDA volume folds
    through the hand-written kernel, a CPU volume through ``scalar``.
    """
    return _fold(volume, images, mats, _gs(geom), strategy, pbatch, 0)


def fold_projections(volume, images, mats, geom: Geometry | GeomStatic,
                     strategy: str = "scalar",
                     pbatch: int = DEFAULT_PBATCH, z0: int = 0):
    """Incremental fold: add a projection *chunk* to an existing volume,
    in place.

    ``volume`` may be a partial accumulation from earlier chunks, and a
    z-slab ``(nz, L, L)`` whose first global z index is ``z0``.  Any
    sequence of folds whose chunks cover the projection set once gives
    the reconstruction, in any arrival order (fp32 summation order
    differs, so cross-order agreement is ~1e-5, not bitwise).
    """
    return _fold(volume, images, mats, _gs(geom), strategy, pbatch,
                 int(z0))


def reconstruct(projections, matrices, geom: Geometry, *,
                strategy: str = "scalar", volume=None,
                pbatch: int | None = None, device="cuda"):
    """Full reconstruction: stream every *filtered* projection
    ``(n_proj, n_v, n_u)`` with its ``(n_proj, 3, 4)`` matrix into the
    volume, ``pbatch`` (default :data:`DEFAULT_PBATCH`) per volume pass.

    ``volume`` (on ``device``) is updated in place; ``None`` starts from
    zeros on ``device``.
    """
    dev = resolve_device(device)
    gs = GeomStatic.of(geom)
    if volume is None:
        volume = torch.zeros((gs.L, gs.L, gs.L), dtype=torch.float32,
                             device=dev)
    elif volume.device != dev:
        raise ValueError(f"volume lies on {volume.device}, not {dev}")
    return _fold(volume, projections, matrices, gs, strategy,
                 DEFAULT_PBATCH if pbatch is None else int(pbatch), 0)
