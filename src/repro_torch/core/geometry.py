"""Cone-beam CT acquisition geometry (RabbitCT conventions).

The port's own copy of ``repro.core.geometry``: pure numpy, kept
line-for-line so the matrices are bitwise equal to the reference's.

The RabbitCT framework hands the back projection implementation, per
projection image ``i``, a 3x4 homogeneous projection matrix ``A_i`` plus the
scalars ``O`` (world coordinate of voxel 0) and ``MM`` (voxel pitch in mm).
This module reconstructs that interface from first principles for a circular
C-arm trajectory so that the whole pipeline (data generation, filtering,
back projection, quality evaluation) is self-contained and exactly
consistent.

Coordinate systems
------------------
VCS  voxel coordinate system: integer indices ``(x, y, z)`` in ``[0, L)``.
WCS  world coordinate system (mm), origin at the volume centre:
     ``w = O + i * MM`` per axis with ``O = -(L - 1) / 2 * MM``.
ICS  image (detector) coordinate system: continuous pixel coordinates
     ``(ix, iy)`` with ``ix`` along detector rows (width ``n_u``) and ``iy``
     along columns (height ``n_v``).  An image is stored ``I[iy, ix]``.

The projection matrices are normalised such that the homogeneous coordinate
``w`` equals 1.0 at the isocenter; the inverse-square-law weight used by the
back projection is then simply ``1 / w**2`` (Listing 1, line 43 of the
paper).

Everything here is *host-side* precompute (numpy): the RabbitCT framework
also precomputes matrices on the host.  Device code only ever consumes the
stacked ``(n_proj, 3, 4)`` matrix array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "Geometry",
    "default_geometry",
    "projection_matrix",
    "projection_matrices",
    "source_position",
    "detector_basis",
    "voxel_origin",
    "voxel_world_coords",
    "project_voxels",
]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static description of one circular cone-beam acquisition.

    Attributes mirror the quantities the RabbitCT framework precomputes.
    ``n_u``/``n_v`` are detector width/height in pixels (RabbitCT: 1248x960),
    ``du``/``dv`` the pixel pitch in mm, ``sid`` the source-isocenter
    distance, ``sdd`` the source-detector distance, ``L`` the reconstruction
    volume edge length in voxels and ``voxel_mm`` the voxel pitch (``MM``).
    """

    n_u: int = 1248
    n_v: int = 960
    du: float = 0.32
    dv: float = 0.32
    sid: float = 750.0
    sdd: float = 1200.0
    L: int = 512
    voxel_mm: float = 0.5
    n_proj: int = 496
    # Total gantry sweep in radians (RabbitCT C-arm: ~200 degrees).
    sweep: float = math.radians(200.0)

    # ------------------------------------------------------------------
    @property
    def O(self) -> float:  # noqa: E743  (paper's name)
        """World coordinate of voxel index 0 (identical for x/y/z)."""
        return -(self.L - 1) / 2.0 * self.voxel_mm

    @property
    def MM(self) -> float:
        """Voxel pitch in mm (paper's name)."""
        return self.voxel_mm

    @property
    def cu(self) -> float:
        """Detector centre offset along u in pixels."""
        return (self.n_u - 1) / 2.0

    @property
    def cv(self) -> float:
        """Detector centre offset along v in pixels."""
        return (self.n_v - 1) / 2.0

    @property
    def angles(self) -> np.ndarray:
        """Projection angles in radians, shape ``(n_proj,)``."""
        return np.linspace(0.0, self.sweep, self.n_proj, endpoint=False)

    @property
    def magnification(self) -> float:
        return self.sdd / self.sid

    def scaled(self, L: int, *, n_proj: int | None = None,
               n_u: int | None = None, n_v: int | None = None) -> "Geometry":
        """Return a geometry rescaled to a different volume size.

        Field of view is preserved: the voxel pitch grows as ``L`` shrinks,
        and (unless overridden) the detector resolution shrinks
        proportionally so that the voxel->pixel beam density stays the same.
        This is how the test/benchmark suite derives laptop-sized problems
        from the medically relevant 512^3 case without changing the access
        pattern statistics that the paper's analysis depends on.
        """
        factor = self.L / L
        return dataclasses.replace(
            self,
            L=L,
            voxel_mm=self.voxel_mm * factor,
            n_u=n_u if n_u is not None else max(8, int(round(self.n_u / factor))),
            n_v=n_v if n_v is not None else max(8, int(round(self.n_v / factor))),
            du=self.du * factor if n_u is None else self.du * self.n_u / n_u,
            dv=self.dv * factor if n_v is None else self.dv * self.n_v / n_v,
            n_proj=n_proj if n_proj is not None else self.n_proj,
        )


def default_geometry(**overrides) -> Geometry:
    """The RabbitCT-like default geometry, optionally overridden."""
    return Geometry(**overrides)


# ----------------------------------------------------------------------
# Trajectory frames
# ----------------------------------------------------------------------

def source_position(geom: Geometry, theta: float | np.ndarray) -> np.ndarray:
    """X-ray source position(s) in WCS for gantry angle(s) ``theta``."""
    theta = np.asarray(theta, dtype=np.float64)
    return np.stack(
        [geom.sid * np.cos(theta), geom.sid * np.sin(theta),
         np.zeros_like(theta)], axis=-1)


def detector_basis(geom: Geometry, theta: float | np.ndarray):
    """Orthonormal detector frame for angle(s) ``theta``.

    Returns ``(e_u, e_v, e_w)`` where ``e_u`` spans detector rows, ``e_v``
    detector columns (world z) and ``e_w`` is the principal-axis unit vector
    pointing from the source towards the detector.
    """
    theta = np.asarray(theta, dtype=np.float64)
    zeros = np.zeros_like(theta)
    ones = np.ones_like(theta)
    e_u = np.stack([-np.sin(theta), np.cos(theta), zeros], axis=-1)
    e_v = np.stack([zeros, zeros, ones], axis=-1)
    e_w = np.stack([-np.cos(theta), -np.sin(theta), zeros], axis=-1)
    return e_u, e_v, e_w


def projection_matrix(geom: Geometry, theta: float) -> np.ndarray:
    """Build the normalised ``3x4`` projection matrix for one angle.

    For a world point ``X`` (homogeneous ``[X, 1]``)::

        [u', v', w]^T = A @ [X, 1]
        ix = u' / w,  iy = v' / w          # detector pixel coordinates
        weight = 1 / w**2                  # inverse-square law

    ``A`` is scaled so that ``w == 1`` at the isocenter, matching the
    RabbitCT convention (the paper calls ``w`` "an approximation of the
    distance from the X-ray source to the voxel").
    """
    e_u, e_v, e_w = detector_basis(geom, theta)
    s = source_position(geom, theta)
    f_u = geom.sdd / geom.du  # focal length in pixel units (u)
    f_v = geom.sdd / geom.dv
    # Rows of the unnormalised matrix: projective pinhole model.
    r0 = f_u * e_u + geom.cu * e_w
    r1 = f_v * e_v + geom.cv * e_w
    r2 = e_w
    R = np.stack([r0, r1, r2], axis=0)            # (3, 3)
    t = -R @ s                                     # (3,)
    A = np.concatenate([R, t[:, None]], axis=1)    # (3, 4)
    return (A / geom.sid).astype(np.float64)


def projection_matrices(geom: Geometry,
                        angles: Sequence[float] | None = None) -> np.ndarray:
    """Stacked matrices ``(n_proj, 3, 4)`` (float32, device-ready)."""
    if angles is None:
        angles = geom.angles
    mats = np.stack([projection_matrix(geom, float(t)) for t in angles])
    return mats.astype(np.float32)


# ----------------------------------------------------------------------
# Voxel coordinate helpers (Part 1 of the paper's kernel, host reference)
# ----------------------------------------------------------------------

def voxel_origin(geom: Geometry) -> float:
    return geom.O


def voxel_world_coords(geom: Geometry, idx: np.ndarray) -> np.ndarray:
    """VCS -> WCS: ``w = O + i * MM`` (Listing 1, lines 6-8)."""
    return geom.O + np.asarray(idx, dtype=np.float64) * geom.MM


def project_voxels(A: np.ndarray, wx, wy, wz):
    """Forward-project world coordinates through ``A`` (host reference).

    Returns ``(ix, iy, w)`` exactly as in Listing 1 lines 10-15.  Used by
    tests and by the clipping-mask brute-force oracle.
    """
    wx = np.asarray(wx, dtype=np.float64)
    wy = np.asarray(wy, dtype=np.float64)
    wz = np.asarray(wz, dtype=np.float64)
    u = wx * A[0, 0] + wy * A[0, 1] + wz * A[0, 2] + A[0, 3]
    v = wx * A[1, 0] + wy * A[1, 1] + wz * A[1, 2] + A[1, 3]
    w = wx * A[2, 0] + wy * A[2, 1] + wz * A[2, 2] + A[2, 3]
    return u / w, v / w, w
