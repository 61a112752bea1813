"""Analytic 3-D ellipsoid phantom and exact cone-beam forward projector.

The port's counterpart of ``repro.core.phantom``.  The ellipsoid table
is the same numpy data; :func:`voxelize` and :func:`forward_project` run
on tensors, on the caller's device, in float64 with the reference's
operation order, so the float32 results match the numpy versions to
float32 rounding.  At full RabbitCT size (496 angles of 1248x960 rays)
the numpy projector loops over the angles on the host for minutes; here
a block of angles is one batch of device ops.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from .geometry import Geometry, detector_basis, projection_matrices, \
    source_position

__all__ = [
    "Ellipsoid",
    "shepp_logan_3d",
    "voxelize",
    "forward_project",
    "make_dataset",
]


@dataclasses.dataclass(frozen=True)
class Ellipsoid:
    center: tuple[float, float, float]   # WCS mm
    semi_axes: tuple[float, float, float]  # mm
    rho: float                            # density (additive)
    phi: float = 0.0                      # rotation about world z (radians)

    def rotation(self) -> np.ndarray:
        c, s = np.cos(self.phi), np.sin(self.phi)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def shepp_logan_3d(extent_mm: float) -> list[Ellipsoid]:
    """A compact 3-D Shepp-Logan-flavoured phantom scaled to ``extent_mm``
    (the world half-extent of the volume; the phantom fills ~90% of it)."""
    e = extent_mm

    def E(cx, cy, cz, a, b, c, rho, phi=0.0):
        return Ellipsoid((cx * e, cy * e, cz * e), (a * e, b * e, c * e),
                         rho, phi)

    return [
        E(0.0, 0.0, 0.0, 0.69, 0.92, 0.81, 1.0),
        E(0.0, -0.0184, 0.0, 0.6624, 0.874, 0.78, -0.8),
        E(0.22, 0.0, 0.0, 0.11, 0.31, 0.22, -0.2, np.radians(-18)),
        E(-0.22, 0.0, 0.0, 0.16, 0.41, 0.28, -0.2, np.radians(18)),
        E(0.0, 0.35, -0.15, 0.21, 0.25, 0.41, 0.1),
        E(0.0, 0.1, 0.25, 0.046, 0.046, 0.05, 0.1),
        E(0.0, -0.1, 0.25, 0.046, 0.046, 0.05, 0.1),
        E(-0.08, -0.605, 0.0, 0.046, 0.023, 0.05, 0.1),
        E(0.0, -0.605, 0.0, 0.023, 0.023, 0.02, 0.1),
        E(0.06, -0.605, 0.0, 0.023, 0.046, 0.02, 0.1),
    ]


def _rows_times(x, m):
    """``x @ m`` for ``x (..., 3)`` and a host ``(3, 3)`` matrix, written
    out so the three products are summed in a fixed order."""
    return torch.stack(
        [x[..., 0] * float(m[0, j]) + x[..., 1] * float(m[1, j])
         + x[..., 2] * float(m[2, j]) for j in range(3)], dim=-1)


def voxelize(geom: Geometry, ellipsoids: Sequence[Ellipsoid] | None = None,
             *, device="cuda", slab: int = 32) -> torch.Tensor:
    """Exact voxel-centre sampling of the phantom, ``(L, L, L)`` float32,
    index order ``volume[z, y, x]``.  Built ``slab`` z-planes at a time to
    bound the float64 temporaries."""
    dev = resolve_device(device)
    if ellipsoids is None:
        ellipsoids = shepp_logan_3d(-geom.O)
    L = geom.L
    coords = geom.O + torch.arange(L, dtype=torch.float64,
                                   device=dev) * geom.MM
    out = torch.empty((L, L, L), dtype=torch.float32, device=dev)
    for z0 in range(0, L, slab):
        zz, yy, xx = torch.meshgrid(coords[z0:z0 + slab], coords, coords,
                                    indexing="ij")
        pts = torch.stack([xx, yy, zz], dim=-1)
        vol = torch.zeros(zz.shape, dtype=torch.float64, device=dev)
        for ell in ellipsoids:
            rel = pts - torch.tensor(ell.center, dtype=torch.float64,
                                     device=dev)
            rel = _rows_times(rel, ell.rotation())
            q = (rel / torch.tensor(ell.semi_axes, dtype=torch.float64,
                                    device=dev)) ** 2
            vol += ell.rho * (q.sum(dim=-1) <= 1.0)
        out[z0:z0 + slab] = vol.to(torch.float32)
    return out


def forward_project(geom: Geometry,
                    ellipsoids: Sequence[Ellipsoid] | None = None,
                    angles: np.ndarray | None = None, *, device="cuda",
                    block: int = 8) -> torch.Tensor:
    """Closed-form line integrals, ``(n_proj, n_v, n_u)`` float32.

    Each ray goes through a pixel centre in the detector frame that
    builds the projection matrices, so forward and back projection are
    consistent.  ``block`` angles are projected per batch of device ops.
    """
    dev = resolve_device(device)
    if ellipsoids is None:
        ellipsoids = shepp_logan_3d(-geom.O)
    if angles is None:
        angles = geom.angles
    angles = np.asarray(angles, dtype=np.float64)
    f64 = dict(dtype=torch.float64, device=dev)
    iu = (torch.arange(geom.n_u, **f64) - geom.cu) * geom.du
    iv = (torch.arange(geom.n_v, **f64) - geom.cv) * geom.dv
    vv, uu = torch.meshgrid(iv, iu, indexing="ij")        # (n_v, n_u)

    out = torch.empty((len(angles), geom.n_v, geom.n_u),
                      dtype=torch.float32, device=dev)
    for k0 in range(0, len(angles), block):
        th = angles[k0:k0 + block]
        e_u, e_v, e_w = (torch.as_tensor(e, **f64)[:, None, None, :]
                         for e in detector_basis(geom, th))  # (b,1,1,3)
        s = source_position(geom, th)                        # (b, 3) host
        d = (uu[None, ..., None] * e_u + vv[None, ..., None] * e_v
             + geom.sdd * e_w)                               # (b,nv,nu,3)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        acc = torch.zeros(d.shape[:-1], **f64)
        for ell in ellipsoids:
            R = ell.rotation()
            inv_ax = 1.0 / np.asarray(ell.semi_axes)
            p = ((s - np.asarray(ell.center)) @ R) * inv_ax   # (b, 3) host
            q = _rows_times(d, R) * torch.as_tensor(inv_ax, **f64)
            pt = torch.as_tensor(p, **f64)[:, None, None, :]
            a = torch.sum(q * q, dim=-1)
            b = torch.sum(q * pt, dim=-1)
            c0 = torch.as_tensor([float(pk @ pk) - 1.0 for pk in p],
                                 **f64)[:, None, None]
            disc = b * b - a * c0
            chord = 2.0 * torch.sqrt(torch.clamp(disc, min=0.0)) / a
            acc += ell.rho * chord
        out[k0:k0 + len(th)] = acc.to(torch.float32)
    return out


def make_dataset(geom: Geometry, *, device="cuda"):
    """``(projections, matrices, reference_volume)``: the raw line
    integrals ``(n_proj, n_v, n_u)`` and the voxelised phantom ``(L, L,
    L)`` as float32 tensors on ``device``, and the stacked ``(n_proj, 3,
    4)`` float32 matrices as host numpy (host precompute, as RabbitCT
    hands them over)."""
    dev = resolve_device(device)
    ells = shepp_logan_3d(-geom.O)
    projections = forward_project(geom, ells, device=dev)
    matrices = projection_matrices(geom)
    reference = voxelize(geom, ells, device=dev)
    return projections, matrices, reference
