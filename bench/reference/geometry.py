"""Circular C-arm geometry of a RabbitCT scan, in numpy.

A frozen copy of the arithmetic the benchmark needs: the projection
angles, the normalised 3x4 projection matrices (``w == 1`` at the
isocentre, so the back projection's weight is ``1 / w**2``), the
source positions and detector frames.  The matrices made here are the
inputs handed to the program under test and to the reference alike.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scan:
    """One acquisition as a configuration file states it."""

    n_u: int
    n_v: int
    du: float
    dv: float
    sid: float
    sdd: float
    L: int
    voxel_mm: float
    n_proj: int
    sweep_deg: float

    @classmethod
    def from_config(cls, geometry: dict) -> "Scan":
        return cls(**{f.name: geometry[f.name]
                      for f in dataclasses.fields(cls)})

    @property
    def sweep(self) -> float:
        return math.radians(self.sweep_deg)

    @property
    def O(self) -> float:  # noqa: E743  (RabbitCT's name)
        """World coordinate of voxel index 0 on every axis (mm)."""
        return -(self.L - 1) / 2.0 * self.voxel_mm

    @property
    def cu(self) -> float:
        return (self.n_u - 1) / 2.0

    @property
    def cv(self) -> float:
        return (self.n_v - 1) / 2.0

    @property
    def angles(self) -> np.ndarray:
        return np.linspace(0.0, self.sweep, self.n_proj, endpoint=False)


def source_position(scan: Scan, theta) -> np.ndarray:
    theta = np.asarray(theta, dtype=np.float64)
    return np.stack([scan.sid * np.cos(theta), scan.sid * np.sin(theta),
                     np.zeros_like(theta)], axis=-1)


def detector_basis(scan: Scan, theta):
    """``(e_u, e_v, e_w)``: detector rows, columns (world z), and the
    principal axis from the source towards the detector."""
    theta = np.asarray(theta, dtype=np.float64)
    zeros, ones = np.zeros_like(theta), np.ones_like(theta)
    e_u = np.stack([-np.sin(theta), np.cos(theta), zeros], axis=-1)
    e_v = np.stack([zeros, zeros, ones], axis=-1)
    e_w = np.stack([-np.cos(theta), -np.sin(theta), zeros], axis=-1)
    return e_u, e_v, e_w


def projection_matrices(scan: Scan) -> np.ndarray:
    """``(n_proj, 3, 4)`` float32: ``[u', v', w] = A [X, 1]``, pixel
    ``(u'/w, v'/w)``, scaled so that ``w == 1`` at the isocentre."""
    mats = []
    for theta in scan.angles:
        e_u, e_v, e_w = detector_basis(scan, float(theta))
        s = source_position(scan, float(theta))
        r0 = scan.sdd / scan.du * e_u + scan.cu * e_w
        r1 = scan.sdd / scan.dv * e_v + scan.cv * e_w
        R = np.stack([r0, r1, e_w], axis=0)
        A = np.concatenate([R, (-R @ s)[:, None]], axis=1)
        mats.append(A / scan.sid)
    return np.stack(mats).astype(np.float32)
