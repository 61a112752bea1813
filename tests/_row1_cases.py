"""Inputs that reach the corners of the row-1 back projection and of the
row encoder: shared by the CPU design tests
(``tests/test_torch_row1_design.py``) and the card tests
(``tests/test_torch_cuda.py``).  numpy and the port only, no JAX.

* :func:`odd_problem`: L = 37 (no multiple of the kernel's 32 x 8 block),
  a 13-plane slab from global plane 5 (no multiple of its 8-voxel z
  run), random images on a 90 x 69 detector, and matrices that send
  taps off the detector (view 2 widens u three-fold) and put w at or
  below 1e-6 across part of the volume (view 5's w row is shifted to
  cross 0 mid-volume).
* :func:`hard_rows`: a stack of rows off the encoder's tile sizes with
  random, all-zero, constant and one-signed rows, and rows built so that
  every step's quotient ``(xp - offset) / scale`` lands within a few
  ulps of a half-integer.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.geometry import Geometry, projection_matrices

ODD_L, ODD_Z0, ODD_NZ, ODD_VIEWS = 37, 5, 13, 8


def odd_problem(seed: int = 0):
    """``(geom, images, mats, volume, z0)``: numpy float32 images ``(8,
    n_v, n_u)``, matrices ``(8, 3, 4)`` and a ``(13, 37, 37)`` slab from
    global plane ``z0``."""
    geom = Geometry().scaled(ODD_L, n_proj=ODD_VIEWS)
    rng = np.random.default_rng(seed)
    mats = np.array(projection_matrices(geom), np.float64)
    mats[2, 0] *= 3.0
    # View 5: w = 0 on the plane through the volume's centre.
    idx = np.arange(ODD_L, dtype=np.float64)
    centre = geom.O + idx.mean() * geom.MM
    mats[5, 2, 3] = -mats[5, 2, :3].sum() * centre
    images = rng.standard_normal((ODD_VIEWS, geom.n_v, geom.n_u)).astype(
        np.float32)
    volume = rng.standard_normal((ODD_NZ, ODD_L, ODD_L)).astype(np.float32)
    return geom, images, mats.astype(np.float32), volume, ODD_Z0


def _near_half_row(rng, cols: int, lo: float, hi: float,
                   symmetric: bool) -> np.ndarray:
    """A row whose range is ``[lo, hi]`` (columns 0 and 1) and whose
    later columns each aim the error-feedback quotient of the
    (``symmetric``) grid at ``k + 1/2`` (plus 0 or a few ulps), stepping
    the plain version's float32 chain to know the residual each column
    meets."""
    f = np.float32
    x = np.empty(cols, np.float32)
    x[:2] = (lo, hi)[:min(2, cols)]
    if symmetric:
        scale = f(max(abs(lo), abs(hi))) / f(127.0)
        offset = f(0.0)
    else:
        lo32, hi32 = f(min(lo, 0.0)), f(max(hi, 0.0))
        scale = f(max(f(hi32 - lo32), f(1e-30))) / f(254.0)
        offset = f(lo32 + f(f(127.0) * scale))
    err = f(0.0)
    for c in range(cols):
        if c >= 2:
            k = int(rng.integers(-120, 121)) if not symmetric else \
                int(rng.integers(-60, 61))
            aim = (k + 0.5) * (1 + int(rng.integers(-3, 4)) * 2.0**-23)
            x[c] = f(aim * float(scale) + float(offset) - float(err))
        xp = f(x[c] + err)
        q = np.clip(np.round(f(f(xp - offset) / scale)), -127, 127).astype(
            np.float32)
        err = f(xp - f(f(q * scale) + offset))
    return x


def hard_rows(seed: int, P: int = 3, rows: int = 37, cols: int = 131, *,
              symmetric: bool = False):
    """A ``(P, rows, cols)`` float32 stack of the rows above, the
    near-half rows aimed at the ``symmetric`` or the affine grid."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((P, rows, cols)) * 3).astype(np.float32)
    special = (0.0, 2.5, -1.25, -np.abs(x[0, 3 % rows]),
               np.abs(x[0, 4 % rows]))
    for r, v in enumerate(special[:rows]):
        x[0, r] = v
    if rows > 5:
        x[0, 5, min(7, cols - 1)] = 1e4
    for p in range(P):
        for r in range(6 if p == 0 else 0, rows, 3):
            x[p, r] = _near_half_row(rng, cols, -2.0 - p, 3.0 + r % 5,
                                     symmetric)
    return x
