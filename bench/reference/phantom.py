"""Seeded ellipsoid phantoms and their exact cone-beam line integrals.

The table is a 3-D Shepp-Logan-like phantom (ten ellipsoids filling
about 90 % of the field of view), perturbed from a seed: centres,
semi-axes, densities and rotations move a little, so two seeds give two
different scans of the same shape and the same cost.  The projector
intersects each ray with each ellipsoid in closed form, in float64 on
the caller's device, ``block`` angles per batch of device operations.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Scan, detector_basis, source_position

# (centre, semi-axes) as fractions of the half-extent, density, and the
# rotation about world z in degrees.
_TABLE = (
    ((0.0, 0.0, 0.0), (0.69, 0.92, 0.81), 1.0, 0.0),
    ((0.0, -0.0184, 0.0), (0.6624, 0.874, 0.78), -0.8, 0.0),
    ((0.22, 0.0, 0.0), (0.11, 0.31, 0.22), -0.2, -18.0),
    ((-0.22, 0.0, 0.0), (0.16, 0.41, 0.28), -0.2, 18.0),
    ((0.0, 0.35, -0.15), (0.21, 0.25, 0.41), 0.1, 0.0),
    ((0.0, 0.1, 0.25), (0.046, 0.046, 0.05), 0.1, 0.0),
    ((0.0, -0.1, 0.25), (0.046, 0.046, 0.05), 0.1, 0.0),
    ((-0.08, -0.605, 0.0), (0.046, 0.023, 0.05), 0.1, 0.0),
    ((0.0, -0.605, 0.0), (0.023, 0.023, 0.02), 0.1, 0.0),
    ((0.06, -0.605, 0.0), (0.023, 0.046, 0.02), 0.1, 0.0),
)


def ellipsoids(scan: Scan, rng: np.random.Generator) -> list[dict]:
    """The phantom for one seeded scan: the table with each centre moved
    by up to 1 % of the half-extent, each semi-axis scaled by up to
    +-3 % (the outer two moved and scaled together, so the shell keeps
    its shape), each inner density by up to +-20 % and each rotation by
    up to +-10 degrees."""
    e = -scan.O
    shell = 1.0 + rng.uniform(-0.03, 0.03)
    shift = rng.uniform(-0.01, 0.01, 3) * e
    out = []
    for i, (c, a, rho, phi) in enumerate(_TABLE):
        move = shift if i < 2 else rng.uniform(-0.01, 0.01, 3) * e
        c = np.asarray(c) * e + move
        grow = shell if i < 2 else 1.0 + rng.uniform(-0.03, 0.03, 3)
        a = np.asarray(a) * e * grow
        if i >= 2:
            rho = rho * (1.0 + rng.uniform(-0.2, 0.2))
        phi = np.radians(phi + rng.uniform(-10.0, 10.0))
        cs, sn = np.cos(phi), np.sin(phi)
        rot = np.array([[cs, -sn, 0.0], [sn, cs, 0.0], [0.0, 0.0, 1.0]])
        out.append({"center": c, "axes": a, "rho": float(rho), "rot": rot})
    return out


def _times(x, m):
    """``x @ m`` for ``x (..., 3)`` and a host ``(3, 3)`` matrix, summed
    in a fixed order."""
    return torch.stack([x[..., 0] * float(m[0, j]) + x[..., 1] * float(m[1, j])
                        + x[..., 2] * float(m[2, j]) for j in range(3)],
                       dim=-1)


def forward_project(scan: Scan, ells: list[dict], device, *,
                    block: int = 16, out: torch.Tensor | None = None,
                    order: np.ndarray | None = None) -> torch.Tensor:
    """Line integrals ``(n_proj, n_v, n_u)`` float32 on ``device``.

    Row ``k`` of the result is the view at angle index ``order[k]``
    (default: angle order).  Each ray leaves the source towards a pixel
    centre of the detector frame the projection matrices are built from,
    ``D = u e_u + v e_v + sdd e_w`` with ``|D| = n(u, v)`` the same at
    every angle.  In an ellipsoid's unit-sphere frame the ray is ``p + t
    Q / n`` with ``Q = u U + v V + W``, so its chord is ``2 n sqrt(B^2 -
    A c) / A`` with ``A = Q.Q``, ``B = Q.p`` and ``c = p.p - 1``: per
    angle, ``A`` and ``B`` are sums of a function of ``u`` and one of
    ``v`` (and a ``u v`` term where an ellipsoid is not rotated about
    the detector's ``v`` axis), evaluated in float64."""
    f64 = dict(dtype=torch.float64, device=device)
    if order is None:
        order = np.arange(scan.n_proj)
    angles = scan.angles[np.asarray(order)]
    u = ((torch.arange(scan.n_u, **f64) - scan.cu) * scan.du)[None, None, :]
    v = ((torch.arange(scan.n_v, **f64) - scan.cv) * scan.dv)[None, :, None]
    n = torch.sqrt(u * u + v * v + scan.sdd ** 2)
    if out is None:
        out = torch.empty((len(angles), scan.n_v, scan.n_u),
                          dtype=torch.float32, device=device)

    def col(x):                      # (b,) host -> (b, 1, 1) device
        return torch.as_tensor(x, **f64)[:, None, None]

    for k0 in range(0, len(angles), block):
        th = angles[k0:k0 + block]
        e_u, e_v, e_w = detector_basis(scan, th)
        s = source_position(scan, th)
        acc = torch.zeros((len(th), scan.n_v, scan.n_u), **f64)
        for ell in ells:
            inv, rot = 1.0 / ell["axes"], ell["rot"]
            U, V = (e_u @ rot) * inv, (e_v @ rot) * inv
            W = scan.sdd * (e_w @ rot) * inv
            p = ((s - ell["center"]) @ rot) * inv

            def dot(a, b):
                return np.sum(a * b, axis=1)

            A = (col(dot(U, U)) * u + col(2.0 * dot(U, W))) * u \
                + col(dot(W, W)) \
                + (col(dot(V, V)) * v + col(2.0 * dot(V, W))) * v
            uv = dot(U, V)
            if np.any(uv != 0.0):
                A = A + col(2.0 * uv) * u * v
            B = col(dot(U, p)) * u + col(dot(W, p)) + col(dot(V, p)) * v
            disc = torch.clamp(B * B - A * col(dot(p, p) - 1.0), min=0.0)
            acc += (2.0 * ell["rho"]) * n * torch.sqrt(disc) / A
        out[k0:k0 + len(th)] = acc.to(torch.float32)
    return out


def densities(scan: Scan, ells: list[dict], zyx: torch.Tensor) -> torch.Tensor:
    """The phantom sampled at voxel centres ``zyx`` (``(3, N)`` integer
    indices), float32: the value the reconstruction approximates."""
    w = scan.O + zyx.to(torch.float64) * scan.voxel_mm
    pts = torch.stack([w[2], w[1], w[0]], dim=-1)
    f64 = dict(dtype=torch.float64, device=zyx.device)
    val = torch.zeros(pts.shape[0], **f64)
    for ell in ells:
        rel = _times(pts - torch.as_tensor(ell["center"], **f64), ell["rot"])
        q = (rel / torch.as_tensor(ell["axes"], **f64)) ** 2
        val += ell["rho"] * (q.sum(dim=-1) <= 1.0)
    return val.to(torch.float32)
