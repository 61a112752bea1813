"""Voxel-driven back projection at chosen voxels, plain PyTorch.

RabbitCT's Listing 1 at a set of voxels: each voxel's world point is
projected through the 3x4 matrix, the four floor taps of the bordered
view are blended bilinearly (a tap outside the bordered view reads 0),
and the blend is weighted by ``1 / w**2`` (0 where ``w <= 1e-6``).  All
arithmetic is float32; projections are taken ``block`` at a time.
"""

from __future__ import annotations

import torch

_EPS_W = 1e-6
_TAP_CLAMP = float(1 << 20)


def voxel_coords(flat: torch.Tensor, L: int) -> torch.Tensor:
    """``(3, N)`` ``(z, y, x)`` indices of flat indices into ``(L, L, L)``."""
    return torch.stack([flat // (L * L), (flat // L) % L, flat % L])


def backproject_at(values: torch.Tensor, mats: torch.Tensor,
                   zyx: torch.Tensor, O: float, MM: float, *,
                   block: int = 8) -> torch.Tensor:
    """``(N,)`` float32: the sum over ``p`` of the bilinear sample of
    ``values[p]`` over ``w_p**2`` at voxels ``zyx`` (``(3, N)``).

    ``values`` is ``(P, n_v + 2, n_u + 2)`` float32, each view with its
    1-pixel border; ``mats`` ``(P, 3, 4)`` float32 on the same device."""
    P, rows, cols = values.shape
    wz, wy, wx = (O + zyx[i].to(torch.float32) * MM for i in range(3))
    acc = torch.zeros(zyx.shape[1], dtype=torch.float32,
                      device=values.device)
    for p0 in range(0, P, block):
        A = mats[p0:p0 + block]
        b = A.shape[0]

        def project(i):
            return (wx * A[:, i, 0:1] + wy * A[:, i, 1:2]) \
                + wz * A[:, i, 2:3] + A[:, i, 3:4]

        u, v, w = project(0), project(1), project(2)
        r = torch.where(w > _EPS_W, 1.0 / w, 0.0)
        ix = torch.clamp(u * r, -_TAP_CLAMP, _TAP_CLAMP)
        iy = torch.clamp(v * r, -_TAP_CLAMP, _TAP_CLAMP)
        fx, fy = torch.floor(ix), torch.floor(iy)
        sx, sy = ix - fx, iy - fy
        c = fx.to(torch.int64) + 1
        rr = fy.to(torch.int64) + 1
        flat = values[p0:p0 + b].reshape(b, rows * cols)

        def tap(ri, ci):
            ok = (ri >= 0) & (ri < rows) & (ci >= 0) & (ci < cols)
            idx = ri.clamp(0, rows - 1) * cols + ci.clamp(0, cols - 1)
            return torch.where(ok, torch.gather(flat, 1, idx), 0.0)

        valb = (1.0 - sx) * tap(rr, c) + sx * tap(rr, c + 1)
        valt = (1.0 - sx) * tap(rr + 1, c) + sx * tap(rr + 1, c + 1)
        val = (1.0 - sy) * valb + sy * valt
        acc += torch.sum(val * (r * r), dim=0)
    return acc
