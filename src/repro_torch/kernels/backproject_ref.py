"""Plain PyTorch version of the back-projection kernel.

Listing-1 semantics (floor bilinear, zero outside the detector, ``1/w^2``
weighting) built from the ``scalar`` pieces of
:mod:`repro_torch.core.backproject`, with the kernel's accumulation
order: per voxel, the volume value plus each projection's contribution
in projection order.  The CPU path of
:mod:`repro_torch.kernels.backproject_ops` runs it; on the card only the
smoke run uses it, as the kernel's yardstick.
"""

from __future__ import annotations

import torch

from ..core.backproject import (GeomStatic, contribution, plane_coords,
                                sample_scalar)

__all__ = ["backproject_batch_ref"]

_SLAB = 8


def backproject_batch_ref(volume, images, mats, gs: GeomStatic, *,
                          z0: int = 0):
    """``volume += Σ_p bilinear(images[p]) / w_p²``, in place; returns
    ``volume``.

    ``volume`` is ``(nz, L, L)`` float32 (a z-slab starting at global
    plane ``z0``), ``images`` the *unpadded* ``(P, n_v, n_u)`` stack,
    ``mats`` ``(P, 3, 4)``.  Works :data:`_SLAB` z-planes at a time to
    bound the temporaries (a few hundred MB at L=512).
    """
    nz = volume.shape[0]
    for s in range(0, nz, _SLAB):
        e = min(s + _SLAB, nz)
        zs = torch.arange(z0 + s, z0 + e, device=volume.device)
        acc = volume[s:e]
        for p in range(images.shape[0]):
            ix, iy, w = plane_coords(mats[p], gs, zs)
            acc += contribution(sample_scalar(images[p], ix, iy, gs), w)
    return volume
