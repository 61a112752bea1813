"""Plain PyTorch versions of the port's CUDA kernels.

* :func:`backproject_batch_ref` is the back-projection kernel's:
  Listing-1 semantics (floor bilinear, zero outside the buffer, ``1/w^2``
  weighting) built from the ``scalar`` pieces of
  :mod:`repro_torch.core.backproject`, with the kernel's accumulation
  order: per voxel, the volume value plus each projection's contribution
  in projection order.  With a narrow ``wire`` it first turns the
  zero-bordered stack into the float32 values the kernel's taps read (a
  bfloat16 round trip, or the int8 codes of
  :func:`repro_torch.quant.quantize_rows_ref` decoded), then runs the
  same arithmetic on the bordered stack
  (:func:`backproject_padded_ref`, which also takes a stack already on
  the wire through :func:`decode_wire`).
* :func:`repro_torch.quant.quantize_rows_ref` is the row quantiser's.

The CPU path of :mod:`repro_torch.kernels.backproject_ops` runs them; on
the card only the smoke run uses them, as the kernels' yardsticks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.backproject import (GeomStatic, _sample_bounded, contribution,
                                plane_coords, sample_scalar,
                                strip_wire_dtype)
from ..quant import RowQuant, dequantize_rows, quantize_rows_ref

__all__ = ["backproject_batch_ref", "backproject_padded_ref",
           "decode_wire", "wire_values"]

_SLAB = 8


def decode_wire(stack, scales=None):
    """The float32 values the kernel's taps read from a stack on the
    wire: a float32 or bfloat16 tensor as it is (bf16 widens exactly), or
    int8 codes with their ``(P, 2, rows)`` scale/offset block decoded in
    two rounded steps, as the kernel does."""
    if scales is None:
        return stack.to(torch.float32)
    return dequantize_rows(RowQuant(stack, scales[:, 0], scales[:, 1]))


def wire_values(padded, wire: str = "float32"):
    """The float32 values the kernel's taps read from the zero-bordered
    ``(P, rows, cols)`` float32 stack ``padded`` on ``wire``."""
    dtype = strip_wire_dtype(wire)
    if dtype is None:
        return padded
    if dtype is torch.bfloat16:
        return decode_wire(padded.to(torch.bfloat16))
    rq = quantize_rows_ref(padded)
    return decode_wire(rq.codes, rq.scales())


def _accumulate(volume, mats, gs: GeomStatic, z0: int, n: int, sample):
    nz = volume.shape[0]
    for s in range(0, nz, _SLAB):
        e = min(s + _SLAB, nz)
        zs = torch.arange(z0 + s, z0 + e, device=volume.device)
        acc = volume[s:e]
        for p in range(n):
            ix, iy, w = plane_coords(mats[p], gs, zs)
            acc += contribution(sample(p, ix, iy), w)
    return volume


def backproject_padded_ref(volume, values, mats, gs: GeomStatic, *,
                           z0: int = 0):
    """``volume += Σ_p bilinear(values[p]) / w_p²`` in place, with taps
    read from the zero-bordered ``(P, n_v + 2, n_u + 2)`` float32 stack
    ``values`` (a narrow wire already decoded, :func:`decode_wire`) and
    reading 0 past it; returns ``volume``."""
    return _accumulate(volume, mats, gs, z0, values.shape[0],
                       lambda p, ix, iy: _sample_bounded(values[p], ix, iy,
                                                         shift=1))


def backproject_batch_ref(volume, images, mats, gs: GeomStatic, *,
                          z0: int = 0, wire: str = "float32"):
    """``volume += Σ_p bilinear(images[p]) / w_p²``, in place; returns
    ``volume``.

    ``volume`` is ``(nz, L, L)`` float32 (a z-slab starting at global
    plane ``z0``), ``images`` the *unpadded* ``(P, n_v, n_u)`` float32
    stack, ``mats`` ``(P, 3, 4)``, ``wire`` the projection wire
    (``"float32"``, ``"bfloat16"`` or ``"int8"``).  Works :data:`_SLAB`
    z-planes at a time to bound the temporaries (a few hundred MB at
    L=512).
    """
    if strip_wire_dtype(wire) is not None:
        return backproject_padded_ref(
            volume, wire_values(F.pad(images, (1, 1, 1, 1)), wire), mats,
            gs, z0=z0)
    return _accumulate(volume, mats, gs, z0, images.shape[0],
                       lambda p, ix, iy: sample_scalar(images[p], ix, iy,
                                                       gs))
