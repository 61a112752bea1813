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
* :func:`backproject_strip_ref`, :func:`backproject_micro_ref` and
  :func:`backproject_shared_ref` are the strip kernels' (K3 ``strip_db``,
  K4 ``strip_micro``, K5 ``strip_shared``): the same arithmetic, with
  each kernel's window rule.  A tap reads its value only when it lies in
  the window the kernel stages for it, and 0 otherwise:

  - strip (K3): per ``(ty, chunk)`` voxel tile of one z-plane and per
    projection, a ``(band, width)`` window at the corner-based origin of
    the reference's ``_strip_origin`` (``repro/kernels/backproject.py:86``):
    the floor of the least clipped tap coordinate over the tile's four
    corner voxels, clamped so the window ends inside the reference's
    rounded-up padded image (:func:`padded_dims`);
  - micro (K4): inside that strip, per run of ``group`` consecutive
    x-voxels, a ``(gband, gwidth)`` window at the least strip-relative
    tap row and column of the run, each clipped into the strip, the
    origin clipped so the window stays in the strip (the reference's
    ``_micro_tile_accumulate``, ``backproject.py:280-296``);
  - shared (K5): per tile and projection group, one ``(band, width)``
    window per projection, all anchored at the elementwise minimum of
    the group's corner origins (``backproject.py:791-800``).

  With a window that covers every tap (the planner checks that), each
  equals :func:`backproject_padded_ref` bitwise.
* :func:`repro_torch.quant.quantize_rows_ref` is the row quantiser's.

The CPU path of :mod:`repro_torch.kernels.backproject_ops` runs them; on
the card only the smoke run uses them, as the kernels' yardsticks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.backproject import (GeomStatic, _blend, _sample_bounded,
                                contribution, plane_coords, sample_scalar,
                                strip_wire_dtype)
from ..core.clipping import corner_lows
from ..quant import RowQuant, dequantize_rows, quantize_rows_ref

__all__ = ["backproject_batch_ref", "backproject_micro_ref",
           "backproject_padded_ref", "backproject_shared_ref",
           "backproject_strip_ref", "decode_wire", "padded_dims",
           "wire_values"]

_SLAB = 8

# Tap coordinates are clamped to +-2^20 before the integer conversion:
# every comparison with a window or the image keeps its outcome, and no
# conversion overflows (the kernels do the same).
_TAP_CLAMP = float(1 << 20)

# Rows of the reference's padded image are rounded up to the wire's
# sublane tile (float32 8, bfloat16 16, int8 32), columns to 128.
_SUBLANE = {1: 32, 2: 16, 4: 8}


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


def padded_dims(gs: GeomStatic, band: int, width: int,
                itemsize: int) -> tuple[int, int]:
    """The reference's padded image size for a ``(band, width)`` window
    on a wire of ``itemsize`` bytes: at least the window and the
    bordered image, rows rounded to the wire's sublane tile and columns
    to 128 (``repro/kernels/backproject_ops.py::_pad_up_stack``).  A
    window origin is clamped so the window ends inside it; the port
    stores only the bordered image and reads 0 past it, as the
    reference's round-up pixels hold on the float32 and bfloat16
    wires."""
    sub = _SUBLANE[int(itemsize)]
    rows = max(int(band), gs.n_v + 2)
    cols = max(int(width), gs.n_u + 2)
    return rows + (-rows) % sub, cols + (-cols) % 128


def _tap_index(f):
    return torch.clamp(f, -_TAP_CLAMP, _TAP_CLAMP).to(torch.int64) + 1


def _corner_origins(mats, zs, gs: GeomStatic, ty, chunk, band, width,
                    pad_rows, pad_cols):
    """``(r0, c0)`` per ``(ty, chunk)`` tile of the z-planes ``zs`` for
    each matrix, ``(P, nz, L / ty, L / chunk)``: the corner rule
    (:func:`repro_torch.core.clipping.corner_lows`), clamped so the
    window ends inside the padded image."""
    r0, c0 = corner_lows(gs, mats, ty, chunk, zs)
    return (torch.clamp(r0, max=pad_rows - band),
            torch.clamp(c0, max=pad_cols - width))


def _per_voxel(o, ty, chunk):
    return o.repeat_interleave(ty, dim=-2).repeat_interleave(chunk, dim=-1)


def _windowed_taps(img, ix, iy, inside):
    """Bilinear of ``img`` (``(rows, cols)`` bordered) at ``(ix, iy)``;
    a tap reads 0 outside the image and where ``inside(rows, cols)`` is
    False.  The blend is :func:`backproject_padded_ref`'s."""
    fx, fy = torch.floor(ix), torch.floor(iy)
    sx, sy = ix - fx, iy - fy
    c, r = _tap_index(fx), _tap_index(fy)
    rows, cols = img.shape
    flat = img.reshape(-1)

    def tap(rq, cq):
        ok = (rq >= 0) & (rq < rows) & (cq >= 0) & (cq < cols) \
            & inside(rq, cq)
        idx = rq.clamp(0, rows - 1) * cols + cq.clamp(0, cols - 1)
        return torch.where(ok, flat[idx], 0.0)

    return _blend(tap(r, c), tap(r, c + 1), tap(r + 1, c),
                  tap(r + 1, c + 1), sx, sy)


def _fold_windowed(volume, values, mats, gs: GeomStatic, z0: int,
                   windows):
    """``volume += Σ_p bilinear(values[p]) / w_p²`` in place, each tap
    read through the window rule ``windows(zs, ix, iy)``: given a slab's
    z-planes and ``(P, nz, L, L)`` coordinates it returns, per projection
    ``p``, a function ``inside(rows, cols)`` of padded tap positions."""
    nz, P = volume.shape[0], values.shape[0]
    for s in range(0, nz, _SLAB):
        e = min(s + _SLAB, nz)
        zs = torch.arange(z0 + s, z0 + e, device=volume.device)
        ix, iy, w = plane_coords(mats, gs, zs)          # (P, nz, L, L)
        inside = windows(zs, ix, iy)
        acc = volume[s:e]
        for p in range(P):
            acc += contribution(
                _windowed_taps(values[p], ix[p], iy[p], inside(p)), w[p])
    return volume


def _box(r0, c0, band, width):
    def inside(rq, cq):
        dr, dc = rq - r0, cq - c0
        return (dr >= 0) & (dr < band) & (dc >= 0) & (dc < width)
    return inside


def backproject_strip_ref(volume, values, mats, gs: GeomStatic, *,
                          ty: int, chunk: int, band: int, width: int,
                          pad_rows: int, pad_cols: int, z0: int = 0):
    """Plain version of K3 ``strip_db`` (and of every strip fold): taps
    read from a ``(band, width)`` window per ``(ty, chunk)`` tile and
    projection, at the tile's corner-based origin (module docstring).
    ``values``: the decoded ``(P, n_v + 2, n_u + 2)`` float32 stack
    (:func:`decode_wire`); ``pad_rows``/``pad_cols`` from
    :func:`padded_dims`.  Updates ``volume`` in place."""
    def windows(zs, ix, iy):
        r0, c0 = _corner_origins(mats, zs, gs, ty, chunk, band, width,
                                 pad_rows, pad_cols)
        r0, c0 = _per_voxel(r0, ty, chunk), _per_voxel(c0, ty, chunk)
        return lambda p: _box(r0[p], c0[p], band, width)
    return _fold_windowed(volume, values, mats, gs, z0, windows)


def backproject_micro_ref(volume, values, mats, gs: GeomStatic, *,
                          ty: int, chunk: int, band: int, width: int,
                          pad_rows: int, pad_cols: int, group: int,
                          gband: int, gwidth: int, z0: int = 0):
    """Plain version of K4 ``strip_micro``: inside each tile's strip (as
    :func:`backproject_strip_ref`), taps read from a ``(gband, gwidth)``
    micro window per run of ``group`` consecutive x-voxels (module
    docstring).  ``group`` divides ``chunk``; ``gband <= band``,
    ``gwidth <= width``."""
    def windows(zs, ix, iy):
        r0, c0 = _corner_origins(mats, zs, gs, ty, chunk, band, width,
                                 pad_rows, pad_cols)
        r0, c0 = _per_voxel(r0, ty, chunk), _per_voxel(c0, ty, chunk)

        def origin(f, o, size, gsize):
            rel = torch.clamp(_tap_index(torch.floor(f)) - o, 0, size - 1)
            lo = rel.reshape(rel.shape[:-1] + (-1, group)).amin(dim=-1)
            lo = torch.clamp(lo, 0, size - gsize)
            return o + lo.repeat_interleave(group, dim=-1)

        r0g = origin(iy, r0, band, gband)
        c0g = origin(ix, c0, width, gwidth)
        return lambda p: _box(r0g[p], c0g[p], gband, gwidth)
    return _fold_windowed(volume, values, mats, gs, z0, windows)


def backproject_shared_ref(volume, values, mats, gs: GeomStatic, *,
                           ty: int, chunk: int, band: int, width: int,
                           pad_rows: int, pad_cols: int, z0: int = 0):
    """Plain version of K5 ``strip_shared``: the ``P`` projections of
    the call are one group; per tile every projection reads a ``(band,
    width)`` window anchored at the minimum of the group's corner
    origins (module docstring)."""
    def windows(zs, ix, iy):
        r0, c0 = _corner_origins(mats, zs, gs, ty, chunk, band, width,
                                 pad_rows, pad_cols)
        inside = _box(_per_voxel(r0.amin(dim=0), ty, chunk),
                      _per_voxel(c0.amin(dim=0), ty, chunk), band, width)
        return lambda p: inside
    return _fold_windowed(volume, values, mats, gs, z0, windows)
