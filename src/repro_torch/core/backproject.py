"""Voxel-driven cone-beam back projection — the paper's kernel, in PyTorch.

The port's counterpart of ``repro.core.backproject``, keeping Listing 1's
three parts:

* **Part 1** (:func:`plane_coords`): VCS->WCS->ICS transform with the
  reciprocal trick (one reciprocal replaces the three divides).
* **Part 2** (``sample_*``): the four bilinear taps and their blend, by
  one of five strategies of identical semantics (floor taps, zero
  outside the detector):

  ========== ==========================================================
  ``scalar``  per-tap bounds-checked loads (Listing 1)
  ``gather``  index gathers on the 1-pixel zero-padded image
  ``onehot``  bilinear sampling as two one-hot products
  ``strip``   per x-chunk ``(band, width)`` window + banded one-hot
  ``strip2``  per ``group`` of voxels a ``(gband, gwidth)`` window
  ========== ==========================================================

  ``strip``/``strip2`` select taps from a window with one-hot compares,
  so a tap outside the window is dropped: :func:`validate_strip_opts`
  checks the windows against the host planner.  They also carry the
  projection *wire* (``strip_dtype``): ``"float32"``, ``"bfloat16"``
  (values rounded to bf16) or ``"int8"`` (per-row affine codes,
  :mod:`repro_torch.quant`, dequantised after the window is read).
* **Part 3** (:func:`contribution` / :func:`accumulate`): the ``1/w^2``
  weight and the voxel update.

On a CPU volume the folds run the named strategy here.  On a CUDA volume
every strategy folds through the hand-written kernel of row 1
(:mod:`repro_torch.kernels.backproject_ops`), which reads the four taps
straight from the padded image: the window options (``chunk``, ``band``,
``width``, ``strips_per_block``, ``group``, ``gband``, ``gwidth``,
``groups_per_block``, ``vox_block``) are carried in the plan but cannot
change a result there, so they are checked against the planner only on
the CPU (:func:`check_windows`); ``strip_dtype`` picks the kernel's
wire.  A plan whose tuned kernel beat the strategies (``use_pallas``,
:mod:`repro_torch.dispatch`) folds through that kernel on either
device, and its staged windows are checked on both.

The reference returns a new volume; the port updates the volume tensor
**in place** (and returns it), so a fold never holds two volumes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._device import as_f32, resolve_device
from ..quant import RowQuant, dequantize_rows, quantize_rows
from .geometry import Geometry

__all__ = [
    "STRATEGIES",
    "DEFAULT_PBATCH",
    "GeomStatic",
    "plane_coords",
    "sample_scalar",
    "sample_gather",
    "sample_onehot",
    "sample_strip",
    "sample_strip2",
    "strip_wire_dtype",
    "contribution",
    "accumulate",
    "backproject_plane",
    "backproject_plane_batch",
    "backproject_one",
    "backproject_batch",
    "fold_projections",
    "validate_strip_opts",
    "check_windows",
    "reconstruct",
]

STRATEGIES = ("scalar", "gather", "onehot", "strip", "strip2")

# Wire dtypes of the strip strategies and the kernel.  ``None`` leaves
# the float32 image untouched (the f32 path inserts no conversion).
_STRIP_WIRE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                      "int8": torch.int8}


def strip_wire_dtype(strip_dtype: str):
    """Map a ``strip_dtype`` option to a torch dtype (``None`` = float32
    passthrough).  Unknown names raise: a typo never runs float32."""
    try:
        return _STRIP_WIRE_DTYPES[str(strip_dtype)]
    except KeyError:
        raise ValueError(
            f"unknown strip_dtype {strip_dtype!r}; want one of "
            f"{tuple(_STRIP_WIRE_DTYPES)}") from None


# Projections folded into the volume per volume pass (DESIGN.md §7): the
# volume streams through memory ceil(n_proj / pbatch) times.
DEFAULT_PBATCH = 4

_EPS_W = 1e-6

# z-planes the CPU folds vectorise at once: bounds the (pbatch, slab,
# L, L) temporaries.
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


def _blend(bl, br, tl, tr, sx, sy):
    valb = (1.0 - sx) * bl + sx * br
    valt = (1.0 - sx) * tl + sx * tr
    return (1.0 - sy) * valb + sy * valt


# ----------------------------------------------------------------------
# Part 2 — the four-tap fetch + bilinear blend
# ----------------------------------------------------------------------

def _sample_bounded(image, ix, iy, shift: int = 0):
    """Bilinear taps at ``(floor(iy) + shift, floor(ix) + shift)`` of
    ``image`` (``(rows, cols)``, or a ``(P, rows, cols)`` stack whose
    leading axis matches that of ``ix``/``iy``), each reading 0 outside
    the image."""
    iix, iiy, sx, sy = _taps(ix, iy)
    iix, iiy = iix + shift, iiy + shift
    rows, cols = image.shape[-2:]
    nb = image.shape[0] if image.ndim == 3 else 1
    flat = image.reshape(nb, rows * cols)

    def tap(r, c):
        ok = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
        idx = r.clamp(0, rows - 1) * cols + c.clamp(0, cols - 1)
        val = torch.gather(flat, 1, idx.reshape(nb, -1)).reshape(r.shape)
        return torch.where(ok, val, 0.0)

    return _blend(tap(iiy, iix), tap(iiy, iix + 1), tap(iiy + 1, iix),
                  tap(iiy + 1, iix + 1), sx, sy)


def sample_scalar(image, ix, iy, gs: GeomStatic):
    """Listing-1 transliteration: four bounds-checked loads per voxel.

    ``image`` is the *unpadded* ``(n_v, n_u)`` projection, or a ``(P,
    n_v, n_u)`` stack whose leading axis matches the leading axis of
    ``ix``/``iy``.  Taps outside the detector read 0.
    """
    if tuple(image.shape[-2:]) != (gs.n_v, gs.n_u):
        raise ValueError(f"image must be (..., {gs.n_v}, {gs.n_u}); got "
                         f"{tuple(image.shape)}")
    return _sample_bounded(image, ix, iy)


def sample_gather(padded, ix, iy, gs: GeomStatic):
    """Four index gathers on the 1-pixel zero-padded ``(n_v + 2, n_u +
    2)`` image, indices clamped into it: every clamped-out tap lands on
    a zero border cell, so no per-tap condition is left."""
    iix, iiy, sx, sy = _taps(ix, iy)
    r = torch.clamp(iiy + 1, 0, gs.n_v + 1)
    r2 = torch.clamp(iiy + 2, 0, gs.n_v + 1)
    c = torch.clamp(iix + 1, 0, gs.n_u + 1)
    c2 = torch.clamp(iix + 2, 0, gs.n_u + 1)
    return _blend(padded[r, c], padded[r, c2], padded[r2, c],
                  padded[r2, c2], sx, sy)


def sample_onehot(padded, ix, iy, gs: GeomStatic, *, vox_block: int = 512):
    """Bilinear sampling as two one-hot products: ``val[p] = rowsel[p]
    @ padded @ colsel[p]``, ``rowsel``/``colsel`` carrying the
    interpolation weights on the two tap rows/columns.  Out-of-range
    taps give all-zero one-hot rows, so zero-outside is exact.
    ``vox_block`` voxels are selected per product (bounds memory)."""
    R, W = gs.n_v + 2, gs.n_u + 2
    iix, iiy, sx, sy = (t.reshape(-1) for t in _taps(ix, iy))
    riota = torch.arange(R, device=padded.device)
    ciota = torch.arange(W, device=padded.device)
    out = torch.empty(iix.shape, dtype=torch.float32, device=padded.device)
    vb = max(1, int(vox_block))
    for s in range(0, out.shape[0], vb):
        rr = iiy[s:s + vb, None] + 1            # padded row of lower tap
        cc = iix[s:s + vb, None] + 1
        syb, sxb = sy[s:s + vb, None], sx[s:s + vb, None]
        rowsel = (riota == rr) * (1.0 - syb) + (riota == rr + 1) * syb
        colsel = (ciota == cc) * (1.0 - sxb) + (ciota == cc + 1) * sxb
        out[s:s + vb] = torch.sum((rowsel @ padded) * colsel, dim=-1)
    return out.reshape(ix.shape)


def _divisor_at_most(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k``."""
    k = max(1, min(int(k), n))
    while n % k:
        k -= 1
    return k


def _strip_bounds(idx, lo_clip, hi_clip, pad_origin_max):
    """Chunk-min tap origin, clamped into the padded image: the lowest
    tap of the chunk sits at padded ``floor(min(idx)) + 1``, so the
    origin ``floor(min(idx))`` leaves one margin row/col below it."""
    clipped = torch.clamp(idx, lo_clip, hi_clip)
    lo = torch.floor(torch.amin(clipped, dim=-1)).to(torch.int64)
    return torch.clamp(lo, 0, pad_origin_max)


def _wire_image(padded, strip_dtype: str):
    """The float32 values the strip samplers read for a wire: the image
    itself (f32), its bf16 rounding, or its int8 codes decoded.
    ``padded`` may be a pre-encoded :class:`RowQuant` on the int8 wire
    only."""
    wire = strip_wire_dtype(strip_dtype)
    if wire is torch.int8:
        rq = padded if isinstance(padded, RowQuant) else \
            quantize_rows(padded)
        return dequantize_rows(rq)
    if isinstance(padded, RowQuant):
        raise TypeError(
            f"RowQuant-encoded image requires strip_dtype='int8'; got "
            f"{strip_dtype!r}")
    if wire is not None:
        return padded.to(wire).to(torch.float32)
    return padded


def _window_sample(img, ix, iy, gs: GeomStatic, chunk: int, band: int,
                   width: int, per_block: int):
    """Cut the x lines into ``chunk``-voxel pieces; for each, read one
    ``(band, width)`` window of ``img`` at the chunk's lowest tap and
    select the taps with one-hot compares.  Taps outside the window
    select all-zero rows and are dropped (the caller validates)."""
    L = gs.L
    chunk = _divisor_at_most(L, chunk)
    band = min(int(band), gs.n_v + 2)
    width = min(int(width), gs.n_u + 2)
    ixs, iys = ix.reshape(-1, chunk), iy.reshape(-1, chunk)
    iix, iiy, sx, sy = _taps(ixs, iys)
    r0 = _strip_bounds(iys, -1.0, float(gs.n_v), gs.n_v + 2 - band)
    c0 = _strip_bounds(ixs, -1.0, float(gs.n_u), gs.n_u + 2 - width)
    rel_r = iiy + 1 - r0[:, None]               # window-relative tap rows
    rel_c = iix + 1 - c0[:, None]
    biota = torch.arange(band, device=img.device)
    wiota = torch.arange(width, device=img.device)
    out = torch.empty(ixs.shape, dtype=torch.float32, device=img.device)
    nb = max(1, int(per_block))
    for s in range(0, ixs.shape[0], nb):
        e = s + nb
        win = img[r0[s:e, None, None] + biota[:, None],
                  c0[s:e, None, None] + wiota]          # (nb, band, width)
        rr, cc = rel_r[s:e, :, None], rel_c[s:e, :, None]
        syb, sxb = sy[s:e, :, None], sx[s:e, :, None]
        rowsel = (biota == rr) * (1.0 - syb) + (biota == rr + 1) * syb
        colsel = (wiota == cc) * (1.0 - sxb) + (wiota == cc + 1) * sxb
        out[s:e] = torch.sum(torch.bmm(rowsel, win) * colsel, dim=-1)
    return out.reshape(ix.shape)


def sample_strip(padded, ix, iy, gs: GeomStatic, *, chunk: int = 128,
                 band: int = 16, width: int = 512,
                 strips_per_block: int = 64,
                 strip_dtype: str = "float32"):
    """Per x-chunk ``(band, width)`` window of the padded image, taps
    selected with a banded one-hot (the fastrabbit pairwise-load
    analogue).  ``strip_dtype`` is the wire the window is read in
    (``padded`` may be a :class:`RowQuant` for ``"int8"``); the
    selection runs in float32."""
    img = _wire_image(padded, strip_dtype)
    return _window_sample(img, ix, iy, gs, chunk, band, width,
                          strips_per_block)


def sample_strip2(padded, ix, iy, gs: GeomStatic, *, group: int = 8,
                  gband: int = 8, gwidth: int = 64,
                  groups_per_block: int = 512,
                  strip_dtype: str = "float32"):
    """``strip`` with a small ``(gband, gwidth)`` window per ``group``
    of voxels.  Same semantics provided the window covers each group's
    taps, which :func:`validate_strip_opts` checks."""
    img = _wire_image(padded, strip_dtype)
    return _window_sample(img, ix, iy, gs, group, gband, gwidth,
                          groups_per_block)


def _sample(strategy, image, padded, ix, iy, gs, opts):
    if strategy == "scalar":
        return sample_scalar(image, ix, iy, gs)
    if strategy == "gather":
        return sample_gather(padded, ix, iy, gs)
    if strategy == "onehot":
        return sample_onehot(padded, ix, iy, gs, **opts)
    if strategy == "strip":
        return sample_strip(padded, ix, iy, gs, **opts)
    if strategy == "strip2":
        return sample_strip2(padded, ix, iy, gs, **opts)
    raise ValueError(f"unknown strategy {strategy!r}; want {STRATEGIES}")


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

def _pad_image(image):
    """The 1-pixel zero border (on the last two axes)."""
    return F.pad(image, (1, 1, 1, 1))


def _wire_padded(padded, opts: dict):
    """Encode the padded image(s) once per fold for the int8 wire, so
    the samplers never re-encode; every other wire passes through."""
    if opts.get("strip_dtype") != "int8":
        return padded
    return quantize_rows(padded)


def _take(stack, i):
    """Index a projection stack (a tensor, or a tuple of tensors such
    as a :class:`RowQuant`) along its leading axis."""
    if isinstance(stack, tuple):
        parts = [_take(t, i) for t in stack]
        return type(stack)(*parts) if hasattr(stack, "_fields") \
            else tuple(parts)
    return stack[i]


def backproject_plane(plane, image, padded, A, gs: GeomStatic, z,
                      strategy: str = "scalar", **opts):
    """Back-project one projection into z-plane(s) ``z``; returns the
    new plane.  ``padded`` is the zero-bordered image (or its int8
    encoding), read by every strategy but ``scalar``."""
    ix, iy, w = plane_coords(A, gs, z)
    return accumulate(plane, _sample(strategy, image, padded, ix, iy, gs,
                                     opts), w)


def backproject_plane_batch(plane, images, padded, mats, gs: GeomStatic, z,
                            strategy: str = "scalar", **opts):
    """Back-project a *batch* of projections into z-plane(s).

    ``plane`` is ``(L, L)`` for a scalar ``z`` or ``(Z, L, L)`` for a 1-D
    ``z``; ``images`` ``(P, n_v, n_u)``; ``padded`` their zero-bordered
    stack (or its int8 encoding); ``mats`` ``(P, 3, 4)``.  The batch's
    contributions are summed, then added to the plane once (the
    inverted loop nest of DESIGN.md §7).  Returns the new plane.
    """
    if strategy == "scalar":
        ix, iy, w = plane_coords(mats, gs, z)
        val = sample_scalar(images, ix, iy, gs)
        return plane + torch.sum(contribution(val, w), dim=0)
    contribs = []
    for p in range(images.shape[0]):
        ix, iy, w = plane_coords(mats[p], gs, z)
        val = _sample(strategy, images[p], _take(padded, p), ix, iy, gs,
                      opts)
        contribs.append(contribution(val, w))
    return plane + torch.sum(torch.stack(contribs), dim=0)


def _backproject_batch_body(volume, images, padded, mats, gs: GeomStatic,
                            plan, z0: int):
    """One volume pass for one projection batch, in place.

    ``volume`` may be a z-slab whose first global z index is ``z0``.
    """
    nz = volume.shape[0]
    opts = plan.jnp_opts()
    for s in range(0, nz, _SLAB):
        e = min(s + _SLAB, nz)
        zs = torch.arange(z0 + s, z0 + e, device=volume.device)
        volume[s:e] = backproject_plane_batch(volume[s:e], images, padded,
                                              mats, gs, zs, plan.strategy,
                                              **opts)
    return volume


def _stream_batches(projections, matrices, volume, pbatch: int, call):
    """Fold the projection stack into ``volume``, ``pbatch`` at a time.

    The one batch-chunking loop the CPU folds and the kernel wrapper
    share: full batches first, then a ``pbatch ∤ n_proj`` remainder as
    one final smaller batch.  ``projections`` is a tensor or a tuple of
    tensors sharing the leading projection axis (each batch slices every
    one); ``call(vol, imgs, mats)`` performs one volume pass.
    """
    lead = projections[0] if isinstance(projections, tuple) \
        else projections
    n_proj = int(lead.shape[0])
    pbatch = max(1, min(int(pbatch), n_proj)) if n_proj else 1
    for b0 in range(0, n_proj, pbatch):
        sl = slice(b0, b0 + pbatch)
        volume = call(volume, _take(projections, sl), matrices[sl])
    return volume


def _explicit_plan(strategy: str, opts: dict, pbatch: int | None = None):
    from ..dispatch.plan import ExecutionPlan

    return ExecutionPlan.explicit(strategy, opts, pbatch)


def _resolve_plan(geom, strategy: str, opts: dict, pbatch: int | None):
    """``strategy="auto"`` through the process dispatcher (cache hit,
    in-situ selection or the logged fallback); any other name strictly
    (:meth:`repro_torch.dispatch.ExecutionPlan.explicit`)."""
    if strategy == "auto":
        from ..dispatch import get_dispatcher

        return get_dispatcher().resolve(geom, "auto", opts, pbatch=pbatch)
    return _explicit_plan(strategy, opts, pbatch)


def _fold(volume, images, mats, geom, plan, z0: int):
    if not torch.is_tensor(volume) or volume.dtype != torch.float32:
        raise TypeError("volume must be a float32 tensor (updated in place)")
    gs = _gs(geom)
    images = as_f32(images, volume.device)
    mats = as_f32(mats, volume.device)
    if plan.use_pallas:
        # The tuned kernel beat the strategies: fold through it, at the
        # plan's depth; the caller checked its windows (check_windows).
        from ..kernels.backproject_ops import backproject_batch as kernel

        return kernel(volume, images, mats, geom, z0=z0, validate=False,
                      **dict(plan.pallas_opts(), pbatch=plan.pbatch))
    if volume.is_cuda:
        from ..kernels.backproject_ops import backproject_batch as kernel

        return kernel(volume, images, mats, gs, pbatch=plan.pbatch, z0=z0,
                      strip_dtype=plan.strip_dtype)
    if plan.strategy == "scalar":       # reads the unpadded images only
        return _stream_batches(
            images, mats, volume, plan.pbatch,
            lambda vol, imgs, ms: _backproject_batch_body(
                vol, imgs, None, ms, gs, plan, z0))
    padded = _wire_padded(_pad_image(images), plan.jnp_opts())
    return _stream_batches(
        (images, padded), mats, volume, plan.pbatch,
        lambda vol, pair, ms: _backproject_batch_body(
            vol, pair[0], pair[1], ms, gs, plan, z0))


def backproject_one(volume, image, A, geom: Geometry | GeomStatic,
                    strategy: str = "scalar", **opts):
    """Add one ``(n_v, n_u)`` projection with its ``(3, 4)`` matrix to
    ``volume`` (``(L, L, L)``) in place; returns ``volume``."""
    if not torch.is_tensor(volume):
        raise TypeError("volume must be a float32 tensor (updated in place)")
    image = as_f32(image, volume.device)
    if image.ndim != 2:
        raise ValueError("image must be one (n_v, n_u) projection")
    plan = _explicit_plan(strategy, opts, 1)
    return _fold(volume, image[None],
                 torch.as_tensor(A, dtype=torch.float32).reshape(1, 3, 4),
                 geom, plan, 0)


def backproject_batch(volume, images, mats, geom: Geometry | GeomStatic,
                      strategy: str = "scalar",
                      pbatch: int = DEFAULT_PBATCH, **opts):
    """Add a stack of projections to ``volume`` in place, ``pbatch`` per
    volume pass; returns ``volume``.

    ``images`` is ``(n_proj, n_v, n_u)`` (filtered), ``mats`` ``(n_proj,
    3, 4)``; both are moved to the volume's device.  Windows are not
    validated here (see :func:`validate_strip_opts`).
    """
    plan = _explicit_plan(strategy, opts, int(pbatch))
    return _fold(volume, images, mats, geom, plan, 0)


def fold_projections(volume, images, mats, geom: Geometry | GeomStatic,
                     strategy: str = "scalar",
                     pbatch: int = DEFAULT_PBATCH, z0: int = 0, *,
                     plan=None, validate: bool = True, **opts):
    """Incremental fold: add a projection *chunk* to an existing volume,
    in place.

    ``volume`` may be a partial accumulation from earlier chunks, and a
    z-slab ``(nz, L, L)`` whose first global z index is ``z0``.  Any
    sequence of folds whose chunks cover the projection set once gives
    the reconstruction, in any arrival order (fp32 summation order
    differs, so cross-order agreement is ~1e-5, not bitwise).  A
    pre-built ``plan`` (:class:`repro_torch.dispatch.ExecutionPlan`)
    replaces ``strategy``/``pbatch``/``opts``.  With a full
    :class:`Geometry` and ``validate=True`` the windows are checked
    against the planner where they are read (see :func:`check_windows`);
    pass ``validate=False`` where the chunk's matrices were checked
    before.
    """
    if plan is None:
        plan = _explicit_plan(strategy, opts, int(pbatch))
    if validate and isinstance(geom, Geometry) and torch.is_tensor(volume):
        check_windows(geom, mats, plan, volume.device)
    return _fold(volume, images, mats, geom, plan, int(z0))


def validate_strip_opts(geom: Geometry, matrices, strategy: str,
                        opts: dict, *, device=None) -> None:
    """Planner-backed check that ``strip``/``strip2`` windows cover
    every chunk's taps.

    A tap outside a window selects an all-zero one-hot row and is
    dropped silently; this raises ``ValueError`` with the required
    window sizes instead.  No-op for strategies without windows.  The
    planner (:func:`repro_torch.core.clipping.strip_needs`) runs in
    float64 on ``device`` (default: where the matrices lie) and
    memoises each matrix's needs.
    """
    if strategy == "strip":
        chunk = _divisor_at_most(geom.L, int(opts.get("chunk", 128)))
        band = min(int(opts.get("band", 16)), geom.n_v + 2)
        width = min(int(opts.get("width", 512)), geom.n_u + 2)
        what = f"strip (chunk={chunk}, band={band}, width={width})"
    elif strategy == "strip2":
        chunk = _divisor_at_most(geom.L, int(opts.get("group", 8)))
        band = min(int(opts.get("gband", 8)), geom.n_v + 2)
        width = min(int(opts.get("gwidth", 64)), geom.n_u + 2)
        what = f"strip2 (group={chunk}, gband={band}, gwidth={width})"
    else:
        return
    from .clipping import strip_needs

    need_band, need_width = (int(n) for n in strip_needs(
        geom, matrices, chunk=chunk, device=device).max(axis=0))
    # A full-detector window never loses a tap: the requirement
    # saturates at the padded image.
    need_band = min(need_band, geom.n_v + 2)
    need_width = min(need_width, geom.n_u + 2)
    if band < need_band or width < need_width:
        raise ValueError(
            f"{what} does not cover the chunk tap footprint for this "
            f"geometry; need at least (band={need_band}, "
            f"width={need_width}) — undersized windows drop taps "
            f"silently")


def check_windows(geom: Geometry, matrices, plan, device) -> None:
    """The window check ``plan`` needs where its windows are read.

    A plan that folds through a tuned strip kernel (``use_pallas``)
    reads that kernel's staged windows on either device: they are
    checked on ``device``'s planner
    (:func:`repro_torch.kernels.backproject_ops.check_variant_windows`).
    Otherwise the strategy's windows are read only on the CPU; on a CUDA
    device every strategy folds through row 1, which reads taps
    directly, so nothing is checked there."""
    dev = torch.device(device)
    if plan.use_pallas:
        from ..kernels.backproject_ops import check_variant_windows

        check_variant_windows(geom, matrices, plan.pallas_opts(),
                              device=dev)
    elif dev.type == "cpu":
        validate_strip_opts(geom, matrices, plan.strategy, plan.jnp_opts(),
                            device=dev)


def reconstruct(projections, matrices, geom: Geometry, *,
                strategy: str = "scalar", volume=None,
                pbatch: int | None = None, plan=None,
                validate: bool = True, device="cuda", **opts):
    """Full reconstruction: stream every *filtered* projection
    ``(n_proj, n_v, n_u)`` with its ``(n_proj, 3, 4)`` matrix into the
    volume, ``pbatch`` (default: the plan's) per volume pass.

    ``strategy="auto"`` resolves through the process dispatcher
    (:mod:`repro_torch.dispatch`: a cached decision, in-situ selection,
    or the logged ``strip2`` fallback); any other ``strategy`` and
    ``opts`` are validated strictly
    (:meth:`repro_torch.dispatch.ExecutionPlan.explicit`); a pre-built
    ``plan`` replaces them.  ``validate=True`` checks the windows the
    fold reads against the planner first (:func:`check_windows`; pass
    ``False`` where the windows were checked before).  ``volume`` (on
    ``device``) is updated in place; ``None`` starts from zeros on
    ``device``.
    """
    dev = resolve_device(device)
    gs = GeomStatic.of(geom)
    if plan is None:
        plan = _resolve_plan(geom, strategy, opts, pbatch)
    if validate:
        check_windows(geom, matrices, plan, dev)
    if volume is None:
        volume = torch.zeros((gs.L, gs.L, gs.L), dtype=torch.float32,
                             device=dev)
    elif volume.device != dev:
        raise ValueError(f"volume lies on {volume.device}, not {dev}")
    return _fold(volume, projections, matrices, geom, plan, 0)
