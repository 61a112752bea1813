"""Clipping masks and strip planning, in PyTorch float64 on any device.

The port's counterpart of ``repro.core.clipping``, on tensors.  Per
``(z, y)`` voxel line, :func:`line_clip_exact` gives the exact ``x``
range whose projection lands on the detector (the paper's improved
clipping mask); :func:`plan_strips` extends it to a **strip plan**: per
``(projection, z, y, x-chunk)`` the origin of the smallest detector
rectangle holding every bilinear tap of the chunk.  The plans check that
a window covers every tap it must hold: the ``strip``/``strip2``
windows of the CPU samplers
(:func:`repro_torch.core.backproject.validate_strip_opts`) and the
staged windows of the strip kernels
(:func:`repro_torch.kernels.backproject_ops.validate_strip_config`,
:func:`repro_torch.kernels.backproject_ops.shared_window_dims`).

One implementation serves the CPU and the card.  Every operation is an
elementwise float64 operation in the reference's order (a division is
always by a tensor: PyTorch on a CUDA tensor turns a division by a
Python scalar into a multiply by its reciprocal), so the integer outputs
equal the reference's exactly on either device.  The matrices are
planned in batches; :func:`strip_needs` memoises each matrix's window
needs, so every check at one chunk reuses one plan, and a scan whose
matrices were planned once (by the tuner's sweep, say) is checked
again for free.

Monotone-beam property
----------------------
For a fixed ``(z, y)`` line, ``Z(x)`` (the homogeneous coordinate) is affine
in ``x`` and both detector coordinates are projective in ``x``:

* ``iy(x) = f * wz / Z(x) + cv`` is monotone (``1/Z`` is monotone where
  ``Z > 0``), and
* ``d(ix)/dx`` has the sign of ``U'Z - U Z'`` which is *constant* along the
  line, so ``ix(x)`` is monotone too.

Hence per-chunk strip bounds are exact from the chunk's two endpoint voxels.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .geometry import Geometry

__all__ = [
    "LinePlan",
    "StripPlan",
    "pad_projection",
    "line_clip_exact",
    "line_clip_conservative",
    "plan_strips",
    "strip_needs",
    "shared_window_requirement",
    "shared_window_cover",
    "corner_lows",
    "corner_boxes",
    "box_slot_dims",
    "strip_box_slots",
    "shared_box_slots",
]

# Margin (pixels) added around the analytic tap bounds: one for the floor()
# tap pair, one for float32-vs-float64 index disagreement near integers.
_MARGIN = 2

# float64 elements of one planner array per batch: bounds the
# temporaries of a pass (about twenty arrays of this size are alive).
_BATCH_ELEMS = 1 << 24

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class LinePlan:
    """Exact per-line clip ranges: process ``x`` in ``[x0, x1)``."""

    x0: torch.Tensor  # (L, L) int32, indexed [z, y]
    x1: torch.Tensor  # (L, L) int32

    @property
    def voxels(self) -> int:
        return int(torch.clamp(self.x1 - self.x0, min=0).sum())


@dataclasses.dataclass(frozen=True)
class StripPlan:
    """Per-chunk strip origins in *padded* image coordinates.

    ``r0``/``c0`` have shape ``(L, L, n_chunks)`` indexed ``[z, y, chunk]``.
    ``band``/``width`` are the static strip dims every chunk fits in.
    ``active`` marks chunks with at least one contributing voxel.
    """

    r0: torch.Tensor
    c0: torch.Tensor
    active: torch.Tensor
    chunk: int
    band: int
    width: int
    required_band: int
    required_width: int


def pad_projection(image: np.ndarray) -> np.ndarray:
    """Zero-pad by one pixel on every side (paper section 5.1.1).

    The paper found that copying projections into a zero-padded buffer and
    dropping the per-tap bounds checks beats masked gathers.  With a 1-pixel
    border, *every* bilinear tap of a voxel whose footprint touches the
    detector maps to a well-defined padded pixel, and all out-of-detector
    taps map either to the zero border or outside any planned strip (where
    the one-hot selection contributes zero by construction).
    """
    n_v, n_u = image.shape[-2:]
    out = np.zeros(image.shape[:-2] + (n_v + 2, n_u + 2), dtype=image.dtype)
    out[..., 1:-1, 1:-1] = image
    return out


def _host64(matrices) -> np.ndarray:
    if torch.is_tensor(matrices):
        matrices = matrices.detach().cpu().numpy()
    return np.asarray(matrices, np.float64).reshape(-1, 3, 4)


def _device(matrices, device) -> torch.device:
    """``device``, or where the matrices lie (the CPU for host arrays)."""
    if device is not None:
        return torch.device(device)
    return matrices.device if torch.is_tensor(matrices) \
        else torch.device("cpu")


# ----------------------------------------------------------------------
# Exact per-line clipping (paper's improved clipping mask)
# ----------------------------------------------------------------------

def _line_coeffs(geom: Geometry, A: torch.Tensor):
    """Affine coefficients of (u', v', w) along x for all (z, y) lines of
    each matrix of the ``(n, 3, 4)`` float64 stack ``A``.

    Returns ``(n, L, L)`` x=0 intercepts indexed ``[m, z, y]`` and
    ``(n, 1, 1)`` slopes: ``u'(x) = pu + qu * x`` etc.
    """
    L = geom.L
    wcoord = geom.O + torch.arange(L, dtype=_F64, device=A.device) * geom.MM
    wy = wcoord[None, None, :]    # y varies on axis 2
    wz = wcoord[None, :, None]    # z varies on axis 1
    w0 = geom.O                   # world x at voxel x=0

    def a(i, j):
        return A[:, i, j].reshape(-1, 1, 1)

    pu = a(0, 0) * w0 + a(0, 1) * wy + a(0, 2) * wz + a(0, 3)
    pv = a(1, 0) * w0 + a(1, 1) * wy + a(1, 2) * wz + a(1, 3)
    pw = a(2, 0) * w0 + a(2, 1) * wy + a(2, 2) * wz + a(2, 3)
    return (pu, pv, pw), (a(0, 0) * geom.MM, a(1, 0) * geom.MM,
                          a(2, 0) * geom.MM)


def _halfline(acc_lo, acc_hi, a, b):
    """Intersect {x : a + b*x > 0} into interval [acc_lo, acc_hi]."""
    root = -a / b
    lo = torch.where(b > 0, torch.maximum(acc_lo, root), acc_lo)
    hi = torch.where(b < 0, torch.minimum(acc_hi, root), acc_hi)
    # b == 0: condition is just a > 0 (empty interval if it fails).
    dead = (b == 0) & (a <= 0)
    lo = torch.where(dead, torch.inf, lo)
    hi = torch.where(dead, -torch.inf, hi)
    return lo, hi


def _line_clip(geom: Geometry, coeffs, eps_w: float):
    (pu, pv, pw), (qu, qv, qw) = coeffs
    L = geom.L
    lo = torch.full(pu.shape, -torch.inf, dtype=_F64, device=pu.device)
    hi = torch.full(pu.shape, torch.inf, dtype=_F64, device=pu.device)
    # w > eps
    lo, hi = _halfline(lo, hi, pw - eps_w, qw)
    # ix > -1   <=>  u' + w > 0
    lo, hi = _halfline(lo, hi, pu + pw, qu + qw)
    # ix < n_u  <=>  n_u * w - u' > 0
    lo, hi = _halfline(lo, hi, geom.n_u * pw - pu, geom.n_u * qw - qu)
    # iy > -1
    lo, hi = _halfline(lo, hi, pv + pw, qv + qw)
    # iy < n_v
    lo, hi = _halfline(lo, hi, geom.n_v * pw - pv, geom.n_v * qw - qv)
    x0 = torch.clamp(torch.ceil(lo), 0, L).to(torch.int32)
    x1 = torch.clamp(torch.floor(hi) + 1, 0, L).to(torch.int32)
    return x0, torch.maximum(x1, x0)


def line_clip_exact(geom: Geometry, A, eps_w: float = 1e-6,
                    device=None) -> LinePlan:
    """Exact ``[x0, x1)`` per line such that outside it no tap contributes.

    A voxel contributes iff ``-1 < ix < n_u`` and ``-1 < iy < n_v`` and
    ``w > 0``.  Each bound is a linear inequality in ``x`` (after
    multiplying through by ``w > 0``), so the valid set is an interval —
    the "improved clipping mask" of paper section 5.  Runs on ``device``
    (default: where ``A`` lies, the CPU for a host array).
    """
    dev = _device(A, device)
    At = torch.as_tensor(_host64(A), device=dev)
    x0, x1 = _line_clip(geom, _line_coeffs(geom, At), eps_w)
    return LinePlan(x0=x0[0], x1=x1[0])


def line_clip_conservative(geom: Geometry, A: np.ndarray) -> LinePlan:
    """The pre-fix mask: per z-plane all-or-nothing corner test.

    Mirrors the "original algorithm with minor flaws" the paper improved
    on: project the four corners of each z-plane; if any corner's footprint
    may touch the detector, process *every* voxel of the plane.  A host
    computation (four corners per plane); the planes' flags come back as
    CPU tensors.
    """
    from .geometry import project_voxels, voxel_world_coords

    L = geom.L
    A = _host64(A)[0]
    corners = voxel_world_coords(geom, np.array([0, L - 1], dtype=np.float64))
    x1 = np.zeros((L, L), dtype=np.int32)
    for zi in range(L):
        wz = voxel_world_coords(geom, zi)
        cx, cy = np.meshgrid(corners, corners)
        ix, iy, w = project_voxels(A, cx.ravel(), cy.ravel(),
                                   np.full(4, wz))
        if (w <= 0).any():
            # Projective hull argument breaks behind the source; take
            # the whole plane.
            x1[zi, :] = L
            continue
        # The plane's projection lies in the convex hull of its corner
        # projections (w > 0), so a bounding-box overlap test is truly
        # conservative.  (An "any corner inside" test is NOT — detector
        # cones can cross a plane whose corners all miss; cf. the
        # paper's remark that the original mask "had minor flaws".)
        hit = ((ix.max() > -1) & (ix.min() < geom.n_u)
               & (iy.max() > -1) & (iy.min() < geom.n_v))
        x1[zi, :] = L if hit else 0
    return LinePlan(x0=torch.zeros((L, L), dtype=torch.int32),
                    x1=torch.from_numpy(x1))


# ----------------------------------------------------------------------
# Strip planning (feeds the window checks)
# ----------------------------------------------------------------------

def _round8(v):
    return max(8, (v + 7) // 8 * 8)


def _round128(v):
    return max(128, (v + 127) // 128 * 128)


def _plan(geom: Geometry, A: torch.Tensor, chunk: int, band=None,
          width=None, clip=None):
    """Strip plans of the ``(n, 3, 4)`` float64 stack ``A`` at once.

    Returns ``r0``, ``c0`` (``(n, L, L, n_chunks)`` int32), ``active``
    (bool, same shape), the ``(n,)`` int64 ``band``, ``width``,
    ``required_band`` and ``required_width``, and the float64 ``(r_hi,
    c_hi)``: one past each active chunk's highest tap row and column in
    image coordinates (``-inf`` where the chunk is inactive).
    """
    L = geom.L
    if L % chunk:
        raise ValueError(f"chunk={chunk} must divide L={L}")
    dev = A.device
    coeffs = _line_coeffs(geom, A)
    if clip is None:
        x0i, x1i = _line_clip(geom, coeffs, 1e-6)
    else:
        x0i, x1i = clip.x0.to(dev)[None], clip.x1.to(dev)[None]
    (pu, pv, pw), (qu, qv, qw) = coeffs
    n_chunks = L // chunk
    xs = (torch.arange(n_chunks, device=dev) * chunk).to(_F64)

    # Effective endpoints: the chunk extent intersected with the exact clip
    # range.  This guarantees ``w > 0`` at both endpoints (the clip range
    # enforces it), so the projective coordinates there are meaningful, and
    # by monotonicity every contributing tap lies between them.
    x0 = x0i[..., None].to(_F64)                      # (n, L, L, 1)
    x1 = x1i[..., None].to(_F64)
    xa = torch.maximum(xs, x0)
    xb = torch.minimum(xs + (chunk - 1), x1 - 1.0)
    xb = torch.maximum(xb, xa)                        # degenerate -> point

    def coords(xq):  # xq: (n, L, L, n_chunks)
        u = pu[..., None] + qu[..., None] * xq
        v = pv[..., None] + qv[..., None] * xq
        w = pw[..., None] + qw[..., None] * xq
        w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
        return u / w, v / w

    ix_a, iy_a = coords(xa)
    ix_b, iy_b = coords(xb)
    del xb

    # Clamp projected coords into the padded-image footprint before taking
    # bounds: contributions outside it are zero anyway.
    def pclip(t, n):
        return torch.clamp(t, -1.0, float(n))

    ca, cb = pclip(ix_a, geom.n_u), pclip(ix_b, geom.n_u)
    ra, rb = pclip(iy_a, geom.n_v), pclip(iy_b, geom.n_v)
    c_lo = torch.floor(torch.minimum(ca, cb))
    c_hi = torch.floor(torch.maximum(ca, cb)) + 1
    r_lo = torch.floor(torch.minimum(ra, rb))
    r_hi = torch.floor(torch.maximum(ra, rb)) + 1
    del ix_a, iy_a, ix_b, iy_b, ca, cb, ra, rb

    # Active chunks: nonempty overlap between the [x0, x1) clip range and
    # the chunk extent.
    active = torch.minimum(x1, xs + chunk) > torch.maximum(x0, xs)

    def required(hi, lo):
        span = torch.where(active, hi - lo, 0.0).amax(dim=(1, 2, 3))
        return (span + _MARGIN).to(torch.int64)

    req_band, req_width = required(r_hi, r_lo), required(c_hi, c_lo)
    if band is None:
        band = torch.clamp((req_band + 7) // 8 * 8, min=8)
    else:
        band = torch.full_like(req_band, int(band))
    if width is None:
        width = torch.clamp((req_width + 127) // 128 * 128, min=128)
    else:
        width = torch.full_like(req_width, int(width))

    # Origins in padded coordinates (padded pixel p maps image index p-1),
    # clamped so the strip stays inside the padded image (np.clip's
    # order: the lower bound first, then the upper).
    def origin(lo, n, size):
        hi = (n + 2 - size).to(_F64).reshape(-1, 1, 1, 1)
        return torch.minimum(torch.maximum(lo + 1 - _MARGIN // 2,
                                           torch.zeros((), dtype=_F64,
                                                       device=dev)), hi)

    r0 = origin(r_lo, geom.n_v, band).to(torch.int32)
    c0 = origin(c_lo, geom.n_u, width).to(torch.int32)
    hi = (torch.where(active, r_hi, -torch.inf),
          torch.where(active, c_hi, -torch.inf))
    return r0, c0, active, band, width, req_band, req_width, hi


def plan_strips(geom: Geometry, A, chunk: int, band: int | None = None,
                width: int | None = None, clip: LinePlan | None = None,
                device=None) -> StripPlan:
    """Compute per-chunk strip origins in padded-image coordinates.

    Exactness relies on the monotone-beam property (module docstring): the
    tap bounding box of an x-chunk is spanned by its endpoint voxels.  The
    returned ``required_band``/``required_width`` are the tight maxima over
    all *active* chunks; callers pass static ``band``/``width`` at least
    that large.  Runs on ``device`` (default: where ``A`` lies, the CPU
    for a host array); the tensors of the plan lie there.
    """
    dev = _device(A, device)
    At = torch.as_tensor(_host64(A)[:1], device=dev)
    r0, c0, active, b, w, rb, rw, _ = _plan(geom, At, chunk, band, width,
                                            clip)
    return StripPlan(r0=r0[0], c0=c0[0], active=active[0], chunk=chunk,
                     band=int(b[0]), width=int(w[0]),
                     required_band=int(rb[0]), required_width=int(rw[0]))


def _batches(n: int, per_matrix: int, multiple: int = 1):
    """``(start, stop)`` ranges over ``n`` matrices: as many per batch as
    :data:`_BATCH_ELEMS` allows, a multiple of ``multiple``."""
    step = max(1, _BATCH_ELEMS // per_matrix) // multiple * multiple
    step = max(multiple, step)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _span(o: torch.Tensor, ty: int, dims=()) -> torch.Tensor:
    """Per-tile origin scatter over ``ty`` adjacent y lines (and over
    ``dims``): ``o`` is ``(..., L, L, n_chunks)``."""
    g = o.reshape(o.shape[:-2] + (o.shape[-2] // ty, ty, o.shape[-1]))
    d = tuple(dims) + (g.ndim - 2,)
    return g.amax(dim=d) - g.amin(dim=d)


# (geometry, chunk, ty, matrix bytes) -> (need_band, need_width).
_NEEDS: dict = {}
# (geometry, ty, chunk, pbatch, digest of the set) -> (band, width).
_SHARED: dict = {}
_MEMO_MAX = 1 << 16


def _gkey(geom: Geometry) -> tuple:
    return (geom.L, geom.n_u, geom.n_v, float(geom.O), float(geom.MM))


def _remember(memo: dict, key, value) -> None:
    if len(memo) >= _MEMO_MAX:      # bound a long-lived process
        memo.clear()
    memo[key] = value


def strip_needs(geom: Geometry, matrices, *, chunk: int, ty: int = 1,
                device=None) -> np.ndarray:
    """Each matrix's window needs at ``chunk``: an ``(n, 2)`` int64 array
    of ``(band, width)``.

    A window covering ``ty`` adjacent lines of ``chunk`` voxels must span
    the scatter of their strip origins plus the planner's tight
    requirement: ``max(origin) - min(origin) + required`` over every such
    tile (``ty=1``: the requirement itself).  Each matrix's needs are
    memoised; the matrices not seen before are planned in batches on
    ``device`` (default: where the matrices lie).
    """
    if geom.L % ty:
        raise ValueError(f"ty={ty} must divide L={geom.L}")
    mats = _host64(matrices)
    g = _gkey(geom)
    keys = [(g, chunk, ty, m.tobytes()) for m in mats]
    todo = [i for i, k in enumerate(keys) if k not in _NEEDS]
    if todo:
        dev = _device(matrices, device)
        per = geom.L * geom.L * (geom.L // chunk)
        for s, e in _batches(len(todo), per):
            idx = todo[s:e]
            At = torch.as_tensor(mats[idx], device=dev)
            r0, c0, _, _, _, rb, rw, _ = _plan(geom, At, chunk)
            nb = (_span(r0, ty).amax(dim=(1, 2, 3)) + rb).cpu()
            nw = (_span(c0, ty).amax(dim=(1, 2, 3)) + rw).cpu()
            for j, i in enumerate(idx):
                _remember(_NEEDS, keys[i], (int(nb[j]), int(nw[j])))
                _remember(_NEEDS, (g, chunk, 1, keys[i][3]),
                          (int(rb[j]), int(rw[j])))
    return np.array([_NEEDS[k] for k in keys], np.int64).reshape(-1, 2)


def shared_window_requirement(geom: Geometry, matrices, *, ty: int,
                              chunk: int, pbatch: int,
                              device=None) -> tuple[int, int]:
    """Superset-window dims covering a whole projection group per tile.

    A shared-window batch kernel reads ONE ``(pbatch, band, width)``
    window slab per ``(z, ty-lines, x-chunk)`` volume tile, anchored at
    the elementwise minimum of the group members' strip origins.  For
    that window to cover every member's taps, its dims must span the
    group's origin scatter — across the ``ty`` merged lines (as in the
    per-projection window check) *and* across the ``pbatch`` projections
    of the group.

    Groups mirror the batch folds' chunking (``_stream_batches``):
    full ``pbatch`` groups from index 0 plus one smaller remainder
    group.  Returns the tight ``(need_band, need_width)`` maxima over
    all groups and tiles; callers must use a window at least that large
    or taps silently drop.  Memoised per matrix set; planned on
    ``device`` (default: where the matrices lie).
    """
    mats = _host64(matrices)
    L = geom.L
    if L % ty or L % chunk:
        raise ValueError(f"ty={ty} and chunk={chunk} must divide L={L}")
    key = (_gkey(geom), ty, chunk, pbatch,
           hashlib.sha1(mats.tobytes()).hexdigest())
    hit = _SHARED.get(key)
    if hit is not None:
        return hit
    dev = _device(matrices, device)
    need_band = need_width = 0
    per = L * L * (L // chunk)
    for s, e in _batches(len(mats), per, multiple=pbatch):
        At = torch.as_tensor(mats[s:e], device=dev)
        r0, c0, _, _, _, rb, rw, _ = _plan(geom, At, chunk)
        for g0 in range(0, e - s, pbatch):
            sl = slice(g0, g0 + pbatch)
            # Merge over group members (dim 0) and the ty lines a volume
            # tile spans: the kernel serves all of them from one window.
            span_r = _span(r0[sl], ty, (0,)) + rb[sl].max()
            span_c = _span(c0[sl], ty, (0,)) + rw[sl].max()
            need_band = max(need_band, int(span_r.max()))
            need_width = max(need_width, int(span_c.max()))
    _remember(_SHARED, key, (need_band, need_width))
    return need_band, need_width


def _corner_span(geom, A: torch.Tensor, ty: int, chunk: int, zs=None):
    """The least and greatest tap row and column over the four corner
    voxels of every ``(ty, chunk)`` tile of each matrix of ``A``
    (``(n, 3, 4)``), clipped into the bordered detector, in float32 with
    the kernels' (and ``plane_coords``') operations in their order, and
    whether some corner has ``w <= 1e-6``.  Each is ``(n, len(zs), L /
    ty, L / chunk)``; ``zs`` the global z-planes (default: all)."""
    L, dev = geom.L, A.device
    A32 = A.to(torch.float32)
    if zs is None:
        zs = torch.arange(L, device=dev)

    def world(idx):
        return geom.O + idx.to(torch.float32) * geom.MM

    def a(i, j):
        return A32[:, i, j].reshape(-1, 1, 1, 1)

    wz = world(zs).reshape(1, -1, 1, 1)
    lo_r = hi_r = lo_c = hi_c = flat = None
    for dy in (0, ty - 1):
        for dx in (0, chunk - 1):
            wy = world(torch.arange(0, L, ty, device=dev) + dy)
            wx = world(torch.arange(0, L, chunk, device=dev) + dx)
            wy, wx = wy.reshape(1, 1, -1, 1), wx.reshape(1, 1, 1, -1)
            u = wx * a(0, 0) + wy * a(0, 1) + wz * a(0, 2) + a(0, 3)
            v = wx * a(1, 0) + wy * a(1, 1) + wz * a(1, 2) + a(1, 3)
            w = wx * a(2, 0) + wy * a(2, 1) + wz * a(2, 2) + a(2, 3)
            r = torch.where(w > 1e-6, 1.0 / w, 0.0)
            ix = torch.clamp(u * r, -1.0, float(geom.n_u))
            iy = torch.clamp(v * r, -1.0, float(geom.n_v))
            if lo_r is None:
                lo_r, hi_r, lo_c, hi_c, flat = iy, iy, ix, ix, ~(w > 1e-6)
                continue
            lo_r, hi_r = torch.minimum(lo_r, iy), torch.maximum(hi_r, iy)
            lo_c, hi_c = torch.minimum(lo_c, ix), torch.maximum(hi_c, ix)
            flat = flat | ~(w > 1e-6)
    return lo_r, hi_r, lo_c, hi_c, flat


def corner_lows(geom, A: torch.Tensor, ty: int, chunk: int, zs=None):
    """The window origin the strip kernels compute for every ``(ty,
    chunk)`` tile of each matrix of ``A`` (``(n, 3, 4)``): the floor of
    the least tap coordinate over the tile's four corner voxels, clipped
    into the bordered detector, in float32 with the kernels' (and
    ``plane_coords``') operations in their order, clamped at 0.  (A
    kernel also clamps it so its window ends inside the padded image.)
    ``geom`` is a :class:`Geometry` or a ``GeomStatic``; ``zs`` the
    global z-planes (default: all).  Returns ``(rows, cols)``, int64
    ``(n, len(zs), L / ty, L / chunk)``."""
    lo_r, _, lo_c, _, _ = _corner_span(geom, A, ty, chunk, zs)
    return (torch.clamp(torch.floor(lo_r).to(torch.int64), min=0),
            torch.clamp(torch.floor(lo_c).to(torch.int64), min=0))


# Pixels added on each side of a tile's corner tap box against the
# float32 rounding of its voxels' own coordinates (the kernels'
# kBoxMargin).
_BOX_MARGIN = 1

# (geometry, tile, window, padded image, itemsize, matrix bytes) ->
# (rows, units) of the largest staged box (K3/K4); ("group", the same,
# the group's matrix bytes) -> units of its largest tile's boxes (K5).
_BOXES: dict = {}


def corner_boxes(geom, A: torch.Tensor, *, ty: int, chunk: int, band: int,
                 width: int, pad_rows: int, pad_cols: int, zs=None,
                 group: int = 1):
    """The box of taps the strip kernels stage for every ``(ty, chunk)``
    tile of each matrix of ``A`` (``(n, 3, 4)``), in padded image
    coordinates: rows ``[r0, r1)`` and columns ``[c0, c1)``, each int64
    ``(n, len(zs), L / ty, L / chunk)``.

    On a z-plane ``u/w`` and ``v/w`` are linear-fractional in ``(x,
    y)``, so where ``w > 0`` on the tile (``w`` is affine: at its four
    corners) every voxel's taps lie between those of the four corner
    voxels: rows ``[floor(min iy) + 1, floor(max iy) + 3)`` and the same
    for the columns, from :func:`_corner_span`, widened by
    :data:`_BOX_MARGIN` on each side.  A tile with a corner at ``w <=
    1e-6`` takes its whole window.  The box is cut to the tile's
    ``(band, width)`` window (at :func:`corner_lows`' origin, clamped so
    the window ends inside the ``(pad_rows, pad_cols)`` image) and to
    the bordered image; it is empty where ``r1 <= r0`` or ``c1 <= c0``.
    K3 and K4 cut each matrix's box to its own window (``group=1``); K5
    cuts it to its group's: with ``group=g`` each run of ``g``
    consecutive matrices shares the window at the least of their
    origins.
    """
    lo_r, hi_r, lo_c, hi_c, flat = _corner_span(geom, A, ty, chunk, zs)
    fr, fc = torch.floor(lo_r).to(torch.int64), \
        torch.floor(lo_c).to(torch.int64)
    wr = torch.clamp(torch.clamp(fr, min=0), max=pad_rows - band)
    wc = torch.clamp(torch.clamp(fc, min=0), max=pad_cols - width)
    if group > 1:
        wr, wc = (o.reshape((-1, group) + o.shape[1:]).amin(
            dim=1, keepdim=True).expand((-1, group) + o.shape[1:])
            .reshape(o.shape) for o in (wr, wc))
    gr = torch.floor(hi_r).to(torch.int64) + 3 + _BOX_MARGIN
    gc = torch.floor(hi_c).to(torch.int64) + 3 + _BOX_MARGIN
    r0 = torch.where(flat, wr, torch.maximum(wr, fr + 1 - _BOX_MARGIN))
    c0 = torch.where(flat, wc, torch.maximum(wc, fc + 1 - _BOX_MARGIN))
    r1 = torch.where(flat, wr + band, torch.minimum(wr + band, gr))
    c1 = torch.where(flat, wc + width, torch.minimum(wc + width, gc))
    return (r0, torch.clamp(r1, max=geom.n_v + 2), c0,
            torch.clamp(c1, max=geom.n_u + 2))


def box_slot_dims(boxes, itemsize: int):
    """The rows and the 16-byte units per row a kernel stages for each
    box of :func:`corner_boxes` on a wire of ``itemsize`` bytes (a row
    from the unit holding its first element): ``(rows, units)``, both 0
    for an empty box."""
    r0, r1, c0, c1 = boxes
    empty = (r1 <= r0) | (c1 <= c0)
    units = (c1 * itemsize + 15) // 16 - (c0 * itemsize) // 16
    return ((r1 - r0).masked_fill(empty, 0), units.masked_fill(empty, 0))


def strip_box_slots(geom, matrices, *, ty: int, chunk: int, band: int,
                    width: int, pad_rows: int, pad_cols: int,
                    itemsize: int, device=None) -> np.ndarray:
    """Each matrix's largest staged box over every tile and z-plane: an
    ``(n, 2)`` int64 array of ``(rows, units)`` (:func:`box_slot_dims`
    of :func:`corner_boxes`), from which a launch of K3 or K4 sizes its
    slots.  ``matrices`` are taken in float32, as the kernels take them;
    each matrix's result is memoised, and the matrices not seen before
    are computed in batches on ``device`` (default: where the matrices
    lie)."""
    if geom.L % ty or geom.L % chunk:
        raise ValueError(f"ty={ty} and chunk={chunk} must divide "
                         f"L={geom.L}")
    if torch.is_tensor(matrices):
        m32 = matrices.detach().to("cpu", torch.float32).numpy()
    else:
        m32 = np.asarray(matrices, np.float32)
    m32 = m32.reshape(-1, 3, 4)
    head = (_gkey(geom), ty, chunk, band, width, pad_rows, pad_cols,
            int(itemsize))
    keys = [head + (m.tobytes(),) for m in m32]
    todo = [i for i, k in enumerate(keys) if k not in _BOXES]
    if todo:
        dev = _device(matrices, device)
        per = geom.L * (geom.L // ty) * (geom.L // chunk)
        for s, e in _batches(len(todo), per):
            idx = todo[s:e]
            boxes = corner_boxes(
                geom, torch.as_tensor(m32[idx], device=dev), ty=ty,
                chunk=chunk, band=band, width=width, pad_rows=pad_rows,
                pad_cols=pad_cols)
            rows, units = box_slot_dims(boxes, itemsize)
            del boxes
            rows = rows.amax(dim=(1, 2, 3)).cpu()
            units = units.amax(dim=(1, 2, 3)).cpu()
            for j, i in enumerate(idx):
                _remember(_BOXES, keys[i], (int(rows[j]), int(units[j])))
    return np.array([_BOXES[k] for k in keys], np.int64).reshape(-1, 2)


def shared_box_slots(geom, matrices, *, ty: int, chunk: int, band: int,
                     width: int, pad_rows: int, pad_cols: int,
                     itemsize: int, pbatch: int | None = None,
                     device=None) -> np.ndarray:
    """The 16-byte units a launch of K5 needs per slot, for each group of
    ``pbatch`` consecutive matrices (full groups, then the remainder, as
    the folds batch them; ``None``: one group of all): the largest over
    every tile and z-plane of the total of the group's boxes
    (:func:`box_slot_dims` of :func:`corner_boxes`, cut to the group's
    window), which the kernel packs back to back in one slot.  An
    ``(n_groups,)`` int64 array.  ``matrices`` are taken in float32, as
    the kernel takes them; each group's result is memoised, and the
    groups not seen before are computed in batches on ``device``
    (default: where the matrices lie)."""
    if geom.L % ty or geom.L % chunk:
        raise ValueError(f"ty={ty} and chunk={chunk} must divide "
                         f"L={geom.L}")
    if torch.is_tensor(matrices):
        m32 = matrices.detach().to("cpu", torch.float32).numpy()
    else:
        m32 = np.asarray(matrices, np.float32)
    m32 = m32.reshape(-1, 3, 4)
    n = len(m32)
    pb = n if pbatch is None else max(1, min(int(pbatch), n))
    groups = [(s, min(s + pb, n)) for s in range(0, n, pb)]
    head = ("group", _gkey(geom), ty, chunk, band, width, pad_rows,
            pad_cols, int(itemsize))
    keys = [head + (m32[s:e].tobytes(),) for s, e in groups]
    found = {i: _BOXES[k] for i, k in enumerate(keys) if k in _BOXES}
    per = geom.L * (geom.L // ty) * (geom.L // chunk)
    for size in sorted({e - s for s, e in groups}):
        todo = [i for i, (s, e) in enumerate(groups)
                if e - s == size and i not in found]
        for a, b in _batches(len(todo) * size, per, multiple=size):
            idx = todo[a // size:b // size]
            A = torch.as_tensor(np.concatenate(
                [m32[groups[i][0]:groups[i][1]] for i in idx]),
                device=_device(matrices, device))
            rows, units = box_slot_dims(corner_boxes(
                geom, A, ty=ty, chunk=chunk, band=band, width=width,
                pad_rows=pad_rows, pad_cols=pad_cols, group=size),
                itemsize)
            total = (rows * units).reshape((len(idx), size)
                                           + rows.shape[1:]).sum(dim=1)
            total = total.amax(dim=(1, 2, 3)).cpu()
            for j, i in enumerate(idx):
                found[i] = int(total[j])
                _remember(_BOXES, keys[i], found[i])
    return np.array([found[i] for i in range(len(keys))], np.int64)


def shared_window_cover(geom: Geometry, matrices, *, ty: int, chunk: int,
                        pbatch: int, device=None) -> tuple[int, int]:
    """The superset window K5's own rule needs: per tile and projection
    group, from the window origin the kernel computes (the least of the
    members' corner origins, :func:`_corner_lows`) to one past the
    highest tap row and column of the group's contributing voxels (the
    planner's bounds), maximised over all tiles and groups.

    :func:`shared_window_requirement` (the reference's rule) merges the
    members' planner origins instead, which the planner clamps so that
    each matrix's own auto-sized strip fits the image, and which it
    computes for inactive chunks too.  The clamp can hide part of the
    members' scatter near the detector's edge (then a window of that
    size drops taps at the kernel's origin); the inactive origins can
    inflate it many times over.  K5 is sized by this function.  Memoised
    per matrix set; planned on ``device`` (default: where the matrices
    lie).
    """
    mats = _host64(matrices)
    L = geom.L
    if L % ty or L % chunk:
        raise ValueError(f"ty={ty} and chunk={chunk} must divide L={L}")
    key = (_gkey(geom), ty, chunk, pbatch, "cover",
           hashlib.sha1(mats.tobytes()).hexdigest())
    hit = _SHARED.get(key)
    if hit is not None:
        return hit
    dev = _device(matrices, device)
    need_band = need_width = 0
    for s, e in _batches(len(mats), L * L * (L // chunk), multiple=pbatch):
        At = torch.as_tensor(mats[s:e], device=dev)
        *_, (r_hi, c_hi) = _plan(geom, At, chunk)
        ro, co = corner_lows(geom, At, ty, chunk)
        for g0 in range(0, e - s, pbatch):
            sl = slice(g0, g0 + pbatch)
            for hi, lo, need in ((r_hi, ro, "band"), (c_hi, co, "width")):
                top = hi[sl].reshape(hi[sl].shape[:2] + (L // ty, ty, -1))
                top = top.amax(dim=(0, 3)) + 2      # padded, exclusive
                span = torch.where(torch.isfinite(top),
                                   top - lo[sl].amin(dim=0), 0.0)
                n = int(span.max())
                if need == "band":
                    need_band = max(need_band, n)
                else:
                    need_width = max(need_width, n)
    _remember(_SHARED, key, (need_band, need_width))
    return need_band, need_width
