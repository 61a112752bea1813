"""Clipping masks and strip planning (host-side geometry precompute).

The port's numpy copy of ``repro.core.clipping``.  Per ``(z, y)`` voxel
line, :func:`line_clip_exact` gives the exact ``x`` range whose
projection lands on the detector (the paper's improved clipping mask);
:func:`plan_strips` extends it to a **strip plan**: per ``(projection,
z, y, x-chunk)`` the origin of the smallest detector rectangle holding
every bilinear tap of the chunk.  The port uses the plan to check that
the ``strip``/``strip2`` windows cover every tap
(:func:`repro_torch.core.backproject.validate_strip_opts`); the CUDA
kernel reads taps directly and needs no plan.

Monotone-beam property
----------------------
For a fixed ``(z, y)`` line, ``Z(x)`` (the homogeneous coordinate) is affine
in ``x`` and both detector coordinates are projective in ``x``:

* ``iy(x) = f * wz / Z(x) + cv`` is monotone (``1/Z`` is monotone where
  ``Z > 0``), and
* ``d(ix)/dx`` has the sign of ``U'Z - U Z'`` which is *constant* along the
  line, so ``ix(x)`` is monotone too.

Hence per-chunk strip bounds are exact from the chunk's two endpoint voxels.

All computations here are float64 numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .geometry import Geometry

__all__ = [
    "LinePlan",
    "StripPlan",
    "pad_projection",
    "line_clip_exact",
    "line_clip_conservative",
    "plan_strips",
    "shared_window_requirement",
]

# Margin (pixels) added around the analytic tap bounds: one for the floor()
# tap pair, one for float32-vs-float64 index disagreement near integers.
_MARGIN = 2


@dataclasses.dataclass(frozen=True)
class LinePlan:
    """Exact per-line clip ranges: process ``x`` in ``[x0, x1)``."""

    x0: np.ndarray  # (L, L) int32, indexed [z, y]
    x1: np.ndarray  # (L, L) int32

    @property
    def voxels(self) -> int:
        return int(np.maximum(self.x1 - self.x0, 0).sum())


@dataclasses.dataclass(frozen=True)
class StripPlan:
    """Per-chunk strip origins in *padded* image coordinates.

    ``r0``/``c0`` have shape ``(L, L, n_chunks)`` indexed ``[z, y, chunk]``.
    ``band``/``width`` are the static strip dims every chunk fits in.
    ``active`` marks chunks with at least one contributing voxel.
    """

    r0: np.ndarray
    c0: np.ndarray
    active: np.ndarray
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


# ----------------------------------------------------------------------
# Exact per-line clipping (paper's improved clipping mask)
# ----------------------------------------------------------------------

def _line_coeffs(geom: Geometry, A: np.ndarray):
    """Affine coefficients of (u', v', w) along x for all (z, y) lines.

    Returns arrays shaped (L, L) for the x=0 intercepts and scalars for the
    common slopes: ``u'(x) = pu + qu * x`` etc.
    """
    L = geom.L
    wcoord = geom.O + np.arange(L, dtype=np.float64) * geom.MM
    wy = wcoord[None, :, None]   # y varies on axis 1
    wz = wcoord[:, None, None]   # z varies on axis 0
    w0 = geom.O                  # world x at voxel x=0
    pu = A[0, 0] * w0 + A[0, 1] * wy + A[0, 2] * wz + A[0, 3]
    pv = A[1, 0] * w0 + A[1, 1] * wy + A[1, 2] * wz + A[1, 3]
    pw = A[2, 0] * w0 + A[2, 1] * wy + A[2, 2] * wz + A[2, 3]
    qu = A[0, 0] * geom.MM
    qv = A[1, 0] * geom.MM
    qw = A[2, 0] * geom.MM
    return (pu[..., 0], pv[..., 0], pw[..., 0]), (qu, qv, qw)


def _halfline(acc_lo, acc_hi, a, b):
    """Intersect {x : a + b*x > 0} into interval [acc_lo, acc_hi]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        root = -a / b
    pos_b = b > 0
    neg_b = b < 0
    zero_b = b == 0
    lo = np.where(pos_b, np.maximum(acc_lo, root), acc_lo)
    hi = np.where(neg_b, np.minimum(acc_hi, root), acc_hi)
    # b == 0: condition is just a > 0 (empty interval if it fails).
    dead = zero_b & (a <= 0)
    lo = np.where(dead, np.inf, lo)
    hi = np.where(dead, -np.inf, hi)
    return lo, hi


def line_clip_exact(geom: Geometry, A: np.ndarray,
                    eps_w: float = 1e-6) -> LinePlan:
    """Exact ``[x0, x1)`` per line such that outside it no tap contributes.

    A voxel contributes iff ``-1 < ix < n_u`` and ``-1 < iy < n_v`` and
    ``w > 0``.  Each bound is a linear inequality in ``x`` (after
    multiplying through by ``w > 0``), so the valid set is an interval —
    the "improved clipping mask" of paper section 5.
    """
    (pu, pv, pw), (qu, qv, qw) = _line_coeffs(geom, A)
    L = geom.L
    lo = np.full(pu.shape, -np.inf)
    hi = np.full(pu.shape, np.inf)
    # w > eps
    lo, hi = _halfline(lo, hi, pw - eps_w, np.full_like(pw, qw))
    # ix > -1   <=>  u' + w > 0
    lo, hi = _halfline(lo, hi, pu + pw, np.full_like(pw, qu + qw))
    # ix < n_u  <=>  n_u * w - u' > 0
    lo, hi = _halfline(lo, hi, geom.n_u * pw - pu,
                       np.full_like(pw, geom.n_u * qw - qu))
    # iy > -1
    lo, hi = _halfline(lo, hi, pv + pw, np.full_like(pw, qv + qw))
    # iy < n_v
    lo, hi = _halfline(lo, hi, geom.n_v * pw - pv,
                       np.full_like(pw, geom.n_v * qw - qv))
    x0 = np.clip(np.ceil(lo), 0, L).astype(np.int32)
    x1 = np.clip(np.floor(hi) + 1, 0, L).astype(np.int32)
    x1 = np.maximum(x1, x0)
    return LinePlan(x0=x0, x1=x1)


def line_clip_conservative(geom: Geometry, A: np.ndarray) -> LinePlan:
    """The pre-fix mask: per z-plane all-or-nothing corner test.

    Mirrors the "original algorithm with minor flaws" the paper improved
    on: project the four corners of each z-plane; if any corner's footprint
    may touch the detector, process *every* voxel of the plane.
    """
    from .geometry import project_voxels, voxel_world_coords

    L = geom.L
    corners = voxel_world_coords(geom, np.array([0, L - 1], dtype=np.float64))
    x0 = np.zeros((L, L), dtype=np.int32)
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
    return LinePlan(x0=x0, x1=x1)


# ----------------------------------------------------------------------
# Strip planning (feeds the window checks of `strip` and `strip2`)
# ----------------------------------------------------------------------

def plan_strips(geom: Geometry, A: np.ndarray, chunk: int,
                band: int | None = None, width: int | None = None,
                clip: LinePlan | None = None) -> StripPlan:
    """Compute per-chunk strip origins in padded-image coordinates.

    Exactness relies on the monotone-beam property (module docstring): the
    tap bounding box of an x-chunk is spanned by its endpoint voxels.  The
    returned ``required_band``/``required_width`` are the tight maxima over
    all *active* chunks; callers pass static ``band``/``width`` at least
    that large (asserted by the strategies).
    """
    if clip is None:
        clip = line_clip_exact(geom, A)
    L = geom.L
    assert L % chunk == 0, (L, chunk)
    n_chunks = L // chunk
    (pu, pv, pw), (qu, qv, qw) = _line_coeffs(geom, A)

    xs = np.arange(n_chunks) * chunk

    # Effective endpoints: the chunk extent intersected with the exact clip
    # range.  This guarantees ``w > 0`` at both endpoints (the clip range
    # enforces it), so the projective coordinates there are meaningful, and
    # by monotonicity every contributing tap lies between them.
    x0 = clip.x0[..., None].astype(np.float64)       # (L, L, 1)
    x1 = clip.x1[..., None].astype(np.float64)
    xa = np.maximum(xs[None, None, :].astype(np.float64), x0)
    xb = np.minimum((xs + chunk - 1)[None, None, :].astype(np.float64),
                    x1 - 1.0)
    xb = np.maximum(xb, xa)                          # degenerate -> point

    def coords(xq):  # xq: (L, L, n_chunks)
        u = pu[..., None] + qu * xq
        v = pv[..., None] + qv * xq
        w = pw[..., None] + qw * xq
        w = np.where(np.abs(w) < 1e-12, 1e-12, w)
        return u / w, v / w, w

    ix_a, iy_a, w_a = coords(xa)
    ix_b, iy_b, w_b = coords(xb)

    # Clamp projected coords into the padded-image footprint before taking
    # bounds: contributions outside it are zero anyway.
    def pclip_c(ix):
        return np.clip(ix, -1.0, float(geom.n_u))

    def pclip_r(iy):
        return np.clip(iy, -1.0, float(geom.n_v))

    c_lo = np.floor(np.minimum(pclip_c(ix_a), pclip_c(ix_b)))
    c_hi = np.floor(np.maximum(pclip_c(ix_a), pclip_c(ix_b))) + 1
    r_lo = np.floor(np.minimum(pclip_r(iy_a), pclip_r(iy_b)))
    r_hi = np.floor(np.maximum(pclip_r(iy_a), pclip_r(iy_b))) + 1

    # Active chunks: nonempty overlap between the [x0, x1) clip range and
    # the chunk extent.
    active = (np.minimum(x1, (xs + chunk)[None, None, :].astype(np.float64))
              > np.maximum(x0, xs[None, None, :].astype(np.float64)))

    req_band = int(np.max(np.where(active, r_hi - r_lo, 0)) + _MARGIN)
    req_width = int(np.max(np.where(active, c_hi - c_lo, 0)) + _MARGIN)
    band = int(band) if band is not None else _round8(req_band)
    width = int(width) if width is not None else _round128(req_width)

    # Origins in padded coordinates (padded pixel p maps image index p-1),
    # clamped so the strip stays inside the padded image.
    r0 = np.clip(r_lo + 1 - _MARGIN // 2, 0, geom.n_v + 2 - band)
    c0 = np.clip(c_lo + 1 - _MARGIN // 2, 0, geom.n_u + 2 - width)
    return StripPlan(
        r0=r0.astype(np.int32), c0=c0.astype(np.int32),
        active=active, chunk=chunk, band=band, width=width,
        required_band=req_band, required_width=req_width)


def _round8(v: int) -> int:
    return max(8, (v + 7) // 8 * 8)


def _round128(v: int) -> int:
    return max(128, (v + 127) // 128 * 128)


def shared_window_requirement(geom: Geometry, matrices, *, ty: int,
                              chunk: int, pbatch: int) -> tuple[int, int]:
    """Superset-window dims covering a whole projection group per tile.

    A shared-window batch kernel reads ONE ``(pbatch, band, width)``
    window slab per ``(z, ty-lines, x-chunk)`` volume tile, anchored at
    the elementwise minimum of the group members' strip origins.  For
    that window to cover every member's taps, its dims must span the
    group's origin scatter — across the ``ty`` merged lines (as in the
    per-projection ``validate_strip_config`` check) *and* across the
    ``pbatch`` projections of the group.

    Groups mirror the batch folds' chunking (``_stream_batches``):
    full ``pbatch`` groups from index 0 plus one smaller remainder
    group.  Returns the tight ``(need_band, need_width)`` maxima over
    all groups and tiles; callers must use a window at least that large
    or taps silently drop — same loud-or-correct contract as
    :func:`plan_strips` consumers.
    """
    mats = np.asarray(matrices, np.float64).reshape(-1, 3, 4)
    L = geom.L
    assert L % ty == 0 and L % chunk == 0, (L, ty, chunk)
    plans = [plan_strips(geom, A, chunk=chunk) for A in mats]
    need_band = need_width = 0
    for g0 in range(0, len(plans), pbatch):
        grp = plans[g0:g0 + pbatch]
        r0 = np.stack([p.r0.astype(np.int64) for p in grp])
        c0 = np.stack([p.c0.astype(np.int64) for p in grp])
        rb = max(p.required_band for p in grp)
        rw = max(p.required_width for p in grp)
        # Merge over group members (axis 0) and the ty lines a volume
        # tile spans (axis 3 after the reshape) — the kernel serves all
        # of them from one window.
        gr = r0.reshape(len(grp), L, L // ty, ty, -1)
        gc = c0.reshape(len(grp), L, L // ty, ty, -1)
        span_r = gr.max(axis=(0, 3)) - gr.min(axis=(0, 3)) + rb
        span_c = gc.max(axis=(0, 3)) - gc.min(axis=(0, 3)) + rw
        need_band = max(need_band, int(span_r.max()))
        need_width = max(need_width, int(span_c.max()))
    return need_band, need_width
