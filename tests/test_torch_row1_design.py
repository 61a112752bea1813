"""The order of operations of the row-1 back-projection kernel and of the
row encoder (``kernels/csrc/backproject.cu``, ``kernels/csrc/quant.cu``),
emulated in PyTorch on the CPU and held bitwise to their plain versions.

The CUDA kernels run only on a card; these emulations follow each
kernel's steps as its source writes them, so a change of order that
would break bitwise equality shows here, without a card:

* row 1: a thread folds a run of 8 voxels along z at fixed (x, y); per
  projection it forms ``wx a0 + wy a1`` of each matrix row once, and per
  voxel ``((t + wz a2) + a3)``; a tap index is one saturating conversion
  plus 1, wrapping as an unsigned 32-bit sum (``bp::tap_index``), with
  no clamp; one test admits a whole 2x2 quad, the per-tap tests run only
  where it fails; a last run shorter than 8 folds its last plane again
  and drops the copies.  Held to ``backproject_batch_ref`` with
  ``torch.equal`` on the float32, bfloat16 and int8 wires.
* the encoder: pass 1 per lane and across the warp by an xor butterfly,
  pass 2 along column tiles; the quotient taken as a product with the
  row's reciprocal, and as the IEEE division only within 2^-15 of a
  half-integer (the margin is checked on its own); the code rounded by
  adding and subtracting 1.5 * 2^23 after the clamp, the code the sum's
  low byte.  Held to ``quantize_rows_ref`` bitwise (codes, scales,
  offsets).

One case runs the JAX package's ``quantize_rows`` and its jnp back
projection on the same numpy inputs (bitwise for the encoder, 1e-5 ·
max(1, max|ref|) for the back projection, the tolerance of
``tests/test_torch_backproject.py``: XLA sums in its own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core.backproject as jbp
import repro.quant as jq
from _prop import given, settings, st
from _row1_cases import hard_rows, odd_problem
from repro.core.geometry import Geometry as JGeometry
from repro.core.geometry import projection_matrices as j_mats
from repro_torch.core.backproject import GeomStatic
from repro_torch.core.geometry import Geometry, projection_matrices
from repro_torch.kernels.backproject_ref import (backproject_batch_ref,
                                                 wire_values)
from repro_torch.quant import quantize_rows_ref

RUN = 8              # voxels a thread folds along z
LANES = 32           # a warp
TILE = 64            # the encoder's staged columns
MAGIC = 12582912.0   # 1.5 * 2^23
EPS_W = 1e-6
INT_MIN, INT_MAX = -2**31, 2**31 - 1
HALF_MARGIN = 2.0**-15   # the encoder's kHalfMargin


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def tap_index(v):
    """bp::tap_index: floor(v) converted to int32 with saturation (NaN
    reads 0, as the card's conversion gives), plus 1 as an unsigned
    32-bit sum read back as int32."""
    f = torch.nan_to_num(torch.floor(v).to(torch.float64), nan=0.0)
    i = torch.clamp(f, INT_MIN, INT_MAX).to(torch.int64) + 1
    return (i - INT_MIN) % 2**32 + INT_MIN


class _Taps:
    """Tap reads of one projection, as the kernel's loaders make them:
    float32 values, or int8 codes decoded per tap with the row's scale and
    offset (two rounded steps)."""

    def __init__(self, stack, scales, p):
        self.img = stack[p]
        self.rows, self.cols = self.img.shape
        self.flat = self.img.reshape(-1)
        self.sc = None if scales is None else scales[p]

    def at(self, r, c):
        """The tap at (r, c), which the caller has checked lies inside."""
        r = r.clamp(0, self.rows - 1)
        c = c.clamp(0, self.cols - 1)
        v = self.flat[r * self.cols + c]
        if self.sc is None:
            return v.to(torch.float32)
        return v.to(torch.float32) * self.sc[0][r] + self.sc[1][r]

    def checked(self, r, c):
        ok = (r >= 0) & (r < self.rows) & (c >= 0) & (c < self.cols)
        return torch.where(ok, self.at(r, c), 0.0)


def emulate_row1(volume, stack, mats, gs: GeomStatic, *, z0: int = 0,
                 scales=None, stats=None):
    """``backproject.cu``'s fold, step by step, of one launch: ``stack``
    is the ``(P, rows, cols)`` bordered stack on its wire (int8 codes with
    ``scales``), ``volume`` a ``(nz, L, L)`` slab from plane ``z0``,
    updated in place.  ``stats`` (a dict) counts the quads each path
    took, the taps wholly off the image and the voxels with w <= 1e-6."""
    nz, L = volume.shape[0], volume.shape[1]
    P, rows, cols = stack.shape
    O, MM = _f32(gs.O), _f32(gs.MM)
    world = O + torch.arange(L, dtype=torch.float32) * MM
    wx, wy = world[None, :], world[:, None]
    for zr in range(0, nz, RUN):
        zis = [min(zr + j, nz - 1) for j in range(RUN)]
        wz = [O + _f32(z0 + zi) * MM for zi in zis]
        acc = [volume[zi].clone() for zi in zis]
        for p in range(P):
            a = mats[p]
            t = [wx * a[k, 0] + wy * a[k, 1] for k in range(3)]
            taps = _Taps(stack, scales, p)
            for j in range(RUN):
                u, v, w = ((t[k] + wz[j] * a[k, 2]) + a[k, 3]
                           for k in range(3))
                r = torch.where(w > EPS_W, 1.0 / w, 0.0)
                ix, iy = u * r, v * r
                c, rr = tap_index(ix), tap_index(iy)
                sx, sy = ix - torch.floor(ix), iy - torch.floor(iy)
                fast = (rr >= 0) & (rr < rows - 1) & (c >= 0) & (c < cols - 1)
                quad = [torch.where(fast, taps.at(rr + dr, c + dc),
                                    taps.checked(rr + dr, c + dc))
                        for dr, dc in ((0, 0), (0, 1), (1, 0), (1, 1))]
                bl, br, tl, tr = quad
                ox = 1.0 - sx
                valb = ox * bl + sx * br
                valt = ox * tl + sx * tr
                val = (1.0 - sy) * valb + sy * valt
                acc[j] = acc[j] + val * (r * r)
                if stats is not None and zr + j < nz:
                    stats["fast"] += int(fast.sum())
                    stats["slow"] += int((~fast).sum())
                    stats["far"] += int(((c < -1) | (c > cols)
                                         | (rr < -1) | (rr > rows)).sum())
                    stats["flat_w"] += int((w <= EPS_W).sum())
        for j in range(RUN):
            if zr + j < nz:
                volume[zr + j] = acc[j]
    return volume


def emulate_encoder(x, *, symmetric: bool = False, stats=None):
    """``quant.cu``'s encode of a ``(P, rows, cols)`` float32 stack:
    returns ``(codes, scale, offset)``.  ``stats`` (a dict) counts the
    steps that took the division."""
    P, rows, cols = x.shape
    flat = x.reshape(-1, cols)
    n = flat.shape[0]
    # Pass 1: lane l folds columns l, l + 32, ... from 0, then an xor
    # butterfly across the lanes.
    pad = (-cols) % LANES
    lanes = F.pad(flat, (0, pad)).reshape(n, -1, LANES)
    lane_ids = torch.arange(LANES)
    if symmetric:
        red = [torch.clamp_min(torch.amax(lanes.abs(), dim=1), 0.0)]
        ops = [torch.maximum]
    else:
        red = [torch.clamp_max(torch.amin(lanes, dim=1), 0.0),
               torch.clamp_min(torch.amax(lanes, dim=1), 0.0)]
        ops = [torch.minimum, torch.maximum]
    for o in (16, 8, 4, 2, 1):
        red = [op(v, v[:, lane_ids ^ o]) for op, v in zip(ops, red)]
    if symmetric:
        amax = red[0][:, 0]
        scale = torch.clamp_min(amax, 1e-30) / torch.full_like(amax, 127.0)
        offset = torch.zeros_like(scale)
    else:
        lo, hi = red[0][:, 0], red[1][:, 0]
        scale = torch.clamp_min(hi - lo, 1e-30) / torch.full_like(lo, 254.0)
        offset = lo + 127.0 * scale
    # Pass 2: the chains, a column tile at a time.
    codes = torch.empty(flat.shape, dtype=torch.int8)
    err = torch.zeros_like(scale)
    rscale = 1.0 / scale
    for c0 in range(0, cols, TILE):
        for c in range(c0, min(c0 + TILE, cols)):
            xp = flat[:, c] + err
            a = xp - offset
            y = a * rscale
            m = torch.clamp(y, -127.0, 127.0) + MAGIC
            q = m - MAGIC
            near = ((y - q).abs() - 0.5).abs() < HALF_MARGIN
            if bool(near.any()):
                exact = torch.clamp(a / scale, -127.0, 127.0) + MAGIC
                m = torch.where(near, exact, m)
                q = m - MAGIC
            if stats is not None:
                stats["division"] += int(near.sum())
                stats["steps"] += near.numel()
            low = m.view(torch.int32) & 0xFF
            codes[:, c] = (low - ((low & 0x80) << 1)).to(torch.int8)
            err = xp - (q * scale + offset)
    return (codes.reshape(x.shape), scale.reshape(P, rows),
            offset.reshape(P, rows))


def _on_wire(images, wire):
    """The bordered stack a launch reads on ``wire`` (and the int8
    scales), encoded as the wrapper encodes it."""
    padded = F.pad(images, (1, 1, 1, 1))
    if wire == "float32":
        return padded, None
    if wire == "bfloat16":
        return padded.to(torch.bfloat16), None
    rq = quantize_rows_ref(padded)
    return rq.codes, rq.scales()


def _launches(volume, images, mats, gs, z0, P, wire, stats=None):
    stack, scales = _on_wire(images, wire)
    for s in range(0, images.shape[0], P):
        emulate_row1(volume, stack[s:s + P], mats[s:s + P], gs, z0=z0,
                     scales=None if scales is None else scales[s:s + P],
                     stats=stats)
    return volume


# ----------------------------------------------------------------------
# Row 1
# ----------------------------------------------------------------------

def test_tap_index_stays_off_the_image():
    """A coordinate past the int32 range saturates, and its + 1 wraps to
    the far negative end: both the tap and its neighbour then lie
    outside any image, as they do for the plain version.  Inside the
    range the index is floor + 1; float32 values below 2^31 are at most
    2^31 - 128, so the neighbour's + 1 never overflows."""
    v = torch.tensor([-3e9, -2.0**31, -1.5, -0.25, 0.0, 0.75, 1249.5,
                      2.0**31 - 128, 2.0**31, 1e12, float("inf"),
                      float("-inf")], dtype=torch.float32)
    got = tap_index(v)
    want = [INT_MIN + 1, INT_MIN + 1, -1, 0, 1, 1, 1250, 2**31 - 127,
            INT_MIN, INT_MIN, INT_MIN, INT_MIN + 1]
    assert got.tolist() == want
    assert float(np.nextafter(np.float32(2.0**31), np.float32(0))) == \
        2.0**31 - 128
    for cols in (3, 1250, 2**21):
        off = (got < -1) | (got >= cols)
        assert off.tolist() == [True, True, False, False, False, False,
                                cols <= 1250, True, True, True, True, True]


def _odd():
    geom, images, mats, volume, z0 = odd_problem()
    return (GeomStatic.of(geom), torch.tensor(images), torch.tensor(mats),
            torch.tensor(volume), z0)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_row1_emulation_equals_plain_at_odd_shapes(wire, P):
    """L = 37, a 13-plane slab from plane 5, taps off the detector and a
    view with w <= 1e-6: the emulated launches of P views equal the plain
    version bitwise."""
    gs, images, mats, volume, z0 = _odd()
    got = _launches(volume.clone(), images, mats, gs, z0, P, wire)
    want = backproject_batch_ref(volume.clone(), images, mats, gs, z0=z0,
                                 wire=wire)
    assert torch.equal(got, want)


def test_odd_shapes_reach_every_path():
    """The odd problem takes the quad test both ways, sends taps far off
    the image, and has voxels at w <= 1e-6, so the cases above hold each
    path to the plain version."""
    gs, images, mats, volume, z0 = _odd()
    stats = dict(fast=0, slow=0, far=0, flat_w=0)
    _launches(volume.clone(), images, mats, gs, z0, 8, "float32", stats)
    assert stats["fast"] > 1000 and stats["slow"] > 1000, stats
    assert stats["far"] > 0 and stats["flat_w"] > 0, stats
    assert stats["fast"] + stats["slow"] == 8 * 13 * 37 * 37


G16 = Geometry().scaled(16, n_proj=6)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("P", [1, 4])
def test_row1_emulation_equals_plain_on_the_phantom(wire, P):
    """The phantom's filtered views at L = 16 (a full 16-plane volume, two
    whole runs), every wire."""
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.phantom import forward_project

    images = filter_projections(forward_project(G16, device="cpu"), G16,
                                device="cpu")
    mats = torch.tensor(projection_matrices(G16))
    gs = GeomStatic.of(G16)
    volume = torch.tensor(np.random.default_rng(P).standard_normal(
        (16, 16, 16)).astype(np.float32))
    got = _launches(volume.clone(), images, mats, gs, 0, P, wire)
    want = backproject_batch_ref(volume.clone(), images, mats, gs,
                                 wire=wire)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# The encoder
# ----------------------------------------------------------------------

def _same_encode(x, symmetric):
    codes, scale, offset = emulate_encoder(x, symmetric=symmetric)
    want = quantize_rows_ref(x, symmetric=symmetric)
    assert torch.equal(codes, want.codes)
    assert torch.equal(scale, want.scale)
    assert torch.equal(offset, want.offset)


@given(seed=st.integers(0, 2**16), rows=st.integers(1, 40),
       cols=st.integers(1, 200),
       kind=st.sampled_from(["normal", "huge", "tiny", "constant", "zero",
                             "positive"]))
@settings(max_examples=25, deadline=None)
def test_encoder_emulation_equals_plain(seed, rows, cols, kind):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, rows, cols)).astype(np.float32)
    x *= {"normal": 3.0, "huge": 1e6, "tiny": 1e-20, "constant": 0.0,
          "zero": 0.0, "positive": 1.0}[kind]
    if kind == "constant":
        x += np.float32(rng.uniform(-5, 5))
    if kind == "positive":
        x = np.abs(x)
    for symmetric in (False, True):
        _same_encode(torch.tensor(x), symmetric)


@pytest.mark.parametrize("symmetric", [False, True])
def test_encoder_emulation_on_near_half_rows(symmetric):
    """Rows off the 32-row block and the 64-column tile, zero, constant
    and one-signed rows, and rows whose every quotient lies within a few
    ulps of a half-integer (ties included): these take the division."""
    x = torch.tensor(hard_rows(7, symmetric=symmetric))
    _same_encode(x, symmetric)
    stats = dict(division=0, steps=0)
    emulate_encoder(x, symmetric=symmetric, stats=stats)
    assert stats["division"] > 1000, stats


def test_reciprocal_quotient_stays_inside_the_margin():
    """RN(a RN(1/b)) against RN(a/b) in float32, for quotients up to
    128.01 in size and scales from 1e-33 to 1e30 (the encoder's grid
    steps reach down to 1e-30 / 254): the gap stays under the proven
    |a/b| (3 2^-24 + 2^-48) <= 2.29e-5, below the 2^-15 margin."""
    rng = np.random.default_rng(5)
    n = 200_000
    b = np.float32(10.0) ** rng.uniform(-33, 30, n).astype(np.float32)
    t = rng.uniform(-128.01, 128.01, n)
    t[: n // 4] = np.round(t[: n // 4]) + 0.5          # near the halves
    a = (t * b.astype(np.float64)).astype(np.float32)
    keep = np.isfinite(a) & (a != 0)
    a, b = a[keep], b[keep]
    y = (a * (np.float32(1.0) / b)).astype(np.float64)
    exact = (a / b).astype(np.float64)
    q = a.astype(np.float64) / b.astype(np.float64)
    bound = np.abs(q) * (3 * 2.0**-24 + 2.0**-48)
    assert np.all(np.abs(y - exact) <= bound)
    assert bound[np.abs(q) <= 128.01].max() < 2.29e-5 < HALF_MARGIN


# ----------------------------------------------------------------------
# Against the JAX package
# ----------------------------------------------------------------------

JG16 = JGeometry().scaled(16, n_proj=6)


def test_emulations_against_the_jax_package():
    """On the same numpy inputs: the emulated encoder equals
    ``repro.quant.quantize_rows`` bitwise on the bordered stack, and the
    emulated float32 launches agree with the jnp ``scalar`` back
    projection to 1e-5 · max(1, max|ref|)."""
    import repro.core.filtering as jfilt
    import repro.core.phantom as jph

    filt = np.asarray(jfilt.filter_projections(jph.forward_project(JG16),
                                               JG16))
    mats = np.asarray(j_mats(JG16))
    padded = np.pad(filt, ((0, 0), (1, 1), (1, 1)))
    ref = jax.vmap(jq.quantize_rows)(jnp.asarray(padded))
    codes, scale, offset = emulate_encoder(torch.tensor(padded))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(offset.numpy(), np.asarray(ref.offset))

    vol = np.random.default_rng(11).standard_normal((16, 16, 16)).astype(
        np.float32)
    want = np.asarray(jbp.backproject_batch(vol, filt, mats, JG16,
                                            strategy="scalar", pbatch=4))
    got = _launches(torch.tensor(vol), torch.tensor(filt),
                    torch.tensor(mats), GeomStatic.of(G16), 0, 4,
                    "float32").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_wire_values_match_the_emulated_taps():
    """The int8 taps the emulation decodes per tap equal the decoded
    stack the plain version reads (``wire_values``)."""
    gs, images, mats, volume, z0 = _odd()
    padded = F.pad(images, (1, 1, 1, 1))
    codes, scales = _on_wire(images, "int8")
    taps = _Taps(codes, scales, 2)
    r = torch.arange(padded.shape[1])[:, None].expand(-1, padded.shape[2])
    c = torch.arange(padded.shape[2])[None, :].expand(padded.shape[1], -1)
    assert torch.equal(taps.at(r, c), wire_values(padded, "int8")[2])
