"""The tap boxes K3 ``strip_db`` and K4 ``strip_micro`` stage (CPU).

Per ``(ty, chunk)`` tile and projection the kernels stage only the box
of taps the tile's voxels read, from its four corner voxels
(``repro_torch.core.clipping.corner_boxes``), cut to the tile's window
and the image; a tap outside the box reads 0.  Held here, exactly:

* the corner box holds every tap the window admits for a voxel with
  ``w > eps``, and lies within 2 px of the brute-force box of every
  voxel's taps (the kernels' float32 operations in their order, cut to
  the window and the image) on each side, at L = 32 and 64 on every
  matrix and at L = 512 on sampled planes and views;
* a fold that reads its taps through the box (the kernels' rule)
  equals the plain versions of K3 and K4 bitwise, on every wire;
* a tile with a corner at ``w <= 1e-6`` takes its whole window;
* the slot sizing (``strip_box_slots``), the shared-memory byte model
  and the 16-byte row pitch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.kernels.backproject_ref as R
from repro_torch.core import clipping
from repro_torch.core.backproject import GeomStatic, plane_coords
from repro_torch.core.geometry import Geometry, projection_matrices
from repro_torch.kernels.backproject import (SMEM_LIMIT, pitch_stack,
                                             strip_smem_bytes, window_units)
from repro_torch.kernels.backproject_ops import clamp_tiles

_EPS_W = 1e-6


def _window(g, mats, ty, chunk, itemsize=4):
    """The planner's window for the tile over ``mats`` (every tap), and
    the padded image it is clamped into."""
    nb, nw = clipping.strip_needs(g, mats, chunk=chunk, ty=ty).max(axis=0)
    _, _, band, width = clamp_tiles(GeomStatic.of(g), ty, chunk, int(nb),
                                    int(nw))
    return dict(band=band, width=width, **dict(zip(
        ("pad_rows", "pad_cols"),
        R.padded_dims(GeomStatic.of(g), band, width, itemsize))))


def _brute(g, mats, zs, ty, chunk, win):
    """Per tile: the corner boxes, the window origins, and the brute-force
    box of every voxel's taps (voxels with ``w > eps``), cut to the
    window and the image; plus, per voxel, the four taps and whether the
    window admits each."""
    gs = GeomStatic.of(g)
    A = torch.as_tensor(mats)
    box = clipping.corner_boxes(gs, A, ty=ty, chunk=chunk, zs=zs, **win)
    wr, wc = R._corner_origins(A, zs, gs, ty, chunk, win["band"],
                               win["width"], win["pad_rows"],
                               win["pad_cols"])
    ix, iy, w = plane_coords(A, gs, zs)
    live = w > _EPS_W
    rr, c = R._tap_index(torch.floor(iy)), R._tap_index(torch.floor(ix))

    def tiles(t, red):
        n, nz, L, _ = t.shape
        t = t.reshape(n, nz, L // ty, ty, L // chunk, chunk)
        return red(red(t, 5), 3)

    big = 1 << 30
    lo_r = tiles(torch.where(live, rr, big), lambda t, d: t.amin(dim=d))
    hi_r = tiles(torch.where(live, rr + 2, -big), lambda t, d: t.amax(dim=d))
    lo_c = tiles(torch.where(live, c, big), lambda t, d: t.amin(dim=d))
    hi_c = tiles(torch.where(live, c + 2, -big), lambda t, d: t.amax(dim=d))
    brute = (torch.maximum(torch.maximum(lo_r, wr), torch.zeros(())),
             torch.minimum(torch.minimum(hi_r, wr + win["band"]),
                           torch.tensor(g.n_v + 2)),
             torch.maximum(torch.maximum(lo_c, wc), torch.zeros(())),
             torch.minimum(torch.minimum(hi_c, wc + win["width"]),
                           torch.tensor(g.n_u + 2)))
    per = [R._per_voxel(t, ty, chunk) for t in (*box, wr, wc)]
    taps = []
    for dr in (0, 1):
        for dc in (0, 1):
            rq, cq = rr + dr, c + dc
            admitted = (live & (rq >= per[4]) & (rq < per[4] + win["band"])
                        & (cq >= per[5]) & (cq < per[5] + win["width"])
                        & (rq >= 0) & (rq < g.n_v + 2) & (cq >= 0)
                        & (cq < g.n_u + 2))
            inside = ((rq >= per[0]) & (rq < per[1]) & (cq >= per[2])
                      & (cq < per[3]))
            taps.append((admitted, inside))
    return box, brute, taps


def _check_boxes(g, mats, zs, ty, chunk, win, tight=True):
    box, brute, taps = _brute(g, mats, zs, ty, chunk, win)
    for admitted, inside in taps:
        assert not bool((admitted & ~inside).any()), \
            "a tap the window admits lies outside the staged box"
    if not tight:
        return
    r0, r1, c0, c1 = box
    b0, b1, d0, d1 = brute
    full = (b1 > b0) & (d1 > d0)
    assert bool(full.any())
    for lo, blo in ((r0, b0), (c0, d0)):
        assert bool((lo[full] <= blo[full]).all())
        assert int((blo - lo)[full].max()) <= 2
    for hi, bhi in ((r1, b1), (c1, d1)):
        assert bool((hi[full] >= bhi[full]).all())
        assert int((hi - bhi)[full].max()) <= 2


@pytest.mark.parametrize("L", [32, 64])
@pytest.mark.parametrize("tile", [(1, 16), (8, 8)])
def test_corner_box_holds_every_tap_at_every_matrix(L, tile):
    g = Geometry().scaled(L)
    mats = projection_matrices(g)
    ty, chunk = tile
    win = _window(g, mats, ty, chunk)
    zs = torch.arange(L)
    for s in range(0, len(mats), 64):
        _check_boxes(g, mats[s:s + 64], zs, ty, chunk, win)


@pytest.mark.parametrize("tile", [(1, 64), (8, 32)])
def test_corner_box_holds_every_tap_at_full_width(tile):
    g = Geometry()
    mats = projection_matrices(g)[[0, 131, 260, 495]]
    ty, chunk = tile
    win = _window(g, mats, ty, chunk)
    _check_boxes(g, mats, torch.tensor([0, 197, 384, 511]), ty, chunk, win)


def test_corner_box_cut_to_a_small_window():
    """An undersized window: the box lies in it and still holds every
    tap it admits."""
    g = Geometry().scaled(32)
    mats = projection_matrices(g)[::31]
    win = dict(band=4, width=8, pad_rows=32, pad_cols=128)
    box, _, _ = _brute(g, mats, torch.arange(32), 1, 16, win)
    wr, wc = R._corner_origins(torch.as_tensor(mats), torch.arange(32),
                               GeomStatic.of(g), 1, 16, 4, 8, 32, 128)
    r0, r1, c0, c1 = box
    assert bool(((r0 >= wr) & (c0 >= wc) & (r1 <= wr + 4)
                 & (c1 <= wc + 8)).all())
    _check_boxes(g, mats, torch.arange(32), 1, 16, win, tight=False)


def _flat_matrix(g):
    """A RabbitCT matrix whose w row vanishes on the plane x = 0 and is
    negative beyond it, so that tiles there have corners at w <= eps."""
    A = projection_matrices(g)[3].copy()
    A[2] = [1.0, 0.0, 0.0, 0.0]
    return A


def test_flat_tile_stages_its_whole_window():
    g = Geometry().scaled(32, n_proj=4)
    gs = GeomStatic.of(g)
    A = torch.as_tensor(_flat_matrix(g))[None]
    win = dict(band=8, width=32, pad_rows=40, pad_cols=128)
    zs = torch.arange(32)
    r0, r1, c0, c1 = clipping.corner_boxes(gs, A, ty=8, chunk=8, zs=zs,
                                           **win)
    wr, wc = R._corner_origins(A, zs, gs, 8, 8, 8, 32, 40, 128)
    x0 = torch.arange(0, 32, 8)
    wx_last = (gs.O + (x0 + 7).to(torch.float32) * gs.MM)
    flat = (wx_last <= _EPS_W).reshape(1, 1, 1, -1).expand_as(r0)
    assert bool(flat.any()) and not bool(flat.all())
    assert torch.equal(r0[flat], wr[flat])
    assert torch.equal(c0[flat], wc[flat])
    assert torch.equal(r1[flat], torch.clamp(wr + 8, max=g.n_v + 2)[flat])
    assert torch.equal(c1[flat], torch.clamp(wc + 32, max=g.n_u + 2)[flat])


def _box_inside(mats, gs, ty, chunk, win, micro=None):
    """The kernels' tap rule as a ``windows`` function of
    ``backproject_ref._fold_windowed``: a tap reads its value inside the
    tile's box (and, for K4, the micro window), else 0."""
    def windows(zs, ix, iy):
        box = clipping.corner_boxes(gs, mats, ty=ty, chunk=chunk, zs=zs,
                                    **win)
        r0, r1, c0, c1 = (R._per_voxel(t, ty, chunk) for t in box)
        if micro is not None:
            wr, wc = (R._per_voxel(t, ty, chunk) for t in R._corner_origins(
                mats, zs, gs, ty, chunk, win["band"], win["width"],
                win["pad_rows"], win["pad_cols"]))

            def origin(f, o, size, gsize):
                rel = torch.clamp(R._tap_index(torch.floor(f)) - o, 0,
                                  size - 1)
                lo = rel.reshape(rel.shape[:-1] + (-1, micro["group"]))
                lo = torch.clamp(lo.amin(dim=-1), 0, size - gsize)
                return o + lo.repeat_interleave(micro["group"], dim=-1)

            gr = origin(iy, wr, win["band"], micro["gband"])
            gc = origin(ix, wc, win["width"], micro["gwidth"])
            r0, r1 = torch.maximum(r0, gr), torch.minimum(
                r1, gr + micro["gband"])
            c0, c1 = torch.maximum(c0, gc), torch.minimum(
                c1, gc + micro["gwidth"])

        def inside(p):
            return lambda rq, cq: ((rq >= r0[p]) & (rq < r1[p])
                                   & (cq >= c0[p]) & (cq < c1[p]))
        return inside
    return windows


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["border", "32", "flat"])
def test_box_fold_equals_plain_bitwise(wire, case):
    """K3's and K4's plain versions read every tap their window admits;
    reading only the staged box gives the same volume, bit for bit."""
    if case == "border":
        g = Geometry().scaled(16, n_proj=6, n_u=24, n_v=18)
        mats = projection_matrices(g)
    else:
        g = Geometry().scaled(32 if case == "32" else 16, n_proj=6)
        mats = projection_matrices(g)
        if case == "flat":
            mats[2] = _flat_matrix(g)
    gs = GeomStatic.of(g)
    rng = np.random.default_rng(7)
    imgs = torch.tensor(rng.standard_normal(
        (len(mats), g.n_v, g.n_u)).astype(np.float32))
    values = R.wire_values(F.pad(imgs, (1, 1, 1, 1)), wire)
    vol = torch.tensor(rng.standard_normal((g.L,) * 3).astype(np.float32))
    A = torch.as_tensor(mats)
    ty, chunk = 8, 8
    isz = {"float32": 4, "bfloat16": 2, "int8": 1}[wire]
    for win in (_window(g, mats, ty, chunk, isz),
                dict(band=8, width=16, **dict(zip(
                    ("pad_rows", "pad_cols"),
                    R.padded_dims(gs, 8, 16, isz))))):
        want = R.backproject_strip_ref(vol.clone(), values, A, gs, ty=ty,
                                       chunk=chunk, **win)
        got = R._fold_windowed(vol.clone(), values, A, gs, 0,
                               _box_inside(A, gs, ty, chunk, win))
        assert torch.equal(got, want)
        micro = dict(group=4, gband=min(4, win["band"]),
                     gwidth=min(8, win["width"]))
        want = R.backproject_micro_ref(vol.clone(), values, A, gs, ty=ty,
                                       chunk=chunk, **win, **micro)
        got = R._fold_windowed(vol.clone(), values, A, gs, 0,
                               _box_inside(A, gs, ty, chunk, win, micro))
        assert torch.equal(got, want)


def test_strip_box_slots_are_the_largest_boxes():
    g = Geometry().scaled(32, n_proj=12)
    mats = projection_matrices(g)
    win = _window(g, mats, 1, 16, itemsize=2)
    clipping._BOXES.clear()
    slots = clipping.strip_box_slots(g, mats, ty=1, chunk=16, itemsize=2,
                                     **win)
    assert slots.shape == (12, 2) and len(clipping._BOXES) == 12
    rows, units = clipping.box_slot_dims(clipping.corner_boxes(
        g, torch.as_tensor(mats), ty=1, chunk=16, **win), 2)
    np.testing.assert_array_equal(slots[:, 0], rows.amax(dim=(1, 2, 3)))
    np.testing.assert_array_equal(slots[:, 1], units.amax(dim=(1, 2, 3)))
    # Never more than the window's worst case, and memoised per matrix.
    assert (slots[:, 0] <= win["band"]).all()
    assert (slots[:, 1] <= window_units(win["width"], 2)).all()
    again = clipping.strip_box_slots(g, torch.as_tensor(mats[::-1].copy()),
                                     ty=1, chunk=16, itemsize=2, **win)
    np.testing.assert_array_equal(again, slots[::-1])
    assert len(clipping._BOXES) == 12


def test_box_slot_units_count_whole_16_byte_units():
    one = torch.tensor([[0]])
    for c0, c1, isz, units in ((0, 4, 4, 1), (3, 5, 4, 2), (15, 17, 1, 2),
                               (16, 32, 1, 1), (7, 9, 2, 2), (5, 5, 4, 0)):
        rows, got = clipping.box_slot_dims(
            (one, one + 3, one * 0 + c0, one * 0 + c1), isz)
        assert int(got) == units
        assert int(rows) == (3 if units else 0)


def test_strip_smem_bytes_counts_slots_in_16_byte_units():
    mats = (4 * 48 + 15) // 16 * 16
    # K3: depth x (item record + rows x units x 16); K4 two slots, plus
    # its reduction scratch where a group does not divide a warp.
    assert strip_smem_bytes("db", 4, ty=1, chunk=64, band=32, width=224,
                            itemsize=4, depth=3, slot=(12, 20)) == \
        mats + 3 * (32 + 12 * 20 * 16)
    assert strip_smem_bytes("micro", 4, ty=1, chunk=64, band=32, width=224,
                            itemsize=4, group=8, slot=(12, 20)) == \
        mats + 2 * (32 + 12 * 20 * 16)
    assert strip_smem_bytes("micro", 4, ty=1, chunk=60, band=32, width=224,
                            itemsize=4, group=6, slot=(12, 20)) == \
        mats + 2 * (32 + 12 * 20 * 16) + 2 * 60 * 4
    # No slot: the window's worst case, which bounds every box.
    for isz in (4, 2, 1):
        assert window_units(224, isz) == (224 * isz + 15) // 16 + 1
        assert strip_smem_bytes("db", 4, ty=1, chunk=64, band=32,
                                width=224, itemsize=isz, depth=2) == \
            mats + 2 * (32 + 32 * window_units(224, isz) * 16)
    # K5: three sets of P box records and two slots of packed boxes; no
    # slot takes P whole windows in 16-byte units.
    assert strip_smem_bytes("shared", 4, ty=1, chunk=64, band=16,
                            width=256, itemsize=4) == \
        mats + 3 * 4 * 32 + 2 * 4 * 16 * window_units(256, 4) * 16
    # The planner's window at the reference's base tile does not fit a
    # ring; its largest box (at most 16 rows x 104 columns) does.
    assert strip_smem_bytes("db", 4, ty=8, chunk=32, band=160, width=1280,
                            itemsize=4, depth=4) > SMEM_LIMIT
    assert strip_smem_bytes("db", 4, ty=8, chunk=32, band=160, width=1280,
                            itemsize=4, depth=4, slot=(16, 28)) < 32768


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("cols", [1, 7, 16, 33, 1250])
def test_pitch_stack_pads_rows_to_16_bytes(dtype, cols):
    stack = (torch.arange(2 * 3 * cols) % 100 + 1).reshape(2, 3, cols).to(
        dtype)
    out = pitch_stack(stack)
    assert out.dtype == dtype and out.shape[:2] == (2, 3)
    assert (out.shape[2] * out.element_size()) % 16 == 0
    assert out.shape[2] - cols < 16 // out.element_size()
    assert torch.equal(out[..., :cols], stack)
    assert not out[..., cols:].any()
    assert pitch_stack(out) is out
