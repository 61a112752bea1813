"""The tap boxes K5 ``strip_shared`` stages (CPU).

Per ``(ty, chunk)`` tile, the ``P`` projections of a launch form one
group, and projection ``p`` reads its taps inside the group window: a
``(band, width)`` window at the least of the members' corner origins.
The kernel stages for each projection only the box of taps its tile's
four corner voxels bound (``repro_torch.core.clipping.corner_boxes`` with
``group=P``), cut to the group window and the image, and packs a tile's
``P`` boxes back to back in one slot; a tap outside its box reads 0.
Held here, exactly:

* each projection's group box holds every tap the K5 window admits for
  a voxel with ``w > eps``, and lies within 2 px of the brute-force box
  of those taps on each side, against a brute force over every voxel, at
  L = 32 and 64, tiles (1, 16) and (8, 8), groups of 1, 4 and 8
  consecutive or spread views;
* a fold that reads its taps only through the boxes equals the plain
  version of K5 bitwise, on every wire;
* the slot sizing (``shared_box_slots``: per group, the largest
  per-tile total) and the shared-memory byte model, against the
  kernel's own constants.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.kernels.backproject_ref as R
from repro_torch.core import clipping
from repro_torch.core.backproject import GeomStatic, plane_coords
from repro_torch.core.geometry import Geometry, projection_matrices
from repro_torch.kernels.backproject import (SMEM_LIMIT, shared_slot_units,
                                             strip_smem_bytes, window_units)
from repro_torch.kernels.backproject_ops import (clamp_tiles,
                                                 shared_window_dims)
from repro_torch.tune.space import kernel_smem_bytes

_EPS_W = 1e-6
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def _window(g, mats, ty, chunk, itemsize=4):
    """K5's window for the group ``mats`` at the tile (every tap of the
    group), and the padded image it is clamped into."""
    gs = GeomStatic.of(g)
    b, w = shared_window_dims(g, mats, ty=ty, chunk=chunk,
                              pbatch=len(mats))
    _, _, band, width = clamp_tiles(gs, ty, chunk, b, w)
    return dict(band=band, width=width, **dict(zip(
        ("pad_rows", "pad_cols"),
        R.padded_dims(gs, band, width, itemsize))))


def _group_origin(A, zs, gs, ty, chunk, win):
    wr, wc = R._corner_origins(A, zs, gs, ty, chunk, win["band"],
                               win["width"], win["pad_rows"],
                               win["pad_cols"])
    return wr.amin(dim=0), wc.amin(dim=0)


def _check_group(g, mats, zs, ty, chunk, win):
    """Every tap the group window admits for a live voxel lies in its
    projection's box; every box lies in the window and the image."""
    gs = GeomStatic.of(g)
    A = torch.as_tensor(mats)
    box = clipping.corner_boxes(gs, A, ty=ty, chunk=chunk, zs=zs,
                                group=len(A), **win)
    wr, wc = _group_origin(A, zs, gs, ty, chunk, win)
    r0, r1, c0, c1 = box
    full = (r1 > r0) & (c1 > c0)
    assert bool(full.any())
    assert bool(((r0 >= wr) & (c0 >= wc) & (r1 <= wr + win["band"])
                 & (c1 <= wc + win["width"]) & (r1 <= g.n_v + 2)
                 & (c1 <= g.n_u + 2))[full].all())
    per = [R._per_voxel(t, ty, chunk) for t in (*box, wr, wc)]
    ix, iy, w = plane_coords(A, gs, zs)
    live = w > _EPS_W
    rr, c = R._tap_index(torch.floor(iy)), R._tap_index(torch.floor(ix))
    # Tight: within 2 px on each side of the brute-force box of the live
    # voxels' taps, cut to the group window and the image.
    big = 1 << 30

    def tiles(t, red):
        n, nz, L, _ = t.shape
        t = t.reshape(n, nz, L // ty, ty, L // chunk, chunk)
        return red(red(t, 5), 3)

    def lo(t):
        return tiles(torch.where(live, t, big), lambda t, d: t.amin(dim=d))

    def hi(t):
        return tiles(torch.where(live, t + 2, -big),
                     lambda t, d: t.amax(dim=d))

    brute = (torch.clamp(torch.maximum(lo(rr), wr), min=0),
             torch.clamp(torch.minimum(hi(rr), wr + win["band"]),
                         max=g.n_v + 2),
             torch.clamp(torch.maximum(lo(c), wc), min=0),
             torch.clamp(torch.minimum(hi(c), wc + win["width"]),
                         max=g.n_u + 2))
    tight = full & (brute[1] > brute[0]) & (brute[3] > brute[2])
    assert bool(tight.any())
    for a, b, sign in zip(box, brute, (1, -1, 1, -1)):
        d = sign * (b - a)[tight]
        assert bool((d >= 0).all()) and int(d.max()) <= 2
    for dr in (0, 1):
        for dc in (0, 1):
            rq, cq = rr + dr, c + dc
            admitted = (live & (rq >= per[4]) & (rq < per[4] + win["band"])
                        & (cq >= per[5]) & (cq < per[5] + win["width"])
                        & (rq >= 0) & (rq < g.n_v + 2) & (cq >= 0)
                        & (cq < g.n_u + 2))
            inside = ((rq >= per[0]) & (rq < per[1]) & (cq >= per[2])
                      & (cq < per[3]))
            assert not bool((admitted & ~inside).any()), \
                "a tap the group window admits lies outside its box"


@pytest.mark.parametrize("spread", [False, True], ids=["consecutive",
                                                       "spread"])
@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("tile", [(1, 16), (8, 8)])
@pytest.mark.parametrize("L", [32, 64])
def test_group_boxes_hold_every_tap(L, tile, P, spread):
    g = Geometry().scaled(L)
    mats = projection_matrices(g)
    ty, chunk = tile
    n = len(mats)
    if spread:
        starts = [np.linspace(s, n - 1, P).astype(int) for s in (0, 37)]
    else:
        starts = [np.arange(s, s + P) for s in (0, n // 3, n // 2,
                                                n - P)]
    zs = torch.arange(L) if L == 32 else torch.tensor([0, 17, 31, 46, 63])
    for idx in starts:
        group = mats[idx]
        _check_group(g, group, zs, ty, chunk, _window(g, group, ty, chunk))


def _flat_matrix(g):
    """A RabbitCT matrix whose w row vanishes on the plane x = 0 and is
    negative beyond it, so that tiles there have corners at w <= eps."""
    A = projection_matrices(g)[3].copy()
    A[2] = [1.0, 0.0, 0.0, 0.0]
    return A


def _box_inside(mats, gs, ty, chunk, win):
    """K5's tap rule as a ``windows`` function of
    ``backproject_ref._fold_windowed``: projection ``p`` reads a tap
    inside its group box, else 0."""
    def windows(zs, ix, iy):
        box = clipping.corner_boxes(gs, mats, ty=ty, chunk=chunk, zs=zs,
                                    group=len(mats), **win)
        r0, r1, c0, c1 = (R._per_voxel(t, ty, chunk) for t in box)

        def inside(p):
            return lambda rq, cq: ((rq >= r0[p]) & (rq < r1[p])
                                   & (cq >= c0[p]) & (cq < c1[p]))
        return inside
    return windows


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["border", "32", "flat"])
def test_packed_box_fold_equals_plain_bitwise(wire, case):
    """K5's plain version reads every tap its group window admits;
    reading only each projection's box gives the same volume, bit for
    bit, in a group of all six views and of the first four, at the
    window that covers the group and at one too small for it."""
    if case == "border":
        g = Geometry().scaled(16, n_proj=6, n_u=24, n_v=18)
        mats = projection_matrices(g)
    else:
        g = Geometry().scaled(32 if case == "32" else 16, n_proj=6)
        mats = projection_matrices(g)
        if case == "flat":
            mats[2] = _flat_matrix(g)
    gs = GeomStatic.of(g)
    rng = np.random.default_rng(11)
    imgs = torch.tensor(rng.standard_normal(
        (len(mats), g.n_v, g.n_u)).astype(np.float32))
    values = R.wire_values(F.pad(imgs, (1, 1, 1, 1)), wire)
    vol = torch.tensor(rng.standard_normal((g.L,) * 3).astype(np.float32))
    ty, chunk = 8, 8
    isz = _ITEMSIZE[wire]
    for P in (6, 4):
        A = torch.as_tensor(mats[:P])
        for win in (_window(g, mats[:P], ty, chunk, isz),
                    dict(band=8, width=16, **dict(zip(
                        ("pad_rows", "pad_cols"),
                        R.padded_dims(gs, 8, 16, isz))))):
            want = R.backproject_shared_ref(vol.clone(), values[:P], A, gs,
                                            ty=ty, chunk=chunk, **win)
            got = R._fold_windowed(vol.clone(), values[:P], A, gs, 0,
                                   _box_inside(A, gs, ty, chunk, win))
            assert torch.equal(got, want), (P, win)


def test_shared_box_slots_are_the_largest_tile_totals():
    g = Geometry().scaled(32, n_proj=10)
    gs = GeomStatic.of(g)
    mats = projection_matrices(g)
    win = _window(g, mats, 1, 16, itemsize=2)
    clipping._BOXES.clear()
    slots = clipping.shared_box_slots(g, mats, ty=1, chunk=16, itemsize=2,
                                      pbatch=4, **win)
    # Groups of 4, 4 and the remainder of 2, each memoised once.
    assert slots.shape == (3,) and len(clipping._BOXES) == 3
    for j, (s, e) in enumerate(((0, 4), (4, 8), (8, 10))):
        rows, units = clipping.box_slot_dims(clipping.corner_boxes(
            gs, torch.as_tensor(mats[s:e]), ty=1, chunk=16, group=e - s,
            **win), 2)
        assert slots[j] == int((rows * units).sum(dim=0).max())
        assert 0 < slots[j] <= shared_slot_units(e - s, win["band"],
                                                 win["width"], 2)
    again = clipping.shared_box_slots(g, torch.as_tensor(mats), ty=1,
                                      chunk=16, itemsize=2, pbatch=4,
                                      **win)
    np.testing.assert_array_equal(again, slots)
    assert len(clipping._BOXES) == 3
    one = clipping.shared_box_slots(g, mats[:4], ty=1, chunk=16,
                                    itemsize=2, **win)
    np.testing.assert_array_equal(one, slots[:1])


def test_shared_smem_bytes_counts_what_the_kernel_allocates():
    """The byte model of K5: the matrices, three sets of P 32-byte box
    records and two slots, the constants of the kernel's source."""
    src = (pathlib.Path(R.__file__).parent / "csrc" /
           "backproject_strip.cu").read_text()
    sets = int(re.search(r"kSharedSets = (\d+);", src).group(1))
    slots = int(re.search(r"kSharedSlots = (\d+);", src).group(1))
    box = re.search(r"struct Box \{\s*int ([^;]*);", src).group(1)
    packed = re.search(r"struct PackedBox \{\s*Box b;\s*int ([^;]*);",
                       src).group(1)
    record = 4 * (len(box.split(",")) + len(packed.split(",")))
    assert (sets, slots, record) == (3, 2, 32)
    for P, slot in ((1, 0), (4, 1234), (8, 5000)):
        mats = (P * 48 + 15) // 16 * 16
        assert strip_smem_bytes("shared", P, ty=8, chunk=32, band=40,
                                width=256, itemsize=4, slot=slot) == \
            mats + sets * P * record + slots * slot * 16
    # No slot: P whole windows, which no tile's boxes exceed.
    for isz in (4, 2, 1):
        most = shared_slot_units(4, 16, 256, isz)
        assert most == 4 * 16 * window_units(256, isz)
        assert strip_smem_bytes("shared", 4, ty=1, chunk=64, band=16,
                                width=256, itemsize=isz) == \
            (4 * 48) + 3 * 4 * 32 + 2 * most * 16
    # The tuner's screen: the records and the slots the sweep sizes;
    # without them, the records alone.
    gs = GeomStatic.of(Geometry())
    cfg = {"shared_window": True, "pbatch": 4, "ty": 8, "chunk": 32}
    assert kernel_smem_bytes(gs, cfg, slot=1234) == \
        4 * 48 + sets * 4 * record + slots * 1234 * 16
    assert kernel_smem_bytes(gs, cfg) == 4 * 48 + sets * 4 * record
    # Two whole (32, 256) windows per view at P = 8 do not fit a block;
    # the boxes of a (1, 64) tile (about 9 rows x 50 units) do.
    assert strip_smem_bytes("shared", 8, ty=1, chunk=64, band=32,
                            width=256, itemsize=4) > SMEM_LIMIT
    assert strip_smem_bytes("shared", 8, ty=1, chunk=64, band=32,
                            width=256, itemsize=4,
                            slot=8 * 9 * 50) < SMEM_LIMIT
