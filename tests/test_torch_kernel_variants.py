"""The strip kernels' plain versions against the reference (CPU).

K3 ``strip_db``, K4 ``strip_micro`` and K5 ``strip_shared`` run on the
CPU as their plain versions (``repro_torch.kernels.backproject_ref``,
through ``backproject_batch``/``backproject_one``), on the same numpy
inputs as the reference's Pallas variants (interpret mode) and its
oracles, at L=16 with 8 views and with a detector smaller than the
volume's footprint (border rays).

Tolerances:
* db and shared against the Pallas variants: 1e-5·max(1, max|ref|)
  (float32 summation order and XLA fusion only).  On the int8 wire the
  Pallas wrapper encodes round-up pixels past the 1-pixel border that
  the port reads as 0 (ROADMAP Queue 3): there the two agree to 1e-5 on
  every voxel none of whose taps leaves the bordered image, and within
  500 times that elsewhere; the port is held to the jnp int8 path at
  1e-5.
* micro against the reference's scalar oracle (float32), or its jnp
  strip2 path on a narrow wire: MICRO_TOL·max(1, max|ref|), not against
  the Pallas micro output.  The oracle's XLA arithmetic differs from
  the port's in the last bits: at L=48 (the reference's own micro case)
  the port's micro, bitwise equal to its row 1 there, is 7.4e-5 from the
  oracle at max|ref| 4.07.
* With windows that cover every tap, each plain version equals row 1's
  plain version bitwise.
"""

import numpy as np
import pytest
import torch

import repro.core.backproject as jbp
import repro.core.filtering as jfilt
import repro.core.phantom as jph
from repro.core.geometry import Geometry as JGeometry
from repro.core.geometry import projection_matrices as j_mats
from repro.core.geometry import projection_matrix as j_matrix
from repro.kernels import backproject_ops as jops
from repro_torch.core.backproject import GeomStatic
from repro_torch.core.geometry import Geometry
from repro_torch.kernels import backproject_ops as tops
from repro_torch.kernels.backproject_ref import backproject_batch_ref

MICRO_TOL = 2.5e-5

CASES = {
    "16": dict(n_proj=8),
    "border": dict(n_proj=8, n_u=24, n_v=18),
}
TILE = dict(ty=8, chunk=16, band=16, width=128)
WIRES = ("float32", "bfloat16", "int8")


def _case(key):
    jg = JGeometry().scaled(16, **CASES[key])
    g = Geometry().scaled(16, **CASES[key])
    filt = np.asarray(jfilt.filter_projections(jph.forward_project(jg), jg))
    vol = np.random.default_rng(3).standard_normal(
        (16, 16, 16)).astype(np.float32)
    return jg, g, filt, j_mats(jg), vol


_CASES = {k: _case(k) for k in CASES}


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _past(g, mats):
    """Voxels with a tap past the bordered image on the high side."""
    from repro_torch.core.backproject import plane_coords

    ix, iy, _ = plane_coords(torch.tensor(mats), GeomStatic.of(g),
                             torch.arange(g.L))
    return ((torch.floor(ix) + 2 >= g.n_u + 2)
            | (torch.floor(iy) + 2 >= g.n_v + 2)).any(dim=0).numpy()


def _port(vol, filt, mats, g, **kw):
    return tops.backproject_batch(torch.tensor(vol), torch.tensor(filt),
                                  mats, g, **kw).numpy()


def _row1(vol, filt, mats, g, wire, pbatch):
    out = torch.tensor(vol)
    for b0 in range(0, len(filt), pbatch):
        backproject_batch_ref(out, torch.tensor(filt[b0:b0 + pbatch]),
                              torch.tensor(mats[b0:b0 + pbatch]),
                              GeomStatic.of(g), wire=wire)
    return out.numpy()


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("flags", [
    pytest.param(dict(double_buffer=True, db_depth=2), id="db2"),
    pytest.param(dict(double_buffer=True, db_depth=3), id="db3"),
    pytest.param(dict(shared_window=True), id="shared"),
])
def test_db_and_shared_match_pallas(key, wire, flags):
    jg, g, filt, mats, vol = _CASES[key]
    kw = dict(TILE, pbatch=4, strip_dtype=wire, **flags)
    want = np.asarray(jops.pallas_backproject_batch(
        vol, filt, mats, jg, interpret=True, **kw))
    got = _port(vol, filt, mats, g, **kw)
    tol = _tol(want)
    # Covering windows: the plain version is row 1's, bitwise.
    np.testing.assert_array_equal(got, _row1(vol, filt, mats, g, wire, 4))
    if wire != "int8":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        return
    past = _past(g, mats)
    np.testing.assert_allclose(got[~past], want[~past], rtol=0, atol=tol)
    assert float(np.abs(got - want).max()) <= 500 * tol
    jnp_int8 = vol + np.asarray(jbp.reconstruct(
        filt, mats, jg, strategy="strip2", strip_dtype="int8", pbatch=4))
    np.testing.assert_allclose(got, jnp_int8, rtol=0, atol=_tol(jnp_int8))


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("wire", WIRES)
def test_micro_matches_scalar_oracle(key, wire):
    jg, g, filt, mats, vol = _CASES[key]
    got = _port(vol, filt, mats, g, pbatch=4, strip_dtype=wire, micro=True,
                micro_group=8, micro_band=8, micro_width=32, **TILE)
    np.testing.assert_array_equal(got, _row1(vol, filt, mats, g, wire, 4))
    if wire == "float32":
        oracle = np.asarray(jbp.reconstruct(filt, mats, jg,
                                            strategy="scalar"))
    else:
        oracle = np.asarray(jbp.reconstruct(filt, mats, jg,
                                            strategy="strip2",
                                            strip_dtype=wire))
    want = vol + oracle
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MICRO_TOL * max(1.0, float(
                                   np.abs(want).max())))


def test_micro_at_the_reference_case():
    """The reference's own micro case (L=48, one view, chunk=48): the
    undersized micro window raises with the reference's words, and the
    default window validates, equals row 1 bitwise and stays within
    MICRO_TOL of the scalar oracle."""
    jg = JGeometry().scaled(48, n_proj=4)
    g = Geometry().scaled(48, n_proj=4)
    image = np.random.default_rng(7).standard_normal(
        (g.n_v, g.n_u)).astype(np.float32)
    A = j_matrix(jg, 2.9).astype(np.float32)
    tile = dict(ty=8, chunk=48, band=32, width=256)
    msgs = []
    for mod, geom in ((jops, jg), (tops, g)):
        with pytest.raises(ValueError, match="micro window") as e:
            mod.validate_strip_config(geom, A.astype(np.float64), micro=True,
                                      micro_band=4, **tile)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    vol = torch.zeros((48,) * 3)
    got = tops.backproject_one(vol, torch.tensor(image), A, g, micro=True,
                               **tile).numpy()
    row1 = backproject_batch_ref(torch.zeros((48,) * 3),
                                 torch.tensor(image)[None],
                                 torch.tensor(A)[None], GeomStatic.of(g))
    np.testing.assert_array_equal(got, row1.numpy())
    import jax.numpy as jnp

    oracle = np.asarray(jbp.backproject_one(
        jnp.zeros((48,) * 3, jnp.float32), jnp.asarray(image),
        jnp.asarray(A), jg, strategy="scalar"))
    np.testing.assert_allclose(
        got, oracle, rtol=0,
        atol=MICRO_TOL * max(1.0, float(np.abs(oracle).max())))


@pytest.mark.parametrize("flags", [
    pytest.param(dict(double_buffer=True, db_depth=2), id="db"),
    pytest.param(dict(micro=True, micro_group=4, micro_band=8,
                      micro_width=32), id="micro"),
])
def test_one_projection_variants_match_pallas(flags):
    """Rows 7 and 8: K3 and K4 launched with P = 1."""
    jg, g, filt, mats, vol = _CASES["border"]
    kw = dict(TILE, **flags)
    want = np.asarray(jops.pallas_backproject_one(
        vol, filt[2], mats[2], jg, interpret=True, validate=True, **kw))
    got = tops.backproject_one(torch.tensor(vol), torch.tensor(filt[2]),
                               mats[2], g, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("tile,flags", [
    pytest.param(dict(ty=2, chunk=16, band=6, width=12),
                 dict(double_buffer=True), id="db-narrow"),
    pytest.param(dict(ty=4, chunk=8, band=4, width=8),
                 dict(double_buffer=True), id="db-tiny"),
    pytest.param(dict(ty=8, chunk=16, band=8, width=128),
                 dict(micro=True, micro_group=4, micro_band=2,
                      micro_width=4), id="micro-tiny"),
])
def test_undersized_windows_drop_the_reference_taps(tile, flags):
    """With the check off, a window that misses taps drops exactly the
    taps the Pallas variant drops: the window rules (corner origins,
    the micro run's clip-then-min origin) are the reference's."""
    jg, g, filt, mats, vol = _CASES["16"]
    vol = np.zeros_like(vol)
    kw = dict(tile, pbatch=4, **flags)
    want = np.asarray(jops.pallas_backproject_batch(
        vol, filt, mats, jg, interpret=True, validate=False, **kw))
    got = _port(vol, filt, mats, g, validate=False, **kw)
    full = _row1(vol, filt, mats, g, "float32", 4)
    assert float(np.abs(full - want).max()) > 100 * _tol(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("kw", [
    pytest.param(dict(band=8), id="strip-band"),
    pytest.param(dict(width=16), id="strip-width"),
    pytest.param(dict(micro=True, micro_band=2), id="micro-band"),
    pytest.param(dict(micro=True, micro_width=3), id="micro-width"),
    pytest.param(dict(micro=True, micro_group=3), id="micro-group"),
])
def test_undersized_strips_raise_with_reference_needs(kw):
    jg, g, filt, mats, vol = _CASES["16"]
    args = dict(TILE, **kw)
    msgs = []
    for mod, geom in ((jops, jg), (tops, g)):
        with pytest.raises(ValueError) as e:
            for A in mats.astype(np.float64):
                mod.validate_strip_config(geom, A, **args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # The whole stack at once raises for the same first matrix.
    with pytest.raises(ValueError) as e:
        tops.validate_strip_config(g, mats, **args)
    assert str(e.value) == msgs[0]
    with pytest.raises(ValueError, match="need at least|must divide"):
        _port(vol, filt, mats, g, pbatch=4, double_buffer=not kw.get(
            "micro"), **args)


def test_undersized_shared_window_raises():
    """K5's window is sized by its own rule
    (``clipping.shared_window_cover``); a pinned window smaller than
    that raises in the reference's words, with the rule's needs."""
    from repro_torch.core import clipping

    jg, g, filt, mats, vol = _CASES["border"]
    need = clipping.shared_window_cover(g, mats, ty=8, chunk=16, pbatch=4)
    need = (min(need[0], g.n_v + 2), min(need[1], g.n_u + 2))
    with pytest.raises(ValueError, match="shared window") as e:
        tops.shared_window_dims(g, mats, ty=8, chunk=16, pbatch=4,
                                shared_band=4)
    assert str(e.value).startswith(
        "shared window (shared_band=4, shared_width=") and \
        f"need at least (shared_band={need[0]}, shared_width={need[1]})" \
        in str(e.value)
    assert tops.shared_window_dims(g, mats, ty=8, chunk=16, pbatch=4) == \
        (max(8, -(-need[0] // 8) * 8), max(128, -(-need[1] // 128) * 128))
    with pytest.raises(ValueError, match="shared window"):
        _port(vol, filt, mats, g, pbatch=4, shared_window=True,
              shared_width=8, **TILE)


@pytest.mark.parametrize("flags", [
    pytest.param(dict(micro=True, double_buffer=True), id="micro+db"),
    pytest.param(dict(shared_window=True, double_buffer=True),
                 id="shared+db"),
    pytest.param(dict(shared_window=True, micro=True), id="shared+micro"),
    pytest.param(dict(double_buffer=True, db_depth=1), id="db-depth-1"),
])
def test_variant_errors_match_reference(flags):
    jg, g, filt, mats, vol = _CASES["16"]
    with pytest.raises(ValueError) as want:
        jops.pallas_backproject_batch(vol, filt, mats, jg, interpret=True,
                                      **TILE, **flags)
    with pytest.raises(ValueError) as got:
        _port(vol, filt, mats, g, **TILE, **flags)
    assert str(got.value) == str(want.value)


def test_clamp_tiles_matches_reference():
    for key in CASES:
        jg, g = _CASES[key][:2]
        for tile in ((8, 128, 16, 512), (4, 8, 300, 40), (32, 32, 8, 128)):
            assert tops.clamp_tiles(GeomStatic.of(g), *tile) == \
                jops.clamp_tiles(jbp.GeomStatic.of(jg), *tile)


def test_shared_window_covers_spread_groups():
    """K5 is sized by its own rule.  For four views 90 degrees apart at
    L=64 the reference's rule gives a window that drops taps (its planner
    origins are clamped to each view's own strip); the port's sizing
    covers them, and K5 equals row 1 bitwise."""
    import torch.nn.functional as F

    from repro_torch.core import clipping
    from repro_torch.kernels import backproject_ref as R

    g = Geometry().scaled(64, n_proj=32)
    gs = GeomStatic.of(g)
    idx = [0, 8, 16, 24]
    mats = torch.tensor(j_mats(JGeometry().scaled(64, n_proj=32))[idx])
    vals = F.pad(torch.tensor(np.random.default_rng(5).standard_normal(
        (4, g.n_v, g.n_u)).astype(np.float32)), (1, 1, 1, 1))
    row1 = R.backproject_padded_ref(torch.zeros((64,) * 3), vals, mats, gs)

    def shared(band, width):
        band, width = tops.clamp_tiles(gs, 8, 32, band, width)[2:]
        pr, pc = R.padded_dims(gs, band, width, 4)
        return R.backproject_shared_ref(
            torch.zeros((64,) * 3), vals, mats, gs, ty=8, chunk=32,
            band=band, width=width, pad_rows=pr, pad_cols=pc)

    ref_need = clipping.shared_window_requirement(g, mats, ty=8, chunk=32,
                                                  pbatch=4)
    cover = clipping.shared_window_cover(g, mats, ty=8, chunk=32, pbatch=4)
    assert cover[1] > ref_need[1]
    assert not torch.equal(shared(*ref_need), row1)
    assert torch.equal(shared(*cover), row1)
    dims = tops.shared_window_dims(g, mats, ty=8, chunk=32, pbatch=4)
    assert torch.equal(shared(*dims), row1)
