"""The port's strip planner (``repro_torch.core.clipping``, float64
tensors) equals the reference's (float64 numpy) exactly: clip ranges,
strip origins, active chunks, required window sizes, the per-tile window
needs and the shared-window requirement.  Every operation is elementwise
float64 in the same order, so any difference is a bug."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.clipping as jclip
from repro.core.geometry import Geometry as JGeometry
from repro.core.geometry import projection_matrices as j_mats
from repro.core.geometry import projection_matrix as j_matrix
from repro_torch.core import clipping as tclip
from repro_torch.core.geometry import Geometry

GEOMS = {
    16: (JGeometry().scaled(16, n_proj=8), Geometry().scaled(16, n_proj=8)),
    32: (JGeometry().scaled(32, n_proj=6), Geometry().scaled(32, n_proj=6)),
    # A detector smaller than the volume's footprint: border rays.
    "border": (JGeometry().scaled(16, n_proj=8, n_u=24, n_v=18),
               Geometry().scaled(16, n_proj=8, n_u=24, n_v=18)),
}
THETAS = [0.0, 0.7, 1.9, 3.3, 5.9]


def _assert_plans_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            va = va.cpu().numpy()
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
            assert va.dtype == vb.dtype
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("key", list(GEOMS))
@pytest.mark.parametrize("theta", THETAS)
def test_line_clips_equal_reference(key, theta):
    jg, g = GEOMS[key]
    A = j_matrix(jg, theta)
    _assert_plans_equal(tclip.line_clip_exact(g, A),
                        jclip.line_clip_exact(jg, A))
    _assert_plans_equal(tclip.line_clip_conservative(g, A),
                        jclip.line_clip_conservative(jg, A))
    assert tclip.line_clip_exact(g, A).voxels == \
        jclip.line_clip_exact(jg, A).voxels


@pytest.mark.parametrize("key", list(GEOMS))
@pytest.mark.parametrize("chunk,band,width", [(4, None, None),
                                              (8, None, None),
                                              (16, 16, 128)])
def test_plan_strips_equals_reference(key, chunk, band, width):
    jg, g = GEOMS[key]
    for theta in THETAS[1:4]:
        A = j_matrix(jg, theta)
        _assert_plans_equal(
            tclip.plan_strips(g, A, chunk, band=band, width=width),
            jclip.plan_strips(jg, A, chunk, band=band, width=width))


def test_pad_projection_equals_reference():
    img = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(tclip.pad_projection(img),
                                  jclip.pad_projection(img))


@pytest.mark.parametrize("ty,chunk,pbatch", [(4, 8, 4), (8, 16, 3),
                                             (2, 4, 8)])
def test_shared_window_requirement_equals_reference(ty, chunk, pbatch):
    jg, g = GEOMS[16]
    mats = j_mats(jg)
    assert tclip.shared_window_requirement(
        g, mats, ty=ty, chunk=chunk, pbatch=pbatch) == \
        jclip.shared_window_requirement(jg, mats, ty=ty, chunk=chunk,
                                        pbatch=pbatch)


def _reference_needs(jg, A, chunk, ty):
    """The reference's per-matrix window needs (its validate_strip_config
    arithmetic)."""
    plan = jclip.plan_strips(jg, A, chunk=chunk)
    L = jg.L
    g = plan.r0.astype(np.int64).reshape(L, L // ty, ty, -1)
    gc = plan.c0.astype(np.int64).reshape(L, L // ty, ty, -1)
    return (int((g.max(2) - g.min(2) + plan.required_band).max()),
            int((gc.max(2) - gc.min(2) + plan.required_width).max()))


@pytest.mark.parametrize("key", list(GEOMS))
@pytest.mark.parametrize("chunk,ty", [(8, 1), (16, 4), (4, 8), (16, 16)])
def test_strip_needs_equal_reference(key, chunk, ty):
    """The batched planner's per-matrix window needs equal the
    reference's, matrix by matrix, also when the batch is cut small."""
    jg, g = GEOMS[key]
    mats = j_mats(jg).astype(np.float64)
    want = [_reference_needs(jg, A, chunk, ty) for A in mats]
    tclip._NEEDS.clear()
    assert [tuple(n) for n in tclip.strip_needs(g, mats, chunk=chunk,
                                                ty=ty)] == want
    tclip._NEEDS.clear()
    old = tclip._BATCH_ELEMS
    tclip._BATCH_ELEMS = g.L * g.L * (g.L // chunk) * 3   # 3 per batch
    try:
        assert [tuple(n) for n in tclip.strip_needs(
            g, torch.tensor(mats), chunk=chunk, ty=ty)] == want
    finally:
        tclip._BATCH_ELEMS = old


def test_plans_are_memoised_per_matrix(monkeypatch):
    """Every check at one chunk reuses one plan: a matrix planned once
    (as part of any set) is not planned again, and a new set plans only
    its new matrices."""
    jg, g = GEOMS[16]
    mats = j_mats(jg).astype(np.float64)
    tclip._NEEDS.clear()
    planned = []
    real = tclip._plan
    monkeypatch.setattr(tclip, "_plan", lambda geom, A, *a, **k: (
        planned.append(len(A)), real(geom, A, *a, **k))[1])
    first = tclip.strip_needs(g, mats[:5], chunk=8, ty=4)
    assert planned == [5]
    # The ty=1 needs came with the same pass.
    np.testing.assert_array_equal(
        tclip.strip_needs(g, mats[:5], chunk=8),
        [[p.required_band, p.required_width]
         for p in (jclip.plan_strips(jg, A, chunk=8) for A in mats[:5])])
    both = tclip.strip_needs(g, mats[3:], chunk=8, ty=4)
    assert planned == [5, 3]
    np.testing.assert_array_equal(both[:2], first[3:])


def test_plans_stay_on_the_matrices_device():
    jg, g = GEOMS[32]
    A = torch.tensor(j_matrix(jg, 1.1))
    plan = tclip.plan_strips(g, A, 8)
    assert plan.r0.device == A.device and plan.r0.dtype == torch.int32
    assert tclip.line_clip_exact(g, A).x0.device == A.device
