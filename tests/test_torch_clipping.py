"""The port's strip planner (``repro_torch.core.clipping``, numpy) equals
the reference's exactly: clip ranges, strip origins, active chunks,
required window sizes and the shared-window requirement.  Both are
float64 numpy on the same matrices, so any difference is a bug."""

import dataclasses

import numpy as np
import pytest

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
