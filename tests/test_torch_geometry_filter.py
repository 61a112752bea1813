"""The port's geometry, phantom, quality and filtering against the JAX
package, on the same inputs at small size (CPU).

Tolerances: matrices and Parker/cosine tables are the same numpy code,
so bitwise.  The phantom runs in float64 on both sides and is compared
in float32 at rtol 1e-6 (plus 1e-6·max of absolute slack for rays that
graze an ellipsoid, where the chord is a difference of near-equal
float64 terms).  The filter's FFTs come from different libraries, so
fp32 atol 1e-5·max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.filtering as jfilt
import repro.core.phantom as jph
import repro.core.quality as jq
from repro.core.geometry import Geometry as JGeometry
from repro.core.geometry import projection_matrices as j_mats
from repro_torch import convert
from repro_torch.core import filtering as tfilt
from repro_torch.core import phantom as tph
from repro_torch.core import quality as tq
from repro_torch.core.geometry import Geometry, projection_matrices

JG = JGeometry().scaled(16, n_proj=6)
G = Geometry().scaled(16, n_proj=6)
PROJS = jph.forward_project(JG)


def _filter_tol(ref):
    return 1e-5 * float(np.abs(ref).max())


def test_geometry_and_matrices_bitwise_equal():
    assert dataclasses.asdict(G) == dataclasses.asdict(JG)
    assert convert.geometry_from_reference(dataclasses.asdict(JG)) == G
    np.testing.assert_array_equal(projection_matrices(G), j_mats(JG))
    # The full RabbitCT geometry too: host numpy, cheap.
    full_j, full_t = JGeometry(), Geometry()
    np.testing.assert_array_equal(projection_matrices(full_t)[::31],
                                  j_mats(full_j)[::31])


def test_forward_project_matches_reference():
    out = tph.forward_project(G, device="cpu", block=4).numpy()
    assert out.shape == PROJS.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, PROJS, rtol=1e-6,
                               atol=1e-6 * np.abs(PROJS).max())


def test_voxelize_matches_reference():
    ref = jph.voxelize(JG)
    out = tph.voxelize(G, device="cpu", slab=5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_make_dataset_matches_reference():
    projs, mats, ref = jph.make_dataset(JG)
    tp, tm, tr = tph.make_dataset(G, device="cpu")
    np.testing.assert_array_equal(tm, mats)
    np.testing.assert_allclose(tp.numpy(), projs, rtol=1e-6,
                               atol=1e-6 * np.abs(projs).max())
    np.testing.assert_allclose(tr.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_quality_metrics_match_reference():
    ref = jph.voxelize(JG)
    vol = ref + np.random.default_rng(1).normal(
        0, 0.05, ref.shape).astype(np.float32)
    np.testing.assert_array_equal(tq.roi_mask(16, device="cpu").numpy(),
                                  jq.roi_mask(16))
    want = jq.quality_report(vol, ref)
    got = tq.quality_report(torch.tensor(vol), ref)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5), key


def test_filter_full_stack_matches_reference():
    ref = np.asarray(jfilt.filter_projections(PROJS, JG))
    out = tfilt.filter_projections(PROJS, G, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_filter_tol(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_shuffled_subset_by_angle_index(seed):
    idx = np.random.default_rng(seed).permutation(G.n_proj)[:4]
    ref = np.asarray(jfilt.filter_projections(PROJS[idx], JG,
                                              angle_indices=idx))
    out = tfilt.filter_projections(torch.tensor(PROJS[idx]), G,
                                   angle_indices=idx, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_filter_tol(ref))
    # A single image with a scalar index.
    one = tfilt.filter_projections(PROJS[idx[0]], G, angle_indices=idx[0],
                                   device="cpu").numpy()
    np.testing.assert_allclose(one, ref[0], rtol=0, atol=_filter_tol(ref))


def test_short_scan_subset_without_indices_raises_on_both_sides():
    with pytest.raises(ValueError, match="angle_indices"):
        jfilt.filter_projections(PROJS[:3], JG)
    with pytest.raises(ValueError, match="angle_indices"):
        tfilt.filter_projections(PROJS[:3], G, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 6\)"):
        tfilt.filter_projections(PROJS[:2], G, angle_indices=[0, 6],
                                 device="cpu")
    with pytest.raises(ValueError, match="one angle index"):
        tfilt.filter_projections(PROJS[:2], G, angle_indices=[0],
                                 device="cpu")
    # short_scan=False needs no indices, as in the reference.
    ref = np.asarray(jfilt.filter_projections(PROJS[:3], JG,
                                              short_scan=False))
    out = tfilt.filter_projections(PROJS[:3], G, short_scan=False,
                                   device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_filter_tol(ref))


def test_filter_plan_from_reference_equals_own_plan():
    jp = jfilt.make_filter_plan(JG)
    plan = convert.filter_plan_from_reference(
        jp.pad, jp.n_u, jp.n_proj, jp.scale, np.asarray(jp.hf),
        np.asarray(jp.cosw), np.asarray(jp.parker), device="cpu")
    own = tfilt.make_filter_plan(G, device="cpu")
    assert (plan.pad, plan.n_u, plan.n_proj, plan.scale) == \
        (own.pad, own.n_u, own.n_proj, own.scale)
    assert plan.hf.dtype == own.hf.dtype == torch.complex64
    assert torch.equal(plan.hf, own.hf)
    assert torch.equal(plan.cosw, own.cosw)
    assert torch.equal(plan.parker, own.parker)
    # The carried plan filters exactly as the port's own.
    x = torch.tensor(PROJS)
    pw = own.parker
    assert torch.equal(tfilt.apply_filter(x, plan, plan.parker),
                       tfilt.apply_filter(x, own, pw))
    with pytest.raises(TypeError, match="complex64"):
        convert.filter_plan_from_reference(
            jp.pad, jp.n_u, jp.n_proj, jp.scale,
            np.asarray(jp.hf).astype(np.complex128), np.asarray(jp.cosw),
            None, device="cpu")
