"""The five back-projection strategies of the port against the JAX
package on the CPU, the planner-backed window check, and the execution
plan's validation.

Tolerance: atol 1e-5·max(1, max|ref|).  Both sides compute the same
float32 semantics; they differ in summation order inside the one-hot
products and the batch sums, and in XLA's fusion.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.backproject as jbp
import repro.core.filtering as jfilt
import repro.core.phantom as jph
from repro.core.geometry import Geometry as JGeometry
from repro.core.geometry import projection_matrices as j_mats
from repro.core.geometry import projection_matrix as j_matrix
from repro.dispatch.plan import ExecutionPlan as JPlan
from repro_torch import convert
from repro_torch.core import backproject as tbp
from repro_torch.core.geometry import Geometry
from repro_torch.dispatch import ExecutionPlan

JG = JGeometry().scaled(16, n_proj=7)
G = Geometry().scaled(16, n_proj=7)
FILT = np.asarray(jfilt.filter_projections(jph.forward_project(JG), JG))
MATS = j_mats(JG)

# A detector smaller than the volume's footprint: every strategy meets
# taps that straddle the detector edge (the strategy-sweep geometry).
JBORDER = JGeometry().scaled(16, n_proj=8, n_u=24, n_v=18)
BORDER = Geometry().scaled(16, n_proj=8, n_u=24, n_v=18)

OPTS = {
    "gather": {},
    "onehot": {"vox_block": 64},
    "strip": {"chunk": 8, "band": 16, "width": 128},
    "strip2": {"group": 8, "gband": 8, "gwidth": 64},
}
STRATS = list(OPTS)


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _volume(seed=0, shape=(16, 16, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("strategy", STRATS)
@pytest.mark.parametrize("seed", range(3))
def test_sampler_matches_reference_on_border_rays(strategy, seed):
    rng = np.random.default_rng(seed)
    theta = float(rng.uniform(0.0, 2.0 * np.pi))
    z = int(rng.integers(0, 16))
    image = rng.standard_normal((18, 24)).astype(np.float32)
    A = j_matrix(JBORDER, theta).astype(np.float32)
    jgs, tgs = jbp.GeomStatic.of(JBORDER), tbp.GeomStatic.of(BORDER)
    ix, iy, _ = jbp.plane_coords(jnp.asarray(A), jgs, jnp.int32(z))
    ref = np.asarray(jbp._sample(strategy, jnp.asarray(image),
                                 jbp._pad_image(jnp.asarray(image)), ix, iy,
                                 jgs, OPTS[strategy]))
    tix, tiy, _ = tbp.plane_coords(torch.tensor(A), tgs, z)
    timg = torch.tensor(image)
    out = tbp._sample(strategy, timg, tbp._pad_image(timg), tix, tiy, tgs,
                      OPTS[strategy]).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))
    oracle = tbp.sample_scalar(timg, tix, tiy, tgs).numpy()
    np.testing.assert_allclose(out, oracle, rtol=0, atol=_tol(oracle))


@pytest.mark.parametrize("strategy", STRATS)
@pytest.mark.parametrize("pbatch", [3, 4])
def test_backproject_batch_matches_reference(strategy, pbatch):
    vol = _volume(pbatch)
    ref = np.asarray(jbp.backproject_batch(vol, FILT, MATS, JG,
                                           strategy=strategy, pbatch=pbatch,
                                           **OPTS[strategy]))
    out = tbp.backproject_batch(torch.tensor(vol), FILT, MATS, G,
                                strategy=strategy, pbatch=pbatch,
                                **OPTS[strategy]).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("strategy", STRATS)
def test_fold_projections_slab_matches_reference(strategy):
    slab = _volume(9, (5, 16, 16))
    ref = np.asarray(jbp.fold_projections(slab, FILT[:5], MATS[:5], JG,
                                          strategy=strategy, pbatch=2, z0=6,
                                          **OPTS[strategy]))
    out = tbp.fold_projections(torch.tensor(slab), FILT[:5], MATS[:5], G,
                               strategy=strategy, pbatch=2, z0=6,
                               **OPTS[strategy]).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("strategy", STRATS)
def test_reconstruct_matches_reference(strategy):
    ref = np.asarray(jbp.reconstruct(FILT, MATS, JG, strategy=strategy,
                                     pbatch=4, **OPTS[strategy]))
    out = tbp.reconstruct(FILT, MATS, G, strategy=strategy, pbatch=4,
                          device="cpu", **OPTS[strategy]).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("strategy", ["scalar"] + STRATS)
def test_backproject_one_matches_reference(strategy):
    vol = _volume(11)
    ref = np.asarray(jbp.backproject_one(vol, FILT[3], MATS[3], JG,
                                         strategy=strategy,
                                         **OPTS.get(strategy, {})))
    out = tbp.backproject_one(torch.tensor(vol), FILT[3], MATS[3], G,
                              strategy=strategy,
                              **OPTS.get(strategy, {})).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


def test_default_strip_windows_match_reference():
    """strip/strip2 at their default windows (the reference's)."""
    for strategy in ("strip", "strip2"):
        ref = np.asarray(jbp.reconstruct(FILT, MATS, JG, strategy=strategy))
        out = tbp.reconstruct(FILT, MATS, G, strategy=strategy,
                              device="cpu").numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("strategy,opts", [
    ("strip2", {"gband": 2, "gwidth": 64}),
    ("strip2", {"gband": 8, "gwidth": 3}),
    ("strip", {"chunk": 16, "band": 3, "width": 128}),
])
def test_undersized_window_raises_with_reference_sizes(strategy, opts):
    with pytest.raises(ValueError) as want:
        jbp.validate_strip_opts(JG, MATS, strategy, opts)
    with pytest.raises(ValueError) as got:
        tbp.validate_strip_opts(G, MATS, strategy, opts)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="need at least"):
        tbp.reconstruct(FILT, MATS, G, strategy=strategy, device="cpu",
                        **opts)
    # validate=False skips the check (the caller checked before).
    tbp.reconstruct(FILT[:1], MATS[:1], G, strategy=strategy, device="cpu",
                    validate=False, **opts)


def test_engine_validates_windows_per_chunk():
    from repro_torch.streaming import ProjectionChunk, ReconstructionEngine

    eng = ReconstructionEngine(G, n_slots=1, strategy="strip2", gband=2,
                               device="cpu")
    sid = eng.begin_scan(n_proj=2)
    with pytest.raises(ValueError, match="need at least"):
        eng.submit(sid, ProjectionChunk(np.zeros((2, G.n_v, G.n_u)),
                                        MATS[:2], np.arange(2)))
    off = ReconstructionEngine(G, n_slots=1, strategy="strip2", gband=2,
                               validate=False, device="cpu")
    sid = off.begin_scan(n_proj=2)
    off.submit(sid, ProjectionChunk(np.zeros((2, G.n_v, G.n_u)), MATS[:2],
                                    np.arange(2)))
    assert off.scans[sid].done


@pytest.mark.parametrize("strategy,opts", [
    ("strip2", {"gband": 2, "gwidth": 64}),
    ("strip", {"chunk": 16, "band": 3, "width": 128}),
])
def test_windows_checked_only_where_they_are_read(strategy, opts):
    """The host window check runs for a CPU fold and not for a CUDA one
    (the kernel reads taps directly); no card is needed to ask."""
    plan = ExecutionPlan.explicit(strategy, opts)
    with pytest.raises(ValueError, match="need at least"):
        tbp.check_windows(G, MATS, plan, "cpu")
    tbp.check_windows(G, MATS, plan, "cuda")
    tbp.check_windows(G, MATS, plan, torch.device("cuda", 0))


@pytest.mark.parametrize("strategy,opts,match", [
    ("strip2", {"ty": 8}, "unknown option"),
    ("strip2", {"gband": 8, "vox_block": 4}, "do not apply"),
    ("scalar", {"group": 8}, "do not apply"),
    ("strip2", {"chunk": 8}, "do not apply"),
    ("onehot", {"strip_dtype": "int8"}, "do not apply"),
    ("strip", {"strip_dtype": "fp8"}, "strip_dtype"),
    # "auto" is the dispatcher's to resolve (the ids stay).
    pytest.param("auto", {}, "Dispatcher", id="auto-opts6-not ported"),
    pytest.param("auto", {"group": 8}, "Dispatcher",
                 id="auto-opts7-not ported"),
    ("nearest", {}, "unknown strategy"),
])
def test_explicit_plan_raises(strategy, opts, match):
    with pytest.raises(ValueError, match=match):
        ExecutionPlan.explicit(strategy, opts)


@pytest.mark.parametrize("strategy,opts,match", [
    ("strip2", {"ty": 8}, "unknown option"),
    ("strip2", {"chunk": 8}, "do not apply"),
    ("gather", {"vox_block": 8}, "do not apply"),
])
def test_filter_strategy_opts_always_raises(strategy, opts, match):
    """Every strategy is named explicitly in the port: an option the
    strategy does not take raises as an unknown one does, and accepted
    options pass through unchanged."""
    from repro_torch.tune import filter_strategy_opts

    with pytest.raises(ValueError, match=match):
        filter_strategy_opts(strategy, opts)
    assert filter_strategy_opts("strip2", {"group": 8}) == {"group": 8}


@pytest.mark.parametrize("strategy,opts,pbatch", [
    ("strip2", {"strip_dtype": "int8", "gband": 8}, 4),
    ("strip", {"chunk": 8, "pbatch": 3}, None),
    ("onehot", {"vox_block": 64}, 2),
    ("scalar", {}, None),
])
def test_plan_matches_reference_and_round_trips(strategy, opts, pbatch):
    ref = JPlan.explicit(strategy, dict(opts), pbatch)
    plan = ExecutionPlan.explicit(strategy, dict(opts), pbatch)
    ref_fields = ref.as_dict()
    assert ref_fields["pallas"] is None and not ref_fields["use_pallas"]
    assert plan.as_dict() == ref_fields
    assert plan.label == ref.label
    assert convert.plan_from_reference(ref.as_dict()) == plan
    assert hash(plan) == hash(ExecutionPlan.explicit(strategy, dict(opts),
                                                     pbatch))


def test_tuned_reference_plan_is_not_carried():
    """A tuned reference plan is carried with its kernel config, field
    for field; one whose kernel config names a key the
    port's kernels do not take is not carried, and raises."""
    fields = JPlan.explicit("strip2").as_dict()
    fields.update(pallas={"ty": 8, "double_buffer": True}, use_pallas=True)
    plan = convert.plan_from_reference(fields)
    assert plan.as_dict() == fields and plan.use_pallas
    fields.update(pallas={"ty": 8, "lanes": 128})
    with pytest.raises(ValueError, match="lanes"):
        convert.plan_from_reference(fields)


def test_plan_drives_reconstruct_and_fold():
    plan = ExecutionPlan.explicit("strip2", {"strip_dtype": "int8"}, 3)
    a = tbp.reconstruct(FILT, MATS, G, plan=plan, device="cpu")
    b = tbp.reconstruct(FILT, MATS, G, strategy="strip2", pbatch=3,
                        strip_dtype="int8", device="cpu")
    assert torch.equal(a, b)
    c = tbp.fold_projections(torch.zeros(16, 16, 16), FILT, MATS, G,
                             plan=plan)
    assert torch.equal(a, c)
