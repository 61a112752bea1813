"""The port's back projection against the JAX package (CPU).

The port's plain path (``scalar``, and the kernel wrapper's CPU path,
which runs ``backproject_ref``) is held against
``repro.core.backproject`` (``strategy="scalar"``) and against the Pallas
batch kernel run as the JAX tests run it on a CPU (``interpret=True``),
on the same numpy inputs made from a seed.

Tolerance: atol 1e-5·max(1, max|ref|).  Both sides compute Listing-1
semantics in float32; they differ only in summation order (the Pallas
kernel blends vertically first and folds projection by projection, the
jnp nest sums a batch before adding it) and in XLA's fusion.
"""

import numpy as np
import pytest
import torch

import repro.core.backproject as jbp
import repro.core.filtering as jfilt
import repro.core.phantom as jph
from repro.core.geometry import Geometry as JGeometry
from repro.core.geometry import projection_matrices as j_mats
from repro.kernels.backproject_ops import (pallas_backproject_batch,
                                           pallas_backproject_one)
from repro_torch import convert
from repro_torch.core import backproject as tbp
from repro_torch.core.geometry import Geometry
from repro_torch.kernels import LAUNCHES, backproject_batch, backproject_one
from repro_torch.kernels.backproject_ref import backproject_batch_ref

JG = JGeometry().scaled(16, n_proj=6)
G = Geometry().scaled(16, n_proj=6)
FILT = np.asarray(jfilt.filter_projections(jph.forward_project(JG), JG))
MATS = j_mats(JG)


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _volume(seed=0, shape=(16, 16, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _off_detector(mats):
    """Shift every matrix by 0.4·n_u pixels along u: a band of voxels now
    projects past the detector's right edge, so taps fall off it (and
    onto the zero border) on every projection."""
    m = np.array(mats, np.float64)
    m[:, 0, :] += 0.4 * G.n_u * m[:, 2, :]
    return m.astype(np.float32)


@pytest.mark.parametrize("pbatch", [1, 3, 4])
@pytest.mark.parametrize("off", [False, True])
def test_scalar_batch_matches_reference(pbatch, off):
    mats = _off_detector(MATS) if off else MATS
    vol = _volume(pbatch)
    ref = np.asarray(jbp.backproject_batch(vol, FILT, mats, JG,
                                           strategy="scalar",
                                           pbatch=pbatch))
    out = tbp.backproject_batch(torch.tensor(vol), FILT, mats, G,
                                pbatch=pbatch).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))
    # The kernel wrapper's CPU path (the plain version) agrees too.
    out2 = backproject_batch(torch.tensor(vol), torch.tensor(FILT), mats,
                             G, pbatch=pbatch).numpy()
    np.testing.assert_allclose(out2, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("z0", [0, 5, 11])
def test_fold_projections_slab_matches_reference(z0):
    slab = _volume(z0, (5, 16, 16))
    ref = np.asarray(jbp.fold_projections(slab, FILT[:5], MATS[:5], JG,
                                          strategy="scalar", pbatch=4,
                                          z0=z0))
    out = tbp.fold_projections(torch.tensor(slab), FILT[:5], MATS[:5], G,
                               pbatch=4, z0=z0).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))
    out2 = backproject_batch(torch.tensor(slab), torch.tensor(FILT[:5]),
                             MATS[:5], G, pbatch=4, z0=z0).numpy()
    np.testing.assert_allclose(out2, ref, rtol=0, atol=_tol(ref))


def test_fold_is_in_place_and_slabs_compose():
    """The volume is updated in place, and folding two z-slabs with their
    ``z0`` gives the whole-volume fold bitwise (planes are independent)."""
    vol = torch.tensor(_volume(3))
    assert tbp.backproject_batch(vol, FILT, MATS, G) is vol
    slabs = torch.tensor(_volume(3))
    tbp.fold_projections(slabs[:7], FILT, MATS, G, z0=0)
    tbp.fold_projections(slabs[7:], FILT, MATS, G, z0=7)
    assert torch.equal(slabs, vol)


@pytest.mark.parametrize("pbatch,off", [(3, False), (4, True)])
def test_kernel_wrapper_matches_pallas_interpret(pbatch, off):
    mats = _off_detector(MATS) if off else MATS
    vol = _volume(10 + pbatch)
    ref = np.asarray(pallas_backproject_batch(vol, FILT, mats, JG,
                                              pbatch=pbatch,
                                              interpret=True))
    out = backproject_batch(torch.tensor(vol), torch.tensor(FILT), mats, G,
                            pbatch=pbatch).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


def test_backproject_one_matches_pallas_interpret():
    vol = _volume(20)
    ref = np.asarray(pallas_backproject_one(vol, FILT[2], MATS[2], JG,
                                            interpret=True))
    out = backproject_one(torch.tensor(vol), torch.tensor(FILT[2]),
                          MATS[2], G).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


def test_reconstruct_matches_reference():
    ref = np.asarray(jbp.reconstruct(FILT, MATS, JG, strategy="scalar",
                                     pbatch=4))
    out = tbp.reconstruct(FILT, MATS, G, pbatch=4, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


def test_reconstruct_matches_reference_at_L32():
    jg = JGeometry().scaled(32, n_proj=8)
    g = Geometry().scaled(32, n_proj=8)
    filt = np.asarray(jfilt.filter_projections(jph.forward_project(jg), jg))
    mats = j_mats(jg)
    ref = np.asarray(jbp.reconstruct(filt, mats, jg, strategy="scalar",
                                     pbatch=3))
    out = tbp.reconstruct(torch.tensor(filt), mats, g, pbatch=3,
                          device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))
    vol = torch.zeros(32, 32, 32)
    backproject_batch(vol, torch.tensor(filt), mats, g, pbatch=3)
    np.testing.assert_allclose(vol.numpy(), ref, rtol=0, atol=_tol(ref))


def test_volume_carried_from_reference_continues_the_fold():
    """A half-folded reference volume handed over as numpy
    (``convert.tensor_from_reference``) finishes in the port as it would
    in the reference."""
    vol = _volume(6)
    half = np.asarray(jbp.fold_projections(vol, FILT[:3], MATS[:3], JG,
                                           strategy="scalar"))
    want = np.asarray(jbp.fold_projections(half, FILT[3:], MATS[3:], JG,
                                           strategy="scalar"))
    carried = convert.tensor_from_reference(half, device="cpu")
    got = tbp.fold_projections(carried, FILT[3:], MATS[3:], G).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def test_plain_ref_accumulates_in_projection_order():
    """The plain version adds each projection to the volume in order, as
    the CUDA kernel does: it equals P single-projection passes bitwise."""
    vol = torch.tensor(_volume(4))
    seq = vol.clone()
    backproject_batch_ref(vol, torch.tensor(FILT), torch.tensor(MATS),
                          tbp.GeomStatic.of(G))
    for p in range(G.n_proj):
        backproject_batch_ref(seq, torch.tensor(FILT[p:p + 1]),
                              torch.tensor(MATS[p:p + 1]),
                              tbp.GeomStatic.of(G))
    assert torch.equal(vol, seq)


def test_cpu_path_launches_no_kernel():
    LAUNCHES["backproject"] = 0
    backproject_batch(torch.zeros(16, 16, 16), torch.tensor(FILT), MATS, G)
    assert LAUNCHES["backproject"] == 0


# The ids of the slice-1 cases stay: "strip2" and "gather" are ported
# now, so those cases hold what each still refuses; "auto" is resolved
# by the dispatcher, not by the explicit fold, which names it so.
@pytest.mark.parametrize("strategy,opts,match", [
    pytest.param("strip2", {"ty": 8}, "unknown option", id="strip2"),
    pytest.param("gather", {"strip_dtype": "int8"}, "do not apply",
                 id="gather"),
    pytest.param("auto", {}, "Dispatcher", id="auto"),
    pytest.param("bogus", {}, "unknown strategy", id="bogus"),
    pytest.param("auto", {"strip_dtype": "int8"}, "Dispatcher",
                 id="auto-with-opts"),
])
def test_unported_strategy_raises(strategy, opts, match):
    with pytest.raises(ValueError, match=match):
        tbp.backproject_batch(torch.zeros(16, 16, 16), FILT, MATS, G,
                              strategy=strategy, **opts)


# The wire (strip_dtype) and the tiling keywords (their Hopper meaning:
# the tile and strip, K3/K4/K5's flags) are ported: every case now runs
# on the CPU.  The windows of this geometry cover every tap, so
# each equals row 1's plain version on its wire bitwise.
@pytest.mark.parametrize("opt", [
    pytest.param({"ty": 8}, id="opt0"),
    pytest.param({"chunk": 64}, id="opt1"),
    pytest.param({"band": 16}, id="opt2"),
    pytest.param({"width": 512}, id="opt3"),
    pytest.param({"double_buffer": True}, id="opt4"),
    pytest.param({"micro": True}, id="opt5"),
    pytest.param({"shared_window": True}, id="opt6"),
    pytest.param({"strip_dtype": "int8"}, id="opt7"),
    pytest.param({"strip_dtype": "bfloat16"}, id="opt8"),
])
def test_tpu_tiling_options_raise(opt):
    vol = torch.tensor(_volume(7))
    want = backproject_batch_ref(vol.clone(), torch.tensor(FILT),
                                 torch.tensor(MATS), tbp.GeomStatic.of(G),
                                 wire=opt.get("strip_dtype", "float32"))
    out = backproject_batch(vol, torch.tensor(FILT), MATS, G, pbatch=6,
                            **opt)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    vol = torch.tensor(_volume(5), device=dev)
    imgs = torch.tensor(FILT, device=dev)
    ref = backproject_batch_ref(vol.clone(), imgs, torch.tensor(
        MATS, device=dev), tbp.GeomStatic.of(G))
    out = backproject_batch(vol, imgs, MATS, G, pbatch=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=_tol(ref.cpu().numpy()))
