"""The projection wire (``strip_dtype``) of the port, against the JAX
package on the CPU (mirrors ``tests/test_strip_dtype.py``).

* ``"float32"`` is **bitwise** the path without the option.
* Each narrow wire changes the volume (the conversion is real) and stays
  inside the reference's envelope: ``"bfloat16"`` ROI PSNR against the
  float32 volume above 40 dB and a phantom-PSNR drop under 0.5 dB;
  ``"int8"`` above 35 dB and a drop under 1.0 dB.
* The port's narrow-wire volumes equal the reference's jnp ``strip``/
  ``strip2`` volumes on the same wire within 1e-5·max(1, max|ref|): the
  int8 codes are bitwise equal, so only summation order differs.
* Unknown dtypes raise at every layer, and a pre-encoded ``RowQuant``
  on a non-int8 sampler raises ``TypeError``.
"""

import asyncio

import numpy as np
import pytest
import torch

import repro.core.backproject as jbp
import repro.streaming as jstream
from repro.core import filtering as jfilt
from repro.core.geometry import Geometry as JGeometry
from repro.core.phantom import make_dataset
from repro.kernels.backproject_ops import pallas_backproject_batch
from repro_torch.api import CTFrontDoor, ProjectionChunk
from repro_torch.core import backproject as tbp
from repro_torch.core.geometry import Geometry
from repro_torch.core.quality import psnr, roi_mask
from repro_torch.dispatch import ExecutionPlan
from repro_torch.kernels import LAUNCHES, backproject_batch
from repro_torch.quant import quantize_rows
from repro_torch.streaming import ReconstructionEngine

JG = JGeometry().scaled(16, n_proj=8)
G = Geometry().scaled(16, n_proj=8)
PROJS, MATS, PHANTOM = (np.asarray(a) for a in make_dataset(JG))
FILT = np.asarray(jfilt.filter_projections(PROJS, JG))

# (dtype, min ROI PSNR vs the f32 volume, max phantom-PSNR drop)
WIRES = [("bfloat16", 40.0, 0.5), ("int8", 35.0, 1.0)]


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _rec(strategy, **opts):
    return tbp.reconstruct(FILT, MATS, G, strategy=strategy, device="cpu",
                           **opts)


@pytest.mark.parametrize("strategy", ["strip", "strip2"])
def test_f32_wire_is_bitwise_unchanged(strategy):
    assert torch.equal(_rec(strategy), _rec(strategy, strip_dtype="float32"))


@pytest.mark.parametrize("dtype,psnr_min,drop_max", WIRES)
@pytest.mark.parametrize("strategy", ["strip", "strip2"])
def test_narrow_wire_differs_but_bounded(strategy, dtype, psnr_min,
                                         drop_max):
    v32, vq = _rec(strategy), _rec(strategy, strip_dtype=dtype)
    ref, mask = torch.tensor(PHANTOM), roi_mask(G.L, device="cpu")
    assert not torch.equal(vq, v32), f"{dtype} wire was a no-op"
    assert psnr(vq, v32, mask) > psnr_min
    drop = psnr(v32, ref, mask) - psnr(vq, ref, mask)
    assert abs(drop) < drop_max


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("strategy", ["strip", "strip2"])
def test_narrow_wire_matches_reference(strategy, dtype):
    want = np.asarray(jbp.reconstruct(FILT, MATS, JG, strategy=strategy,
                                      strip_dtype=dtype))
    got = _rec(strategy, strip_dtype=dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("pbatch", [3, 8])
def test_kernel_wrapper_wire_matches_jnp_strip2(dtype, pbatch):
    """The wrapper's CPU path (the kernel's plain version) reads taps
    straight from the 1-pixel-bordered wire stack: it computes what the
    reference's jnp strip2 computes on that wire."""
    want = np.asarray(jbp.reconstruct(FILT, MATS, JG, strategy="strip2",
                                      strip_dtype=dtype, pbatch=pbatch))
    vol = torch.zeros(16, 16, 16)
    got = backproject_batch(vol, torch.tensor(FILT), MATS, G, pbatch=pbatch,
                            strip_dtype=dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kernel_wrapper_wire_against_pallas_interpret(dtype):
    """Against the Pallas batch kernel on the same wire.  bf16 agrees to
    1e-5·max(1, max|ref|).  On int8 the Pallas wrapper pads the image
    further (rows to 32, columns to 128) before encoding, and its taps
    past the 1-pixel border decode the residual-carrying codes of those
    round-up pixels, where the port reads 0.  So the two agree to
    1e-5·max(1, max|ref|) on every voxel none of whose taps leaves the
    bordered buffer on the high side, and elsewhere to within
    5e-3·max(1, max|ref|) (measured: 4.2e-3 at max|ref| 1.79)."""
    vol = np.zeros((16, 16, 16), np.float32)
    want = np.asarray(pallas_backproject_batch(vol, FILT, MATS, JG,
                                               pbatch=4, strip_dtype=dtype,
                                               interpret=True))
    got = backproject_batch(torch.tensor(vol), torch.tensor(FILT), MATS, G,
                            pbatch=4, strip_dtype=dtype).numpy()
    gs = tbp.GeomStatic.of(G)
    ix, iy, _ = tbp.plane_coords(torch.tensor(MATS), gs,
                                 torch.arange(G.L))
    past = ((torch.floor(ix) + 2 >= G.n_u + 2)
            | (torch.floor(iy) + 2 >= G.n_v + 2)).any(dim=0).numpy()
    assert past.any() and not past.all()
    tol = _tol(want)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        return
    np.testing.assert_allclose(got[~past], want[~past], rtol=0, atol=tol)
    assert float(np.abs(got - want).max()) <= 500 * tol


def test_unknown_strip_dtype_raises_at_every_layer():
    vol = torch.zeros(16, 16, 16)
    calls = {
        "plan": lambda: ExecutionPlan.explicit("strip2",
                                               {"strip_dtype": "fp16"}),
        "reconstruct": lambda: _rec("strip2", strip_dtype="float16"),
        "fold": lambda: tbp.fold_projections(vol, FILT, MATS, G,
                                             strategy="strip",
                                             strip_dtype="int4"),
        "engine": lambda: ReconstructionEngine(G, strategy="strip2",
                                               strip_dtype="int4",
                                               device="cpu"),
        "kernel": lambda: backproject_batch(vol, torch.tensor(FILT), MATS,
                                            G, strip_dtype="uint8"),
        "front door": lambda: CTFrontDoor(G, n_slots=1, strategy="strip2",
                                          strip_dtype="f32", device="cpu"),
        "table": lambda: tbp.strip_wire_dtype("f32"),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="strip_dtype"):
            call()
    assert tbp.strip_wire_dtype("float32") is None
    assert tbp.strip_wire_dtype("bfloat16") is torch.bfloat16
    assert tbp.strip_wire_dtype("int8") is torch.int8
    assert set(tbp._STRIP_WIRE_DTYPES) == set(jbp._STRIP_WIRE_DTYPES)


@pytest.mark.parametrize("sampler", [tbp.sample_strip, tbp.sample_strip2])
def test_rowquant_image_requires_int8(sampler):
    rq = quantize_rows(torch.ones(16, 128))
    gs = tbp.GeomStatic.of(G)
    ixy = torch.zeros(16, 16)
    for dtype in ("float32", "bfloat16"):
        with pytest.raises(TypeError, match="RowQuant"):
            sampler(rq, ixy, ixy, gs, strip_dtype=dtype)


def test_preencoded_rowquant_equals_encode_in_sampler():
    img = torch.tensor(np.pad(FILT[2], 1))
    gs = tbp.GeomStatic.of(G)
    ix, iy, _ = tbp.plane_coords(torch.tensor(MATS[2]), gs, 5)
    a = tbp.sample_strip2(quantize_rows(img), ix, iy, gs, strip_dtype="int8")
    b = tbp.sample_strip2(img, ix, iy, gs, strip_dtype="int8")
    assert torch.equal(a, b)


def _shuffled(seed, sizes):
    order = np.random.default_rng(seed).permutation(G.n_proj)
    out, c0 = [], 0
    for k in sizes:
        idx = np.sort(order[c0:c0 + k])
        out.append((PROJS[idx], MATS[idx], idx))
        c0 += k
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_engine_matches_reference_engine(dtype):
    """strip2 on each wire, shuffled chunks, both engines given the same
    chunks.  1e-4·max|v|: the engines fold in arrival order, the
    reference zero-pads its remainder batch."""
    jeng = jstream.ReconstructionEngine(JG, n_slots=2, strategy="strip2",
                                        pbatch=4, strip_dtype=dtype)
    teng = ReconstructionEngine(G, n_slots=2, strategy="strip2", pbatch=4,
                                strip_dtype=dtype, device="cpu")
    assert teng.exec_plan == ExecutionPlan.explicit(
        "strip2", {"strip_dtype": dtype}, 4)
    jsid, tsid = jeng.begin_scan(), teng.begin_scan()
    for projs, mats, idx in _shuffled(4, (3, 1, 4)):
        jeng.submit(jsid, jstream.ProjectionChunk(projs, mats, idx))
        teng.submit(tsid, ProjectionChunk(torch.tensor(projs), mats, idx))
    jeng.drain()
    teng.drain()
    want = np.asarray(jeng.result(jsid))
    got = teng.result(tsid).numpy()
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_front_door_forwards_engine_options():
    fd = CTFrontDoor(G, n_slots=1, pbatch=3, strategy="strip2",
                     strip_dtype="int8", gband=8, gwidth=64, validate=False,
                     device="cpu")
    eng = fd._backend.engine
    assert eng.exec_plan == ExecutionPlan.explicit(
        "strip2", {"strip_dtype": "int8", "gband": 8, "gwidth": 64}, 3)
    assert eng.validate is False and eng.pbatch == 3

    async def one_scan():
        ticket = await fd.open_scan(tenant="a", n_proj=G.n_proj)
        for projs, mats, idx in _shuffled(2, (5, 3)):
            await fd.submit(ticket, ProjectionChunk(projs, mats, idx))
        return await fd.result(ticket)

    got = asyncio.run(one_scan()).numpy()
    eng2 = ReconstructionEngine(G, n_slots=1, pbatch=3, strategy="strip2",
                                strip_dtype="int8", device="cpu")
    sid = eng2.begin_scan()
    for projs, mats, idx in _shuffled(2, (5, 3)):
        eng2.submit(sid, ProjectionChunk(projs, mats, idx))
    eng2.drain()
    assert np.array_equal(got, eng2.result(sid).numpy())


def test_cpu_wire_paths_launch_no_kernel():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    backproject_batch(torch.zeros(16, 16, 16), torch.tensor(FILT), MATS, G,
                      strip_dtype="int8")
    _rec("strip2", strip_dtype="int8")
    assert set(LAUNCHES.values()) == {0}



@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_plain_version_on_a_stack_already_on_the_wire(dtype):
    """The kernel's plain version, given the stack the wrapper puts on
    the wire (bf16 values, or int8 codes with their (P, 2, rows) block),
    equals the plain version that encodes the images itself, bitwise."""
    from repro_torch.kernels.backproject_ref import (backproject_batch_ref,
                                                     backproject_padded_ref,
                                                     decode_wire)

    gs = tbp.GeomStatic.of(G)
    imgs = torch.tensor(FILT[:5])
    padded = tbp._pad_image(imgs)
    if dtype == "int8":
        rq = quantize_rows(padded)
        values = decode_wire(rq.codes, rq.scales())
    else:
        values = decode_wire(padded.to(torch.bfloat16))
    vol = torch.tensor(np.random.default_rng(4).standard_normal(
        (16, 16, 16)).astype(np.float32))
    want = backproject_batch_ref(vol.clone(), imgs, MATS[:5], gs, wire=dtype)
    got = backproject_padded_ref(vol.clone(), values,
                                 torch.tensor(MATS[:5]), gs)
    assert torch.equal(got, want)
