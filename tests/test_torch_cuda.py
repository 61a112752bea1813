"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a CUDA card and no JAX (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips with a reason.  Tolerance for the back
projection: 1e-5·max(1, max|ref|), as ``chip_smoke.py`` (the kernels
write every float operation with round-to-nearest intrinsics in the
plain version's order, so they agree bitwise in practice).  The row
encoder is held bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.backproject import GeomStatic
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry, projection_matrices
from repro_torch.core.phantom import forward_project
from repro_torch.kernels import LAUNCHES, backproject_batch
from repro_torch.kernels.backproject_ref import backproject_batch_ref
from repro_torch.quant import quantize_rows, quantize_rows_ref
from repro_torch.streaming import ProjectionChunk, ReconstructionEngine

pytestmark = pytest.mark.cuda

G = Geometry().scaled(16, n_proj=8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(ref: torch.Tensor) -> float:
    return 1e-5 * max(1.0, float(ref.abs().max()))


def _filtered(device):
    raw = forward_project(G, device=device)
    return raw, filter_projections(raw, G, device=device)


@pytest.mark.parametrize("symmetric", [False, True])
def test_row_encoder_equals_plain_bitwise(dev, symmetric):
    rng = np.random.default_rng(12)
    x = torch.tensor((rng.standard_normal((2, 40, 300)) * 3).astype(
        np.float32), device=dev)
    x[0, 3] = 0.0
    x[1, 7] = 2.5
    before = LAUNCHES["quantize_rows"]
    got = quantize_rows(x, symmetric=symmetric)
    torch.cuda.synchronize()
    assert LAUNCHES["quantize_rows"] == before + 1
    want = quantize_rows_ref(x, symmetric=symmetric)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_backprojection_equals_plain_on_each_wire(dev, wire):
    _, imgs = _filtered(dev)
    mats = torch.tensor(projection_matrices(G), dtype=torch.float32,
                        device=dev)
    vol = torch.tensor(np.random.default_rng(5).standard_normal(
        (16, 16, 16)).astype(np.float32), device=dev)
    want = vol.clone()
    gs = GeomStatic.of(G)
    backproject_batch_ref(want, imgs[:5], mats[:5], gs, wire=wire)
    backproject_batch_ref(want, imgs[5:], mats[5:], gs, wire=wire)
    got = backproject_batch(vol, imgs, mats, G, pbatch=5, strip_dtype=wire)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=_tol(want))


def test_engine_int8_wire_launches_once_per_fold(dev):
    """strip2 on the int8 wire: one encode and one int8 launch per fold,
    and the same volume as the CPU engine to 1e-4·max|v| (the CPU runs
    the one-hot windows, the card reads taps directly)."""
    raw, _ = _filtered(dev)
    mats = projection_matrices(G)
    vols = {}
    for device in ("cpu", dev):
        eng = ReconstructionEngine(G, n_slots=1, pbatch=3, strategy="strip2",
                                   strip_dtype="int8", device=device)
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        sid = eng.begin_scan()
        eng.submit(sid, ProjectionChunk(raw.to(device), mats,
                                        np.arange(G.n_proj)))
        eng.drain()
        vols[str(device)] = eng.result(sid).cpu()
        folds = eng.stats["fold_launches"]
    assert folds == 3
    assert LAUNCHES["backproject_int8"] == folds == LAUNCHES["quantize_rows"]
    assert LAUNCHES["backproject"] == 0
    want = vols["cpu"]
    torch.testing.assert_close(vols[str(dev)], want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
