"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a CUDA card and no JAX (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips with a reason.  The back projection
(row 1 on every wire) is held to its plain version exactly, rtol = atol
= 0, as in ``chip_smoke.py``: the kernel writes every float operation
with round-to-nearest intrinsics in the plain version's order.  The row
encoder and the row gather are held bitwise (the gather to
``F.embedding`` too, on in-range ids).  The sLSTM recurrence is held to
its plain version at rtol = atol = 2e-4, the reference's own kernel
tolerance (``tests/test_kernel_slstm.py``): its gate functions come from
the special-function unit, not bitwise PyTorch's.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.backproject import GeomStatic
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry, projection_matrices
from repro_torch.core.phantom import forward_project
from _row1_cases import hard_rows, odd_problem
from repro_torch.kernels import LAUNCHES, backproject_batch
from repro_torch.kernels.backproject_ref import backproject_batch_ref
from repro_torch.kernels.slstm import BWD_CHUNK, BWD_WARPS
from repro_torch.quant import quantize_rows, quantize_rows_ref
from repro_torch.streaming import ProjectionChunk, ReconstructionEngine

pytestmark = pytest.mark.cuda

G = Geometry().scaled(16, n_proj=8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


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


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("shape", [(3, 37, 131), (1, 5, 1), (2, 33, 64),
                                   (1, 1, 1250)])
def test_row_encoder_bitwise_off_its_tiles(dev, symmetric, shape):
    """Rows and columns off the encoder's 32-row block and 64-column
    tile; zero, constant and one-signed rows, and rows whose quotients
    lie within a few ulps of a half-integer, in both modes."""
    P, rows, cols = shape
    x = hard_rows(21 + cols, P=P, rows=rows, cols=cols, symmetric=symmetric)
    got = quantize_rows(torch.tensor(x, device=dev), symmetric=symmetric)
    torch.cuda.synchronize()
    want = quantize_rows_ref(torch.tensor(x), symmetric=symmetric)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


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
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_row1_equals_plain_at_odd_shapes(dev, wire, P):
    """L = 37 (no multiple of the 32 x 8 block), a 13-plane slab from
    plane 5 (no multiple of the 8-voxel run), taps off the detector and a
    view with w <= 1e-6: equal to the plain version on the CPU, rtol =
    atol = 0, one launch per batch of P."""
    geom, images, mats, volume, z0 = odd_problem()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    got = backproject_batch(torch.tensor(volume, device=dev),
                            torch.tensor(images, device=dev),
                            torch.tensor(mats, device=dev), geom, pbatch=P,
                            z0=z0, strip_dtype=wire)
    torch.cuda.synchronize()
    suffix = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[wire]
    assert LAUNCHES["backproject" + suffix] == -(-len(images) // P)
    want = backproject_batch_ref(torch.tensor(volume), torch.tensor(images),
                                 torch.tensor(mats), GeomStatic.of(geom),
                                 z0=z0, wire=wire)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_sharded_identity_mesh_on_the_card_equals_the_cpu(dev):
    """A 1x1 mesh on the card (a single-process NCCL group): with
    prefiltered images bitwise the card's one-shot fold, and with raw
    ones (filtered in the shard) within 1e-5 * max(1, max|v|) of the CPU
    (cuFFT against the host FFT, then row 1 against the strip2 sampler);
    row 1 launched once per batch of 4 each time."""
    import torch.distributed as dist

    from repro_torch.core.backproject import reconstruct
    from repro_torch.core.pipeline import sharded_reconstruct
    from repro_torch.launch.mesh import make_local_mesh

    raw, filt = _filtered(dev)
    mats = projection_matrices(G)
    mesh = make_local_mesh(1, 1, device=dev)
    try:
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        pre = sharded_reconstruct(filt, mats, G, mesh, device=dev)
        out = sharded_reconstruct(raw, mats, G, mesh, prefiltered=False,
                                  device=dev).full_tensor()
        torch.cuda.synchronize()
        launches = LAUNCHES["backproject"]
        assert torch.equal(pre.to_local(), reconstruct(filt, mats, G,
                                                       strategy="strip2",
                                                       device=dev))
    finally:
        dist.destroy_process_group()
    assert launches == 2 * -(-G.n_proj // 4)
    raw_cpu = raw.cpu()
    want = reconstruct(filter_projections(raw_cpu, G, device="cpu"), mats, G,
                       strategy="strip2", device="cpu")
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((out.cpu() - want).abs().max()) <= tol
    assert float(want.abs().max()) > 0


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


def _strip_case(dev, wire):
    _, imgs = _filtered(dev)
    mats = torch.tensor(projection_matrices(G), dtype=torch.float32,
                        device=dev)
    vol = torch.tensor(np.random.default_rng(9).standard_normal(
        (16, 16, 16)).astype(np.float32), device=dev)
    return imgs, mats, vol


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("flags,key", [
    (dict(double_buffer=True, db_depth=2), "strip_db"),
    (dict(double_buffer=True, db_depth=4), "strip_db"),
    (dict(micro=True, micro_group=4, micro_band=8, micro_width=32),
     "strip_micro"),
    (dict(shared_window=True), "strip_shared"),
])
def test_strip_kernels_equal_plain(dev, wire, flags, key):
    """K3/K4/K5 against their plain versions on the CPU, bitwise (the
    same arithmetic, the same window rules), and each launched once per
    batch of the wrapper."""
    from repro_torch.kernels import backproject_ops as ops

    imgs, mats, vol = _strip_case(dev, wire)
    kw = dict(ty=8, chunk=16, band=16, width=128, pbatch=3,
              strip_dtype=wire, **flags)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    got = ops.backproject_batch(vol.clone(), imgs, mats, G, **kw)
    torch.cuda.synchronize()
    suffix = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[wire]
    assert LAUNCHES[key + suffix] == 3            # 8 views: 3 + 3 + 2
    want = ops.backproject_batch(vol.cpu(), imgs.cpu(), mats.cpu(), G,
                                 **kw)
    assert torch.equal(got.cpu(), want)


def test_strip_kernels_at_one_projection(dev):
    """Rows 7 and 8: K3 and K4 launched with P = 1 count apart."""
    from repro_torch.kernels import backproject_ops as ops

    imgs, mats, vol = _strip_case(dev, "float32")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for flags in (dict(double_buffer=True), dict(micro=True)):
        got = ops.backproject_one(vol.clone(), imgs[2], mats[2], G, ty=8,
                                  chunk=16, band=16, width=128, **flags)
        want = ops.backproject_one(vol.cpu(), imgs[2].cpu(), mats[2].cpu(),
                                   G, ty=8, chunk=16, band=16, width=128,
                                   **flags)
        assert torch.equal(got.cpu(), want)
    assert LAUNCHES["strip_db_p1"] == LAUNCHES["strip_micro_p1"] == 1


_G32 = Geometry().scaled(32, n_proj=8)


def _box_case(dev):
    """L = 32, 8 views, one of them a matrix whose w vanishes on the
    plane x = 0 (tiles there have corners at w <= eps and stage their
    whole window)."""
    mats = projection_matrices(_G32)
    mats[5, 2] = [1.0, 0.0, 0.0, 0.0]
    rng = np.random.default_rng(21)
    imgs = torch.tensor(rng.standard_normal(
        (8, _G32.n_v, _G32.n_u)).astype(np.float32), device=dev)
    vol = torch.tensor(rng.standard_normal((32,) * 3).astype(np.float32),
                       device=dev)
    return imgs, torch.tensor(mats, device=dev), vol


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("flags,key", [
    (dict(double_buffer=True, db_depth=2), "strip_db"),
    (dict(double_buffer=True, db_depth=4), "strip_db"),
    (dict(micro=True), "strip_micro"),
])
def test_strip_boxes_equal_plain_at_each_batch(dev, wire, flags, key):
    """K3 (depth 2 and 4) and K4 stage each tile's tap box cut from a
    window wider than the planner's (so the cut matters): bitwise equal
    to their plain versions at P = 1, 4 and 8 on three tiles (the last
    too narrow for a warp's lanes to share the corners), one launch per
    batch, and no box cut by its slot."""
    from repro_torch.core import clipping
    from repro_torch.kernels import backproject_ops as ops
    from repro_torch.kernels.backproject import (reset_strip_clamped,
                                                 strip_clamped)

    imgs, mats, vol = _box_case(dev)
    suffix = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[wire]
    reset_strip_clamped()
    for ty, chunk in ((1, 16), (8, 8), (1, 2)):
        nb, nw = clipping.strip_needs(_G32, mats.cpu(), chunk=chunk,
                                      ty=ty).max(axis=0)
        kw = dict(ty=ty, chunk=chunk, band=int(nb) + 8,
                  width=int(nw) + 32, strip_dtype=wire, **flags)
        if "micro" in flags:
            group = min(8, chunk)
            gb, gw = clipping.strip_needs(_G32, mats.cpu(),
                                          chunk=group).max(axis=0)
            kw.update(micro_group=group, micro_band=int(gb) + 2,
                      micro_width=int(gw) + 4)
        for P in (1, 4, 8):
            for k in LAUNCHES:
                LAUNCHES[k] = 0
            got = ops.backproject_batch(vol.clone(), imgs[:P], mats[:P],
                                        _G32, pbatch=P, **kw)
            torch.cuda.synchronize()
            assert LAUNCHES[key + suffix + ("_p1" if P == 1 else "")] == 1
            want = ops.backproject_batch(vol.cpu(), imgs[:P].cpu(),
                                         mats[:P].cpu(), _G32, pbatch=P,
                                         **kw)
            assert torch.equal(got.cpu(), want), (ty, chunk, P)
    assert strip_clamped(dev) == 0


def test_strip_clamp_counter_counts_cut_boxes(dev):
    """A slot smaller than the launch's boxes cuts them: each cut item
    is counted (the launcher takes any slot within the window)."""
    from repro_torch.kernels.backproject import (launch_strip, pitch_stack,
                                                 reset_strip_clamped,
                                                 strip_clamped)
    from repro_torch.kernels.backproject_ref import padded_dims

    imgs, mats, vol = _box_case(dev)
    gs = GeomStatic.of(_G32)
    stack = pitch_stack(torch.nn.functional.pad(imgs[:2], (1, 1, 1, 1)))
    win = dict(ty=1, chunk=16, band=16, width=128)
    pr, pc = padded_dims(gs, 16, 128, 4)
    reset_strip_clamped()
    launch_strip(vol.clone(), stack, mats[:2].contiguous(), kind="db",
                 z0=0, O=gs.O, MM=gs.MM, n_u=gs.n_u, n_v=gs.n_v,
                 pad_rows=pr, pad_cols=pc, slot=(1, 1), **win)
    assert strip_clamped(dev) > 0
    reset_strip_clamped()
    assert strip_clamped(dev) == 0


_G64 = Geometry().scaled(64, n_proj=8)


def _box_case64(dev):
    """L = 64, 8 views (one with w vanishing on the plane x = 0), for the
    tiles (1, 64) and (8, 32) that full-width runs use."""
    mats = projection_matrices(_G64)
    mats[5, 2] = [1.0, 0.0, 0.0, 0.0]
    rng = np.random.default_rng(23)
    imgs = torch.tensor(rng.standard_normal(
        (8, _G64.n_v, _G64.n_u)).astype(np.float32), device=dev)
    vol = torch.tensor(rng.standard_normal((64,) * 3).astype(np.float32),
                       device=dev)
    return imgs, torch.tensor(mats, device=dev), vol


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_shared_boxes_equal_plain_at_each_batch(dev, wire):
    """K5 stages each projection's tap box cut to the group window,
    packed per tile: bitwise equal to its plain version at tiles (1, 64)
    and (8, 32), P = 1, 4 and 8, at the planner's window and at one
    wider than it (so the cut matters), one launch per batch, and no
    box cut by its slot."""
    from repro_torch.core import clipping
    from repro_torch.kernels import backproject_ops as ops
    from repro_torch.kernels.backproject import (reset_strip_clamped,
                                                 strip_clamped)

    imgs, mats, vol = _box_case64(dev)
    suffix = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[wire]
    reset_strip_clamped()
    for ty, chunk in ((1, 64), (8, 32)):
        for P in (1, 4, 8):
            nb, nw = clipping.shared_window_cover(
                _G64, mats[:P].cpu(), ty=ty, chunk=chunk, pbatch=P)
            for pin in ({}, dict(shared_band=nb + 8, shared_width=nw + 32)):
                kw = dict(ty=ty, chunk=chunk, strip_dtype=wire,
                          shared_window=True, **pin)
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
                got = ops.backproject_batch(vol.clone(), imgs[:P], mats[:P],
                                            _G64, pbatch=P, **kw)
                torch.cuda.synchronize()
                assert LAUNCHES["strip_shared" + suffix] == 1
                want = ops.backproject_batch(vol.cpu(), imgs[:P].cpu(),
                                             mats[:P].cpu(), _G64, pbatch=P,
                                             **kw)
                assert torch.equal(got.cpu(), want), (ty, chunk, P, pin)
    assert strip_clamped(dev) == 0


def test_shared_slot_one_unit_short_counts_its_cut(dev):
    """A K5 slot one 16-byte unit smaller than the launch's largest tile
    of boxes cuts that tile's last box, and the cut is counted; the
    slot shared_box_slots gives cuts nothing."""
    from repro_torch.core import clipping
    from repro_torch.kernels.backproject import (launch_strip, pitch_stack,
                                                 reset_strip_clamped,
                                                 strip_clamped)
    from repro_torch.kernels.backproject_ref import padded_dims

    imgs, mats, vol = _box_case64(dev)
    gs = GeomStatic.of(_G64)
    stack = pitch_stack(torch.nn.functional.pad(imgs[:4], (1, 1, 1, 1)))
    band, width = clipping.shared_window_cover(_G64, mats[:4].cpu(), ty=8,
                                               chunk=32, pbatch=4)
    pr, pc = padded_dims(gs, band, width, 4)
    win = dict(ty=8, chunk=32, band=band, width=width, pad_rows=pr,
               pad_cols=pc)
    slot = int(clipping.shared_box_slots(gs, mats[:4], itemsize=4,
                                         **win)[0])
    for size, cut in ((slot, False), (slot - 1, True)):
        reset_strip_clamped()
        launch_strip(vol.clone(), stack, mats[:4].contiguous(),
                     kind="shared", z0=0, O=gs.O, MM=gs.MM, n_u=gs.n_u,
                     n_v=gs.n_v, slot=size, **win)
        assert (strip_clamped(dev) > 0) == cut
    reset_strip_clamped()


def test_planner_on_the_card_equals_the_host(dev):
    from repro_torch.core import clipping

    mats = projection_matrices(Geometry().scaled(64, n_proj=12))
    g = Geometry().scaled(64, n_proj=12)
    for chunk, ty in ((8, 1), (16, 8)):
        clipping._NEEDS.clear()
        card = clipping.strip_needs(g, mats, chunk=chunk, ty=ty, device=dev)
        clipping._NEEDS.clear()
        host = clipping.strip_needs(g, mats, chunk=chunk, ty=ty,
                                    device="cpu")
        np.testing.assert_array_equal(card, host)
    clipping._SHARED.clear()
    card = clipping.shared_window_requirement(g, mats, ty=8, chunk=16,
                                              pbatch=4, device=dev)
    clipping._SHARED.clear()
    assert card == clipping.shared_window_requirement(
        g, mats, ty=8, chunk=16, pbatch=4, device="cpu")


def test_engine_folds_through_the_tuned_kernel(dev, tmp_path, monkeypatch):
    """strategy="auto" on the card with a stored decision whose K3 beat
    the strategies: the engine resolves it, folds every batch through
    strip_db and serves the plain engine's volume to 1e-4·max|v|."""
    from repro_torch.dispatch import reset_dispatcher
    from repro_torch.tune import (TunedConfig, clear_memory_cache,
                                  device_identity, store_tuned)
    from repro_torch.core.backproject import GeomStatic as GS

    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_DISPATCH_INSITU", "0")
    clear_memory_cache()
    reset_dispatcher()
    backend, kind = device_identity()
    assert backend == "cuda" and kind == torch.cuda.get_device_name()
    store_tuned(GS.of(G), TunedConfig(
        strategy="strip2", opts={}, backend=backend, device_kind=kind,
        us_per_call=100.0, pallas={"ty": 8, "chunk": 16, "band": 16,
                                   "width": 128, "double_buffer": True,
                                   "db_depth": 3, "pbatch": 3},
        pallas_us=10.0))
    raw, _ = _filtered(dev)
    mats = projection_matrices(G)
    vols = {}
    try:
        for device in ("cpu", dev):
            eng = ReconstructionEngine(G, n_slots=1, strategy="auto",
                                       device=device)
            for k in LAUNCHES:
                LAUNCHES[k] = 0
            sid = eng.begin_scan()
            eng.submit(sid, ProjectionChunk(raw.to(device), mats,
                                            np.arange(G.n_proj)))
            eng.drain()
            vols[str(device)] = eng.result(sid).cpu()
            assert eng.exec_plan.use_pallas and eng.pbatch == 3
            assert eng.stats["pallas_folds"] == G.n_proj
    finally:
        clear_memory_cache()
        reset_dispatcher()
    assert LAUNCHES["strip_db"] == 3 and LAUNCHES["backproject"] == 0
    want = vols["cpu"]
    torch.testing.assert_close(vols[str(dev)], want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


# ----------------------------------------------------------------------
# The language-model kernels: rows 9 (row gather) and 10 (sLSTM)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,n", [(1000, 768, 37), (50, 7, 9),
                                   (300, 64, 1)])
def test_row_gather_equals_plain_and_embedding_bitwise(dev, dtype, V, D, n):
    """Row 9: zero rows for ids outside [0, V), bitwise equal to its plain
    version, and to F.embedding on in-range ids; one launch per call, on
    the 16-byte path (D = 768, 64) and the element path (D = 7)."""
    from repro_torch.core.gather_ops import gather
    from repro_torch.kernels.gather_ref import gather_ref

    g = torch.Generator(device=dev).manual_seed(V)
    table = torch.randn((V, D), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, V, (n,), generator=g, device=dev)
    ids[0] = -1
    if n > 2:
        ids[1], ids[2] = V, V - 1
    before = LAUNCHES["onehot_gather"]
    got = gather(table, ids.reshape(1, n), impl="onehot")
    torch.cuda.synchronize()
    assert LAUNCHES["onehot_gather"] == before + 1
    assert got.shape == (1, n, D) and got.dtype == dtype
    assert torch.equal(got[0], gather_ref(table, ids))
    ok = (ids >= 0) & (ids < V)
    assert torch.equal(got[0][ok],
                       torch.nn.functional.embedding(ids[ok], table))
    assert not got[0][~ok].any()


@pytest.mark.parametrize("n", [4, 512])
def test_row_gather_at_chatglm3_width(dev, n):
    """Row 9 at chatglm3-6b's embedding, V = 65024, D = 4096, bfloat16: a
    decode call's 4 ids and a prompt's 512, bitwise equal to its plain
    version and to F.embedding."""
    from repro_torch.core.gather_ops import gather
    from repro_torch.kernels.gather_ref import gather_ref

    V, D = 65024, 4096
    g = torch.Generator(device=dev).manual_seed(n)
    table = torch.randn((V, D), generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, V, (n,), generator=g, device=dev)
    ids[0], ids[-1] = V - 1, 0
    before = LAUNCHES["onehot_gather"]
    got = gather(table, ids.reshape(1, n), impl="onehot")
    torch.cuda.synchronize()
    assert LAUNCHES["onehot_gather"] == before + 1
    assert torch.equal(got[0], gather_ref(table, ids))
    assert torch.equal(got[0], torch.nn.functional.embedding(ids, table))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["odd_width", "one_row", "ragged_rows",
                                  "all_out_of_range", "unaligned",
                                  "long_batch"])
def test_row_gather_grid_edges(dev, dtype, case):
    """Row 9's grid over (row, 16-byte unit): rows whose bytes are not
    whole 16-byte units (the element path), N = 1, N not a multiple of
    a block's 4 rows, every id out of range, a table 4 bytes off
    16-byte alignment, and N = 8192 at xlstm-125m's widths: bitwise equal
    to its plain version and to F.embedding, zero bits where an id is out
    of range, one launch per call."""
    from repro_torch.kernels.gather import launch_onehot_gather
    from repro_torch.kernels.gather_ref import gather_ref

    V, D, n = {"odd_width": (97, 7 if dtype == torch.float32 else 12, 37),
               "one_row": (500, 768, 1), "ragged_rows": (500, 768, 37),
               "all_out_of_range": (64, 768, 9),
               "unaligned": (300, 768, 21),
               "long_batch": (50304, 768, 8192)}[case]
    g = torch.Generator(device=dev).manual_seed(n + D)
    if case == "unaligned":
        flat = torch.randn((V * D + 1,), generator=g, device=dev).to(dtype)
        table = flat[1:].view(V, D)
        assert table.data_ptr() % 16
    else:
        table = torch.randn((V, D), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, V, (n,), generator=g, device=dev)
    if case == "all_out_of_range":
        ids = torch.tensor([-5, -1, V, V + 7, 2 ** 40, -2 ** 40, V, -1, V],
                           device=dev)
    elif n > 2:
        ids[0], ids[n // 2] = -1, V
    before = LAUNCHES["onehot_gather"]
    got = launch_onehot_gather(table, ids)
    torch.cuda.synchronize()
    assert LAUNCHES["onehot_gather"] == before + 1
    assert got.shape == (n, D) and got.dtype == dtype
    assert torch.equal(got, gather_ref(table, ids))
    ok = (ids >= 0) & (ids < V)
    assert torch.equal(got[ok], torch.nn.functional.embedding(ids[ok],
                                                              table))
    bits = got.view(torch.int32 if dtype == torch.float32 else torch.int16)
    assert not bits[~ok].any()


@pytest.mark.parametrize("B,S", [(1, 1), (3, 1), (2, 37), (4, 300)])
@pytest.mark.parametrize("fresh", [True, False])
def test_slstm_kernel_matches_plain(dev, B, S, fresh):
    """Row 10: hidden states and final state against the plain recurrence
    from a fresh (m = -inf) and a carried initial state."""
    from repro_torch.kernels.slstm_ops import slstm_recurrence
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_recurrence_ref)

    di = 96
    g = torch.Generator(device=dev).manual_seed(B * 1000 + S)
    zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
    r = torch.randn((4, di), generator=g, device=dev) * 0.3
    if fresh:
        state = init_slstm_state(B, di, device=dev)
    else:
        state = torch.randn((4, B, di), generator=g, device=dev)
        state[1] = state[1].abs() + 1.0
    before = LAUNCHES["slstm"]
    hs, final = slstm_recurrence(zifo, r, state)
    torch.cuda.synchronize()
    assert LAUNCHES["slstm"] == before + 1
    want_hs, want_final = slstm_recurrence_ref(zifo, r, state)
    torch.testing.assert_close(hs, want_hs, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(final, want_final, rtol=2e-4, atol=2e-4)


def _slstm_against_plain(dev, zifo, r, state):
    from repro_torch.kernels.slstm_ops import slstm_recurrence
    from repro_torch.kernels.slstm_ref import slstm_recurrence_ref

    before = LAUNCHES["slstm"]
    hs, final = slstm_recurrence(zifo, r, state)
    torch.cuda.synchronize()
    assert LAUNCHES["slstm"] == before + 1
    want_hs, want_final = slstm_recurrence_ref(zifo, r, state)
    torch.testing.assert_close(hs, want_hs, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(final, want_final, rtol=2e-4, atol=2e-4)
    return hs, final


@pytest.mark.parametrize("fresh", [True, False])
def test_slstm_kernel_long_memory(dev, fresh):
    """Row 10 with the forget pre-activations shifted by +12 (a forget
    gate of 1 - 6e-6: the log-forget comes from the kernel's series, and
    its errors would compound along the memory), S = 2048 at di = 1536."""
    from repro_torch.kernels.slstm_ref import init_slstm_state

    B, S, di = 2, 2048, 1536
    g = torch.Generator(device=dev).manual_seed(12)
    zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
    zifo[:, :, 2] += 12.0
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    if fresh:
        state = init_slstm_state(B, di, device=dev)
    else:
        state = torch.randn((4, B, di), generator=g, device=dev)
        state[1] = state[1].abs() + 1.0
    _slstm_against_plain(dev, zifo, r, state)


@pytest.mark.parametrize("fresh", [True, False])
def test_slstm_kernel_extreme_gates(dev, fresh):
    """Row 10 with pre-activations up to |30|, where tanh and sigmoid
    saturate and exp(-|x|) flushes to 0, and recurrence weights of 3: the
    outputs stay finite and within the tolerance."""
    from repro_torch.kernels.slstm_ref import init_slstm_state

    B, S, di = 3, 300, 96
    g = torch.Generator(device=dev).manual_seed(30)
    zifo = (torch.rand((B, S, 4, di), generator=g, device=dev) * 60 - 30)
    r = torch.randn((4, di), generator=g, device=dev) * 3.0
    if fresh:
        state = init_slstm_state(B, di, device=dev)
    else:
        state = torch.randn((4, B, di), generator=g, device=dev) * 30
        state[1] = state[1].abs() + 1.0
    hs, final = _slstm_against_plain(dev, zifo, r, state)
    assert bool(torch.isfinite(hs).all() and torch.isfinite(final).all())


@pytest.mark.parametrize("fresh", [True, False])
def test_slstm_kernel_chained_decode_steps(dev, fresh):
    """Row 10 as the served decode runs it: 256 launches at S = 1, B = 4,
    di = 1536, each from the state the last one returned (the kernel
    carries m in base-2 units and converts it at every launch), against
    the plain recurrence chained the same way: every step's h and the
    final state within rtol = atol = 2e-4."""
    from repro_torch.kernels.slstm_ops import slstm_recurrence
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_recurrence_ref)

    B, steps, di = 4, 256, 1536
    g = torch.Generator(device=dev).manual_seed(256)
    zifo = torch.randn((B, steps, 4, di), generator=g, device=dev)
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    if fresh:
        state = init_slstm_state(B, di, device=dev)
    else:
        state = torch.randn((4, B, di), generator=g, device=dev)
        state[1] = state[1].abs() + 1.0
    got, want, got_hs, want_hs = state, state, [], []
    before = LAUNCHES["slstm"]
    for t in range(steps):
        h, got = slstm_recurrence(zifo[:, t:t + 1].contiguous(), r, got)
        got_hs.append(h)
        h, want = slstm_recurrence_ref(zifo[:, t:t + 1], r, want)
        want_hs.append(h)
    torch.cuda.synchronize()
    assert LAUNCHES["slstm"] == before + steps
    torch.testing.assert_close(torch.cat(got_hs, 1), torch.cat(want_hs, 1),
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _tiny_xlstm(impl):
    import dataclasses

    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS["xlstm-125m"].reduced(),
                               gather_impl=impl)


def test_model_on_the_card_matches_its_plain_versions(dev, monkeypatch):
    """The reduced xlstm's forward logits with the kernels against the
    same model with the plain versions, on the card, at 2e-4·max(1,
    max|ref|) (float32 model)."""
    from repro_torch.kernels import gather_kernel_ops, slstm_ops
    from repro_torch.kernels.gather_ref import gather_ref
    from repro_torch.kernels.slstm_ref import slstm_recurrence_ref
    from repro_torch.models import forward, init_model

    cfg = _tiny_xlstm("onehot")
    model = init_model(cfg, seed=3, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    got, _ = forward(model, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert LAUNCHES["onehot_gather"] == 1
    assert LAUNCHES["slstm"] == cfg.n_layers // 2
    monkeypatch.setattr(gather_kernel_ops, "launch_onehot_gather",
                        gather_ref)
    monkeypatch.setattr(slstm_ops, "launch_slstm", slstm_recurrence_ref)
    want, _ = forward(model, cfg, {"tokens": toks})
    tol = 2e-4 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_take_and_onehot_serve_identical_greedy_tokens(dev):
    """The served path on the card: prompts of unequal length (grouped,
    masked decode), greedy and temperature requests; the two gathers give
    the same greedy tokens, and every prefill and decode step launched the
    sLSTM kernel."""
    from repro_torch.models import init_model
    from repro_torch.serving import Request, ServingEngine

    served = {}
    for impl in ("take", "onehot"):
        cfg = _tiny_xlstm(impl)
        model = init_model(cfg, seed=0, device=dev)
        eng = ServingEngine(cfg, model, n_slots=2, max_len=64, seed=5,
                            device=dev)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4 + 3 * i),
                        max_tokens=6, temperature=0.8 if i % 2 else 0.0)
                for i in range(4)]
        for r in reqs:
            eng.submit(r)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        eng.run_until_done(max_ticks=100)
        torch.cuda.synchronize()
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
        assert LAUNCHES["slstm"] > 0
        assert (LAUNCHES["onehot_gather"] > 0) == (impl == "onehot")
        served[impl] = [r.out_tokens for r in reqs]
    assert served["take"][0::2] == served["onehot"][0::2]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-small",
                                  "qwen2-vl-2b"])
def test_attention_model_on_the_card_matches_the_cpu(dev, arch):
    """An attention model (reduced, float32) on the card against the same
    parameters on the CPU: forward, prefill and a decode step at 2e-4 x
    max(1, max|ref|); with gather_impl="onehot" the card launches row 9
    once a call and gives the same bits as "take"."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, forward, init_model, prefill
    from repro_torch.models.model import FRONTEND_DIM

    cfg = ARCHS[arch].reduced()
    model = init_model(cfg, seed=4, device="cpu")
    on_card = init_model(cfg, seed=4, device="cpu").to(dev)
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g)}
    if cfg.frontend:
        n = 4 if cfg.frontend == "vision" else 16
        key = "patches" if cfg.frontend == "vision" else "frames"
        batch[key] = torch.randn((2, n, FRONTEND_DIM[cfg.frontend]),
                                 generator=g)
    n = 12 + (4 if cfg.frontend == "vision" else 0)
    tok = batch["tokens"][:, :1]

    def run(m, c, b):
        logits, _ = forward(m, c, b)
        last, cache = prefill(m, c, b, 24)
        step, _ = decode_step(m, c, cache, tok.to(m.device), n)
        return logits, last, step

    want = run(model, cfg, batch)
    card = {k: v.to(dev) for k, v in batch.items()}
    got = run(on_card, cfg, card)
    for a, b in zip(got, want):
        tol = 2e-4 * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol)
    onehot = dataclasses.replace(cfg, gather_impl="onehot")
    before = LAUNCHES["onehot_gather"]
    got1 = run(on_card, onehot, card)
    torch.cuda.synchronize()
    assert LAUNCHES["onehot_gather"] == before + 3
    assert all(torch.equal(a, b) for a, b in zip(got, got1))


@pytest.mark.parametrize("chunk", [256, 16])
def test_mamba_scan_on_the_card_equals_the_cpu(dev, chunk):
    """The Mamba mixer (jamba's reduced widths, float32) on the card
    against the same code on the CPU at 2e-4: one chunk of 48 tokens, and
    three chunks of 16 with ``h`` carried; the returned state too."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.models import ssm
    from repro_torch.models.layers import Params

    cfg = ARCHS["jamba-v0.1-52b"].reduced()
    cpu = Params(torch.float32, torch.device("cpu"),
                 torch.Generator().manual_seed(0))
    ssm.init_mamba(cpu, cfg)
    with torch.no_grad():
        cpu["dt_bias"].normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 48, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    want, ws = ssm.mamba_forward(cpu, cfg, x, chunk=chunk,
                                 dtype=torch.float32, return_state=True)
    on_card = copy.deepcopy(cpu).to(dev)
    got, gs = ssm.mamba_forward(on_card, cfg, x.to(dev), chunk=chunk,
                                dtype=torch.float32, return_state=True)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    for k in ("conv", "h"):
        torch.testing.assert_close(gs[k].cpu(), ws[k], rtol=2e-4, atol=2e-4)


def test_moe_scatter_on_the_card_drops_what_the_cpu_drops(dev):
    """MoE ``scatter`` with a capacity that drops: the card's positions in
    expert and kept set equal the CPU's, and the outputs agree at 2e-4
    (rows with every assignment dropped exactly zero on both)."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models.layers import Params

    cfg = dataclasses.replace(ARCHS["jamba-v0.1-52b"].reduced(),
                              capacity_factor=0.25)
    cpu = Params(torch.float32, torch.device("cpu"),
                 torch.Generator().manual_seed(3))
    moe.init_moe(cpu, cfg)
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    _, _, idx = moe._route(cpu, cfg, x.reshape(-1, cfg.d_model))
    pos = moe._positions_in_expert(idx.reshape(-1), cfg.n_experts)
    C = moe.moe_capacity(cfg, 256)
    want, waux = moe.moe_forward(cpu, cfg, x, dtype=torch.float32)
    on_card = copy.deepcopy(cpu).to(dev)
    _, _, gidx = moe._route(on_card, cfg, x.reshape(-1, cfg.d_model).to(dev))
    gpos = moe._positions_in_expert(gidx.reshape(-1), cfg.n_experts)
    assert torch.equal(gidx.cpu(), idx)
    assert torch.equal(gpos.cpu(), pos)
    assert int((pos >= C).sum()) > 0
    got, aux = moe.moe_forward(on_card, cfg, x.to(dev), dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-5, atol=1e-6)
    assert torch.equal(got.cpu().abs().sum(-1) == 0, want.abs().sum(-1) == 0)


@pytest.mark.parametrize("impl", ["take", "onehot"])
def test_jamba_period_runs_on_the_card(dev, impl):
    """One period of jamba at small widths (7 Mamba blocks and 1
    attention block, MoE on every second) in float32 on the card:
    prefill and three decode steps against the same parameters on the
    CPU at 2e-4·max(1, max|ref|); under onehot row 9 launches once a
    call."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_model, prefill

    cfg = dataclasses.replace(ARCHS["jamba-v0.1-52b"].reduced(), n_layers=8,
                              gather_impl=impl)
    model = init_model(cfg, seed=5, device="cpu")
    on_card = init_model(cfg, seed=5, device="cpu").to(dev)
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(6))

    def run(m, t):
        outs = []
        logits, cache = prefill(m, cfg, {"tokens": t}, 32)
        outs.append(logits)
        for i in range(3):
            logits, cache = decode_step(m, cfg, cache, t[:, i:i + 1], 20 + i)
            outs.append(logits)
        return outs, cache

    want, wc = run(model, toks)
    before = LAUNCHES["onehot_gather"]
    got, gc = run(on_card, toks.to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES["onehot_gather"] - before == (4 if impl == "onehot"
                                                  else 0)
    for a, b in zip(got, want):
        tol = 2e-4 * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol)
    for name, leaves in wc["blocks"].items():
        for k, v in leaves.items():
            tol = 2e-4 * max(1.0, float(v.float().abs().max()))
            torch.testing.assert_close(gc["blocks"][name][k].cpu(), v,
                                       rtol=0, atol=tol)


# ----------------------------------------------------------------------
# The backward kernels (rows 9b, 10b) and a train step on the card
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,S,di", [(1, 1, 64), (3, 37, 96), (2, 300, 1536)])
def test_slstm_backward_kernel_matches_plain(dev, B, S, di):
    """Row 10b against autograd through the plain recurrence, from a
    fresh state, at the forward's 2e-4 (relative, plus absolute); the
    training forward equals the served one bitwise, and two runs of the
    backward give the same bits."""
    from repro_torch.kernels.slstm import (launch_slstm,
                                           launch_slstm_backward,
                                           launch_slstm_train)
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_backward_ref)

    g = torch.Generator(device=dev).manual_seed(B * 100 + S)
    zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    state = init_slstm_state(B, di, device=dev)
    dhs = torch.randn((B, S, di), generator=g, device=dev)
    hs, final, states = launch_slstm_train(zifo, r, state)
    served = launch_slstm(zifo, r, state)
    before = LAUNCHES["slstm_backward"]
    dz, dr = launch_slstm_backward(zifo, r, state, hs, states, dhs)
    again = launch_slstm_backward(zifo, r, state, hs, states, dhs)
    torch.cuda.synchronize()
    assert LAUNCHES["slstm_backward"] == before + 2
    assert torch.equal(hs, served[0]) and torch.equal(final, served[1])
    assert torch.equal(dz, again[0]) and torch.equal(dr, again[1])
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    torch.testing.assert_close(dz, want_z, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dr, want_r, rtol=2e-4, atol=2e-4)


def test_slstm_autograd_runs_both_kernels(dev):
    from repro_torch.kernels.slstm_ops import slstm_recurrence

    zifo = torch.randn((2, 17, 4, 32), device=dev, requires_grad=True)
    r = torch.randn((4, 32), device=dev, requires_grad=True)
    before = dict(LAUNCHES)
    hs, _ = slstm_recurrence(zifo, r)
    hs.sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES["slstm"] == before["slstm"] + 1
    assert LAUNCHES["slstm_backward"] == before["slstm_backward"] + 1
    assert torch.isfinite(zifo.grad).all() and torch.isfinite(r.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,n", [(1000, 768, 37), (50, 7, 9),
                                   (64, 768, 4096), (300, 12, 0)])
def test_gather_backward_kernel_equals_plain(dev, dtype, V, D, n):
    """Row 9b: d table equal to the plain version (the float32 sum in
    position order, rounded once) bitwise, with repeated ids and ids out
    of range, zero rows where no id hits; two runs give the same bits."""
    from repro_torch.kernels.gather import launch_onehot_gather_grad
    from repro_torch.kernels.gather_ref import gather_grad_ref

    g = torch.Generator(device=dev).manual_seed(V + n)
    ids = torch.randint(0, V, (n,), generator=g, device=dev)
    if n >= 8:
        ids[0], ids[1] = -1, V
        ids[2:6] = ids[6]
    dout = torch.randn((n, D), generator=g, device=dev).to(dtype)
    got = launch_onehot_gather_grad(ids, dout, V)
    again = launch_onehot_gather_grad(ids, dout, V)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, gather_grad_ref(ids, dout, V))
    hit = torch.zeros(V, dtype=torch.bool, device=dev)
    hit[ids[(ids >= 0) & (ids < V)]] = True
    assert not got[~hit].any()


def _gather_edge(case, V, dev):
    """(ids, D) of a row 9b edge case."""
    from repro_torch.kernels.gather import BLOCK_MAX_N

    g = torch.Generator(device=dev).manual_seed(len(case))
    n, D = {"n0": (0, 64), "n1": (1, 64), "one_run": (512, 768),
            "all_out": (64, 64), "at_limit": (BLOCK_MAX_N, 64),
            "above_limit": (BLOCK_MAX_N + 1, 64), "v_odd": (300, 128),
            "d_odd": (200, 7)}[case]
    ids = torch.randint(0, V, (n,), generator=g, device=dev)
    if case == "one_run":
        ids[:] = V // 3
    elif case == "all_out":
        ids = torch.where(torch.arange(n, device=dev) % 2 == 0, -1 - ids,
                          V + ids)
    elif n >= 8:
        ids[0], ids[1] = -1, V
        ids[2:6] = ids[6]
    return ids, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,V", [("n0", 300), ("n1", 300),
                                    ("one_run", 1000), ("all_out", 100),
                                    ("at_limit", 50304),
                                    ("above_limit", 50304),
                                    ("v_odd", 1000 + 7), ("d_odd", 500)])
def test_gather_backward_edges(dev, dtype, case, V):
    """Row 9b at its edges: no ids, one id, every id equal (one run of
    N), every id out of range, N at the one-block limit and one above it
    (torch.sort's path), V not a multiple of 32 (the hit map's tail) and
    D itemsize not a multiple of 16 (element stores).  Each equals the
    plain version (the float32 sum in position order, rounded once)
    bitwise, twice, through the path ``grad_path`` names."""
    from repro_torch.kernels.gather import (GRAD_PATHS, grad_path,
                                            launch_onehot_gather_grad)
    from repro_torch.kernels.gather_ref import gather_grad_ref

    ids, D = _gather_edge(case, V, dev)
    g = torch.Generator(device=dev).manual_seed(V + D)
    dout = torch.randn((ids.numel(), D), generator=g, device=dev).to(dtype)
    path = grad_path(ids.numel(), V)
    assert path == ("sort" if case == "above_limit" else "block")
    before = dict(GRAD_PATHS)
    got = launch_onehot_gather_grad(ids, dout, V)
    again = launch_onehot_gather_grad(ids, dout, V)
    torch.cuda.synchronize()
    assert GRAD_PATHS[path] == before[path] + 2
    assert torch.equal(got, again)
    assert torch.equal(got, gather_grad_ref(ids, dout, V))


@pytest.mark.parametrize("B,S,di,shift", [
    (1, BWD_CHUNK - 1, 96, 0.0), (1, BWD_CHUNK, 96, 0.0),
    (1, BWD_CHUNK + 1, 96, 0.0), (1, BWD_WARPS * BWD_CHUNK, 96, 0.0),
    (1, BWD_WARPS * BWD_CHUNK + 1, 96, 0.0),
    (2, BWD_WARPS * BWD_CHUNK + 1, 40, 0.0), (2, 2048, 64, 12.0)])
def test_slstm_backward_piece_edges(dev, B, S, di, shift):
    """Row 10b at the chunked scan's edges: S one short of a chunk, a
    chunk, one over, a piece and one over, at B = 1; 40 features (a
    block's 32 chains straddle two batch rows); a long memory (forget
    pre-activations +12 over 2048 tokens).  Within 2e-4 of autograd
    through the plain recurrence, and the same bits twice."""
    from repro_torch.kernels.slstm import (launch_slstm_backward,
                                           launch_slstm_train)
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_backward_ref)

    g = torch.Generator(device=dev).manual_seed(B * 1000 + S + di)
    zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
    zifo[:, :, 2] += shift
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    state = init_slstm_state(B, di, device=dev)
    dhs = torch.randn((B, S, di), generator=g, device=dev)
    hs, _, states = launch_slstm_train(zifo, r, state)
    dz, dr = launch_slstm_backward(zifo, r, state, hs, states, dhs)
    again = launch_slstm_backward(zifo, r, state, hs, states, dhs)
    torch.cuda.synchronize()
    assert torch.equal(dz, again[0]) and torch.equal(dr, again[1])
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    torch.testing.assert_close(dz, want_z, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dr, want_r, rtol=2e-4, atol=2e-4)


def test_slstm_backward_layout(dev):
    """The built backward's layout is the one its launcher module names,
    and its shared memory lets an SM hold at least two blocks."""
    from repro_torch.kernels.slstm import backward_config

    cfg = backward_config()
    assert (cfg["warps"], cfg["chunk"]) == (BWD_WARPS, BWD_CHUNK)
    assert cfg["smem_bytes"] == (BWD_WARPS * BWD_CHUNK * 9 + BWD_WARPS * 20) \
        * 32 * 4
    assert cfg["blocks_per_sm"] >= 2


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One train step of the reduced xlstm (onehot gather) on the card,
    with rows 9, 9b, 10 and 10b, against the same step on the CPU's plain
    versions: the loss within 2e-4·max(1, |ref|); no parameter more than
    lr from the CPU's, and at most 1 % of them more than lr/10 (Adam's
    first step is about lr times the sign of the gradient, so an element
    whose gradient is near zero follows its last bits)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    cfg = dataclasses.replace(ARCHS["xlstm-125m"].reduced(),
                              gather_impl="onehot")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    toks = torch.randint(0, cfg.vocab, (2, 25),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for where in ("cpu", dev):
        model = init_model(cfg, seed=4, device="cpu").to(where)
        opt = init_opt_state(model, ocfg)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        model, opt, m = make_train_step(cfg, ocfg)(model, opt, batch)
        if where != "cpu":
            torch.cuda.synchronize()
            assert LAUNCHES["onehot_gather"] == 1
            assert LAUNCHES["onehot_gather_backward"] == 1
            assert LAUNCHES["slstm"] == cfg.n_layers      # forward + remat
            assert LAUNCHES["slstm_backward"] == cfg.n_layers // 2
        out[str(where)] = (float(m["loss"]),
                           {k: p.detach().cpu()
                            for k, p in model.named_parameters()})
    (l_cpu, p_cpu), (l_dev, p_dev) = out["cpu"], out[str(dev)]
    assert abs(l_dev - l_cpu) <= 2e-4 * max(1.0, abs(l_cpu))
    far = total = 0
    for k, want in p_cpu.items():
        d = (p_dev[k] - want).abs()
        assert float(d.max()) <= ocfg.lr, k
        far += int((d > ocfg.lr / 10).sum())
        total += d.numel()
    assert far <= total // 100
