"""The frozen reference agrees with the program's CPU path at a small
size.  (This test imports both; ``bench/reference`` imports nothing of
the program.)"""

import ast
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench import reference
from bench.reference import codes, fdk, geometry, phantom
from bench.reference.backproject import backproject_at, voxel_coords
from repro_torch.core import filtering as port_filtering
from repro_torch.core import phantom as port_phantom
from repro_torch.core.backproject import reconstruct
from repro_torch.core.geometry import Geometry, projection_matrices
from repro_torch.kernels.backproject_ref import backproject_batch_ref
from repro_torch.quant import quantize_rows_ref

REF_DIR = pathlib.Path(reference.__file__).parent


def small(L=16, n_proj=32):
    g = Geometry().scaled(L, n_proj=n_proj)
    return g, geometry.Scan(n_u=g.n_u, n_v=g.n_v, du=g.du, dv=g.dv,
                            sid=g.sid, sdd=g.sdd, L=g.L,
                            voxel_mm=g.voxel_mm, n_proj=g.n_proj,
                            sweep_deg=200.0)


def views(scan, seed=7):
    ells = phantom.ellipsoids(scan, np.random.default_rng(seed))
    return ells, phantom.forward_project(scan, ells, "cpu")


def test_the_reference_imports_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and not node.level else []
            for name in names:
                assert name.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {name}"


def test_matrices_are_the_programs():
    g, scan = small()
    np.testing.assert_array_equal(geometry.projection_matrices(scan),
                                  projection_matrices(g))


def test_projector_matches_the_programs():
    g, scan = small()
    ells, mine = views(scan)
    port = [port_phantom.Ellipsoid(tuple(e["center"]), tuple(e["axes"]),
                                   e["rho"], float(np.arctan2(e["rot"][1, 0],
                                                              e["rot"][0, 0])))
            for e in ells]
    theirs = port_phantom.forward_project(g, port, device="cpu")
    scale = float(theirs.abs().max())
    assert float((mine - theirs).abs().max()) <= 1e-5 * scale


def test_filter_matches_the_programs():
    g, scan = small()
    _, raw = views(scan)
    idx = np.random.default_rng(1).permutation(scan.n_proj)[:8]
    mine = fdk.Filter(scan, "cpu")(raw[idx], torch.as_tensor(idx))
    theirs = port_filtering.filter_projections(raw[idx], g,
                                               angle_indices=idx,
                                               device="cpu")
    assert float((mine - theirs).abs().max()) <= \
        1e-6 * float(theirs.abs().max())


def test_int8_codes_are_the_programs_bitwise():
    x = torch.randn(3, 11, 37, generator=torch.Generator().manual_seed(0))
    x = F.pad(x, (1, 1, 1, 1))
    c, s, o = codes.encode(x, 8)
    rq = quantize_rows_ref(x)
    assert torch.equal(c, rq.codes.to(torch.float32))
    assert torch.equal(s, rq.scale) and torch.equal(o, rq.offset)


def test_four_bit_codes_are_coarser():
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(1))
    err8 = (codes.decode(*codes.encode(x, 8)) - x).abs().max()
    err4 = (codes.decode(*codes.encode(x, 4)) - x).abs().max()
    assert float(err4) > 8 * float(err8)


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_back_projection_matches_the_kernels_plain_version(wire):
    g, scan = small()
    _, raw = views(scan)
    filt = fdk.Filter(scan, "cpu")(raw, torch.arange(scan.n_proj))
    mats = torch.as_tensor(geometry.projection_matrices(scan))
    vol = torch.zeros((g.L,) * 3)
    from repro_torch.core.backproject import GeomStatic

    backproject_batch_ref(vol, filt, mats, GeomStatic.of(g), wire=wire)
    flat = torch.arange(g.L ** 3)
    mine = backproject_at(reference.on_wire(filt, wire), mats,
                          voxel_coords(flat, g.L), scan.O, scan.voxel_mm)
    assert float((mine - vol.reshape(-1)).abs().max()) <= \
        1e-5 * float(vol.abs().max())


@pytest.mark.parametrize("wire, strategy", [("float32", "scalar"),
                                            ("int8", "strip2")])
def test_reconstruction_matches_the_programs_one_shot(wire, strategy):
    g, scan = small()
    _, raw = views(scan, seed=11)
    order = np.random.default_rng(2).permutation(scan.n_proj)
    mats = geometry.projection_matrices(scan)
    flat = torch.as_tensor(np.unique(
        np.random.default_rng(3).integers(0, g.L ** 3, 500)))
    mine = reference.reconstruct_at(scan, raw[order], order,
                                    torch.as_tensor(mats[order]), flat,
                                    (wire,))[wire]
    opts = {} if wire == "float32" else {"strip_dtype": wire}
    filt = port_filtering.filter_projections(raw, g, device="cpu")
    vol = reconstruct(filt, mats, g, strategy=strategy, device="cpu", **opts)
    want = vol.reshape(-1)[flat]
    assert float((mine - want).abs().max()) <= 1e-5 * float(want.abs().max())
