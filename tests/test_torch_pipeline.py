"""The port's sharded reconstruction against its single-device fold and
against the JAX package's ``sharded_reconstruct``.

On a 1x1 gloo mesh (this process) the decomposition is one z-slab and
one projection block, so the result is bitwise the single-device fold.
One spawned run of 4 CPU ranks (``_torch_ranks.run_ranks``) holds a 2x2
mesh within 1e-5 of the single-device fold (the sum over projection
blocks changes order), a 2x1 mesh bitwise, the wires against float32,
and the plan broadcast; beside it the reference's own 4-device child
(fake CPU devices, as ``tests/test_distributed.py`` runs it) computes
the same 2x2 reconstructions, and the two packages agree at the
tolerance ``tests/test_torch_strategies.py`` holds ``reconstruct`` to,
1e-5 * max(1, max|ref|).  All inputs are the reference's dataset as
numpy arrays.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as jcore
from repro.core.phantom import make_dataset as j_make_dataset
from repro.core.pipeline import sharded_reconstruct as j_sharded
from repro.launch.mesh import make_local_mesh as j_make_local_mesh
from _torch_ranks import SRC, run_ranks
from repro_torch.core.backproject import GeomStatic, reconstruct
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry
from repro_torch.core.pipeline import reconstruct_shards, sharded_reconstruct
from repro_torch.dispatch import ExecutionPlan
from repro_torch.launch.mesh import make_local_mesh

JG = jcore.Geometry().scaled(16, n_proj=4)
G = Geometry().scaled(16, n_proj=4)
_J = j_make_dataset(JG)
PROJS, MATS = np.asarray(_J[0]), np.asarray(_J[1])
CPU = dict(device="cpu")


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture
def mesh():
    """A 1x1 gloo mesh, its process group destroyed after the test."""
    m = make_local_mesh(1, 1, device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _filtered():
    return filter_projections(PROJS, G, **CPU)


@pytest.mark.parametrize("strategy", ["gather", "strip2", "scalar"])
def test_identity_mesh_is_the_single_device_fold_bitwise(mesh, strategy):
    filt = _filtered()
    out = sharded_reconstruct(filt, MATS, G, mesh, strategy=strategy, **CPU)
    single = reconstruct(filt, MATS, G, strategy=strategy, **CPU)
    assert tuple(out.shape) == (G.L,) * 3 and out.to_local().shape == (
        G.L,) * 3
    assert float(single.abs().sum()) != 0.0
    assert torch.equal(out.full_tensor(), single)


def test_prefiltered_false_filters_in_shard_bitwise(mesh):
    out = sharded_reconstruct(PROJS, MATS, G, mesh, prefiltered=False, **CPU)
    single = reconstruct(_filtered(), MATS, G, strategy="strip2", **CPU)
    assert float(out.to_local().abs().sum()) != 0.0
    assert torch.equal(out.to_local(), single)


def test_prefiltered_false_rejects_subset(mesh):
    with pytest.raises(ValueError, match="full scan"):
        sharded_reconstruct(PROJS[:2], MATS[:2], G, mesh, prefiltered=False,
                            **CPU)


def test_mesh_refuses_another_device(mesh):
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="device type"):
        sharded_reconstruct(PROJS, MATS, G, mesh, device=meta)


def test_reconstruct_shards_z0_slab_offset():
    """The per-rank body back-projects a non-first z-slab correctly when
    handed its global offset."""
    filt = _filtered()
    full = reconstruct(filt, MATS, G, strategy="strip2", **CPU)
    gs = GeomStatic.of(G)
    half = G.L // 2
    plan = ExecutionPlan.explicit("strip2")
    lo = reconstruct_shards(filt, MATS, gs, plan,
                            torch.zeros((half,) + (G.L,) * 2))
    hi = reconstruct_shards(filt, MATS, gs, plan,
                            torch.zeros((half,) + (G.L,) * 2), z0=half)
    assert torch.equal(lo, full[:half]) and torch.equal(hi, full[half:])
    assert float((lo - full[half:]).abs().max()) > 0     # default z0 = 0


@pytest.mark.parametrize("prefiltered", [True, False])
def test_identity_mesh_against_the_reference(mesh, prefiltered):
    jmesh = j_make_local_mesh(data=1, model=1)
    if prefiltered:
        jfilt = np.asarray(jcore.filter_projections(PROJS, JG))
        want = np.asarray(j_sharded(jfilt, MATS, JG, jmesh,
                                    strategy="gather"))
        got = sharded_reconstruct(_filtered(), MATS, G, mesh,
                                  strategy="gather", **CPU)
    else:
        want = np.asarray(j_sharded(PROJS, MATS, JG, jmesh,
                                    prefiltered=False))
        got = sharded_reconstruct(PROJS, MATS, G, mesh, prefiltered=False,
                                  **CPU)
    np.testing.assert_allclose(got.full_tensor().numpy(), want, rtol=0,
                               atol=_tol(want))


# ----------------------------------------------------------------------
# Four ranks (gloo), and the reference's 4-device child
# ----------------------------------------------------------------------

_RANKS_BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
import repro_torch.core.pipeline as pl
from repro_torch.core.backproject import reconstruct
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry
from repro_torch.core.quality import psnr, roi_mask
from repro_torch.launch.mesh import make_local_mesh

D = np.load({data!r})
PROJS, MATS = D["projs"], D["mats"]
G = Geometry().scaled(16, n_proj=4)
CPU = dict(device="cpu")


def main():
    res = {{}}
    filt = filter_projections(PROJS, G, **CPU)
    mesh = make_local_mesh(2, 2, device="cpu")

    def run(projs, m=mesh, **kw):
        return pl.sharded_reconstruct(projs, MATS, G, m, **CPU, **kw)

    for s in ("gather", "strip2"):
        vol = run(filt, strategy=s)
        res[f"slab_{{s}}"] = list(vol.to_local().shape)
        out = vol.full_tensor()
        single = reconstruct(filt, MATS, G, strategy=s, **CPU)
        res[f"diff_{{s}}"] = float((out - single).abs().max())
        res[f"top_{{s}}"] = float(single.abs().max())
        if s == "gather" and RANK == 0:
            np.save({gather!r}, out.numpy())
    raw = run(PROJS, prefiltered=False).full_tensor()
    single = reconstruct(filt, MATS, G, strategy="strip2", **CPU)
    res["diff_raw"] = float((raw - single).abs().max())
    res["nonzero_raw"] = bool((raw != 0).any())
    if RANK == 0:
        np.save({raw!r}, raw.numpy())

    v32 = run(filt).full_tensor()
    res["f32_bitwise"] = torch.equal(
        run(filt, strip_dtype="float32").full_tensor(), v32)
    mask = roi_mask(G.L, **CPU)
    for w in ("bfloat16", "int8"):
        vq = run(filt, strip_dtype=w).full_tensor()
        res[f"identical_{{w}}"] = torch.equal(vq, v32)
        res[f"psnr_{{w}}"] = psnr(vq, v32, mask)
    try:
        run(filt, strip_dtype="int4")
        res["int4_raised"] = False
    except ValueError as e:
        res["int4_raised"] = "strip_dtype" in str(e)

    # A 2x1 mesh (data only) for each of two replicas.
    m21 = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=(
        "rep", "data", "model"))["data", "model"]
    for s in ("gather", "strip2"):
        out = run(filt, m=m21, strategy=s)
        res[f"bitwise_2x1_{{s}}"] = torch.equal(
            out.full_tensor(), reconstruct(filt, MATS, G, strategy=s, **CPU))
        res[f"slab_2x1_{{s}}"] = list(out.to_local().shape)

    # strategy="auto": resolved on the first rank only, one plan for all.
    calls, plans = [], []
    resolve, body = pl._resolve_plan, pl.reconstruct_shards

    def counted(*a):
        calls.append(1)
        return resolve(*a)

    def recorded(projs, mats, gs, plan, *a, **kw):
        plans.append(plan)
        return body(projs, mats, gs, plan, *a, **kw)

    pl._resolve_plan, pl.reconstruct_shards = counted, recorded
    try:
        out = run(filt, strategy="auto").full_tensor()
    finally:
        pl._resolve_plan, pl.reconstruct_shards = resolve, body
    every = [None] * WORLD
    dist.all_gather_object(every, (len(calls), plans))
    res["auto_calls"] = [c for c, _ in every]
    res["auto_same"] = (len(plans) == 1
                        and all(p == every[0][1] for _, p in every))
    res["auto_files"] = sorted(os.listdir(os.environ["REPRO_TORCH_TUNE_DIR"]))
    single = reconstruct(filt, MATS, G, plan=plans[0], **CPU)
    res["diff_auto"] = float((out - single).abs().max())
    return res
"""

_REF_CHILD = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import numpy as np
from repro.core import Geometry, filter_projections
from repro.core.pipeline import sharded_reconstruct
from repro.launch.mesh import make_local_mesh
D = np.load({data!r})
geom = Geometry().scaled(16, n_proj=4)
filt = np.asarray(filter_projections(D["projs"], geom))
mesh = make_local_mesh(data=2, model=2)
np.save({gather!r}, np.asarray(sharded_reconstruct(
    filt, D["mats"], geom, mesh, strategy="gather")))
np.save({raw!r}, np.asarray(sharded_reconstruct(
    D["projs"], D["mats"], geom, mesh, prefiltered=False)))
print(json.dumps({{"ok": True}}))
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The port's 4-rank run and the reference's 4-device child, run
    side by side; returns the ranks' record and the directory with both
    packages' volumes."""
    tmp = tmp_path_factory.mktemp("pipeline4")
    data = str(tmp / "data.npz")
    np.savez(data, projs=PROJS, mats=MATS)
    files = {k: str(tmp / f"{k}.npy") for k in ("gather", "raw",
                                                 "j_gather", "j_raw")}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_CHILD.format(
            src=str(SRC), data=data, gather=files["j_gather"],
            raw=files["j_raw"]))], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        tune = tmp / "tune"
        tune.mkdir()
        rec = run_ranks(_RANKS_BODY.format(data=data, gather=files["gather"],
                                           raw=files["raw"]), 4, tmp,
                        env={"REPRO_TORCH_TUNE_DIR": str(tune)})
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1]) == {"ok": True}
    return rec, {k: np.load(v) for k, v in files.items()}


def test_2x2_within_tolerance_of_the_single_device_fold(four):
    rec, _ = four
    for s in ("gather", "strip2"):
        assert rec[f"slab_{s}"] == [G.L // 2, G.L, G.L]
        assert rec[f"diff_{s}"] < 1e-5 * max(1.0, rec[f"top_{s}"])


def test_2x2_prefiltered_false_weights_nonprefix_ranks(four):
    rec, _ = four
    assert rec["nonzero_raw"]
    assert rec["diff_raw"] < 1e-5


def test_2x2_wires(four):
    rec, _ = four
    assert rec["f32_bitwise"]
    for w, floor in (("bfloat16", 40.0), ("int8", 35.0)):
        assert not rec[f"identical_{w}"], f"the {w} wire was a no-op"
        assert rec[f"psnr_{w}"] > floor
    assert rec["int4_raised"]


def test_2x1_is_the_single_device_fold_bitwise(four):
    rec, _ = four
    for s in ("gather", "strip2"):
        assert rec[f"slab_2x1_{s}"] == [G.L // 2, G.L, G.L]
        assert rec[f"bitwise_2x1_{s}"]


def test_auto_plan_is_resolved_once_and_broadcast(four):
    rec, _ = four
    assert rec["auto_calls"] == [1, 0, 0, 0]
    assert rec["auto_same"]
    assert len(rec["auto_files"]) == 1           # one writer of the cache
    assert rec["diff_auto"] < 1e-5


@pytest.mark.parametrize("name", ["gather", "raw"])
def test_2x2_against_the_reference_4_device_child(four, name):
    _, vols = four
    want = vols[f"j_{name}"]
    np.testing.assert_allclose(vols[name], want, rtol=0, atol=_tol(want))
