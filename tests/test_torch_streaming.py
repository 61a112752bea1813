"""The port's streaming engine against the JAX package's (CPU).

Both engines get the same shuffled chunks of the same numpy phantom; the
JAX engine runs ``strategy="scalar"``.  Tolerance 1e-5 (abs and rel), as
the reference's own streaming tests: both sides are float32, and the
streamed summation order follows arrival order.
"""

import numpy as np
import pytest
import torch

import repro.streaming as jstream
from repro.core.geometry import Geometry as JGeometry
from repro.core.phantom import make_dataset
from repro_torch.core.backproject import reconstruct
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry
from repro_torch.streaming import ProjectionChunk, ReconstructionEngine

JG = JGeometry().scaled(16, n_proj=6)
G = Geometry().scaled(16, n_proj=6)
PROJS, MATS, _ = make_dataset(JG)
TOL = dict(atol=1e-5, rtol=1e-5)


def _one_shot():
    filt = filter_projections(PROJS, G, device="cpu")
    return reconstruct(filt, MATS, G, device="cpu").numpy()


REF = _one_shot()


def _chunks(seed, sizes):
    order = np.random.default_rng(seed).permutation(G.n_proj)
    out, c0 = [], 0
    for k in sizes:
        idx = order[c0:c0 + k]
        out.append((PROJS[idx], MATS[idx], idx))
        c0 += k
    return out


@pytest.mark.parametrize("seed,sizes,pbatch", [(7, (3, 2, 1), 4),
                                               (3, (6,), 4),
                                               (5, (1, 4, 1), 3)])
def test_engine_matches_reference_engine(seed, sizes, pbatch):
    jeng = jstream.ReconstructionEngine(JG, n_slots=2, strategy="scalar",
                                        pbatch=pbatch)
    teng = ReconstructionEngine(G, n_slots=2, pbatch=pbatch, device="cpu")
    jsid, tsid = jeng.begin_scan(), teng.begin_scan()
    for projs, mats, idx in _chunks(seed, sizes):
        jeng.submit(jsid, jstream.ProjectionChunk(projs, mats, idx))
        teng.submit(tsid, ProjectionChunk(torch.tensor(projs), mats, idx))
    jeng.drain()
    teng.drain()
    want = np.asarray(jeng.result(jsid))
    got = teng.result(tsid).numpy()
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, REF, **TOL)
    for key in jeng.stats:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["fold_launches"] >= -(-G.n_proj // pbatch)


def test_slot_reuse_matches_reference_engine():
    """3 scans over 2 slots, interleaved single-projection arrival: the
    third admits after a retirement and reuses a zeroed slot."""
    jeng = jstream.ReconstructionEngine(JG, n_slots=2, strategy="scalar",
                                        pbatch=4)
    teng = ReconstructionEngine(G, n_slots=2, pbatch=4, device="cpu")
    jsids = [jeng.begin_scan() for _ in range(3)]
    tsids = [teng.begin_scan() for _ in range(3)]
    assert teng.active == 3 and teng.free_slots == 0
    for i in range(G.n_proj):
        for js, ts in zip(jsids, tsids):
            jeng.submit(js, jstream.ProjectionChunk(PROJS[i], MATS[i], i))
            teng.submit(ts, ProjectionChunk(PROJS[i], MATS[i], i))
    jeng.drain()
    teng.drain()
    assert teng.slot_history == jeng.slot_history
    assert teng.stats["retired"] == 3 and teng.active == 0
    for js, ts in zip(jsids, tsids):
        np.testing.assert_allclose(teng.result(ts).numpy(),
                                   np.asarray(jeng.result(js)), **TOL)


def test_abort_then_reuse_is_bit_clean():
    fresh = ReconstructionEngine(G, n_slots=1, pbatch=4, device="cpu")
    sid = fresh.begin_scan()
    fresh.submit(sid, ProjectionChunk(PROJS, MATS, np.arange(G.n_proj)))
    fresh.drain()
    clean = fresh.result(sid).clone()

    eng = ReconstructionEngine(G, n_slots=1, pbatch=4, device="cpu")
    bad = eng.begin_scan()
    eng.submit(bad, ProjectionChunk(PROJS[:4] * 1e3, MATS[:4],
                                    np.arange(4)))
    assert eng.stats["folds"] == 4
    queued = eng.begin_scan()
    eng.abort_scan(bad)
    assert eng.stats["aborted"] == 1 and eng.slot_scan == [queued]
    eng.submit(queued, ProjectionChunk(PROJS, MATS, np.arange(G.n_proj)))
    eng.drain()
    assert torch.equal(eng.result(queued), clean)
    with pytest.raises(ValueError, match="unknown"):
        eng.abort_scan(bad)


def test_streamed_matches_one_shot_and_result_pops():
    eng = ReconstructionEngine(G, n_slots=1, pbatch=4, device="cpu")
    sid = eng.begin_scan(n_proj=G.n_proj)
    for projs, mats, idx in _chunks(11, (2, 2, 2)):
        eng.submit(sid, ProjectionChunk(projs, mats, idx))
    eng.drain()
    vol = eng.result(sid, pop=True)
    np.testing.assert_allclose(vol.numpy(), REF, **TOL)
    assert sid not in eng.scans
    eng.release(sid)                  # idempotent after eviction


def test_engine_rejects_bad_submissions(tmp_path, monkeypatch):
    eng = ReconstructionEngine(G, n_slots=1, pbatch=4, device="cpu")
    with pytest.raises(ValueError, match="n_proj"):
        eng.begin_scan(n_proj=0)
    sid = eng.begin_scan(n_proj=2)
    with pytest.raises(ValueError, match="angle ind"):
        eng.submit(sid, ProjectionChunk(PROJS[0], MATS[0], G.n_proj))
    with pytest.raises(ValueError, match="matrices"):
        eng.submit(sid, ProjectionChunk(PROJS[:2], MATS[:1], np.arange(2)))
    with pytest.raises(ValueError, match="not finished"):
        eng.result(sid)
    with pytest.raises(ValueError, match="still active"):
        eng.release(sid)
    with pytest.raises(ValueError, match="declared"):
        eng.submit(sid, ProjectionChunk(PROJS[:3], MATS[:3], np.arange(3)))
    with pytest.raises(TypeError, match="ProjectionChunk"):
        eng.submit(sid, PROJS[:2])
    eng.submit(sid, ProjectionChunk(PROJS[:2], MATS[:2], np.arange(2)))
    assert eng.scans[sid].done
    with pytest.raises(ValueError, match="finished"):
        eng.submit(sid, ProjectionChunk(PROJS[2], MATS[2], 2))
    # "auto" resolves through the dispatcher: with in-situ
    # selection off and no cached decision, to the strip2 fallback.
    from repro_torch.dispatch import ExecutionPlan, reset_dispatcher

    monkeypatch.setenv("REPRO_TORCH_DISPATCH_INSITU", "0")
    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path / "tune"))
    reset_dispatcher()
    try:
        auto = ReconstructionEngine(G, strategy="auto", device="cpu")
    finally:
        reset_dispatcher()
    assert auto.exec_plan == ExecutionPlan.explicit("strip2")
    with pytest.raises(ValueError, match="strip_dtype"):
        ReconstructionEngine(G, strategy="strip2", strip_dtype="int4",
                             device="cpu")


@pytest.mark.parametrize("pallas", [
    pytest.param({"ty": 8, "chunk": 16, "band": 16, "width": 128,
                  "double_buffer": True, "db_depth": 2, "pbatch": 3},
                 id="db"),
    pytest.param({"ty": 4, "chunk": 16, "band": 16, "width": 128,
                  "micro": True, "micro_group": 8, "micro_band": 8,
                  "micro_width": 32, "pbatch": 2}, id="micro"),
    pytest.param({"ty": 8, "chunk": 16, "band": 16, "width": 128,
                  "shared_window": True, "pbatch": 4}, id="shared"),
])
def test_tuned_kernel_plan_folds_like_reference_engine(pallas):
    """An engine on a plan whose tuned kernel config beat the strategies
    (``use_pallas``) folds every batch through that kernel (the plain
    version on the CPU) at the decision's depth, and serves what the
    reference engine serves on the same tuned plan through its Pallas
    variant (interpret mode), to 1e-5.  (Float32 wire: each engine
    filters with its own FFT, and a narrow wire's rounding would turn
    their last-bit differences into whole bf16 steps.)"""
    from repro.dispatch import ExecutionPlan as JPlan
    from repro_torch import convert

    ref_plan = JPlan.explicit("strip2")._replace(
        pallas=tuple(sorted(pallas.items())), use_pallas=True)
    jeng = jstream.ReconstructionEngine(JG, n_slots=1, plan=ref_plan)
    teng = ReconstructionEngine(
        G, n_slots=1, plan=convert.plan_from_reference(ref_plan.as_dict()),
        device="cpu")
    assert teng.exec_plan.use_pallas and teng.pbatch == pallas["pbatch"]
    jsid, tsid = jeng.begin_scan(), teng.begin_scan()
    for projs, mats, idx in _chunks(13, (4, 2)):
        jeng.submit(jsid, jstream.ProjectionChunk(projs, mats, idx))
        teng.submit(tsid, ProjectionChunk(torch.tensor(projs), mats, idx))
    jeng.drain()
    teng.drain()
    want = np.asarray(jeng.result(jsid))
    got = teng.result(tsid).numpy()
    assert teng.stats["pallas_folds"] == jeng.stats["pallas_folds"] \
        == G.n_proj
    np.testing.assert_allclose(got, want, **TOL)
