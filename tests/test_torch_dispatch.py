"""The port's dispatch layer: ExecutionPlan + Dispatcher (CPU).

Mirrors ``tests/test_dispatch.py``: the three resolution outcomes (cache
hit, in-situ first-call selection, structured fallback), the plan's
hash-equality contract, the engine's tuned-kernel fold, and the plan's
fields against the reference's for the same tuned decision.  Every test
isolates the port's tune directory in ``tmp_path`` and turns in-situ
selection off through the environment; tests that select opt back in
with ``Dispatcher(insitu=True)`` or an injected ``sweep_fn``.
Tolerances: bitwise where the same computation runs; 1e-5 (abs and rel)
streamed against one-shot, as the reference's own tests.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.geometry import Geometry as JGeometry
from repro.core.phantom import make_dataset
from repro.dispatch import ExecutionPlan as JPlan
from repro.tune import TunedConfig as JTunedConfig
from repro_torch.core.backproject import GeomStatic, reconstruct
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry
from repro_torch.dispatch import (Dispatcher, ExecutionPlan, get_dispatcher,
                                  insitu_candidates, reset_dispatcher,
                                  set_dispatcher)
from repro_torch.streaming import ProjectionChunk, ReconstructionEngine
from repro_torch.tune import (TUNE_SCHEMA_VERSION, TunedConfig, cache_key,
                              clear_memory_cache, device_identity,
                              store_tuned)
from repro_torch.tune.sweep import SweepResult, Timing

GEOM = Geometry().scaled(16, n_proj=4)
GS = GeomStatic.of(GEOM)
PROJS, MATS, _ = make_dataset(JGeometry().scaled(16, n_proj=4))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def tune_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path / "tune"))
    monkeypatch.setenv("REPRO_TORCH_DISPATCH_INSITU", "0")
    clear_memory_cache()
    reset_dispatcher()
    yield tmp_path / "tune"
    clear_memory_cache()
    reset_dispatcher()


@pytest.fixture(scope="module")
def filt():
    return filter_projections(PROJS, GEOM, device="cpu")


def _rec(filt, **kw):
    return reconstruct(filt, MATS, GEOM, device="cpu", **kw)


def _fake_sweep_result():
    gather = Timing(label="gather[pbatch=2]", strategy="gather",
                    opts=(("pbatch", 2),), us_per_call=11.0, gups=1.0)
    strip2 = Timing(label="strip2[pbatch=4]", strategy="strip2",
                    opts=(("pbatch", 4),), us_per_call=22.0, gups=1.0)
    return SweepResult(geom_key=tuple(GS), backend="cpu",
                       device_kind="cpu", timings=[gather, strip2],
                       skipped=[])


def _cfg(**kw):
    backend, device_kind = device_identity()
    return TunedConfig(backend=backend, device_kind=device_kind, **kw)


# ----------------------------------------------------------------------
# ExecutionPlan
# ----------------------------------------------------------------------

def test_plan_hash_equality_across_construction_paths():
    a = ExecutionPlan.explicit("strip2", pbatch=2)
    b = ExecutionPlan.from_tuned(_cfg(strategy="strip2", opts={"pbatch": 2},
                                      us_per_call=1.0))
    assert a == b and hash(a) == hash(b)
    assert {a: "built"}[b] == "built"
    assert a.label == "strip2@p2"


def test_plan_explicit_validates_strictly():
    with pytest.raises(ValueError, match="auto"):
        ExecutionPlan.explicit("fastest")
    with pytest.raises(ValueError, match="gband"):
        ExecutionPlan.explicit("onehot", {"gband": 8})
    with pytest.raises(ValueError, match="unknown option"):
        ExecutionPlan.explicit("strip2", {"gbnad": 8})


@pytest.mark.parametrize("fields,caller", [
    pytest.param(dict(strategy="strip2", opts={"group": 8, "pbatch": 2},
                      us_per_call=10.0,
                      pallas={"ty": 8, "chunk": 16, "band": 16,
                              "width": 128, "pbatch": 2},
                      pallas_us=5.0), {"gband": 16}, id="kernel-wins"),
    pytest.param(dict(strategy="strip2", opts={}, us_per_call=10.0,
                      pallas={"ty": 8, "chunk": 16, "band": 16,
                              "width": 128, "double_buffer": True,
                              "db_depth": 4}, pallas_us=50.0), None,
                 id="kernel-slower"),
    pytest.param(dict(strategy="onehot", opts={"vox_block": 64},
                      us_per_call=3.0,
                      pallas={"shared_window": True, "pbatch": 4,
                              "strip_dtype": "int8"}, pallas_us=1.0),
                 None, id="shared-int8"),
])
def test_plan_from_tuned_merges_and_flags_kernel(fields, caller):
    """The plan a tuned decision gives equals the reference's for the
    same TunedConfig fields, field by field."""
    plan = ExecutionPlan.from_tuned(_cfg(**fields), caller)
    ref = JPlan.from_tuned(JTunedConfig(backend="cpu", device_kind="cpu",
                                        **fields), caller)
    assert plan.as_dict() == ref.as_dict()
    assert plan.label == ref.label
    assert plan.use_pallas == (fields["pallas_us"] < fields["us_per_call"])
    assert plan.pallas_opts() == ref.pallas_opts()


def test_cache_key_carries_the_card():
    """A decision made on the card is keyed ("cuda", <card name>), apart
    from the CPU's and from another card's."""
    key = cache_key(GS, *device_identity("cuda", "NVIDIA H100 80GB HBM3"))
    assert key.endswith("--cuda--NVIDIA-H100-80GB-HBM3")
    assert key != cache_key(GS, *device_identity("cuda", "NVIDIA H200"))
    d = Dispatcher(backend="cuda", device_kind="NVIDIA H100 80GB HBM3",
                   insitu=False)
    assert d.device == "cuda" and d._include_pallas()
    assert not Dispatcher(backend="cpu", insitu=False)._include_pallas()


# ----------------------------------------------------------------------
# Fallback (selection unavailable)
# ----------------------------------------------------------------------

def test_fallback_warns_once_with_key_and_matches_strip2(filt, caplog):
    d = Dispatcher(insitu=False)
    key = cache_key(GS, d.backend, d.device_kind)
    with caplog.at_level(logging.WARNING, logger="repro_torch.dispatch"):
        plan = d.resolve(GEOM)
        d.resolve(GEOM)
    warns = [r for r in caplog.records if "falling back" in r.message]
    assert len(warns) == 1
    assert key in warns[0].message
    assert "REPRO_TORCH_DISPATCH_INSITU" in warns[0].message
    assert plan == ExecutionPlan.explicit("strip2")
    set_dispatcher(d)
    assert torch.equal(_rec(filt, strategy="auto"),
                       _rec(filt, strategy="strip2"))


def test_resolve_kernel_fallback_and_hit(caplog):
    d = Dispatcher(insitu=False)
    with caplog.at_level(logging.WARNING, logger="repro_torch.dispatch"):
        assert d.resolve_kernel(GEOM) is None
    assert any("falling back" in r.message for r in caplog.records)
    store_tuned(GS, _cfg(strategy="strip2", opts={}, us_per_call=1.0,
                         pallas={"ty": 8, "chunk": 16, "band": 16,
                                 "width": 128, "micro": True,
                                 "micro_group": 8, "micro_band": 12,
                                 "micro_width": 64}))
    tiles = Dispatcher(insitu=False).resolve_kernel(GEOM)
    assert tiles["micro"] and tiles["micro_band"] == 12


# ----------------------------------------------------------------------
# In-situ first-call selection
# ----------------------------------------------------------------------

def test_insitu_shortlist_is_deterministic():
    a = insitu_candidates(GS, topk=6)
    b = insitu_candidates(GS, topk=6)
    assert [c.label for c in a] == [c.label for c in b]
    assert a[0].strategy == "strip2"
    assert len(a) <= 6 and len(set(map(id, a))) == len(a)
    with_kernels = insitu_candidates(GS, topk=6, include_pallas=True)
    assert any(c.strategy == "pallas" for c in with_kernels)
    assert all(c.pbatch > 1 for c in with_kernels
               if c.strategy == "pallas")
    from repro.core.backproject import GeomStatic as JGS
    from repro.dispatch import insitu_candidates as j_insitu

    jgs = JGS(*GS)
    for include in (False, True):
        assert [c.label for c in insitu_candidates(
            GS, include_pallas=include)] == \
            [c.label for c in j_insitu(jgs, include_pallas=include)]


def test_insitu_selects_persists_and_never_retimes(tune_dir, caplog):
    calls = []

    def fake_sweep(geom, *, space, warmup, iters, min_total_s):
        calls.append((len(space), warmup, iters, min_total_s))
        return _fake_sweep_result()

    d = Dispatcher(insitu=True, sweep_fn=fake_sweep)
    with caplog.at_level(logging.INFO, logger="repro_torch.dispatch"):
        plan = d.resolve(GEOM)
    assert len(calls) == 1 and calls[0][1:] == (1, 1, 0.0)
    assert plan == ExecutionPlan.explicit("gather", pbatch=2)
    sel = [r for r in caplog.records if "in-situ selection" in r.message]
    assert len(sel) == 1 and "winner=gather" in sel[0].message

    files = list(Path(tune_dir).glob("*.json"))
    assert len(files) == 1
    data = json.loads(files[0].read_text())
    assert data["version"] == TUNE_SCHEMA_VERSION
    assert data["strategy"] == "gather" and data["opts"]["pbatch"] == 2
    assert len(data["timings"]) == 2

    assert d.resolve(GEOM) == plan and len(calls) == 1

    def boom(*a, **k):
        raise AssertionError("re-timed a cached key")

    clear_memory_cache()
    d2 = Dispatcher(insitu=True, sweep_fn=boom)
    assert d2.resolve(GEOM) == plan
    assert d2.resolve(GS) == plan


def test_insitu_plan_matches_offline_tuned_path_bitwise(filt):
    set_dispatcher(Dispatcher(insitu=True,
                              sweep_fn=lambda g, **k: _fake_sweep_result()))
    assert torch.equal(_rec(filt, strategy="auto"),
                       _rec(filt, strategy="gather", pbatch=2))


def test_insitu_real_sweep_end_to_end(filt, tune_dir, caplog):
    d = Dispatcher(insitu=True, topk=2, include_pallas=False)
    with caplog.at_level(logging.INFO, logger="repro_torch.dispatch"):
        plan = d.resolve(GEOM)
    assert any("in-situ selection" in r.message for r in caplog.records)
    assert plan.strategy in ("strip2", "gather")
    assert len(list(Path(tune_dir).glob("*.json"))) == 1
    set_dispatcher(d)
    assert torch.equal(
        _rec(filt, strategy="auto"),
        _rec(filt, strategy=plan.strategy, pbatch=plan.pbatch,
             **plan.jnp_opts()))


def test_env_flag_gates_insitu(monkeypatch):
    calls = []

    def fake_sweep(geom, **kw):
        calls.append(1)
        return _fake_sweep_result()

    assert Dispatcher(sweep_fn=fake_sweep).resolve(GEOM).strategy \
        == "strip2" and not calls
    monkeypatch.setenv("REPRO_TORCH_DISPATCH_INSITU", "1")
    assert Dispatcher(sweep_fn=fake_sweep).resolve(GEOM).strategy \
        == "gather"
    assert len(calls) == 1


def test_stale_cached_window_is_audited_and_reselected(caplog):
    """A cached decision whose window the planner proves too small is
    never replayed: one warning naming the reasons, then selection."""
    store_tuned(GS, _cfg(strategy="strip2", opts={"gband": 2},
                         us_per_call=1.0,
                         pallas={"ty": 8, "chunk": 16, "band": 4,
                                 "width": 128, "double_buffer": True},
                         pallas_us=0.5))
    d = Dispatcher(insitu=True,
                   sweep_fn=lambda g, **k: _fake_sweep_result())
    with caplog.at_level(logging.WARNING, logger="repro_torch.dispatch"):
        plan = d.resolve(GEOM)
        d.resolve(GEOM)
    warns = [r.message for r in caplog.records
             if "will not be replayed" in r.message]
    assert len(warns) == 1
    assert "strategy window" in warns[0] and "pallas tile" in warns[0]
    assert plan == ExecutionPlan.explicit("gather", pbatch=2)


# ----------------------------------------------------------------------
# Streaming engine: tuned kernel fold
# ----------------------------------------------------------------------

def _serve(eng):
    sid = eng.begin_scan()
    eng.submit(sid, ProjectionChunk(PROJS, MATS, np.arange(GEOM.n_proj)))
    eng.drain()
    return eng.result(sid, pop=True)


def test_engine_runs_tuned_pallas_batch_plan(filt):
    store_tuned(GS, _cfg(strategy="strip2", opts={}, us_per_call=100.0,
                         pallas={"ty": 8, "chunk": 16, "band": 16,
                                 "width": 128, "pbatch": 2},
                         pallas_us=10.0))
    eng = ReconstructionEngine(GEOM, n_slots=1, strategy="auto",
                               device="cpu")
    assert eng.exec_plan.use_pallas and eng.pbatch == 2
    out = _serve(eng)
    assert eng.stats["pallas_folds"] == GEOM.n_proj
    np.testing.assert_allclose(out.numpy(), _rec(filt).numpy(), **TOL)


def test_engine_untuned_fold_unchanged(filt):
    eng = ReconstructionEngine(GEOM, n_slots=1, strategy="auto",
                               device="cpu")
    assert eng.exec_plan.use_pallas is False
    out = _serve(eng)
    assert eng.stats["pallas_folds"] == 0
    np.testing.assert_allclose(out.numpy(), _rec(filt).numpy(), **TOL)


def test_process_dispatcher_is_singleton():
    d = get_dispatcher()
    assert get_dispatcher() is d
    other = Dispatcher(insitu=False)
    assert set_dispatcher(other) is d
    assert get_dispatcher() is other
