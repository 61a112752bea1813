"""The port's tuner: sweep, cache and ``strategy="auto"`` (CPU).

Mirrors ``tests/test_tune.py``.  Every test isolates the port's tune
directory (``REPRO_TORCH_TUNE_DIR``) in ``tmp_path``, drops the
in-process memo and turns in-situ selection off, so decisions never leak
between tests or from a developer's ``.repro_torch_tune/``.  On the CPU
the kernel candidates are checked but not timed (their times would be
the plain versions'), and the kernel wrappers run the plain versions.
Results are compared bitwise wherever the same computation runs.
"""

import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.backproject import GeomStatic as JGS
from repro.core.geometry import Geometry as JGeometry
from repro.core.phantom import make_dataset
from repro.tune.space import jnp_candidates as j_jnp_candidates
from repro.tune.space import pallas_candidates as j_pallas_candidates
from repro_torch.core.backproject import STRATEGIES, GeomStatic, reconstruct
from repro_torch.core.filtering import filter_projections
from repro_torch.core.geometry import Geometry
from repro_torch.dispatch import Dispatcher, reset_dispatcher, set_dispatcher
from repro_torch.kernels import backproject_batch, backproject_one
from repro_torch.tune import (TUNE_SCHEMA_VERSION, Candidate, TunedConfig,
                              autotune, cache_key, clear_memory_cache,
                              device_identity, load_tuned, store_tuned,
                              sweep_strategies, time_fn)
from repro_torch.tune.space import (jnp_candidates, kernel_smem_bytes,
                                    pallas_batch_fits_smem,
                                    pallas_candidates)

GEOM = Geometry().scaled(16, n_proj=4)
GS = GeomStatic.of(GEOM)
PROJS, MATS, _ = make_dataset(JGeometry().scaled(16, n_proj=4))


@pytest.fixture(autouse=True)
def _isolated_tune_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path / "tune"))
    monkeypatch.setenv("REPRO_TORCH_DISPATCH_INSITU", "0")
    clear_memory_cache()
    reset_dispatcher()
    yield
    clear_memory_cache()
    reset_dispatcher()


@pytest.fixture(scope="module")
def filt():
    return filter_projections(PROJS, GEOM, device="cpu")


def _rec(filt, **kw):
    return reconstruct(filt, MATS, GEOM, device="cpu", **kw)


def _store(**kw):
    backend, device_kind = device_identity()
    cfg = TunedConfig(backend=backend, device_kind=device_kind, **kw)
    store_tuned(GS, cfg)
    return cfg


def test_auto_untuned_matches_strip2_bitwise(filt):
    assert torch.equal(_rec(filt, strategy="auto"),
                       _rec(filt, strategy="strip2"))


def test_auto_follows_tuned_cache(filt):
    _store(strategy="gather", opts={}, us_per_call=1.0)
    a = _rec(filt, strategy="auto")
    assert torch.equal(a, _rec(filt, strategy="gather"))
    assert not torch.equal(a, _rec(filt, strategy="strip2"))


def test_auto_filters_mismatched_caller_opts(filt):
    """Options written for the fallback strategy are shed loudly when
    the cache tuned another one; a typo still raises."""
    _store(strategy="onehot", opts={"vox_block": 64}, us_per_call=1.0)
    with pytest.warns(RuntimeWarning, match="gband"):
        a = _rec(filt, strategy="auto", gband=8)
    assert torch.equal(a, _rec(filt, strategy="onehot", vox_block=64))


def test_unknown_caller_opt_raises(filt):
    with pytest.raises(ValueError, match="unknown option"):
        _rec(filt, strategy="strip2", gbnad=8)
    with pytest.raises(ValueError, match="unknown option"):
        _rec(filt, strategy="auto", gbnad=8)


def test_autotune_sweeps_and_persists_roundtrip():
    cfg = autotune(GEOM, include_pallas=False, warmup=0, iters=1,
                   device="cpu")
    assert cfg.strategy in STRATEGIES and cfg.us_per_call > 0
    assert len(cfg.timings) >= 5
    assert all(t["us_per_call"] > 0 and t["gups"] > 0
               for t in cfg.timings)
    clear_memory_cache()
    back = load_tuned(GS)
    assert back is not None
    assert (back.strategy, back.opts) == (cfg.strategy, cfg.opts)


def test_sweep_skips_undersized_windows():
    bad = Candidate.of("strip2", group=8, gband=2, gwidth=8)
    ok = Candidate.of("gather")
    res = sweep_strategies(GEOM, space=[bad, ok], include_pallas=False,
                           warmup=0, iters=1, device="cpu")
    assert [t.strategy for t in res.timings] == ["gather"]
    assert len(res.skipped) == 1 and "does not cover" in res.skipped[0][1]


def test_stale_schema_versions_are_ignored():
    d = Path(os.environ["REPRO_TORCH_TUNE_DIR"])
    d.mkdir(parents=True, exist_ok=True)
    backend, device_kind = device_identity()
    path = d / f"{cache_key(GS, backend, device_kind)}.json"
    v1 = {"strategy": "gather", "opts": {}, "backend": backend,
          "device_kind": device_kind, "us_per_call": 1.0}
    path.write_text(json.dumps(v1))
    assert load_tuned(GS) is None
    v1["version"] = TUNE_SCHEMA_VERSION + 1
    path.write_text(json.dumps(v1))
    clear_memory_cache()
    assert load_tuned(GS) is None
    v1["version"] = TUNE_SCHEMA_VERSION
    path.write_text(json.dumps(v1))
    clear_memory_cache()
    cfg = load_tuned(GS)
    assert cfg is not None and cfg.strategy == "gather"
    path.write_text("{not json")
    clear_memory_cache()
    assert load_tuned(GS) is None


def test_autotune_persists_current_version_and_pbatch():
    cfg = autotune(GEOM, include_pallas=False, warmup=0, iters=1,
                   device="cpu")
    assert cfg.version == TUNE_SCHEMA_VERSION
    assert "pbatch" in cfg.opts and cfg.pbatch >= 1
    assert any(t["opts"].get("pbatch", 1) > 1 for t in cfg.timings)


def test_cache_file_is_json_keyed_on_device(tmp_path):
    cfg = autotune(GEOM, include_pallas=False, warmup=0, iters=1,
                   device="cpu")
    files = list((tmp_path / "tune").glob("*.json"))
    assert len(files) == 1
    name = files[0].name
    assert f"L{GEOM.L}" in name and "--cpu--" in name
    assert json.loads(files[0].read_text())["strategy"] == cfg.strategy
    assert not Path(".repro_tune").joinpath(name).exists()


def test_repeated_auto_resolution_is_stable(filt, monkeypatch):
    """The counterpart of the reference's jit-cache test: repeated
    ``auto`` calls resolve from the memo, with no new selection and no
    new audit."""
    from repro_torch.tune import audit

    sweeps, audits = [], []
    real_audit = audit.audit_tuned_config
    monkeypatch.setattr(audit, "audit_tuned_config",
                        lambda *a, **k: audits.append(1) or real_audit(
                            *a, **k))

    def fake_sweep(geom, **kw):
        sweeps.append(1)
        return sweep_strategies(geom, warmup=0, iters=1, device="cpu",
                                **{k: kw[k] for k in ("space",)})

    set_dispatcher(Dispatcher(insitu=True, sweep_fn=fake_sweep))
    first = _rec(filt, strategy="auto")
    for _ in range(3):
        assert torch.equal(_rec(filt, strategy="auto"), first)
    assert len(sweeps) == 1 and len(audits) == 1


def test_pallas_auto_uses_tuned_tiles(filt):
    vol0 = torch.zeros((GEOM.L,) * 3)
    img, A = filt[0], MATS[0]
    out_auto = backproject_one(vol0.clone(), img, A, GEOM, ty=4, chunk=8,
                               band=16, width=128, strategy="auto")
    out_fix = backproject_one(vol0.clone(), img, A, GEOM, ty=4, chunk=8,
                              band=16, width=128)
    assert torch.equal(out_auto, out_fix)
    _store(strategy="strip2", opts={}, us_per_call=1.0,
           pallas={"ty": 8, "chunk": 16, "band": 16, "width": 128,
                   "micro": True})
    out_auto = backproject_one(vol0.clone(), img, A, GEOM, strategy="auto")
    out_fix = backproject_one(vol0.clone(), img, A, GEOM, ty=8, chunk=16,
                              band=16, width=128, micro=True)
    assert torch.equal(out_auto, out_fix)
    with pytest.raises(ValueError, match="fixed.*auto|auto.*fixed"):
        backproject_one(vol0, img, A, GEOM, strategy="strip")


def test_pallas_auto_resolves_full_micro_window(filt):
    from repro_torch.tune import resolve_pallas_config

    micro = [dict(c.opts) for c in pallas_candidates(GS)
             if dict(c.opts).get("micro")]
    assert micro
    for opts in micro:
        assert {"micro_group", "micro_band", "micro_width"} <= set(opts)
    win = {"micro_group": 8, "micro_band": 12, "micro_width": 64}
    _store(strategy="strip2", opts={}, us_per_call=1.0,
           pallas={"ty": 8, "chunk": 16, "band": 16, "width": 128,
                   "micro": True, **win})
    resolved = resolve_pallas_config(GS)
    assert {k: resolved[k] for k in win} == win
    vol0 = torch.zeros((GEOM.L,) * 3)
    out_auto = backproject_one(vol0.clone(), filt[0], MATS[0], GEOM,
                               strategy="auto")
    out_fix = backproject_one(vol0.clone(), filt[0], MATS[0], GEOM, ty=8,
                              chunk=16, band=16, width=128, micro=True,
                              **win)
    assert torch.equal(out_auto, out_fix)


def test_pallas_batch_auto_honors_tuned_variant_flags(filt):
    _store(strategy="strip2", opts={}, us_per_call=1.0,
           pallas={"ty": 8, "chunk": 16, "band": 16, "width": 128,
                   "double_buffer": True, "db_depth": 3, "pbatch": 2})
    vol0 = torch.zeros((GEOM.L,) * 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = backproject_batch(vol0.clone(), filt, MATS, GEOM,
                                strategy="auto")
    ref = backproject_batch(vol0.clone(), filt, MATS, GEOM, ty=8, chunk=16,
                            band=16, width=128, pbatch=2,
                            double_buffer=True, db_depth=3)
    assert torch.equal(out, ref)


def test_pallas_one_auto_resolves_tuned_db_depth(filt, monkeypatch,
                                                 caplog):
    """The single-projection path resolves ``db_depth`` with the
    ``double_buffer`` flag.  The result is schedule-invariant, so the
    depth is read where the wrapper picks the kernel.  A tuned depth the
    ring cannot take fails the dispatcher's audit: it is not replayed
    (the reference replays it and raises in the wrapper)."""
    import logging

    from repro_torch.kernels import backproject_ops as ops

    pallas = {"ty": 8, "chunk": 16, "band": 16, "width": 128,
              "double_buffer": True, "db_depth": 4}
    _store(strategy="strip2", opts={}, us_per_call=1.0, pallas=pallas)
    depths = []
    real = ops.resolve_variant
    monkeypatch.setattr(ops, "resolve_variant", lambda gs, **kw: (
        depths.append(kw.get("db_depth")), real(gs, **kw))[1])
    vol0 = torch.zeros((GEOM.L,) * 3)
    out_auto = backproject_one(vol0.clone(), filt[0], MATS[0], GEOM,
                               strategy="auto")
    assert depths[-1] == 4
    out_fix = backproject_one(vol0.clone(), filt[0], MATS[0], GEOM,
                              **pallas)
    assert torch.equal(out_auto, out_fix)
    clear_memory_cache()
    reset_dispatcher()
    _store(strategy="strip2", opts={}, us_per_call=1.0,
           pallas={**pallas, "db_depth": 1})
    with caplog.at_level(logging.WARNING, logger="repro_torch.dispatch"):
        backproject_one(vol0, filt[0], MATS[0], GEOM, strategy="auto")
    assert any("db_depth=1" in r.message and "not be replayed"
               in r.message for r in caplog.records)
    assert depths[-1] == 2          # the caller's default ran
    with pytest.raises(ValueError, match="db_depth"):
        backproject_one(vol0, filt[0], MATS[0], GEOM, **pallas | {
            "db_depth": 1})


def test_pallas_batch_candidates_cross_variants():
    cands = [dict(c.opts) for c in pallas_candidates(GS)]
    batched = [c for c in cands if c.get("pbatch", 1) > 1]
    assert any(c.get("double_buffer") for c in batched)
    assert any(c.get("micro") for c in batched)
    assert any(not c.get("double_buffer") and not c.get("micro")
               for c in batched)
    for c in batched:
        if c.get("double_buffer"):
            assert c["db_depth"] >= 2
            assert pallas_batch_fits_smem(
                pbatch=c["pbatch"], ty=c["ty"], chunk=c["chunk"],
                band=c["band"], width=c["width"], depth=c["db_depth"])
        if c.get("micro"):
            assert {"micro_group", "micro_band", "micro_width"} <= set(c)
        assert not (c.get("double_buffer") and c.get("micro"))


def test_candidate_space_spans_new_axes():
    assert any(dict(c.opts).get("strip_dtype") == "bfloat16"
               for c in jnp_candidates(GS))
    cands = [dict(c.opts) for c in pallas_candidates(GS)]
    assert any(c.get("strip_dtype") == "bfloat16"
               and not c.get("shared_window") for c in cands)
    shared = [c for c in cands if c.get("shared_window")]
    assert shared and {c.get("strip_dtype", "float32") for c in shared} \
        == {"float32", "bfloat16", "int8"}
    for c in shared:
        assert not c.get("double_buffer") and not c.get("micro")


@pytest.mark.parametrize("L", [16, 32, 512])
def test_candidate_sets_match_reference(L):
    """The reference's candidate set and order, at the test sizes and at
    full width (where the shared-memory screen admits what the VMEM
    screen admitted)."""
    g = Geometry().scaled(L, n_proj=4) if L < 512 else Geometry()
    gs = GeomStatic.of(g)
    jgs = JGS(*gs)
    assert [c.label for c in jnp_candidates(gs)] == \
        [c.label for c in j_jnp_candidates(jgs)]
    assert [c.label for c in pallas_candidates(gs)] == \
        [c.label for c in j_pallas_candidates(jgs)]


def test_sweep_times_or_skips_shared_and_bf16():
    """Each candidate is timed or skipped with its reason; on the CPU the
    kernel candidates are checked, then skipped (their times would be
    the plain versions')."""
    space = [
        Candidate.of("strip2", group=8, gband=8, gwidth=64,
                     strip_dtype="bfloat16", pbatch=2),
        Candidate.of("pallas", ty=8, chunk=16, band=16, width=128,
                     pbatch=2, strip_dtype="bfloat16"),
        Candidate.of("pallas", ty=8, chunk=16, band=16, width=128,
                     pbatch=2, shared_window=True),
        Candidate.of("pallas", ty=8, chunk=16, band=4, width=128,
                     pbatch=2, double_buffer=True),
    ]
    res = sweep_strategies(GEOM, space=space, include_pallas=True,
                           warmup=0, iters=1, min_total_s=0, device="cpu")
    assert len(res.timings) + len(res.skipped) == len(space)
    assert [t.strategy for t in res.timings] == ["strip2"]
    reasons = dict(res.skipped)
    assert "need at least" in reasons[space[3].label]
    for cand in space[1:3]:
        assert "CUDA" in reasons[cand.label]


def test_resolve_strategy_passes_strip_dtype():
    from repro_torch.tune.cache import resolve_strategy

    _store(strategy="strip2", opts={"strip_dtype": "bfloat16",
                                    "pbatch": 2}, us_per_call=1.0)
    strategy, opts = resolve_strategy(GS)
    assert strategy == "strip2" and opts["strip_dtype"] == "bfloat16"


def test_shared_memory_screen_and_time_fn():
    """The byte model counts the staged windows at the wire's itemsize
    and the P x 12 matrices; a K5 slab past 227 KB does not fit; the
    timer measures a CPU call with the host clock."""
    f32 = kernel_smem_bytes(GS, {"double_buffer": True, "db_depth": 3,
                                 "ty": 8, "chunk": 16, "band": 16,
                                 "width": 128, "pbatch": 4})
    int8 = kernel_smem_bytes(GS, {"double_buffer": True, "db_depth": 3,
                                  "ty": 8, "chunk": 16, "band": 16,
                                  "width": 128, "pbatch": 4,
                                  "strip_dtype": "int8"})
    # Per slot a 32-byte item record and the window's worst-case box:
    # 16 rows of (bytes / 16 + 1) 16-byte units.
    assert f32 == 4 * 48 + 3 * (32 + 16 * (512 // 16 + 1) * 16)
    assert int8 == 4 * 48 + 3 * (32 + 16 * (128 // 16 + 1) * 16)
    assert kernel_smem_bytes(GS, {"ty": 8}) == 0
    assert not pallas_batch_fits_smem(pbatch=8, ty=8, chunk=32,
                                      band=64, width=512, depth=8)
    t = time_fn(torch.zeros, 1000, warmup=0, iters=3, min_total_s=0)
    assert t > 0
