"""The comparison fails what it has to fail: each configuration's control
(one precision lower), and a run whose timed path is broken underneath.
Each drives the whole run but the look for a card, at a size a CPU run
holds.  (One chip makes no exchange between chips to leave out.)"""

import time

import pytest
import torch

import repro_torch.streaming.engine as engine_mod
from bench.harness import cell, control
from bench.tests.conftest import tiny

CPU = torch.device("cpu")
FOLD = engine_mod.fold_projections
CELLS = ["ct512-f32-resident", "ct512-int8-host31", "ct512-f32-frames"]


def run(bench, name="ct512-f32-resident", seed=41):
    return cell.run(bench, name, seed, 0.5, False, CPU, time.perf_counter(),
                    overrides=tiny(bench, name))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(bench, name):
    out = run(bench, name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(bench, name):
    checks, ok = control.run(bench, name, 43, 0.5, CPU, time.perf_counter(),
                             tiny=tiny(bench, name))
    assert not ok, checks


def _unchanged(volume, *args, **kwargs):
    return volume


def _half_batch(volume, images, mats, *args, **kwargs):
    keep = slice(0, max(1, images.shape[0] // 2))
    scale = images.shape[0] / images[keep].shape[0]
    return FOLD(volume, images[keep] * scale, mats[keep], *args, **kwargs)


@pytest.mark.parametrize("name", ["ct512-f32-resident", "ct512-f32-frames"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, fault, name):
    if fault == "answer_altered":
        result = engine_mod.ReconstructionEngine.result

        def altered(self, sid, pop=False):
            vol = result(self, sid, pop=pop)
            vol[vol.shape[0] // 2] *= 1.01
            return vol

        monkeypatch.setattr(engine_mod.ReconstructionEngine, "result",
                            altered)
    else:
        monkeypatch.setattr(engine_mod, "fold_projections",
                            _unchanged if fault == "state_unchanged"
                            else _half_batch)
    out = run(bench, name)
    assert not out["correct"], out["checks"]
