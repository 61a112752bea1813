"""Why ``chip_smoke.py`` (phase 11) bounds a prefill's whole decode cache
in float32 at the sLSTM kernel's tolerance, and in bfloat16 only against
a gross fault.

A 12-layer xlstm at small widths (the reduced config at xlstm-125m's
depth) is prefilled on the CPU on the plain versions, and again with the
plain recurrence's h off by the factor ``1 + eps`` (its hidden states and
its final state's h), as a kernel that far off would give.  The
difference is ``max |d| / (1 + |ref|)`` over every cache leaf:

* bfloat16: ``eps = 1e-6``, 200 times inside the tolerance and about the
  size of the kernel's own error in h, moves the cache by more than ten
  times the tolerance: a bfloat16 rounding flips, and the change spreads
  over the layers.  So at the tolerance the whole bfloat16 cache holds
  only a kernel that is bitwise its plain version.
* float32: ``eps = 1e-6`` stays within the tolerance, and ``eps = 1e-3``
  (five times it) breaks it.

The tolerance is the kernel's, rtol = atol = 2e-4
(``chip_smoke.SLSTM_TOL``).  Three seeds each.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro_torch.kernels.slstm_ops as sops
from repro_torch.configs import ARCHS
from repro_torch.kernels.slstm_ref import slstm_recurrence_ref
from repro_torch.models import init_model, prefill

TOL = 2e-4
N_LAYERS, PROMPT, MAX_LEN = 12, 256, 1024


def _cfg(dtype):
    return dataclasses.replace(ARCHS["xlstm-125m"].reduced(),
                               n_layers=N_LAYERS, param_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _model_and_tokens(dtype, seed):
    cfg = _cfg(dtype)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (1, PROMPT))
    return init_model(cfg, seed=seed, device="cpu"), torch.tensor(toks)


@functools.lru_cache(maxsize=None)
def _cache(dtype, seed, eps=0.0):
    """The prefill's decode cache, the plain recurrence's h off by the
    factor ``1 + eps``."""
    model, toks = _model_and_tokens(dtype, seed)

    def faulty(zifo, r, state):
        hs, final = slstm_recurrence_ref(zifo, r, state)
        final = final.clone()
        final[2] *= 1 + eps
        return hs * (1 + eps), final

    orig = sops.slstm_recurrence_ref
    sops.slstm_recurrence_ref = faulty
    try:
        return prefill(model, _cfg(dtype), {"tokens": toks}, MAX_LEN)[1]
    finally:
        sops.slstm_recurrence_ref = orig


def _cache_err(got, want):
    return max(float(((a - b).abs() / (1 + b.abs())).max())
               for n in got["blocks"] for a, b in
               zip(got["blocks"][n].values(), want["blocks"][n].values()))


@functools.lru_cache(maxsize=None)
def _moved(dtype, seed, eps):
    return _cache_err(_cache(dtype, seed, eps), _cache(dtype, seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_cache_moves_past_the_tolerance_with_h_off_by_1e6(seed):
    assert _moved("bfloat16", seed, 1e-6) > 10 * TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_cache_holds_h_off_by_1e6(seed):
    assert _moved("float32", seed, 1e-6) <= TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_cache_sees_h_off_by_1e3(seed):
    assert _moved("float32", seed, 1e-3) > TOL
