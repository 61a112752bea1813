"""Kernel row 10 (the sLSTM recurrence) against the JAX package on the
CPU: the port's plain recurrence, through its wrapper and the sLSTM
mixer, against the reference's scan (``slstm_forward``), its Pallas
kernel's wrapper (``fused_slstm_forward``, interpret mode), its final
state (``return_state=True``) and its decode step (``slstm_step``),
from the same numpy inputs.

Tolerance rtol = atol = 2e-4, the reference's own kernel test's
(``tests/test_kernel_slstm.py``): the exponentials and ``tanh`` of the
two frameworks differ by ulps, which the recurrence carries along.
bfloat16 mixers at 5e-2, that test's bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.kernels.slstm_ops import fused_slstm_forward as ref_fused
from repro.models import ssm as ref_ssm
from repro_torch.kernels.slstm_ops import (fused_slstm_forward,
                                           slstm_recurrence)
from repro_torch.kernels.slstm_ref import (init_slstm_state, slstm_cell_ref,
                                           slstm_recurrence_ref, softplus)
from repro_torch.models import ssm

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg(d=32, expand=2):
    return ModelConfig(name="t", family="ssm", n_layers=2, d_model=d,
                       n_heads=4, n_kv_heads=2, d_ff=0, vocab=64,
                       ssm_expand=expand, param_dtype="float32")


def _params(cfg, seed=0):
    """The mixer's parameters from numpy, for both packages."""
    rng = np.random.default_rng(seed)
    d, di = cfg.d_model, cfg.d_inner
    arrays = {
        "zifo": rng.standard_normal((d, 4 * di)) / np.sqrt(d),
        "r_zifo": rng.standard_normal((4, di)) / np.sqrt(di),
        "out_proj": rng.standard_normal((di, d)) / np.sqrt(di),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()})


def _x(B, S, d, seed=1):
    x = (np.random.default_rng(seed).standard_normal((B, S, d))
         * 0.5).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("B,S,d", [(2, 16, 32), (3, 40, 16), (8, 64, 64)])
def test_mixer_matches_scan_and_pallas_kernel(B, S, d):
    cfg = _cfg(d)
    jp, tp = _params(cfg)
    jx, tx = _x(B, S, d)
    got = fused_slstm_forward(tp, cfg, tx, dtype=torch.float32)
    _close(got, ref_ssm.slstm_forward(jp, cfg, jx, dtype=jnp.float32))
    _close(got, ref_fused(jp, cfg, jx, dtype=jnp.float32, interpret=True))
    # The model's mixer is the same function.
    _close(ssm.slstm_forward(tp, cfg, tx, dtype=torch.float32), got,
           rtol=0, atol=0)


def test_bf16_mixer_close():
    cfg = _cfg(32)
    jp, tp = _params(cfg)
    jx, tx = _x(2, 24, 32)
    got = fused_slstm_forward(tp, cfg, tx, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, ref_ssm.slstm_forward(jp, cfg, jx, dtype=jnp.float32),
           rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("B,S", [(2, 16), (1, 33)])
def test_final_state_matches_return_state(B, S):
    cfg = _cfg(32)
    jp, tp = _params(cfg, seed=2)
    jx, tx = _x(B, S, 32, seed=3)
    got_y, got = ssm.slstm_forward(tp, cfg, tx, dtype=torch.float32,
                                   return_state=True)
    want_y, want = ref_ssm.slstm_forward(jp, cfg, jx, dtype=jnp.float32,
                                         return_state=True)
    _close(got_y, want_y)
    assert sorted(got) == sorted(want) == ["c", "h", "m", "n"]
    for k in want:
        _close(got[k], want[k])


def test_step_from_cached_state_matches_slstm_step():
    """S = 1 from a cached state (a prefill of 12 tokens) against the
    reference's decode step, and the fresh cache (m = -inf) too."""
    cfg = _cfg(32)
    jp, tp = _params(cfg, seed=4)
    jx, tx = _x(3, 13, 32, seed=5)
    _, jcache = ref_ssm.slstm_forward(jp, cfg, jx[:, :12], dtype=jnp.float32,
                                      return_state=True)
    tcache = {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}
    fresh_j = ref_ssm.init_slstm_cache(cfg, 3)
    fresh_t = ssm.init_slstm_cache(cfg, 3, device="cpu")
    for k in fresh_j:
        np.testing.assert_array_equal(fresh_t[k].numpy(),
                                      np.asarray(fresh_j[k]))
    for jc, tc in ((jcache, tcache), (fresh_j, fresh_t)):
        got_y, got = ssm.slstm_step(tp, cfg, tx[:, 12:13], tc,
                                    dtype=torch.float32)
        want_y, want = ref_ssm.slstm_step(jp, cfg, jx[:, 12:13], jc,
                                          dtype=jnp.float32)
        _close(got_y, want_y)
        for k in want:
            _close(got[k], want[k])


def test_recurrence_from_a_carried_state_matches_reference_cell():
    """The plain recurrence from a non-zero initial state against the
    reference's ``_slstm_cell`` iterated, and the wrapper on the CPU runs
    the plain version."""
    rng = np.random.default_rng(6)
    B, S, di = 2, 20, 24
    zifo = rng.standard_normal((B, S, 4, di)).astype(np.float32)
    r = (rng.standard_normal((4, di)) * 0.3).astype(np.float32)
    st = rng.standard_normal((4, B, di)).astype(np.float32)
    st[1] = np.abs(st[1]) + 1.0
    state = tuple(jnp.asarray(s) for s in st)
    hs = []
    for t in range(S):
        state = ref_ssm._slstm_cell(jnp.asarray(zifo[:, t].reshape(B, -1)),
                                    jnp.asarray(r), state)
        hs.append(state[2])
    got_hs, got = slstm_recurrence_ref(torch.tensor(zifo), torch.tensor(r),
                                       torch.tensor(st))
    _close(got_hs, jnp.stack(hs, axis=1))
    _close(got, jnp.stack(state))
    w_hs, w = slstm_recurrence(torch.tensor(zifo), torch.tensor(r),
                               torch.tensor(st))
    assert torch.equal(w_hs, got_hs) and torch.equal(w, got)


def test_fresh_state_and_first_step():
    """m = -inf before the first token gives a decay of 0, not NaN."""
    st = init_slstm_state(2, 5, device="cpu")
    assert torch.equal(st[:3], torch.zeros(3, 2, 5))
    assert bool(torch.isinf(st[3]).all() and (st[3] < 0).all())
    g = torch.randn(2, 4, 5, generator=torch.Generator().manual_seed(0))
    new = slstm_cell_ref(g, torch.ones(4, 5), st)
    assert bool(torch.isfinite(new).all())
    assert torch.equal(new[3], g[:, 1])          # m' = i on a fresh state
    assert torch.equal(new[1], torch.ones(2, 5))  # n' = exp(i - m') = 1


def test_softplus_is_jax_softplus():
    """logaddexp(x, 0), not torch's softplus (the identity above 20)."""
    x = np.array([-80.0, -20.5, -1.0, 0.0, 1e-3, 3.0, 20.5, 80.0],
                 np.float32)
    np.testing.assert_allclose(softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def test_wrapper_refuses_other_devices():
    zifo = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        slstm_recurrence(zifo, torch.zeros(4, 8, device="meta"))
