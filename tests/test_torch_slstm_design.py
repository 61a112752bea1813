"""The order of operations of the sLSTM kernel (kernel row 10,
``kernels/csrc/slstm.cu``), emulated in PyTorch on the CPU and held to
its plain version.

The CUDA kernel runs only on a card; this emulation follows its steps as
its source writes them, so a change of form that would leave the
tolerance shows here, without a card:

* the stabiliser in base-2 units: ``r`` and the gates scaled by
  ``log2(e)`` (the z gate by ``2 log2(e)``), each pre-activation one
  FMA, ``m`` scaled in and back out;
* one exponential for the two decays: ``d = lm - i``, ``e = 2^-|d|``,
  ``(dec, inc, m') = (1, e, lm)`` if ``d >= 0``, else ``(e, 1, i)``;
* ``log2 f + m = (min(f, 0) + m) - log2(1 + e)``, ``e = 2^-|f|``, the
  log from four terms of its series below ``e = 2^-5`` (a long memory,
  where ``lg2``'s absolute error would compound) and ``lg2(1 + e)``
  above;
* ``tanh`` and ``sigmoid`` from ``2^-|x|`` and one reciprocal, then the
  sign; ``h = (o c) rcp(max(n, 1e-6))``.

``ex2``, ``lg2`` and ``rcp`` are the kernel's ``.approx.ftz`` PTX
instructions.  The emulation takes them exact (flushed to zero below
2^-126) or with an error of the PTX ISA's bound injected into every
call: ``ex2`` relative 2^-22, ``rcp`` relative 2^-23, ``lg2`` absolute
2^-22 (the ISA states 2 ulp, 1 ulp and 2^-22.6 near 1; rounded up here),
with random signs from a fixed seed or all of one sign.  The tolerance
is the kernel's, rtol = atol = 2e-4 (``tests/test_torch_cuda.py``,
``chip_smoke.SLSTM_TOL``).  One case holds the emulation to the JAX
package's ``_slstm_cell`` on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                           slstm_recurrence_ref)

TOL = dict(rtol=2e-4, atol=2e-4)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)   # kLog2e
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)     # kLn2
GATE_SCALE = torch.stack([2 * LOG2E, LOG2E, LOG2E, LOG2E])
SERIES = torch.stack([LOG2E, -0.5 * LOG2E, LOG2E / 3, -0.25 * LOG2E])  # kL1-4
SERIES_MAX = 2.0**-5                                             # kSeriesMax
EX2_REL, RCP_REL, LG2_ABS = 2.0**-22, 2.0**-23, 2.0**-22
FTZ = 2.0**-126


class Sfu:
    """``ex2``, ``lg2`` and ``rcp`` as the kernel calls them: float32
    results, ``ex2`` flushed to zero below 2^-126; in mode ``"exact"``
    the rounded true value, otherwise with the bound's error injected,
    its sign drawn per element (``"random"``) or fixed (``"up"``,
    ``"down"``)."""

    def __init__(self, mode="exact", seed=0):
        self.mode = mode
        self.gen = torch.Generator().manual_seed(seed)

    def _sign(self, like):
        if self.mode == "random":
            return torch.randint(0, 2, like.shape, generator=self.gen,
                                 dtype=torch.float64) * 2 - 1
        return {"exact": 0.0, "up": 1.0, "down": -1.0}[self.mode]

    def ex2(self, x):
        y = (torch.exp2(x.double()) * (1 + self._sign(x) * EX2_REL)).float()
        return torch.where(y < FTZ, torch.zeros_like(y), y)

    def lg2(self, x):
        return (torch.log2(x.double()) + self._sign(x) * LG2_ABS).float()

    def rcp(self, x):
        return (1.0 / x.double() * (1 + self._sign(x) * RCP_REL)).float()


def fma(a, b, c):
    """``fmaf``: the product exact, one rounding (through float64)."""
    return (a.double() * b.double() + c.double()).float()


def select_decays(lm, ig, exp):
    """The kernel's form: one exponential and a select."""
    d = lm - ig
    e = exp(-d.abs())
    keep = d >= 0
    one = torch.ones_like(e)
    return (torch.where(keep, one, e), torch.where(keep, e, one),
            torch.where(keep, lm, ig))


def two_exp_decays(lm, ig, exp):
    """The plain version's form: ``m' = max(lm, i)`` and two exponentials."""
    m_new = torch.maximum(lm, ig)
    return exp(lm - m_new), exp(ig - m_new), m_new


def kernel_step(g, r2, state, sfu, decays=select_decays):
    """``Cell::step``: ``g`` ``(B, 4, di)`` pre-activations, ``r2`` the
    scaled weights, ``state`` ``(c, n, h, m)`` with ``m`` in base-2
    units."""
    c, n, h, m = state
    zx, ig, fx, ox = (fma(r2[q], h, g[:, q] * GATE_SCALE[q])
                      for q in range(4))
    ez = sfu.ex2(-zx.abs())
    z = torch.copysign((1 - ez) * sfu.rcp(1 + ez), zx)
    eo = sfu.ex2(-ox.abs())
    so = sfu.rcp(1 + eo)
    o = torch.where(ox >= 0, so, eo * so)
    ef = sfu.ex2(-fx.abs())
    q = torch.clamp_max(fx, 0) + m
    t = fma(fma(fma(ef, SERIES[3], SERIES[2]), ef, SERIES[1]), ef, SERIES[0])
    lm = torch.where(ef < SERIES_MAX, fma(-ef, t, q), q - sfu.lg2(1 + ef))
    dec, inc, m = decays(lm, ig, sfu.ex2)
    c = fma(c, dec, inc * z)
    n = fma(n, dec, inc)
    h = (o * c) * sfu.rcp(torch.clamp_min(n, 1e-6))
    return c, n, h, m


def emulate(zifo, r, state, sfu, decays=select_decays):
    """The kernel over the sequence: hidden states ``(B, S, di)`` and the
    final state ``(4, B, di)``, ``m`` scaled back to natural units."""
    r2 = r * GATE_SCALE[:, None]
    c, n, h, m = state.unbind(0)
    st = (c, n, h, m * LOG2E)
    hs = []
    for t in range(zifo.shape[1]):
        st = kernel_step(zifo[:, t], r2, st, sfu, decays)
        hs.append(st[2])
    c, n, h, m = st
    return torch.stack(hs, 1), torch.stack([c, n, h, m * LN2])


def _problem(seed, B, S, di, *, shift=0.0, fresh=True, scale=1.0):
    """Seeded numpy inputs: gates (forget gate shifted by ``shift``), r,
    and a fresh (m = -inf) or a carried state."""
    rng = np.random.default_rng(seed)
    zifo = (rng.standard_normal((B, S, 4, di)) * scale).astype(np.float32)
    zifo[:, :, 2] += shift
    r = (rng.standard_normal((4, di)) * 0.3).astype(np.float32)
    if fresh:
        state = init_slstm_state(B, di, device="cpu")
    else:
        st = rng.standard_normal((4, B, di)).astype(np.float32)
        st[1] = np.abs(st[1]) + 1.0
        state = torch.tensor(st)
    return torch.tensor(zifo), torch.tensor(r), state


@pytest.mark.parametrize("exp", [torch.exp, torch.exp2, Sfu().ex2],
                         ids=["exp", "exp2", "ex2_ftz"])
def test_select_equals_two_exponentials_bitwise(exp):
    """``(dec, inc, m')`` from one exponential and a select equal the
    plain version's two exponentials bit for bit: on equal operands, far
    apart ones (flushed to 0), and from ``m = -inf`` (the fresh state:
    ``dec = 0``, ``inc = 1``)."""
    rng = np.random.default_rng(3)
    lm = rng.standard_normal(4096).astype(np.float32) * 40
    ig = rng.standard_normal(4096).astype(np.float32) * 40
    ig[:512] = lm[:512]
    lm[512:1024] = -np.inf
    lm, ig = torch.tensor(lm), torch.tensor(ig)
    got = select_decays(lm, ig, exp)
    want = two_exp_decays(lm, ig, exp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][512:1024], torch.zeros(512))
    assert torch.equal(got[1][512:1024], torch.ones(512))


@pytest.mark.parametrize("fresh", [True, False])
def test_select_recurrence_equals_two_exponential_recurrence(fresh):
    """The whole emulated recurrence with either form of the decays gives
    the same bits."""
    zifo, r, state = _problem(4, 2, 200, 64, shift=3.0, fresh=fresh)
    got = emulate(zifo, r, state, Sfu())
    want = emulate(zifo, r, state, Sfu(), decays=two_exp_decays)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["random", "up", "down"])
@pytest.mark.parametrize("shift", [0.0, 6.0, 12.0])
@pytest.mark.parametrize("fresh", [True, False])
def test_emulation_with_sfu_errors_within_tolerance(fresh, shift, mode):
    """S = 2048 at di = 128, forget pre-activations shifted by 0, +6 and
    +12 (long memory): the hidden states and the final state with the
    approximations' errors injected into every call stay within rtol =
    atol = 2e-4 of the plain recurrence."""
    zifo, r, state = _problem(int(shift) + 10 * fresh, 2, 2048, 128,
                              shift=shift, fresh=fresh)
    got_hs, got = emulate(zifo, r, state, Sfu(mode, seed=7))
    want_hs, want = slstm_recurrence_ref(zifo, r, state)
    torch.testing.assert_close(got_hs, want_hs, **TOL)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", ["random", "up", "down"])
@pytest.mark.parametrize("fresh", [True, False])
def test_chained_single_token_launches_within_tolerance(fresh, mode):
    """A served decode: 256 launches at S = 1, each from the state the
    last one returned, so ``m`` goes into base-2 units and back at every
    step; with the approximations' errors injected, every ``h`` and the
    final state stay within rtol = atol = 2e-4 of the plain recurrence
    chained the same way."""
    zifo, r, state = _problem(20 + fresh, 4, 256, 128, fresh=fresh)
    sfu = Sfu(mode, seed=9)
    got, want, got_hs, want_hs = state, state, [], []
    for t in range(zifo.shape[1]):
        h, got = emulate(zifo[:, t:t + 1], r, got, sfu)
        got_hs.append(h)
        h, want = slstm_recurrence_ref(zifo[:, t:t + 1], r, want)
        want_hs.append(h)
    torch.testing.assert_close(torch.cat(got_hs, 1), torch.cat(want_hs, 1),
                               **TOL)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", ["random", "up", "down"])
def test_emulation_at_extreme_gates(mode):
    """Pre-activations up to |30|: tanh and sigmoid saturate and
    ``2^-|x|`` flushes to 0; still within the tolerance, and finite."""
    zifo, r, state = _problem(5, 2, 256, 128, fresh=False, scale=30.0)
    zifo = zifo.clamp(-30.0, 30.0)
    got_hs, got = emulate(zifo, r, state, Sfu(mode, seed=8))
    want_hs, want = slstm_recurrence_ref(zifo, r, state)
    assert bool(torch.isfinite(got_hs).all() and torch.isfinite(got).all())
    torch.testing.assert_close(got_hs, want_hs, **TOL)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("fresh", [True, False])
def test_emulation_against_the_jax_cell(fresh):
    """The emulated kernel against the JAX package's ``_slstm_cell``
    iterated, on the same numpy inputs."""
    B, S, di = 2, 64, 32
    zifo, r, state = _problem(6, B, S, di, shift=2.0, fresh=fresh)
    got_hs, got = emulate(zifo, r, state, Sfu())
    jstate = tuple(jnp.asarray(s.numpy()) for s in state)
    hs = []
    for t in range(S):
        jstate = ref_ssm._slstm_cell(
            jnp.asarray(zifo[:, t].reshape(B, -1).numpy()),
            jnp.asarray(r.numpy()), jstate)
        hs.append(np.asarray(jstate[2]))
    np.testing.assert_allclose(got_hs.numpy(), np.stack(hs, 1), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.stack([np.asarray(s) for s in jstate]),
                               **TOL)
