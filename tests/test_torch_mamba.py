"""The port's Mamba (S6) mixer against the JAX package's on the CPU: one
mixer of jamba-v0.1-52b.reduced(), its parameters the reference's seeded
init carried over by ``convert.lm_params_from_reference``, on numpy
inputs from a seed.

``mamba_forward`` with its state, in one chunk and in several (the
reference's ``lax.scan`` over chunks, here a loop carrying ``h``);
``mamba_step`` chained from the reference's own cache; the empty cache.
float32 within rtol = atol = 2e-4: the in-chunk scan is a doubling scan
whose sums round in another order than ``jax.lax.associative_scan``'s.
bfloat16 within 5e-2·max(1, max|ref|).  Then properties of the port
alone: the doubling scan against a plain loop at odd chunk lengths, and
a prefill followed by steps against one forward over all the tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import ssm

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 12
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def mixers():
    """``get(dtype)`` -> (config, reference mixer params, port mixer):
    layer 0 of the reduced model (a Mamba block) from one reference
    init per dtype."""
    made = {}

    def get(dtype):
        if dtype not in made:
            rcfg = dataclasses.replace(REF_ARCHS[ARCH].reduced(),
                                       param_dtype=dtype)
            cfg = dataclasses.replace(ARCHS[ARCH].reduced(),
                                      param_dtype=dtype)
            assert cfg.block_pattern[0] == "mamba"
            params, _ = ref_model.init_model(rcfg, jax.random.PRNGKey(0))
            port = lm_params_from_reference(
                jax.tree.map(np.asarray, params), cfg, device="cpu")
            ref = jax.tree.map(lambda a: a[0],
                               params["blocks"]["b0"]["mixer"])
            made[dtype] = cfg, ref, port.layers[0]["mixer"]
        return made[dtype]

    return get


def _x(cfg, s=S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _check(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    tol = TOL if dtype == "float32" else dict(
        rtol=0, atol=5e-2 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [256, 4])
def test_forward_with_state_matches_reference(mixers, dtype, chunk):
    """chunk 256 does not divide S = 12: one chunk of S; chunk 4: three
    chunks, ``h`` carried between them."""
    cfg, ref, port = mixers(dtype)
    jd, td = DTYPES[dtype]
    x = _x(cfg)
    want, wstate = ref_ssm.mamba_forward(ref, cfg, jnp.asarray(x, jd),
                                         chunk=chunk, dtype=jd,
                                         return_state=True)
    got, gstate = ssm.mamba_forward(port, cfg, torch.tensor(x).to(td),
                                    chunk=chunk, dtype=td,
                                    return_state=True)
    assert got.dtype == td
    _check(got, want, dtype, "out")
    assert sorted(gstate) == sorted(wstate) == ["conv", "h"]
    for k in ("conv", "h"):
        assert gstate[k].dtype == torch.float32, k
        _check(gstate[k], wstate[k], dtype, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_steps_chained_from_the_reference_cache(mixers, dtype):
    """Three ``mamba_step`` s from the reference's prefill cache (carried
    bitwise): each step's output and cache."""
    cfg, ref, port = mixers(dtype)
    jd, td = DTYPES[dtype]
    _, wc = ref_ssm.mamba_forward(ref, cfg, jnp.asarray(_x(cfg), jd),
                                  dtype=jd, return_state=True)
    gc = {k: torch.tensor(np.asarray(v)) for k, v in wc.items()}
    for step, x in enumerate(_x(cfg, s=3, seed=1).swapaxes(0, 1)):
        x = x[:, None]
        want, wc = ref_ssm.mamba_step(ref, cfg, jnp.asarray(x, jd), wc,
                                      dtype=jd)
        got, gc = ssm.mamba_step(port, cfg, torch.tensor(x).to(td), gc,
                                 dtype=td)
        _check(got, want, dtype, f"step {step}")
        for k in ("conv", "h"):
            assert gc[k].dtype == torch.float32
            _check(gc[k], wc[k], dtype, f"step {step} {k}")


def test_init_cache_matches_reference(mixers):
    cfg, _, _ = mixers("float32")
    want = ref_ssm.init_mamba_cache(cfg, 3)
    got = ssm.init_mamba_cache(cfg, 3, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert str(got[k].dtype).endswith(np.asarray(v).dtype.name), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def _loop_scan(dA, dBx, h0):
    h, states = h0, []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        states.append(h)
    return torch.stack(states, 1), h


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 13])
def test_doubling_scan_equals_a_loop(C):
    """The doubling scan at chunk lengths on and off powers of two,
    against the recurrence stepped one token at a time (float64)."""
    g = torch.Generator().manual_seed(C)
    dA = torch.rand((2, C, 3, 4), generator=g, dtype=torch.float64)
    dBx = torch.randn((2, C, 3, 4), generator=g, dtype=torch.float64)
    h0 = torch.randn((2, 3, 4), generator=g, dtype=torch.float64)
    got, last = ssm._ssm_scan_chunk(dA, dBx, h0)
    want, want_last = _loop_scan(dA, dBx, h0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(last, want_last, rtol=1e-12, atol=1e-12)


def test_prefill_then_steps_equal_one_forward(mixers):
    """Prefill of 8 tokens (two chunks of 4), then 4 steps, against a
    forward over all 12 in one chunk: the conv carry and ``h`` continue
    the sequence."""
    cfg, _, port = mixers("float32")
    x = torch.tensor(_x(cfg, seed=2))
    full = ssm.mamba_forward(port, cfg, x, dtype=torch.float32)
    out, cache = ssm.mamba_forward(port, cfg, x[:, :8], chunk=4,
                                   dtype=torch.float32, return_state=True)
    outs = [out]
    for t in range(8, S):
        y, cache = ssm.mamba_step(port, cfg, x[:, t:t + 1], cache,
                                  dtype=torch.float32)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)
