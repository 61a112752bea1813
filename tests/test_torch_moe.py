"""The port's MoE layer against the JAX package's on the CPU, on the same
parameters (a small MoE model's layer 0, the reference's seeded init
carried over by ``convert.lm_params_from_reference``) and numpy inputs
from a seed: ``scatter``, ``einsum`` and ``grouped`` each against the
reference's same ``impl``, ``ep`` without a mesh (both fall back to
``scatter``), a capacity that drops assignments, the aux loss and
``moe_capacity``.  float32 within rtol = atol = 2e-4, bfloat16 within
5e-2·max(1, max|ref|).  The mirrors of ``tests/test_moe.py`` follow.

``torch.topk`` and ``jax.lax.top_k`` may order tied probabilities
differently; these inputs have no ties except the uniform router, whose
aux loss is 1 whichever expert a tie picks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import moe

TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fields(E=4, k=2, d=32, ff=16, cf=8.0, dtype="float32"):
    return dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=4,
                n_kv_heads=2, d_ff=0, vocab=64, moe=True, n_experts=E,
                top_k=k, moe_d_ff=ff, capacity_factor=cf,
                param_dtype=dtype)


def _pair(seed=0, **kw):
    """(reference config, reference MoE params, port config, port MoE
    params)."""
    rcfg, cfg = RefConfig(**_fields(**kw)), ModelConfig(**_fields(**kw))
    params, _ = ref_model.init_model(rcfg, jax.random.PRNGKey(seed))
    port = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    ref = jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["moe"])
    return rcfg, ref, cfg, port.layers[0]["moe"]


def _x(shape, seed=100):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(pair, x, dtype, **kw):
    rcfg, ref, cfg, port = pair
    jd, td = DTYPES[dtype]
    want, waux = ref_moe.moe_forward(ref, rcfg, jnp.asarray(x, jd),
                                     dtype=jd, **kw)
    got, aux = moe.moe_forward(port, cfg, torch.tensor(x).to(td), dtype=td,
                               **kw)
    return (got, aux), (np.asarray(want, np.float32), float(waux))


def _check(got, want, dtype):
    (g, ga), (w, wa) = got, want
    assert g.shape == w.shape
    tol = TOL if dtype == "float32" else dict(
        rtol=0, atol=5e-2 * max(1.0, float(np.abs(w).max())))
    np.testing.assert_allclose(g.float().numpy(), w, **tol)
    assert ga.dtype == torch.float32
    np.testing.assert_allclose(float(ga), wa, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["scatter", "einsum", "grouped"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 16)])
def test_impl_matches_reference(impl, dtype, shape):
    pair = _pair(seed=sum(shape), dtype=dtype)
    x = _x(shape + (32,), seed=shape[1])
    _check(*_both(pair, x, dtype, impl=impl), dtype)


@pytest.mark.parametrize("groups", [2, 5])
def test_grouped_with_groups_matches_reference(groups):
    """Explicit group counts: 2 divides N = 32, 5 does not (the
    reference steps G down to 4)."""
    pair = _pair(seed=3, cf=0.5)
    x = _x((2, 16, 32), seed=4)
    _check(*_both(pair, x, "float32", impl="grouped", groups=groups),
           "float32")


def test_ep_without_a_mesh_is_scatter():
    """No mesh: ``ep`` is ``scatter`` in both packages."""
    pair = _pair(seed=5, cf=0.5)
    x = _x((2, 16, 32), seed=6)
    got, want = _both(pair, x, "float32", impl="ep")
    _check(got, want, "float32")
    _, _, cfg, port = pair
    scat, _ = moe.moe_forward(port, cfg, torch.tensor(x),
                              dtype=torch.float32)
    assert torch.equal(got[0], scat)


def test_unknown_impl_raises():
    _, _, cfg, port = _pair()
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_forward(port, cfg, torch.zeros((1, 2, 32)), impl="dense")


@pytest.mark.parametrize("impl", ["scatter", "einsum", "grouped"])
def test_dropping_capacity_matches_reference(impl):
    """capacity_factor 1e-9: C floors at 8 of 256 tokens' 512 assignments,
    so most drop; the same ones as the reference's (the stable order of
    the token-major assignment list), and the rows with every assignment
    dropped are exactly zero (mirror of ``test_capacity_drops_tokens``)."""
    pair = _pair(cf=1e-9)
    cfg = pair[2]
    x = _x((4, 64, 32), seed=0)
    got, want = _both(pair, x, "float32", impl=impl)
    _check(got, want, "float32")
    y = got[0].numpy()
    zero = np.all(y == 0.0, axis=-1)
    np.testing.assert_array_equal(zero, np.all(want[0] == 0.0, axis=-1))
    if impl != "grouped":
        assert zero.sum() >= 4 * 64 - cfg.n_experts * moe.moe_capacity(
            cfg, 256)


def test_scatter_drops_what_the_position_rule_drops():
    """The dropped assignments are those past C in each expert, counted
    in token-major order."""
    _, _, cfg, port = _pair(cf=0.5)
    xf = torch.tensor(_x((48, 32), seed=8))
    _, _, idx = moe._route(port, cfg, xf)
    pos = moe._positions_in_expert(idx.reshape(-1), cfg.n_experts)
    seen = {}
    for n, e in enumerate(idx.reshape(-1).tolist()):
        assert int(pos[n]) == seen.get(e, 0)
        seen[e] = seen.get(e, 0) + 1
    C = moe.moe_capacity(cfg, 48)
    assert int((pos >= C).sum()) == sum(max(0, c - C) for c in seen.values())
    assert int((pos >= C).sum()) > 0


@pytest.mark.parametrize("seed", range(4))
def test_scatter_equals_einsum(seed):
    """Mirror of ``test_scatter_equals_einsum``: the two dispatches agree."""
    _, _, cfg, port = _pair(seed=seed)
    x = torch.tensor(_x((2, 16, 32), seed=seed + 100))
    y1, a1 = moe.moe_forward(port, cfg, x, impl="scatter",
                             dtype=torch.float32)
    y2, a2 = moe.moe_forward(port, cfg, x, impl="einsum",
                             dtype=torch.float32)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a1, a2, rtol=1e-5, atol=0)


def test_aux_loss_uniform_router_is_one():
    """Mirror of ``test_aux_loss_uniform_router_is_one``: a zero router
    gives P_e = 1/E, so aux = sum_e f_e = 1 whatever the tie order."""
    rcfg, ref, cfg, port = _pair(E=8, k=1)
    with torch.no_grad():
        port["router"].zero_()
    ref = dict(ref, router=jnp.zeros_like(ref["router"]))
    x = _x((2, 256, 32), seed=2)
    _, aux = moe.moe_forward(port, cfg, torch.tensor(x), dtype=torch.float32)
    _, waux = ref_moe.moe_forward(ref, rcfg, jnp.asarray(x),
                                  dtype=jnp.float32)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-3)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("E,k,cf,N", [(4, 2, 1.25, 1), (16, 2, 1.25, 512),
                                      (128, 8, 1.25, 4), (384, 8, 1.25, 4096),
                                      (4, 2, 0.25, 24), (4, 2, 1e-9, 256)])
def test_capacity_matches_reference(E, k, cf, N):
    kw = dict(E=E, k=k, cf=cf)
    assert moe.moe_capacity(ModelConfig(**_fields(**kw)), N) == \
        ref_moe.moe_capacity(RefConfig(**_fields(**kw)), N)


def test_init_shapes_and_scales():
    """The port's seeded init: the reference's shapes, and each stack's
    scale 1/sqrt(fan-in) (d for the router, gate and up; ff for down)."""
    from repro_torch.models.layers import Params

    cfg = ModelConfig(**_fields(E=4, d=256, ff=128))
    p = Params(torch.float32, torch.device("cpu"),
               torch.Generator().manual_seed(0))
    moe.init_moe(p, cfg)
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == {
        "router": (256, 4), "w_gate": (4, 256, 128),
        "w_up": (4, 256, 128), "w_down": (4, 128, 256)}
    for name, fan_in in (("router", 256), ("w_gate", 256), ("w_up", 256),
                         ("w_down", 128)):
        std = float(p[name].std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, (name, std)


def test_dataclass_fields_agree():
    assert dataclasses.asdict(ModelConfig(**_fields())) == \
        dataclasses.asdict(RefConfig(**_fields()))
