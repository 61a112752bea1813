"""The port's loss and train step against the JAX package on the CPU:
``models.model.loss_fn`` and ``training.make_train_step`` on the same
parameters (the reference's seeded init carried over by
``convert.lm_params_from_reference``) and the same numpy batches, for
xlstm-125m, chatglm3-6b and jamba-v0.1-52b at ``reduced()`` in float32.

Bounds, float32:
- the loss, its LM and aux parts, the gradient norm and the learning
  rate within rtol = 2e-6;
- each gradient leaf, in the reference's stacked layout
  (``convert.lm_tree_to_reference``), within 2e-5·max|ref leaf|: the
  same float32 operations, summed in other orders (5e-6 measured);
- the parameters after two steps: none more than lr/2 from the
  reference's and at most one element in a thousand more than 1e-3·lr.
  Adam divides each update by the root of its second moment, so an
  element whose gradient is near zero takes a step of up to lr whose
  size follows the last ulps of that gradient (at most 35 of 107072
  elements beyond 1e-3·lr measured, chatglm3-6b).
A bfloat16 model is held to the reference run op by op (``jax.disable_jit``):
the loss, each gradient leaf, the parameters' change over a step and the
update alone, at the bounds and readings its test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.training import optim as ref_optim
from repro.training import train as ref_train
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference, lm_tree_to_reference
from repro_torch.models import loss_fn
from repro_torch.training import (AdamWConfig, adamw_update,
                                  init_opt_state, make_eval_step,
                                  make_train_step)
from repro_torch.training.train import _grads

ARCHS_UNDER_TEST = ["xlstm-125m", "chatglm3-6b", "jamba-v0.1-52b"]
LR = 1e-3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a).copy(), tree)


def _batches(cfg, n=2, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        b["labels"][0, :3] = -1                  # masked positions
        out.append(b)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _setup(arch, dtype="float32"):
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), param_dtype=dtype)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), param_dtype=dtype)
    params, _ = ref_model.init_model(rcfg, jax.random.PRNGKey(0))
    model = lm_params_from_reference(_np(params), cfg, device="cpu")
    return rcfg, cfg, params, model


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=ARCHS_UNDER_TEST)
def run(request):
    """Two train steps of each package from the same start; the first
    step's gradients of each."""
    arch = request.param
    rcfg, cfg, params, model = _setup(arch)
    b1, b2 = _batches(cfg)
    rocfg = ref_optim.AdamWConfig(lr=LR, warmup_steps=0)
    ocfg = AdamWConfig(lr=LR, warmup_steps=0)
    # Reference: the first step by hand (its gradients kept), the
    # second through its train step.
    (_, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, rcfg, _jnp(b1)), has_aux=True)(params)
    ref_grads = _np(ref_grads)
    ropt = ref_optim.init_opt_state(params, rocfg)
    rparams, ropt, stats = ref_optim.adamw_update(
        jax.tree.map(jnp.asarray, ref_grads), params, ropt, rocfg)
    ref_m1 = {**_np(ref_metrics), **_np(stats)}
    rparams, ropt, ref_m2 = ref_train.make_train_step(rcfg, rocfg)(
        rparams, ropt, _jnp(b2))
    # Port: the first step's gradients as the train step takes them.
    loss, _ = loss_fn(model.requires_grad_(True), cfg, b1)
    port_grads = {k: g.detach().clone() for k, g in _grads(model,
                                                           loss).items()}
    step = make_train_step(cfg, ocfg)
    opt = init_opt_state(model, ocfg)
    model, opt, m1 = step(model, opt, b1)
    model, opt, m2 = step(model, opt, b2)
    return {"cfg": cfg, "ref": (ref_m1, ref_grads, _np(rparams),
                                _np(ref_m2)),
            "port": (m1, port_grads, model, m2)}


def test_metrics_match_reference(run):
    (rm1, _, _, rm2), (m1, _, _, m2) = run["ref"], run["port"]
    for key in ("lm_loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m1[key]), float(rm1[key]),
                                   rtol=2e-6, atol=1e-7, err_msg=key)
    for key in ("loss", "lm_loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[key]), float(rm2[key]),
                                   rtol=2e-6, atol=1e-7, err_msg=key)


def test_gradients_match_reference_leaf_by_leaf(run):
    (_, rgrads, _, _), (_, grads, _, _) = run["ref"], run["port"]
    want = _leaves(rgrads)
    got = _leaves(lm_tree_to_reference(grads, run["cfg"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        assert np.abs(got[path] - w).max() <= 2e-5 * scale, path


def test_parameters_after_two_steps_match_reference(run):
    (_, _, rparams, _), (_, _, model, _) = run["ref"], run["port"]
    want = _leaves(rparams)
    got = _leaves(lm_tree_to_reference(dict(model.named_parameters()),
                                       run["cfg"]))
    n_far = n_all = 0
    for path, w in want.items():
        d = np.abs(got[path] - w)
        assert d.max() <= LR / 2, path
        n_far += int((d > 1e-3 * LR).sum())
        n_all += d.size
    assert n_far <= n_all // 1000


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_accumulated_steps_match_reference(arch):
    """``accum_steps=2``: the gradients of two microbatches added in
    float32 and halved; the loss their mean, the other metrics the last
    microbatch's."""
    rcfg, cfg, params, model = _setup(arch)
    (b,) = _batches(cfg, n=1, B=4)
    rocfg = ref_optim.AdamWConfig(lr=LR, warmup_steps=0)
    rparams, _, rm = ref_train.make_train_step(rcfg, rocfg, accum_steps=2)(
        params, ref_optim.init_opt_state(params, rocfg), _jnp(b))
    ocfg = AdamWConfig(lr=LR, warmup_steps=0)
    model, _, m = make_train_step(cfg, ocfg, accum_steps=2)(
        model, init_opt_state(model, ocfg), b)
    for key in ("loss", "lm_loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                   rtol=2e-6, atol=1e-7, err_msg=key)
    want = _leaves(_np(rparams))
    got = _leaves(lm_tree_to_reference(dict(model.named_parameters()), cfg))
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= LR / 2, path


def test_remat_gives_the_same_gradients():
    """Per-period recomputation changes no value: the gradients with and
    without remat are equal bitwise."""
    _, cfg, _, model = _setup("jamba-v0.1-52b")
    (b,) = _batches(cfg, n=1)
    model.requires_grad_(True)
    out = []
    for remat in (True, False):
        loss, _ = loss_fn(model, cfg, b, remat=remat)
        out.append((loss.detach(), _grads(model, loss)))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def test_eval_step_matches_reference_loss():
    rcfg, cfg, params, model = _setup("chatglm3-6b")
    (b,) = _batches(cfg, n=1)
    want = ref_train.make_eval_step(rcfg)(params, _jnp(b))
    got = make_eval_step(cfg)(model, b)
    for key in ("loss", "lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-6, err_msg=key)


def test_bfloat16_step_matches_reference_op_by_op():
    """xlstm-125m reduced in bfloat16 against the reference run op by op
    (``jax.disable_jit``).  Bounds, each beside its reading:

    - the loss within 5e-3 (5.0e-4 measured, of 6.908);
    - each gradient leaf within 1.6e-2 max|ref leaf|, two bfloat16 ulps
      of the leaf's largest value (7.2e-3 at worst measured, on ``qkv``);
      a zero gradient would be 1.0 off;
    - each leaf's change over one train step, p1 - p0, against the
      reference's: mean |d - d_ref| within 2e-2 lr (3.5e-3 lr at worst
      measured; with the update skipped it is 0.97-1.0 lr on every leaf
      the update moves).  Adam's first step is about lr sign(g), so the
      few elements whose bfloat16 gradients differ in sign move 2 lr
      apart (0.18 % at worst measured, on ``up``): at most 1 % may;
    - the update alone, ``adamw_update`` on the reference's gradients,
      against the reference's: at most one element in 10^4 differs, and
      by one bfloat16 ulp at most (none of 182912 measured).  Rounding
      the update to bfloat16 before subtracting it changes 1363 of them,
      computing it in bfloat16 arithmetic 2405.
    """
    rcfg, cfg, params, model = _setup("xlstm-125m", "bfloat16")
    (b,) = _batches(cfg, n=1)
    rocfg = ref_optim.AdamWConfig(lr=LR, warmup_steps=0)
    with jax.disable_jit():
        (loss_r, _), grads_r = jax.value_and_grad(
            lambda p: ref_model.loss_fn(p, rcfg, _jnp(b)), has_aux=True)(
                params)
        grads_r = _np(grads_r)
        rparams, _, _ = ref_optim.adamw_update(
            jax.tree.map(jnp.asarray, grads_r), params,
            ref_optim.init_opt_state(params, rocfg), rocfg)
    loss, _ = loss_fn(model.requires_grad_(True), cfg, b)
    grads = _grads(model, loss)
    assert abs(float(loss.detach()) - float(loss_r)) <= 5e-3
    want = _leaves(grads_r)
    got = _leaves(lm_tree_to_reference(grads, cfg))
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= 1.6e-2 * np.abs(w).max(), path

    p0 = _leaves(_np(params))
    p1_ref = _leaves(_np(rparams))
    ocfg = AdamWConfig(lr=LR, warmup_steps=0)
    model, _, _ = make_train_step(cfg, ocfg)(model, init_opt_state(model,
                                                                   ocfg), b)
    p1 = _leaves(lm_tree_to_reference(dict(model.named_parameters()), cfg))

    def change_off(path, got_p1):
        d = np.abs((got_p1 - p0[path]) - (p1_ref[path] - p0[path]))
        return float(d.mean()), float((d > LR / 2).mean())

    moved = [path for path in p0 if np.any(p1_ref[path] != p0[path])]
    assert moved
    for path in p0:
        mean, frac = change_off(path, p1[path])
        assert mean <= 2e-2 * LR and frac <= 1e-2, path
    # The bound sees an update skipped, on every leaf the update moves.
    assert all(change_off(path, p0[path])[0] > 2e-2 * LR for path in moved)

    # The update alone, on the reference's gradients.
    fresh = lm_params_from_reference(_np(params), cfg, device="cpu")
    g_ref = {k: g.detach() for k, g in lm_params_from_reference(
        grads_r, cfg, device="cpu").named_parameters()}
    adamw_update(g_ref, fresh, init_opt_state(fresh, ocfg), ocfg)
    p1 = _leaves(lm_tree_to_reference(dict(fresh.named_parameters()), cfg))
    n_off = n_all = 0
    for path, w in p1_ref.items():
        off = p1[path] != w
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        assert np.all(np.abs(p1[path] - w)[off] <= ulp[off]), path
        n_off += int(off.sum())
        n_all += off.size
    assert n_off <= n_all // 10_000


def test_moe_grads_flow_to_all_param_kinds():
    """Mirror of ``tests/test_moe.py::test_moe_grads_flow_to_all_param_kinds``:
    every MoE parameter gets a nonzero gradient through ``scatter``."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    from repro_torch.models.layers import Params

    cfg = ModelConfig(name="t", family="moe", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=0, vocab=64, moe=True,
                      n_experts=4, top_k=2, moe_d_ff=16, capacity_factor=8.0,
                      param_dtype="float32")
    params = Params(torch.float32, torch.device("cpu"),
                    torch.Generator().manual_seed(0))
    moe.init_moe(params, cfg)
    params.requires_grad_(True)
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_forward(params, cfg, x, impl="scatter",
                             dtype=torch.float32)
    loss = torch.sum(y ** 2) + 0.01 * aux
    names = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(names.values()))
    for name, g in zip(names, grads):
        assert float(g.abs().max()) > 0, f"dead grads: {name}"
