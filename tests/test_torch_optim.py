"""The port's AdamW (``repro_torch.training.optim``) against the JAX
package's on the CPU.

One update from the same parameters, gradients and non-zero moments
(two reference steps' worth, carried over by
``convert.opt_state_from_reference``), on the reduced xlstm-125m's
parameter tree, for each moment type: float32 parameters within
rtol = atol = 1e-6 (the same float32 operations, in another order for
the global norm); float32 moments within 1e-6 relative, bfloat16 ones
within one bfloat16 ulp, int8 codes within one code (a value that lands
on a rounding boundary may round either way) with scales within 1e-6
relative.  Plus the weight-decay rank rule on a per-layer 1-D block leaf,
the schedule, and the mirrors of ``tests/test_optim_ckpt_ft.py``'s
optimizer tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.training import optim as ref_optim
from repro_torch.configs import ARCHS
from repro_torch.convert import (lm_params_from_reference,
                                 lm_tree_to_reference,
                                 opt_state_from_reference)
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        cosine_schedule, global_norm,
                                        init_opt_state, reference_ndim)

ARCH = "xlstm-125m"


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a).copy(), tree)


def _setup(state_dtype):
    """(reference params, grads, opt state after two steps; config) as
    numpy, the grads of the third step too."""
    cfg = REF_ARCHS[ARCH].reduced()
    params, _ = ref_model.init_model(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    ocfg = ref_optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                                 state_dtype=state_dtype)

    def grads_like(scale):
        return jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale,
                                  p.dtype), params)

    opt = ref_optim.init_opt_state(params, ocfg)
    for scale in (0.3, 2.0):
        params, opt, _ = ref_optim.adamw_update(grads_like(scale), params,
                                                opt, ocfg)
    return _np(params), _np(grads_like(0.7)), _np(opt), ocfg


def _port_cfg(ocfg):
    return AdamWConfig(**{f: getattr(ocfg, f) for f in
                          ("lr", "b1", "b2", "eps", "weight_decay",
                           "clip_norm", "state_dtype", "warmup_steps",
                           "total_steps")})


def _per_layer(tree, cfg):
    """A stacked numpy tree as the port's ``{name: tensor}``."""
    from repro_torch.convert import _per_layer as split

    out = {}
    for name, (node, idx) in split(tree, cfg).items():
        arr = torch.tensor(np.asarray(node, np.float32))
        out[name] = arr if idx is None else arr[idx].clone()
    return out


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_update_matches_reference_from_nonzero_moments(state_dtype):
    params, grads, opt, ocfg = _setup(state_dtype)
    cfg = ARCHS[ARCH].reduced()
    model = lm_params_from_reference(params, cfg, device="cpu")
    port_opt = opt_state_from_reference(opt, cfg, device="cpu")
    assert int(port_opt["step"]) == 2
    port_grads = _per_layer(grads, cfg)

    want_p, want_opt, want_stats = ref_optim.adamw_update(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, opt), ocfg)
    _, got_opt, stats = adamw_update(port_grads, model, port_opt,
                                     _port_cfg(ocfg))
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(want_stats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(stats["lr"]), float(want_stats["lr"]),
                               rtol=1e-6)
    assert int(got_opt["step"]) == 3
    got_p = lm_tree_to_reference(dict(model.named_parameters()), cfg)
    for path, want in jax.tree_util.tree_leaves_with_path(_np(want_p)):
        got = _get(got_p, path)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    want_m = opt_state_from_reference(_np(want_opt), cfg, device="cpu")
    for key in ("m", "v"):
        for name, want in want_m[key].items():
            got = got_opt[key][name]
            if state_dtype == "int8":
                torch.testing.assert_close(got["s"], want["s"], rtol=1e-6,
                                           atol=0)
                assert (got["q"].int() - want["q"].int()).abs().max() <= 1
            elif state_dtype == "bfloat16":
                assert got.dtype == torch.bfloat16
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=2 ** -7, atol=1e-30)
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_block_norms_decay_as_the_reference_stacks_them():
    """The reference decays a leaf of rank >= 2; its block norms are
    stacked over the periods, ``(n_periods, d)``, so they decay, and
    ``norm_f_*`` (``(d,)``) does not.  The port's per-layer block norm is
    1-D and decays all the same."""
    assert reference_ndim("layers.3.ln1_scale", torch.ones(4)) == 2
    assert reference_ndim("enc_layers.0.ln1_bias", torch.ones(4)) == 2
    assert reference_ndim("norm_f_scale", torch.ones(4)) == 1
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0)
    params = {"layers.0.ln1_scale": torch.ones(4),
              "norm_f_scale": torch.ones(4)}
    grads = {k: torch.zeros(4) for k in params}
    adamw_update(grads, params, init_opt_state(params, cfg), cfg)
    lr = float(cosine_schedule(cfg, torch.tensor(1)))
    torch.testing.assert_close(params["layers.0.ln1_scale"],
                               torch.full((4,), 1 - lr * 0.5))
    assert torch.equal(params["norm_f_scale"], torch.ones(4))
    # The reference on the stacked leaf and the top-level one.
    rcfg = ref_optim.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0)
    rp = {"blocks": {"ln1_scale": jnp.ones((1, 4))},
          "norm_f_scale": jnp.ones(4)}
    out, _, _ = ref_optim.adamw_update(jax.tree.map(jnp.zeros_like, rp), rp,
                                       ref_optim.init_opt_state(rp, rcfg),
                                       rcfg)
    np.testing.assert_allclose(np.asarray(out["blocks"]["ln1_scale"][0]),
                               params["layers.0.ln1_scale"].numpy(),
                               rtol=1e-7)
    np.testing.assert_array_equal(np.asarray(out["norm_f_scale"]),
                                  params["norm_f_scale"].numpy())


def test_cosine_schedule_matches_reference():
    for kw in ({}, {"warmup_steps": 10, "total_steps": 100, "lr": 3e-3},
               {"warmup_steps": 0, "total_steps": 7}):
        rc, pc = ref_optim.AdamWConfig(**kw), AdamWConfig(**kw)
        steps = np.arange(0, 2 * pc.total_steps + 3, max(1, pc.total_steps
                                                         // 37))
        want = np.asarray(ref_optim.cosine_schedule(rc, jnp.asarray(steps)))
        got = cosine_schedule(pc, torch.tensor(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7 * pc.lr)


def test_global_norm_and_int8_rows_in_blocks(monkeypatch):
    """A leaf larger than a block is updated a block of rows at a time
    with the same result as in one piece (bitwise, with no clipping: the
    norm's blocks add in another order, 1e-6 apart)."""
    from repro_torch.training import optim

    rng = np.random.default_rng(4)
    p0 = torch.tensor(rng.standard_normal((9, 5)).astype(np.float32))
    g = {"w": torch.tensor(rng.standard_normal((9, 5)).astype(np.float32))}
    cfg = AdamWConfig(lr=0.05, state_dtype="int8", warmup_steps=0,
                      clip_norm=1e6)
    out = []
    for chunk in (1 << 25, 10):            # one block; 2 rows a block
        monkeypatch.setattr(optim, "CHUNK_ELEMS", chunk)
        p = {"w": p0.clone()}
        opt = init_opt_state(p, cfg)
        for _ in range(3):
            adamw_update(g, p, opt, cfg)
        out.append((p["w"], opt["m"]["w"]["q"], global_norm(g)))
    (p1, q1, n1), (p2, q2, n2) = out
    assert torch.equal(p1, p2) and torch.equal(q1, q2)
    torch.testing.assert_close(n1, n2, rtol=1e-6, atol=0)


# ----------------------------------------------------------------------
# Mirrors of tests/test_optim_ckpt_ft.py
# ----------------------------------------------------------------------

def _quad_problem():
    params = {"w": torch.tensor([2.0, -3.0, 1.0]),
              "b": torch.tensor([[0.5, -0.5], [1.0, 2.0]])}

    def grads(p):
        return {k: 2 * v for k, v in p.items()}

    def loss(p):
        return float(sum(torch.sum(v ** 2) for v in p.values()))

    return params, grads, loss


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges(state_dtype):
    params, grads, loss = _quad_problem()
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, state_dtype=state_dtype,
                      warmup_steps=0, total_steps=10_000)
    opt = init_opt_state(params, cfg)
    l0 = loss(params)
    for _ in range(200):
        params, opt, stats = adamw_update(grads(params), params, opt, cfg)
    l1 = loss(params)
    assert l1 < 0.05 * l0, f"{state_dtype}: {l0} -> {l1}"
    assert np.isfinite(float(stats["grad_norm"]))


def test_int8_state_memory_shape():
    params, _, _ = _quad_problem()
    opt = init_opt_state(params, AdamWConfig(state_dtype="int8"))
    assert opt["m"]["b"]["q"].dtype == torch.int8
    assert tuple(opt["m"]["b"]["s"].shape) == (2, 1)
    assert tuple(opt["m"]["w"]["s"].shape) == (1,)


def test_grad_clip_applied():
    params, _, _ = _quad_problem()
    w_before = params["w"].clone()
    cfg = AdamWConfig(lr=1e-3, clip_norm=1e-6, weight_decay=0.0)
    opt = init_opt_state(params, cfg)
    huge = {k: 1e9 * torch.ones_like(v) for k, v in params.items()}
    new_params, _, _ = adamw_update(huge, params, opt, cfg)
    delta = float((new_params["w"] - w_before).abs().max())
    assert delta < 1e-3
