"""The backward of kernel rows 9 and 10 against the JAX package on the
CPU, where both ``torch.autograd.Function``s run their plain versions.

Row 10b: the gradient of the plain recurrence (autograd through
``slstm_recurrence_ref``, and through the whole sLSTM mixer) against
``jax.grad`` of the reference's ``_slstm_cell`` scan and of its
``slstm_forward``, from a fresh state (m = -inf) at S = 1 and S = 64:
finite, and within rtol = atol = 2e-4 (the forward's tolerance; the two
frameworks' exponentials differ by ulps, which the reverse walk
carries).  ``_backward_kernel`` replays ``csrc/slstm.cu``'s backward
step in float32, formula for formula, and is held to autograd at the
same bound, ties of both maximums included (split evenly).

Row 9b: the gradient of the one-hot gather against ``jax.grad`` of the
reference's ``onehot_gather`` (``oh^T g``) with repeated ids and ids out
of range: float32 within 1e-6 relative (the sum's order), bfloat16
within one bfloat16 ulp of the float32 sum, and the plain version's
order is position order (``index_add_`` on the CPU adds in that order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.core import gather_ops as ref_gather
from repro.models import ssm as ref_ssm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
from repro_torch.kernels.gather_ref import gather_grad_ref
from repro_torch.kernels.slstm_ops import fused_slstm_forward, slstm_recurrence
from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                           slstm_backward_ref,
                                           slstm_recurrence_ref)

TOL = dict(rtol=2e-4, atol=2e-4)


def _problem(B, S, di, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    zifo = rng.standard_normal((B, S, 4, di)).astype(np.float32)
    zifo[:, :, 2] += shift
    r = (rng.standard_normal((4, di)) / np.sqrt(di)).astype(np.float32)
    dhs = rng.standard_normal((B, S, di)).astype(np.float32)
    return zifo, r, dhs


def _ref_grad(zifo, r, dhs):
    """``jax.grad`` of sum(hs * dhs) over the reference's cell, scanned
    from a fresh state."""
    B, _, _, di = zifo.shape

    def hs_of(z, w):
        state = (jnp.zeros((B, di)), jnp.zeros((B, di)), jnp.zeros((B, di)),
                 jnp.full((B, di), -jnp.inf))

        def body(st, zt):
            new = ref_ssm._slstm_cell(zt, w, st)
            return new, new[2]

        zs = jnp.moveaxis(z.reshape(B, -1, 4 * di), 1, 0)
        _, hs = jax.lax.scan(body, state, zs)
        return jnp.sum(jnp.moveaxis(hs, 0, 1) * dhs)

    dz, dr = jax.grad(hs_of, argnums=(0, 1))(jnp.asarray(zifo),
                                             jnp.asarray(r))
    return np.asarray(dz), np.asarray(dr)


@pytest.mark.parametrize("B,S", [(2, 1), (3, 64)])
def test_plain_backward_matches_jax_grad(B, S):
    zifo, r, dhs = _problem(B, S, 16, seed=S)
    want_z, want_r = _ref_grad(zifo, r, dhs)
    state = init_slstm_state(B, 16, device="cpu")
    dz, dr = slstm_backward_ref(torch.tensor(zifo), torch.tensor(r), state,
                                torch.tensor(dhs))
    assert torch.isfinite(dz).all() and torch.isfinite(dr).all()
    np.testing.assert_allclose(dz.numpy(), want_z, **TOL)
    np.testing.assert_allclose(dr.numpy(), want_r, **TOL)


def _backward_kernel(zifo, r, state, dhs):
    """``csrc/slstm.cu``'s backward, replayed in float32 on the CPU: the
    states a forward saves (here the plain recurrence's), then each step
    in reverse, recomputed from the previous state and carried back
    formula for formula as the kernel writes it; ``d r`` summed per
    chain in reverse order, then over the batch in order."""
    B, S, _, di = zifo.shape
    saved = []
    st = state
    from repro_torch.kernels.slstm_ref import slstm_cell_ref
    for t in range(S):
        st = slstm_cell_ref(zifo[:, t], r, st)
        saved.append(st)
    r0, r1, r2, r3 = r
    dc = dn = dh = dm = torch.zeros((B, di))
    part = torch.zeros((B, 4, di))
    dzifo = torch.empty_like(zifo)

    def share(x, y):
        return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))

    for t in range(S - 1, -1, -1):
        c, n, h, m = saved[t - 1] if t > 0 else state
        zi, ii, fi, oi = zifo[:, t].unbind(1)
        z = torch.tanh(zi + r0 * h)
        ig = ii + r1 * h
        fg = fi + r2 * h
        o = 1.0 / (1.0 + torch.exp(-(oi + r3 * h)))
        logf = -(torch.clamp_min(-fg, 0.0)
                 + torch.log1p(torch.exp(-fg.abs())))
        a = logf + m
        mn = torch.maximum(a, ig)
        ea, eb = torch.exp(a - mn), torch.exp(ig - mn)
        cn, nn = c * ea + eb * z, n * ea + eb
        dH = dhs[:, t] + dh
        nc = torch.clamp_min(nn, 1e-6)
        d_o = dH * cn / nc
        dcn = dc + dH * o / nc
        dnc = -dH * (o * cn) / (nc * nc)
        dnn = dn + dnc * share(nn, torch.full_like(nn, 1e-6))
        dea = dcn * c + dnn * n
        deb = dcn * z + dnn
        dz = dcn * eb
        dc, dn = dcn * ea, dnn * ea
        dA, dB = dea * ea, deb * eb
        dmn = dm - dA - dB
        da = dA + dmn * share(a, ig)
        dig = dB + dmn * share(ig, a)
        dm = da
        dfg = da / (1.0 + torch.exp(fg))
        dzp = dz * (1.0 - z * z)
        dop = d_o * o * (1.0 - o)
        dzifo[:, t] = torch.stack([dzp, dig, dfg, dop], dim=1)
        part += torch.stack([dzp, dig, dfg, dop], dim=1) * h[:, None]
        dh = dzp * r0 + dig * r1 + dfg * r2 + dop * r3
    dr = torch.zeros((4, di))
    for b in range(B):
        dr = dr + part[b]
    return dzifo, dr


@pytest.mark.parametrize("B,S,shift", [(2, 1, 0.0), (3, 64, 0.0),
                                       (2, 256, 12.0)])
def test_backward_kernel_formulas_match_autograd(B, S, shift):
    """The kernel's derivative, step for step, against autograd through
    the plain recurrence, fresh state, ordinary and long-memory gates."""
    zifo, r, dhs = (torch.tensor(a) for a in _problem(B, S, 16, seed=7,
                                                      shift=shift))
    state = init_slstm_state(B, 16, device="cpu")
    dz, dr = _backward_kernel(zifo, r, state, dhs)
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    assert torch.isfinite(dz).all() and torch.isfinite(dr).all()
    torch.testing.assert_close(dz, want_z, **TOL)
    torch.testing.assert_close(dr, want_r, **TOL)


def test_backward_kernel_formulas_split_ties_as_autograd():
    """A tie of the stabiliser, max(logf + m, i) with logf = -0 (f =
    200: exp(-200) underflows) and i = m, splits the gradient evenly in
    the kernel's formulas as in autograd (and in JAX)."""
    B, di = 2, 4
    state = torch.zeros((4, B, di))
    state[0], state[1], state[3] = 0.5, 1.5, 0.25
    zifo = torch.zeros((B, 1, 4, di))
    zifo[:, 0, 1] = 0.25                     # i = m
    zifo[:, 0, 2] = 200.0                    # logf = -0
    zifo[:, 0, 0], zifo[:, 0, 3] = 0.3, -0.2
    r = torch.zeros((4, di))
    dhs = torch.ones((B, 1, di))
    dz, _ = _backward_kernel(zifo, r, state, dhs)
    want_z, _ = slstm_backward_ref(zifo, r, state, dhs)
    torch.testing.assert_close(dz, want_z, rtol=1e-6, atol=1e-7)
    # The share of the tie reaches both gates: i's gradient is not the
    # untied one.
    untied = zifo.clone()
    untied[:, 0, 1] = 0.2
    dz_u, _ = slstm_backward_ref(untied, r, state, dhs)
    assert not torch.allclose(dz[:, 0, 1], dz_u[:, 0, 1])


@pytest.mark.parametrize("S", [1, 64])
def test_mixer_gradient_matches_jax_grad(S):
    """The sLSTM mixer's gradient (projection, recurrence through the
    autograd Function, out-projection) against ``jax.grad`` of the
    reference's ``slstm_forward``, with respect to every parameter and
    the input, from a fresh state."""
    cfg = ModelConfig(name="t", family="ssm", n_layers=2, d_model=16,
                      n_heads=4, n_kv_heads=2, d_ff=0, vocab=64,
                      ssm_expand=2, param_dtype="float32")
    rng = np.random.default_rng(S)
    d, di = cfg.d_model, cfg.d_inner
    arrays = {"zifo": rng.standard_normal((d, 4 * di)) / np.sqrt(d),
              "r_zifo": rng.standard_normal((4, di)) / np.sqrt(di),
              "out_proj": rng.standard_normal((di, d)) / np.sqrt(di)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    dy = rng.standard_normal((2, S, d)).astype(np.float32)

    def ref_loss(p, xx):
        return jnp.sum(ref_ssm.slstm_forward(p, cfg, xx, dtype=jnp.float32)
                       * dy)

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(x))
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in arrays.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = fused_slstm_forward(params, cfg, xt, dtype=torch.float32)
    torch.sum(y * torch.tensor(dy)).backward()
    for k, t in params.items():
        assert torch.isfinite(t.grad).all(), k
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[k]), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)


def test_recurrence_refuses_a_trainable_initial_state():
    zifo = torch.zeros((1, 2, 4, 8), requires_grad=True)
    state = init_slstm_state(1, 8, device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="fresh state"):
        slstm_recurrence(zifo, torch.zeros(4, 8), state)


def test_functions_route_to_the_plain_versions_on_the_cpu():
    """With gradients on the CPU both Functions run their plain versions:
    no launch counted, the forwards equal the plain ones bitwise, the
    backwards equal the plain backwards bitwise."""
    before = dict(LAUNCHES)
    zifo, r, dhs = (torch.tensor(a) for a in _problem(2, 9, 8, seed=3))
    z = zifo.clone().requires_grad_(True)
    w = r.clone().requires_grad_(True)
    hs, final = slstm_recurrence(z, w)
    assert not final.requires_grad
    want_hs, _ = slstm_recurrence_ref(zifo, r, init_slstm_state(2, 8,
                                                                device="cpu"))
    assert torch.equal(hs.detach(), want_hs)
    hs.backward(dhs)
    want_z, want_r = slstm_backward_ref(zifo, r, init_slstm_state(
        2, 8, device="cpu"), dhs)
    assert torch.equal(z.grad, want_z) and torch.equal(w.grad, want_r)

    table = torch.randn(11, 5, requires_grad=True)
    ids = torch.tensor([[3, 3, -1], [11, 0, 3]])
    out = cuda_onehot_gather(table, ids)
    g = torch.randn(out.shape)
    out.backward(g)
    assert torch.equal(table.grad, gather_grad_ref(ids.reshape(-1),
                                                   g.reshape(6, 5), 11))
    assert dict(LAUNCHES) == before


def _gather_case(V, D, N, dtype, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, N)
    ids[:4] = ids[4]                       # a repeated id
    ids[5], ids[6] = -1, V                 # out of range
    g = rng.standard_normal((N, D)).astype(np.float32)
    if dtype == "bfloat16":
        table = table.astype(jnp.bfloat16)
        g = g.astype(jnp.bfloat16)
    return table, ids.astype(np.int32), g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,D,N", [(37, 8, 50), (300, 16, 200)])
def test_gather_gradient_matches_jax_grad(dtype, V, D, N):
    table, ids, g = _gather_case(V, D, N, dtype, seed=V)

    def ref(t):
        return jnp.sum(ref_gather.onehot_gather(t, jnp.asarray(ids))
                       .astype(jnp.float32) * jnp.asarray(g, jnp.float32))

    want = np.asarray(jax.grad(ref)(jnp.asarray(table)), np.float32)
    tt = torch.tensor(np.asarray(table, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(True)
    gt = torch.tensor(np.asarray(g, np.float32)).to(getattr(torch, dtype))
    out = cuda_onehot_gather(tt, torch.tensor(ids))
    out.backward(gt)
    got = tt.grad.float().numpy()
    # Rows no in-range id hits are exactly zero in both.
    hit = np.zeros(V, bool)
    hit[ids[(ids >= 0) & (ids < V)]] = True
    assert not got[~hit].any() and not want[~hit].any()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        exact = gather_grad_ref(torch.tensor(ids), gt.float(), V)
        ulp = np.abs(exact.numpy()) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - exact.numpy()) <= ulp)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_gather_gradient_sums_in_position_order():
    """The plain version's float32 sum is the sequential one in position
    order, the order the kernel adds in."""
    rng = np.random.default_rng(5)
    ids = torch.tensor([2, 0, 2, 2, 7, 2])
    g = torch.tensor(rng.standard_normal((6, 3)).astype(np.float32) * 1e4)
    g[2] *= 1e-4
    got = gather_grad_ref(ids, g, 4)
    want = torch.zeros(3)
    for n in (0, 2, 3, 5):
        want = want + g[n]
    assert torch.equal(got[2], want)
    assert torch.equal(got[0], g[1]) and not got[[1, 3]].any()
