"""The backward of kernel rows 9 and 10 against the JAX package on the
CPU, where both ``torch.autograd.Function``s run their plain versions.

Row 10b: the gradient of the plain recurrence (autograd through
``slstm_recurrence_ref``, and through the whole sLSTM mixer) against
``jax.grad`` of the reference's ``_slstm_cell`` scan and of its
``slstm_forward``, from a fresh state (m = -inf) at S = 1 and S = 64:
finite, and within rtol = atol = 2e-4 (the forward's tolerance; the two
frameworks' exponentials differ by ulps, which the reverse walk
carries).  ``_backward_kernel`` replays ``csrc/slstm.cu``'s backward
step in float32, formula for formula, token after token, and is held to
autograd at the same bound, ties of both maximums included (split
evenly).  ``_chunked_kernel`` replays the kernel's chunked scan with its
W and T (each chunk's map, the walk over chunks and pieces, the replay
of each chunk from its carry) and is held to autograd at the same bound
at the piece's edges, from a fresh state, over a long memory and through
ties; its latest chunk equals the token-by-token replay, and a carry
that skips one chunk's map breaks the bound.

Row 9b: the gradient of the one-hot gather against ``jax.grad`` of the
reference's ``onehot_gather`` (``oh^T g``) with repeated ids and ids out
of range: float32 within 1e-6 relative (the sum's order), bfloat16
within one bfloat16 ulp of the float32 sum, and the plain version's
order is position order (``index_add_`` on the CPU adds in that order).
``_block_path`` replays the one-block path of ``csrc/gather.cu`` (the
packed keys, the bitonic network, the runs, the hit map and its word
ranks, the row writer's sums) and equals the plain version bitwise;
the launcher's choice of path and the key's bits hold for every
vocabulary in ``configs/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.core import gather_ops as ref_gather
from repro.models import ssm as ref_ssm
from repro_torch.configs import ARCHS
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.gather import (BLOCK_MAX_N, BLOCK_MAX_V,
                                        KEY_POS_BITS, grad_path,
                                        grad_scratch_ints)
from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
from repro_torch.kernels.slstm import BWD_CHUNK, BWD_WARPS
from repro_torch.kernels.gather_ref import gather_grad_ref
from repro_torch.kernels.slstm_ops import fused_slstm_forward, slstm_recurrence
from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                           slstm_backward_ref,
                                           slstm_cell_ref,
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


def _share(x, y):
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def _saved(zifo, r, state):
    """The state after each step, as the training forward saves it."""
    out, st = [], state
    for t in range(zifo.shape[1]):
        st = slstm_cell_ref(zifo[:, t], r, st)
        out.append(st)
    return out


def _recompute(zifo, state, saved, t, r, sfu=0.0):
    """``csrc/slstm.cu::recompute`` and ``coefs``: step ``t``'s
    coefficients from its staged inputs (the gates, the state and h
    before it).  Phase 3 rebuilds the same coefficients from the values
    phase 1 stores, by the same formulas.  ``sfu`` injects the SFU's
    error: each exponential, logarithm and reciprocal is off by that
    relative amount, its sign alternating with the token (the logarithm
    off by it absolute, lg2.approx's bound)."""
    c, n, h, m = saved[t - 1] if t > 0 else state
    zi, ii, fi, oi = zifo[:, t].unbind(1)
    r0, r1, r2, r3 = r
    off = 1.0 + sfu * (-1) ** t
    zx = zi + r0 * h
    ez = torch.exp(-2.0 * zx.abs()) * off
    z = torch.copysign((1.0 - ez) * (1.0 / (1.0 + ez) * off), zx)
    ig = ii + r1 * h
    fg = fi + r2 * h
    ox = oi + r3 * h
    eo = torch.exp(-ox.abs()) * off
    ro = 1.0 / (1.0 + eo) * off
    o = torch.where(ox >= 0, ro, eo * ro)
    ef = torch.exp(-fg.abs()) * off
    logf = -(torch.clamp_min(-fg, 0.0) + torch.log(1.0 + ef) + (off - 1.0))
    rf = 1.0 / (1.0 + ef) * off
    sg = torch.where(fg >= 0, ef * rf, rf)
    a = logf + m
    e = torch.exp(-(a - ig).abs()) * off
    ea = torch.where(a >= ig, 1.0, e)
    eb = torch.where(ig >= a, 1.0, e)
    sa = _share(a, ig)
    nn = n * ea + eb
    rn = 1.0 / torch.clamp_min(nn, 1e-6) * off
    cn = c * ea + eb * z
    al = o * rn
    be = cn * rn
    la = be * (o * (1.0 - o))
    ka = eb * (1.0 - z * z)
    return {"al": al, "ga": -(al * be) * _share(nn, torch.full_like(nn, 1e-6)),
            "P": c * ea, "Q": n * ea, "R": z * eb, "ea": ea, "eb": eb,
            "sa": sa, "si": 1.0 - sa, "ka": ka, "sg": sg, "la": la,
            "K0": r0 * ka, "K2": r2 * sg, "K3": r3 * la, "h": h}


def _back_step(s, v, dhs, r):
    """``csrc/slstm.cu::back_step`` (phase 3): the carry (dc, dn, dm, dh)
    before a step from the one after it and dhs, and the step's
    d(pre-activations) (z, i, f, o)."""
    dc, dn, dm, dh = v
    dH = dh + dhs
    dcn = dc + s["al"] * dH
    dnn = dn + s["ga"] * dH
    dA = s["P"] * dcn + s["Q"] * dnn
    dB = s["R"] * dcn + s["eb"] * dnn
    dmn = dm - dA - dB
    da = dA + s["sa"] * dmn
    d = (s["ka"] * dcn, dB + s["si"] * dmn, s["sg"] * da, s["la"] * dH)
    dh_new = r[0] * d[0] + r[1] * d[1] + r[2] * d[2] + r[3] * d[3]
    return (s["ea"] * dcn, s["ea"] * dnn, da, dh_new), d


def _map_step(s, v, dH, r):
    """``csrc/slstm.cu::map_step`` (phase 1): the same map on a column of
    a chunk's map (dH = dh) or on its vector (dH = dh + dhs), r folded
    into K0, K2, K3."""
    dc, dn, dm, _ = v
    dcn = dc + s["al"] * dH
    dnn = dn + s["ga"] * dH
    dA = s["P"] * dcn + s["Q"] * dnn
    dB = s["R"] * dcn + s["eb"] * dnn
    dmn = dm - dA - dB
    da = dA + s["sa"] * dmn
    return (s["ea"] * dcn, s["ea"] * dnn, da,
            s["K0"] * dcn + r[1] * (dB + s["si"] * dmn) + s["K2"] * da
            + s["K3"] * dH)


def _batch_sum(part):
    dr = torch.zeros(part.shape[1:])
    for b in range(part.shape[0]):
        dr = dr + part[b]
    return dr


def _backward_kernel(zifo, r, state, dhs):
    """``csrc/slstm.cu``'s backward step, replayed in float32 on the CPU
    token after token, latest first, from the states a forward saves
    (here the plain recurrence's), formula for formula as the kernel
    writes it; ``d r`` summed per chain in reverse order, then over the
    batch in order."""
    B, S, _, di = zifo.shape
    saved = _saved(zifo, r, state)
    v = (torch.zeros((B, di)),) * 4
    part = torch.zeros((B, 4, di))
    dzifo = torch.empty_like(zifo)
    for t in range(S - 1, -1, -1):
        s = _recompute(zifo, state, saved, t, r)
        v, d = _back_step(s, v, dhs[:, t], r)
        dzifo[:, t] = torch.stack(d, dim=1)
        part += torch.stack(d, dim=1) * s["h"][:, None]
    return dzifo, _batch_sum(part)


def _chunked_kernel(zifo, r, state, dhs, W=BWD_WARPS, T=BWD_CHUNK,
                    skip=None, sfu=0.0):
    """``csrc/slstm.cu``'s chunked scan, replayed in float32 on the CPU
    in the kernel's order, every chain at once: pieces of W T tokens,
    the latest first; in a piece each chunk's map (its four columns and
    its vector, latest token first), then the walk over the W maps from
    the later piece's carry, then each chunk replayed from the carry that
    enters it; ``d r`` per chunk in reverse token order, over the pieces,
    then over the W chunks in order and over the batch in order.
    Phase 1 carries the map with ``_map_step``, phase 3 replays with
    ``_back_step``.  ``skip = (piece, chunk)`` plants a fault: the walk
    passes that chunk without its map; ``sfu`` injects the SFU's error
    (``_recompute``)."""
    B, S, _, di = zifo.shape
    saved = _saved(zifo, r, state)
    zero, one = torch.zeros((B, di)), torch.ones((B, di))
    units = [tuple(one if q == c else zero for q in range(4))
             for c in range(4)]
    v = (zero,) * 4
    part = [torch.zeros((B, 4, di)) for _ in range(W)]
    dzifo = torch.empty_like(zifo)
    P = W * T
    for p in range((S + P - 1) // P - 1, -1, -1):
        spans = [(p * P + w * T, max(0, min(T, S - p * P - w * T)))
                 for w in range(W)]
        maps = []
        for t0, n in spans:
            cols, vec = list(units), (zero,) * 4
            for k in range(n - 1, -1, -1):
                s = _recompute(zifo, state, saved, t0 + k, r, sfu)
                cols = [_map_step(s, col, col[3], r) for col in cols]
                vec = _map_step(s, vec, vec[3] + dhs[:, t0 + k], r)
            maps.append((cols, vec))
        into = [None] * W
        for w in range(W - 1, -1, -1):
            into[w] = v
            if skip == (p, w):
                continue
            cols, vec = maps[w]
            v = tuple(vec[q] + v[0] * cols[0][q] + v[1] * cols[1][q]
                      + v[2] * cols[2][q] + v[3] * cols[3][q]
                      for q in range(4))
        for w, (t0, n) in enumerate(spans):
            u = into[w]
            for k in range(n - 1, -1, -1):
                s = _recompute(zifo, state, saved, t0 + k, r, sfu)
                u, d = _back_step(s, u, dhs[:, t0 + k], r)
                dzifo[:, t0 + k] = torch.stack(d, dim=1)
                part[w] = part[w] + torch.stack(d, dim=1) * s["h"][:, None]
    acc = torch.zeros((B, 4, di))
    for w in range(W):
        acc = acc + part[w]
    return dzifo, _batch_sum(acc)


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


def test_backward_layout_matches_the_source():
    """The W and T the replay uses are the ones ``csrc/slstm.cu`` builds
    with, and its staging holds nine floats a token and chain."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / "src" /
           "repro_torch" / "kernels" / "csrc" / "slstm.cu").read_text()
    assert int(re.search(r"#define SLSTM_BWD_W (\d+)", src).group(1)) \
        == BWD_WARPS
    assert int(re.search(r"#define SLSTM_BWD_T (\d+)", src).group(1)) \
        == BWD_CHUNK
    assert re.search(r"constexpr int kBwdIn = 9;", src)


@pytest.mark.parametrize("S", [BWD_CHUNK - 1, BWD_CHUNK, BWD_CHUNK + 1,
                               BWD_WARPS * BWD_CHUNK,
                               BWD_WARPS * BWD_CHUNK + 1])
def test_chunked_scan_matches_autograd_at_the_piece_edges(S):
    """The chunked scan from a fresh state (m = -inf), with S one short of
    a chunk, a chunk, one over, a piece and one over: finite, and within
    SLSTM_TOL of autograd through the plain recurrence."""
    zifo, r, dhs = (torch.tensor(a) for a in _problem(3, S, 16, seed=S))
    state = init_slstm_state(3, 16, device="cpu")
    dz, dr = _chunked_kernel(zifo, r, state, dhs)
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    assert torch.isfinite(dz).all() and torch.isfinite(dr).all()
    torch.testing.assert_close(dz, want_z, **TOL)
    torch.testing.assert_close(dr, want_r, **TOL)


def test_chunked_scan_over_a_long_memory():
    """Forget pre-activations +12 over 2048 tokens (the forward's hard
    case: the carried dc and dn pass 2048 decays of nearly 1, through 43
    pieces of composed maps)."""
    zifo, r, dhs = (torch.tensor(a) for a in _problem(2, 2048, 8, seed=11,
                                                      shift=12.0))
    state = init_slstm_state(2, 8, device="cpu")
    dz, dr = _chunked_kernel(zifo, r, state, dhs)
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    assert torch.isfinite(dz).all() and torch.isfinite(dr).all()
    torch.testing.assert_close(dz, want_z, **TOL)
    torch.testing.assert_close(dr, want_r, **TOL)


@pytest.mark.parametrize("S,shift", [(200, 0.0), (2048, 12.0)])
def test_chunked_scan_with_the_sfu_errors(S, shift):
    """The kernel takes its exponentials, log1p and reciprocals from the
    SFU: with each off by 4 ulps (2^-21, over the 2 ulps of ex2.approx
    and rcp.approx and the Newton step's residue), ordinary gates and a
    long memory stay within SLSTM_TOL of autograd."""
    zifo, r, dhs = (torch.tensor(a) for a in _problem(2, S, 8, seed=S,
                                                      shift=shift))
    state = init_slstm_state(2, 8, device="cpu")
    dz, dr = _chunked_kernel(zifo, r, state, dhs, sfu=2.0 ** -21)
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    torch.testing.assert_close(dz, want_z, **TOL)
    torch.testing.assert_close(dr, want_r, **TOL)


def test_chunked_scan_splits_ties_as_autograd():
    """Both maximums tie at every step, across chunk and piece borders:
    the stabiliser (r = 0, f = 200 so logf = -0, i = m) in batch row 0,
    and max(n', 1e-6) (n = 1e-6, i = -200 so eb = 0 and n' = n) in row
    1; each splits its gradient evenly, as autograd does."""
    B, S, di = 2, BWD_WARPS * BWD_CHUNK + 3, 4
    state = torch.zeros((4, B, di))
    state[0], state[1], state[3] = 0.5, 1.5, 0.25
    state[1, 1] = 1e-6
    zifo = torch.zeros((B, S, 4, di))
    zifo[:, :, 0], zifo[:, :, 3] = 0.3, -0.2
    zifo[0, :, 1], zifo[0, :, 2] = 0.25, 200.0
    zifo[1, :, 1], zifo[1, :, 2] = -200.0, 1.0
    r = torch.zeros((4, di))
    dhs = torch.ones((B, S, di))
    dz, dr = _chunked_kernel(zifo, r, state, dhs)
    want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
    torch.testing.assert_close(dz, want_z, **TOL)
    torch.testing.assert_close(dr, want_r, **TOL)
    # Each share reaches the gradient: the untied problem's is not it.
    untied = zifo.clone()
    untied[0, :, 1] = 0.2
    dz_u, _ = slstm_backward_ref(untied, r, state, dhs)
    assert not torch.allclose(dz[0], dz_u[0], **TOL)
    untied = state.clone()
    untied[1, 1] = 1.1e-6
    dz_u, _ = slstm_backward_ref(zifo, r, untied, dhs)
    assert not torch.allclose(dz[1], dz_u[1], **TOL)


def test_chunked_scan_latest_chunk_is_the_token_replay():
    """The latest chunk starts from a zero carry, so it is the token by
    token replay's: within 1e-6 relative."""
    S = BWD_WARPS * BWD_CHUNK + BWD_CHUNK + 2
    zifo, r, dhs = (torch.tensor(a) for a in _problem(2, S, 16, seed=4))
    state = init_slstm_state(2, 16, device="cpu")
    dz, _ = _chunked_kernel(zifo, r, state, dhs)
    want, _ = _backward_kernel(zifo, r, state, dhs)
    latest = slice(S - (S % BWD_CHUNK or BWD_CHUNK), S)
    torch.testing.assert_close(dz[:, latest], want[:, latest], rtol=1e-6,
                               atol=1e-7)


def test_chunked_scan_sees_a_carry_that_skips_a_map():
    """A planted fault, the walk passing one chunk at a piece's border
    without its map, breaks the bound."""
    S = 2 * BWD_WARPS * BWD_CHUNK
    zifo, r, dhs = (torch.tensor(a) for a in _problem(2, S, 16, seed=9))
    state = init_slstm_state(2, 16, device="cpu")
    want_z, _ = slstm_backward_ref(zifo, r, state, dhs)
    dz, _ = _chunked_kernel(zifo, r, state, dhs, skip=(1, 0))
    assert not torch.allclose(dz, want_z, **TOL)


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


def _block_path(ids, dout, V):
    """``csrc/gather.cu``'s one-block path replayed on the CPU: the packed
    keys (0xffffffff out of range) through the sort kernel's bitonic
    network as it schedules it (strides >= 64 as pairs in shared memory,
    strides <= 32 as the warps' register exchanges), the runs (first
    sorted index and row) and the hit map, then the row writer: each
    run's row the float32 sum of its rows of ``dout`` in sorted order,
    rounded once, and zeros where the hit map has no bit."""
    N = ids.numel()
    p2 = 64
    while p2 < N:
        p2 *= 2
    keys = np.full(p2, 0xFFFFFFFF, dtype=np.uint64)
    idv = ids.numpy().astype(np.int64)
    ok = (idv >= 0) & (idv < V)
    keys[:N][ok] = (idv[ok].astype(np.uint64) << KEY_POS_BITS) | \
        np.arange(N, dtype=np.uint64)[ok]
    idx = np.arange(p2)
    size = 2
    while size <= p2:
        stride = size // 2
        while stride >= 64:                # on shared memory
            q = np.arange(p2 // 2)
            lo = ((q & ~(stride - 1)) << 1) | (q & (stride - 1))
            hi = lo + stride
            a, c = keys[lo], keys[hi]
            swap = (a > c) == ((lo & size) == 0)
            keys[lo[swap]], keys[hi[swap]] = c[swap], a[swap]
            stride //= 2
        stride = min(size // 2, 32)        # in registers, a warp 64 keys
        while stride:
            if stride == 32:
                i0 = idx[(idx & 63) < 32]
                a, c = keys[i0], keys[i0 + 32]
                swap = (a > c) == ((i0 & size) == 0)
                keys[i0[swap]], keys[i0[swap] + 32] = c[swap], a[swap]
            else:
                y = keys[idx ^ stride]
                keep_min = ((idx & stride) == 0) == ((idx & size) == 0)
                keys = np.where(keep_min, np.minimum(keys, y),
                                np.maximum(keys, y))
            stride //= 2
        size *= 2
    assert np.all(np.diff(keys.astype(np.int64)) >= 0)
    n_in = int(ok.sum())
    rid = (keys[:n_in] >> KEY_POS_BITS).astype(np.int64)
    pos = (keys[:n_in] & ((1 << KEY_POS_BITS) - 1)).astype(np.int64)
    head = [k for k in range(n_in) if k == 0 or rid[k] != rid[k - 1]]
    run_row = [int(rid[k]) for k in head]
    head.append(n_in)
    words = (V + 31) // 32
    hitmap = np.zeros(words, np.uint64)
    for v in run_row:
        hitmap[v >> 5] |= np.uint64(1 << (v & 31))
    assert words + len(head) + n_in + len(run_row) + 1 <= \
        grad_scratch_ints(N, V)
    out = torch.full((V, dout.shape[1]), float("nan"), dtype=dout.dtype)
    for h, v in enumerate(run_row):              # the run blocks
        acc = torch.zeros(dout.shape[1])
        for k in range(head[h], head[h + 1]):
            acc = acc + dout[pos[k]].float()
        out[v] = acc.to(dout.dtype)
    for v in range(V):                           # the zero groups
        if not (int(hitmap[v >> 5]) >> (v & 31)) & 1:
            out[v] = 0
    assert not out.isnan().any()                 # every row written
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["n0", "n1", "one_run", "all_out",
                                  "v_odd", "mixed"])
def test_gather_block_path_is_the_plain_version(dtype, case):
    """The one-block path's arithmetic equals ``gather_grad_ref`` bitwise:
    no ids, one id, every id equal (one run), every id out of range, V
    not a multiple of 32 (the hit map's tail), and repeated ids with
    ids -1 and V among them."""
    rng = np.random.default_rng(len(case))
    V, N = {"n0": (70, 0), "n1": (70, 1), "one_run": (70, 200),
            "all_out": (70, 40), "v_odd": (1000 + 7, 300),
            "mixed": (300, 257)}[case]
    ids = rng.integers(0, V, N)
    if case == "one_run":
        ids[:] = 33
    elif case == "all_out":
        ids = np.where(np.arange(N) % 2 == 0, -1 - ids, V + ids)
    elif case == "mixed":
        ids[:9] = ids[9]
        ids[10], ids[11] = -1, V
    elif case == "v_odd":
        ids[:4] = V - 1
    ids = torch.tensor(ids, dtype=torch.int64)
    dout = torch.tensor(rng.standard_normal((N, 5)).astype(np.float32)
                        ).to(dtype)
    assert grad_path(N, V) == "block"
    assert torch.equal(_block_path(ids, dout, V),
                       gather_grad_ref(ids, dout, V))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gather_grad_path_and_key_bits_for_every_vocabulary(arch):
    """For each configuration's vocabulary: the launcher takes the one-block
    path up to BLOCK_MAX_N ids and torch.sort's above; the largest id and
    position of that path pack into a key below the out-of-range key
    0xffffffff and unpack to themselves."""
    V = ARCHS[arch].vocab
    assert V <= BLOCK_MAX_V
    assert grad_path(BLOCK_MAX_N, V) == "block"
    assert grad_path(BLOCK_MAX_N + 1, V) == "sort"
    key = (V - 1) << KEY_POS_BITS | (BLOCK_MAX_N - 1)
    assert key < 0xFFFFFFFF
    assert key >> KEY_POS_BITS == V - 1
    assert key & ((1 << KEY_POS_BITS) - 1) == BLOCK_MAX_N - 1
    assert grad_path(1, BLOCK_MAX_V + 1) == "sort"
