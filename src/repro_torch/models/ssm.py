"""SSM blocks, counterpart of ``repro/models/ssm.py``: Mamba (S6) and
xLSTM (mLSTM / sLSTM).

* **Mamba** runs the selective recurrence ``h_t = exp(dt_t A) h_{t-1} +
  dt_t B_t x_t`` as the reference does: a loop over sequence chunks of
  ``chunk`` tokens, a log-depth scan inside each chunk, so that memory
  stays ``O(B * chunk * d_inner * d_state)``.  The reference's in-chunk
  ``jax.lax.associative_scan`` has no PyTorch counterpart; here it is a
  Hillis-Steele doubling scan over the chunk axis with the same combine,
  so the sums round in another order (float32: within 2e-4 of the
  reference).  Plain PyTorch: the reference has no Pallas kernel for it.
* **mLSTM** runs the chunkwise-parallel form: within a chunk the matrix
  memory is applied as decayed attention; across chunks a recurrent
  ``(hd x hd)`` state ``C`` and normaliser ``n`` are carried with
  max-stabilised exponential gates (arXiv:2405.04517, eqs. 19-27).  Plain
  PyTorch: the reference has no Pallas kernel for it.
* **sLSTM** is sequential; its recurrence runs through kernel row 10
  (:mod:`repro_torch.kernels.slstm_ops`): the CUDA kernel on the card,
  the plain recurrence on the CPU, in prefill and in every decode step
  (a launch at S = 1 from the cached state).

The ``-inf`` stabiliser starts (``m``) give 0, never NaN: ``exp(-inf) =
0`` and every ``m_new`` is finite.

Under a tensor-parallel split (:mod:`repro_torch.dist.tp`) each mixer
takes a rank's blocks (the fused ``in_proj``, ``qkv``, ``gates`` and
``zifo`` cut part by part) and runs on its channels or heads: the
widths come from the weights, the caches' from the split.  A mixer whose
heads or channels the split does not divide takes its weights whole and
runs as on one device (:func:`repro_torch.dist.tp.sub_split`).  Mamba's
``x_proj`` is row-parallel into outputs every channel reads, so its
partial sums are all-reduced (:func:`tp.shared`); the out-projections'
partial sums are reduced by the block.
"""

from __future__ import annotations

import math

import torch

from ..dist import tp
from ..kernels.slstm_ops import fused_slstm_forward
from ..kernels.slstm_ref import init_slstm_state, softplus
from .layers import Params, dense, init_dense, silu

__all__ = [
    "init_mamba", "mamba_forward", "mamba_step", "init_mamba_cache",
    "init_mlstm", "mlstm_forward", "mlstm_step", "init_mlstm_cache",
    "init_slstm", "slstm_forward", "slstm_step", "init_slstm_cache",
]

_SLSTM_KEYS = ("c", "n", "h", "m")


# ======================================================================
# Mamba (S6)
# ======================================================================

def init_mamba(p: Params, cfg):
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    init_dense(p, "in_proj", d, 2 * di, ("fsdp", "tp"))
    p.add("conv_w", (cfg.d_conv, di), (None, "tp"), scale=1.0 / math.sqrt(cfg.d_conv))
    p.add("conv_b", (di,), ("tp",), init="zeros")
    init_dense(p, "x_proj", di, 2 * ds + 1, ("tp", None))
    p.add("dt_bias", (di,), ("tp",), init="zeros")
    p.add("A_log", (di, ds), ("tp", None), init="ones")
    p.add("D", (di,), ("tp",), init="ones")
    init_dense(p, "out_proj", di, d, ("tp", "fsdp"))


def _mamba_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                carry: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence, its ``K`` taps summed in
    tap order.  ``x``: (B, S, di); ``carry``: the ``K - 1`` inputs before
    ``x`` (zeros without one).  Returns (out, the last ``K - 1``
    inputs)."""
    K, S = w.shape[0], x.shape[1]
    if carry is None:
        carry = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, (xp[:, -(K - 1):] if K > 1 else carry)


def _ssm_scan_chunk(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor):
    """Scan of ``h_t = dA_t * h_{t-1} + dBx_t`` over a chunk.

    ``dA``, ``dBx``: (B, C, di, ds); ``h0``: (B, di, ds).  A doubling
    scan: after the round at offset ``o`` each position holds the
    combination of the ``2 o`` positions up to it, ``combine(a, b) =
    (a0 b0, b0 a1 + b1)`` with ``a`` the earlier (the reference's).
    Returns (states (B, C, di, ds), h_last)."""
    C = dA.shape[1]
    off = 1
    while off < C:
        dBx = torch.cat([dBx[:, :off],
                         dA[:, off:] * dBx[:, :-off] + dBx[:, off:]], dim=1)
        dA = torch.cat([dA[:, :off], dA[:, :-off] * dA[:, off:]], dim=1)
        off *= 2
    states = dA * h0[:, None] + dBx
    return states, states[:, -1]


def _mamba_in(params, cfg, x, dtype, carry=None):
    """The mixer up to the recurrence: (x after the conv and silu in
    ``dtype``, z, B, C, dt (float32), A, the conv's carry)."""
    ds = cfg.d_state
    xi, z = dense(params, "in_proj", x, dtype).chunk(2, dim=-1)
    xi, conv = _mamba_conv(xi, params["conv_w"].to(dtype),
                           params["conv_b"].to(dtype), carry)
    xi = silu(xi)
    bcd = tp.shared(dense(params, "x_proj", xi, dtype),
                    tp.sub_split(cfg, "mamba", tp.split())).float()
    # dt is one value a token, broadcast over d_inner by dt_bias (as the
    # reference's x_proj of 2 * ds + 1 outputs).
    Bm, Cm, dt = bcd[..., :ds], bcd[..., ds:2 * ds], bcd[..., -1:]
    dt = softplus(dt + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())               # (di, ds)
    return xi, z, Bm, Cm, dt, A, conv


def _mamba_out(params, xi, y, z, dtype):
    y = y + xi.float() * params["D"].float()
    return dense(params, "out_proj", y.to(dtype) * silu(z), dtype)


def mamba_forward(params, cfg, x: torch.Tensor, *, chunk: int = 256,
                  dtype=torch.bfloat16, return_state: bool = False):
    """Full-sequence selective SSM.  ``x``: (B, S, d) -> (B, S, d).

    A loop over chunks of ``chunk`` tokens (one chunk of ``S`` where
    ``chunk`` does not divide ``S``, as the reference), carrying ``h``.
    ``return_state=True`` also returns the decode cache after the last
    token: the conv's last inputs in float32 and ``h``."""
    B, S, _ = x.shape
    xi, z, Bm, Cm, dt, A, conv = _mamba_in(params, cfg, x, dtype)
    xf = xi.float()
    if S % chunk:
        chunk = S
    h = torch.zeros((B, xi.shape[-1], cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dtb = dt[:, sl]
        dA = torch.exp(dtb[..., None] * A)                 # (B, C, di, ds)
        dBx = (dtb * xf[:, sl])[..., None] * Bm[:, sl, None, :]
        states, h = _ssm_scan_chunk(dA, dBx, h)
        ys.append(torch.einsum("bcds,bcs->bcd", states, Cm[:, sl]))
        del dA, dBx, states
    out = _mamba_out(params, xi, torch.cat(ys, dim=1), z, dtype)
    if return_state:
        return out, {"conv": conv.float(), "h": h}
    return out


def init_mamba_cache(cfg, batch: int, dtype=torch.float32, *,
                     device) -> dict:
    di = tp.local_inner(cfg, "mamba")
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba_step(params, cfg, x: torch.Tensor, cache: dict, *,
               dtype=torch.bfloat16):
    """Single-token recurrent step.  ``x``: (B, 1, d); the cached conv
    inputs are cast to ``dtype`` and stored back in their own dtype."""
    xi, z, Bm, Cm, dt, A, conv = _mamba_in(
        params, cfg, x, dtype, carry=cache["conv"].to(dtype))
    xf = xi.float()[:, 0]                                  # (B, di)
    dA = torch.exp(dt[:, 0, :, None] * A)                  # (B, di, ds)
    h = cache["h"] * dA + (dt[:, 0] * xf)[..., None] * Bm[:, 0, None, :]
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None]
    out = _mamba_out(params, xi, y, z, dtype)
    return out, {"conv": conv.to(cache["conv"].dtype), "h": h}


# ======================================================================
# mLSTM (matrix LSTM, chunkwise-parallel)
# ======================================================================

def init_mlstm(p: Params, cfg):
    d, di = cfg.d_model, cfg.d_inner
    init_dense(p, "qkv", d, 3 * di, ("fsdp", "tp"))
    init_dense(p, "gates", d, 2 * cfg.n_heads, ("fsdp", "tp"))
    init_dense(p, "up", d, di, ("fsdp", "tp"))
    init_dense(p, "out_proj", di, d, ("tp", "fsdp"))


def _mlstm_hd(cfg) -> int:
    return cfg.d_inner // cfg.n_heads


def _mlstm_local_heads(cfg) -> int:
    """This rank's mLSTM heads: all of them where the mixer runs whole
    (heads or ``d_inner`` that the split does not divide)."""
    s = tp.sub_split(cfg, "mlstm", tp.split())
    return cfg.n_heads if s is None else cfg.n_heads // s.n


def _mlstm_heads(cfg, t: torch.Tensor) -> torch.Tensor:
    B, S, di = t.shape
    return t.reshape(B, S, -1, _mlstm_hd(cfg))


def mlstm_forward(params, cfg, x: torch.Tensor, *, chunk: int = 128,
                  dtype=torch.bfloat16, return_state: bool = False):
    """Chunkwise-parallel mLSTM.  ``x``: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    H = _mlstm_local_heads(cfg)
    hd = _mlstm_hd(cfg)
    di = H * hd
    qkv = dense(params, "qkv", x, dtype)
    q, k, v = (_mlstm_heads(cfg, t).float() for t in qkv.chunk(3, dim=-1))
    gates = dense(params, "gates", x, dtype).float()
    ig, fg = gates.chunk(2, dim=-1)                        # (B, S, H)
    logf = -softplus(-fg)                                  # log sigmoid

    if S % chunk:
        chunk = S
    scale = 1.0 / math.sqrt(hd)
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, :, :, None]

    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    nvec = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    m = torch.full((B, H), -torch.inf, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, ib, fb = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], \
            logf[:, sl]
        csum = torch.cumsum(fb, dim=1)                     # (B, C, H)
        total = csum[:, -1]
        # One chunk-level stabiliser suffices: log-sigmoid forget gates
        # are <= 0, so every exponent below is bounded by max(m, ig_k).
        m_new = torch.maximum(m, ib.amax(dim=1))
        # Intra-chunk decayed attention.
        dmat = csum[:, :, None] - csum[:, None, :] + ib[:, None, :]
        dmat = torch.where(causal, dmat - m_new[:, None, None, :],
                           -torch.inf)                     # (B,Cq,Ck,H)
        att = torch.einsum("bqhd,bkhd->bqkh", qb, kb) * scale
        w = att * torch.exp(dmat)
        intra = torch.einsum("bqkh,bkhd->bqhd", w, vb)
        # Inter-chunk: the carried state, decayed to each position.
        dec = torch.exp(csum + m[:, None] - m_new[:, None])  # (B, C, H)
        qdec = qb * dec[..., None]
        inter = torch.einsum("bqhd,bhde->bqhe", qdec, C) * scale
        norm = w.sum(dim=2) \
            + torch.einsum("bqhd,bhd->bqh", qdec, nvec) * scale
        y = (intra + inter) / torch.maximum(
            norm.abs()[..., None], torch.exp(-m_new)[:, None, :, None])
        # State update: position k decays by the rest of the chunk's
        # gates, exponent ig_k + (total - csum_k) - m_new.
        kdec = torch.exp(ib + total[:, None] - csum - m_new[:, None])
        kk = kb * kdec[..., None]
        carry = torch.exp(total + m - m_new)
        C = C * carry[..., None, None] \
            + torch.einsum("bkhd,bkhe->bhde", kk, vb)
        nvec = nvec * carry[..., None] + kk.sum(dim=1)
        m = m_new
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, di).to(dtype)
    y = y * silu(dense(params, "up", x, dtype))
    out = dense(params, "out_proj", y, dtype)
    if return_state:
        return out, {"C": C, "n": nvec, "m": m}
    return out


def init_mlstm_cache(cfg, batch: int, *, device) -> dict:
    H = _mlstm_local_heads(cfg)
    hd = _mlstm_hd(cfg)
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), -torch.inf, dtype=torch.float32,
                        device=device),
    }


def mlstm_step(params, cfg, x: torch.Tensor, cache: dict, *,
               dtype=torch.bfloat16):
    """O(1)-state decode step.  ``x``: (B, 1, d)."""
    B = x.shape[0]
    H = _mlstm_local_heads(cfg)
    hd = _mlstm_hd(cfg)
    di = H * hd
    qkv = dense(params, "qkv", x, dtype)
    q, k, v = (_mlstm_heads(cfg, t)[:, 0].float()
               for t in qkv.chunk(3, dim=-1))              # (B, H, hd)
    gates = dense(params, "gates", x, dtype).float()[:, 0]
    ig, fg = gates.chunk(2, dim=-1)                        # (B, H)
    logf = -softplus(-fg)
    C, nvec, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m, ig)
    fdec = torch.exp(logf + m - m_new)
    idec = torch.exp(ig - m_new)
    C_new = C * fdec[..., None, None] \
        + idec[..., None, None] * k[..., :, None] * v[..., None, :]
    n_new = nvec * fdec[..., None] + idec[..., None] * k
    scale = 1.0 / math.sqrt(hd)
    num = torch.einsum("bhd,bhde->bhe", q, C_new) * scale
    den = torch.einsum("bhd,bhd->bh", q, n_new) * scale
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    y = y.reshape(B, 1, di).to(dtype)
    y = y * silu(dense(params, "up", x, dtype))
    out = dense(params, "out_proj", y, dtype)
    return out, {"C": C_new, "n": n_new, "m": m_new}


# ======================================================================
# sLSTM (scalar memory, sequential): the recurrence is kernel row 10
# ======================================================================

def init_slstm(p: Params, cfg):
    d, di = cfg.d_model, cfg.d_inner
    init_dense(p, "zifo", d, 4 * di, ("fsdp", "tp"))
    p.add("r_zifo", (4, di), (None, "tp"), scale=1.0 / math.sqrt(di))   # diag recurrence
    init_dense(p, "out_proj", di, d, ("tp", "fsdp"))


def _state_dict(state: torch.Tensor) -> dict:
    return dict(zip(_SLSTM_KEYS, state.unbind(0)))


def slstm_forward(params, cfg, x: torch.Tensor, *, dtype=torch.bfloat16,
                  return_state: bool = False):
    """The sLSTM mixer over a sequence.  ``x``: (B, S, d)."""
    if not return_state:
        return fused_slstm_forward(params, cfg, x, dtype=dtype)
    out, state = fused_slstm_forward(params, cfg, x, dtype=dtype,
                                     return_state=True)
    return out, _state_dict(state)


def init_slstm_cache(cfg, batch: int, *, device) -> dict:
    return _state_dict(init_slstm_state(
        batch, tp.local_inner(cfg, "slstm"), device=device))


def slstm_step(params, cfg, x: torch.Tensor, cache: dict, *,
               dtype=torch.bfloat16):
    """One token from the cached state: the recurrence at S = 1."""
    state = torch.stack([cache[k] for k in _SLSTM_KEYS])
    out, new = fused_slstm_forward(params, cfg, x, dtype=dtype, state=state,
                                   return_state=True)
    return out, _state_dict(new)
