"""Mixture-of-Experts layer, counterpart of ``repro/models/moe.py``.

Tokens are routed to ``top_k`` of ``n_experts`` experts (router in
float32, renormalised top-k gates), placed into per-expert buffers of
capacity ``C = ceil(top_k * N / E * capacity_factor)`` (rounded up to a
multiple of 8, at least 8; overflow assignments drop, empty slots compute
zeros), the expert FFNs run as dense batched einsums over every expert,
and the results gather back.  Dispatch implementations, as the
reference's:

``scatter`` (default)
    position-in-expert by a stable sort of the token-major assignment
    list, the kept rows written into an ``(E, C, d)`` buffer, a ``take``
    back, the combine in the compute dtype and the k-sum in float32.
``einsum``
    GShard-style dense dispatch mask ``(N, E, C)`` einsums, in float32.
``grouped``
    capacity counted per dispatch group (``groups``, 32 by default), so
    a different set of tokens may drop under overflow.
``ep``
    the reference's manual expert parallelism runs only under a mesh,
    which the port does not have yet (ROADMAP Queue 1, item 8); without
    one the reference falls back to ``scatter``, and so does the port.

The reference's ``scatter-add`` into ``E * C + 1`` rows sends every
dropped assignment, multiplied by 0, to the extra row and cuts it away;
the port writes the kept rows only (each kept slot is unique, so the
values are the same) and needs no extra row.  Plain PyTorch: the
reference has no Pallas kernel for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params, activation

__all__ = ["init_moe", "moe_forward", "moe_capacity"]


def init_moe(p: Params, cfg):
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p.add("router", (d, E), scale=1.0 / math.sqrt(d))
    p.add("w_gate", (E, d, ff), scale=1.0 / math.sqrt(d))
    p.add("w_up", (E, d, ff), scale=1.0 / math.sqrt(d))
    p.add("w_down", (E, ff, d), scale=1.0 / math.sqrt(ff))


def moe_capacity(cfg, n_tokens: int) -> int:
    c = math.ceil(cfg.top_k * n_tokens / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)     # round up to a multiple of 8


def _route(params, cfg, xf: torch.Tensor):
    """Router logits -> (probs, gates, idx) with renormalised top-k
    weights."""
    logits = xf @ params["router"].float()                 # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)      # (N, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _aux_loss(cfg, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss: ``E * sum_e f_e * P_e``."""
    E = cfg.n_experts
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    f = counts / max(idx.numel(), 1)
    return E * torch.sum(f * probs.mean(dim=0))


def _expert_ffn(params, cfg, buf: torch.Tensor, dtype) -> torch.Tensor:
    """Batched expert FFNs over every expert.  ``buf``: (E, C, d) ->
    (E, C, d)."""
    g = torch.bmm(buf, params["w_gate"].to(dtype))
    u = torch.bmm(buf, params["w_up"].to(dtype))
    return torch.bmm(activation("swiglu")(g) * u, params["w_down"].to(dtype))


def _positions_in_expert(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Each assignment's position in its expert, in list order: a stable
    sort, each expert's start subtracted (O(N * k) memory)."""
    nk = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty((nk,), dtype=torch.int64, device=e_flat.device)
    pos[order] = torch.arange(nk, device=e_flat.device) \
        - starts[e_flat[order]]
    return pos


def _dispatch(params, cfg, xt, gates, slot, keep, n_rows: int, dtype):
    """The kept assignments' tokens into ``n_rows`` buffer rows, the
    expert FFNs, and the gated outputs summed over each token's ``k``
    assignments in float32: (N, d)."""
    E, k = cfg.n_experts, cfg.top_k
    N, d = xt.shape
    tok = torch.arange(N, device=xt.device).repeat_interleave(k)
    buf = xt.new_zeros((n_rows, d), dtype=dtype)
    buf[slot[keep]] = xt[tok[keep]].to(dtype)
    out_buf = _expert_ffn(params, cfg, buf.reshape(E, n_rows // E, d),
                          dtype)
    gk = (gates.reshape(-1) * keep).to(dtype)
    got = out_buf.reshape(n_rows, d)[torch.clamp(slot, 0, n_rows - 1)]
    return (got * gk[:, None]).reshape(N, k, d).float().sum(1)


def moe_forward(params, cfg, x: torch.Tensor, *, impl: str = "scatter",
                dtype=torch.bfloat16, groups: int | None = None):
    """MoE FFN.  ``x``: (B, S, d) -> ((B, S, d), aux loss)."""
    B, S, d = x.shape
    N = B * S
    xt = x.reshape(N, d)
    xf = xt.float()
    C = moe_capacity(cfg, N)
    E, k = cfg.n_experts, cfg.top_k

    probs, gates, idx = _route(params, cfg, xf)
    aux = _aux_loss(cfg, probs, idx)

    if impl == "ep":
        impl = "scatter"             # no mesh in the port (item 8)
    if impl == "einsum":
        onehot = F.one_hot(idx, E).float()                 # (N, k, E)
        sel = onehot.sum(1)                                # (N, E)
        pos = torch.cumsum(sel, 0) - sel                   # pre-count
        pos_k = torch.einsum("nke,ne->nk", onehot, pos)    # (N, k)
        keep = pos_k < C
        # Index C (a dropped assignment) is an all-zero one-hot row.
        slot = F.one_hot(torch.where(keep, pos_k, C).long(),
                         C + 1)[..., :C].float()           # (N, k, C)
        disp = torch.einsum("nke,nkc->nec", onehot, slot)  # (N, E, C)
        buf = torch.einsum("nec,nd->ecd", disp, xf).to(dtype)
        out_buf = _expert_ffn(params, cfg, buf, dtype).float()
        comb = torch.einsum("nec,nk,nke->nec", disp, gates, onehot)
        y = torch.einsum("nec,ecd->nd", comb, out_buf)
        return y.reshape(B, S, d).to(x.dtype), aux
    if impl == "grouped":
        G = min(groups or 32, N)
        while N % G:
            G -= 1
        Cg = max(8, -(-C // G) // 8 * 8)
        # Group-major (e, g) keys: a stable sort over the whole list ranks
        # each group's assignments as the reference's per-group sort.
        e_g = idx.reshape(G, N // G * k)
        g_ix = torch.arange(G, device=x.device)[:, None]
        pos = _positions_in_expert((e_g * G + g_ix).reshape(-1), E * G)
        keep = pos < Cg
        slot = torch.where(keep, (e_g * G + g_ix).reshape(-1) * Cg + pos,
                           E * G * Cg)
        y = _dispatch(params, cfg, xt, gates, slot, keep, E * G * Cg, dtype)
        return y.reshape(B, S, d).to(x.dtype), aux
    if impl != "scatter":
        raise ValueError(f"unknown moe impl {impl!r}")
    e_flat = idx.reshape(-1)                               # (N * k,)
    pos = _positions_in_expert(e_flat, E)
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, E * C)
    y = _dispatch(params, cfg, xt, gates, slot, keep, E * C, dtype)
    return y.reshape(B, S, d).to(x.dtype), aux
