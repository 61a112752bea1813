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
    manual expert parallelism (:func:`_moe_manual_ep`) under a sharding
    context whose ``ep`` axes have more than one rank and divide the
    experts; elsewhere ``scatter``, as the reference falls back.

**Under a mesh** each rank holds its rows of the batch.  ``scatter``
keeps the one-device semantics the reference's GSPMD keeps: the
capacity comes from the global token count, an assignment's position
in its expert counts the assignments of the lower batch ranks first
(the global flat order; an all-gather of one count per expert), and the
aux loss is computed from the all-reduced per-expert sums.  Each rank
computes only its own buffer rows (an expert's rows are independent).
``einsum`` and ``grouped`` gather the rows over the batch axes, run the
one-device implementation on all of them and keep this rank's rows
(their gradient: the cut), with the aux loss from this rank's rows as
``scatter``'s.  Manual EP follows the
reference's schedule: each rank routes its tokens against the full
router, scatters only the assignments bound for its ``E / ep`` experts
into a buffer of group-local capacity ``moe_capacity(cfg, N_local)``,
runs its experts, and all-reduces the ``(N_local, d)`` output in the
compute dtype over the ``ep`` axes; the aux loss, group-local, is
averaged over the batch axes.  For training, the input's gradient is
summed over the ``ep`` axes and the router's too (each rank's covers its
experts), and each ``ep`` rank carries ``1/ep`` of the aux loss's.

Under a tensor-parallel split the MoE layer is not split over ``tp``
(its leaves have no ``tp`` axis): every ``tp`` rank computes it whole on
the whole stream, or, with ``ep`` on the same axis, its own experts.
Under ``sp_act`` the block gathers the stream's sequence blocks before
the layer and keeps its own block after it
(:mod:`repro_torch.models.blocks`).

The reference's ``scatter-add`` into ``E * C + 1`` rows sends every
dropped assignment, multiplied by 0, to the extra row and cuts it away;
the port writes every assignment's token into ``E * C + 1`` rows (each
kept slot is unique, so the kept rows hold the same values; the dropped
ones land in the extra row, which is cut), with no boolean mask, so no
shape depends on the data (fake tensors, the dry run) and no host
sync.  Plain PyTorch: the reference has no Pallas kernel for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import fsdp
from .layers import Params, activation

__all__ = ["init_moe", "moe_forward", "moe_capacity", "ep_shards",
           "gather_moe"]


def init_moe(p: Params, cfg):
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p.add("router", (d, E), (None, "ep"), scale=1.0 / math.sqrt(d))
    p.add("w_gate", (E, d, ff), ("ep", "fsdp", None),
          scale=1.0 / math.sqrt(d))
    p.add("w_up", (E, d, ff), ("ep", "fsdp", None),
          scale=1.0 / math.sqrt(d))
    p.add("w_down", (E, ff, d), ("ep", None, "fsdp"),
          scale=1.0 / math.sqrt(ff))


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


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in ``[0, n)``, as a
    tensor of ``n`` int64 counts whatever the values (no host sync, and
    a shape fake tensors know)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _aux_loss(cfg, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss: ``E * sum_e f_e * P_e``."""
    E = cfg.n_experts
    counts = _counts(idx.reshape(-1), E).float()
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
    counts = _counts(e_flat, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty((nk,), dtype=torch.int64, device=e_flat.device)
    pos[order] = torch.arange(nk, device=e_flat.device) \
        - starts[e_flat[order]]
    return pos


def _dispatch(params, cfg, xt, gates, slot, keep, n_rows: int, dtype):
    """The kept assignments' tokens into ``n_rows`` buffer rows, the
    expert FFNs (of ``params``'s experts), and the gated outputs summed
    over each token's ``k`` assignments in float32: (N, d).  A dropped
    assignment's ``slot`` is ``n_rows``: its token goes to one more row,
    which is cut (no boolean mask, so no host sync)."""
    E, k = params["w_gate"].shape[0], cfg.top_k
    N, d = xt.shape
    tok = torch.arange(N, device=xt.device).repeat_interleave(k)
    buf = xt.new_zeros((n_rows + 1, d), dtype=dtype)
    buf[slot] = xt[tok].to(dtype)
    out_buf = _expert_ffn(params, cfg,
                          buf[:n_rows].reshape(E, n_rows // E, d), dtype)
    gk = (gates.reshape(-1) * keep).to(dtype)
    got = out_buf.reshape(n_rows, d)[torch.clamp(slot, 0, n_rows - 1)]
    return (got * gk[:, None]).reshape(N, k, d).float().sum(1)


def ep_shards(cfg):
    """``(mesh, ep axes, ep shards)`` of manual expert parallelism under
    the active sharding context: ``ep`` axes the mesh has, in the rules'
    order, of more than one rank in all and dividing the experts; else
    ``None`` (the reference's fallback to ``scatter``)."""
    ctx = fsdp.active()
    if ctx is None:
        return None
    mesh, rules = ctx
    axes = tuple(a for a in rules.ep if a in mesh.mesh_dim_names)
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    if n == 1 or cfg.n_experts % n:
        return None
    return mesh, axes, n


def gather_moe(module, mesh, rules, ep: bool) -> dict:
    """A MoE layer's parameters as the layer reads them under a mesh
    (:func:`repro_torch.dist.fsdp.gather`); under expert parallelism
    (``ep``) each rank keeps its own experts and the router's gradient
    is summed over the ``ep`` axes (each rank's covers its experts)."""
    out = {}
    for n, p in module.named_parameters(recurse=False):
        router = n == "router"
        out[n] = fsdp.gather(
            p, mesh, rules, keep_axes=rules.ep if ep and not router else (),
            sum_axes=rules.ep if ep and router else ())
    return out


def _own_experts(w: torch.Tensor, E: int, off: int, n: int):
    """This rank's ``n`` experts from ``off``: ``w`` itself when it holds
    only those (a placed parameter's block), else its slice."""
    return w[off:off + n] if w.shape[0] == E else w


def _moe_manual_ep(params, cfg, x: torch.Tensor, dtype):
    """Manual expert parallelism (module docstring): ``(y, aux)`` for this
    rank's rows ``x``, or ``None`` where the reference falls back."""
    sh = ep_shards(cfg)
    if sh is None:
        return None
    mesh, axes, n_ep = sh
    _, rules = fsdp.active()
    ep_dims = fsdp.axis_dims(mesh, axes)
    b_dims = fsdp.batch_dims(mesh, rules)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // n_ep
    Nl = B * S
    xt = fsdp.sum_grad(x, mesh, ep_dims).reshape(Nl, d)
    probs, gates, idx = _route(params, cfg, xt.float())
    aux = _aux_loss(cfg, probs, idx)
    aux = aux.detach() + (aux - aux.detach()) / n_ep
    if b_dims:
        n_b = math.prod(mesh.size(i) for i in b_dims)
        aux = fsdp.reduced(aux / n_b, mesh, b_dims)
    off = fsdp.axes_offset(mesh, axes, E_loc)
    e_flat = idx.reshape(-1)
    local = (e_flat >= off) & (e_flat < off + E_loc)
    e_loc = torch.where(local, e_flat - off, E_loc)
    C_loc = moe_capacity(cfg, Nl)
    pos = _positions_in_expert(e_loc, E_loc + 1)
    keep = local & (pos < C_loc)
    slot = torch.where(keep, e_loc * C_loc + pos, E_loc * C_loc)
    own = {n: _own_experts(params[n], E, off, E_loc)
           for n in ("w_gate", "w_up", "w_down")}
    y = _dispatch(own, cfg, xt, gates, slot, keep, E_loc * C_loc, dtype)
    y = fsdp.reduced(y.to(dtype), mesh, ep_dims)
    return y.reshape(B, S, d).to(x.dtype), aux


def _split_batch():
    """``(mesh, batch dims, shards)`` when the active context splits the
    batch, else ``None``."""
    ctx = fsdp.active()
    dims = () if ctx is None else fsdp.batch_dims(*ctx)
    if not dims:
        return None
    return ctx[0], dims, math.prod(ctx[0].size(i) for i in dims)


def _global_aux(cfg, probs, idx, split) -> torch.Tensor:
    """:func:`_aux_loss` over every rank's rows: the per-expert counts
    and probability sums all-reduced; the gradient is this rank's part."""
    mesh, dims, n = split
    E = cfg.n_experts
    counts = _counts(idx.reshape(-1), E).float()
    counts = fsdp.reduced(counts, mesh, dims)
    f = counts / (idx.numel() * n)
    P = fsdp.reduced(probs.sum(dim=0), mesh, dims) / (probs.shape[0] * n)
    return E * torch.sum(f * P)


def _all_rows_moe(params, cfg, x: torch.Tensor, impl: str, dtype, groups,
                  split):
    """``einsum`` or ``grouped`` under a split batch (module docstring):
    every rank's rows gathered, the one-device implementation on them,
    this rank's rows kept; the aux loss of :func:`_global_aux` on this
    rank's rows, its gradient this rank's part."""
    mesh, dims, _ = split
    rules = fsdp.active()[1]
    whole = fsdp.gather_rows(x, mesh, rules)
    B, S, d = whole.shape
    xt = whole.reshape(B * S, d)
    probs, gates, idx = _route(params, cfg, xt.float())
    if impl == "einsum":
        y = _einsum_dispatch(params, cfg, xt.float(), gates, idx,
                             moe_capacity(cfg, B * S), dtype)
    else:
        y = _grouped_dispatch(params, cfg, xt, gates, idx,
                              moe_capacity(cfg, B * S), dtype, groups)
    own = fsdp.batch_block(y.reshape(B, S, d).to(x.dtype), mesh, rules)
    mine = fsdp.batch_block(probs.reshape(B, S, -1), mesh, rules)
    ids = fsdp.batch_block(idx.reshape(B, S, -1), mesh, rules)
    aux = _global_aux(cfg, mine.reshape(-1, cfg.n_experts),
                      ids.reshape(-1, cfg.top_k), split)
    return own, aux


def _einsum_dispatch(params, cfg, xf, gates, idx, C: int, dtype):
    """GShard-style dense dispatch of ``N`` tokens ``xf`` (float32) at
    capacity ``C``: (N, d) float32."""
    E = cfg.n_experts
    onehot = F.one_hot(idx, E).float()                     # (N, k, E)
    sel = onehot.sum(1)                                    # (N, E)
    pos = torch.cumsum(sel, 0) - sel                       # pre-count
    pos_k = torch.einsum("nke,ne->nk", onehot, pos)        # (N, k)
    keep = pos_k < C
    # Index C (a dropped assignment) is an all-zero one-hot row.
    slot = F.one_hot(torch.where(keep, pos_k, C).long(),
                     C + 1)[..., :C].float()               # (N, k, C)
    disp = torch.einsum("nke,nkc->nec", onehot, slot)      # (N, E, C)
    buf = torch.einsum("nec,nd->ecd", disp, xf).to(dtype)
    out_buf = _expert_ffn(params, cfg, buf, dtype).float()
    comb = torch.einsum("nec,nk,nke->nec", disp, gates, onehot)
    return torch.einsum("nec,ecd->nd", comb, out_buf)


def _grouped_dispatch(params, cfg, xt, gates, idx, C: int, dtype,
                      groups):
    """Capacity counted per dispatch group of ``N`` tokens ``xt``: (N, d)
    float32."""
    N = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    G = min(groups or 32, N)
    while N % G:
        G -= 1
    Cg = max(8, -(-C // G) // 8 * 8)
    # Group-major (e, g) keys: a stable sort over the whole list ranks
    # each group's assignments as the reference's per-group sort.
    e_g = idx.reshape(G, N // G * k)
    g_ix = torch.arange(G, device=xt.device)[:, None]
    pos = _positions_in_expert((e_g * G + g_ix).reshape(-1), E * G)
    keep = pos < Cg
    slot = torch.where(keep, (e_g * G + g_ix).reshape(-1) * Cg + pos,
                       E * G * Cg)
    return _dispatch(params, cfg, xt, gates, slot, keep, E * G * Cg, dtype)


def moe_forward(params, cfg, x: torch.Tensor, *, impl: str = "scatter",
                dtype=torch.bfloat16, groups: int | None = None):
    """MoE FFN.  ``x``: (B, S, d) -> ((B, S, d), aux loss); under a mesh
    ``x`` is this rank's rows (module docstring)."""
    if impl == "ep":
        out = _moe_manual_ep(params, cfg, x, dtype)
        if out is not None:
            return out
        impl = "scatter"
    B, S, d = x.shape
    N = B * S
    xt = x.reshape(N, d)
    xf = xt.float()
    C = moe_capacity(cfg, N)
    E = cfg.n_experts

    split = _split_batch()
    if split is not None and impl in ("einsum", "grouped"):
        return _all_rows_moe(params, cfg, x, impl, dtype, groups, split)
    probs, gates, idx = _route(params, cfg, xf)
    aux = (_aux_loss(cfg, probs, idx) if split is None
           else _global_aux(cfg, probs, idx, split))
    if impl == "einsum":
        y = _einsum_dispatch(params, cfg, xf, gates, idx, C, dtype)
        return y.reshape(B, S, d).to(x.dtype), aux
    if impl == "grouped":
        y = _grouped_dispatch(params, cfg, xt, gates, idx, C, dtype, groups)
        return y.reshape(B, S, d).to(x.dtype), aux
    if impl != "scatter":
        raise ValueError(f"unknown moe impl {impl!r}")
    e_flat = idx.reshape(-1)                               # (N * k,)
    pos = _positions_in_expert(e_flat, E)
    if split is None:
        keep = pos < C
    else:
        mesh, dims, n = split
        C = moe_capacity(cfg, N * n)
        before, _ = fsdp.rank_prefix(_counts(e_flat, E), mesh, dims)
        keep = pos + before[e_flat] < C
    slot = torch.where(keep, e_flat * C + pos, E * C)
    y = _dispatch(params, cfg, xt, gates, slot, keep, E * C, dtype)
    return y.reshape(B, S, d).to(x.dtype), aux
