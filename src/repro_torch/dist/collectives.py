"""Hand-scheduled all-reduce variants over one mesh axis.

The port's counterpart of ``repro.dist.collectives``.  JAX runs these
inside a ``shard_map`` region over a named mesh axis; here every rank
calls them (SPMD) inside a :func:`repro_torch.dist.sharding_context`,
and ``axis`` names the mesh dimension whose process group reduces.
Outside a context they raise.

* **latency**: thousands of tiny all-reduces (one per parameter leaf)
  are latency-bound; :func:`bucketed_psum` concatenates consecutive
  leaves into ``>= min_bucket_bytes`` flat buckets first, so the
  interconnect sees a few large transfers (exact: pure reordering).
* **bandwidth**: fp32 gradients move 4 bytes an element;
  :func:`compress_psum` moves int8 codes plus one scalar scale and keeps
  the quantisation residual on the device as *error feedback*, so the
  running average of compressed reductions converges to the true mean.
  The quantise-with-residual step is :func:`repro_torch.quant.quantize_ef`,
  shared with the ``strip_dtype="int8"`` detector wire.

Trees are anything :mod:`torch.utils._pytree` flattens (dicts, lists,
tuples of tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..quant import _div, quantize_ef
from .sharding import _CTX

__all__ = ["bucketed_psum", "compress_psum"]


def _group(axis: str):
    """The process group of mesh dimension ``axis`` of the ambient mesh."""
    ctx = _CTX.get()
    if ctx is None:
        raise RuntimeError(
            f"a collective over mesh axis {axis!r} needs an ambient "
            f"sharding_context (repro_torch.dist.sharding_context)")
    return ctx[0].get_group(axis)


def bucketed_psum(tree, axis: str, min_bucket_bytes: int = 1 << 22):
    """Exact all-reduce-sum of ``tree`` over ``axis``, few big transfers.

    Consecutive same-dtype leaves are flattened and concatenated until a
    bucket reaches ``min_bucket_bytes``, each bucket is all-reduced as
    one vector, and the leaves are sliced back out.  Bit-exact per leaf:
    concatenation commutes with the elementwise sum.  Returns new
    tensors; the inputs are not modified.
    """
    group = _group(axis)
    leaves, treedef = pytree.tree_flatten(tree)
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, leaf in enumerate(leaves):
        if cur and (leaf.dtype != cur_dtype
                    or cur_bytes >= min_bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_dtype = leaf.dtype
        cur_bytes += leaf.numel() * leaf.element_size()
    if cur:
        buckets.append(cur)

    out = [None] * len(leaves)
    for bucket in buckets:
        flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for i in bucket:
            n = leaves[i].numel()
            out[i] = flat[offset:offset + n].reshape(leaves[i].shape)
            offset += n
    return pytree.tree_unflatten(out, treedef)


def compress_psum(tree, axis: str, error_tree):
    """int8-compressed all-reduce-*mean* with error feedback.

    Per leaf: add the carried residual, quantise to int8 on a shared
    symmetric grid (scale = the global absmax, an all-reduce ``MAX``),
    all-gather the codes as ``torch.int8`` (the only non-scalar
    transfer, 1 byte an element), sum them locally in int32, and return
    the dequantised mean.  The new residual ``(x + e) - dequant(q)`` is
    returned for the caller to carry into the next step.

    Returns ``(mean_tree, new_error_tree)``.
    """
    group = _group(axis)
    n = dist.get_world_size(group)

    def one(g, e):
        g32, e32 = g.to(torch.float32), e.to(torch.float32)
        amax = torch.amax(torch.abs(g32 + e32))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _div(torch.clamp(amax, min=1e-30), 127.0)
        q, new_e = quantize_ef(g32, scale, error=e32)
        # int8 moves on the wire; the sum runs locally in int32.  An
        # all-reduce would widen the codes to 4 bytes and erase the whole
        # point of quantising.
        codes = q.to(torch.int8).reshape(-1)
        gathered = torch.empty(n * codes.numel(), dtype=torch.int8,
                               device=codes.device)
        dist.all_gather_into_tensor(gathered, codes, group=group)
        total = gathered.reshape((n,) + tuple(q.shape)).to(
            torch.int32).sum(dim=0)
        mean = _div(total.to(torch.float32) * scale, float(n))
        return mean.to(g.dtype), new_e.to(e.dtype)

    g_leaves, treedef = pytree.tree_flatten(tree)
    e_leaves = pytree.tree_leaves(error_tree)
    pairs = [one(g, e) for g, e in zip(g_leaves, e_leaves)]
    return (pytree.tree_unflatten([p[0] for p in pairs], treedef),
            pytree.tree_unflatten([p[1] for p in pairs], treedef))
