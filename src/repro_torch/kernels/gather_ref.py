"""Plain PyTorch version of the row gather (kernel row 9).

``table[ids]`` with out-of-range ids mapped to zero rows: the exact
semantics of the TPU kernel ``repro/kernels/gather.py::onehot_gather_kernel``
(a one-hot product), and of the CUDA kernel ``csrc/gather.cu``, which the
card runs in its place.  :func:`gather_grad_ref` is the plain version
of its backward (``csrc/gather.cu``'s row 9b).  Both take the launchers'
arguments, the shard ``offset`` included (``table`` is rows ``[offset,
offset + V)`` of a larger vocabulary), so either stands in for its
launcher.
"""

from __future__ import annotations

import torch

__all__ = ["gather_grad_ref", "gather_ref"]


def gather_ref(table: torch.Tensor, ids: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    """``table[ids - offset]`` for any ids shape; zero rows where an id is
    outside ``[offset, offset + V)``."""
    V = table.shape[0]
    ids = ids - offset
    ok = (ids >= 0) & (ids < V)
    rows = table[ids.clamp(0, V - 1)]
    return rows.masked_fill(~ok[..., None], 0)


def gather_grad_ref(ids: torch.Tensor, dout: torch.Tensor, V: int,
                    offset: int = 0) -> torch.Tensor:
    """``onehot(ids - offset)^T dout``: ``(V, D)`` in ``dout``'s dtype, row
    ``v`` the sum of the rows of ``dout`` (``(N, D)``) whose id (``ids``,
    ``(N,)``) is ``v + offset``, zero where none is; ids outside
    ``[offset, offset + V)`` add nothing.  Summed in float32 in position order (the k-th hit of every
    row in pass k, so no row is added to twice in one pass and the order
    holds on any device) and rounded once, as the kernel sums."""
    ids = ids.reshape(-1).to(device=dout.device, dtype=torch.int64) - offset
    ok = (ids >= 0) & (ids < V)
    D = dout.shape[-1]
    idx, rows = ids[ok], dout.reshape(ids.shape[0], D)[ok].float()
    acc = torch.zeros((V, D), dtype=torch.float32, device=dout.device)
    if idx.numel():
        order = torch.sort(idx, stable=True)
        pos = torch.arange(idx.numel(), device=idx.device)
        rank = pos - torch.searchsorted(order.values, order.values)
        for k in range(int(rank.max()) + 1):
            sel = rank == k
            hit, src = order.values[sel], order.indices[sel]
            acc[hit] = acc[hit] + rows[src]
    return acc.to(dout.dtype)
