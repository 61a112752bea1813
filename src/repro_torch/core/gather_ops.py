"""Generalised gather strategies, counterpart of ``repro/core/gather_ops.py``.

``gather_impl`` values, as the reference's:

``take``
    ``table[ids]`` with clamped out-of-range ids (the reference's XLA
    gather, computed outside any kernel): a PyTorch index.
``onehot``
    the reference's chunked one-hot product.  On the CPU the port runs
    that product (``out += onehot(ids in tile) @ table[tile]`` over
    ``chunk``-row tiles of the vocabulary); on the card it launches the
    CUDA row gather (kernel row 9, :mod:`repro_torch.kernels.gather`),
    which equals the product bitwise: zero rows for out-of-range ids.
``auto``
    ``onehot`` for tables of at most :data:`ONEHOT_AUTO_MAX_ROWS` rows,
    ``take`` above.

Under a vocabulary split (:mod:`repro_torch.dist.tp`) ``table`` is rows
``[offset, offset + len(table))`` of a table of ``vocab`` rows: each
strategy returns that block's share of the whole gather, zero rows for
ids outside it, so the blocks sum to the whole.  ``onehot`` subtracts
the offset (its zero rows already cover the rest); ``take`` clamps to
the whole table first, as unsplit, then masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.gather_kernel_ops import cuda_onehot_gather

__all__ = ["gather", "take_gather", "onehot_gather", "ONEHOT_AUTO_MAX_ROWS"]

# The reference's crossover (its benchmarks/table4_gather_micro.py).
ONEHOT_AUTO_MAX_ROWS = 1024


def take_gather(table: torch.Tensor, ids: torch.Tensor, offset: int = 0,
                vocab: int | None = None) -> torch.Tensor:
    """Plain gather: ``table[ids]`` with clamped out-of-range ids; of a
    block of rows from ``offset`` of ``vocab``, the rows it holds."""
    V = table.shape[0] if vocab is None else vocab
    ids = ids.to(table.device).clamp(0, V - 1)
    if offset == 0 and V == table.shape[0]:
        return table[ids]
    local = ids - offset
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def onehot_gather(table: torch.Tensor, ids: torch.Tensor,
                  chunk: int = 2048, offset: int = 0) -> torch.Tensor:
    """``table[ids - offset]`` with zero rows for ids outside the table:
    the CUDA row gather on the card, the chunked one-hot product on the
    CPU."""
    if table.is_cuda:
        return cuda_onehot_gather(table, ids, offset=offset)
    if table.device.type != "cpu":
        raise ValueError(f"table lies on {table.device}: the one-hot gather "
                         f"runs on a CUDA device or on the CPU")
    V, D = table.shape
    flat = ids.reshape(-1).to(torch.int64) - offset
    chunk = min(chunk, V)
    n_chunks = -(-V // chunk)
    padded = F.pad(table, (0, 0, 0, n_chunks * chunk - V))
    iota = torch.arange(chunk)
    out = torch.zeros((flat.shape[0], D), dtype=table.dtype)
    for c in range(n_chunks):
        base = c * chunk
        oh = (iota[None, :] == (flat[:, None] - base)).to(table.dtype)
        out = out + oh @ padded[base:base + chunk]
    return out.reshape(tuple(ids.shape) + (D,))


def gather(table: torch.Tensor, ids: torch.Tensor, impl: str = "auto",
           chunk: int = 2048, offset: int = 0,
           vocab: int | None = None) -> torch.Tensor:
    """Dispatch on ``impl`` in {take, onehot, auto}; ``table`` is rows
    ``[offset, offset + len(table))`` of ``vocab`` (module docstring)."""
    V = table.shape[0] if vocab is None else vocab
    if impl == "auto":
        impl = "onehot" if V <= ONEHOT_AUTO_MAX_ROWS else "take"
    if impl == "take":
        return take_gather(table, ids, offset, V)
    if impl == "onehot":
        return onehot_gather(table, ids, chunk=chunk, offset=offset)
    raise ValueError(f"unknown gather impl {impl!r}")
