"""Plain PyTorch version of the row gather (kernel row 9).

``table[ids]`` with out-of-range ids mapped to zero rows: the exact
semantics of the TPU kernel ``repro/kernels/gather.py::onehot_gather_kernel``
(a one-hot product), and of the CUDA kernel ``csrc/gather.cu``, which the
card runs in its place.
"""

from __future__ import annotations

import torch

__all__ = ["gather_ref"]


def gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for any ids shape; zero rows where an id is outside
    ``[0, V)``."""
    V = table.shape[0]
    ok = (ids >= 0) & (ids < V)
    rows = table[ids.clamp(0, V - 1)]
    return rows.masked_fill(~ok[..., None], 0)
