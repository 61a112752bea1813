"""Wrapper of the row gather (kernel row 9), counterpart of
``repro/kernels/gather_kernel_ops.py::pallas_onehot_gather``.

:func:`cuda_onehot_gather` takes any leading ids shape and any vocabulary
size, with no padding to tile multiples.  On a CUDA table it launches the
CUDA kernel (``csrc/gather.cu``, through :func:`.gather.launch_onehot_gather`)
and raises if it cannot; on a CPU table it runs the plain version
:func:`.gather_ref.gather_ref`.
"""

from __future__ import annotations

import torch

from .gather import launch_onehot_gather
from .gather_ref import gather_ref

__all__ = ["cuda_onehot_gather"]


def cuda_onehot_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with zero rows for ids outside ``[0, V)``; returns
    ``ids.shape + (D,)`` in the table's dtype."""
    if table.ndim != 2:
        raise ValueError(f"table must be (V, D); got {tuple(table.shape)}")
    flat = ids.reshape(-1).to(device=table.device, dtype=torch.int64)
    if table.is_cuda:
        out = launch_onehot_gather(table.contiguous(), flat.contiguous())
    elif table.device.type == "cpu":
        out = gather_ref(table, flat)
    else:
        raise ValueError(f"table lies on {table.device}: the gather runs on "
                         f"a CUDA device or, as its plain version, the CPU")
    return out.reshape(tuple(ids.shape) + (table.shape[1],))
