"""Wrapper of the row gather (kernel row 9), counterpart of
``repro/kernels/gather_kernel_ops.py::pallas_onehot_gather``.

:func:`cuda_onehot_gather` takes any leading ids shape and any vocabulary
size, with no padding to tile multiples.  On a CUDA table it launches the
CUDA kernel (``csrc/gather.cu``, through :func:`.gather.launch_onehot_gather`)
and raises if it cannot; on a CPU table it runs the plain version
:func:`.gather_ref.gather_ref`.

When the table requires a gradient the gather runs as a
:class:`torch.autograd.Function` whose backward, ``d table =
onehot(ids)^T d out``, is the backward kernel on the card (row 9b,
:func:`.gather.launch_onehot_gather_grad`) and its plain version
:func:`.gather_ref.gather_grad_ref` on the CPU.
"""

from __future__ import annotations

import torch

from .gather import launch_onehot_gather, launch_onehot_gather_grad
from .gather_ref import gather_grad_ref, gather_ref

__all__ = ["cuda_onehot_gather"]


def cuda_onehot_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with zero rows for ids outside ``[0, V)``; returns
    ``ids.shape + (D,)`` in the table's dtype."""
    if table.ndim != 2:
        raise ValueError(f"table must be (V, D); got {tuple(table.shape)}")
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"table lies on {table.device}: the gather runs on "
                         f"a CUDA device or, as its plain version, the CPU")
    flat = ids.reshape(-1).to(device=table.device, dtype=torch.int64)
    if torch.is_grad_enabled() and table.requires_grad:
        out = _OnehotGather.apply(table, flat)
    elif table.is_cuda:
        out = launch_onehot_gather(table.contiguous(), flat.contiguous())
    else:
        out = gather_ref(table, flat)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


class _OnehotGather(torch.autograd.Function):
    """The row gather with its backward: kernels on the card (rows 9 and
    9b), the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.V = table.shape[0]
        if table.is_cuda:
            return launch_onehot_gather(table.contiguous(), ids.contiguous())
        return gather_ref(table, ids)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        if dout.is_cuda:
            return (launch_onehot_gather_grad(ids.contiguous(),
                                              dout.contiguous(), ctx.V),
                    None)
        return gather_grad_ref(ids, dout, ctx.V), None
