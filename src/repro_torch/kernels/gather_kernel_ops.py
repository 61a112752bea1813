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

``offset`` makes ``table`` rows ``[offset, offset + V)`` of a larger
vocabulary (a tensor-parallel rank's block, :mod:`repro_torch.dist.tp`):
the kernels subtract it as they read each id (no launch of its own);
ids outside the block give zero rows in the forward and are skipped in
the backward.
"""

from __future__ import annotations

import torch

from .gather import launch_onehot_gather, launch_onehot_gather_grad
from .gather_ref import gather_grad_ref, gather_ref

__all__ = ["cuda_onehot_gather"]


def cuda_onehot_gather(table: torch.Tensor, ids: torch.Tensor,
                       offset: int = 0) -> torch.Tensor:
    """``table[ids - offset]`` with zero rows for ids outside ``[offset,
    offset + V)``; returns ``ids.shape + (D,)`` in the table's dtype."""
    if table.ndim != 2:
        raise ValueError(f"table must be (V, D); got {tuple(table.shape)}")
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"table lies on {table.device}: the gather runs on "
                         f"a CUDA device or, as its plain version, the CPU")
    flat = ids.reshape(-1).to(device=table.device, dtype=torch.int64)
    if torch.is_grad_enabled() and table.requires_grad:
        out = _OnehotGather.apply(table, flat, offset)
    elif table.is_cuda:
        out = launch_onehot_gather(table.contiguous(), flat.contiguous(),
                                   offset)
    else:
        out = gather_ref(table, flat, offset)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


class _OnehotGather(torch.autograd.Function):
    """The row gather with its backward: kernels on the card (rows 9 and
    9b), the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, table, ids, offset):
        ctx.save_for_backward(ids)
        ctx.V, ctx.offset = table.shape[0], offset
        if table.is_cuda:
            return launch_onehot_gather(table.contiguous(), ids.contiguous(),
                                        offset)
        return gather_ref(table, ids, offset)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        if dout.is_cuda:
            return (launch_onehot_gather_grad(ids.contiguous(),
                                              dout.contiguous(), ctx.V,
                                              ctx.offset),
                    None, None)
        return gather_grad_ref(ids, dout, ctx.V, ctx.offset), None, None
