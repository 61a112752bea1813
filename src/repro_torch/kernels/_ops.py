"""The kernels' custom ops, ``torch.ops.repro_torch.<name>``.

Each launcher of a hand-written kernel checks its operands, then calls
its op; the op's CUDA implementation is the ``ctypes`` launch and the
count in :data:`repro_torch.kernels.backproject.LAUNCHES`.  Through the
op a dispatch mode sees the launch
(:class:`repro_torch.analysis.trace.OpTrace`, PyTorch's flop counter),
and a fake tensor (:class:`torch._subclasses.fake_tensor.FakeTensorMode`,
the dry run's) reaches the op's fake implementation, which gives the
outputs' shapes and dtypes, never the kernel.  The ops have no CPU
implementation: the wrappers run the plain versions on the CPU.  Their
operations are the census's (:data:`repro_torch.analysis.census.KERNEL_TERMS`),
registered as their flop formulas.

The ops are defined on a :class:`torch.library.Library` directly, not
with ``torch.library.custom_op``, whose Python autograd and aliasing
layers cost several times more per call on the host.
"""

from __future__ import annotations

import torch

from ..analysis import census

__all__ = ["define"]

_LIB = torch.library.Library("repro_torch", "DEF")


def define(schema: str, impl, fake) -> None:
    """Define ``repro_torch::<schema>``: ``impl`` on CUDA tensors, ``fake``
    its outputs from the operands' shapes, and the census's operations
    as its flop formula."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    census.register_kernel_op(name)
