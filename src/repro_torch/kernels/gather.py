"""The bound launcher of the CUDA row gather (``csrc/gather.cu``).

It replaces the TPU kernel ``repro/kernels/gather.py::onehot_gather_kernel``
(kernel row 9): ``table[ids]`` with zero rows for ids outside ``[0, V)``,
which is what the one-hot product ``onehot(ids) @ table`` computes.
:func:`launch_onehot_gather` checks what the kernel takes, launches the
float32 or bfloat16 instance on PyTorch's current stream, counts the
launch in :data:`repro_torch.kernels.backproject.LAUNCHES` (key
``"onehot_gather"``) and raises when the launch is refused.  Its plain
version is :func:`repro_torch.kernels.gather_ref.gather_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .backproject import LAUNCHES

__all__ = ["launch_onehot_gather"]

_ENTRIES = {torch.float32: "onehot_gather_f32_launch",
            torch.bfloat16: "onehot_gather_bf16_launch"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _lib(dtype: torch.dtype):
    fn = getattr(_build.load("gather"), _ENTRIES[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_onehot_gather(table: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """``out[n] = table[ids[n]]``, zero rows for ids outside ``[0, V)``,
    on the card.  ``table``: ``(V, D)`` float32 or bfloat16; ``ids``:
    ``(N,)`` int64; both contiguous on one CUDA device.  Returns ``(N,
    D)`` in the table's dtype."""
    if table.dtype not in _ENTRIES:
        raise TypeError(f"table is {table.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    if ids.dtype != torch.int64:
        raise TypeError(f"ids are {ids.dtype}; the kernel takes int64")
    for name, t in (("table", table), ("ids", ids)):
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"{name} lies on {t.device}; the kernel needs "
                             f"both operands on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"table must be (V, D) and ids (N,); got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    V, D = (int(n) for n in table.shape)
    N = int(ids.shape[0])
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if N == 0 or D == 0:
        return out
    vec16 = (D * table.element_size() % 16 == 0
             and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rc = _lib(table.dtype)(table.data_ptr(), ids.data_ptr(),
                               out.data_ptr(), N, V, D, int(vec16), stream)
    if rc != 0:
        raise RuntimeError(f"onehot_gather kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["onehot_gather"] += 1
    return out
