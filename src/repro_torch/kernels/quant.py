"""The bound launcher of the CUDA row quantiser (``csrc/quant.cu``).

:func:`launch_quantize_rows` encodes a ``(P, rows, cols)`` float32 stack
into int8 codes and a ``(P, 2, rows)`` scale/offset block on the card,
counts the launch in :data:`repro_torch.kernels.backproject.LAUNCHES`
(key ``"quantize_rows"``) and raises when the launch is refused.  Its
plain version is :func:`repro_torch.quant.quantize_rows_ref`.  The
launch goes through the custom op ``torch.ops.repro_torch.quantize_rows``
(a dispatch mode sees it; a fake tensor reaches its fake
implementation).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _ops
from .backproject import LAUNCHES

__all__ = ["launch_quantize_rows"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


_ENTRY = "quantize_rows_launch"


def _lib():
    fn = getattr(_build.load("quant"), _ENTRY)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_quantize_rows(x: torch.Tensor, *, symmetric: bool = False):
    """Encode ``x`` (``(P, rows, cols)`` float32, contiguous, on a CUDA
    device); returns ``(codes, scales)``: int8 ``(P, rows, cols)`` and
    float32 ``(P, 2, rows)`` (``[:, 0]`` scale, ``[:, 1]`` offset)."""
    if not x.is_cuda:
        raise ValueError(f"x lies on {x.device}; the kernel needs a CUDA "
                         f"tensor")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 3:
        raise ValueError(f"x must be a contiguous (P, rows, cols) float32 "
                         f"tensor; got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] == 0 or x.shape[2] == 0:
        raise ValueError(f"nothing to encode in a {tuple(x.shape)} stack")
    codes, scales = torch.ops.repro_torch.quantize_rows(x, bool(symmetric))
    return codes, scales


def _quant_op(x: torch.Tensor,
              symmetric: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder's launch (operands checked by
    :func:`launch_quantize_rows`)."""
    P, rows, cols = (int(n) for n in x.shape)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((P, 2, rows), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib()(x.data_ptr(), codes.data_ptr(), scales.data_ptr(), P,
                    rows, cols, int(symmetric), stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["quantize_rows"] += 1
    return codes, scales


def _quant_fake(x, symmetric):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((x.shape[0], 2, x.shape[1])))


_ops.define("quantize_rows(Tensor x, bool symmetric) -> (Tensor, Tensor)",
            _quant_op, _quant_fake)
