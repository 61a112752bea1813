"""The bound launcher of the CUDA back-projection kernel.

``csrc/backproject.cu`` replaces the TPU kernels
``repro/kernels/backproject.py::backproject_kernel_batch`` (a batch of
projections folded into a resident volume tile) and
``::backproject_kernel`` (the same for one projection, here a launch
with P = 1), and their int8/bf16 projection wire (``::_dequant_strip``).
:func:`launch_backproject` checks what the kernel takes, launches the
instance for the stack's wire on PyTorch's current stream and counts the
launch in :data:`LAUNCHES`.  The library is built at first use
(:mod:`._build`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_PBATCH", "WIRE_LAUNCH_KEYS",
           "launch_backproject"]

# Launches of each CUDA kernel of the port, counted where the kernel is
# launched and nowhere else.  A caller sets a count to 0 before the run
# it wants to read.
LAUNCHES = {"backproject": 0, "backproject_bf16": 0, "backproject_int8": 0,
            "quantize_rows": 0}

# The LAUNCHES key of the back-projection instance for each wire dtype.
WIRE_LAUNCH_KEYS = {torch.float32: "backproject",
                    torch.bfloat16: "backproject_bf16",
                    torch.int8: "backproject_int8"}

# The P x 12 matrices sit in the kernel's dynamic shared memory, which
# needs no opt-in up to 48 KB: 1024 projections per launch.
MAX_PBATCH = 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = [_I, _I, _I, _I, _I, _I, _F, _F, _P]   # P L nz z0 rows cols O MM s
_ENTRIES = {
    torch.float32: ("backproject_batch_launch", [_P, _P, _P] + _GEOM),
    torch.bfloat16: ("backproject_batch_bf16_launch", [_P, _P, _P] + _GEOM),
    torch.int8: ("backproject_batch_int8_launch", [_P, _P, _P, _P] + _GEOM),
}


def _lib(wire: torch.dtype):
    name, argtypes = _ENTRIES[wire]
    fn = getattr(_build.load("backproject"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch_backproject(volume: torch.Tensor, padded: torch.Tensor,
                       mats: torch.Tensor, *, z0: int, O: float,
                       MM: float, scales: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """``volume += Σ_p bilinear(padded[p]) / w_p²`` on the card, in place.

    ``volume``: ``(nz, L, L)`` float32, a z-slab starting at global plane
    ``z0``; ``padded``: ``(P, n_v + 2, n_u + 2)`` with the 1-pixel zero
    border, in the wire's dtype (float32, bfloat16, or int8 codes with
    ``scales`` ``(P, 2, n_v + 2)`` float32: scale, offset per row);
    ``mats``: ``(P, 3, 4)`` float32.  All contiguous, on one CUDA
    device.  Raises on anything else, and when the launch is refused.
    """
    wire = padded.dtype
    if wire not in _ENTRIES:
        raise TypeError(f"padded is {wire}; the kernel takes float32, "
                        f"bfloat16 or int8 projections")
    if (wire == torch.int8) != (scales is not None):
        raise ValueError("int8 codes need their (P, 2, rows) scales, and "
                         "only int8 codes take scales")
    operands = [("volume", volume, torch.float32),
                ("padded", padded, wire), ("mats", mats, torch.float32)]
    if scales is not None:
        operands.append(("scales", scales, torch.float32))
    for name, t, dtype in operands:
        if not t.is_cuda or t.device != volume.device:
            raise ValueError(
                f"{name} lies on {t.device}; the kernel needs every "
                f"operand on {volume.device} (a CUDA device)")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if volume.ndim != 3 or volume.shape[1] != volume.shape[2]:
        raise ValueError(f"volume must be (nz, L, L); got "
                         f"{tuple(volume.shape)}")
    P = int(padded.shape[0]) if padded.ndim == 3 else -1
    if padded.ndim != 3 or mats.shape != (P, 3, 4):
        raise ValueError(
            f"want padded (P, rows, cols) and mats (P, 3, 4); got "
            f"{tuple(padded.shape)} and {tuple(mats.shape)}")
    if not 1 <= P <= MAX_PBATCH:
        raise ValueError(f"P={P} projections per launch; the kernel takes "
                         f"1..{MAX_PBATCH}")
    nz, L = int(volume.shape[0]), int(volume.shape[1])
    rows, cols = int(padded.shape[1]), int(padded.shape[2])
    if scales is not None and scales.shape != (P, 2, rows):
        raise ValueError(f"scales must be (P, 2, rows) = {(P, 2, rows)}; "
                         f"got {tuple(scales.shape)}")
    if nz == 0:
        return volume
    head = [volume.data_ptr(), padded.data_ptr()]
    if scales is not None:
        head.append(scales.data_ptr())
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    with torch.cuda.device(volume.device):
        rc = _lib(wire)(*head, mats.data_ptr(), P, L, nz, int(z0), rows,
                        cols, float(O), float(MM), stream)
    if rc != 0:
        raise RuntimeError(f"backproject kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[WIRE_LAUNCH_KEYS[wire]] += 1
    return volume
