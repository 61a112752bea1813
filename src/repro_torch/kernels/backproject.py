"""The bound launcher of the CUDA back-projection kernel.

``csrc/backproject.cu`` replaces the TPU kernels
``repro/kernels/backproject.py::backproject_kernel_batch`` (a batch of
projections folded into a resident volume tile) and
``::backproject_kernel`` (the same for one projection, here a launch
with P = 1).  :func:`launch_backproject` checks what the kernel takes,
launches it on PyTorch's current stream and counts the launch in
:data:`LAUNCHES`.  The library is built at first use (:mod:`._build`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_PBATCH", "launch_backproject"]

# Launches of each CUDA kernel of the port, counted where the kernel is
# launched and nowhere else.  A caller sets a count to 0 before the run
# it wants to read.
LAUNCHES = {"backproject": 0}

# The P x 12 matrices sit in the kernel's dynamic shared memory, which
# needs no opt-in up to 48 KB: 1024 projections per launch.
MAX_PBATCH = 1024

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]


def _lib():
    lib = _build.load("backproject")
    fn = lib.backproject_batch_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_backproject(volume: torch.Tensor, padded: torch.Tensor,
                       mats: torch.Tensor, *, z0: int, O: float,
                       MM: float) -> torch.Tensor:
    """``volume += Σ_p bilinear(padded[p]) / w_p²`` on the card, in place.

    ``volume``: ``(nz, L, L)`` float32, a z-slab starting at global plane
    ``z0``; ``padded``: ``(P, n_v + 2, n_u + 2)`` float32 with the
    1-pixel zero border; ``mats``: ``(P, 3, 4)`` float32.  All three
    contiguous, on one CUDA device.  Raises on anything else, and when
    the launch is refused.
    """
    for name, t in (("volume", volume), ("padded", padded), ("mats", mats)):
        if not t.is_cuda or t.device != volume.device:
            raise ValueError(
                f"{name} lies on {t.device}; the kernel needs every "
                f"operand on {volume.device} (a CUDA device)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
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
    if nz == 0:
        return volume
    rows, cols = int(padded.shape[1]), int(padded.shape[2])
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    with torch.cuda.device(volume.device):
        rc = _lib()(volume.data_ptr(), padded.data_ptr(), mats.data_ptr(),
                    P, L, nz, int(z0), rows, cols, float(O), float(MM),
                    stream)
    if rc != 0:
        raise RuntimeError(f"backproject kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["backproject"] += 1
    return volume
