"""The bound launcher of the CUDA sLSTM recurrence (``csrc/slstm.cu``).

It replaces the TPU kernel ``repro/kernels/slstm.py::slstm_kernel``
(kernel row 10), and beyond it takes an initial state and returns the
final one.  :func:`launch_slstm` checks what the kernel takes, launches
it on PyTorch's current stream, counts the launch in
:data:`repro_torch.kernels.backproject.LAUNCHES` (key ``"slstm"``) and
raises when the launch is refused.  Its plain version is
:func:`repro_torch.kernels.slstm_ref.slstm_recurrence_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .backproject import LAUNCHES

__all__ = ["launch_slstm"]

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    fn = _build.load("slstm").slstm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_slstm(zifo: torch.Tensor, r: torch.Tensor,
                 state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the recurrence over the sequence on the card.

    ``zifo``: ``(B, S, 4, di)`` gate pre-activations; ``r``: ``(4, di)``
    diagonal recurrence weights; ``state``: ``(4, B, di)`` initial
    ``(c, n, h, m)``; all float32, contiguous, on one CUDA device.
    Returns the hidden states ``(B, S, di)`` and the final state ``(4, B,
    di)``, both float32.
    """
    operands = (("zifo", zifo), ("r", r), ("state", state))
    for name, t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"float32")
        if not t.is_cuda or t.device != zifo.device:
            raise ValueError(f"{name} lies on {t.device}; the kernel needs "
                             f"every operand on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if zifo.ndim != 4 or zifo.shape[2] != 4:
        raise ValueError(f"zifo must be (B, S, 4, di); got "
                         f"{tuple(zifo.shape)}")
    B, S, _, di = (int(n) for n in zifo.shape)
    if tuple(r.shape) != (4, di) or tuple(state.shape) != (4, B, di):
        raise ValueError(f"r must be (4, {di}) and state (4, {B}, {di}); "
                         f"got {tuple(r.shape)} and {tuple(state.shape)}")
    hs = torch.empty((B, S, di), dtype=torch.float32, device=zifo.device)
    out = torch.empty((4, B, di), dtype=torch.float32, device=zifo.device)
    if B * di == 0:
        return hs, out
    stream = torch.cuda.current_stream(zifo.device).cuda_stream
    with torch.cuda.device(zifo.device):
        rc = _lib()(zifo.data_ptr(), r.data_ptr(), state.data_ptr(),
                    hs.data_ptr(), out.data_ptr(), B, S, di, stream)
    if rc != 0:
        raise RuntimeError(f"slstm kernel launch failed: CUDA error {rc}")
    LAUNCHES["slstm"] += 1
    return hs, out
