"""The bound launchers of the CUDA sLSTM recurrence (``csrc/slstm.cu``).

It replaces the TPU kernel ``repro/kernels/slstm.py::slstm_kernel``
(kernel row 10), and beyond it takes an initial state and returns the
final one.  :func:`launch_slstm` checks what the kernel takes, launches
it on PyTorch's current stream, counts the launch in
:data:`repro_torch.kernels.backproject.LAUNCHES` (key ``"slstm"``) and
raises when the launch is refused.  Its plain version is
:func:`repro_torch.kernels.slstm_ref.slstm_recurrence_ref`.

For training, :func:`launch_slstm_train` runs the same recurrence and
also keeps each step's state (also counted under ``"slstm"``), and
:func:`launch_slstm_backward` runs the backward kernel (row 10b, key
``"slstm_backward"``), whose plain version is
:func:`repro_torch.kernels.slstm_ref.slstm_backward_ref`.  The backward
is a block-local chunked scan (``csrc/slstm.cu``): a block of
:data:`BWD_WARPS` warps owns 32 chains, each warp a chunk of
:data:`BWD_CHUNK` tokens of each piece; :func:`backward_config` reads
its layout from the built library.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .backproject import LAUNCHES

__all__ = ["BWD_CHUNK", "BWD_WARPS", "backward_config", "launch_slstm",
           "launch_slstm_backward", "launch_slstm_train"]

# The C entry points and their pointer counts before (B, S, di, stream).
_ENTRIES = {"slstm_launch": 5, "slstm_train_launch": 6,
            "slstm_backward_launch": 9}


# The backward's chunked scan, as csrc/slstm.cu builds it (SLSTM_BWD_W
# warps a block, each a chunk of SLSTM_BWD_T tokens of a piece).
BWD_WARPS = 8
BWD_CHUNK = 6


def backward_config() -> dict:
    """The backward kernel's layout on the current CUDA device, from the
    built library: warps a block, tokens a chunk, shared bytes a block
    and the blocks an SM holds."""
    fn = _build.load("slstm").slstm_backward_config
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    rc = fn(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"slstm backward config failed: CUDA error {rc}")
    return {"warps": out[0], "chunk": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3]}


def _lib(entry: str = "slstm_launch"):
    fn = getattr(_build.load("slstm"), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * _ENTRIES[entry]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(zifo: torch.Tensor, r: torch.Tensor, state: torch.Tensor,
           **more: torch.Tensor) -> tuple[int, int, int]:
    """(B, S, di) of operands the kernels take: float32, contiguous, on
    one CUDA device, ``zifo`` (B, S, 4, di), ``r`` (4, di), ``state`` (4,
    B, di), and each of ``more`` of the shape its name says; raises
    otherwise."""
    operands = (("zifo", zifo), ("r", r), ("state", state),
                *more.items())
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
    shapes = {"hs": (B, S, di), "dhs": (B, S, di), "states": (B, S, 3, di)}
    for name, t in more.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}; got "
                             f"{tuple(t.shape)}")
    return B, S, di


def launch_slstm(zifo: torch.Tensor, r: torch.Tensor,
                 state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the recurrence over the sequence on the card.

    ``zifo``: ``(B, S, 4, di)`` gate pre-activations; ``r``: ``(4, di)``
    diagonal recurrence weights; ``state``: ``(4, B, di)`` initial
    ``(c, n, h, m)``; all float32, contiguous, on one CUDA device.
    Returns the hidden states ``(B, S, di)`` and the final state ``(4, B,
    di)``, both float32.
    """
    B, S, di = _check(zifo, r, state)
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


def launch_slstm_train(zifo: torch.Tensor, r: torch.Tensor,
                       state: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """:func:`launch_slstm` that also returns each step's state ``(B, S,
    3, di)`` float32, ``(c, n, m)`` after the step, for
    :func:`launch_slstm_backward`."""
    B, S, di = _check(zifo, r, state)
    hs = torch.empty((B, S, di), dtype=torch.float32, device=zifo.device)
    out = torch.empty((4, B, di), dtype=torch.float32, device=zifo.device)
    states = torch.empty((B, S, 3, di), dtype=torch.float32,
                         device=zifo.device)
    if B * di == 0:
        return hs, out, states
    stream = torch.cuda.current_stream(zifo.device).cuda_stream
    with torch.cuda.device(zifo.device):
        rc = _lib("slstm_train_launch")(
            zifo.data_ptr(), r.data_ptr(), state.data_ptr(), hs.data_ptr(),
            out.data_ptr(), states.data_ptr(), B, S, di, stream)
    if rc != 0:
        raise RuntimeError(f"slstm kernel launch failed: CUDA error {rc}")
    LAUNCHES["slstm"] += 1
    return hs, out, states


def launch_slstm_backward(zifo: torch.Tensor, r: torch.Tensor,
                          state: torch.Tensor, hs: torch.Tensor,
                          states: torch.Tensor, dhs: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the hidden states ``dhs`` (B, S, di) taken back to
    the gates and the recurrence weights, on the card (kernel row 10b).
    ``zifo``, ``r``, ``state`` as :func:`launch_slstm_train` took them,
    ``hs`` and ``states`` as it returned them; all float32, contiguous,
    on one CUDA device.  Returns ``d zifo`` (B, S, 4, di) and ``d r``
    (4, di)."""
    B, S, di = _check(zifo, r, state, hs=hs, states=states, dhs=dhs)
    dzifo = torch.empty_like(zifo)
    dr = torch.zeros((4, di), dtype=torch.float32, device=zifo.device)
    if B * di == 0:
        return dzifo, dr
    part = torch.empty((B, 4, di), dtype=torch.float32, device=zifo.device)
    stream = torch.cuda.current_stream(zifo.device).cuda_stream
    with torch.cuda.device(zifo.device):
        rc = _lib("slstm_backward_launch")(
            zifo.data_ptr(), r.data_ptr(), state.data_ptr(), hs.data_ptr(),
            states.data_ptr(), dhs.data_ptr(), dzifo.data_ptr(),
            part.data_ptr(), dr.data_ptr(), B, S, di, stream)
    if rc != 0:
        raise RuntimeError(f"slstm backward kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["slstm_backward"] += 1
    return dzifo, dr
