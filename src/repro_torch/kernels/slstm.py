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

Each launch goes through a custom op (``torch.ops.repro_torch.slstm``,
``slstm_train`` and ``slstm_backward``), so that a dispatch mode
(:class:`repro_torch.analysis.trace.OpTrace`, the flop counter) sees it
and a fake tensor reaches the op's fake implementation, not the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _ops
from .backproject import LAUNCHES

__all__ = ["BWD_CHUNK", "BWD_WARPS", "backward_config", "launch_slstm",
           "launch_slstm_backward", "launch_slstm_train"]

# The C entry points and their ctypes argument types: the launches take
# their pointers, then (B, S, di, stream); the config its out pointer.
_ARGTYPES = {e: [ctypes.c_void_p] * n + [ctypes.c_int] * 3
             + [ctypes.c_void_p]
             for e, n in (("slstm_launch", 5), ("slstm_train_launch", 6),
                          ("slstm_backward_launch", 9))}
_ARGTYPES["slstm_backward_config"] = [ctypes.c_void_p]


# The backward's chunked scan, as csrc/slstm.cu builds it (SLSTM_BWD_W
# warps a block, each a chunk of SLSTM_BWD_T tokens of a piece).
BWD_WARPS = 8
BWD_CHUNK = 6


def backward_config() -> dict:
    """The backward kernel's layout on the current CUDA device, from the
    built library: warps a block, tokens a chunk, shared bytes a block
    and the blocks an SM holds."""
    out = (ctypes.c_int * 4)()
    rc = _lib("slstm_backward_config")(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"slstm backward config failed: CUDA error {rc}")
    return {"warps": out[0], "chunk": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3]}


def _lib(entry: str = "slstm_launch"):
    fn = getattr(_build.load("slstm"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
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
    if B * di == 0:
        return _outputs(zifo, states=False)
    return tuple(torch.ops.repro_torch.slstm(zifo, r, state))


def launch_slstm_train(zifo: torch.Tensor, r: torch.Tensor,
                       state: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """:func:`launch_slstm` that also returns each step's state ``(B, S,
    3, di)`` float32, ``(c, n, m)`` after the step, for
    :func:`launch_slstm_backward`."""
    B, S, di = _check(zifo, r, state)
    if B * di == 0:
        return _outputs(zifo)
    return tuple(torch.ops.repro_torch.slstm_train(zifo, r, state))


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
    if B * di == 0:
        return (torch.empty_like(zifo),
                torch.zeros((4, di), dtype=torch.float32, device=zifo.device))
    return tuple(torch.ops.repro_torch.slstm_backward(zifo, r, state, hs,
                                                      states, dhs))


def _outputs(zifo: torch.Tensor,
             states: bool = True) -> tuple[torch.Tensor, ...]:
    """Empty hidden states ``(B, S, di)``, final state ``(4, B, di)`` and,
    with ``states``, per-step states ``(B, S, 3, di)`` for gates
    ``zifo``."""
    B, S, _, di = zifo.shape
    out = (zifo.new_empty((B, S, di)), zifo.new_empty((4, B, di)))
    return out + (zifo.new_empty((B, S, 3, di)),) if states else out


def _launch(entry: str, what: str, zifo: torch.Tensor, *ptrs: int) -> None:
    """Launch ``entry`` on the pointers ``ptrs`` and ``zifo``'s (B, S,
    di); raises when the launch is refused."""
    B, S, _, di = (int(n) for n in zifo.shape)
    stream = torch.cuda.current_stream(zifo.device).cuda_stream
    with torch.cuda.device(zifo.device):
        rc = _lib(entry)(*ptrs, B, S, di, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _slstm_op(zifo: torch.Tensor, r: torch.Tensor,
              state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row 10's launch (operands checked by :func:`launch_slstm`)."""
    hs, out = _outputs(zifo, states=False)
    _launch("slstm_launch", "slstm", zifo, zifo.data_ptr(), r.data_ptr(),
            state.data_ptr(), hs.data_ptr(), out.data_ptr())
    LAUNCHES["slstm"] += 1
    return hs, out


def _slstm_train_op(zifo: torch.Tensor, r: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row 10's training launch (operands checked by
    :func:`launch_slstm_train`)."""
    hs, out, states = _outputs(zifo)
    _launch("slstm_train_launch", "slstm", zifo, zifo.data_ptr(), r.data_ptr(),
            state.data_ptr(), hs.data_ptr(), out.data_ptr(),
            states.data_ptr())
    LAUNCHES["slstm"] += 1
    return hs, out, states


def _slstm_backward_op(zifo: torch.Tensor, r: torch.Tensor,
                       state: torch.Tensor, hs: torch.Tensor,
                       states: torch.Tensor, dhs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row 10b's launch (operands checked by
    :func:`launch_slstm_backward`)."""
    B, _, _, di = zifo.shape
    dzifo = torch.empty_like(zifo)
    dr = torch.zeros((4, di), dtype=torch.float32, device=zifo.device)
    part = torch.empty((B, 4, di), dtype=torch.float32, device=zifo.device)
    _launch("slstm_backward_launch", "slstm backward", zifo, zifo.data_ptr(), r.data_ptr(),
            state.data_ptr(), hs.data_ptr(), states.data_ptr(),
            dhs.data_ptr(), dzifo.data_ptr(), part.data_ptr(), dr.data_ptr())
    LAUNCHES["slstm_backward"] += 1
    return dzifo, dr


def _slstm_backward_fake(zifo, r, state, hs, states, dhs):
    return torch.empty_like(zifo), zifo.new_empty((4, zifo.shape[3]))


_ops.define("slstm(Tensor zifo, Tensor r, Tensor state) -> (Tensor, Tensor)",
            _slstm_op, lambda zifo, r, state: _outputs(zifo, states=False))
_ops.define("slstm_train(Tensor zifo, Tensor r, Tensor state) -> "
            "(Tensor, Tensor, Tensor)", _slstm_train_op,
            lambda zifo, r, state: _outputs(zifo))
_ops.define("slstm_backward(Tensor zifo, Tensor r, Tensor state, Tensor hs, "
            "Tensor states, Tensor dhs) -> (Tensor, Tensor)",
            _slstm_backward_op, _slstm_backward_fake)
