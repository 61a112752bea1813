"""The bound launcher of the CUDA row gather (``csrc/gather.cu``).

It replaces the TPU kernel ``repro/kernels/gather.py::onehot_gather_kernel``
(kernel row 9): ``table[ids]`` with zero rows for ids outside ``[0, V)``,
which is what the one-hot product ``onehot(ids) @ table`` computes.
:func:`launch_onehot_gather` checks what the kernel takes, launches the
float32 or bfloat16 instance on PyTorch's current stream, counts the
launch in :data:`repro_torch.kernels.backproject.LAUNCHES` (key
``"onehot_gather"``) and raises when the launch is refused.  Its plain
version is :func:`repro_torch.kernels.gather_ref.gather_ref`.

:func:`launch_onehot_gather_grad` runs the backward kernel (row 9b, key
``"onehot_gather_backward"``), ``d table = onehot(ids)^T d out``; its
plain version is :func:`repro_torch.kernels.gather_ref.gather_grad_ref`.
:func:`grad_path` is the launcher's choice between the one-block sort
and ``torch.sort`` followed by the row search and walk; each
launch counts the path it took in :data:`GRAD_PATHS`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .backproject import LAUNCHES

__all__ = ["BLOCK_MAX_N", "BLOCK_MAX_V", "GRAD_PATHS", "KEY_POS_BITS",
           "grad_path", "grad_scratch_ints", "launch_onehot_gather",
           "launch_onehot_gather_grad"]

_ENTRIES = {torch.float32: "onehot_gather_f32_launch",
            torch.bfloat16: "onehot_gather_bf16_launch"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


_GRAD_ENTRIES = {torch.float32: "onehot_gather_grad_f32_launch",
                 torch.bfloat16: "onehot_gather_grad_bf16_launch"}
_GRAD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BLOCK_ENTRIES = {torch.float32: "onehot_gather_grad_block_f32_launch",
                  torch.bfloat16: "onehot_gather_grad_block_bf16_launch"}
_BLOCK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

# The one-block path packs an id and its position into one 32-bit key,
# id << KEY_POS_BITS | position: it takes N <= BLOCK_MAX_N ids and a
# vocabulary of at most BLOCK_MAX_V rows (the largest id then packs
# below 0xffffffff, the key of an id out of range).
KEY_POS_BITS = 14
BLOCK_MAX_N = 1 << KEY_POS_BITS
BLOCK_MAX_V = (1 << (32 - KEY_POS_BITS)) - 1
GRAD_PATHS = {"block": 0, "sort": 0}


def _lib(dtype: torch.dtype, kind: str = "forward"):
    entries, argtypes = {"forward": (_ENTRIES, _ARGTYPES),
                         "sort": (_GRAD_ENTRIES, _GRAD_ARGTYPES),
                         "block": (_BLOCK_ENTRIES, _BLOCK_ARGTYPES)}[kind]
    fn = getattr(_build.load("gather"), entries[dtype])
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def grad_path(N: int, V: int) -> str:
    """The backward's path for ``N`` ids into ``V`` rows: ``"block"`` (one
    block sorts the packed keys; no library sort, no search over V) where
    the key holds both, else ``"sort"`` (``torch.sort``, then a search
    per row and the row walk)."""
    return "block" if N <= BLOCK_MAX_N and V <= BLOCK_MAX_V else "sort"


def grad_scratch_ints(N: int, V: int) -> int:
    """int32 scratch of the one-block path: the hit map (``ceil(V /
    32)``), each run's first sorted index (N + 1), the positions in
    sorted order (N), each run's row (N) and the count of runs (1)."""
    return (V + 31) // 32 + 3 * N + 2


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


def launch_onehot_gather_grad(ids: torch.Tensor, dout: torch.Tensor,
                              V: int) -> torch.Tensor:
    """``d table`` ``(V, D)`` of the row gather on the card: row ``v`` the
    float32 sum, in position order, of the rows of ``dout`` whose id is
    ``v``, rounded once to ``dout``'s dtype; zero where no id is ``v``;
    ids outside ``[0, V)`` add nothing.  ``ids``: ``(N,)`` int64;
    ``dout``: ``(N, D)`` float32 or bfloat16; both contiguous on one CUDA
    device.  Up to :data:`BLOCK_MAX_N` ids one block sorts them and a row
    writer writes the table; above, the ids are sorted here
    (``torch.sort``, stable) and the search and walk kernels do the rest
    (:func:`grad_path`)."""
    if dout.dtype not in _GRAD_ENTRIES:
        raise TypeError(f"dout is {dout.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    if ids.dtype != torch.int64:
        raise TypeError(f"ids are {ids.dtype}; the kernel takes int64")
    for name, t in (("dout", dout), ("ids", ids)):
        if not t.is_cuda or t.device != dout.device:
            raise ValueError(f"{name} lies on {t.device}; the kernel needs "
                             f"both operands on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dout.ndim != 2 or ids.ndim != 1 or ids.shape[0] != dout.shape[0]:
        raise ValueError(f"ids must be (N,) and dout (N, D); got "
                         f"{tuple(ids.shape)} and {tuple(dout.shape)}")
    N, D = (int(n) for n in dout.shape)
    V = int(V)
    dtable = torch.empty((V, D), dtype=dout.dtype, device=dout.device)
    if V == 0 or D == 0:
        return dtable
    vec16 = (D * dout.element_size() % 16 == 0
             and dout.data_ptr() % 16 == 0 and dtable.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dout.device).cuda_stream
    path = grad_path(N, V)
    with torch.cuda.device(dout.device):
        if path == "block":
            scratch = torch.empty((grad_scratch_ints(N, V),),
                                  dtype=torch.int32, device=dout.device)
            rc = _lib(dout.dtype, "block")(
                ids.data_ptr(), dout.data_ptr(), scratch.data_ptr(),
                dtable.data_ptr(), N, V, D, int(vec16), stream)
        else:
            sorted_ids, perm = torch.sort(ids, stable=True)
            starts = torch.empty((V + 1,), dtype=torch.int64,
                                 device=dout.device)
            rc = _lib(dout.dtype, "sort")(
                sorted_ids.data_ptr(), perm.data_ptr(), dout.data_ptr(),
                starts.data_ptr(), dtable.data_ptr(), N, V, D, int(vec16),
                stream)
    if rc != 0:
        raise RuntimeError(f"onehot_gather backward kernel launch failed: "
                           f"CUDA error {rc}")
    GRAD_PATHS[path] += 1
    LAUNCHES["onehot_gather_backward"] += 1
    return dtable
