"""The plain reference of the benchmark's CT cells.

It works out, from the raw views the benchmark made, what a served scan
has to come to: the FDK filter, the wire's codes where the wire has
them, and the back projection, at a set of voxels.  It imports nothing
of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import codes
from .backproject import backproject_at, voxel_coords
from .fdk import Filter
from .geometry import Scan

# Bits of each wire's codes; None is the float32 wire.
WIRE_BITS = {"float32": None, "int8": 8, "int4": 4}


def on_wire(filtered: torch.Tensor, wire: str) -> torch.Tensor:
    """The bordered ``(k, n_v + 2, n_u + 2)`` float32 values the taps
    read from ``filtered`` views on ``wire``."""
    padded = F.pad(filtered, (1, 1, 1, 1))
    bits = WIRE_BITS[wire]
    if bits is None:
        return padded
    return codes.decode(*codes.encode(padded, bits))


def reconstruct_at(scan: Scan, views: torch.Tensor, angle_index,
                   mats: torch.Tensor, flat: torch.Tensor,
                   wires=("float32",), *, block: int = 16) -> dict:
    """``{wire: (N,) float32}``: the FDK volume of the raw ``views``
    (``(n, n_v, n_u)``, any order, angle indices ``angle_index``, their
    ``(n, 3, 4)`` float32 matrices on the views' device) at the flat
    voxel indices ``flat``, once per wire."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = views.device
        filt = Filter(scan, dev)
        zyx = voxel_coords(flat, scan.L)
        idx = torch.as_tensor(angle_index, dtype=torch.int64, device=dev)
        filtered = torch.cat([filt(views[k0:k0 + block], idx[k0:k0 + block])
                              for k0 in range(0, views.shape[0], block)])
        out = {}
        for w in wires:
            # The whole stack at once: the codes' column loop is serial.
            out[w] = backproject_at(on_wire(filtered, w), mats, zyx,
                                    scan.O, scan.voxel_mm, block=block)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
