"""Per-row affine integer codes with error feedback, plain PyTorch.

The int8 projection wire: each row of a zero-bordered filtered view is
put on the grid ``value = code * scale + offset``, codes in ``[-q, q]``
(``q = 127`` for 8 bits, 7 for 4), the grid spanning the row's range
widened to contain 0, and each column's rounding error carried into the
next column of its row.  ``encode`` then ``decode`` gives the float32
values the back projection's taps read.
"""

from __future__ import annotations

import torch

_EPS_SCALE = 1e-30


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as a true division (a tensor divisor)."""
    return a / torch.full_like(a, d)


def encode(rows: torch.Tensor, bits: int = 8):
    """``(codes, scale, offset)`` of a ``(..., cols)`` float32 tensor,
    rows independent: codes float32 integers, scale and offset
    ``(...,)``."""
    q = float(2 ** (bits - 1) - 1)
    lead, cols = rows.shape[:-1], rows.shape[-1]
    x = rows.reshape(-1, cols)
    lo = torch.clamp_max(torch.amin(x, dim=1), 0.0)
    hi = torch.clamp_min(torch.amax(x, dim=1), 0.0)
    scale = _div(torch.clamp_min(hi - lo, _EPS_SCALE), 2.0 * q)
    offset = lo + q * scale
    codes = torch.empty_like(x)
    err = torch.zeros_like(scale)
    for c in range(cols):
        xp = x[:, c] + err
        k = torch.clamp(torch.round((xp - offset) / scale), -q, q)
        codes[:, c] = k
        err = xp - (k * scale + offset)
    return codes.reshape(rows.shape), scale.reshape(lead), \
        offset.reshape(lead)


def decode(codes: torch.Tensor, scale: torch.Tensor,
           offset: torch.Tensor) -> torch.Tensor:
    """The float32 values: a rounded product, then a rounded sum."""
    return codes * scale[..., None] + offset[..., None]
