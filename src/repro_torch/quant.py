"""Per-row int8 error-feedback quantisation: the ``strip_dtype="int8"``
wire (counterpart of ``repro.quant``).

The padded detector image is encoded once into int8 codes on a per-row
affine grid, ``value = code * scale[row] + offset[row]`` with codes in
``[-127, 127]``, and the quantisation error of each column is carried
into the next column of the same row (sigma-delta error diffusion), so
the error of any row prefix stays within about one grid step.  The
grid is widened to contain 0, and an all-zero row (the zero border)
decodes to exactly 0.0: its codes are all ``-127`` and its offset is
``127 * scale``, so the two products cancel.

:func:`quantize_rows` takes one ``(rows, cols)`` image or a ``(P,
rows, cols)`` stack.  On a CUDA tensor it launches the encoder kernel
(``kernels/csrc/quant.cu``); on a CPU tensor it runs
:func:`quantize_rows_ref`, the plain column loop.  The two agree
bitwise: the kernel writes every float operation with explicit
round-to-nearest intrinsics in the loop's order, and takes the IEEE
division of a step wherever the product with the row's reciprocal
could round to another code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["RowQuant", "quantize_ef", "quantize_rows", "quantize_rows_ref",
           "dequantize_rows"]

# Smallest scale a constant row quantises at: keeps the divide finite,
# and 127 * _EPS_SCALE is still a normal float32.
_EPS_SCALE = 1e-30


def quantize_ef(x, scale, offset=None, *, error=None):
    """One error-feedback step onto the int8 grid ``code * scale (+
    offset)``: returns ``(codes, new_error)`` with ``new_error = (x +
    error) - dequant(codes)``.  ``offset=None`` is the symmetric grid
    (no add on either side); ``error=None`` starts a fresh residual.
    Codes come back as float32 (the residual needs the float value)."""
    xp = x if error is None else x + error
    centred = xp if offset is None else xp - offset
    q = torch.clamp(torch.round(centred / scale), -127.0, 127.0)
    deq = q * scale if offset is None else q * scale + offset
    return q, xp - deq


class RowQuant(NamedTuple):
    """Per-row affine int8 encoding of an image or a stack of images.

    ``codes`` is int8 ``(..., rows, cols)``; ``scale`` and ``offset``
    are float32 ``(..., rows)``: ``value[.., r, c] = codes[.., r, c] *
    scale[.., r] + offset[.., r]``.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor

    def scales(self) -> torch.Tensor:
        """``(..., 2, rows)`` float32: ``[.., 0, :]`` scale, ``[.., 1,
        :]`` offset, the layout the int8 back-projection kernel reads."""
        return torch.stack([self.scale, self.offset], dim=-2).contiguous()


def _div(a, d: float):
    """``a / d`` as an IEEE division on every device.  (On a CUDA
    tensor PyTorch turns division by a Python scalar into a multiply by
    its reciprocal, which rounds differently; a tensor divisor keeps the
    true division the reference and the kernel use.)"""
    return a / torch.full_like(a, d)


def _row_grid(x, symmetric: bool):
    """Per-row ``(scale, offset)`` of the grid, the row's range widened
    to contain 0.  ``x`` is ``(n_rows, cols)`` float32."""
    if symmetric:
        amax = torch.amax(torch.abs(x), dim=1)
        scale = _div(torch.clamp_min(amax, _EPS_SCALE), 127.0)
        return scale, torch.zeros_like(scale)
    lo = torch.clamp_max(torch.amin(x, dim=1), 0.0)
    hi = torch.clamp_min(torch.amax(x, dim=1), 0.0)
    scale = _div(torch.clamp_min(hi - lo, _EPS_SCALE), 254.0)
    # Code -127 decodes to ``lo`` exactly: offset = lo + 127 * scale.
    return scale, lo + 127.0 * scale


def _check_image(x) -> torch.Tensor:
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        raise TypeError("quantize_rows takes a float32 tensor")
    if x.ndim not in (2, 3) or x.shape[-1] == 0 or x.shape[-2] == 0:
        raise ValueError(f"quantize_rows wants a (rows, cols) image or a "
                         f"(P, rows, cols) stack, got {tuple(x.shape)}")
    return x


def quantize_rows_ref(image, *, symmetric: bool = False) -> RowQuant:
    """The plain version: a loop over columns, vectorised over rows.

    Each column quantises with the residual carried from the previous
    column of its row (the reference's ``lax.scan``).  Runs on the
    tensor's device; rows of a stack are independent.
    """
    x = _check_image(image)
    lead, (rows, cols) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape(-1, cols)
    scale, offset = _row_grid(flat, symmetric)
    codes = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
    err = torch.zeros_like(scale)
    for c in range(cols):
        q, err = quantize_ef(flat[:, c], scale, offset, error=err)
        codes[:, c] = q.to(torch.int8)
    return RowQuant(codes.reshape(x.shape), scale.reshape(lead + (rows,)),
                    offset.reshape(lead + (rows,)))


def quantize_rows(image, *, symmetric: bool = False) -> RowQuant:
    """Encode a float32 ``(rows, cols)`` image or ``(P, rows, cols)``
    stack into per-row affine int8 codes.

    A CUDA tensor runs the encoder kernel (one launch; it never falls
    back); a CPU tensor runs :func:`quantize_rows_ref`.
    """
    x = _check_image(image)
    if x.is_cuda:
        from .kernels.quant import launch_quantize_rows

        stack = x if x.ndim == 3 else x[None]
        codes, scales = launch_quantize_rows(stack.contiguous(),
                                             symmetric=symmetric)
        if x.ndim == 2:
            codes, scales = codes[0], scales[0]
        return RowQuant(codes, scales[..., 0, :], scales[..., 1, :])
    if x.device.type != "cpu":
        raise ValueError(f"no row quantiser for device {x.device}")
    return quantize_rows_ref(x, symmetric=symmetric)


def dequantize_rows(rq: RowQuant) -> torch.Tensor:
    """Decode per-row affine int8 codes back to float32, in two rounded
    steps (multiply, then add), as the kernels do."""
    return (rq.codes.to(torch.float32) * rq.scale[..., None]
            + rq.offset[..., None])
