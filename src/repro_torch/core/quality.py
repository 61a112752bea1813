"""RabbitCT-style reconstruction quality metrics, on tensors.

The port's counterpart of ``repro.core.quality``: mean squared error
and PSNR against a reference volume, over the inscribed sphere of the
volume (RabbitCT's scoring region) or over the whole volume.  Inputs may
be tensors or numpy arrays; the sums run in float32 on the tensors'
device, as the reference's jnp sums do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["roi_mask", "mse", "psnr", "quality_report"]


def roi_mask(L: int, *, device="cuda") -> torch.Tensor:
    """Boolean mask of the inscribed sphere (RabbitCT's scoring region),
    ``(L, L, L)`` on ``device``; float64 distances as in the reference."""
    dev = resolve_device(device)
    c = (L - 1) / 2.0
    g = torch.arange(L, dtype=torch.float64, device=dev) - c
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    return (xx * xx + yy * yy + zz * zz) <= c * c


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def mse(volume, reference, mask=None) -> torch.Tensor:
    volume = _f32(volume)
    reference = _f32(reference, volume.device)
    err = (volume - reference) ** 2
    if mask is not None:
        mask = _f32(mask, volume.device)
        return torch.sum(err * mask) / torch.sum(mask)
    return torch.mean(err)


def psnr(volume, reference, mask=None,
         data_range: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB (RabbitCT's headline metric)."""
    if data_range is None:
        ref = _f32(reference)
        data_range = float(ref.max() - ref.min()) or 1.0
    m = float(mse(volume, reference, mask))
    return 10.0 * math.log10((data_range ** 2) / max(m, 1e-20))


def quality_report(volume, reference) -> dict:
    L = int(volume.shape[0])
    mask = roi_mask(L, device=_f32(volume).device)
    return {
        "mse_roi": float(mse(volume, reference, mask)),
        "psnr_roi_db": psnr(volume, reference, mask),
        "mse_full": float(mse(volume, reference)),
        "psnr_full_db": psnr(volume, reference),
    }
