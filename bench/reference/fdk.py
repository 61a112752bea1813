"""FDK pre-weighting and ramp filtering, plain PyTorch.

Per projection at angle index ``i``: cosine weights
``sdd / sqrt(sdd^2 + u^2 + v^2)``, the Parker short-scan row of angle
index ``i`` (a sweep below 360 degrees), a linear convolution of each
detector row with the band-limited Ram-Lak kernel (zero padded to the
next power of two at least ``2 n_u``, by FFT), and the FDK constant
``(sweep / n_proj) (sdd / 2 sid) du``.  The weight tables are built on
the host in float64 and applied in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Scan


def ramlak(n: int, du: float) -> np.ndarray:
    """Ram-Lak kernel ``h[k]``, ``k = -n//2 .. n - n//2 - 1``:
    ``1 / (4 du^2)`` at 0, ``-1 / (pi k du)^2`` at odd ``k``, else 0."""
    k = np.arange(-(n // 2), n - n // 2)
    h = np.zeros(n)
    h[k == 0] = 1.0 / (4.0 * du * du)
    odd = np.abs(k) % 2 == 1
    h[odd] = -1.0 / (np.pi * k[odd] * du) ** 2
    return h


def cosine_weights(scan: Scan) -> np.ndarray:
    u = (np.arange(scan.n_u) - scan.cu) * scan.du
    v = (np.arange(scan.n_v) - scan.cv) * scan.dv
    uu, vv = np.meshgrid(u, v)
    return (scan.sdd / np.sqrt(scan.sdd ** 2 + uu ** 2 + vv ** 2)).astype(
        np.float32)


def parker_weights(scan: Scan) -> np.ndarray | None:
    """``(n_proj, n_u)`` float32 Parker weights times 2 (the filter keeps
    the FDK 1/2), or ``None`` for a full 360-degree sweep."""
    sweep = scan.sweep
    if sweep >= 2.0 * np.pi - 1e-9:
        return None
    gamma = np.arctan2((np.arange(scan.n_u) - scan.cu) * scan.du, scan.sdd)
    delta = float(np.max(np.abs(gamma)))
    if sweep < np.pi + 2 * delta - 1e-9:
        return np.full((scan.n_proj, scan.n_u), 2.0 * np.pi / sweep,
                       dtype=np.float32)
    b = (scan.angles - scan.angles[0])[:, None]
    g = gamma[None, :]
    w = np.ones((scan.n_proj, scan.n_u))
    with np.errstate(invalid="ignore", divide="ignore"):
        w_up = np.nan_to_num(np.sin(np.pi / 4.0 * b / (delta - g)) ** 2,
                             nan=0.0)
        w_dn = np.nan_to_num(np.sin(np.pi / 4.0 * (np.pi + 2 * delta - b)
                                    / (delta + g)) ** 2, nan=0.0)
    w = np.where(b <= 2.0 * (delta - g), w_up, w)
    w = np.where(b >= np.pi - 2.0 * g, w_dn, w)
    w = np.where(b > np.pi + 2 * delta, 0.0, w)
    return (2.0 * w).astype(np.float32)


class Filter:
    """The filter's tables for one scan, on one device."""

    def __init__(self, scan: Scan, device):
        pad = 1
        while pad < 2 * scan.n_u:
            pad *= 2
        h = np.roll(ramlak(pad, scan.du), -(pad // 2))
        self.pad, self.n_u = pad, scan.n_u
        self.spectrum = torch.as_tensor(np.fft.rfft(h).astype(np.complex64),
                                        device=device)
        self.cosw = torch.as_tensor(cosine_weights(scan), device=device)
        pw = parker_weights(scan)
        self.parker = None if pw is None else torch.as_tensor(pw,
                                                              device=device)
        self.scale = float(scan.sweep / scan.n_proj
                           * (scan.sdd / (2.0 * scan.sid)) * scan.du)

    def __call__(self, views: torch.Tensor,
                 angle_index: torch.Tensor) -> torch.Tensor:
        """Filtered ``(k, n_v, n_u)`` float32 of raw ``views`` whose angle
        indices are ``angle_index`` (``(k,)`` int64 on the views' device)."""
        w = views.to(torch.float32) * self.cosw
        if self.parker is not None:
            w = w * self.parker[angle_index][:, None, :]
        spec = torch.fft.rfft(w, n=self.pad, dim=-1) * self.spectrum
        return torch.fft.irfft(spec, n=self.pad, dim=-1)[..., :self.n_u] \
            * self.scale
