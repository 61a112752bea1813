"""The comparison that decides ``correct``.

Every volume returned in a run is held, at the run's sampled voxels, to
the plain reference's volume of the scan its ticket was opened for.
Numbers compared (each beside its limit):

* ``gap``: ``max |served - reference| / max |reference|`` over the
  sampled voxels, the reference on the configuration's wire;
* where the configuration states a quality envelope against float32
  (a narrow wire), over the sampled voxels inside the inscribed sphere:
  ``psnr_db``, the served volume's PSNR against the float32 reference,
  and ``drop_db``, how far its PSNR against the phantom falls below the
  float32 reference's.
"""

from __future__ import annotations

import math

import torch


def roi(zyx: torch.Tensor, L: int) -> torch.Tensor:
    """Which of the voxels ``zyx`` lie in the inscribed sphere."""
    c = (L - 1) / 2.0
    d = zyx.to(torch.float64) - c
    return (d * d).sum(dim=0) <= c * c


def psnr(x: torch.Tensor, ref: torch.Tensor, data_range: float) -> float:
    mse = float(torch.mean((x.double() - ref.double()) ** 2))
    return 10.0 * math.log10(data_range ** 2 / max(mse, 1e-300))


def gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def numbers(samples: list, refs: list, wire: str, envelope: bool,
            inside: torch.Tensor | None = None,
            phantom: list | None = None) -> dict:
    """The compared numbers over served ``samples``: a list of ``(scan,
    (N,) tensor)``; ``refs[scan]`` maps a wire to the reference's
    samples; ``inside`` masks the sampled voxels in the sphere and
    ``phantom[scan]`` gives the phantom there (with ``envelope``)."""
    out = {"gap": max(gap(x, refs[s][wire]) for s, x in samples)}
    if envelope:
        ps, drops = [], []
        for s, x in samples:
            r32, ph = refs[s]["float32"][inside], phantom[s][inside]
            xi = x[inside]
            ps.append(psnr(xi, r32, float(r32.max() - r32.min())))
            rng = float(ph.max() - ph.min())
            drops.append(psnr(r32, ph, rng) - psnr(xi, ph, rng))
        out["psnr_db"] = min(ps)
        out["drop_db"] = max(drops)
    return out


def judge(values: dict, limits: dict) -> tuple[dict, bool]:
    """``({name: {"value", "limit"}}, all within)``: ``limits[name]``
    holds ``max`` (the value may not exceed it) or ``min``."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        if "max" in lim:
            limit, good = lim["max"], v is not None and v <= lim["max"]
        else:
            limit, good = lim["min"], v is not None and v >= lim["min"]
        checks[name] = {"value": v, "limit": limit}
        ok = ok and good
    return checks, ok
