"""The run's inputs, made from its seed.

A run serves ``n`` seeded scans (different phantoms, the same sizes).
Each scan's raw views are projected on the device in a seeded order of
angles and kept there, or copied once to pinned host memory, so that a
chunk is a contiguous slice: handing it over copies nothing on the
host.  The voxels the check compares are drawn from the seed too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.geometry import Scan, projection_matrices
from ..reference.phantom import ellipsoids, forward_project

# Voxels of each served volume kept for the check.
N_SAMPLE = 1 << 20


class Inputs:
    """``scans`` seeded scans of ``scan`` on ``device``, their views
    where ``views`` says (``"device"`` or ``"host_pinned"``)."""

    def __init__(self, scan: Scan, seed: int, scans: int, views: str,
                 device: torch.device):
        if views not in ("device", "host_pinned"):
            raise ValueError(f"views must be 'device' or 'host_pinned', "
                             f"got {views!r}")
        rng = np.random.default_rng([seed, 0])
        self.scan = scan
        self.ells = [ellipsoids(scan, rng) for _ in range(scans)]
        self.order = [rng.permutation(scan.n_proj) for _ in range(scans)]
        # Per scan, each angle index's place in the stored order.
        self.slot = [np.argsort(o) for o in self.order]
        self.mats = projection_matrices(scan)
        n_vox = scan.L ** 3
        flat = np.unique(rng.integers(0, n_vox, min(N_SAMPLE, n_vox)))
        self.flat = torch.as_tensor(flat, dtype=torch.int64, device=device)
        shape = (scan.n_proj, scan.n_v, scan.n_u)
        self.views = []
        made = None
        for ells, order in zip(self.ells, self.order):
            made = forward_project(scan, ells, device, out=made, order=order)
            if views == "device":
                self.views.append(made)
                made = None
            else:
                host = torch.empty(shape, dtype=torch.float32,
                                   pin_memory=device.type == "cuda")
                host.copy_(made)
                self.views.append(host)
        del made

    def chunk(self, s: int, c: int, size: int):
        """``(views, matrices, angle indices)`` of chunk ``c`` of scan
        ``s``: ``size`` views in the scan's seeded angle order."""
        sl = slice(c * size, (c + 1) * size)
        idx = self.order[s][sl]
        return self.views[s][sl], self.mats[idx], idx

    def frame(self, s: int, angle: int):
        """``(views, matrices, angle indices)`` of the one view of scan
        ``s`` taken at angle index ``angle``, wherever the seeded order
        stored it."""
        return self.chunk(s, int(self.slot[s][angle]), 1)
