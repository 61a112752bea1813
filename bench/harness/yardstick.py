"""The yardstick of the back projection's roofline.

The work of a scan is counted the same way whatever runs it: every
(voxel, projection) pair costs 37 float32 operations (the three matrix
rows, the reciprocal, the taps' fractions, the bilinear blend, the
``1/w^2`` weight and the add), and the bytes are the volume written
once plus the scan's views read once as float32.  Neither depends on
the projections folded per volume pass, the wire or the strategy.
Peaks: the published NVIDIA H100 SXM figures (dense, at 700 W).
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores (FLOP/s)
PEAK_BYTES_S = 3.35e12      # HBM3 (bytes/s)
FLOPS_PER_VOXEL_PROJ = 37


def least_seconds(pairs: float, L: int, n_proj: int, n_v: int,
                  n_u: int) -> float:
    """Least time for ``pairs`` voxel-projection pairs of scans of
    ``L**3`` voxels and ``n_proj`` views of ``n_v x n_u``: the larger of
    the operations over the FP32 peak and the bytes over the HBM rate."""
    scans = pairs / (L ** 3 * n_proj)
    flops = FLOPS_PER_VOXEL_PROJ * pairs
    nbytes = scans * (L ** 3 * 4 + n_proj * n_v * n_u * 4)
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)
