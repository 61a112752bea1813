"""Shared-memory screen of the kernel configs the tuner can propose.

The port's counterpart of ``repro/analysis/lint/budget.py``.  The
reference prices each Pallas config's VMEM working set against a
budget; on Hopper the scarce per-block store is shared memory, and the
port has one byte model of it: :func:`repro_torch.tune.space.kernel_smem_bytes`
(the staged windows or K5's box records and slots, and the ``P x 12``
matrices, through :func:`repro_torch.kernels.backproject.strip_smem_bytes`),
which the tuner's candidate screen and the launcher both use.  This
pass calls that function and prices every candidate of
:func:`repro_torch.tune.space.pallas_candidates` at the reference's
scales against :data:`repro_torch.kernels.backproject.SMEM_LIMIT`, so a
config the generator proposes but the card would refuse is a finding
(``candidate-over-smem``; an extra config, ``config-over-smem``).
"""

from __future__ import annotations

from .common import Finding

__all__ = ["screen_candidate_spaces"]

# Geometry scales the pass screens the candidate generator at (the
# reference's): tiny (the test shapes), mid, and the RabbitCT case.
_SCREEN_SCALES = (8, 32, 512)


def screen_candidate_spaces(extra_configs=()):
    """Price every kernel candidate the tuner can propose at each of
    :data:`_SCREEN_SCALES`, and each ``(label, GeomStatic, config dict)``
    of ``extra_configs``, against the card's shared memory per block.

    Returns ``(findings, checked)``."""
    from ...core.backproject import GeomStatic
    from ...core.geometry import default_geometry
    from ...kernels.backproject import SMEM_LIMIT
    from ...tune.space import kernel_smem_bytes, pallas_candidates

    findings, checked = [], 0
    for L in _SCREEN_SCALES:
        gs = GeomStatic.of(default_geometry().scaled(L))
        for cand in pallas_candidates(gs):
            smem = kernel_smem_bytes(gs, dict(cand.opts))
            checked += 1
            if smem > SMEM_LIMIT:
                findings.append(Finding(
                    "budget", "candidate-over-smem", f"L={L}:{cand.label}",
                    f"the kernel needs {smem} B of shared memory per "
                    f"block; a block may opt in to {SMEM_LIMIT} B"))
    for label, gs, cfg in extra_configs:
        smem = kernel_smem_bytes(gs, dict(cfg))
        checked += 1
        if smem > SMEM_LIMIT:
            findings.append(Finding(
                "budget", "config-over-smem", str(label),
                f"the kernel needs {smem} B of shared memory per block; a "
                f"block may opt in to {SMEM_LIMIT} B"))
    return findings, checked
