"""The stable public surface of :mod:`repro_torch`.

The counterpart of ``repro.api``, restricted to the names this slice of
the port implements.  Option-bag parameters are keyword-only, and every
entry point takes ``device=`` (default ``"cuda"``; the CPU only when
asked for)::

    from repro_torch.api import CTFrontDoor, Geometry, ProjectionChunk

    fd = CTFrontDoor(Geometry(), n_slots=2, policy="srsf")
    ticket = await fd.open_scan(tenant="clinic-a")
    await fd.submit(ticket, ProjectionChunk(projs, mats, angles))
    volume = await fd.result(ticket)
"""

from __future__ import annotations

from .core.backproject import reconstruct
from .core.filtering import filter_projections
from .core.geometry import Geometry
from .dispatch import ExecutionPlan
from .serving.ct_frontdoor import (POLICIES, AdmissionPolicy, Backpressure,
                                   CTFrontDoor, DeadlinePolicy,
                                   FairSharePolicy, FIFOPolicy,
                                   PolicyContext, ScanAborted, ScanTicket,
                                   SRSFPolicy)
from .streaming import ProjectionChunk, ReconstructionEngine, ScanState

__all__ = [
    # one-shot reconstruction
    "Geometry",
    "filter_projections",
    "reconstruct",
    # execution plans
    "ExecutionPlan",
    # streaming engine
    "ProjectionChunk",
    "ReconstructionEngine",
    "ScanState",
    # serving tier
    "CTFrontDoor",
    "ScanTicket",
    "Backpressure",
    "ScanAborted",
    "AdmissionPolicy",
    "FIFOPolicy",
    "SRSFPolicy",
    "DeadlinePolicy",
    "FairSharePolicy",
    "PolicyContext",
    "POLICIES",
]
