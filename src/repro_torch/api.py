"""The stable public surface of :mod:`repro_torch`.

The counterpart of ``repro.api``, name for name.  Option-bag
parameters are keyword-only, and every entry point takes ``device=``
(default ``"cuda"``; the CPU only when asked for).  ``strategy="auto"``
resolves through the process :class:`Dispatcher` (a tuned decision from
the port's cache, or an in-situ selection on first use)::

    from repro_torch.api import CTFrontDoor, Geometry, ProjectionChunk

    fd = CTFrontDoor(Geometry(), n_slots=2, policy="srsf", strategy="auto")
    ticket = await fd.open_scan(tenant="clinic-a")
    await fd.submit(ticket, ProjectionChunk(projs, mats, angles))
    volume = await fd.result(ticket)
"""

from __future__ import annotations

from .core.backproject import reconstruct
from .core.filtering import filter_projections
from .core.geometry import Geometry
from .core.pipeline import reconstruct_shards, sharded_reconstruct
from .dispatch import (Dispatcher, ExecutionPlan, get_dispatcher,
                       set_dispatcher)
from .serving.ct_frontdoor import (POLICIES, AdmissionPolicy, Backpressure,
                                   CTFrontDoor, DeadlinePolicy,
                                   FairSharePolicy, FIFOPolicy,
                                   PolicyContext, ScanAborted, ScanTicket,
                                   SRSFPolicy)
from .streaming import ProjectionChunk, ReconstructionEngine, ScanState
from .tune import TunedConfig, autotune

__all__ = [
    # one-shot + sharded reconstruction
    "Geometry",
    "filter_projections",
    "reconstruct",
    "sharded_reconstruct",
    "reconstruct_shards",
    # dispatch
    "Dispatcher",
    "ExecutionPlan",
    "get_dispatcher",
    "set_dispatcher",
    # tuning
    "TunedConfig",
    "autotune",
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
