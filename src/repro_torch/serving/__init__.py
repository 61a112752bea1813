"""Serving: the multi-tenant CT front door and the batched LM engine."""

from .ct_frontdoor import (POLICIES, AdmissionPolicy, Backpressure,
                           CTFrontDoor, DeadlinePolicy, FairSharePolicy,
                           FIFOPolicy, PolicyContext, ScanAborted,
                           ScanTicket, SRSFPolicy)
from .engine import Request, ServingEngine

__all__ = [
    "AdmissionPolicy", "Backpressure", "CTFrontDoor", "DeadlinePolicy",
    "FairSharePolicy", "FIFOPolicy", "POLICIES", "PolicyContext",
    "ScanAborted", "ScanTicket", "SRSFPolicy",
    "Request", "ServingEngine",
]
