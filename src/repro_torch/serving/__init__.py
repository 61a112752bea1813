"""Serving: the multi-tenant CT front door."""

from .ct_frontdoor import (POLICIES, AdmissionPolicy, Backpressure,
                           CTFrontDoor, DeadlinePolicy, FairSharePolicy,
                           FIFOPolicy, PolicyContext, ScanAborted,
                           ScanTicket, SRSFPolicy)

__all__ = [
    "AdmissionPolicy", "Backpressure", "CTFrontDoor", "DeadlinePolicy",
    "FairSharePolicy", "FIFOPolicy", "POLICIES", "PolicyContext",
    "ScanAborted", "ScanTicket", "SRSFPolicy",
]
