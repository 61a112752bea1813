"""repro_torch: the cone-beam CT reconstruction stack in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``repro``, which stays the reference: this
package never imports it (nor JAX).  The public surface is
:mod:`repro_torch.api`, re-exported here.
"""

from .api import (POLICIES, AdmissionPolicy, Backpressure, CTFrontDoor,
                  DeadlinePolicy, FairSharePolicy, FIFOPolicy, Geometry,
                  PolicyContext, ProjectionChunk, ReconstructionEngine,
                  ScanAborted, ScanState, ScanTicket, SRSFPolicy,
                  filter_projections, reconstruct)

__version__ = "0.1.0"

__all__ = [
    "Geometry", "filter_projections", "reconstruct", "ProjectionChunk",
    "ReconstructionEngine", "ScanState", "CTFrontDoor", "ScanTicket",
    "Backpressure", "ScanAborted", "AdmissionPolicy", "FIFOPolicy",
    "SRSFPolicy", "DeadlinePolicy", "FairSharePolicy", "PolicyContext",
    "POLICIES",
]
