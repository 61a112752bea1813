"""repro_torch: the cone-beam CT reconstruction stack in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100, on one card or sharded
over a ``torch.distributed`` mesh, and the language-model stack that
serves all ten of the reference's architectures (:mod:`repro_torch.models`,
:mod:`repro_torch.serving`).

A port of the JAX package ``repro``, which stays the reference: this
package never imports it (nor JAX).  The public surface is
:mod:`repro_torch.api`, re-exported here.
"""

from .api import (POLICIES, AdmissionPolicy, Backpressure, CTFrontDoor,
                  DeadlinePolicy, Dispatcher, ExecutionPlan,
                  FairSharePolicy, FIFOPolicy, Geometry, PolicyContext,
                  ProjectionChunk, ReconstructionEngine, ScanAborted,
                  ScanState, ScanTicket, SRSFPolicy, TunedConfig, autotune,
                  filter_projections, get_dispatcher, reconstruct,
                  reconstruct_shards, set_dispatcher, sharded_reconstruct)

__version__ = "0.1.0"

__all__ = [
    "Geometry", "filter_projections", "reconstruct", "sharded_reconstruct",
    "reconstruct_shards", "Dispatcher",
    "ExecutionPlan", "get_dispatcher", "set_dispatcher", "TunedConfig",
    "autotune",
    "ProjectionChunk",
    "ReconstructionEngine", "ScanState", "CTFrontDoor", "ScanTicket",
    "Backpressure", "ScanAborted", "AdmissionPolicy", "FIFOPolicy",
    "SRSFPolicy", "DeadlinePolicy", "FairSharePolicy", "PolicyContext",
    "POLICIES",
]
