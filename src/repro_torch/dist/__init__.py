"""Distribution layer: logical-axis sharding rules + custom collectives.

The port's counterpart of ``repro.dist``, on ``torch.distributed``.  One
sharding vocabulary for both workloads: code annotates tensors with
*logical* axis names (``batch``, ``fsdp``, ``tp``, ``ep``, ``sp``,
``vol``, ``proj``, ...); :mod:`repro_torch.dist.sharding` maps those to
the axes of a ``DeviceMesh``, pruning whatever the mesh does not have,
and to DTensor placements.  :mod:`repro_torch.dist.collectives` holds the
hand-scheduled all-reduce variants (bucketed exact, int8 error-feedback);
:mod:`repro_torch.dist.fsdp` places the LM's parameters on a mesh and
gathers them per layer (data parallelism with ZeRO-3), and
:mod:`repro_torch.dist.tp` splits the LM's compute over ``tp`` and its
residual stream over ``sp_act`` (Megatron-style tensor and sequence
parallelism).
Every rank runs the same program (SPMD).
"""

from . import tp  # noqa: F401
from .collectives import bucketed_psum, compress_psum  # noqa: F401
from .fsdp import place_params  # noqa: F401
from .sharding import (ShardingRules, current,  # noqa: F401
                       logical_to_spec, shard_constraint, sharding_context,
                       spec_to_placements, valid_spec)

__all__ = [
    "ShardingRules",
    "logical_to_spec",
    "valid_spec",
    "spec_to_placements",
    "sharding_context",
    "current",
    "shard_constraint",
    "place_params",
    "bucketed_psum",
    "compress_psum",
    "tp",
]
