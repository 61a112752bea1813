"""Logical-axis sharding: names in model code, mesh axes at the edge.

The port's counterpart of ``repro.dist.sharding``.  Every tensor
annotation is written against *logical* axis names; a
:class:`ShardingRules` instance maps each logical name to a tuple of
mesh axis names, and :func:`logical_to_spec` resolves an annotation
against a concrete mesh, silently pruning mesh axes the mesh does not
have (the same rules lower onto a 2-pod 512-card mesh, one 16x16 pod or
a 1x1 test mesh).

A *spec* is a tuple with one entry per tensor dimension: a mesh-axis
name, a tuple of names, or ``None`` (replicated), the shape of a
``jax.sharding.PartitionSpec``.  The mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh`; :func:`logical_to_spec`,
:func:`valid_spec` and :func:`spec_to_placements` read only its
``mesh_dim_names`` and ``shape``, so any object with those two
attributes stands in for one.

Two logical names are always replicated: ``None`` and ``"null"``.

:func:`valid_spec` is the divisibility guard: a tensor dimension that
does not divide by the total size of its mesh axes replicates instead.
:func:`spec_to_placements` turns a spec into DTensor placements
(``Shard(d)`` or ``Replicate()`` per mesh dimension).

:func:`sharding_context` + :func:`shard_constraint` give code a
zero-cost annotation idiom: ``shard_constraint(x, ("batch", None,
"tp"))`` is the identity outside a context and, inside one, returns ``x``
as a DTensor on the context's mesh with the resolved placements.  The
port runs SPMD: a plain tensor handed to it is every rank's full,
identical value (``Replicate()``), and the redistribution to a sharded
placement keeps each rank's block with no communication.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

__all__ = [
    "ShardingRules",
    "logical_to_spec",
    "valid_spec",
    "spec_to_placements",
    "sharding_context",
    "current",
    "shard_constraint",
]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axes mapping (+ schedule feature flags).

    LM axes: ``batch`` (data parallel), ``fsdp`` (ZeRO-3 parameter
    sharding), ``tp`` (tensor parallel), ``ep`` (expert parallel), ``sp``
    (sequence-parallel KV cache), ``sp_act`` (the residual stream).  CT
    axes: ``vol`` (volume z-planes, the paper's OpenMP plane
    decomposition), ``proj`` (projection subsets).

    ``flash_decode`` is a schedule flag, not an axis.
    """

    batch: tuple[str, ...] = ("pod", "data")
    fsdp: tuple[str, ...] = ("data",)
    tp: tuple[str, ...] = ("model",)
    ep: tuple[str, ...] = ("model",)
    sp: tuple[str, ...] = ()
    sp_act: tuple[str, ...] = ()
    vol: tuple[str, ...] = ("data",)
    proj: tuple[str, ...] = ("pod", "model")
    flash_decode: bool = False


def _sizes(mesh) -> dict:
    """Mesh axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def logical_to_spec(axes, rules: ShardingRules, mesh) -> tuple:
    """Resolve logical axis names to a spec on ``mesh``.

    Mesh axes named by a rule but absent from the mesh are pruned (a
    podless mesh collapses ``("pod", "data")`` to ``"data"``); a rule
    whose axes are all pruned, or mapped to ``()``, replicates.
    """
    names = set(mesh.mesh_dim_names)
    entries = []
    for ax in axes:
        if ax is None or ax == "null":
            entries.append(None)
            continue
        mapped = getattr(rules, ax)
        mapped = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        present = tuple(a for a in mapped if a in names)
        if not present:
            entries.append(None)
        elif len(present) == 1:
            entries.append(present[0])
        else:
            entries.append(present)
    return tuple(entries)


def valid_spec(shape, spec: tuple, mesh) -> tuple:
    """Drop spec entries whose dimension does not divide the shard count.

    Each dimension sharded over mesh axes with total size ``n`` must be a
    multiple of ``n``; otherwise that dimension replicates.  Trailing
    replicated entries are trimmed, so fully replicated tails compare
    equal to shorter specs.
    """
    sizes = _sizes(mesh)
    entries = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        shards = 1
        for a in axes:
            shards *= sizes[a]
        entries.append(entry if dim % shards == 0 else None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``: per mesh dimension, ``Shard(d)``
    for the tensor dimension ``d`` whose entry names it, else
    ``Replicate()``.

    An entry naming several mesh axes shards its dimension over them
    major to minor, which DTensor expresses only in mesh order; a mesh
    axis named twice, or absent from the mesh, raises.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    claimed: set[str] = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} is not in the mesh's "
                                 f"{tuple(names)}")
            if a in claimed:
                raise ValueError(f"mesh axis {a!r} shards two dimensions "
                                 f"of spec {spec!r}")
            claimed.add(a)
            placements[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry!r} shards a dimension against the mesh "
                f"order {tuple(names)}, which DTensor cannot place")
    return tuple(placements)


# ----------------------------------------------------------------------
# Ambient sharding context
# ----------------------------------------------------------------------

# (mesh, rules) of the innermost active sharding_context, or None.  A
# ContextVar so that nested or threaded launchers each see their own.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_context", default=None)


@contextlib.contextmanager
def sharding_context(mesh, rules: ShardingRules):
    """Make ``(mesh, rules)`` ambient for :func:`shard_constraint` and
    the collectives of :mod:`repro_torch.dist.collectives`."""
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current():
    """``(mesh, rules)`` of the innermost :func:`sharding_context`, or
    ``None`` outside one."""
    return _CTX.get()


# Valid logical names for annotations (flash_decode is a flag, not an
# axis).  Checked even outside a context, so a mistyped annotation fails
# in single-device tests, not at the first launch on a mesh.
_LOGICAL_AXES = frozenset(
    f.name for f in dataclasses.fields(ShardingRules)) - {"flash_decode"}


def shard_constraint(x, logical_axes):
    """Pin ``x`` to its logical sharding: the identity outside a context.

    Inside a :func:`sharding_context`, ``x`` (a DTensor, or a plain
    tensor holding every rank's identical full value) is redistributed
    to the resolved, divisibility-guarded placements on the context's
    mesh and returned as a DTensor.
    """
    for ax in logical_axes:
        if ax is not None and ax != "null" and ax not in _LOGICAL_AXES:
            raise ValueError(f"unknown logical axis {ax!r}; want one of "
                             f"{sorted(_LOGICAL_AXES)}")
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh, rules = ctx
    spec = valid_spec(tuple(x.shape),
                      logical_to_spec(logical_axes, rules, mesh), mesh)
    placements = spec_to_placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(torch.as_tensor(x), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, placements)
