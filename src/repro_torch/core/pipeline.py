"""Distributed reconstruction pipeline over a ``DeviceMesh`` (SPMD).

The port's counterpart of ``repro.core.pipeline``.  Decomposition:

* volume z-planes are sharded over the ``data`` mesh axis, the direct
  analogue of the paper's OpenMP plane decomposition ("the voxel volume
  is segmented into voxel planes that can be processed independently");
* the projection set is sharded over the ``model`` axis (and over
  ``pod`` when present): each rank back-projects its projection subset
  into its full local z-slab, then the slabs are all-reduced (sum) over
  the projection axes.  Back projection is a sum over projections, so
  this is exact up to the order of the sum.

The reference is single-controller: one process hands ``shard_map`` the
global arrays.  ``torch.distributed`` is SPMD: every rank calls
:func:`sharded_reconstruct` with the same full arrays and takes its own
part, the contiguous block of projections that its coordinate on the
projection axes names (what ``P("model")`` gives a ``shard_map`` body)
and the z-slab of ``L / data`` planes at ``z0 = index * slab``.  Only
the slab's all-reduce moves data: ``(L^3 / data) * 4`` bytes per
projection axis.  The plan is resolved once, on the mesh's first rank,
and broadcast, so every rank runs one identical plan.

Each rank's slab update is the port's fold (:func:`repro_torch.core.
backproject.fold_projections`) at the slab's ``z0``: on the card the
back-projection kernel (row 1, or the tuned strip kernel a plan names),
on the CPU the named strategy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import as_f32, resolve_device
from ..dist.sharding import ShardingRules, logical_to_spec, _sizes, \
    spec_to_placements
from .backproject import _fold, _resolve_plan, check_windows
from .filtering import apply_filter, make_filter_plan
from .geometry import Geometry

__all__ = ["sharded_reconstruct", "reconstruct_shards"]


def reconstruct_shards(local_projs, local_mats, gs, plan, local_volume, *,
                       z0=None):
    """Per-rank body: back-project the local projection subset into
    ``local_volume``, in place (returned).

    ``plan`` is the resolved :class:`repro_torch.dispatch.ExecutionPlan`
    (``ExecutionPlan.explicit(...)``, or the dispatcher's).  ``gs`` is the
    :class:`Geometry` (or its ``GeomStatic``; a plan that folds through
    a tuned strip kernel needs the full geometry).  ``local_volume`` may
    be a z-slab of the full volume; ``z0`` is the slab's first *global*
    z index (default 0: a full-volume or first-slab caller).
    """
    return _fold(local_volume, local_projs, local_mats, gs, plan,
                 0 if z0 is None else int(z0))


def _block(mesh, entry) -> int:
    """This rank's block index along the mesh axes of a spec ``entry``
    (``None``, a name or a tuple of names), major to minor."""
    if entry is None:
        return 0
    sizes = _sizes(mesh)
    k = 0
    for ax in (entry if isinstance(entry, tuple) else (entry,)):
        k = k * sizes[ax] + mesh.get_local_rank(ax)
    return k


def _on_first_rank(mesh, fn):
    """Run ``fn`` on the mesh's first rank and hand its result to every
    rank.  An exception there is handed on too and raised on every rank,
    so that no rank waits for a peer that gave up."""
    box = [None]
    if all(c == 0 for c in mesh.get_coordinate()):
        try:
            box[0] = (fn(), None)
        except Exception as e:      # forwarded to the peers, raised below
            box[0] = (None, e)
    # Along each mesh dimension in turn, from coordinate 0: after the
    # last one every rank holds the first rank's box.
    for d in range(mesh.ndim):
        group = mesh.get_group(d)
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
    result, err = box[0]
    if err is not None:
        raise err
    return result


def sharded_reconstruct(projections, matrices, geom: Geometry, mesh, *,
                        strategy: str = "strip2",
                        volume_axis: str = "data",
                        proj_axes: tuple[str, ...] = ("model",),
                        pbatch: int | None = None,
                        prefiltered: bool = True,
                        short_scan: bool | None = None,
                        device="cuda", **opts):
    """Reconstruct on a device mesh; every rank of the mesh calls this
    with the same arguments.

    ``projections``: ``(n_proj, n_v, n_u)`` filtered images (a tensor or
    a numpy array; a rank moves only its own block to ``device``), with
    ``(n_proj, 3, 4)`` ``matrices``.  ``n_proj`` must divide by the
    product of ``proj_axes`` sizes, and ``geom.L`` by the
    ``volume_axis`` size.  ``device`` must be of the mesh's device type.
    Returns the ``(L, L, L)`` volume as a ``DTensor``: ``Shard(0)`` on
    ``volume_axis``, ``Replicate()`` on the other mesh axes
    (``to_local()`` is this rank's slab, ``full_tensor()`` the whole
    volume).

    ``prefiltered=False`` takes *raw* line integrals instead: each rank
    FDK-filters its own projection block (cosine + Parker + ramp) before
    back-projecting, so the filter scales out with the ``proj`` axes.
    Parker rows are taken by *global angle index*, so the raw stack must
    be the full scan.

    ``strategy="auto"`` resolves through the process dispatcher
    (:mod:`repro_torch.dispatch`) exactly like
    :func:`repro_torch.core.backproject.reconstruct`.  Resolution (the
    tuned ``pbatch`` included) and the window check run on the mesh's
    first rank only, and the plan is broadcast: every rank runs one
    identical plan, and only one rank times candidates or writes the
    tune cache.
    """
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {str(device)!r} is not of the mesh's "
                         f"device type {mesh.device_type!r}")
    sizes = _sizes(mesh)
    proj_shards = 1
    for ax in proj_axes:
        proj_shards *= sizes[ax]
    z_shards = sizes[volume_axis]
    n_proj = int(projections.shape[0])
    if n_proj % proj_shards:
        raise ValueError(
            f"n_proj={n_proj} not divisible by projection shards "
            f"{proj_shards}")
    if geom.L % z_shards:
        raise ValueError(f"L={geom.L} not divisible by {z_shards} z-shards")
    if not prefiltered and n_proj != geom.n_proj:
        raise ValueError(
            f"prefiltered=False filters by global angle index, so the raw "
            f"stack must be the full scan: got {n_proj} projections for "
            f"n_proj={geom.n_proj}")

    def resolve():
        plan = _resolve_plan(geom, strategy, opts, pbatch)
        check_windows(geom, matrices, plan, dev)
        return plan

    plan = _on_first_rank(mesh, resolve)

    # One sharding vocabulary with the LM path (repro_torch.dist): the CT
    # decomposition is two more logical axes, ``vol`` and ``proj``.
    rules = ShardingRules(vol=(volume_axis,), proj=tuple(proj_axes))
    per = n_proj // proj_shards
    k = _block(mesh, logical_to_spec(("proj",), rules, mesh)[0])
    rows = slice(k * per, (k + 1) * per)
    local_projs = as_f32(projections[rows], dev)
    if not prefiltered:
        fplan = make_filter_plan(geom, short_scan, device=dev)
        pw = None if fplan.parker is None else fplan.parker[rows]
        local_projs = apply_filter(local_projs, fplan, pw)

    slab = geom.L // z_shards
    volume = torch.zeros((slab, geom.L, geom.L), dtype=torch.float32,
                         device=dev)
    reconstruct_shards(local_projs, matrices[rows], geom, plan, volume,
                       z0=mesh.get_local_rank(volume_axis) * slab)
    del local_projs
    # Sum the projection-sharded partial slabs.
    for ax in proj_axes:
        dist.all_reduce(volume, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(ax))

    from torch.distributed.tensor import DTensor

    placements = spec_to_placements(
        logical_to_spec(("vol", None, None), rules, mesh), mesh)
    return DTensor.from_local(volume, mesh, placements, run_check=False)
