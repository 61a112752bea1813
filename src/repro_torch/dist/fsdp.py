"""Parameters and activations of the LM stack on a device mesh.

The port's counterpart of what the reference leaves to GSPMD once its
launcher has placed the parameters with ``tree_shardings``
(``repro/launch/train.py:32``): data parallelism over the ``batch``
axes and ZeRO-3 (FSDP) over the ``fsdp`` axes.

* :func:`place_params` turns each parameter of a module into a DTensor
  with the placements its logical spec resolves to
  (:func:`~repro_torch.dist.sharding.logical_to_spec`,
  :func:`~repro_torch.dist.sharding.valid_spec`,
  :func:`~repro_torch.dist.sharding.spec_to_placements`); each rank keeps
  only its block.  Every rank draws the same full tensors from the seed
  first (SPMD), so the placement needs no communication.
* :func:`gather` is the per-layer all-gather inside the model's remat
  region: the full parameter as a plain tensor, whose gradient is summed
  over the mesh dimensions the batch is split on (the ``Partial()``
  placements of :func:`grad_placements`) and cut back to the rank's
  block.  No DTensor reaches the model's code or a hand-written kernel.
* Under tensor parallelism (:mod:`repro_torch.dist.tp`) :func:`gather`
  keeps a ``tp``-split parameter's block (``keep_axes=rules.tp``: the
  gradient is the rank's own block), gathers a fused one over ``tp`` too
  with its gradient summed there (``sum_axes=rules.tp``), and under
  ``sp_act`` sums a norm's gradient over the sequence split
  (``sum_axes=rules.sp_act``; :func:`grad_placements`).
* :func:`batch_block` / :func:`gather_rows` split the batch over the
  batch axes (a batch the shards do not divide is replicated) and put
  rows back together; :func:`reduced` is an all-reduce whose gradient
  is the local one, for a global loss.

Every collective goes through ``torch.distributed`` directly (one
process group per mesh dimension), never through DTensor's
``redistribute``: with gloo and CUDA tensors (several ranks on one card)
DTensor's functional collectives crash in torch 2.11, where the c10d
calls work.  A mesh dimension of size 1 issues no collective, so a mesh
of one rank runs the one-device code exactly (the model does not place
anything on it).  :data:`COUNTS` counts the collectives issued.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from .sharding import current, logical_to_spec, spec_to_placements, \
    valid_spec

__all__ = ["COUNTS", "active", "batch_dims", "axis_dims", "place",
           "place_params", "local_block", "full_value", "like",
           "grad_placements", "gather", "all_reduce", "batch_block", "gather_rows",
           "reduced", "sum_grad", "axes_offset", "rank_prefix", "local",
           "is_placed"]

# Collectives issued through this module, by kind (reset by callers).
COUNTS = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}


def active():
    """``(mesh, rules)`` of the innermost sharding context when its mesh
    has more than one rank, else ``None``."""
    ctx = current()
    if ctx is None or ctx[0].size() == 1:
        return None
    return ctx


def axis_dims(mesh, axes) -> tuple[int, ...]:
    """Mesh dimension indices of ``axes`` that the mesh has with a size
    above 1, in mesh order."""
    names = list(mesh.mesh_dim_names)
    return tuple(sorted(names.index(a) for a in axes
                        if a in names and mesh.size(names.index(a)) > 1))


def batch_dims(mesh, rules) -> tuple[int, ...]:
    """The mesh dimensions the batch is split on."""
    return axis_dims(mesh, rules.batch)


def is_placed(t) -> bool:
    """Whether ``t`` is a placed (DTensor) leaf."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block, or ``t`` itself."""
    return t.to_local() if is_placed(t) else t


def _shards(mesh, placements):
    """``[(mesh dim, tensor dim)]`` of the Shard placements on mesh
    dimensions above size 1, in mesh order (major to minor)."""
    return [(i, pl.dim) for i, pl in enumerate(placements)
            if pl.is_shard() and mesh.size(i) > 1]


def local_block(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (a view):
    major mesh dimensions split first, as DTensor lays out a tensor
    dimension sharded over several mesh dimensions."""
    coord = mesh.get_coordinate()
    for i, d in _shards(mesh, placements):
        full = full.chunk(mesh.size(i), dim=d)[coord[i]]
    return full


def _contiguous_stride(shape) -> tuple:
    return torch.empty(tuple(shape), device="meta").stride()


def like(local_t: torch.Tensor, mesh, placements, shape):
    """A DTensor over ``local_t``, this rank's block of a tensor of
    ``shape`` (no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def place(full: torch.Tensor, logical_axes, mesh, rules) -> torch.Tensor:
    """``full`` (every rank's identical copy) as a DTensor placed by its
    logical axes: this rank keeps a contiguous copy of its block.
    Placements on mesh dimensions of size 1 are ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    spec = valid_spec(tuple(full.shape),
                      logical_to_spec(logical_axes, rules, mesh), mesh)
    placements = [pl if mesh.size(i) > 1 else Replicate()
                  for i, pl in enumerate(spec_to_placements(spec, mesh))]
    block = local_block(full, mesh, placements).contiguous().clone()
    return like(block, mesh, placements, full.shape)


def place_params(module: nn.Module, specs: dict, mesh, rules) -> nn.Module:
    """Replace each parameter of ``module`` (named as in ``specs``, e.g.
    :func:`repro_torch.models.model.param_specs`) by its placed DTensor,
    in place; the full tensors are freed.  A mesh of one rank places
    nothing.  This is for parameters loaded whole (converted from the
    reference); a drawn model is placed as it is drawn
    (:func:`repro_torch.models.model.init_model` with ``mesh=``)."""
    if mesh.size() == 1:
        return module
    named = dict(module.named_parameters())
    if set(named) != set(specs):
        raise ValueError(f"specs name {sorted(set(specs) ^ set(named))[:4]} "
                         f"that the module does not, or the reverse")
    for name, p in named.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        placed = place(p.detach(), specs[name], mesh, rules)
        owner._parameters[leaf] = nn.Parameter(placed,
                                               requires_grad=p.requires_grad)
        del p
    return module


def _group(mesh, i: int):
    return mesh.get_group(i)


def _all_gather_dim(t: torch.Tensor, mesh, i: int, d: int) -> torch.Tensor:
    """Blocks of ``t`` from every rank along mesh dimension ``i``,
    concatenated along tensor dimension ``d``."""
    n = mesh.size(i)
    src = t.movedim(d, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=_group(mesh, i))
    COUNTS["all_gather"] += 1
    return out.movedim(0, d)


def _gather_local(t: torch.Tensor, mesh, placements, keep=()) -> torch.Tensor:
    """The full tensor from the local blocks ``t``: minor mesh
    dimensions first; mesh dimensions in ``keep`` stay split."""
    for i, d in reversed(_shards(mesh, placements)):
        if i not in keep:
            t = _all_gather_dim(t, mesh, i, d)
    return t


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value on every rank (no gradient), or ``t``."""
    if not is_placed(t):
        return t
    with torch.no_grad():
        return _gather_local(t.to_local(), t.device_mesh, t.placements)


def all_reduce(t: torch.Tensor, mesh, dims, op=dist.ReduceOp.SUM):
    """``t`` all-reduced in place over mesh dimensions ``dims``."""
    for i in dims:
        dist.all_reduce(t, op=op, group=_group(mesh, i))
        COUNTS["all_reduce"] += 1
    return t


def grad_placements(mesh, rules, sum_axes=()) -> list:
    """Placements of the gradient of :func:`gather`'s full tensor on a
    rank: ``Partial()`` on the mesh dimensions the batch is split on
    (each rank's gradient covers its rows only) and on those of
    ``sum_axes``, ``Replicate()`` on the others (their ranks computed
    the same values).  ``Replicate()`` everywhere would take a rank's
    own gradient as the whole one."""
    from torch.distributed.tensor import Partial, Replicate

    summed = set(batch_dims(mesh, rules)) | set(axis_dims(mesh, sum_axes))
    return [Partial() if i in summed else Replicate()
            for i in range(mesh.ndim)]


class _Gather(torch.autograd.Function):
    """Full tensor from a placed parameter; backward: the gradient
    summed over its ``Partial()`` mesh dimensions, then this rank's
    block cut from it."""

    @staticmethod
    def forward(ctx, p, grad_pl, keep):
        mesh, placements = p.device_mesh, p.placements
        ctx.meta = (mesh, placements, tuple(p.shape), grad_pl, keep)
        return _gather_local(p.to_local(), mesh, placements, keep)

    @staticmethod
    def backward(ctx, g):
        mesh, placements, shape, grad_pl, keep = ctx.meta
        summed = [i for i, pl in enumerate(grad_pl) if pl.is_partial()
                  and mesh.size(i) > 1]
        g = g.contiguous()
        if summed:
            g = all_reduce(g.clone(), mesh, summed)
        from torch.distributed.tensor import Replicate

        cut = [pl if pl.is_shard() and i not in keep else Replicate()
               for i, pl in enumerate(placements)]
        block = local_block(g, mesh, cut).contiguous()
        return like(block, mesh, placements, shape), None, None


def gather(p: torch.Tensor, mesh, rules, *, keep_axes=(), sum_axes=()):
    """``p`` as the model reads it under a mesh: a placed parameter
    gathered to a full plain tensor (the mesh axes of ``keep_axes`` stay
    split: an expert-parallel rank's own experts), its gradient per
    :func:`grad_placements`.  A plain tensor is returned as it is, and
    refused if it trains while the batch is split: its gradient would be
    the rank's own."""
    if not is_placed(p):
        if p.requires_grad and torch.is_grad_enabled() \
                and batch_dims(mesh, rules):
            raise ValueError("a trainable parameter under a batch-split "
                             "mesh must be placed first (place_params)")
        return p
    keep = axis_dims(mesh, keep_axes)
    return _Gather.apply(p, grad_placements(mesh, rules, sum_axes), keep)


# ----------------------------------------------------------------------
# The batch and the reductions of a global loss
# ----------------------------------------------------------------------

def _batch_placements(mesh, rules, d: int = 0):
    from torch.distributed.tensor import Replicate, Shard

    dims = batch_dims(mesh, rules)
    return [Shard(d) if i in dims else Replicate()
            for i in range(mesh.ndim)]


def batch_block(x: torch.Tensor, mesh, rules, d: int = 0) -> torch.Tensor:
    """This rank's rows of ``x`` (every rank's identical copy) along
    dimension ``d``, split over the batch axes major to minor; all of
    them where the batch shards do not divide them (the reference's
    divisibility guard replicates such a batch).  The model's entry
    points then run without batch axes, so that no gradient is summed
    over ranks that hold the same rows
    (:func:`repro_torch.models.model._guard`)."""
    n = math.prod(mesh.size(i) for i in batch_dims(mesh, rules))
    if x.shape[d] % n:
        return x
    return local_block(x, mesh, _batch_placements(mesh, rules, d))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, rules, d):
        ctx.meta = (mesh, rules, d)
        return _gather_local(x, mesh, _batch_placements(mesh, rules, d))

    @staticmethod
    def backward(ctx, g):
        return batch_block(g, *ctx.meta).contiguous(), None, None, None


def gather_rows(x: torch.Tensor, mesh, rules, d: int = 0) -> torch.Tensor:
    """The inverse of :func:`batch_block`: every rank's rows, in order.
    Its gradient is cut back to this rank's rows: every rank holds the
    same whole value, and the parameters' gradients are summed over the
    batch axes afterwards."""
    if not batch_dims(mesh, rules):
        return x
    return _GatherRows.apply(x, mesh, rules, d)


def reduced(t: torch.Tensor, mesh, dims, op=dist.ReduceOp.SUM):
    """``t`` all-reduced over mesh dimensions ``dims``; its gradient is
    the local one (each rank differentiates its own part of a global
    value, and the parameters' gradients are summed afterwards)."""
    if not dims:
        return t
    total = all_reduce(t.detach().clone(), mesh, dims, op)
    return t + (total - t.detach())


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.meta = (mesh, dims)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, dims = ctx.meta
        return all_reduce(g.contiguous().clone(), mesh, dims), None, None


def sum_grad(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``x`` itself; its gradient all-reduced over ``dims`` (an input
    each of whose ranks differentiates a part of the output)."""
    if not dims or not x.requires_grad:
        return x
    return _SumGrad.apply(x, mesh, dims)


def axes_offset(mesh, axes, unit: int) -> int:
    """This rank's first index along a dimension split over ``axes`` (in
    the rules' order, the first major) into blocks of ``unit``."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    off, stride = 0, unit
    for a in reversed(axes):
        i = names.index(a)
        off += coord[i] * stride
        stride *= mesh.size(i)
    return off


def rank_prefix(v: torch.Tensor, mesh, dims):
    """``(prefix, total)`` of a per-rank vector over mesh dimensions
    ``dims`` in rank order (major to minor): the sum of the ranks before
    this one, and of all of them."""
    coord = mesh.get_coordinate()
    prefix = torch.zeros_like(v)
    for i in reversed(dims):
        every = _all_gather_dim(v[None], mesh, i, 0)
        prefix = prefix + every[:coord[i]].sum(0)
        v = every.sum(0)
    return prefix, v
