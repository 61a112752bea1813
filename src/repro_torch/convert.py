"""Carry state across from the JAX package to the port.

CT has no weights: what both sides must share to compute the same thing
is the geometry, the filter plan, the execution plan, the int8 wire's
encodings and the slot volumes.  The reference's objects arrive here as
plain Python and numpy values (this package never imports ``repro``): a
geometry as ``dataclasses.asdict(geom)``, a filter plan as its fields,
an execution plan as ``plan.as_dict()``, a ``RowQuant`` as its three
numpy arrays, volumes and projection stacks as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_f32, resolve_device
from .core.filtering import FilterPlan
from .core.geometry import Geometry
from .dispatch.plan import ExecutionPlan
from .quant import RowQuant

__all__ = ["geometry_from_reference", "filter_plan_from_reference",
           "tensor_from_reference", "rowquant_from_reference",
           "plan_from_reference"]


def geometry_from_reference(fields: dict) -> Geometry:
    """A port :class:`Geometry` from ``dataclasses.asdict`` of the
    reference's; unknown or missing fields raise."""
    return Geometry(**fields)


def filter_plan_from_reference(pad, n_u, n_proj, scale, hf, cosw, parker,
                               *, device="cuda") -> FilterPlan:
    """A port :class:`FilterPlan` from the reference plan's fields
    (``hf`` complex64, ``cosw``/``parker`` float32 numpy; ``parker`` may
    be ``None``), as tensors on ``device``.  Values are carried bitwise."""
    dev = resolve_device(device)
    hf = np.asarray(hf)
    if hf.dtype != np.complex64:
        raise TypeError(f"hf must be complex64, got {hf.dtype}")
    return FilterPlan(
        pad=int(pad), n_u=int(n_u), n_proj=int(n_proj), scale=float(scale),
        hf=torch.tensor(hf, device=dev),
        cosw=tensor_from_reference(cosw, device=dev),
        parker=(None if parker is None
                else tensor_from_reference(parker, device=dev)))


def tensor_from_reference(array, *, device="cuda") -> torch.Tensor:
    """A float32 tensor on ``device`` from a reference volume or
    projection stack handed over as numpy."""
    return as_f32(array, resolve_device(device))


def rowquant_from_reference(rq, *, device="cuda") -> RowQuant:
    """A port :class:`RowQuant` from the reference's ``(codes, scale,
    offset)`` (int8 and float32 numpy, any leading stack axes), carried
    bitwise to ``device``."""
    codes, scale, offset = (np.asarray(a) for a in rq)
    if codes.dtype != np.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if scale.shape != codes.shape[:-1] or offset.shape != scale.shape:
        raise ValueError(f"scale/offset must be {codes.shape[:-1]} for "
                         f"codes {codes.shape}; got {scale.shape} and "
                         f"{offset.shape}")
    dev = resolve_device(device)
    return RowQuant(torch.tensor(codes, device=dev),
                    tensor_from_reference(scale, device=dev),
                    tensor_from_reference(offset, device=dev))


def plan_from_reference(fields: dict) -> ExecutionPlan:
    """A port :class:`ExecutionPlan` from the reference plan's
    ``as_dict()``: the strategy part revalidated as an explicit plan,
    the tuned kernel config (``pallas``, ``use_pallas``) carried as it
    is.  A kernel config key the port's kernels do not take raises."""
    from .tune.cache import _PALLAS_KEYS

    plan = ExecutionPlan.explicit(fields["strategy"], fields["opts"],
                                  fields["pbatch"])
    pallas = fields.get("pallas")
    if not pallas:
        if fields.get("use_pallas"):
            raise ValueError("use_pallas=True needs a kernel config")
        return plan
    stray = sorted(set(pallas) - set(_PALLAS_KEYS))
    if stray:
        raise ValueError(f"kernel config keys {stray} are not taken by the "
                         f"port's kernels {_PALLAS_KEYS}")
    return plan._replace(pallas=tuple(sorted(pallas.items())),
                         use_pallas=bool(fields.get("use_pallas")))
