"""Carry state across from the JAX package to the port.

CT has no weights: what both sides must share to compute the same thing
is the geometry, the filter plan and the slot volumes.  The reference's
objects arrive here as plain Python and numpy values (this package never
imports ``repro``): a geometry as ``dataclasses.asdict(geom)``, a filter
plan as its fields, volumes and projection stacks as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_f32, resolve_device
from .core.filtering import FilterPlan
from .core.geometry import Geometry

__all__ = ["geometry_from_reference", "filter_plan_from_reference",
           "tensor_from_reference"]


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
