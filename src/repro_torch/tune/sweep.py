"""The sweep: time every candidate strategy/config on one device.

The counterpart of ``repro.tune.sweep``.  A candidate carrying
``pbatch`` is timed on a ``pbatch``-deep projection stack and normalised
to **µs per projection**, so depths compete on one scale.  A decision is
persisted for the *geometry*, so every candidate's windows are first
checked against the strip planner over **all** of the geometry's
matrices, on the sweep's device (:mod:`repro_torch.core.clipping`);
a candidate whose windows would drop a tap is *skipped with its
reason*, never timed.

On the card every strategy candidate folds through the row-1 kernel
(which reads taps directly), so what the strategies compete on there is
their ``pbatch`` and their wire; a kernel candidate runs its CUDA kernel
(K3 ``strip_db``, K4 ``strip_micro``, K5 ``strip_shared``, or row 1 with
its tile keywords checked).  A decision's ``use_pallas`` therefore means
on the card that a row 4–8 variant, a ``pbatch`` or a wire beat row 1 at
the strategies' settings.  Kernel candidates are timed only on a CUDA
device: on the CPU they run the kernels' plain versions, whose times say
nothing about the card, so they are skipped with that reason.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.backproject import (STRATEGIES, GeomStatic, backproject_batch,
                                backproject_one, validate_strip_opts)
from ..core.geometry import Geometry, projection_matrices, \
    projection_matrix
from .cache import device_identity
from .space import WIRE_ITEMSIZE, Candidate, default_space, \
    kernel_smem_bytes
from .timing import time_fn

__all__ = ["Timing", "SweepResult", "sweep_strategies"]


@dataclasses.dataclass(frozen=True)
class Timing:
    """One measured sweep point (``us_per_call`` = µs per *projection*)."""

    label: str
    strategy: str
    opts: tuple
    us_per_call: float
    gups: float                     # billions of voxel updates / second

    def as_dict(self) -> dict:
        return {"label": self.label, "strategy": self.strategy,
                "opts": dict(self.opts), "us_per_call": self.us_per_call,
                "gups": self.gups}


@dataclasses.dataclass
class SweepResult:
    geom_key: tuple
    backend: str
    device_kind: str
    timings: list[Timing]
    skipped: list[tuple[str, str]]  # (candidate label, reason)

    def best(self, strategies: tuple[str, ...] | None = None):
        pool = [t for t in self.timings
                if strategies is None or t.strategy in strategies]
        return min(pool, key=lambda t: t.us_per_call) if pool else None


def _default_problem(geom: Geometry, dev):
    """One mid-sweep projection of white noise (the timings do not
    depend on image content)."""
    rng = np.random.default_rng(0)
    image = torch.tensor(rng.standard_normal((geom.n_v, geom.n_u)),
                         dtype=torch.float32, device=dev)
    theta = float(geom.angles[geom.n_proj // 2])
    A = torch.tensor(projection_matrix(geom, theta), dtype=torch.float32,
                     device=dev)
    return image, A


def _batch_problem(geom: Geometry, image, pbatch: int):
    """A ``pbatch``-deep stack around the mid-sweep angle: distinct
    matrices, one noise image replicated."""
    k0 = max(0, geom.n_proj // 2 - pbatch // 2)
    thetas = [float(geom.angles[min(k0 + i, geom.n_proj - 1)])
              for i in range(pbatch)]
    mats = torch.tensor(np.stack([projection_matrix(geom, th)
                                  for th in thetas]),
                        dtype=torch.float32, device=image.device)
    images = image.expand((pbatch,) + tuple(image.shape)).contiguous()
    return images, mats


def _check_kernel_windows(geom: Geometry, gs: GeomStatic, mats_all,
                          opts: dict, pbatch: int, dev) -> None:
    """The kernel candidate's windows over every matrix, as the wrapper
    would run them; raises ``ValueError`` with the reason."""
    from ..core.clipping import shared_box_slots
    from ..kernels.backproject import SMEM_LIMIT
    from ..kernels.backproject_ops import (check_variant_windows,
                                           clamp_tiles, shared_window_dims)
    from ..kernels.backproject_ref import padded_dims

    if not opts.get("shared_window", False):
        # K4 is checked at its own window, the values the candidate
        # persists.
        check_variant_windows(geom, mats_all, opts, device=dev)
        return
    # Size the window and the box slots over the full matrix set (what a
    # run resolves) and screen them against the shared memory of a block.
    ty, chunk, _, _ = clamp_tiles(gs, opts.get("ty", 8),
                                  opts.get("chunk", 128), 16, 512)
    pb_eff = max(1, min(pbatch, geom.n_proj))
    sband, swidth = shared_window_dims(
        geom, mats_all, ty=ty, chunk=chunk, pbatch=pb_eff,
        shared_band=opts.get("shared_band"),
        shared_width=opts.get("shared_width"), device=dev)
    _, _, sband, swidth = clamp_tiles(gs, ty, chunk, sband, swidth)
    itemsize = WIRE_ITEMSIZE[str(opts.get("strip_dtype", "float32"))]
    pad_rows, pad_cols = padded_dims(gs, sband, swidth, itemsize)
    slot = int(shared_box_slots(
        gs, mats_all, ty=ty, chunk=chunk, band=sband, width=swidth,
        pad_rows=pad_rows, pad_cols=pad_cols, itemsize=itemsize,
        pbatch=pb_eff, device=dev).max())
    smem = kernel_smem_bytes(gs, dict(opts, pbatch=pb_eff), slot=slot)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"shared window ({sband}, {swidth}) x pbatch={pb_eff}: its "
            f"tiles' boxes need {smem} B of shared memory per block, "
            f"more than a block's {SMEM_LIMIT} B")


def sweep_strategies(geom: Geometry, *, image=None, A=None,
                     space: list[Candidate] | None = None,
                     include_pallas: bool | None = None,
                     warmup: int = 1, iters: int = 3,
                     min_total_s: float | None = None,
                     device="cuda") -> SweepResult:
    """Time every valid candidate for ``geom`` on ``device``.

    ``include_pallas=None`` proposes the kernel candidates only on a
    CUDA device.  ``min_total_s`` overrides :func:`time_fn`'s adaptive
    floor (0 pins the sample count to ``iters``).
    """
    dev = resolve_device(device)
    tkw = {} if min_total_s is None else {"min_total_s": min_total_s}
    gs = GeomStatic.of(geom)
    on_card = dev.type == "cuda"
    if include_pallas is None:
        include_pallas = on_card
    if space is None:
        space = default_space(gs, include_pallas=include_pallas)
    if image is None or A is None:
        image, A = _default_problem(geom, dev)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    mats_all = projection_matrices(geom)
    vol0 = torch.zeros((gs.L,) * 3, dtype=torch.float32, device=dev)

    timings: list[Timing] = []
    skipped: list[tuple[str, str]] = []
    for cand in space:
        opts = dict(cand.opts)
        pbatch = max(1, int(opts.pop("pbatch", 1)))
        try:
            if cand.strategy in STRATEGIES:
                validate_strip_opts(geom, mats_all, cand.strategy, opts,
                                    device=dev)
                if pbatch == 1:
                    t = time_fn(backproject_one, vol0, image, A, geom,
                                strategy=cand.strategy, warmup=warmup,
                                iters=iters, **tkw, **opts)
                else:
                    images, mats = _batch_problem(geom, image, pbatch)
                    t = time_fn(backproject_batch, vol0, images, mats,
                                geom, strategy=cand.strategy,
                                pbatch=pbatch, warmup=warmup,
                                iters=iters, **tkw, **opts) / pbatch
            elif cand.strategy == "pallas":
                from ..kernels.backproject_ops import (backproject_batch as
                                                       kernel_batch,
                                                       backproject_one as
                                                       kernel_one)

                _check_kernel_windows(geom, gs, mats_all, opts, pbatch, dev)
                if not on_card:
                    raise ValueError(
                        "kernel candidates are timed only on a CUDA device")
                if pbatch == 1:
                    t = time_fn(kernel_one, vol0, image, A, geom,
                                warmup=warmup, iters=iters, **tkw, **opts)
                else:
                    images, mats = _batch_problem(geom, image, pbatch)
                    t = time_fn(kernel_batch, vol0, images, mats, geom,
                                pbatch=pbatch, validate=False,
                                warmup=warmup, iters=iters, **tkw,
                                **opts) / pbatch
            else:
                raise ValueError(f"unknown candidate strategy "
                                 f"{cand.strategy!r}")
        except ValueError as e:
            skipped.append((cand.label, str(e)))
            continue
        timings.append(Timing(
            label=cand.label, strategy=cand.strategy, opts=cand.opts,
            us_per_call=t * 1e6, gups=gs.L ** 3 / t / 1e9))

    backend, device_kind = device_identity("cuda" if on_card else "cpu")
    return SweepResult(geom_key=tuple(gs), backend=backend,
                       device_kind=device_kind,
                       timings=timings, skipped=skipped)
