"""Public wrapper of the back-projection kernel.

The counterparts of ``repro.kernels.backproject_ops.pallas_backproject_
batch`` / ``pallas_backproject_one``.  On a CUDA volume the wrapper pads
the projection stack once with the 1-pixel zero border the zero-outside
rule relies on and launches the CUDA kernel once per ``pbatch``
projections; it never falls back.  On a CPU volume, and only there, it
runs the plain version (:mod:`.backproject_ref`).

The reference's TPU tiling keywords (``ty``, ``chunk``, ``band``,
``width``, ``double_buffer``, ``db_depth``, ``micro*``,
``shared_window*``, and ``strip_dtype`` other than ``"float32"``) shape
VMEM strips a GPU kernel has no use for; this slice takes none of them,
and passing one raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import as_f32
from ..core.backproject import DEFAULT_PBATCH, GeomStatic, _stream_batches
from ..core.geometry import Geometry
from .backproject import launch_backproject
from .backproject_ref import backproject_batch_ref

__all__ = ["backproject_batch", "backproject_one"]


def _reject_tpu_opts(strip_dtype: str, opts: dict) -> None:
    if strip_dtype != "float32":
        raise ValueError(
            f"strip_dtype={strip_dtype!r} is not ported; the kernel takes "
            f"float32 projections")
    if opts:
        raise ValueError(
            f"TPU tiling options {sorted(opts)} are not taken by the CUDA "
            f"kernel; drop them")


def _operands(volume, images, mats, gs: GeomStatic):
    if not torch.is_tensor(volume) or volume.dtype != torch.float32:
        raise TypeError("volume must be a float32 tensor (updated in place)")
    if volume.ndim != 3 or tuple(volume.shape[1:]) != (gs.L, gs.L):
        raise ValueError(f"volume must be (nz, {gs.L}, {gs.L}); got "
                         f"{tuple(volume.shape)}")
    if not torch.is_tensor(images) or images.dtype != torch.float32:
        raise TypeError("images must be a float32 tensor")
    if images.ndim != 3 or tuple(images.shape[1:]) != (gs.n_v, gs.n_u):
        raise ValueError(f"images must be (P, {gs.n_v}, {gs.n_u}); got "
                         f"{tuple(images.shape)}")
    if images.device != volume.device:
        raise ValueError(f"images lie on {images.device}, volume on "
                         f"{volume.device}")
    mats = as_f32(mats, volume.device).reshape(-1, 3, 4).contiguous()
    if mats.shape[0] != images.shape[0]:
        raise ValueError(f"{images.shape[0]} images but {mats.shape[0]} "
                         f"matrices")
    return mats


def backproject_batch(volume, images, mats, geom: Geometry | GeomStatic, *,
                      pbatch: int = DEFAULT_PBATCH, z0: int = 0,
                      strip_dtype: str = "float32", **tpu_opts):
    """Add a stack of projections to ``volume`` in place, ``pbatch`` per
    kernel launch; returns ``volume``.

    ``volume``: ``(nz, L, L)`` float32, a z-slab starting at global
    plane ``z0`` (the whole volume at ``z0=0``); ``images``: unpadded
    ``(n_proj, n_v, n_u)`` float32 on the volume's device; ``mats``:
    ``(n_proj, 3, 4)``.  A ``pbatch ∤ n_proj`` remainder runs as one
    final smaller launch.
    """
    _reject_tpu_opts(strip_dtype, tpu_opts)
    gs = geom if isinstance(geom, GeomStatic) else GeomStatic.of(geom)
    mats = _operands(volume, images, mats, gs)
    if volume.is_cuda:
        padded = F.pad(images, (1, 1, 1, 1)).contiguous()
        return _stream_batches(
            padded, mats, volume, pbatch,
            lambda vol, imgs, ms: launch_backproject(
                vol, imgs.contiguous(), ms.contiguous(), z0=z0, O=gs.O,
                MM=gs.MM))
    if volume.device.type != "cpu":
        raise ValueError(f"no back projection for device {volume.device}")
    return _stream_batches(
        images, mats, volume, pbatch,
        lambda vol, imgs, ms: backproject_batch_ref(vol, imgs, ms, gs,
                                                    z0=z0))


def backproject_one(volume, image, A, geom: Geometry | GeomStatic, *,
                    z0: int = 0, strip_dtype: str = "float32",
                    **tpu_opts):
    """Add one ``(n_v, n_u)`` projection with its ``(3, 4)`` matrix to
    ``volume`` in place: the batch kernel launched with P = 1."""
    if not torch.is_tensor(image) or image.ndim != 2:
        raise ValueError("image must be one (n_v, n_u) tensor")
    return backproject_batch(volume, image[None], A, geom,
                             pbatch=1, z0=z0, strip_dtype=strip_dtype,
                             **tpu_opts)
