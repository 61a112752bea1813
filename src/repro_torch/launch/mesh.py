"""Mesh construction on ``torch.distributed``.

The port's counterpart of ``repro.launch.mesh``: :func:`make_local_mesh`
and :func:`make_production_mesh`.  Functions, not module-level
constants: importing this module creates no process group.

The port runs SPMD: a world of processes, one per rank, each calling the
same code.  A launcher of several ranks creates the default process
group first (``torch.distributed.init_process_group`` with its store,
rank and world size); :func:`make_local_mesh` then lays that world out
as a ``("data", "model")`` mesh.  A single process needs no launcher:
with no process group and a world of one it creates one on a
``HashStore``, so a 1x1 mesh is a plain function call.

The production topology is the reference's: a pod is a 16x16
``("data", "model")`` mesh of 256 ranks, and ``multi_pod=True`` adds a
leading 2-pod axis (512 ranks).  :func:`init_world` joins a world of
several ranks from the environment a launcher such as ``torchrun``
sets.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["make_local_mesh", "make_production_mesh", "init_world"]


def init_world(device="cuda") -> torch.device:
    """Join the world the environment describes and return this rank's
    device.  ``WORLD_SIZE`` above 1 creates the default process group
    (NCCL on the card, gloo on the CPU) at ``RANK`` through
    ``REPRO_TORCH_INIT_METHOD`` (``env://`` by default: ``MASTER_ADDR``
    and ``MASTER_PORT``), on the card ``LOCAL_RANK`` names; a world of
    one is left to :func:`make_local_mesh`."""
    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda" and dev.index is None and world > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=os.environ.get("REPRO_TORCH_INIT_METHOD", "env://"),
            rank=int(os.environ["RANK"]), world_size=world)
    return dev


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16x16 ``("data", "model")`` pod, or with ``multi_pod`` the
    2x16x16 ``("pod", "data", "model")`` mesh, over a world of 256 or
    512 ranks whose process group exists; any other world raises."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != want:
        raise ValueError(f"make_production_mesh: the {'x'.join(map(str, shape))} "
                         f"mesh needs a world of {want} ranks, not {world}")
    if not dist.is_initialized():
        raise RuntimeError("create the process group of the world before "
                           "make_production_mesh (see init_world)")
    # A fake world (the dry run's) holds no devices to resolve.
    kind = (torch.device(device).type if dist.get_backend() == "fake"
            else resolve_device(device).type)
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_local_mesh(data: int | None = None, model: int = 1, *,
                    device="cuda"):
    """A ``(data, model)`` ``DeviceMesh`` named ``("data", "model")`` over
    the world's ranks, on ``device``'s type.

    ``data=None`` takes every rank not on the model axis.  Without a
    process group, a world of one (``WORLD_SIZE`` unset or 1) gets a
    single-process group on a ``HashStore``: NCCL on the card, gloo on
    the CPU.  A larger world must create its group first.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # the card this rank's mesh uses
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != 1:
            raise RuntimeError(
                f"WORLD_SIZE={world}: create the process group of the "
                f"world (torch.distributed.init_process_group) before "
                f"make_local_mesh")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return init_device_mesh(dev.type, (int(data), int(model)),
                            mesh_dim_names=("data", "model"))
