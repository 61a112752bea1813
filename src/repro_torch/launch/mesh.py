"""Local mesh construction on ``torch.distributed``.

The port's counterpart of ``repro.launch.mesh.make_local_mesh``.  A
function, not a module-level constant: importing this module creates no
process group.

The port runs SPMD: a world of processes, one per rank, each calling the
same code.  A launcher of several ranks creates the default process
group first (``torch.distributed.init_process_group`` with its store,
rank and world size); :func:`make_local_mesh` then lays that world out
as a ``("data", "model")`` mesh.  A single process needs no launcher:
with no process group and a world of one it creates one on a
``HashStore``, so a 1x1 mesh is a plain function call.

(``make_production_mesh``, the 16x16 pod and the 2-pod mesh, waits for
its only users, the dry-run and training launchers.)
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["make_local_mesh"]


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
