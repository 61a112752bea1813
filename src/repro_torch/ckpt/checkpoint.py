"""Atomic, async checkpoints, counterpart of ``repro/ckpt/checkpoint.py``,
with the reference's on-disk layout: one directory per step::

    <dir>/step_000000123/
        manifest.json       # step, the tree's paths, each leaf's shape and dtype
        arr_00000.npy ...   # one file per leaf: its raw bytes (uint8)

* **Atomicity**: a save writes ``step_X.tmp/`` and renames it into place,
  so a writer cut short never leaves a checkpoint that restore picks up.
* **Async**: :meth:`CheckpointManager.save_async` copies the tree to host
  memory at once and writes it on a daemon thread, one write in flight.
* **Retention**: the ``keep`` newest checkpoints stay; older ones go
  after a save.
* **Restore** puts each leaf on the device the caller names (by default
  the device of the matching leaf of the template), or copies it into
  the template's leaf in place.
* **Under a mesh** (leaves placed as DTensors by
  :func:`repro_torch.dist.place_params`), a save gathers each leaf to
  its full value on every rank and rank 0 writes it, then a barrier:
  the reference's layout, unsharded, whatever mesh saved it.  A restore
  keeps each rank's block of each leaf of a placed template (its
  placements), so state saved on one mesh restores on another or on one
  device (elastic restore).  Rank 0 writing is the port's choice: the
  reference's single controller writes from its one process.

A tree is nested dicts whose leaves are tensors; an ``nn.Module`` in it
stands for its named parameters.  Leaves are flattened in sorted key
order, as ``jax.tree`` flattens dicts.  bfloat16 and int8 leaves are
stored as their bytes (``.view(torch.uint8)``) with the dtype's name in
the manifest.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..dist import fsdp

__all__ = ["save_checkpoint", "load_checkpoint", "all_steps",
           "CheckpointManager"]

_MANIFEST = "manifest.json"
_DTYPES = {str(d).removeprefix("torch."): d
           for d in (torch.float32, torch.float64, torch.bfloat16,
                     torch.float16, torch.int8, torch.uint8, torch.int16,
                     torch.int32, torch.int64, torch.bool)}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def _items(node) -> list:
    """A node's ``(key, child)`` pairs in sorted key order."""
    if isinstance(node, nn.Module):
        return sorted(node.named_parameters())
    return sorted(node.items())


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``[(path, leaf)]`` of a tree, depth first in sorted key order."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _items(tree):
        out += _flatten(child, f"{prefix}/{key}" if prefix else str(key))
    return out


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaves[path]``; an
    ``nn.Module`` takes its values in place and is returned itself."""
    if torch.is_tensor(tree):
        return leaves[prefix]
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for key, p in tree.named_parameters():
                leaf = leaves[f"{prefix}/{key}" if prefix else key]
                if leaf is not p:
                    p.copy_(leaf)
        return tree
    return {key: _unflatten(child, leaves,
                            f"{prefix}/{key}" if prefix else str(key))
            for key, child in tree.items()}


def _host(t: torch.Tensor) -> torch.Tensor:
    """A leaf's full value copied to the host (a placed leaf gathered:
    every rank takes part)."""
    return fsdp.full_value(t.detach()).to("cpu", copy=True).contiguous()


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of the world, or
    the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3):
    """Atomic synchronous save of ``tree`` at ``step``; returns the step's
    directory.  Every rank of a world calls it; rank 0 writes."""
    leaves = [(path, _host(leaf)) for path, leaf in _flatten(tree)]
    if _writer():
        _write(directory, step, leaves, keep)
    _barrier()
    return _step_dir(directory, step)


def _write(directory: str, step: int, leaves: list, keep: int):
    """Write ``[(path, host tensor)]`` as step ``step``'s checkpoint."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": [p for p, _ in leaves],
                "n_leaves": len(leaves), "leaves": []}
    for i, (_, arr) in enumerate(leaves):
        raw = arr.reshape(-1).view(torch.uint8).numpy()
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), raw)
        manifest["leaves"].append(
            {"shape": list(arr.shape),
             "dtype": str(arr.dtype).removeprefix("torch.")})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    _gc(directory, keep)


def _gc(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    """The steps with a complete checkpoint under ``directory``, sorted."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name,
                                                _MANIFEST)):
            out.append(int(name.removeprefix("step_")))
    return sorted(out)


def load_checkpoint(directory: str, tree_like, *, step: int | None = None,
                    device=None, in_place: bool = False):
    """Restore into the structure of ``tree_like``: the latest step, or
    ``step``.  Each leaf lands on ``device``, or without one on the
    device of ``tree_like``'s leaf in its place; an ``nn.Module`` in
    ``tree_like`` receives its parameters' values in place.  With
    ``in_place`` every leaf of ``tree_like`` receives its values, one
    leaf at a time from the host, so that a restore holds no second copy
    of the tree on the device.  A placed leaf of ``tree_like`` takes
    this rank's block of the stored full value.  Returns ``(tree,
    step)``."""
    if in_place and device is not None:
        raise ValueError("in_place restores onto the template's devices")
    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    d = _step_dir(directory, step)
    like = _flatten(tree_like)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(like)} — structure changed?")
    if manifest["treedef"] != [p for p, _ in like]:
        raise ValueError("the checkpoint's leaves are not the template's")
    out = {}
    for i, (path, leaf) in enumerate(like):
        meta = manifest["leaves"][i]
        raw = torch.from_numpy(np.load(os.path.join(d, f"arr_{i:05d}.npy")))
        arr = raw.view(_DTYPES[meta["dtype"]]).reshape(meta["shape"])
        placed = fsdp.is_placed(leaf)
        if placed:
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{path}: the checkpoint holds "
                                 f"{tuple(arr.shape)}, the template "
                                 f"{tuple(leaf.shape)}")
            mesh, placements = leaf.device_mesh, leaf.placements
            block = fsdp.local_block(arr, mesh, placements)
        if not in_place:
            dev = leaf.device if device is None else device
            out[path] = (fsdp.like(block.contiguous().to(dev), mesh,
                                   placements, arr.shape) if placed
                         else arr.to(dev))
            continue
        if arr.dtype != leaf.dtype or arr.shape != leaf.shape:
            raise ValueError(f"{path}: the checkpoint holds {arr.dtype} "
                             f"{tuple(arr.shape)}, the template "
                             f"{leaf.dtype} {tuple(leaf.shape)}")
        with torch.no_grad():
            fsdp.local(leaf).copy_(block if placed else arr)
        out[path] = leaf
    return _unflatten(tree_like, out), step


class CheckpointManager:
    """Async checkpointing with at most one write in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._pending = False

    def save_async(self, step: int, tree):
        """Copy ``tree`` to the host now (every rank: placed leaves are
        gathered); write it on a daemon thread (rank 0)."""
        self.wait()                     # at most one write in flight
        leaves = [(path, _host(leaf)) for path, leaf in _flatten(tree)]
        self._pending = True
        if not _writer():
            return

        def work():
            try:
                _write(self.directory, step, leaves, self.keep)
            except Exception as e:      # noqa: BLE001 - re-raised by wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight (then a barrier of every rank);
        re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> int | None:
        steps = all_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, tree_like, *, in_place: bool = False):
        return load_checkpoint(self.directory, tree_like, in_place=in_place)
