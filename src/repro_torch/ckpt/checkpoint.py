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
from torch import nn

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
    return t.detach().to("cpu", copy=True).contiguous()


def _host_tree(tree):
    """A copy of ``tree`` on the host, modules as dicts of parameters."""
    if torch.is_tensor(tree):
        return _host(tree)
    return {key: _host_tree(child) for key, child in _items(tree)}


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3):
    """Atomic synchronous save of ``tree`` at ``step``; returns the step's
    directory."""
    leaves = _flatten(tree)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": [p for p, _ in leaves],
                "n_leaves": len(leaves), "leaves": []}
    for i, (_, leaf) in enumerate(leaves):
        arr = _host(leaf)
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
    return final


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
    of the tree on the device.  Returns ``(tree, step)``."""
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
        if not in_place:
            out[path] = arr.to(leaf.device if device is None else device)
            continue
        if arr.dtype != leaf.dtype or arr.shape != leaf.shape:
            raise ValueError(f"{path}: the checkpoint holds {arr.dtype} "
                             f"{tuple(arr.shape)}, the template "
                             f"{leaf.dtype} {tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(arr)
        out[path] = leaf
    return _unflatten(tree_like, out), step


class CheckpointManager:
    """Async checkpointing with at most one write in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree):
        """Copy ``tree`` to the host now; write it on a daemon thread."""
        self.wait()                     # at most one write in flight
        host_tree = _host_tree(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                keep=self.keep)
            except Exception as e:      # noqa: BLE001 - re-raised by wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> int | None:
        steps = all_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, tree_like, *, in_place: bool = False):
        return load_checkpoint(self.directory, tree_like, in_place=in_place)
