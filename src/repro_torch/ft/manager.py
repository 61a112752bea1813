"""Fault-tolerant training loop, counterpart of ``repro/ft/manager.py``:
checkpoint and restart, preemption, stragglers.

* **Checkpoint/restart**: the loop saves the state (parameters,
  optimizer state, step) through :class:`repro_torch.ckpt.CheckpointManager`
  and resumes bit-exactly: the data is addressed by step
  (:mod:`repro_torch.data.tokens`), so the step is the only data state.
* **Preemption**: an optional ``health`` callback per step; a
  preemption (:class:`PreemptionSimulator` in drills) takes a final
  synchronous checkpoint and raises :class:`Preempted`, which
  :func:`run_with_restarts` turns into a resume.
* **Stragglers**: a step whose wall time exceeds ``straggler_factor``
  times the median of the last 20 is counted and passed to
  ``on_straggler``.

The reference restores into zeros shaped by ``jax.eval_shape(init_fn)``;
the port calls ``init_fn`` once for the template (its structure,
shapes, dtypes and devices) and loads the checkpoint into it in place,
a leaf at a time from the host.  :func:`run_with_restarts` drops the
preempted state before it builds that template, so a restart holds one
copy of the state on the device, as a fresh start does.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

from ..ckpt import CheckpointManager

__all__ = ["Preempted", "PreemptionSimulator", "FaultTolerantLoop",
           "run_with_restarts"]


class Preempted(Exception):
    """Raised inside the loop when the environment signals preemption."""


class PreemptionSimulator:
    """Deterministic preemption injector for tests and drills."""

    def __init__(self, at_steps: set[int]):
        self.at_steps = set(at_steps)

    def __call__(self, step: int) -> bool:
        return step in self.at_steps


class FaultTolerantLoop:
    def __init__(self, ckpt_dir: str, *, save_every: int = 50,
                 keep: int = 3, straggler_factor: float = 3.0,
                 health: Callable[[int], bool] | None = None,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.save_every = save_every
        self.health = health or (lambda step: False)
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler or (lambda step, t: None)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []

    # ------------------------------------------------------------------
    def restore_or_init(self, init_fn):
        """``(state, start_step)``: the latest checkpoint, restored in
        place into a fresh ``init_fn()`` (each leaf where it puts it), or
        that init."""
        latest = self.mgr.latest_step()
        if latest is None:
            return init_fn(), 0
        state, step = self.mgr.restore(init_fn(), in_place=True)
        return state, step + 1

    def run(self, state, start_step: int, n_steps: int, step_fn,
            log_every: int = 10, metrics_cb=None):
        """Run ``step_fn(state, step) -> (state, metrics)`` with FT."""
        step = start_step
        try:
            while step < n_steps:
                if self.health(step):
                    raise Preempted(f"preempted at step {step}")
                t0 = time.perf_counter()
                state, metrics = step_fn(state, step)
                dt = time.perf_counter() - t0
                self._track_straggler(step, dt)
                if metrics_cb and step % log_every == 0:
                    metrics_cb(step, metrics, dt)
                if self.save_every and step % self.save_every == 0 \
                        and step > start_step:
                    self.mgr.save_async(step, state)
                step += 1
        except Preempted:
            # Final synchronous checkpoint on the way down.
            self.mgr.wait()
            self.mgr.save_async(step - 1 if step > start_step else step,
                                state)
            self.mgr.wait()
            raise
        self.mgr.wait()
        return state, step

    # ------------------------------------------------------------------
    def _track_straggler(self, step: int, dt: float):
        if len(self.step_times) >= 5:
            med = statistics.median(self.step_times[-20:])
            if dt > self.straggler_factor * med:
                self.stragglers.append(step)
                self.on_straggler(step, dt)
        self.step_times.append(dt)


def run_with_restarts(make_loop, init_fn, step_fn, n_steps: int,
                      max_restarts: int = 10):
    """Restart on preemption until done: ``(state, step, restarts)``.
    Each (re)start builds its loop with ``make_loop()``."""
    restarts = 0
    while True:
        loop = make_loop()
        state, start = loop.restore_or_init(init_fn)
        try:
            state, step = loop.run(state, start, n_steps, step_fn)
            return state, step, restarts
        except Preempted:
            restarts += 1
            if restarts > max_restarts:
                raise
        state = None        # freed before the restore builds its template
