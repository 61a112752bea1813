"""Fault tolerance (counterpart of ``repro.ft``): restartable loops,
preemption simulation, stragglers."""

from .manager import (FaultTolerantLoop, Preempted,  # noqa: F401
                      PreemptionSimulator, run_with_restarts)
