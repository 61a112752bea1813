"""Execution plans (counterpart of ``repro.dispatch``; the dispatcher
that resolves ``strategy="auto"`` is not ported yet)."""

from .plan import ExecutionPlan

__all__ = ["ExecutionPlan"]
