"""Execution-plan dispatch (counterpart of ``repro.dispatch``).

One frozen :class:`ExecutionPlan` per resolved configuration, one
:class:`Dispatcher` that maps ``strategy="auto"`` to a plan (cache hit,
in-situ first-call selection, or a logged ``strip2`` fallback), so no
entry point carries its own resolution logic.
"""

from .dispatcher import (Dispatcher, get_dispatcher, insitu_candidates,
                         reset_dispatcher, set_dispatcher)
from .plan import ExecutionPlan

__all__ = ["ExecutionPlan", "Dispatcher", "insitu_candidates",
           "get_dispatcher", "set_dispatcher", "reset_dispatcher"]
