"""The program's own spans and gauges, recorded while a profiler records.

A span is a named stretch of host time on ``time.perf_counter()``: its
parent span, the scan it serves (the engine's ``sid``; on the front
door's spans the ticket's ``tid`` too) and a few counts as attributes.
A gauge is a time-stamped sample of a named value.  Both are recorded
only while a ``torch.profiler`` profile records on the calling thread
(``torch.autograd._profiler_enabled()``): an operator who profiles, or
the benchmark's traced run.  Each span is then also a profiler record
function of the same name (what ``torch.profiler.record_function``
enters, without its dispatch through an operator), so the exported
timeline shows it as a ``user_annotation`` beside the kernels.
Otherwise a span site costs one check and gets a shared no-op context
(which is falsy, so a site computes its attributes only under
``if sp:``).

Spans and gauges are kept in memory, in one bounded buffer per process
(:data:`CAPACITY` entries; what does not fit is counted in ``dropped``).
:func:`snapshot` copies it out and :func:`clear` empties it; nothing is
written to a file.  A span encloses no ``await``: spans of one thread
nest, and the front door's spans cover the synchronous part of a call.

This is run-time tracing; :mod:`repro_torch.analysis.trace` is the dry
run's op census and is unrelated.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import torch

__all__ = ["CAPACITY", "Gauge", "Snapshot", "Span", "clear", "gauge",
           "snapshot", "span"]

CAPACITY = 1_000_000

_recording = torch.autograd._profiler_enabled
_rf_enter = torch.autograd._record_function_with_args_enter
_rf_exit = torch.autograd._record_function_with_args_exit


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span; ``parent`` is the enclosing span's ``id``."""

    id: int
    name: str
    start: float
    end: float
    parent: int | None
    sid: int | None
    tid: int | None
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class Gauge:
    name: str
    t: float
    value: float


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """The buffer's spans (in order of start) and gauges (in order of
    time), and how many of either did not fit."""

    spans: list
    gauges: list
    dropped: int


class _NoSpan:
    """The shared context of a span site while nothing records."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()

# The buffer holds flat tuples of numbers and strings (a span's attributes
# as key, value, key, ...), which the garbage collector stops tracking: a
# window's tens of thousands of spans add nothing to a collection's pause.
# A dict inside a tuple would keep it tracked.
_spans: list[tuple] = []
_gauges: list[tuple] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


class _Open:
    """A span being recorded; ``attrs`` may be added to until it ends."""

    __slots__ = ("name", "sid", "tid", "attrs", "start", "id", "parent",
                 "_rf")

    def __init__(self, name, sid, tid, attrs, start):
        self.name, self.sid, self.tid = name, sid, tid
        self.attrs, self.start = attrs, start

    def __bool__(self) -> bool:
        return True

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._rf = _rf_enter(self.name)
        return self

    def __exit__(self, *exc):
        _rf_exit(self._rf)
        _stack().pop()
        _keep(_spans, (self.id, self.name, self.start, time.perf_counter(),
                       self.parent, self.sid, self.tid,
                       *itertools.chain.from_iterable(self.attrs.items())))
        return None


def span(name: str, *, sid: int | None = None, tid: int | None = None,
         **attrs):
    """A context for the span ``name``: recorded while a profiler
    records, the shared no-op otherwise.  The span starts here, its
    clock read first and, on exit, last: its own cost lies inside it."""
    if not _recording():
        return _NO_SPAN
    return _Open(name, sid, tid, attrs, time.perf_counter())


def gauge(name: str, value: float) -> None:
    """Sample ``value`` of ``name`` now, while a profiler records."""
    if _recording():
        _keep(_gauges, (name, time.perf_counter(), float(value)))


def snapshot() -> Snapshot:
    with _lock:
        spans, gauges, dropped = list(_spans), list(_gauges), _dropped
    spans = [Span(*s[:7], dict(zip(s[7::2], s[8::2]))) for s in spans]
    spans.sort(key=lambda s: (s.start, s.id))
    return Snapshot(spans, [Gauge(*g) for g in gauges], dropped)


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _gauges.clear()
        _dropped = 0


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(into: list, entry: tuple) -> None:
    global _dropped
    with _lock:
        if len(_spans) + len(_gauges) >= CAPACITY:
            _dropped += 1
        else:
            into.append(entry)
