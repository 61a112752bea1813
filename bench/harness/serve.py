"""The measured window: clients on the program's front door.

Each client opens a scan, hands in its views, awaits the volume, and
opens its next scan, until the window's end; no scan is opened
after it, and those open then run to their end.  How a client hands in
its views follows the traffic mix:

* closed loop (no ``fps``): the scan's chunks in a seeded order, each
  as soon as the last was taken;
* paced (``fps``, one view a submit): a scanner's frames in acquisition
  order, angle index 0, 1, ..., each at ``t_open + k / fps`` on an
  absolute schedule (a view that falls behind goes at once, and the
  lateness does not add up), with client ``i`` opening its first scan
  ``i / clients`` of an acquisition into the window and each next one
  as soon as the volume is back.  ``t_open``
  is the scheduled time of a scan's first frame and ``t_last`` that of
  its last (not when they were handed in): a clinician waits from
  ``t_last`` for the volume.

A volume counts as returned when the device work that made it has
finished: a CUDA event is recorded when ``result`` returns and mapped
onto the host clock after the window, through an event recorded after
one synchronise before the window (nothing synchronises inside it).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import itertools
import time

import numpy as np
import torch

# Seconds past the window's end a scan may take before it counts as
# never returned.
GRACE_S = 60.0

# The event loop's timers wake up to a millisecond late; the last
# seconds of a wait are spent yielding to the other tasks instead.
SPIN_S = 0.002


async def until(t: float) -> None:
    """Wait until ``time.perf_counter()`` reaches ``t``, never less, and
    as little more as the other tasks on the loop allow."""
    while (wait := t - time.perf_counter()) > 0:
        await asyncio.sleep(wait - SPIN_S if wait > SPIN_S else 0)


class Clock:
    """Device completion times on the host's ``perf_counter`` clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.ref = torch.cuda.Event(enable_timing=True)
            self.ref.record()
        self.t_ref = time.perf_counter()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, mark) -> float:
        """Host time of ``mark``; call after a synchronise."""
        if self.cuda:
            return self.t_ref + self.ref.elapsed_time(mark) / 1e3
        return mark


class Spans:
    """Host seconds and calls per named span, and the profiler's
    annotation of each while a trace runs."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def timed(self, name: str, coro):
        return _Timed(self, name, coro)

    def span(self, name: str):
        """The profiler's annotation ``bench.<name>`` around the
        benchmark's own work, while a trace runs."""
        if self.annotate:
            return torch.profiler.record_function(f"bench.{name}")
        return contextlib.nullcontext()

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1


class _Timed:
    """Awaits ``coro`` and times only the part that runs before it
    first yields to the event loop: the call's own host work, not the
    other clients' turns."""

    def __init__(self, spans: Spans, name: str, coro):
        self.spans, self.name, self.coro = spans, name, coro

    def _first(self):
        t = time.perf_counter()
        try:
            if self.spans.annotate:
                with torch.profiler.record_function(f"bench.{self.name}"):
                    return self.coro.send(None)
            return self.coro.send(None)
        finally:
            self.spans.add(self.name, time.perf_counter() - t)

    def __await__(self):
        try:
            y = self._first()
        except StopIteration as stop:
            return stop.value
        while True:
            try:
                r = yield y
            except BaseException as exc:  # forwarded into the call
                try:
                    y = self.coro.throw(exc)
                except StopIteration as stop:
                    return stop.value
            else:
                try:
                    y = self.coro.send(r)
                except StopIteration as stop:
                    return stop.value


@dataclasses.dataclass
class Record:
    """One scan a client opened in the window."""

    client: int
    scan: int
    t_open: float
    ticket: object = None
    done: object = None            # the clock's mark once returned
    t_done: float | None = None
    sample: torch.Tensor | None = None
    error: str | None = None
    # Paced only (where ``t_open`` is the scheduled time of the first
    # frame): that of the last frame, not when it was handed in, and
    # each view's seconds behind its schedule.
    t_last: float | None = None
    late: list = dataclasses.field(default_factory=list)


def drive(fd, inputs, traffic: dict, seed: int, seconds: float,
          clock: Clock, spans: Spans, chunk_type) -> tuple[list, float]:
    """Run the window on ``fd``; returns the records and the window's
    start on the host clock.  ``chunk_type`` is the program's chunk
    class.  Without ``fps`` in ``traffic`` the clients run a closed
    loop; with it, each is a scanner paced at ``fps`` frames a second
    (the module's docstring), and its records carry ``t_last``.  Each
    returned volume's samples (``inputs.flat``, 4 bytes a voxel) are
    gathered on the card, under the span ``sample``, and stay there
    until the check: the memory peak holds them."""
    n_proj = inputs.scan.n_proj
    n_chunks = n_proj // traffic["chunk"]
    size = traffic["chunk"]
    if n_chunks * size != n_proj:
        raise ValueError(f"chunks of {size} do not divide a scan of "
                         f"{n_proj} views")
    fps = traffic.get("fps")
    if fps is not None and size != 1:
        raise ValueError(f"a paced scanner hands in one view a submit, "
                         f"not chunks of {size}")
    records: list[Record] = []

    async def scan(rec: Record, due, parts) -> bool:
        """Serve one scan: its views ``parts``, each handed in at its
        ``due`` time (None: at once); False where it failed, and the
        client stops."""
        records.append(rec)
        try:
            ticket = await spans.timed("open_scan", fd.open_scan(
                tenant=f"tenant-{rec.client % traffic['tenants']}",
                n_proj=n_proj))
            rec.ticket = ticket
            for when, part in zip(due, parts):
                if when is not None:
                    await until(when)
                    rec.late.append(time.perf_counter() - when)
                await spans.timed("submit", fd.submit(
                    ticket, chunk_type(*part)))
            vol = await spans.timed("result", fd.result(ticket))
        except Exception as exc:  # the scan failed; the client stops
            rec.error = f"{type(exc).__name__}: {exc}"
            return False
        rec.done = clock.mark()
        with spans.span("sample"):
            rec.sample = vol.reshape(-1).index_select(0, inputs.flat)
        # No volume is held past its samples, as in the warm-up: one held
        # into the next scan makes the allocator grow in the window.
        ticket.volume = vol = None
        return True

    async def closed(i: int, t0: float, t_end: float) -> None:
        """The scan's chunks in a seeded order, back to back."""
        rng = np.random.default_rng([seed, 1, i])
        while time.perf_counter() < t_end:
            rec = Record(client=i, scan=int(rng.integers(len(inputs.views))),
                         t_open=time.perf_counter())
            order = rng.permutation(n_chunks)
            if not await scan(rec, itertools.repeat(None),
                              (inputs.chunk(rec.scan, c, size)
                               for c in order)):
                return

    async def paced(i: int, t0: float, t_end: float) -> None:
        """A scanner's frames in acquisition order on its frame clock."""
        rng = np.random.default_rng([seed, 1, i])
        dt = 1.0 / fps
        start = t0 + i / traffic["clients"] * (n_proj - 1) * dt
        while start < t_end:
            await until(start)
            rec = Record(client=i, scan=int(rng.integers(len(inputs.views))),
                         t_open=start, t_last=start + (n_proj - 1) * dt)
            if not await scan(rec, (start + k * dt for k in range(n_proj)),
                              (inputs.frame(rec.scan, k)
                               for k in range(n_proj))):
                return
            # The next run starts when the volume is back, so the
            # scanners' phases drift into each other's frames as
            # independent rooms' do.
            start = time.perf_counter()

    async def window() -> float:
        t0 = time.perf_counter()
        t_end = t0 + seconds
        client = closed if fps is None else paced
        tasks = [asyncio.ensure_future(client(i, t0, t_end))
                 for i in range(traffic["clients"])]
        _, late = await asyncio.wait(tasks, timeout=seconds + GRACE_S)
        for task in late:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for task in tasks:
            if not task.cancelled() and task.exception() is not None:
                raise task.exception()
        return t0

    clock.start()
    t0 = asyncio.run(window())
    if clock.cuda:
        torch.cuda.synchronize(clock.device)
    for rec in records:
        if rec.done is not None:
            rec.t_done = clock.seconds(rec.done)
    return records, t0


def warm_up(fd, inputs, traffic: dict, chunk_type) -> None:
    """One scan for each of the traffic's clients, all at once, through
    the front door in the cell's chunks, each volume's samples taken as
    in the window: the allocator holds what the window's concurrency
    needs, and every kernel the window runs is loaded.  A paced mix is
    warmed up unpaced: its one-view submits have the window's shapes."""
    size = traffic["chunk"]

    async def one(i: int):
        ticket = await fd.open_scan(tenant=f"tenant-{i % traffic['tenants']}",
                                    n_proj=inputs.scan.n_proj)
        s = i % len(inputs.views)
        for c in range(inputs.scan.n_proj // size):
            await fd.submit(ticket, chunk_type(*inputs.chunk(s, c, size)))
        vol = await fd.result(ticket)
        vol.reshape(-1).index_select(0, inputs.flat)
        ticket.volume = None

    async def all_clients():
        await asyncio.gather(*(one(i) for i in range(traffic["clients"])))

    asyncio.run(all_clients())
