"""The device's side of a traced run, read from the profiler's trace.

The window runs under ``torch.profiler`` (host and CUDA activity), its
whole length inside one ``bench.window`` annotation and each call into
the front door inside a ``bench.<call>`` annotation.  The trace is
exported to a file in ``TMPDIR``, read back here and deleted: device
operations (kernels, copies, sets), the benchmark's spans and the host
operations, on one clock.  A device operation launched inside one of
the benchmark's own spans (``bench.sample``: the samples the check
reads) is named ``bench.<span>: <name>``, so that no layer of the
program counts it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The benchmark's spans whose device work is its own, not the program's.
OWN_SPANS = ("bench.sample",)
_NAME_CHARS = 96


def short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list (and the benchmark's span before it, if any)."""
    if name.startswith("bench.") and ": " in name:
        who, rest = name.split(": ", 1)
        return f"{who}: {short(rest)}"[:_NAME_CHARS]
    base = name.split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:_NAME_CHARS] or name[:_NAME_CHARS]


class Trace:
    """Device intervals and host spans of one window, in seconds from the
    window's start."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == "bench.window"
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} bench.window spans")
        t0, self.window_s = float(win[0]["ts"]), float(win[0]["dur"]) / 1e6
        end = self.window_s

        def span(e):
            a = (float(e["ts"]) - t0) / 1e6
            return max(a, 0.0), min(a + float(e.get("dur", 0)) / 1e6, end)

        own = _own_launches(events)
        self.device, self.spans, self.host = [], [], []
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            cat = e.get("cat", "")
            if cat in _DEVICE_CATS:
                a, b = span(e)
                name = e["name"]
                who = own.get(_correlation(e))
                if who is not None:
                    name = f"{who}: {name}"
                if b > a:
                    self.device.append((a, b, name))
            elif cat == "user_annotation" and e["name"].startswith("bench.") \
                    and e["name"] != "bench.window":
                a, b = span(e)
                self.spans.append((a, b, e["name"][6:]))
            elif cat == "cpu_op":
                a, b = span(e)
                self.host.append((a, b, e["name"]))
        self.device.sort()
        self.spans.sort()
        self.host.sort()

    @staticmethod
    def own(name: str) -> bool:
        """Is the device operation ``name`` the benchmark's own work?"""
        return name.startswith("bench.")

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's intervals."""
        out: list[list[float]] = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list[tuple[float, float]]:
        """The window's stretches with nothing on the device."""
        out, t = [], 0.0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def device_s(self, match=None) -> float:
        """Device seconds of the operations whose name ``match`` accepts
        (all of them without one)."""
        return sum(b - a for a, b, n in self.device
                   if match is None or match(n))

    def by_name(self) -> list[tuple[str, float]]:
        tot: dict[str, float] = {}
        for a, b, n in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def _open_at(self, spans: list, t: float) -> str | None:
        """The innermost span of ``spans`` (sorted) open at ``t``."""
        i = bisect.bisect_right(spans, (t, float("inf"), ""))
        best = None
        for a, b, n in reversed(spans[max(0, i - 256):i]):
            if a <= t < b and (best is None or a > best[0]):
                best = (a, n)
        return None if best is None else best[1]

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t`` (a gap's midpoint): the
        benchmark's span and the innermost host operation open then."""
        span = self._open_at(self.spans, t) or "event loop"
        op = self._open_at(self.host, t)
        return span if op is None else f"{span}: {op}"

    def breakdown(self, top: int = 10) -> dict:
        ops = [[short(n), s] for n, s in self.by_name()[:top]]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": ops,
                "idle_gaps": [[self.host_at((a + b) / 2), b - a]
                              for a, b in gaps]}


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _own_launches(events: list) -> dict:
    """``{correlation id: span name}`` of the launches the host made
    inside one of :data:`OWN_SPANS` (on the same thread)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("tid"), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("name") in OWN_SPANS
                   and e.get("cat") == "user_annotation")
    if not spans:
        return {}
    starts = [a for a, _, _, _ in spans]
    out = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _LAUNCH_CATS:
            continue
        cid, t = _correlation(e), float(e["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if cid is not None and i >= 0:
            a, b, tid, name = spans[i]
            if t < b and tid == e.get("tid"):
                out[cid] = name
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the body when ``enabled``; yields a holder whose
    ``trace`` is the :class:`Trace` once the body has ended."""
    holder = type("Held", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    holder.read_from = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.trace = Trace(events)
