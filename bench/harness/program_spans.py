"""The program's own spans and gauges (``repro_torch.spans``), read after
a traced window and put on the trace's clock.

The program records them only while the profiler records, so a traced
run's window holds them; they are read through ``spans.snapshot()`` in
the same process.  A program without the module (an older commit), a
window that recorded nothing, or a buffer that dropped spans gives
``None``, and every metric that reads them then finds nothing.

The device's idle stretches (``Trace.gaps()``) are in seconds from the
window's start on the profiler's clock; the spans are on
``time.perf_counter()``.  The i-th ``frontdoor.submit`` span opens a few
microseconds inside the benchmark's i-th ``bench.submit`` span: the
median of those offsets maps one clock onto the other.  A count that
differs, or fewer than :data:`SHARE` of the pairs within
:data:`RESIDUAL_S` of the median, leaves the mapping, and the metrics
that need it, undefined: a pairing off by one submit moves every pair
by milliseconds, while a pause of the host between the two readings
moves one pair in thousands.  Each span's idle time is the device's
idle time inside its own stretch, less its children's (its self time),
so the parts add up to the window's idle time exactly.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
import statistics
import sys

RESIDUAL_S = 1e-4
SHARE = 0.99
TOP = 10


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def blocking_copy(s) -> bool:
    """A copy to the card that holds the host until it is done."""
    return s.name.startswith("engine.copy.") and bool(s.attrs.get("blocks"))


@dataclasses.dataclass
class Program:
    """What the metrics read of one traced window's spans."""

    views: int                  # views the engine took in (``engine.submit``)
    copy_s: float               # host seconds in blocking copies
    work_s: float               # ``engine.submit`` outside copies and folds
    fold_s: float               # host seconds in ``engine.fold``
    launches: int               # ``engine.fold`` spans
    offset: float | None        # perf_counter minus the trace's clock
    idle: dict | None           # seconds: copy, outside, other, by_name
    pending_mean: float | None  # ``frontdoor.pending``, time-weighted


def load(ctx) -> Program | None:
    """The window's :class:`Program`, worked out once per context."""
    if not hasattr(ctx, "_program"):
        ctx._program = _load(ctx)
    return ctx._program


def _snapshot():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.snapshot()


def _load(ctx) -> Program | None:
    snap = _snapshot()
    if snap is None:
        _log("program spans: the program records none")
        return None
    if snap.dropped:
        _log(f"program spans: {snap.dropped} dropped; not read")
        return None
    spans = [s for s in snap.spans if s.start >= ctx.t0]
    gauges = [g for g in snap.gauges if g.t >= ctx.t0]
    if not spans:
        _log("program spans: none recorded in the window")
        return None
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    def below(s):
        for c in kids.get(s.id, ()):
            yield c
            yield from below(c)

    submits = [s for s in spans if s.name == "engine.submit"]
    folds = [s for s in spans if s.name == "engine.fold"]
    copy_s = sum(s.seconds for s in spans if blocking_copy(s))
    work_s = sum(s.seconds - sum(c.seconds for c in below(s) if
                                 blocking_copy(c) or c.name == "engine.fold")
                 for s in submits)
    p = Program(views=sum(s.attrs.get("views", 0) for s in submits),
                copy_s=copy_s, work_s=work_s,
                fold_s=sum(s.seconds for s in folds), launches=len(folds),
                offset=None, idle=None, pending_mean=None)
    per = len(spans) / ctx.scans_folded if ctx.folds else float("nan")
    _log(f"program spans: {len(spans)} spans ({per:.2f} a scan folded), "
         f"{len(gauges)} gauge samples; "
         f"{p.views} views taken in, {p.launches} fold launches; host s: "
         f"copies {p.copy_s:.6f}, other submit work {p.work_s:.6f}, "
         f"folds {p.fold_s:.6f}")
    for name, n, sec, moved in _by_name(spans):
        _log(f"program span {name}: {n} spans, {sec:.6f} host s, "
             f"{1e6 * sec / n:.3f} us each"
             + (f", {moved} bytes to the card" if moved else ""))
    bench_s = sum(ctx.spans.seconds.get(k, 0.0)
                  for k in ("open_scan", "submit", "result"))
    if bench_s > 0:
        _log(f"program spans: copies, submit work and folds "
             f"{p.copy_s + p.work_s + p.fold_s:.6f} s of the benchmark's "
             f"open_scan, submit and result spans' {bench_s:.6f} s "
             f"({(p.copy_s + p.work_s + p.fold_s) / bench_s:.4f})")
    if ctx.trace is None:
        return p
    p.offset = offset(spans, ctx.trace)
    if p.offset is None:
        return p
    p.idle = idle_split(spans, ctx.trace.gaps(), p.offset)
    w = ctx.trace.window_s
    idle = sum(b - a for a, b in ctx.trace.gaps())
    i = p.idle
    _log(f"idle by program span (s, % of the {w:.6f} s window): device idle "
         f"{idle:.6f} ({100 * idle / w:.4f} %) = blocking copies "
         f"{i['copy']:.6f} ({100 * i['copy'] / w:.4f} %) + outside every "
         f"program span {i['outside']:.6f} ({100 * i['outside'] / w:.4f} %) "
         f"+ in the program's other spans {i['other']:.6f} "
         f"({100 * i['other'] / w:.4f} %)")
    for name, s in sorted(i["by_name"].items(), key=lambda kv: -kv[1])[:TOP]:
        _log(f"idle in program span {name}: {s:.6f} s "
             f"({100 * s / w:.4f} %)")
    p.pending_mean = time_mean(
        [g for g in gauges if g.name == "frontdoor.pending"],
        p.offset, p.offset + w)
    return p


def _by_name(spans) -> list:
    """``(name, spans, host seconds, bytes)`` for each span name."""
    out: dict = {}
    for s in spans:
        n, sec, moved = out.get(s.name, (0, 0.0, 0))
        out[s.name] = (n + 1, sec + s.seconds, moved + s.attrs.get("bytes", 0))
    return sorted(((k, *v) for k, v in out.items()), key=lambda r: -r[2])


def offset(spans, trace) -> float | None:
    """``perf_counter`` minus the trace's clock, from the window's
    submits (see the module's docstring), or ``None``."""
    ours = sorted(s.start for s in spans if s.name == "frontdoor.submit")
    theirs = sorted(a for a, _, n in trace.spans if n == "submit")
    if not ours or len(ours) != len(theirs):
        _log(f"program spans: {len(ours)} frontdoor.submit spans against "
             f"{len(theirs)} of the benchmark's; no clock mapping")
        return None
    offs = [a - b for a, b in zip(ours, theirs)]
    off = statistics.median(offs)
    resid = sorted(abs(o - off) for o in offs)
    worst = resid[math.ceil(SHARE * len(resid)) - 1]
    stray = sum(r > RESIDUAL_S for r in resid)
    _log(f"program spans: clock mapping from {len(offs)} submit pairs, "
         f"offset {off:.9f} s; p{100 * SHARE:g} residual "
         f"{1e3 * worst:.6f} ms (the mapping holds where it is within "
         f"{1e3 * RESIDUAL_S:g} ms), largest residual "
         f"{1e3 * resid[-1]:.6f} ms, {stray} pairs over "
         f"{1e3 * RESIDUAL_S:g} ms; the first and last tenth's offsets "
         f"differ by {1e3 * _drift(offs):.6f} ms")
    return off if worst <= RESIDUAL_S else None


def _drift(offs: list) -> float:
    k = max(1, len(offs) // 10)
    return statistics.median(offs[-k:]) - statistics.median(offs[:k])


class _Gaps:
    """Idle seconds inside any stretch, from sorted, disjoint gaps."""

    def __init__(self, gaps):
        self.starts = [a for a, _ in gaps]
        self.ends = [b for _, b in gaps]
        self.cum = [0.0, *itertools.accumulate(b - a for a, b in gaps)]

    def within(self, a: float, b: float) -> float:
        if b <= a:
            return 0.0
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))


def idle_split(spans, gaps, off: float) -> dict:
    """The idle seconds of ``gaps`` (trace clock) by where the host was:
    in a blocking copy, outside every span, or in another span; and by
    the innermost span's name."""
    g = _Gaps(gaps)
    ids = {s.id for s in spans}
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent if s.parent in ids else None, []).append(s)
    out = {"copy": 0.0, "other": 0.0, "by_name": {}}
    for s in spans:
        a, b = s.start - off, s.end - off
        own = g.within(a, b) - sum(
            g.within(max(c.start - off, a), min(c.end - off, b))
            for c in kids.get(s.id, ()))
        out["copy" if blocking_copy(s) else "other"] += own
        out["by_name"][s.name] = out["by_name"].get(s.name, 0.0) + own
    inside = sum(g.within(s.start - off, s.end - off)
                 for s in kids.get(None, ()))
    out["outside"] = g.cum[-1] - inside
    return out


def time_mean(samples, t0: float, t1: float) -> float | None:
    """The time-weighted mean over ``[t0, t1]`` of a gauge's samples,
    each holding until the next, from the last sample at or before
    ``t0`` (or the first after it)."""
    samples = sorted(samples, key=lambda g: g.t)
    if not samples:
        return None
    i = max(bisect.bisect_right([g.t for g in samples], t0) - 1, 0)
    start = max(samples[i].t, t0)
    if t1 <= start:
        return None
    total = 0.0
    for cur, nxt in zip(samples[i:], [*samples[i + 1:], None]):
        a = max(cur.t, t0)
        b = t1 if nxt is None else min(nxt.t, t1)
        if b > a:
            total += cur.value * (b - a)
    return total / (t1 - start)
