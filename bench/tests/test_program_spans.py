"""The readers of the program's own spans, on synthetic spans and a
synthetic trace: the clock mapping, each metric's value, ``None`` where
there is nothing to read, and the idle parts adding up to the device's
idle share."""

import dataclasses
import sys
import types

import numpy as np
import pytest

import repro_torch
from bench.harness import program_spans, registry
from bench.harness.trace import Trace
from repro_torch.spans import Gauge, Snapshot, Span

NEW = ("ingest_copy_host_ms", "ingest_work_host_ms", "fold_launch_host_us",
       "idle_copy_pct", "idle_outside_pct", "pending_depth_mean")
OFF = 4321.5          # perf_counter at the trace's 0
LAG = 5e-6            # frontdoor.submit opens this much inside bench.submit
W0 = 1_000_000.0      # the window's start on the profiler's clock (us)

# Device busy [0, .2], [.3, .6], [.7, .95] of a 1 s window: idle .25 s.
BUSY = ((0.0, 0.2), (0.3, 0.6), (0.7, 0.95))
BENCH_SUBMITS = ((0.15, 0.35), (0.55, 0.75), (0.80, 0.85))


def _events(busy=BUSY, submits=BENCH_SUBMITS, window=1.0):
    def x(name, cat, a, b):
        return {"ph": "X", "cat": cat, "name": name, "ts": W0 + 1e6 * a,
                "dur": 1e6 * (b - a)}

    return ([x("bench.window", "user_annotation", 0.0, window)]
            + [x("bench.submit", "user_annotation", a, b) for a, b in submits]
            + [x("kernel_k", "kernel", a, b) for a, b in busy])


def _span(i, name, a, b, parent=None, **attrs):
    """A span at ``a`` to ``b`` on the trace's clock."""
    return Span(i, name, OFF + LAG + a, OFF + LAG + b, parent, 0, None,
                attrs)


def _spans(stray=0.0):
    return [
        _span(1, "frontdoor.submit", 0.15, 0.34),
        _span(2, "engine.submit", 0.16, 0.33, 1, views=31),
        _span(3, "engine.copy.views", 0.17, 0.25, 2, bytes=10, blocks=True),
        _span(4, "engine.fold", 0.26, 0.32, 2, views=4),
        _span(5, "frontdoor.submit", 0.55 + stray, 0.74),
        _span(6, "engine.submit", 0.56, 0.73, 5, views=31),
        _span(7, "engine.copy.matrices", 0.58, 0.65, 6, bytes=9,
              blocks=True),
        _span(8, "engine.filter", 0.66, 0.72, 6),
        _span(9, "frontdoor.submit", 0.80, 0.84),   # a pending ticket's
    ]


REAL_SNAPSHOT = program_spans._snapshot
GAUGES = [Gauge("frontdoor.pending", OFF + LAG + t, v)
          for t, v in ((0.0, 0.0), (0.1, 1.0), (0.5, 0.0))]


def _ctx(trace_events=None, bench_s=0.5):
    return types.SimpleNamespace(
        t0=OFF, folds=4, scans_folded=4 / 496,
        spans=types.SimpleNamespace(seconds={"submit": bench_s}),
        trace=Trace(trace_events or _events()))


def _read(name, ctx):
    return registry.reader(name).read(ctx)


@pytest.fixture
def recorded(monkeypatch):
    """Point the readers at a snapshot the test sets."""
    box = {"snap": Snapshot(_spans(), GAUGES, 0)}
    monkeypatch.setattr(program_spans, "_snapshot", lambda: box["snap"])
    return box


def test_the_mapping_recovers_a_known_offset():
    trace = Trace(_events())
    assert program_spans.offset(_spans(), trace) == pytest.approx(
        OFF + LAG, abs=1e-9)
    # One pair of three 0.2 ms off is more than 1 % of them; so is a
    # count that differs.
    assert program_spans.offset(_spans(2e-4), trace) is None
    assert program_spans.offset(_spans()[:4], trace) is None


def test_the_mapping_outlasts_one_stray_pair_in_a_hundred():
    n = 200
    submits = [(0.004 * i, 0.004 * i + 0.002) for i in range(n)]
    spans = [_span(i + 1, "frontdoor.submit", a, b)
             for i, (a, b) in enumerate(submits)]
    trace = Trace(_events(busy=(), submits=submits))
    for k in (1, 2):
        spans[7 * k] = dataclasses.replace(spans[7 * k],
                                           start=spans[7 * k].start + 2e-4)
    assert program_spans.offset(spans, trace) == pytest.approx(
        OFF + LAG, abs=1e-9)
    spans[50] = dataclasses.replace(spans[50], start=spans[50].start + 2e-4)
    assert program_spans.offset(spans, trace) is None
    # Off by one submit: every pair strays.
    assert program_spans.offset(spans[1:] + [_span(
        999, "frontdoor.submit", 0.9, 0.901)], trace) is None


def test_each_reader_gives_its_value(recorded):
    ctx = _ctx()
    got = {n: _read(n, ctx) for n in NEW}
    assert got == pytest.approx({
        "ingest_copy_host_ms": 1e3 * (0.08 + 0.07) / 62,
        "ingest_work_host_ms": 1e3 * ((0.17 - 0.08 - 0.06)
                                      + (0.17 - 0.07)) / 62,
        "fold_launch_host_us": 0.06e6,
        "idle_copy_pct": 10.0,        # .20-.25 and .60-.65
        "idle_outside_pct": 5.0,      # .95-1.0
        "pending_depth_mean": 0.4,    # 1 over .1-.5 of 1 s
    })
    idle = program_spans.load(ctx).idle
    assert idle["other"] == pytest.approx(0.10)
    assert idle["by_name"] == pytest.approx({
        "frontdoor.submit": 0.0, "engine.submit": 0.02,
        "engine.copy.views": 0.05, "engine.fold": 0.04,
        "engine.copy.matrices": 0.05, "engine.filter": 0.04})


@pytest.mark.parametrize("why", ["no module", "nothing recorded", "dropped",
                                 "none in the window"])
@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_where_nothing_was_kept(recorded,
                                                          monkeypatch, why,
                                                          name):
    if why == "no module":
        monkeypatch.setattr(program_spans, "_snapshot", REAL_SNAPSHOT)
        monkeypatch.delattr(repro_torch, "spans", raising=False)
        monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    elif why == "nothing recorded":
        recorded["snap"] = Snapshot([], [], 0)
    elif why == "dropped":
        recorded["snap"] = Snapshot(_spans(), GAUGES, 1)
    else:
        recorded["snap"] = Snapshot(   # an earlier window's spans
            [dataclasses.replace(s, start=s.start - 10, end=s.end - 10)
             for s in _spans()], [], 0)
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("seed", range(4))
def test_the_idle_parts_add_up_to_the_devices_idle_share(recorded, seed):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0, 1, 40))
    busy = list(zip(edges[::2], edges[1::2]))
    # Nested program spans: roots in turn, each with children in turn.
    spans, submits, i = [], [], 0
    t = 0.0
    while t < 0.9:
        a = t + rng.uniform(0.001, 0.02)
        b = min(a + rng.uniform(0.01, 0.08), 0.99)
        submits.append((a, b))
        i += 1
        root = i
        spans.append(_span(root, "frontdoor.submit", a, b))
        c = a
        while c < b - 0.004:
            d = min(c + rng.uniform(0.001, 0.01), b)
            i += 1
            name = ("engine.copy.views", "engine.fold",
                    "engine.filter")[i % 3]
            spans.append(_span(i, name, c, d, root, blocks=True))
            c = d + rng.uniform(0, 0.003)
        t = b
    recorded["snap"] = Snapshot(spans, [], 0)
    ctx = _ctx(_events(busy, submits))
    idle = _read("device_idle_pct", ctx)
    parts = (_read("idle_copy_pct", ctx) + _read("idle_outside_pct", ctx)
             + 100 * program_spans.load(ctx).idle["other"]
             / ctx.trace.window_s)
    assert 0 < _read("idle_copy_pct", ctx) < idle
    assert parts == pytest.approx(idle, abs=0.01)
