"""The program's own spans and gauges (``repro_torch.spans``) on the CT
serving path.

On the CPU: a served scan records nothing without a profiler; under
``torch.profiler`` (CPU activity) the spans nest as the calls do, count
what the engine counts, keep tickets apart, appear in the exported
timeline with the same nesting, and the buffer's bound counts what does
not fit.  This file imports neither JAX nor the reference package, so
its card tests run on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_spans.py

There, only a copy of pageable views is held to block the host until the
stream has drained; pinned views, the Parker rows' indices and the
matrices cross without waiting, and the bound on the host's lead waits
once it is reached.
"""

import asyncio
import gc
import json

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import CTFrontDoor, Geometry, ProjectionChunk
from repro_torch.core.phantom import make_dataset

G = Geometry().scaled(16, n_proj=6)
PROJS, MATS, _ = make_dataset(G, device="cpu")
# Three clients on two slots: the third ticket waits, and its chunks
# buffer in the front door until a slot frees.
CLIENTS = ((2, "a", 0), (3, "b", 1), (6, "a", 2))


async def _stream(fd, chunk, tenant, seed):
    ticket = await fd.open_scan(tenant=tenant, n_proj=G.n_proj)
    order = np.random.default_rng(seed).permutation(G.n_proj)
    for c0 in range(0, G.n_proj, chunk):
        idx = order[c0:c0 + chunk]
        await fd.submit(ticket, ProjectionChunk(PROJS[idx], MATS[idx], idx))
    return await fd.result(ticket)


def _serve():
    """A fresh front door serves the three clients; returns it."""
    fd = CTFrontDoor(G, n_slots=2, max_pending=8, policy="fair", pbatch=4,
                     device="cpu")

    async def scenario():
        await asyncio.gather(*(_stream(fd, *c) for c in CLIENTS))

    asyncio.run(scenario())
    return fd


def _profiled():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fd = _serve()
    return fd, prof


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One profiled run: its front door, snapshot and chrome trace."""
    spans.clear()
    fd, prof = _profiled()
    snap = spans.snapshot()
    spans.clear()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return fd, snap, events


def _by_id(snap):
    return {s.id: s for s in snap.spans}


def _ancestors(s, by_id):
    while s.parent is not None:
        s = by_id[s.parent]
        yield s


def test_without_a_profiler_nothing_is_recorded():
    spans.clear()
    fd = _serve()
    snap = spans.snapshot()
    assert fd.stats["completed"] == len(CLIENTS)
    assert snap.spans == [] and snap.gauges == [] and snap.dropped == 0


def test_every_fold_has_a_step_ancestor(served):
    _, snap, _ = served
    by_id = _by_id(snap)
    folds = [s for s in snap.spans if s.name == "engine.fold"]
    assert folds
    for f in folds:
        assert "engine.step" in {a.name for a in _ancestors(f, by_id)}
        assert f.attrs["views"] > 0 and f.attrs["wire"] == "float32"


def test_fold_spans_count_the_launches(served):
    fd, snap, _ = served
    folds = [s for s in snap.spans if s.name == "engine.fold"]
    assert len(folds) == fd._backend.engine.stats["fold_launches"]
    assert sum(f.attrs["views"] for f in folds) == len(CLIENTS) * G.n_proj


def test_submit_spans_count_every_view_buffered_ones_too(served):
    _, snap, _ = served
    by_id = _by_id(snap)
    submits = [s for s in snap.spans if s.name == "engine.submit"]
    assert sum(s.attrs["views"] for s in submits) == len(CLIENTS) * G.n_proj
    # The waiting ticket's buffered chunks reach the engine at admission.
    admits = [s for s in snap.spans if s.name == "frontdoor.admit"]
    assert sum(a.attrs["views"] for a in admits) > 0
    assert any(a.name == "frontdoor.admit"
               for s in submits for a in _ancestors(s, by_id))


def _ticket(s, tid_of_sid):
    if s.tid is not None:
        return s.tid
    return tid_of_sid.get(s.sid)


def test_spans_of_different_tickets_overlap_only_nested(served):
    _, snap, _ = served
    tid_of_sid = {s.sid: s.tid for s in snap.spans
                  if s.sid is not None and s.tid is not None}
    owned = [(s, _ticket(s, tid_of_sid)) for s in snap.spans]
    owned = [(s, t) for s, t in owned if t is not None]
    assert len({t for _, t in owned}) == len(CLIENTS)
    for i, (a, ta) in enumerate(owned):
        for b, tb in owned[i + 1:]:
            if ta == tb or a.end <= b.start or b.end <= a.start:
                continue
            inner, outer = (a, b) if a.start >= b.start else (b, a)
            assert outer.start <= inner.start and inner.end <= outer.end


def test_every_span_is_a_user_annotation_with_the_same_nesting(served):
    _, snap, events = served
    names = {s.name for s in snap.spans}
    ann = sorted((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in names)
    assert len(ann) == len(snap.spans)
    # The i-th span of a name is the i-th annotation of that name.
    seen: dict = {}
    pair = {}
    for ts, neg, name in ann:
        k = seen.get(name, 0)
        seen[name] = k + 1
        pair[(name, k)] = (ts, ts - neg)
    seen = {}
    where = {}
    for s in snap.spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        where[s.id] = pair[(s.name, k)]
    for s in snap.spans:
        a, b = where[s.id]
        around = [(x, y, o.id) for o in snap.spans if o.id != s.id
                  for x, y in [where[o.id]] if x <= a and b <= y]
        innermost = max(around, default=None, key=lambda t: (t[0], -t[1]))
        assert (innermost[2] if innermost else None) == s.parent, s.name


def test_gauges_follow_the_queues(served):
    _, snap, _ = served
    assert {g.name for g in snap.gauges} == {"frontdoor.pending"}
    pending = [g.value for g in snap.gauges]
    # Each open adds a ticket, each admission takes one.
    assert len(pending) == 2 * len(CLIENTS)
    assert max(pending) >= 1 and pending[-1] == 0
    times = [g.t for g in snap.gauges]
    assert times == sorted(times)


def test_the_buffer_counts_what_does_not_fit(served, monkeypatch):
    _, snap, _ = served
    total = len(snap.spans) + len(snap.gauges)
    monkeypatch.setattr(spans, "CAPACITY", 10)
    spans.clear()
    try:
        _profiled()
        small = spans.snapshot()
    finally:
        spans.clear()
    assert len(small.spans) + len(small.gauges) == 10
    assert small.dropped == total - 10


def test_the_buffer_holds_nothing_the_collector_tracks(served):
    """A window's tens of thousands of spans add nothing to a garbage
    collection's pause: once collected, no record is tracked."""
    spans.clear()
    try:
        _profiled()
        gc.collect()
        kept = spans._spans + spans._gauges
        assert kept and not any(gc.is_tracked(e) for e in kept)
    finally:
        spans.clear()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copies are asynchronous only "
                    "on a card")
    return torch.device("cuda")


CYCLES = 200_000_000


def _sleep_seconds():
    """What ``torch.cuda._sleep(CYCLES)`` holds the stream, in seconds."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(CYCLES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def _spans_of(eng, chunks, before, monkeypatch):
    """Submit ``chunks`` (scan id, chunk), each followed by a drain as
    the front door's, under the profiler, calling ``before(name)`` as
    each span opens; the recorded spans."""
    real = spans.span

    def hooked(name, **kw):
        before(name)
        return real(name, **kw)

    torch.cuda.synchronize()
    monkeypatch.setattr(spans, "span", hooked)
    spans.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for sid, chunk in chunks:
                eng.submit(sid, chunk)
                eng.drain()
            torch.cuda.synchronize()
        return spans.snapshot().spans
    finally:
        monkeypatch.setattr(spans, "span", real)
        spans.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("copy, views", [
    ("engine.copy.views", "pinned"), ("engine.copy.views", "resident"),
    ("engine.copy.views", "pageable"), ("engine.copy.parker", "pinned"),
    ("engine.copy.matrices", "pinned")])
def test_each_copy_to_the_card_blocks_the_host(dev, copy, views,
                                               monkeypatch):
    """Work queued on the compute stream just before the copy: only a
    copy of pageable views lasts until that work is done.  Views in
    pinned memory, the Parker rows' indices and the matrices cross on
    the copy stream and do not wait; views already on the card are not
    copied.  The spans are those of the engine's second scan: its first
    copies allocate on the copy stream and load what they use, once."""
    from repro_torch.streaming import ReconstructionEngine

    sleep_s = _sleep_seconds()
    eng = ReconstructionEngine(G, n_slots=1, pbatch=4, device=dev)
    src = {"pinned": lambda v: v.pin_memory(), "resident": lambda v:
           v.to(dev), "pageable": lambda v: v.numpy()}[views](
        torch.as_tensor(PROJS, dtype=torch.float32))
    warm = eng.begin_scan()
    eng.submit(warm, ProjectionChunk(src, MATS, np.arange(G.n_proj)))
    eng.drain()
    torch.cuda.synchronize()
    eng.result(warm, pop=True)
    sid = eng.begin_scan()

    def sleep(name):
        if name == copy:
            torch.cuda._sleep(CYCLES)

    got = _spans_of(eng, [(sid, ProjectionChunk(src, MATS,
                                                np.arange(G.n_proj)))],
                    sleep, monkeypatch)
    got = [s for s in got if s.name == copy]
    assert len(got) == 1
    blocks = views == "pageable"
    assert got[0].attrs["blocks"] is blocks
    assert (got[0].attrs["bytes"] > 0) is (views != "resident")
    if blocks:
        assert got[0].seconds >= 0.8 * sleep_s, (got[0].seconds, sleep_s)
    else:
        assert got[0].seconds < 0.2 * sleep_s, (got[0].seconds, sleep_s)
    assert torch.equal(eng.result(sid), _plain_volume(dev))


def _plain_volume(dev):
    """The same scan submitted from pageable views, synchronised."""
    from repro_torch.streaming import ReconstructionEngine

    eng = ReconstructionEngine(G, n_slots=1, pbatch=4, device=dev)
    sid = eng.begin_scan()
    eng.submit(sid, ProjectionChunk(PROJS.numpy(), MATS,
                                    np.arange(G.n_proj)))
    eng.drain()
    torch.cuda.synchronize()
    return eng.result(sid)


@pytest.mark.cuda
def test_the_bound_waits_for_the_oldest_chunk(dev, monkeypatch):
    """Four chunks of 33 pinned views queued behind a sleep: the fourth
    starts 99 views in, more than INFLIGHT_VIEWS past the first chunk's
    end, so it waits once, for the first chunk's work, which the sleep
    holds; the 66 views after it stay in flight."""
    from repro_torch.core.phantom import make_dataset
    from repro_torch.streaming import ReconstructionEngine
    from repro_torch.streaming.engine import INFLIGHT_VIEWS

    g = Geometry().scaled(16, n_proj=132)
    projs, mats, _ = make_dataset(g, device="cpu")
    projs = projs.pin_memory()
    size = 33
    assert size <= INFLIGHT_VIEWS < 2 * size

    def chunks(sid):
        return [(sid, ProjectionChunk(projs[c:c + size], mats[c:c + size],
                                      np.arange(c, c + size)))
                for c in range(0, g.n_proj, size)]

    # Load every kernel first, on an engine of its own: the bound counts
    # an engine's views across its scans.
    warm = ReconstructionEngine(g, n_slots=1, pbatch=4, device=dev)
    for s, c in chunks(warm.begin_scan()):
        warm.submit(s, c)
        warm.drain()
    torch.cuda.synchronize()
    sleep_s = _sleep_seconds()
    eng = ReconstructionEngine(g, n_slots=1, pbatch=4, device=dev)
    sid = eng.begin_scan()
    first = []

    def sleep(name):
        if name == "engine.submit" and not first:
            first.append(True)
            torch.cuda._sleep(CYCLES)

    got = _spans_of(eng, chunks(sid), sleep, monkeypatch)
    waits = [s for s in got if s.name == "engine.copy.wait"]
    assert len(waits) == 1
    assert waits[0].attrs == {"bytes": 0, "blocks": True,
                              "views": 2 * size}
    assert waits[0].seconds >= 0.5 * sleep_s, (waits[0].seconds, sleep_s)
    submits = [s for s in got if s.name == "engine.submit"]
    assert waits[0].parent == submits[3].id
    assert not any(s.attrs.get("blocks") for s in got
                   if s.name.startswith("engine.copy.") and s is not waits[0])
