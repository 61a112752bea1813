"""The bound on the host's lead over the card
(``repro_torch.streaming.engine.Inflight``), with fake events on the CPU.

Before a chunk's copies a CUDA engine waits for the newest earlier
submit whose views end more than ``INFLIGHT_VIEWS`` views before the
chunk, and only while the card has not finished it.  A fake card here
finishes its submits in order: on its own, as far as a test lets it, or
when an event of it is synchronised.  A CPU engine keeps no such state
and never waits.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import Geometry, ProjectionChunk
from repro_torch.core.phantom import make_dataset
from repro_torch.streaming import ReconstructionEngine, engine
from repro_torch.streaming.engine import INFLIGHT_VIEWS, Inflight


class _Card:
    """Submits finish in order; ``done`` of them have."""

    def __init__(self):
        self.done = 0
        self.queried: list[int] = []
        self.synced: list[int] = []


class _Event:
    def __init__(self, card: _Card, i: int):
        self.card, self.i = card, i

    def query(self) -> bool:
        self.card.queried.append(self.i)
        return self.i < self.card.done

    def synchronize(self) -> None:
        self.card.synced.append(self.i)
        self.card.done = max(self.card.done, self.i + 1)


def _due(ends, start, bound, past):
    """The newest submit (by index) ending more than ``bound`` views
    before ``start``, or None, or where it is no newer than ``past``, the
    one an earlier wait settled: what the engine should wait for."""
    far = [i for i, e in enumerate(ends) if start - e > bound]
    return far[-1] if far and far[-1] > past else None


def _run(chunks, bound, progress=None):
    """Drive an Inflight over ``chunks`` while INFLIGHT_VIEWS is
    ``bound``; ``progress(j)`` is how many submits the card has finished
    on its own before chunk ``j``.  Checks each wait against :func:`_due`
    and returns the card and the in-flight views after each wait."""
    assert engine.INFLIGHT_VIEWS == bound
    card, inf = _Card(), Inflight()
    ends, lead, past = [], [], -1
    for j, k in enumerate(chunks):
        if progress is not None:
            card.done = max(card.done, min(progress(j), j))
        start = ends[-1] if ends else 0
        want = _due(ends, start, bound, past)
        past = past if want is None else want
        before = (len(card.queried), len(card.synced), card.done)
        left = inf.wait()
        queried = card.queried[before[0]:]
        synced = card.synced[before[1]:]
        if want is None:
            assert left is None and not queried and not synced
        else:
            assert left == start - ends[want]
            # Only the submit waited for is asked, and synchronised only
            # when the card had not finished it.
            assert queried == [want]
            assert synced == ([] if want < before[2] else [want])
        lead.append(start - (ends[card.done - 1] if card.done else 0))
        inf.mark(k, _Event(card, j))
        ends.append(start + k)
    assert inf.views == sum(chunks)
    return card, lead


@pytest.mark.parametrize("chunk", [1, 31, 200])
def test_waits_only_on_the_newest_submit_far_enough_back(chunk):
    n = max(8, 3 * INFLIGHT_VIEWS // chunk + 3)
    card, _ = _run([chunk] * n, INFLIGHT_VIEWS)
    # The card finishes nothing on its own: every due submit is waited
    # for, each once, newest first among those due.
    assert card.synced == sorted(set(card.synced))
    assert card.synced


@pytest.mark.parametrize("chunk", [1, 31, 200])
def test_the_lead_stays_within_the_bound_plus_one_chunk(chunk):
    n = max(8, 3 * INFLIGHT_VIEWS // chunk + 3)
    _, lead = _run([chunk] * n, INFLIGHT_VIEWS)
    assert max(lead) <= INFLIGHT_VIEWS + chunk
    # And the host does lead: the bound stops it, not a drain.
    assert max(lead) > INFLIGHT_VIEWS


@pytest.mark.parametrize("chunk, first_wait", [
    (1, INFLIGHT_VIEWS + 2), (31, 4), (200, 2)])
def test_the_first_wait_comes_when_a_submit_ends_that_far_back(chunk,
                                                               first_wait):
    card, inf = _Card(), Inflight()
    for j in range(first_wait + 1):
        left = inf.wait()
        if j < first_wait:
            assert left is None and not card.synced, j
        else:
            assert card.synced == [0]
            assert left == (first_wait - 1) * chunk
        inf.mark(chunk, _Event(card, j))


@pytest.mark.parametrize("chunk", [1, 31, 200])
def test_a_finished_submit_is_not_waited_for(chunk):
    # The card keeps up: every submit but the last is done by the next.
    n = max(8, 3 * INFLIGHT_VIEWS // chunk + 3)
    card, lead = _run([chunk] * n, INFLIGHT_VIEWS, progress=lambda j: j)
    assert card.synced == [] and card.queried
    assert max(lead) <= chunk


@pytest.mark.parametrize("seed", range(6))
def test_mixed_chunks_and_a_card_of_any_pace(seed):
    rng = np.random.default_rng(seed)
    chunks = [int(k) for k in rng.choice([1, 2, 7, 31, 64, 65, 200], 60)]
    steps = np.cumsum(rng.integers(0, 3, len(chunks)))
    _, lead = _run(chunks, INFLIGHT_VIEWS,
                   progress=lambda j: int(steps[j]))
    for j in range(1, len(chunks)):
        assert lead[j] <= INFLIGHT_VIEWS + max(chunks[:j])


@pytest.mark.parametrize("bound", [0, 5, 64])
def test_any_bound(bound, monkeypatch):
    monkeypatch.setattr(engine, "INFLIGHT_VIEWS", bound)
    _, lead = _run([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5] * 4, bound)
    assert max(lead) <= bound + 9


def test_what_a_submit_read_is_held_until_its_event_is_done(monkeypatch):
    """A mark's source stays referenced until an event at or after its
    own has completed; then the bound lets it go."""

    class Source:
        pass

    monkeypatch.setattr(engine, "INFLIGHT_VIEWS", 4)
    card, inf = _Card(), Inflight()
    refs = []
    alive_at_sync = []

    class Watching(_Event):
        def synchronize(self):
            gc.collect()
            alive_at_sync.append(
                all(r() is not None for r in refs[self.card.done:]))
            super().synchronize()

    for j in range(12):
        inf.wait()
        src = Source()
        refs.append(weakref.ref(src))
        inf.mark(2, Watching(card, j), src)
        del src
    # Every source of a submit not yet known done was alive at each wait.
    assert len(alive_at_sync) == len(card.synced) > 1
    assert all(alive_at_sync)
    gc.collect()
    finished = card.done
    assert all(r() is None for r in refs[:finished])
    assert all(r() is not None for r in refs[finished:])


G = Geometry().scaled(16, n_proj=12)


def test_a_cpu_engine_never_waits(monkeypatch):
    """No stream, no event, no ``engine.copy.wait``; no copy span blocks
    or counts bytes."""

    def refuse(*a, **kw):
        raise AssertionError("a CPU engine touched torch.cuda")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    projs, mats, _ = make_dataset(G, device="cpu")
    eng = ReconstructionEngine(G, n_slots=2, pbatch=4, device="cpu")
    assert eng._inflight is None and eng._copies is None
    sids = [eng.begin_scan(), eng.begin_scan()]
    spans.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for c0 in range(0, G.n_proj, 1):
                for s in sids:
                    idx = np.arange(c0, c0 + 1)
                    eng.submit(s, ProjectionChunk(projs[idx], mats[idx],
                                                  idx))
        snap = spans.snapshot()
    finally:
        spans.clear()
    names = {s.name for s in snap.spans}
    assert "engine.copy.wait" not in names
    copies = [s for s in snap.spans if s.name.startswith("engine.copy.")]
    per = 3 if eng.plan.parker is not None else 2
    assert len(copies) == per * 2 * G.n_proj
    assert all(s.attrs == {"bytes": 0, "blocks": False} for s in copies)
    assert all(eng.result(s).shape == (G.L,) * 3 for s in sids)
