"""The engine's asynchronous ingest on a card: views in pinned host
memory, the Parker rows' indices and the matrices cross on the engine's
copy stream while earlier folds run, and the host's lead over the card
is bounded in views (``INFLIGHT_VIEWS``).

This file imports neither JAX nor the reference package; on a machine
with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_ingest_async.py

Without a card every test skips with a reason.  The served volumes are
held bitwise to the same scans submitted from pageable memory with a
synchronise after each submit, on the float32, bfloat16 and int8 wires
and through a tuned strip kernel (K5, ``use_pallas``), while a
sleep queued before each submit on the compute stream (a destination
reused before the filter read it) or on the copy stream (a filter that
did not wait for its copy) would show as a different volume.
"""

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import ExecutionPlan
from repro_torch.core.geometry import Geometry
from repro_torch.core.phantom import make_dataset
from repro_torch.streaming import ProjectionChunk, ReconstructionEngine
from repro_torch.streaming.engine import INFLIGHT_VIEWS

pytestmark = pytest.mark.cuda

G = Geometry().scaled(64, n_proj=150)      # L a multiple of K5's chunk
# K5 (strip_shared) as a tuned decision names it.
TUNED = ExecutionPlan.explicit("scalar", pbatch=4)._replace(
    pallas=tuple(sorted(dict(ty=1, chunk=32, pbatch=4,
                             shared_window=True).items())),
    use_pallas=True)
WIRES = {"float32": dict(strategy="scalar"),
         "bfloat16": dict(strategy="strip2", strip_dtype="bfloat16"),
         "int8": dict(strategy="strip2", strip_dtype="int8"),
         "tuned": dict(plan=TUNED)}
# Uneven chunks, so the copy stream's blocks are reused at other sizes.
SIZES = (7, 1, 31, 13, 64, 2, 32)
CYCLES = 20_000_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ingest is asynchronous only "
                    "on a card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    projs, mats, _ = make_dataset(G, device="cpu")
    return projs, mats


def _chunks(n_scans, seed):
    """(scan, angle indices) in arrival order: each scan's views in its
    own seeded order, in chunks of ``SIZES`` in turn, the scans
    interleaved."""
    rng = np.random.default_rng(seed)
    per = []
    for s in range(n_scans):
        order = rng.permutation(G.n_proj)
        cuts, c, i = [], 0, s
        while c < G.n_proj:
            k = SIZES[i % len(SIZES)]
            cuts.append(order[c:c + k])
            c, i = c + k, i + 1
        per.append(cuts)
    out = []
    for j in range(max(len(p) for p in per)):
        out += [(s, p[j]) for s, p in enumerate(per) if j < len(p)]
    return out


def _serve(dev, wire, projs, mats, views, each=None):
    """Three scans on two slots, each submit followed by a drain as the
    front door's; ``views(idx)`` makes a chunk's views, ``each(eng)``
    runs before every submit.  The volumes, by scan."""
    opts = WIRES[wire]
    eng = ReconstructionEngine(G, n_slots=2, device=dev, **opts,
                               **({} if "plan" in opts else {"pbatch": 4}))
    sids = [eng.begin_scan() for _ in range(3)]
    for s, idx in _chunks(len(sids), seed=5):
        if each is not None:
            each(eng)
        eng.submit(sids[s], ProjectionChunk(views(idx), mats[idx], idx))
        eng.drain()
    torch.cuda.synchronize()
    return [eng.result(s).clone() for s in sids]


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("stream", ["compute", "copies"])
def test_async_ingest_equals_the_synchronised_one_bitwise(dev, data, wire,
                                                          stream):
    projs, mats = data
    pinned = projs.pin_memory()

    def plain_sync(eng):
        torch.cuda.synchronize()

    def sleep(eng):
        if stream == "compute":
            torch.cuda._sleep(CYCLES)
        else:
            with torch.cuda.stream(eng._copies):
                torch.cuda._sleep(CYCLES)

    want = _serve(dev, wire, projs, mats, lambda i: projs[i].numpy(),
                  plain_sync)
    # A pinned chunk is a contiguous slice of pinned memory in the
    # benchmark; an index gather here would be pageable, so each chunk
    # is pinned on its own.
    got = _serve(dev, wire, projs, mats,
                 lambda i: pinned[torch.as_tensor(i)].pin_memory(), sleep)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("size", [1, 31, 40])
def test_in_flight_views_stay_within_the_bound_plus_one_chunk(dev, data,
                                                              size,
                                                              monkeypatch):
    """Before each chunk's copies, the views of earlier submits that the
    card has not finished (an event recorded after each submit and its
    drain) number at most INFLIGHT_VIEWS plus one chunk; the bound
    engages."""
    projs, mats = data
    pinned = projs.pin_memory()
    eng = ReconstructionEngine(G, n_slots=1, pbatch=4, device=dev)
    sid = eng.begin_scan()
    marks = []                                  # (views, event)
    lead = []
    real = spans.span

    def hooked(name, **kw):
        if name == "engine.copy.views":
            lead.append(sum(k for k, ev in marks if not ev.query()))
        return real(name, **kw)

    monkeypatch.setattr(spans, "span", hooked)
    waits = []
    wait = eng._inflight.wait

    def counted(sid=None):
        left = wait(sid)
        waits.append(left)
        return left

    monkeypatch.setattr(eng._inflight, "wait", counted)
    for c in range(0, G.n_proj, size):
        idx = np.arange(c, min(c + size, G.n_proj))
        torch.cuda._sleep(CYCLES)
        eng.submit(sid, ProjectionChunk(pinned[c:c + len(idx)], mats[idx],
                                        idx))
        eng.drain()
        ev = torch.cuda.Event()
        ev.record()
        marks.append((len(idx), ev))
    torch.cuda.synchronize()
    assert eng.result(sid).shape == (G.L,) * 3
    assert max(lead) <= INFLIGHT_VIEWS + size, lead
    assert max(lead) > INFLIGHT_VIEWS - size, lead
    assert any(w is not None for w in waits)
