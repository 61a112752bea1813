"""Paced scanners: the schedule a paced mix drives, the closed loop a
mix without ``fps`` still drives, and the lag reader."""

import asyncio
import json
import statistics
import time
import types

import numpy as np
import pytest
import torch

from bench.harness import cell, registry, serve
from bench.harness.inputs import Inputs
from bench.reference.geometry import Scan
from bench.tests.conftest import TINY

CPU = torch.device("cpu")


class Door:
    """A front door that keeps each call with the time it came:
    ``(call, ticket, angle indices, time)``."""

    def __init__(self, L: int):
        self.L, self.calls, self.opened = L, [], 0

    async def open_scan(self, tenant, n_proj):
        ticket = types.SimpleNamespace(tid=self.opened, tenant=tenant,
                                       volume=None)
        self.opened += 1
        self.calls.append(("open", ticket.tid, tenant, time.perf_counter()))
        await asyncio.sleep(0)
        return ticket

    async def submit(self, ticket, chunk):
        self.calls.append(("submit", ticket.tid,
                           [int(a) for a in chunk[2]], time.perf_counter()))
        await asyncio.sleep(0)

    async def result(self, ticket):
        await asyncio.sleep(0)
        self.calls.append(("result", ticket.tid, None, time.perf_counter()))
        return torch.zeros(self.L ** 3)

    def of(self, tid):
        return [c for c in self.calls if c[1] == tid]


@pytest.fixture(scope="module")
def inputs(bench):
    cfg = cell._merge(registry.config(bench, "rabbitct-512-f32"),
                      TINY["config"])
    return Inputs(Scan.from_config(cfg["geometry"]), 11, 2, "device", CPU)


def drive(inputs, traffic, seconds, seed=3):
    door = Door(inputs.scan.L)
    records, t0 = serve.drive(door, inputs, traffic, seed, seconds,
                              serve.Clock(CPU), serve.Spans(False),
                              lambda *parts: parts)
    return door, records, t0


def test_a_frame_is_the_view_at_its_angle(inputs):
    for s in range(2):
        for k in range(inputs.scan.n_proj):
            views, mats, idx = inputs.frame(s, k)
            j = int(inputs.slot[s][k])
            assert list(idx) == [k] and inputs.order[s][j] == k
            assert views.shape[0] == 1
            assert torch.equal(views, inputs.views[s][j:j + 1])
            assert np.array_equal(mats, inputs.mats[[k]])


def test_the_paced_schedule(inputs):
    fps, clients = 100.0, 3
    acq = (inputs.scan.n_proj - 1) / fps
    traffic = {"clients": clients, "tenants": clients, "chunk": 1,
               "fps": fps}
    door, records, t0 = drive(inputs, traffic, 0.45)
    assert {r.client for r in records} == set(range(clients))
    for i in range(clients):
        mine = [r for r in records if r.client == i]
        # The stagger: client i opens its first scan i/clients of an
        # acquisition into the window.
        assert mine[0].t_open == pytest.approx(t0 + i / clients * acq)
        for r in mine:
            assert r.error is None and r.t_done is not None
            assert r.t_last == pytest.approx(r.t_open + acq)
            calls = door.of(r.ticket.tid)
            assert calls[0][3] >= r.t_open
            submits = [c for c in calls if c[0] == "submit"]
            # One view a submit, in acquisition order, none before its
            # time on the scan's own schedule.
            assert [c[2] for c in submits] == \
                [[k] for k in range(inputs.scan.n_proj)]
            for k, c in enumerate(submits):
                assert c[3] >= r.t_open + k / fps
            assert len(r.late) == inputs.scan.n_proj
            assert min(r.late) >= 0.0
            assert [c[0] for c in calls] == \
                ["open"] + ["submit"] * inputs.scan.n_proj + ["result"]
        # The next scan opens as soon as the last one's volume is back,
        # not on the scanner's old frame grid.
        assert len(mine) == (2 if i < 2 else 1)
        for a, b in zip(mine, mine[1:]):
            back = door.of(a.ticket.tid)[-1][3]
            assert back <= b.t_open < back + 1 / fps
            assert door.of(b.ticket.tid)[0][3] >= b.t_open


def test_without_fps_the_clients_run_the_closed_loop(inputs):
    """The calls each client makes are the closed loop's: a seeded scan,
    its chunks in a seeded order back to back, then the result."""
    seed, size, clients = 3, 8, 2
    traffic = {"clients": clients, "tenants": 2, "chunk": size}
    door, records, _ = drive(inputs, traffic, 0.05, seed)
    n_chunks = inputs.scan.n_proj // size
    for i in range(clients):
        rng = np.random.default_rng([seed, 1, i])
        mine = [r for r in records if r.client == i]
        assert mine
        for r in mine:
            scan = int(rng.integers(2))
            order = rng.permutation(n_chunks)
            assert r.scan == scan and r.t_last is None and not r.late
            want = [("open", f"tenant-{i}")] + [
                ("submit", [int(a) for a in
                            inputs.order[scan][c * size:(c + 1) * size]])
                for c in order] + [("result", None)]
            assert [(c[0], c[2]) for c in door.of(r.ticket.tid)] == want


def test_a_paced_mix_hands_in_one_view_a_submit(inputs):
    with pytest.raises(ValueError, match="one view a submit"):
        drive(inputs, {"clients": 1, "tenants": 1, "chunk": 8,
                       "fps": 60.0}, 0.01)


def test_the_lag_reader():
    lag = registry.reader("lag_p50_s").read
    rec = types.SimpleNamespace
    lags = [0.004, 0.006, 0.005, 0.012, 0.007, 0.009, 0.030, 0.005]
    recs = [rec(t_last=10.0 + j, t_done=10.0 + j + x)
            for j, x in enumerate(lags)]
    recs.append(rec(t_last=50.0, t_done=None))          # never returned
    want = statistics.median(lags)
    assert lag(types.SimpleNamespace(records=recs)) == pytest.approx(want)
    closed = [rec(t_last=None, t_done=float(j)) for j in range(8)]
    assert lag(types.SimpleNamespace(records=closed)) is None
    assert lag(types.SimpleNamespace(records=recs[-1:])) is None


def test_a_mix_may_set_fps_and_nothing_unread(tmp_path, monkeypatch):
    assert "fps" in registry.TRAFFIC_KEYS
    assert registry.traffic("frames20s")["fps"] == 24.8
    (tmp_path / "traffic").mkdir()
    mix = dict(registry.traffic("frames20s"), jitter_ms=2)
    (tmp_path / "traffic" / "jittered.json").write_text(json.dumps(mix))
    monkeypatch.setattr(registry, "BENCH", tmp_path)
    with pytest.raises(ValueError, match="jitter_ms"):
        registry.traffic("jittered")
