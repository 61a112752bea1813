"""The port's CT front door against the JAX package's (CPU).

The same clients, chunks and policies drive both front doors; volumes
agree to 1e-5 (abs and rel: float32 both sides, summation order follows
arrival), and backpressure and cancellation behave alike.
"""

import asyncio

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core.phantom import make_dataset
from repro_torch.api import (POLICIES, Backpressure, CTFrontDoor, Geometry,
                             ProjectionChunk, ScanAborted)

JG = japi.Geometry().scaled(16, n_proj=6)
G = Geometry().scaled(16, n_proj=6)
PROJS, MATS, _ = make_dataset(JG)
TOL = dict(atol=1e-5, rtol=1e-5)


async def _stream(fd, chunk_cls, *, chunk, tenant, seed):
    ticket = await fd.open_scan(tenant=tenant, n_proj=G.n_proj)
    order = np.random.default_rng(seed).permutation(G.n_proj)
    for c0 in range(0, G.n_proj, chunk):
        idx = order[c0:c0 + chunk]
        await fd.submit(ticket, chunk_cls(PROJS[idx], MATS[idx], idx))
    return np.asarray(await fd.result(ticket))


def _serve(fd, chunk_cls):
    async def scenario():
        return await asyncio.gather(*(
            _stream(fd, chunk_cls, chunk=c, tenant=t, seed=s)
            for c, t, s in ((2, "a", 0), (3, "b", 1), (6, "a", 2)))), \
            dict(fd.stats)

    return asyncio.run(scenario())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_front_doors_agree_under_every_policy(policy):
    jfd = japi.CTFrontDoor(JG, n_slots=2, max_pending=8, policy=policy,
                           strategy="scalar", pbatch=4)
    tfd = CTFrontDoor(G, n_slots=2, max_pending=8, policy=policy, pbatch=4,
                      device="cpu")
    jouts, jstats = _serve(jfd, japi.ProjectionChunk)
    touts, tstats = _serve(tfd, ProjectionChunk)
    assert tstats == jstats and tstats["completed"] == 3
    for got, want in zip(touts, jouts):
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, **TOL)


def _full_house(mod, geom, **kw):
    async def scenario():
        fd = mod.CTFrontDoor(geom, n_slots=1, max_pending=1,
                             retry_after=0.25, **kw)
        busy = await fd.open_scan(n_proj=2)
        queued = await fd.open_scan(n_proj=2)
        with pytest.raises(mod.Backpressure) as exc:
            await fd.open_scan(n_proj=2)
        states = (busy.state, queued.state, exc.value.retry_after)
        assert await fd.cancel(queued)
        with pytest.raises(mod.ScanAborted):
            await fd.result(queued)
        idx = np.arange(2)
        await fd.submit(busy, mod.ProjectionChunk(PROJS[idx], MATS[idx],
                                                  idx))
        vol = np.asarray(await fd.result(busy))
        assert not await fd.cancel(busy)          # already finished
        with pytest.raises(ValueError, match="aborted"):
            await fd.submit(queued, mod.ProjectionChunk(PROJS[idx],
                                                        MATS[idx], idx))
        return states, dict(fd.stats), fd.free_slots, vol

    return asyncio.run(scenario())


class _Mod:
    """The port's names under the attribute names ``repro.api`` uses."""

    CTFrontDoor = CTFrontDoor
    Backpressure = Backpressure
    ScanAborted = ScanAborted
    ProjectionChunk = ProjectionChunk


def test_backpressure_and_cancel_behave_alike():
    jres = _full_house(japi, JG, strategy="scalar", pbatch=4)
    tres = _full_house(_Mod, G, pbatch=4, device="cpu")
    assert tres[0] == jres[0] == ("active", "pending", 0.25)
    assert tres[1] == jres[1]
    assert tres[2] == jres[2] == 1
    np.testing.assert_allclose(tres[3], jres[3], **TOL)


def test_cancel_active_frees_slot_bit_clean():
    async def scenario():
        fd = CTFrontDoor(G, n_slots=1, pbatch=4, device="cpu")
        poisoned = await fd.open_scan(n_proj=G.n_proj)
        idx = np.arange(4)
        await fd.submit(poisoned, ProjectionChunk(PROJS[idx] * 1e3,
                                                  MATS[idx], idx))
        assert await fd.cancel(poisoned)
        out = await _stream(fd, ProjectionChunk, chunk=3, tenant="x",
                            seed=0)
        fresh = CTFrontDoor(G, n_slots=1, pbatch=4, device="cpu")
        clean = await _stream(fresh, ProjectionChunk, chunk=3, tenant="x",
                              seed=0)
        return out, clean

    out, clean = asyncio.run(scenario())
    assert np.array_equal(out, clean)


def test_mesh_raises_until_ported():
    with pytest.raises(NotImplementedError, match="mesh"):
        CTFrontDoor(G, mesh=object(), device="cpu")


def test_volumes_are_tensors_on_the_engine_device():
    async def scenario():
        fd = CTFrontDoor(G, n_slots=1, pbatch=4, device="cpu")
        ticket = await fd.open_scan(n_proj=1)
        await fd.submit(ticket, ProjectionChunk(PROJS[0], MATS[0], 0))
        return await fd.result(ticket)

    vol = asyncio.run(scenario())
    assert torch.is_tensor(vol) and vol.device.type == "cpu"
    assert vol.shape == (G.L,) * 3
