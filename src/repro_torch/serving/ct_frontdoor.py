"""Multi-tenant CT front door: async admission over the streaming engine.

The port's counterpart of ``repro.serving.ct_frontdoor`` (DESIGN.md §14).
Many concurrent clients hand in interleaved scan streams; admission
order is a policy; a full house answers "retry in t seconds" instead of
buffering without bound; a client can walk away mid-scan without leaking
a slot:

* **One payload.** Every arrival is a
  :class:`repro_torch.streaming.ProjectionChunk`, the currency the
  engine's ``submit`` takes.
* **Pluggable admission.** The engine's own queue stays empty; the front
  door holds all waiting scans and, whenever the backend has a free
  slot, asks its :class:`AdmissionPolicy` which one goes next: FIFO,
  shortest-remaining-scan-first with aging (:class:`SRSFPolicy`),
  SLO-deadline least-slack (:class:`DeadlinePolicy`), or per-tenant fair
  share (:class:`FairSharePolicy`).
* **Backpressure, not buffering.** The pending queue is bounded
  (``max_pending``); when it is full and no slot is free,
  :meth:`CTFrontDoor.open_scan` raises :class:`Backpressure` carrying a
  ``retry_after`` hint derived from the measured scan service time.
* **Cancellation.** :meth:`CTFrontDoor.cancel` drops a pending ticket or
  aborts an in-flight one (``ReconstructionEngine.abort_scan`` zeroes
  the slot in place and refills it), so abort-then-reuse is bit-clean.
* **Sharded mode.** ``mesh=`` serves each scan across a ``DeviceMesh``
  through :func:`repro_torch.core.pipeline.sharded_reconstruct`.  The
  port runs SPMD: every rank of the mesh builds its own front door and
  drives it with the same calls, in the same order, with the same
  chunks; each rank's :meth:`CTFrontDoor.result` is the whole volume.

Concurrency model: single event loop, cooperative.  Device work is
launched inline (CUDA launches are asynchronous, so they overlap host
code); ``await`` points let client coroutines interleave their streams.
The front door itself is not thread-safe: one loop owns it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np
import torch

from ..core.geometry import Geometry
from ..streaming import ProjectionChunk, ReconstructionEngine

__all__ = [
    "AdmissionPolicy",
    "FIFOPolicy",
    "SRSFPolicy",
    "DeadlinePolicy",
    "FairSharePolicy",
    "POLICIES",
    "PolicyContext",
    "Backpressure",
    "ScanAborted",
    "ScanTicket",
    "CTFrontDoor",
]


class Backpressure(RuntimeError):
    """The front door is full: no free slot and the pending queue is at
    ``max_pending``.  ``retry_after`` (seconds) is the service-time-based
    hint a well-behaved client sleeps before retrying."""

    def __init__(self, retry_after: float):
        self.retry_after = float(retry_after)
        super().__init__(
            f"serving tier full; retry after {self.retry_after:.3f}s")


class ScanAborted(RuntimeError):
    """Awaited result of a scan that was cancelled."""


@dataclasses.dataclass
class ScanTicket:
    """One client scan as the front door tracks it.

    ``deadline`` is an absolute clock value (same clock as the front
    door's, default ``time.monotonic``) — the SLO instant the finished
    volume is due, which :class:`DeadlinePolicy` schedules against.
    """

    tid: int
    tenant: str
    n_proj: int
    deadline: float | None = None
    arrived: float = 0.0              # clock time open_scan admitted it
    admitted_at: float | None = None  # clock time it got a slot
    first_submit: float | None = None
    finished_at: float | None = None
    state: str = "pending"            # pending | active | done | aborted
    sid: int | None = None            # backend scan id once active
    received: int = 0
    buffered: list = dataclasses.field(default_factory=list)
    volume: object | None = None
    _event: asyncio.Event = dataclasses.field(default_factory=asyncio.Event)

    @property
    def remaining(self) -> int:
        """Projections still to fold end-to-end.  A queued scan has its
        whole declared length ahead of it whatever has been buffered, so
        for pending tickets this is ``n_proj`` — SRSF over a queue is
        shortest-declared-scan-first (plus aging)."""
        return self.n_proj

    @property
    def settled(self) -> bool:
        return self.state in ("done", "aborted")


@dataclasses.dataclass(frozen=True)
class PolicyContext:
    """What a policy may look at when choosing the next admission.

    ``active``/``admitted`` map tenant -> in-flight count / total
    admissions; ``est_proj_s`` is the front door's EWMA of measured
    seconds per projection (0.0 until the first scan completes).
    """

    now: float
    active: dict
    admitted: dict
    est_proj_s: float = 0.0


class AdmissionPolicy:
    """Chooses which pending ticket takes the next free slot.

    ``select`` gets the pending tickets *in arrival order* and a
    :class:`PolicyContext`; it returns the index of the winner.  Stable
    ties (Python ``min`` keeps the first minimum) make every policy
    FIFO among equals.
    """

    name = "abstract"

    def select(self, pending, ctx: PolicyContext) -> int:
        raise NotImplementedError


class FIFOPolicy(AdmissionPolicy):
    """Arrival order — the engine's own queue discipline, lifted."""

    name = "fifo"

    def select(self, pending, ctx: PolicyContext) -> int:
        return 0


class SRSFPolicy(AdmissionPolicy):
    """Shortest-remaining-scan-first with linear aging.

    Key: ``remaining - aging * wait_seconds``.  Pure SRSF (``aging=0``)
    starves a long scan under a steady stream of short ones; with
    ``aging > 0`` (projections of credit per waiting second) a scan that
    has waited ``(its remaining - shortest remaining) / aging`` seconds
    outranks every fresh short arrival — the starvation bound
    ``tests/test_frontdoor.py`` holds as a property.
    """

    name = "srsf"

    def __init__(self, aging: float = 1.0):
        if aging < 0:
            raise ValueError(f"aging must be >= 0, got {aging}")
        self.aging = float(aging)

    def select(self, pending, ctx: PolicyContext) -> int:
        def key(i):
            t = pending[i]
            return t.remaining - self.aging * (ctx.now - t.arrived)

        return min(range(len(pending)), key=key)


class DeadlinePolicy(AdmissionPolicy):
    """SLO deadlines: least slack first.

    Slack = ``deadline - now - remaining * est_proj_s`` — time to spare
    if the scan started this instant at the measured per-projection
    rate.  Tickets without a deadline have infinite slack and are served
    FIFO after every deadlined one.
    """

    name = "deadline"

    def select(self, pending, ctx: PolicyContext) -> int:
        def slack(i):
            t = pending[i]
            if t.deadline is None:
                return float("inf")
            return t.deadline - ctx.now - t.remaining * ctx.est_proj_s

        return min(range(len(pending)), key=slack)


class FairSharePolicy(AdmissionPolicy):
    """Per-tenant fair share: least in-flight, then least ever-admitted.

    A tenant flooding the queue only competes with itself — each free
    slot goes to the tenant with the fewest scans in service (total
    admissions break ties, arrival order after that).
    """

    name = "fair"

    def select(self, pending, ctx: PolicyContext) -> int:
        def key(i):
            t = pending[i]
            return (ctx.active.get(t.tenant, 0),
                    ctx.admitted.get(t.tenant, 0))

        return min(range(len(pending)), key=key)


POLICIES = {"fifo": FIFOPolicy, "srsf": SRSFPolicy,
            "deadline": DeadlinePolicy, "fair": FairSharePolicy}


def _resolve_policy(policy) -> AdmissionPolicy:
    if isinstance(policy, AdmissionPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return POLICIES[policy.lower()]()
        except KeyError:
            raise ValueError(
                f"unknown admission policy {policy!r}; want one of "
                f"{tuple(POLICIES)} or an AdmissionPolicy instance"
            ) from None
    raise TypeError(f"policy must be a name or AdmissionPolicy, "
                    f"got {type(policy).__name__}")


# ----------------------------------------------------------------------
# Backends: where admitted scans actually reconstruct
# ----------------------------------------------------------------------
class _EngineBackend:
    """Single-process slot machine: the streaming ReconstructionEngine."""

    def __init__(self, engine: ReconstructionEngine):
        self.engine = engine

    @property
    def n_slots(self) -> int:
        return self.engine.n_slots

    @property
    def free_slots(self) -> int:
        return self.engine.free_slots

    def validate_declared(self, n_proj: int) -> None:
        pass                        # any positive length streams fine

    def begin(self, n_proj: int) -> int:
        return self.engine.begin_scan(n_proj=n_proj)

    def submit(self, sid: int, chunk: ProjectionChunk) -> None:
        self.engine.submit(sid, chunk)

    def pump(self) -> None:
        self.engine.drain()

    def poll(self, sid: int):
        scan = self.engine.scans.get(sid)
        if scan is not None and scan.done:
            return self.engine.result(sid, pop=True)
        return None

    def abort(self, sid: int) -> None:
        self.engine.abort_scan(sid)


class _ShardedBackend:
    """Mesh path: one scan's volume spans the ``data`` axis.

    Chunks stage on the host by *global angle index*; when the full scan
    is in, :func:`repro_torch.core.pipeline.sharded_reconstruct` runs
    with ``prefiltered=False``: each rank FDK-filters its projection
    block and back-projects its z-slab at its ``z0``, so filtering
    scales with the ``proj`` axes and the volume with ``data``.  The
    in-shard filter needs the whole scan (Parker rows by global angle
    index), so sharded scans must declare ``n_proj == geom.n_proj`` and
    each angle may arrive exactly once.

    ``n_slots`` bounds how many scans may stage concurrently: the same
    admission currency as the engine backend, with host staging memory
    (``n_proj * n_v * n_u * 4`` bytes per scan) as the resource.
    """

    def __init__(self, geom: Geometry, mesh, *, n_slots: int = 2,
                 volume_axis: str = "data",
                 proj_axes: tuple[str, ...] = ("model",),
                 strategy: str = "strip2", pbatch: int | None = None,
                 short_scan: bool | None = None, device="cuda", **opts):
        self.geom = geom
        self.mesh = mesh
        self.n_slots = int(n_slots)
        self._recon_kw = dict(strategy=strategy, volume_axis=volume_axis,
                              proj_axes=tuple(proj_axes), pbatch=pbatch,
                              prefiltered=False, short_scan=short_scan,
                              device=device, **opts)
        self._staged: dict[int, dict] = {}
        self._next_sid = 0

    @property
    def free_slots(self) -> int:
        return max(0, self.n_slots - len(self._staged))

    def validate_declared(self, n_proj: int) -> None:
        if n_proj != self.geom.n_proj:
            raise ValueError(
                f"sharded mode filters in-shard by global angle index, so "
                f"scans must be full: declared n_proj={n_proj}, geometry "
                f"has {self.geom.n_proj}")

    def begin(self, n_proj: int) -> int:
        self.validate_declared(n_proj)
        sid = self._next_sid
        self._next_sid += 1
        g = self.geom
        self._staged[sid] = {
            "projs": torch.zeros((g.n_proj, g.n_v, g.n_u),
                                 dtype=torch.float32),
            "mats": np.zeros((g.n_proj, 3, 4), np.float32),
            "seen": np.zeros((g.n_proj,), bool),
        }
        return sid

    def submit(self, sid: int, chunk: ProjectionChunk) -> None:
        st = self._staged[sid]
        projs, mats, idx = chunk.arrays(device="cpu")
        if idx.min() < 0 or idx.max() >= self.geom.n_proj:
            raise ValueError(
                f"angle indices must lie in [0, {self.geom.n_proj})")
        if st["seen"][idx].any() or len(set(idx.tolist())) != len(idx):
            raise ValueError(
                "sharded mode takes each angle index exactly once; "
                f"duplicate in {idx.tolist()}")
        st["projs"][torch.as_tensor(idx, dtype=torch.long)] = projs
        st["mats"][idx] = mats
        st["seen"][idx] = True

    def pump(self) -> None:
        pass                        # nothing incremental to advance

    def poll(self, sid: int):
        from ..core.pipeline import sharded_reconstruct

        st = self._staged.get(sid)
        if st is None or not st["seen"].all():
            return None
        del self._staged[sid]
        return sharded_reconstruct(st["projs"], st["mats"], self.geom,
                                   self.mesh, **self._recon_kw).full_tensor()

    def abort(self, sid: int) -> None:
        self._staged.pop(sid, None)


# ----------------------------------------------------------------------
# The front door
# ----------------------------------------------------------------------
class CTFrontDoor:
    """Async multi-tenant admission over a reconstruction backend.

    >>> fd = CTFrontDoor(geom, n_slots=2, max_pending=8, policy="srsf")
    >>> ticket = await fd.open_scan(tenant="clinic-a")
    >>> await fd.submit(ticket, ProjectionChunk(projs, mats, idx))
    >>> volume = await fd.result(ticket)

    ``open_scan`` raises :class:`Backpressure` (with ``retry_after``)
    when no slot is free and ``max_pending`` tickets already wait —
    bounded queues all the way down.  ``mesh=...`` (a ``DeviceMesh``)
    selects the sharded backend, which ``engine_opts`` configure
    (``strategy``, ``pbatch``, ``volume_axis``, ``proj_axes``,
    ``short_scan``, the strategy's options); every rank of the mesh
    drives its own front door with the same calls (SPMD).  Otherwise a
    :class:`ReconstructionEngine` on ``device`` is built from
    ``engine_opts`` (``strategy``, including ``"auto"``, which the engine
    resolves through the dispatcher at construction, ``strip_dtype`` and
    the window options, ``pbatch``, ``validate``, ``plan``, ...), or pass
    a prebuilt one as ``engine=``.
    """

    def __init__(self, geom: Geometry, *, n_slots: int = 4,
                 max_pending: int = 16, policy="fifo", engine=None,
                 mesh=None, retry_after: float | None = None,
                 clock=time.monotonic, device="cuda", **engine_opts):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.geom = geom
        self.policy = _resolve_policy(policy)
        self.max_pending = int(max_pending)
        self._clock = clock
        if mesh is not None:
            if engine is not None:
                raise ValueError("pass engine= or mesh=, not both")
            self._backend = _ShardedBackend(geom, mesh, n_slots=n_slots,
                                            device=device, **engine_opts)
        else:
            if engine is None:
                engine = ReconstructionEngine(geom, n_slots=n_slots,
                                              device=device, **engine_opts)
            self._backend = _EngineBackend(engine)
        self._pending: list[ScanTicket] = []      # arrival order
        self._active: dict[int, ScanTicket] = {}
        self._next_tid = 0
        self._active_by_tenant: dict[str, int] = {}
        self._admitted_by_tenant: dict[str, int] = {}
        self._retry_after = retry_after
        self._ewma_scan_s: float | None = None    # per-scan service time
        self._ewma_proj_s: float | None = None    # per-projection
        self.stats = {"opened": 0, "rejected": 0, "admitted": 0,
                      "completed": 0, "cancelled": 0}

    # ------------------------------------------------------------------
    # Client surface (async)
    # ------------------------------------------------------------------
    async def open_scan(self, *, tenant: str = "default",
                        n_proj: int | None = None,
                        deadline: float | None = None) -> ScanTicket:
        """Admit a scan into the tier, or raise :class:`Backpressure`.

        ``deadline`` is an absolute value of the front door's clock (SLO
        instant the volume is due) — only :class:`DeadlinePolicy` reads
        it.  The returned ticket is ``pending`` until a slot frees and
        the policy picks it.
        """
        self.pump()
        n = int(n_proj) if n_proj is not None else self.geom.n_proj
        if n <= 0:
            raise ValueError(f"n_proj must be positive, got {n_proj!r}")
        # A declared length the backend can never serve must fail the
        # *opening* client here — not surface mid-pump out of whichever
        # call happens to admit it later.
        self._backend.validate_declared(n)
        if self._backend.free_slots <= 0 \
                and len(self._pending) >= self.max_pending:
            self.stats["rejected"] += 1
            raise Backpressure(self._retry_hint())
        ticket = ScanTicket(tid=self._next_tid, tenant=str(tenant),
                            n_proj=n, deadline=deadline,
                            arrived=self._clock())
        self._next_tid += 1
        self._pending.append(ticket)
        self.stats["opened"] += 1
        self.pump()
        await asyncio.sleep(0)
        return ticket

    async def submit(self, ticket: ScanTicket,
                     chunk: ProjectionChunk) -> None:
        """Hand in one chunk of ``ticket``'s stream.

        Active scans feed the backend directly; pending scans buffer —
        bounded by the scan's declared ``n_proj``, which over-submission
        breaches loudly here.
        """
        if not isinstance(chunk, ProjectionChunk):
            raise TypeError(
                f"submit takes a ProjectionChunk, got "
                f"{type(chunk).__name__}")
        if ticket.settled:
            raise ValueError(
                f"scan {ticket.tid} already {ticket.state}")
        k = chunk.n
        if ticket.received + k > ticket.n_proj:
            raise ValueError(
                f"scan {ticket.tid} declared {ticket.n_proj} projections; "
                f"{ticket.received + k} submitted")
        if ticket.first_submit is None:
            ticket.first_submit = self._clock()
        ticket.received += k
        if ticket.state == "active":
            self._backend.submit(ticket.sid, chunk)
        else:
            ticket.buffered.append(chunk)
        self.pump()
        await asyncio.sleep(0)

    async def result(self, ticket: ScanTicket, timeout: float | None = None):
        """Await the finished volume (raises :class:`ScanAborted` for a
        cancelled ticket, ``asyncio.TimeoutError`` past ``timeout``)."""
        self.pump()
        if not ticket.settled:
            if timeout is None:
                await ticket._event.wait()
            else:
                await asyncio.wait_for(ticket._event.wait(), timeout)
        if ticket.state == "aborted":
            raise ScanAborted(f"scan {ticket.tid} was cancelled")
        return ticket.volume

    async def cancel(self, ticket: ScanTicket) -> bool:
        """Drop a scan: dequeue a pending one, abort an active one.

        Returns True when the scan was live and is now aborted; a scan
        that already finished keeps its result and returns False.
        """
        if ticket.settled:
            return False
        if ticket.state == "pending":
            self._pending.remove(ticket)
        else:                                       # active
            self._backend.abort(ticket.sid)
            del self._active[ticket.tid]
            self._active_by_tenant[ticket.tenant] -= 1
        ticket.state = "aborted"
        ticket.buffered.clear()
        ticket.finished_at = self._clock()
        self.stats["cancelled"] += 1
        ticket._event.set()
        self.pump()
        await asyncio.sleep(0)
        return True

    # ------------------------------------------------------------------
    # Scheduler core (sync — one event loop owns the front door)
    # ------------------------------------------------------------------
    def pump(self) -> None:
        """Admit while slots are free, advance the backend, retire
        finished scans.  Loops until a fixed point so a retirement's
        freed slot admits in the same call."""
        while True:
            admitted = self._admit_ready()
            self._backend.pump()
            completed = self._reap_completions()
            if not admitted and not completed:
                return

    def _admit_ready(self) -> bool:
        any_admitted = False
        while self._pending and self._backend.free_slots > 0:
            now = self._clock()
            ctx = PolicyContext(now=now,
                                active=dict(self._active_by_tenant),
                                admitted=dict(self._admitted_by_tenant),
                                est_proj_s=self._ewma_proj_s or 0.0)
            i = int(self.policy.select(tuple(self._pending), ctx))
            if not 0 <= i < len(self._pending):
                raise IndexError(
                    f"policy {self.policy.name!r} selected index {i} "
                    f"outside the pending queue (len "
                    f"{len(self._pending)})")
            ticket = self._pending.pop(i)
            ticket.sid = self._backend.begin(ticket.n_proj)
            ticket.state = "active"
            ticket.admitted_at = now
            self._active[ticket.tid] = ticket
            self._active_by_tenant[ticket.tenant] = \
                self._active_by_tenant.get(ticket.tenant, 0) + 1
            self._admitted_by_tenant[ticket.tenant] = \
                self._admitted_by_tenant.get(ticket.tenant, 0) + 1
            self.stats["admitted"] += 1
            for chunk in ticket.buffered:
                self._backend.submit(ticket.sid, chunk)
            ticket.buffered.clear()
            any_admitted = True
        return any_admitted

    def _reap_completions(self) -> bool:
        any_done = False
        for ticket in list(self._active.values()):
            vol = self._backend.poll(ticket.sid)
            if vol is None:
                continue
            ticket.volume = vol
            ticket.state = "done"
            ticket.finished_at = self._clock()
            del self._active[ticket.tid]
            self._active_by_tenant[ticket.tenant] -= 1
            self.stats["completed"] += 1
            service = ticket.finished_at - ticket.admitted_at
            self._ewma_scan_s = (service if self._ewma_scan_s is None
                                 else 0.7 * self._ewma_scan_s
                                 + 0.3 * service)
            per = service / max(1, ticket.n_proj)
            self._ewma_proj_s = (per if self._ewma_proj_s is None
                                 else 0.7 * self._ewma_proj_s + 0.3 * per)
            ticket._event.set()
            any_done = True
        return any_done

    def _retry_hint(self) -> float:
        if self._retry_after is not None:
            return self._retry_after
        # One slot frees roughly every (scan service time / n_slots);
        # before any completion has been measured, hint 100 ms.
        per_scan = self._ewma_scan_s if self._ewma_scan_s else 0.1
        return max(0.01, per_scan / max(1, self._backend.n_slots))

    # ------------------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def active(self) -> int:
        return len(self._active)

    @property
    def free_slots(self) -> int:
        return self._backend.free_slots
