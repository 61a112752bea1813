"""Streamed reconstruction engine: slot-based continuous batching for CT.

The port's counterpart of ``repro.streaming.engine`` (DESIGN.md §8):

* fixed ``n_slots`` concurrent reconstructions share one resident volume
  stack ``(n_slots, L, L, L)`` on the engine's device;
* an arriving chunk is FDK-filtered **the moment it arrives**, with
  Parker rows selected by its explicit *angle indices*, so arrival order
  never has to match angle order;
* filtered projections stage per scan and fold ``pbatch`` at a time, one
  volume pass per batch (DESIGN.md §7);
* each tick folds every ready slot.  Where the reference ran one vmapped,
  masked step over the stack (or one Pallas launch per ready slot), the
  port folds each ready slot **in place** on that slot's view of the
  stack: through the CUDA kernel on a CUDA device, one launch per ready
  slot (plus one encode on the int8 wire), through the named strategy
  on the CPU.  When the plan's tuned kernel beat the strategies
  (``plan.use_pallas``), every fold runs that kernel config instead
  (its CUDA kernel on the card, its plain version on the CPU).  Slots
  that are not ready are never touched, which is the mask;
* finished scans retire, their slot is zeroed in place and refilled
  from the admission queue;
* on a CUDA device no copy of a chunk waits for the card: views in
  pinned host memory, the Parker rows' indices and the matrices cross on
  the engine's copy stream, under the folds already queued, and the
  filter waits for them there.  The host's lead over the card is bounded
  in views (:data:`INFLIGHT_VIEWS`) instead of by a drain.

Summation order within a volume follows arrival order, so a streamed
result matches the one-shot :func:`repro_torch.core.backproject.
reconstruct` of the same projections to fp32 rounding (~1e-5).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import spans
from .._device import as_f32, resolve_device
from ..core.backproject import (GeomStatic, _resolve_plan, check_windows,
                                fold_projections)
from ..core.filtering import apply_filter, make_filter_plan
from ..core.geometry import Geometry
from ..dispatch.plan import ExecutionPlan

__all__ = ["ProjectionChunk", "ScanState", "ReconstructionEngine"]

# The host's lead over the card, in views: before a chunk's copies a CUDA
# engine waits for the newest earlier submit whose views end more than
# this many views back.  64 views are about two chunks of 31 RabbitCT
# views (1248x960), ~25 ms of the card's work at L=512: more than the
# host's ~5 ms a chunk, so the card does not starve while the host waits,
# and few enough that a scan's latency grows by at most ~2 % and the
# chunks in flight stage well under 1 GB on the card.
INFLIGHT_VIEWS = 64


@dataclasses.dataclass(frozen=True)
class ProjectionChunk:
    """One typed arrival payload: ``k`` raw projections with their
    matrices and global angle indices.

    ``projections`` is ``(k, n_v, n_u)`` (or one ``(n_v, n_u)`` image),
    a tensor or a numpy array; ``matrices`` ``(k, 3, 4)`` (or one ``(3,
    4)``); ``angle_indices`` the ``k`` *global* angle indices (or a
    scalar).  Raw line integrals, filtered by the consumer on arrival.

    A CUDA engine reads projections in pinned host memory (a CPU tensor
    whose ``is_pinned()`` is true) after ``submit`` has returned: the
    caller must not write into them until the scan's result is taken.
    Other host projections are copied before ``submit`` returns.
    """

    projections: object
    matrices: object
    angle_indices: object

    @property
    def n(self) -> int:
        """Number of projections carried."""
        shape = tuple(self.projections.shape) \
            if torch.is_tensor(self.projections) \
            else np.shape(self.projections)
        return 1 if len(shape) == 2 else int(shape[0])

    def arrays(self, device="cuda"):
        """Normalise to ``(k, n_v, n_u)`` float32 on ``device``, and host
        ``(k, 3, 4)`` float64 matrices and ``(k,)`` int32 indices."""
        projs = as_f32(self.projections, resolve_device(device))
        if projs.ndim == 2:
            projs = projs[None]
        return (projs, *self._host_arrays())

    def _host_arrays(self):
        mats = np.asarray(self.matrices, np.float64).reshape(-1, 3, 4)
        idx = np.atleast_1d(np.asarray(self.angle_indices, np.int32))
        return mats, idx


class Inflight:
    """The views a CUDA engine has queued and not yet seen done.

    :meth:`mark` notes each submit: where it ends, counted in views
    submitted, an event recorded on the compute stream after its work,
    and the caller's pinned views it read, held until that event has
    completed (the staging copies the engine pinned itself are kept by
    the caching host allocator until their copies are done).  The engine
    records the event as the next submit starts, so that it covers the
    folds a drain queued after the submit too.  :meth:`wait` runs before
    the next chunk's copies.  Any object with ``query()`` and
    ``synchronize()`` serves as an event.
    """

    def __init__(self):
        self.views = 0                      # views submitted so far
        self._marks = collections.deque()   # (end, event, source)

    def mark(self, k: int, event, source=None) -> None:
        """A submit of ``k`` views, done on the card once ``event`` is."""
        self.views += int(k)
        self._marks.append((self.views, event, source))

    def wait(self, sid: int | None = None) -> int | None:
        """Wait for the newest submit whose views end more than
        INFLIGHT_VIEWS views before the next chunk, unless its event has
        completed; the older marks go with it (the compute stream runs in
        order).  The wait is the span ``engine.copy.wait``.  Returns the
        views queued after that submit, which stay in flight, or None
        when no submit lies that far back."""
        due = []
        while (self._marks
               and self.views - self._marks[0][0] > INFLIGHT_VIEWS):
            due.append(self._marks.popleft())
        if not due:
            return None
        end, event, _ = due[-1]
        left = self.views - end
        if not event.query():
            with spans.span("engine.copy.wait", sid=sid, bytes=0,
                            blocks=True, views=left):
                event.synchronize()
        return left


@dataclasses.dataclass
class ScanState:
    """One reconstruction in flight."""

    sid: int
    n_proj: int                       # projections this scan will deliver
    received: int = 0
    folded: int = 0
    # Staged (filtered image, matrix) pairs awaiting a volume pass.
    pending: list = dataclasses.field(default_factory=list)
    volume: torch.Tensor | None = None  # set at retirement
    done: bool = False

    @property
    def complete(self) -> bool:
        """All projections submitted (folds may still be outstanding)."""
        return self.received >= self.n_proj


class ReconstructionEngine:
    """Accept projection chunks in arrival order; serve volumes.

    ``strategy`` and ``**opts`` name the back projection and its options
    (validated strictly into an :class:`ExecutionPlan`), or pass a
    pre-built ``plan=``.  ``strategy="auto"`` resolves through the
    process dispatcher (:mod:`repro_torch.dispatch`) here, at
    construction: a cached decision, or in-situ selection, whose timing
    problem is made from the geometry.  On a CUDA ``device`` every fold
    runs a hand-written kernel: the plan's tuned kernel config when it
    beat the strategies (``plan.use_pallas``; counted in
    ``stats["pallas_folds"]``), else row 1 on the plan's wire
    (``strip_dtype``: float32, bfloat16, or int8 codes encoded once per
    fold); on ``device="cpu"`` the same choice runs the plain versions
    and the named strategy's sampler.  ``validate=True`` checks every
    submitted chunk's windows where they are read (memoised per matrix):
    the strategy's windows on the CPU, a tuned strip kernel's on either
    device.  ``pbatch`` projections fold per volume pass (default: the
    tuned kernel's depth when it runs, else the plan's).  The slot
    volumes are updated in place.

    On a CUDA device the chunks' copies run on the engine's own copy
    stream, and the host waits only to keep its lead over the card
    within :data:`INFLIGHT_VIEWS` views (see :meth:`submit`).
    """

    def __init__(self, geom: Geometry, *, n_slots: int = 4,
                 strategy: str = "scalar", pbatch: int | None = None,
                 short_scan: bool | None = None, validate: bool = True,
                 plan: ExecutionPlan | None = None, device="cuda",
                 **opts):
        if plan is None:
            plan = _resolve_plan(geom, strategy, opts, pbatch)
        self.device = resolve_device(device)
        self.geom = geom
        self.gs = GeomStatic.of(geom)
        if pbatch is not None:
            eff = int(pbatch)
        elif plan.use_pallas:
            # The kernel decision was timed at its own batch depth.
            eff = int(plan.pallas_opts().get("pbatch", plan.pbatch))
        else:
            eff = plan.pbatch
        self.pbatch = max(1, eff)
        self.exec_plan = plan._replace(pbatch=self.pbatch)
        self.strategy = plan.strategy
        self.opts = plan.jnp_opts()
        self.validate = bool(validate)
        self.n_slots = int(n_slots)
        self.plan = make_filter_plan(geom, short_scan, device=self.device)
        self._volumes = torch.zeros((self.n_slots,) + (geom.L,) * 3,
                                    dtype=torch.float32, device=self.device)
        self.slot_scan: list[int | None] = [None] * self.n_slots
        self.scans: dict[int, ScanState] = {}
        self.queue: list[int] = []
        self.slot_history: list[tuple[int, int]] = []  # (slot, sid)
        # ``pallas_folds`` keeps the reference's name: projections folded
        # through the plan's tuned kernel config.  ``fold_launches``
        # counts the per-slot volume passes.
        self.stats = {"folds": 0, "fold_ticks": 0, "retired": 0,
                      "pallas_folds": 0, "aborted": 0, "fold_launches": 0}
        self._next_sid = 0
        if self.device.type == "cuda":
            self._copies = torch.cuda.Stream(self.device)
            self._inflight = Inflight()
        else:
            self._copies = self._inflight = None
        self._unmarked = None   # (views, source) of the last submit

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def begin_scan(self, n_proj: int | None = None) -> int:
        """Register a new reconstruction; returns its scan id.

        The scan takes a free volume slot now, or queues until a running
        scan retires.  ``n_proj=None`` means a full scan; a non-positive
        count raises.
        """
        if n_proj is not None and int(n_proj) <= 0:
            raise ValueError(
                f"begin_scan: n_proj must be positive, got {n_proj!r} "
                f"(pass None for a full scan)")
        sid = self._next_sid
        self._next_sid += 1
        self.scans[sid] = ScanState(
            sid=sid,
            n_proj=int(n_proj) if n_proj is not None else self.geom.n_proj)
        self.queue.append(sid)
        self._admit()
        return sid

    def _free_slots(self):
        return [i for i, s in enumerate(self.slot_scan) if s is None]

    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                break
            sid = self.queue.pop(0)
            self.slot_scan[slot] = sid
            self.slot_history.append((slot, sid))

    # ------------------------------------------------------------------
    # Arrival path
    # ------------------------------------------------------------------
    def submit(self, sid: int, chunk: ProjectionChunk) -> None:
        """Stage one :class:`ProjectionChunk` of scan ``sid``.

        Filters on the engine's device now, with the Parker rows of the
        *submitted angle indices*, stages the result, and runs one fold
        tick.  Chunks may be shuffled, interleaved across scans and split
        arbitrarily.

        On a CUDA device the work is queued and ``submit`` returns before
        it is done.  It waits only for the newest earlier submit that ends
        more than :data:`INFLIGHT_VIEWS` views before this chunk, while
        the card has not finished it.  Views in pinned host memory are
        read on the card after ``submit`` returns: do not write into them
        until the scan's result is taken.
        """
        if not isinstance(chunk, ProjectionChunk):
            raise TypeError(f"submit takes a ProjectionChunk, got "
                            f"{type(chunk).__name__}")
        scan = self.scans[sid]
        if scan.done:
            raise ValueError(f"scan {sid} already finished")
        with spans.span("engine.submit", sid=sid) as sp:
            k = self._submit(scan, chunk)
            if sp:
                sp.attrs.update(views=k)

    def _submit(self, scan: ScanState, chunk: ProjectionChunk) -> int:
        # Three copies from the host to the card: the views (none where
        # they are on the card already), the Parker rows' indices and the
        # matrices; a span's ``bytes`` counts what crossed to the card.
        # On a card they run on the copy stream, which the compute stream
        # waits for before the filter, and hold the host only for pageable
        # views (``blocks``), which cannot be read asynchronously without
        # a host copy of the same size.  The host waits instead to keep
        # its lead within INFLIGHT_VIEWS views (``engine.copy.wait``).
        card = self.device.type == "cuda"
        mats, idx = chunk._host_arrays()
        k = chunk.n
        if mats.shape[0] != k or idx.shape != (k,):
            raise ValueError(
                f"chunk of {k} projection(s) needs {k} matrices and {k} "
                f"angle indices; got {mats.shape[0]} and {idx.shape}")
        if idx.min() < 0 or idx.max() >= self.geom.n_proj:
            raise ValueError(
                f"angle indices must lie in [0, {self.geom.n_proj})")
        if scan.received + k > scan.n_proj:
            raise ValueError(
                f"scan {scan.sid} declared {scan.n_proj} projections; "
                f"{scan.received + k} submitted")
        if self.validate:
            check_windows(self.geom, mats, self.exec_plan, self.device)
        if card:
            self._bound_lead(scan.sid)
        src = chunk.projections
        pinned = card and torch.is_tensor(src) and src.is_pinned()
        with spans.span("engine.copy.views", sid=scan.sid) as sp:
            projs = self._cross(src) if pinned else as_f32(src, self.device)
            if projs.ndim == 2:
                projs = projs[None]
            if sp:
                n = projs.nbytes if card and not (
                    torch.is_tensor(src) and src.is_cuda) else 0
                sp.attrs.update(bytes=n, blocks=n > 0 and not pinned)
        rows = None
        if self.plan.parker is not None:
            with spans.span("engine.copy.parker", sid=scan.sid,
                            bytes=8 * k * card, blocks=False):
                rows = self._send(idx.astype(np.int64))
        with spans.span("engine.copy.matrices", sid=scan.sid,
                        bytes=48 * k * card, blocks=False):
            mats32 = self._send(mats.astype(np.float32))
        if card:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_stream(self._copies)
        with spans.span("engine.filter", sid=scan.sid, views=k):
            pw = None if rows is None else self.plan.parker[rows]
            filt = apply_filter(projs, self.plan, pw)
        for i in range(k):
            scan.pending.append((filt[i], mats32[i]))
        scan.received += k
        self.step()
        if card:
            self._unmarked = (k, src if pinned else None)
        return k

    def _bound_lead(self, sid: int) -> None:
        """Mark the last submit done once all the work queued since it
        is (its folds and those of any drain after it), then wait within
        INFLIGHT_VIEWS views.  The event is not a blocking-sync one:
        with one-view chunks some 55 of those pending held the host in
        the filter's launches, before the bound and outside its span."""
        if self._unmarked is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            k, source = self._unmarked
            self._inflight.mark(k, done, source)
            self._unmarked = None
        self._inflight.wait(sid)

    def _send(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the engine's device; on a card through pinned host
        memory from the caching host allocator, which does not reuse it
        before the copy is done."""
        if self.device.type != "cuda":
            return torch.as_tensor(a, device=self.device)
        return self._cross(torch.from_numpy(a).pin_memory())

    def _cross(self, host: torch.Tensor) -> torch.Tensor:
        """Pinned ``host`` on the card, copied on the copy stream without
        waiting.  The copy lands in memory allocated on that stream and
        marked as read by the compute stream, which must wait for the
        copy stream before it reads."""
        with torch.cuda.stream(self._copies):
            dev = host.to(self.device, non_blocking=True)
        dev.record_stream(torch.cuda.current_stream(self.device))
        return dev

    # ------------------------------------------------------------------
    # Fold path
    # ------------------------------------------------------------------
    def _take_batch(self, scan: ScanState):
        """Up to ``pbatch`` staged projections and their matrices."""
        take = scan.pending[:self.pbatch]
        del scan.pending[:self.pbatch]
        return (torch.stack([img for img, _ in take]),
                torch.stack([m for _, m in take]), len(take))

    def step(self) -> bool:
        """One engine tick: fold every ready slot, retire finished scans.

        A slot is *ready* when it holds a full ``pbatch`` of staged
        projections, or its scan is complete and a remainder is staged.
        Returns True when any fold or retirement happened.
        """
        with spans.span("engine.step"):
            return self._step()

    def _step(self) -> bool:
        self._admit()
        ready = []
        for slot, sid in enumerate(self.slot_scan):
            if sid is None:
                continue
            scan = self.scans[sid]
            if len(scan.pending) >= self.pbatch \
                    or (scan.complete and scan.pending):
                ready.append((slot, scan))
        for slot, scan in ready:
            with spans.span("engine.fold", sid=scan.sid, slot=slot) as sp:
                imgs, ms, n = self._take_batch(scan)
                # The chunk's windows were checked at submit.
                fold_projections(self._volumes[slot], imgs, ms, self.geom,
                                 plan=self.exec_plan, validate=False)
                if sp:
                    sp.attrs.update(views=n,
                                    wire=self.exec_plan.strip_dtype)
            scan.folded += n
            self.stats["folds"] += n
            self.stats["fold_launches"] += 1
            if self.exec_plan.use_pallas:
                self.stats["pallas_folds"] += n
        if ready:
            self.stats["fold_ticks"] += 1
        return self._retire() or bool(ready)

    def _retire(self) -> bool:
        any_retired = False
        for slot, sid in enumerate(self.slot_scan):
            if sid is None:
                continue
            scan = self.scans[sid]
            if scan.complete and not scan.pending:
                with spans.span("engine.retire", sid=sid, slot=slot):
                    scan.volume = self._volumes[slot].clone()
                    self._volumes[slot].zero_()
                scan.done = True
                self.slot_scan[slot] = None
                self.stats["retired"] += 1
                any_retired = True
                del self.slot_history[:-4096]   # bound a long-lived server
        if any_retired:
            self._admit()
        return any_retired

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------
    def drain(self, max_ticks: int = 100_000) -> int:
        """Fold until no slot can make progress; returns ticks run.
        Scans still expecting projections keep their sub-``pbatch``
        staging buffers."""
        ticks = 0
        while ticks < max_ticks and self.step():
            ticks += 1
        return ticks

    def result(self, sid: int, pop: bool = False) -> torch.Tensor:
        """The finished ``(L, L, L)`` volume of scan ``sid``.

        ``pop=True`` releases the scan's state after fetching; a
        long-running server does one of ``pop``/:meth:`release` per scan.
        """
        scan = self.scans[sid]
        if not scan.done:
            raise ValueError(
                f"scan {sid} not finished: {scan.received}/{scan.n_proj} "
                f"submitted, {len(scan.pending)} staged"
                + ("" if scan.complete else " (more submissions expected)"))
        vol = scan.volume
        if pop:
            self.release(sid)
        return vol

    def release(self, sid: int) -> None:
        """Drop a *finished* scan's state (and its retained volume)."""
        scan = self.scans.get(sid)
        if scan is None:
            return
        if not scan.done:
            raise ValueError(f"scan {sid} still active; cannot release")
        del self.scans[sid]

    def abort_scan(self, sid: int) -> None:
        """Drop scan ``sid`` mid-flight: discard its staged projections,
        zero its slot in place and refill the slot from the queue, so the
        next occupant starts from the same all-zero volume a fresh slot
        has.  Unknown (or released) sids raise."""
        scan = self.scans.pop(sid, None)
        if scan is None:
            raise ValueError(f"abort_scan: unknown scan {sid}")
        if sid in self.queue:
            self.queue.remove(sid)
        for slot, owner in enumerate(self.slot_scan):
            if owner == sid:
                self._volumes[slot].zero_()
                self.slot_scan[slot] = None
        scan.pending.clear()
        scan.done = True
        self.stats["aborted"] += 1
        self._admit()

    @property
    def active(self) -> int:
        """Scans currently holding slots or queued."""
        return sum(s is not None for s in self.slot_scan) + len(self.queue)

    @property
    def free_slots(self) -> int:
        """Slots an admission would get *right now* (empty slots not
        already claimed by the engine's own queue)."""
        empty = sum(s is None for s in self.slot_scan)
        return max(0, empty - len(self.queue))
