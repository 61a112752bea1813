"""One run of one cell: set-up, the measured window, the check, the
metrics."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time

import torch

from .. import reference
from ..reference.backproject import voxel_coords
from ..reference.geometry import Scan
from ..reference.phantom import densities
from . import check, registry
from .inputs import Inputs
from .serve import Clock, Spans, drive, warm_up
from .trace import Trace, profiled, short


@dataclasses.dataclass
class Context:
    """What a metric's reader may read."""

    scan: Scan
    traffic: dict
    seconds: float
    setup_s: float
    t0: float
    records: list
    folds: int                      # views the engine folded in the window
    spans: Spans
    trace: Trace | None
    families: dict

    def layer(self, name: str):
        """A test of a device operation's name: is it one of the kernels
        the layer's family files list?"""
        frags = self.families.get(name, [])
        return lambda op: any(f in op for f in frags)

    @property
    def scans_folded(self) -> float:
        return self.folds / self.scan.n_proj


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def program(cfg: dict, scan: Scan, device: torch.device):
    """The system under test, built as the configuration states."""
    from repro_torch.api import CTFrontDoor, Geometry, ReconstructionEngine

    g = cfg["geometry"]
    geom = Geometry(n_u=g["n_u"], n_v=g["n_v"], du=g["du"], dv=g["dv"],
                    sid=g["sid"], sdd=g["sdd"], L=g["L"],
                    voxel_mm=g["voxel_mm"], n_proj=g["n_proj"],
                    sweep=scan.sweep)
    fdc = cfg["front_door"]
    engine = ReconstructionEngine(geom, n_slots=fdc["n_slots"],
                                  device=device, **cfg["engine"])
    fd = CTFrontDoor(geom, engine=engine, max_pending=fdc["max_pending"],
                     policy=fdc["policy"])
    return fd, engine


def pacing(records: list) -> dict | None:
    """How far a paced window's views fell behind their schedule (none
    for a closed loop)."""
    late = sorted(x for r in records for x in r.late)
    if not late:
        return None
    return {"views": len(late), "late_mean_ms": 1e3 * sum(late) / len(late),
            "late_p99_ms": 1e3 * late[int(0.99 * (len(late) - 1))],
            "late_max_ms": 1e3 * late[-1]}


def references(inputs: Inputs, wires: list, device: torch.device) -> list:
    """Per scan, ``{wire: (N,) reference samples}``."""
    out = []
    for s, order in enumerate(inputs.order):
        views = inputs.views[s].to(device)
        mats = torch.as_tensor(inputs.mats[order], device=device)
        out.append(reference.reconstruct_at(inputs.scan, views, order, mats,
                                            inputs.flat, wires))
        del views
    return out


def run(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        overrides: dict | None = None) -> dict:
    """One run of the cell; returns the result line's object.

    ``overrides`` merges its ``config`` and ``traffic`` into the cell's
    (the control, the tests' small sizes)."""
    overrides = overrides or {}
    cell = registry.cell(bench, cell_name)
    base = registry.config(bench, cell["config"])
    cfg = _merge(base, overrides.get("config", {}))
    traffic = _merge(registry.traffic(cell["traffic"]),
                     overrides.get("traffic", {}))
    kind = "per_layer" if trace else "end_to_end"
    wanted = registry.metrics(bench, cell_name, kind)
    readers = {m["name"]: registry.reader(m["name"]) for m in wanted}
    limits = _merge(registry.limits(cell["config"])["checks"],
                    cfg.get("guarantee", {}))
    families = registry.families()
    from repro_torch.api import ProjectionChunk

    scan = Scan.from_config(cfg["geometry"])
    cuda = device.type == "cuda"
    t = time.perf_counter()
    log(f"set-up: imports and the card {t - t_start:.3f} s")
    inputs = Inputs(scan, seed, traffic["scans"], traffic["views"], device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    log(f"set-up: {traffic['scans']} seeded scans "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    fd, engine = program(cfg, scan, device)
    warm_up(fd, inputs, traffic, ProjectionChunk)
    if cuda:
        torch.cuda.synchronize(device)
    log(f"set-up: the program and its warm-up "
        f"{time.perf_counter() - t:.3f} s")
    folds0 = engine.stats["folds"]
    spans, clock = Spans(annotate=trace), Clock(device)
    setup_s = time.perf_counter() - t_start
    t = time.perf_counter()
    with profiled(trace) as held:
        with torch.profiler.record_function("bench.window") if trace \
                else contextlib.nullcontext():
            records, t0 = drive(fd, inputs, traffic, seed, seconds, clock,
                                spans, ProjectionChunk)
    folds = engine.stats["folds"] - folds0
    log(f"window and drain {time.perf_counter() - t:.3f} s"
        + (f", the trace read {time.perf_counter() - held.read_from:.3f} s"
           if trace else ""))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    done = [r for r in records if r.t_done is not None]
    log(f"window: {len(records)} scans opened, {len(done)} returned, "
        f"{sum(r.t_done <= t0 + seconds for r in done)} in the window; "
        f"engine {engine.stats}; front door {fd.stats}; setup "
        f"{setup_s:.3f} s; memory peak {peak} bytes")
    for r in records:
        if r.error:
            log(f"scan of client {r.client} failed: {r.error}")
    paced = pacing(records)
    if paced:
        log("paced: views behind their schedule, "
            + ", ".join(f"{k} {v}" for k, v in paced.items()))
        log("paced: lag from the last frame to the volume, s: "
            + " ".join("-" if r.t_done is None
                       else f"{r.t_done - r.t_last:.6f}" for r in records))
        log("paced: the last frame behind its schedule, s: "
            + " ".join(f"{r.late[-1]:.6f}" if len(r.late) == scan.n_proj
                       else "-" for r in records))
    log("scans (client, scan, opened, returned; s from the window's start): "
        + " ".join(f"{r.client},{r.scan},{r.t_open - t0:.4f},"
                   + ("-" if r.t_done is None else f"{r.t_done - t0:.4f}")
                   for r in records))
    del fd, engine

    ctx = Context(scan=scan, traffic=traffic, seconds=seconds,
                  setup_s=setup_s, t0=t0, records=records, folds=folds,
                  spans=spans, trace=held.trace, families=families)
    metrics = {}
    units = {m["name"]: m["unit"] for m in wanted}
    for name, rd in readers.items():
        v = rd.read(ctx)
        if v is not None and math.isfinite(v):
            metrics[name] = {"value": v, "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"attempted": len(records),
           "failed": len(records) - len(done), "metrics": metrics,
           "device": dev}
    if held.trace is not None:
        tr = held.trace
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
        own = [b - a for a, b, n in tr.device if tr.own(n)]
        log(f"the benchmark's own device ops: {len(own)}, {sum(own):.6f} s")
        for name, s in tr.by_name()[:40]:
            log(f"device op {s:.6f} s  {short(name)}  [{name[:160]}]")
        for a, b in sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:10]:
            log(f"idle gap {b - a:.6f} s at {a:.6f} s of "
                f"{tr.window_s:.6f}: {tr.host_at((a + b) / 2)}")

    # The reference is on the configuration's own wire, whatever runs.
    wire = base["engine"].get("strip_dtype", "float32")
    envelope = {"psnr_db", "drop_db"} & set(limits)
    wires = sorted({wire} | ({"float32"} if envelope else set()))
    values = {}
    samples = [(r.scan, r.sample) for r in done]
    if samples:
        t = time.perf_counter()
        refs = references(inputs, wires, device)
        zyx = voxel_coords(inputs.flat, scan.L)
        inside = check.roi(zyx, scan.L)
        phantom = [densities(scan, e, zyx) for e in inputs.ells] \
            if envelope else None
        values = check.numbers(samples, refs, wire, bool(envelope), inside,
                               phantom)
        log(f"reference and check {time.perf_counter() - t:.3f} s")
    checks, ok = check.judge(values, limits)
    out["correct"] = bool(ok and samples and not out["failed"])
    out["checks"] = checks
    return out

