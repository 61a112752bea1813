"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (the
back projection, with one instance per projection wire, and the int8
row encoder) and holds each against its plain PyTorch version at full
RabbitCT width (L = 512, 1248 x 960 detector).  Then it serves two full
496-projection scans through ``CTFrontDoor`` -> ``ReconstructionEngine``
-> the kernel on the float32 wire, two more on the int8 wire
(``strategy="strip2"``), runs one one-shot reconstruction on the
bfloat16 wire, and checks every volume.  Any failed check exits
non-zero.  The last line of standard output is ``{"ok": true,
"device": {...}}``; the line before it the JSON record of every kernel
of the path.  Needs one CUDA card; imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

_SRC = pathlib.Path(__file__).resolve().parent / "src"

# Card peaks for the bound (H100 SXM data sheet): FP32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Per-voxel float operations of the kernel: 6 for the voxel's world
# coordinates, 37 per projection (three 3x4 rows, the reciprocal, the
# taps' fractions, the bilinear blend, the 1/w^2 weight, the add), and
# on the int8 wire 2 more per tap for the decode (code * scale + offset).
FLOPS_PER_VOXEL = 6
FLOPS_PER_VOXEL_PROJ = 37
WIRE_FLOPS_PER_VOXEL_PROJ = {"float32": 0, "bfloat16": 0, "int8": 4 * 2}
WIRE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
# Row encoder: per pixel 2 operations for the range (pass 1) and 9 for
# the error-feedback step (add, sub, div, round, 2 clamps, mul, add, sub).
QUANT_FLOPS_PER_PIXEL = 11

SEED = 0
N_CHECK = 8               # projections of the full-width kernel check
N_REMAINDER = 5           # plus a remainder batch
CHUNK = 31                # projections per served chunk
PBATCH = 4                # the engine's default fold depth
TOL_KERNEL = 1e-5         # x max(1, max|ref|): fp32 order and FMA slack
TOL_STREAM = 1e-4         # x max|v|: streamed vs one-shot, arrival order
MIN_PSNR_DB = 15.0        # an all-zero volume scores ~11 dB here
# Narrow wires against the float32 volume: (min ROI PSNR, max drop of
# the phantom PSNR), the reference's envelope for each wire.
WIRE_ENVELOPE = {"bfloat16": (40.0, 0.5), "int8": (35.0, 1.0)}
N_VALIDATE = 4            # matrices put through the host window check


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(L: int, nz: int, P: int, rows: int, cols: int,
             wire: str = "float32"):
    """Least time for one launch: the larger of bytes over HBM rate (volume
    read and written once, each image, scale block and matrix read once)
    and FLOPs over the FP32 peak."""
    vox = nz * L * L
    nbytes = (2 * vox * 4 + P * rows * cols * WIRE_BYTES[wire] + P * 48
              + (P * 2 * rows * 4 if wire == "int8" else 0))
    flops = vox * (FLOPS_PER_VOXEL + (FLOPS_PER_VOXEL_PROJ
                                      + WIRE_FLOPS_PER_VOXEL_PROJ[wire]) * P)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def quant_bound_ms(P: int, rows: int, cols: int):
    """Least time of one row-encoder launch: pixels read as float32 and
    written as int8 once, and the (P, 2, rows) block written once."""
    t_bytes = (P * rows * cols * 5 + P * rows * 8) / PEAK_BYTES_S
    t_ops = P * rows * cols * QUANT_FLOPS_PER_PIXEL / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class LaunchTimer:
    """Times every call of a module-level launcher with CUDA events while
    installed (the launch count stays in the launcher)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.events = []

    def __enter__(self):
        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.orig(*args, **kwargs)
            b.record()
            self.events.append((a, b))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events]


def build_all() -> float:
    """Phase 1: one nvcc per kernel source, all started together."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_build.load, n)
                  for n in ("backproject", "quant")]:
            f.result()
    return time.perf_counter() - t0


def check_kernel(geom, dev, rng):
    """Phase 2: the float32 kernel against the plain version at full
    width, and its times.  Returns the problem for phase 2b too."""
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.phantom import forward_project

    L = geom.L
    idx = np.linspace(0, geom.n_proj - 1, N_CHECK + N_REMAINDER).astype(int)
    raw = forward_project(geom, angles=geom.angles[idx], device=dev)
    imgs = filter_projections(raw, geom, angle_indices=idx, device=dev)
    mats = torch.tensor(projection_matrices(geom)[idx], device=dev)
    vol0 = torch.tensor(rng.standard_normal((L, L, L), dtype=np.float32),
                        device=dev)
    problem = (imgs, mats, vol0)
    return problem, check_wire(geom, problem, "float32")


def check_wire(geom, problem, wire):
    """The kernel on ``wire`` against its plain version (P = 8 plus a
    P = 5 remainder, and P = 1), then its times at P = 1, 4, 8 on the
    stack the wrapper puts on the wire, and the plain version's at
    P = 4."""
    from repro_torch.core.backproject import GeomStatic
    from repro_torch.kernels import backproject_batch, backproject_one
    from repro_torch.kernels.backproject import launch_backproject
    from repro_torch.kernels.backproject_ref import (backproject_batch_ref,
                                                     backproject_padded_ref,
                                                     decode_wire)
    from repro_torch.kernels.quant import launch_quantize_rows

    imgs, mats, vol0 = problem
    gs = GeomStatic.of(geom)
    L = geom.L
    errs = []

    def compare(name, out, ref):
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        top = float(ref.abs().max())
        print(f"  {wire} {name}: max|d| {err:.3e}  max|ref| {top:.4f}  "
              f"bound {TOL_KERNEL * max(1.0, top):.3e}")
        if not err <= TOL_KERNEL * max(1.0, top):
            fail(f"{wire} kernel disagrees with its plain version ({name})")
        errs.append(err)

    # P = 8, then the 5-projection remainder: one wrapper call, two
    # launches.
    out = backproject_batch(vol0.clone(), imgs, mats, geom, pbatch=N_CHECK,
                            strip_dtype=wire)
    ref = vol0.clone()
    backproject_batch_ref(ref, imgs[:N_CHECK], mats[:N_CHECK], gs,
                          wire=wire)
    backproject_batch_ref(ref, imgs[N_CHECK:], mats[N_CHECK:], gs,
                          wire=wire)
    compare(f"P={N_CHECK} + remainder P={N_REMAINDER}", out, ref)
    del out, ref
    one = backproject_one(vol0.clone(), imgs[3], mats[3], geom,
                          strip_dtype=wire)
    ref = backproject_batch_ref(vol0.clone(), imgs[3:4], mats[3:4], gs,
                                wire=wire)
    compare("P=1 (backproject_one)", one, ref)
    del one, ref

    # Kernel times at the main path's shapes, P = 4 (the engine's fold)
    # and 8, and P = 1; launched on the wire stack the wrapper builds.
    padded = F.pad(imgs, (1, 1, 1, 1)).contiguous()
    rows, cols = padded.shape[1:]
    scales = None
    if wire == "bfloat16":
        padded = padded.to(torch.bfloat16)
    elif wire == "int8":
        padded, scales = launch_quantize_rows(padded)
    work = vol0.clone()
    timing = {}
    for P in (1, PBATCH, N_CHECK):
        ms = time_ms(lambda: launch_backproject(
            work, padded[:P], mats[:P], z0=0, O=gs.O, MM=gs.MM,
            scales=None if scales is None else scales[:P]), reps=10)
        bms, by = bound_ms(L, L, P, rows, cols, wire)
        timing[P] = (ms, bms, by)
        print(f"  {wire} kernel P={P}: {ms:.4f} ms per launch; bound "
              f"{bms:.4f} ms ({by}); {L ** 3 * P / (ms / 1e3) / 1e9:.2f} "
              f"GUPS")
    # The plain version on the kernel's own inputs: on a narrow wire it
    # decodes the stack already on the wire (the encode is not timed).
    plain_ms = {}
    for P in ((1, PBATCH) if wire == "float32" else (PBATCH,)):
        if wire == "float32":
            def plain():
                backproject_batch_ref(work, imgs[:P], mats[:P], gs)
        else:
            def plain():
                backproject_padded_ref(
                    work, decode_wire(padded[:P], None if scales is None
                                      else scales[:P]), mats[:P], gs)
        plain_ms[P] = time_ms(plain, reps=2)
        print(f"  {wire} plain P={P}: {plain_ms[P]:.2f} ms")
    del work, padded, scales
    torch.cuda.empty_cache()
    return max(errs), timing, plain_ms


def check_quant(problem):
    """Phase 2b: the row encoder against its plain version, bitwise, on
    the filtered 13-view full-width stack; its times per engine fold
    (P = 4) and per served chunk (31 views)."""
    from repro_torch.kernels.quant import launch_quantize_rows
    from repro_torch.quant import quantize_rows, quantize_rows_ref

    imgs = problem[0]
    padded = F.pad(imgs, (1, 1, 1, 1)).contiguous()
    P, rows, cols = padded.shape
    got = quantize_rows(padded)
    torch.cuda.synchronize()
    want = quantize_rows_ref(padded)
    err = 0.0
    for name, a, b in zip(("codes", "scale", "offset"), got, want):
        diff = int((a != b).sum())
        d = float((a.float() - b.float()).abs().max())
        print(f"  quantize_rows {name}: {diff} of {a.numel()} differ from "
              f"the plain version (max|d| {d})")
        if diff:
            fail(f"row encoder {name} differ from the plain version")
        err = max(err, d)
    chunk = padded.repeat(-(-CHUNK // P), 1, 1)[:CHUNK].contiguous()
    timing = {}
    for n, stack in ((PBATCH, padded[:PBATCH].contiguous()),
                     (CHUNK, chunk)):
        ms = time_ms(lambda: launch_quantize_rows(stack), reps=10)
        bms, by = quant_bound_ms(n, rows, cols)
        timing[n] = (ms, bms, by)
        print(f"  quantize_rows P={n}: {ms:.4f} ms per launch; bound "
              f"{bms:.4f} ms ({by})")
    plain = time_ms(lambda: quantize_rows_ref(padded[:PBATCH]), reps=2)
    print(f"  quantize_rows plain P={PBATCH}: {plain:.2f} ms")
    del padded, chunk
    return err, timing, plain


async def _client(fd, projs, mats, tenant, seed):
    from repro_torch.streaming import ProjectionChunk

    n = projs.shape[0]
    ticket = await fd.open_scan(tenant=tenant, n_proj=n)
    order = np.random.default_rng(seed).permutation(n)
    for c0 in range(0, n, CHUNK):
        idx = np.sort(order[c0:c0 + CHUNK])
        sel = torch.as_tensor(idx, device=projs.device)
        await fd.submit(ticket, ProjectionChunk(projs[sel], mats[idx], idx))
    return await fd.result(ticket)


def serve_two(geom, dev, projs, mats, **engine_opts):
    """Two full scans from two tenants in shuffled chunks through the
    front door; every back-projection and encoder launch timed.
    Returns the volumes, the engine, the timers and the wall time."""
    import repro_torch.kernels.backproject_ops as ops
    from repro_torch.api import CTFrontDoor, ReconstructionEngine
    from repro_torch.kernels import LAUNCHES

    engine = ReconstructionEngine(geom, n_slots=2, pbatch=PBATCH,
                                  device=dev, **engine_opts)
    fd = CTFrontDoor(geom, engine=engine, max_pending=4, policy="fair")

    async def both():
        return await asyncio.gather(_client(fd, projs, mats, "clinic-a", 1),
                                    _client(fd, projs, mats, "clinic-b", 2))

    with LaunchTimer(ops, "launch_backproject") as kern, \
            LaunchTimer(ops, "launch_quantize_rows") as enc:
        torch.cuda.synchronize()
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        t0 = time.perf_counter()
        vols = asyncio.run(both())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    print(f"  served 2 scans in {wall:.3f} s; launches {launches}, engine "
          f"stats {engine.stats}")
    for v in vols:
        if v.shape != (geom.L,) * 3 or not bool(torch.isfinite(v).all()):
            fail("served volume is not a finite (L, L, L) volume")
    return vols, engine, launches, kern.ms(), enc.ms(), wall


def serve(geom, dev, projs, mats, filt):
    """Phase 3: two full scans on the float32 wire (``scalar``)."""
    from repro_torch.core.backproject import reconstruct
    from repro_torch.core.phantom import voxelize
    from repro_torch.core.quality import psnr, roi_mask

    vols, engine, launches, per_launch, _, wall = serve_two(
        geom, dev, projs, mats)
    folds = engine.stats["fold_launches"]
    n = launches["backproject"]
    if n != folds or n != 2 * -(-geom.n_proj // PBATCH):
        fail(f"{n} kernel launches for {folds} engine folds")
    one_shot = reconstruct(filt, mats, geom, pbatch=PBATCH, device=dev)
    ref = voxelize(geom, device=dev)
    mask = roi_mask(geom.L, device=dev)
    scores = []
    for v in vols:
        top = float(v.abs().max())
        err = float((v - one_shot).abs().max())
        print(f"  streamed vs one-shot: max|d| {err:.3e} (bound "
              f"{TOL_STREAM * top:.3e})")
        if not err <= TOL_STREAM * top:
            fail("served volume disagrees with the one-shot reconstruction")
        scores.append(psnr(v, ref, mask))
    print(f"  ROI PSNR vs voxelized phantom: {scores}")
    if min(scores) < MIN_PSNR_DB:
        fail(f"ROI PSNR {min(scores):.2f} dB < {MIN_PSNR_DB} dB")
    return n, per_launch, wall, scores, vols[0], ref, mask


def check_envelope(name, vq, v32, ref, mask, wire):
    from repro_torch.core.quality import psnr

    p_min, drop_max = WIRE_ENVELOPE[wire]
    vs32 = psnr(vq, v32, mask)
    drop = psnr(v32, ref, mask) - psnr(vq, ref, mask)
    print(f"  {name}: ROI PSNR vs float32 {vs32:.2f} dB (> {p_min}); "
          f"phantom-PSNR drop {drop:.4f} dB (|drop| < {drop_max})")
    if not (vs32 > p_min and abs(drop) < drop_max):
        fail(f"{name} leaves the {wire} wire's quality envelope")
    return vs32, drop


def serve_wire(geom, dev, projs, mats, filt, v32, ref, mask):
    """Phase 4: two full scans on the int8 wire (``strip2``), and one
    one-shot reconstruction on the bfloat16 wire."""
    import repro_torch.kernels.backproject_ops as ops
    from repro_torch.core.backproject import reconstruct, validate_strip_opts
    from repro_torch.kernels import LAUNCHES

    # On the card the engine runs no host window check (the kernel reads
    # taps directly); time it here on a few matrices, on the host's clock.
    opts = {"strip_dtype": "int8"}
    t0 = time.perf_counter()
    validate_strip_opts(geom, mats[::geom.n_proj // N_VALIDATE][:N_VALIDATE],
                        "strip2", opts)
    host_s = time.perf_counter() - t0
    print(f"  host window check of {N_VALIDATE} matrices (strip2 "
          f"defaults): {host_s:.2f} s on the host")
    vols, engine, launches, kern_ms, enc_ms, wall = serve_two(
        geom, dev, projs, mats, strategy="strip2", **opts)
    folds = engine.stats["fold_launches"]
    if not (launches["backproject_int8"] == folds
            == 2 * -(-geom.n_proj // PBATCH)):
        fail(f"{launches['backproject_int8']} int8 kernel launches for "
             f"{folds} engine folds")
    if launches["quantize_rows"] != folds or launches["backproject"]:
        fail(f"expected one encode per fold and no float32 launch: "
             f"{launches}")
    # Each served int8 volume against the one-shot int8 reconstruction
    # of the same projections: the codes are per image, so only the
    # summation order differs.  The envelope is the quality floor.
    one_shot = reconstruct(filt, mats, geom, strategy="strip2",
                           pbatch=PBATCH, device=dev, **opts)
    for i, v in enumerate(vols):
        top = float(v.abs().max())
        err = float((v - one_shot).abs().max())
        print(f"  int8 served scan {i} vs int8 one-shot: max|d| {err:.3e} "
              f"(bound {TOL_STREAM * top:.3e})")
        if not err <= TOL_STREAM * top:
            fail("served int8 volume disagrees with the int8 one-shot "
                 "reconstruction")
    scores = [check_envelope(f"int8 served scan {i}", v, v32, ref, mask,
                             "int8") for i, v in enumerate(vols)]
    del vols, one_shot

    with LaunchTimer(ops, "launch_backproject") as kern16:
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        t0 = time.perf_counter()
        v16 = reconstruct(filt, mats, geom, strategy="strip2",
                          strip_dtype="bfloat16", pbatch=PBATCH,
                          device=dev)
        torch.cuda.synchronize()
        wall16 = time.perf_counter() - t0
        launches16 = dict(LAUNCHES)
    if launches16["backproject_bf16"] != -(-geom.n_proj // PBATCH) \
            or not bool(torch.isfinite(v16).all()):
        fail(f"bfloat16 one-shot: launches {launches16}, or a non-finite "
             f"volume")
    print(f"  bfloat16 one-shot: {wall16:.3f} s wall, launches "
          f"{launches16}")
    score16 = check_envelope("bfloat16 one-shot", v16, v32, ref, mask,
                             "bfloat16")
    return {"launches": launches, "kern_ms": kern_ms, "enc_ms": enc_ms,
            "wall": wall, "scores": scores, "host_check_s": host_s,
            "launches16": launches16, "kern16_ms": kern16.ms(),
            "wall16": wall16, "score16": score16}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(_SRC))
    try:
        from repro_torch.core.geometry import Geometry
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = build_all()
    print(f"phase 1: built the backproject and quant kernels in "
          f"{build_s:.2f} s")
    record = run(Geometry(), torch.device("cuda", 0), card, build_s)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(geom, dev, card: str, build_s: float) -> dict:
    """Phases 2-4 on ``geom``; prints the details and returns the
    ``kernels`` record."""
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.phantom import forward_project

    print(f"phase 2: kernel vs plain at L={geom.L}, "
          f"{geom.n_u}x{geom.n_v} detector")
    problem, (err, timing, plain_ms) = check_kernel(
        geom, dev, np.random.default_rng(SEED))

    print("phase 2b: the bfloat16 and int8 wires, and the row encoder")
    wires = {w: check_wire(geom, problem, w) for w in ("bfloat16", "int8")}
    q_err, q_timing, q_plain = check_quant(problem)
    del problem
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    projs = forward_project(geom, device=dev)
    mats = projection_matrices(geom)
    filt = torch.cat([filter_projections(
        projs[i:i + CHUNK], geom, angle_indices=np.arange(i, i + CHUNK),
        device=dev) for i in range(0, geom.n_proj, CHUNK)])
    torch.cuda.synchronize()
    print(f"  forward projection and filter of {geom.n_proj} views: "
          f"{time.perf_counter() - t0:.2f} s")

    print(f"phase 3: CTFrontDoor -> ReconstructionEngine -> kernel, "
          f"{geom.n_proj} views per scan, pbatch={PBATCH}, float32 wire")
    launches, per_launch, wall, scores, v32, ref, mask = serve(
        geom, dev, projs, mats, filt)
    med = statistics.median(per_launch)
    kern_s = sum(per_launch) / 2 / 1e3          # per scan
    gups = geom.L ** 3 * geom.n_proj / kern_s / 1e9
    bms, by = timing[PBATCH][1], timing[PBATCH][2]
    print(f"  served kernel time per launch: median {med:.4f} ms, "
          f"min {min(per_launch):.4f}, max {max(per_launch):.4f} "
          f"({len(per_launch)} launches); bound {bms:.4f} ms ({by})")
    print(f"  per scan: kernel {kern_s:.4f} s = {gups:.2f} GUPS; wall "
          f"{wall / 2:.3f} s per scan with 2 in flight")

    print("phase 4: the same two scans on the int8 wire (strip2), and a "
          "bfloat16 one-shot")
    w = serve_wire(geom, dev, projs, mats, filt, v32, ref, mask)
    med8 = statistics.median(w["kern_ms"])
    enc_med = statistics.median(w["enc_ms"])
    kern8_s = sum(w["kern_ms"]) / 2 / 1e3
    enc_s = sum(w["enc_ms"]) / 2 / 1e3
    med16 = statistics.median(w["kern16_ms"])
    print(f"  int8 served: kernel median {med8:.4f} ms per launch "
          f"({len(w['kern_ms'])} launches), encoder median {enc_med:.4f} "
          f"ms per launch ({len(w['enc_ms'])} launches)")
    print(f"  int8 per scan: kernel {kern8_s:.4f} s, encoder {enc_s:.4f} "
          f"s; wall {w['wall'] / 2:.3f} s per scan with 2 in flight "
          f"(float32: {wall / 2:.3f} s)")
    print(f"  bfloat16 one-shot: kernel median {med16:.4f} ms per launch")

    # No single PyTorch call computes any of these kernels: grid_sample
    # has no 1/w^2 weight and no accumulation into the volume, and no
    # library call runs the error-feedback encode.
    src = "src/repro_torch/kernels/csrc/"
    k = []
    for name, wire, launches_, ms, werr, wt, wplain in (
            ("backproject_batch", "float32", launches, med, err, timing,
             plain_ms),
            ("backproject_batch_bf16", "bfloat16",
             w["launches16"]["backproject_bf16"], med16,
             *wires["bfloat16"]),
            ("backproject_batch_int8", "int8",
             w["launches"]["backproject_int8"], med8, *wires["int8"])):
        k.append({"name": name, "route": "cuda",
                  "source": src + "backproject.cu",
                  "replaces": ("src/repro/kernels/backproject.py:548"
                               if wire == "float32" else
                               "src/repro/kernels/backproject.py:141"),
                  "launches": launches_, "max_abs_err": werr, "ms": ms,
                  "plain_ms": wplain[PBATCH], "bound_ms": wt[PBATCH][1],
                  "bound_by": wt[PBATCH][2], "library_ms": None})
    k.append({"name": "quantize_rows", "route": "cuda",
              "source": src + "quant.cu", "replaces": "src/repro/quant.py:95",
              "launches": w["launches"]["quantize_rows"],
              "max_abs_err": q_err, "ms": enc_med, "plain_ms": q_plain,
              "bound_ms": q_timing[PBATCH][1],
              "bound_by": q_timing[PBATCH][2], "library_ms": None})
    print(json.dumps({"detail": {
        "card": card, "build_s": build_s,
        "kernel_ms_by_P": {wr: {str(p): t[0] for p, t in tm.items()}
                           for wr, tm in (("float32", timing),
                                          ("bfloat16", wires["bfloat16"][1]),
                                          ("int8", wires["int8"][1]))},
        "bound_ms_by_P": {wr: {str(p): [t[1], t[2]] for p, t in tm.items()}
                          for wr, tm in (("float32", timing),
                                         ("bfloat16", wires["bfloat16"][1]),
                                         ("int8", wires["int8"][1]))},
        "plain_ms_by_P": {"float32": plain_ms,
                          "bfloat16": wires["bfloat16"][2],
                          "int8": wires["int8"][2]},
        "quant_ms": {str(p): t[0] for p, t in q_timing.items()},
        "quant_bound_ms": {str(p): [t[1], t[2]] for p, t in q_timing.items()},
        "quant_plain_ms_P4": q_plain,
        "served_f32": {"launch_ms_median": med, "wall_s_2_scans": wall,
                       "kernel_s_per_scan": kern_s, "gups": gups,
                       "roi_psnr_db": scores},
        "served_int8": {"launch_ms_median": med8,
                        "encode_ms_median": enc_med,
                        "wall_s_2_scans": w["wall"],
                        "kernel_s_per_scan": kern8_s,
                        "encode_s_per_scan": enc_s,
                        "psnr_vs_f32_and_drop": w["scores"],
                        "host_window_check_s": w["host_check_s"]},
        "one_shot_bf16": {"launch_ms_median": med16, "wall_s": w["wall16"],
                          "psnr_vs_f32_and_drop": w["score16"]}}}))
    return {"kernels": k}


if __name__ == "__main__":
    sys.exit(main())
