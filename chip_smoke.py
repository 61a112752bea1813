"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version at full RabbitCT width (L = 512,
1248 x 960 detector), then serves two full 496-projection scans through
``CTFrontDoor`` -> ``ReconstructionEngine`` -> the kernel and checks the
volumes.  Any failed check exits non-zero.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it the JSON
record of every kernel of the path.  Needs one CUDA card; imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
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
# taps' fractions, the bilinear blend, the 1/w^2 weight, the add).
FLOPS_PER_VOXEL = 6
FLOPS_PER_VOXEL_PROJ = 37

SEED = 0
N_CHECK = 8               # projections of the full-width kernel check
N_REMAINDER = 5           # plus a remainder batch
CHUNK = 31                # projections per served chunk
PBATCH = 4                # the engine's default fold depth
TOL_KERNEL = 1e-5         # x max(1, max|ref|): fp32 order and FMA slack
TOL_STREAM = 1e-4         # x max|v|: streamed vs one-shot, arrival order
MIN_PSNR_DB = 15.0        # an all-zero volume scores ~11 dB here


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(L: int, nz: int, P: int, rows: int, cols: int):
    """Least time for one launch: the larger of bytes over HBM rate (volume
    read and written once, each image and matrix read once) and FLOPs over
    the FP32 peak."""
    vox = nz * L * L
    nbytes = 2 * vox * 4 + P * rows * cols * 4 + P * 48
    flops = vox * (FLOPS_PER_VOXEL + FLOPS_PER_VOXEL_PROJ * P)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
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


def check_kernel(geom, dev, rng):
    """Phase 2: kernel against the plain version at full width."""
    from repro_torch.core.backproject import GeomStatic
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.phantom import forward_project
    from repro_torch.kernels import backproject_batch, backproject_one
    from repro_torch.kernels.backproject import launch_backproject
    from repro_torch.kernels.backproject_ref import backproject_batch_ref

    gs = GeomStatic.of(geom)
    L = geom.L
    idx = np.linspace(0, geom.n_proj - 1, N_CHECK + N_REMAINDER).astype(int)
    raw = forward_project(geom, angles=geom.angles[idx], device=dev)
    imgs = filter_projections(raw, geom, angle_indices=idx, device=dev)
    mats = torch.tensor(projection_matrices(geom)[idx], device=dev)
    vol0 = torch.tensor(rng.standard_normal((L, L, L), dtype=np.float32),
                        device=dev)
    errs = {}

    def compare(name, out, ref):
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        top = float(ref.abs().max())
        print(f"  {name}: max|d| {err:.3e}  max|ref| {top:.4f}  "
              f"bound {TOL_KERNEL * max(1.0, top):.3e}")
        if not err <= TOL_KERNEL * max(1.0, top):
            fail(f"kernel disagrees with its plain version ({name})")
        errs[name] = err

    # P = 8, then the 5-projection remainder: one wrapper call, two
    # launches.
    out = backproject_batch(vol0.clone(), imgs, mats, geom, pbatch=N_CHECK)
    ref = vol0.clone()
    backproject_batch_ref(ref, imgs[:N_CHECK], mats[:N_CHECK], gs)
    backproject_batch_ref(ref, imgs[N_CHECK:], mats[N_CHECK:], gs)
    compare(f"P={N_CHECK} + remainder P={N_REMAINDER}", out, ref)
    del out, ref
    one = backproject_one(vol0.clone(), imgs[3], mats[3], geom)
    ref = backproject_batch_ref(vol0.clone(), imgs[3:4], mats[3:4], gs)
    compare("P=1 (backproject_one)", one, ref)
    del one, ref

    # Kernel times at the main path's shapes, P = 4 (the engine's fold)
    # and 8, and P = 1; launched on the padded stack the wrapper builds.
    rows, cols = geom.n_v + 2, geom.n_u + 2
    padded = F.pad(imgs, (1, 1, 1, 1)).contiguous()
    work = vol0.clone()
    timing = {}
    for P in (1, PBATCH, N_CHECK):
        ms = time_ms(lambda: launch_backproject(
            work, padded[:P], mats[:P], z0=0, O=gs.O, MM=gs.MM), reps=10)
        bms, by = bound_ms(L, L, P, rows, cols)
        timing[P] = (ms, bms, by)
        print(f"  kernel P={P}: {ms:.4f} ms per launch; bound {bms:.4f} ms "
              f"({by}); {L ** 3 * P / (ms / 1e3) / 1e9:.2f} GUPS")
    plain_ms = {}
    for P in (1, PBATCH):
        plain_ms[P] = time_ms(lambda: backproject_batch_ref(
            work, imgs[:P], mats[:P], gs), reps=2)
        print(f"  plain P={P}: {plain_ms[P]:.2f} ms")
    del work, vol0, padded
    torch.cuda.empty_cache()
    return max(errs.values()), timing, plain_ms


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


def serve(geom, dev):
    """Phase 3: two full scans from two tenants through the front door."""
    import repro_torch.kernels.backproject_ops as ops
    from repro_torch.api import CTFrontDoor, ReconstructionEngine
    from repro_torch.core.backproject import reconstruct
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.phantom import forward_project, voxelize
    from repro_torch.core.quality import psnr, roi_mask
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    projs = forward_project(geom, device=dev)
    mats = projection_matrices(geom)
    torch.cuda.synchronize()
    print(f"  forward projection of {geom.n_proj} views: "
          f"{time.perf_counter() - t0:.2f} s")

    # Time every launch of the served run with CUDA events, around the
    # launcher the wrapper calls (the count stays in the launcher).
    events = []
    launch = ops.launch_backproject

    def timed_launch(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(*args, **kwargs)
        b.record()
        events.append((a, b))
        return out

    engine = ReconstructionEngine(geom, n_slots=2, pbatch=PBATCH,
                                  device=dev)
    fd = CTFrontDoor(geom, engine=engine, max_pending=4, policy="fair")

    async def both():
        return await asyncio.gather(_client(fd, projs, mats, "clinic-a", 1),
                                    _client(fd, projs, mats, "clinic-b", 2))

    ops.launch_backproject = timed_launch
    try:
        torch.cuda.synchronize()
        LAUNCHES["backproject"] = 0
        t0 = time.perf_counter()
        vols = asyncio.run(both())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES["backproject"]
    finally:
        ops.launch_backproject = launch
    per_launch = [a.elapsed_time(b) for a, b in events]
    folds = engine.stats["fold_launches"]
    print(f"  served 2 scans in {wall:.3f} s; kernel launches {launches}, "
          f"engine folds {folds}, stats {engine.stats}")
    if launches != folds or launches != 2 * -(-geom.n_proj // PBATCH):
        fail(f"{launches} kernel launches for {folds} engine folds")

    one_shot = reconstruct(
        torch.cat([filter_projections(projs[i:i + CHUNK], geom,
                                      angle_indices=np.arange(i, i + CHUNK),
                                      device=dev)
                   for i in range(0, geom.n_proj, CHUNK)]),
        mats, geom, pbatch=PBATCH, device=dev)
    del projs
    ref = voxelize(geom, device=dev)
    mask = roi_mask(geom.L, device=dev)
    scores = []
    for v in vols:
        if v.shape != (geom.L,) * 3 or not bool(torch.isfinite(v).all()):
            fail("served volume is not a finite (L, L, L) volume")
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
    return launches, per_launch, wall, scores


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(_SRC))
    try:
        from repro_torch.core.geometry import Geometry
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load("backproject")
    print(f"phase 1: built the backproject kernel in "
          f"{time.perf_counter() - t0:.2f} s")

    geom = Geometry()
    print(f"phase 2: kernel vs plain at L={geom.L}, "
          f"{geom.n_u}x{geom.n_v} detector")
    err, timing, plain_ms = check_kernel(geom, dev,
                                         np.random.default_rng(SEED))

    print(f"phase 3: CTFrontDoor -> ReconstructionEngine -> kernel, "
          f"{geom.n_proj} views per scan, pbatch={PBATCH}")
    launches, per_launch, wall, scores = serve(geom, dev)
    med = statistics.median(per_launch)
    kern_s = sum(per_launch) / 2 / 1e3          # per scan
    gups = geom.L ** 3 * geom.n_proj / kern_s / 1e9
    bms, by = timing[PBATCH][1], timing[PBATCH][2]
    print(f"  served kernel time per launch: median {med:.4f} ms, "
          f"min {min(per_launch):.4f}, max {max(per_launch):.4f} "
          f"({len(per_launch)} launches); bound {bms:.4f} ms ({by})")
    print(f"  per scan: kernel {kern_s:.4f} s = {gups:.2f} GUPS; wall "
          f"{wall / 2:.3f} s per scan with 2 in flight")

    record = {"kernels": [{
        "name": "backproject_batch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/backproject.cu",
        "replaces": "src/repro/kernels/backproject.py:548",
        "launches": launches,
        "max_abs_err": err,
        "ms": med,
        "plain_ms": plain_ms[PBATCH],
        "bound_ms": bms,
        "bound_by": by,
        # No single PyTorch call computes it: grid_sample has no 1/w^2
        # weight and no accumulation into the volume.
        "library_ms": None,
    }]}
    print(json.dumps({"detail": {
        "card": card, "kernel_ms_by_P": {str(p): t[0]
                                         for p, t in timing.items()},
        "bound_ms_by_P": {str(p): t[1] for p, t in timing.items()},
        "plain_ms_by_P": {str(p): t for p, t in plain_ms.items()},
        "served_launch_ms_median": med, "served_wall_s_2_scans": wall,
        "kernel_s_per_scan": kern_s, "gups": gups, "roi_psnr_db": scores}}))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
