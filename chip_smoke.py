"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (the
back projection, with one instance per projection wire, the int8 row
encoder, and the strip-staged kernels K3 ``strip_db``, K4
``strip_micro`` and K5 ``strip_shared``) and holds each against its
plain PyTorch version at full RabbitCT width (L = 512, 1248 x 960
detector).  Then it serves two full 496-projection scans through
``CTFrontDoor`` -> ``ReconstructionEngine`` -> the kernel on the float32
wire, two more on the int8 wire (``strategy="strip2"``), runs one
one-shot reconstruction on the bfloat16 wire, checks the strip planner
on the card against a numpy copy and times it over all 496 matrices,
serves two scans with ``strategy="auto"`` (in-situ selection from an
empty tune directory, then a cache hit), folds a full scan through each
strip kernel as a tuned plan names it, and checks every volume.  Then
the language-model path: the row gather (``csrc/gather.cu``) and the
sLSTM recurrence (``csrc/slstm.cu``) against their plain versions at
xlstm-125m's widths, and xlstm-125m served at full width (bfloat16,
seeded weights) through ``ServingEngine`` with ``gather_impl="take"``
and ``"onehot"`` (the greedy tokens must agree), a prefill in bfloat16
and in float32 with its sLSTM launches held to the plain recurrence on
their inputs and its logits and whole cache to the same model on the
plain versions, and one 8 x 2048 forward.  Then chatglm3-6b (dense GQA
attention, RoPE 2d, the SwiGLU MLP) at its published widths in bfloat16
from a seed: the row gather at its 65024 x 4096 table, 8 greedy requests
served with ``take`` and ``onehot`` (equal tokens, row 9 launched once a
prefill and decode call) beside the weight-bytes floor of a decode call
and the profiled device time of one, a prefill bitwise equal under both
gathers, a 2 x 2048 forward on the chunked attention path; the same
widths cut to 4 layers in float32 for three checks that each see a
planted fault (decode against forward, chunked against dense attention,
the int8 KV cache within the reference's bounds); and whisper-small and
qwen2-vl-2b at full width (prefill and decode, finite logits).  Then
jamba-v0.1-52b (Mamba and attention, MoE on every second block) at its
published widths cut to one period of 8 layers, bfloat16 from a seed:
served with ``take`` and ``onehot`` (equal greedy tokens, row 9 at its
65536 x 4096 table once a prefill and decode call) beside its
weight-bytes floor and the profiled device time of a decode call, a
prefill bitwise under both gathers (the Mamba states included), a
2 x 2048 forward (the scan in 8 chunks with carries); one Mamba mixer
and one MoE layer at its widths in float32 for three checks that each
see a planted fault (steps against forward, chunked against one chunk,
scatter against einsum where assignments drop); and qwen3-moe-235b-a22b
(2 layers) and kimi-k2-1t-a32b (1 layer) at full width (prefill and
decode, finite logits).  Last, the sharded CT path at full RabbitCT
width on phase 3's data: ``reconstruct_shards`` on the two z-halves
bitwise equal to ``reconstruct`` (float32 and int8 wires),
``sharded_reconstruct`` on a 1x1 NCCL mesh bitwise equal to the one-card
path, one scan served through ``CTFrontDoor(mesh=...)``, and four
processes on the one card as a 2x2 gloo mesh, each slab within 1e-5 x
max|v| of the one-rank volume.  Last, training (phase 15): the backward
kernels of the row gather (``d table``, row 9b) and of the sLSTM
recurrence (``d zifo``, ``d r``, row 10b) against autograd through their
plain versions, each bound made to see a planted fault; xlstm-125m
trained at full width through ``python -m repro_torch.launch.train``
(the loss falls, checkpoints kept), through the API with the one-hot
gather (rows 9, 9b, 10, 10b launched every step), a preemption drill
that resumes bitwise, and one float32 step with the kernels against the
same step on the plain versions; and chatglm3-6b trained at full width
through the launcher's defaults.  Last, the LM stack under a mesh
(phase 16): the launcher on its 1x1 mesh, every loss bitwise the
no-mesh path's; xlstm-125m on two gloo ranks (data=2, parameters and
moments split) against one rank, rows 9, 9b, 10, 10b launched on each
rank, the checkpoint restored on one rank bitwise; chatglm3-6b (float32)
under flash-decoding over a sequence-split KV cache and
qwen3-moe-235b-a22b (2 layers) under manual expert parallelism, each
held to one rank's plain run.  Last, tensor and sequence parallelism
(phase 17, gloo ranks on the one card): chatglm3-6b at full width in
float32 on a (1, 2) ``tp`` mesh, four prompts' prefills and eight
decode steps each against one rank (and in bfloat16 its greedy tokens'
agreement), with the bytes, collectives and ms each rank takes;
xlstm-125m trained on a (2, 2) mesh (``tp`` on ``model``) against 16b's
one-rank runs, rows 9, 9b, 10 and 10b launched on every rank at the
split shapes and held there to their plain versions; jamba-v0.1-52b one
period deep in float32 under ``tp=ep``; chatglm3-6b at 4 layers under
``sp_act``, its logits, loss and gradient norm against one rank;
whisper-small (float32, its vocabulary whole on each rank, its heads
split) on (1, 2) and xlstm-125m (bfloat16, its mLSTM whole, its sLSTM
at 192 units) on (1, 8), where ``tp`` does not divide some widths, each
against one rank (17e, 17f); then the four kernels timed at a rank's
shapes.  Last, the analysis tools
(phase 18): ``python -m repro_torch.analysis.lint`` on this checkout
(four passes, exit 0) and on a planted fixture (exit 1), one served
chatglm3-6b decode call traced op by op (each kernel op counted as its
launches, the roofline's memory term beside the weight-bytes floor and
the call's profiled device time), a row-1 fold whose traced byte term
is its bound, one dry-run cell on fake tensors, and every cell of
xlstm-125m, qwen2-vl-2b and whisper-small on both production meshes
(none an error).  Any failed check
exits non-zero.  The
last line of standard output is
``{"ok": true, "device": {...}}``; the line before it the JSON record of
every kernel of the path.  Needs one CUDA card; imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

_SRC = pathlib.Path(__file__).resolve().parent / "src"

# The card's peaks and each kernel's operations and bytes (the bound
# column's terms) live in repro_torch/analysis/census.py: census().
L2_BYTES = 50 * 2**20
SMEM_PER_SM = 228 * 1024    # shared memory an SM gives its blocks

# Bytes per element of each projection wire.
WIRE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}

SEED = 0
N_CHECK = 8               # projections of the full-width kernel check
N_REMAINDER = 5           # plus a remainder batch
CHUNK = 31                # projections per served chunk
PBATCH = 4                # the engine's default fold depth
# Row 1 at odd shapes (phase 2): L off the kernel's 32 x 8 block, a slab
# from plane ODD_Z0 of ODD_NZ planes (off its 8-voxel z run).
ODD_L, ODD_Z0, ODD_NZ, ODD_PS = 37, 5, 13, (1, 3, 8)
# Row 1's ms per launch at L = 512 before its z-run design (one voxel
# per thread), as PERF.md's kernel table records them, printed beside
# this run's.
EARLIER_ROW1_MS = {("float32", 1): 1.0145, ("float32", 4): 2.8314,
                   ("bfloat16", 4): 2.8011, ("int8", 4): 3.3302}
TOL_STREAM = 1e-4         # x max|v|: streamed vs one-shot, arrival order
MIN_PSNR_DB = 15.0        # an all-zero volume scores ~11 dB here
# Narrow wires against the float32 volume: (min ROI PSNR, max drop of
# the phantom PSNR), the reference's envelope for each wire.
WIRE_ENVELOPE = {"bfloat16": (40.0, 0.5), "int8": (35.0, 1.0)}
N_VALIDATE = 4            # matrices put through the host window check
# The reference tuner's base tile (ty, chunk), at which the planner is
# timed over all matrices.  The strip kernels run at the first of
# STRIP_TILES whose windows, sized by the planner over all matrices, fit
# a block (K3's 4-deep float32 ring of windows, K5's float32 boxes of
# N_CHECK views and of every PBATCH group of the scan).  One-line
# tiles: the planner merges the strip origins of a tile's lines,
# inactive lines included, so at L = 512 an 8-line tile needs a strip as
# wide as the detector.
STRIP_TILE = (8, 32)
STRIP_TILES = ((1, 128), (1, 64), (1, 32))
# (LAUNCHES key, TPU kernel replaced, wrapper keywords) of each strip
# kernel configuration the smoke run checks.
STRIP_VARIANTS = (
    ("strip_db", "db2", dict(double_buffer=True, db_depth=2)),
    ("strip_db", "db4", dict(double_buffer=True, db_depth=4)),
    ("strip_micro", "micro", dict(micro=True, micro_group=8, micro_band=8,
                                  micro_width=32)),
    ("strip_shared", "shared", dict(shared_window=True)),
)


# The language-model phases (9-11): xlstm-125m at its published widths.
LM_ARCH = "xlstm-125m"
GATHER_NS = (4, 512, 8192)          # a decode tick, a prompt, a long batch
GATHER_RETIME_N = 512               # row 9 against F.embedding, with spread
SLSTM_SHAPES = ((1, 1), (4, 1), (1, 512), (8, 512), (8, 2048))   # (B, S)
# A long memory: (B, S, the forget pre-activations' shift), a forget
# gate of 1 - 6e-6.
SLSTM_LONG = (8, 2048, 12.0)
SLSTM_TOL = 2e-4         # rtol = atol: the reference's kernel test's
LM_SLOTS, LM_MAX_LEN = 4, 1024
LM_REQUESTS, LM_MAX_TOKENS = 8, 32
LM_PROMPT = (64, 512)               # prompt lengths, inclusive
LM_FORWARD = (8, 2048)
# bfloat16 model, kernels against plain versions on the card: the
# reference's bf16 bound for prefill against decode (2e-2), x max(1,
# max|logits|).
LM_LOGIT_TOL = 2e-2
# A prefill's whole decode cache on the kernels against the same model on
# the plain versions, max |d| / (1 + |ref|) over every leaf, by the
# model's dtype.  float32: SLSTM_TOL.  bfloat16 (the served model): any
# kernel that is not bitwise its plain version moves the cache by 5e-2 to
# 1.3e-1, h off by 1e-7 as much as by 1e-2 (a bf16 rounding flips and
# spreads over 12 layers; tools/prefill_cache_sweep.py), so only a gross
# fault can be bounded there.  Each bound must see its fault: the plain
# recurrence with h off by the factor 1 + LM_CACHE_FAULT has to break it.
LM_CACHE_TOL = {"float32": SLSTM_TOL, "bfloat16": 0.2}
LM_CACHE_FAULT = {"float32": 1e-3, "bfloat16": 0.1}

# Phase 12: chatglm3-6b at its published widths (dense GQA, RoPE 2d), and
# the other attention families.
GLM_ARCH = "chatglm3-6b"
GLM_GATHER_NS = (4, 512)            # phase 9 at its table: a decode call, a prompt
GLM_FORWARD = (2, 2048)             # > attn_chunk: the chunked path
GLM_DEPTH = 4                       # 12c: a depth cut, float32
GLM_DECODE_N = 300                  # 12c: the prompt before the decode
# 12c, max |d| / (1 + |ref|) of the logits: a decode step against forward
# at its position (float32 throughout), and the chunked path against the
# dense, the reference's own 2e-3 (tests/test_gather_and_layers.py).
GLM_DECODE_TOL = 1e-3
GLM_CHUNK_TOL = 2e-3
# 12c, the int8 KV cache against the model's own after a prefill and two
# decode steps: tests/test_kv_int8.py's bounds, over KV_INT8_B rows.
KV_INT8_REL, KV_INT8_AGREE, KV_INT8_B = 0.15, 0.5, 8
WHISPER_FRAMES = 1000               # <= attn_chunk: dense (1500 raises)
VL_GRID, VL_TEXT = 16, 64           # a 16 x 16 patch grid, 64 text tokens
LM_DECODE_STEPS = 4                 # 12d, 13e

# Phase 13: jamba-v0.1-52b at its published widths, one period deep (all
# 32 layers are 102.90 GB in bf16, more than the card's 80 GB; one period
# holds every block kind and both FFN kinds), and the MoE families.
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_DEPTH = 8
JAMBA_FORWARD = (2, 2048)           # 8 chunks of the scan, with carries
# 13d, float32, one mixer / one MoE layer at jamba's widths: max |d| / (1
# + |ref|).  A prefill of MAMBA_SPLIT[0] tokens then MAMBA_SPLIT[1] steps
# against one forward over both (the recurrence stepped against the
# doubling scan), and MAMBA_CHUNKS_S tokens in chunks of 256 against one
# chunk: the reference's scan tolerance, 2e-4.  scatter against einsum
# on MOE_TOKENS tokens at capacity_factor MOE_CF (so that assignments
# drop): the reference's own 1e-4 (tests/test_moe.py).
MAMBA_SPLIT, MAMBA_B = (500, 12), 2
MAMBA_CHUNKS_S = 2048
MAMBA_TOL = 2e-4
MOE_TOKENS, MOE_CF, MOE_TOL = 512, 0.5, 1e-4
# 13e: (architecture, depth cut); 94 and 61 layers do not fit one card.
MOE_FAMILIES = (("qwen3-moe-235b-a22b", 2), ("kimi-k2-1t-a32b", 1))

# The sharded path (phase 14): 14d's mesh, four processes on the one
# card over gloo (NCCL refuses two ranks on one device), each rank's
# slab held to the one-rank volume within SHARD_TOL * max|v| (the
# reference's sharded bound, tests/test_distributed.py).
SHARD_MESH = (2, 2)                 # (data, model)
SHARD_TOL = 1e-5
SHARD_TIMEOUT_S = 240
MOE_PROMPT = 64

# Phase 15: training.  15a, the backward kernels against their plain
# versions: row 10b at di = d_inner from a fresh state, at the main
# path's (8, 64) (the launcher's batch and sequence) and the shapes
# below, within the forward's SLSTM_TOL; a plain gradient with d r or
# d zifo off by the factor 1 + TRAIN_FAULT must break that bound.  Row
# 9b at xlstm-125m's and chatglm3-6b's tables, bf16 and f32: float32
# equal to the float32 sum in the kernel's order, bfloat16 within one
# bfloat16 ulp of it; the sum with one repeated id dropped must break
# both.
TRAIN_SHAPE = (8, 64)               # the launcher's --batch, --seq
TRAIN_SLSTM_SHAPES = ((8, 64), (4, 1), (1, 512), (8, 2048))
TRAIN_GATHER_NS = (4, 512, 8192)
TRAIN_FAULT = 1e-3
# 15a also holds each backward at its edges.  Row 10b, the chunked scan
# (W warps a block, chunks of T tokens): S = T - 1, T, T + 1, W T, W T +
# 1 at B = 1, each within SLSTM_TOL and the same bits twice.  Row 9b, at
# (V, D, N, ids): no ids, one id, one run of 512, every id out of range,
# N at the one-block limit and one over (torch.sort's path), V off a
# multiple of 32, D itemsize off a multiple of 16: bitwise the plain
# version, twice, through the path the launcher names.
TRAIN_GATHER_EDGES = (("n0", 300, 64, 0), ("n1", 300, 64, 1),
                      ("one_run", 1000, 768, 512), ("all_out", 100, 64, 64),
                      ("at_limit", 50304, 64, None),
                      ("above_limit", 50304, 64, None),
                      ("v_odd", 1007, 128, 300), ("d_odd", 500, 7, 200))
# 15b: xlstm-125m through the launcher (TRAIN_STEPS, logged at 0, 10,
# 20), through the API with onehot (TRAIN_API_STEPS, launches counted
# per step), the preemption drill (DRILL_STEPS, preempted at
# DRILL_PREEMPT, a checkpoint every DRILL_SAVE_EVERY), and one step of
# the model cut to CHECK_PERIODS periods in float32, kernels against
# the plain versions: every gradient leaf within SLSTM_TOL of the
# leaf's largest.
TRAIN_STEPS = 21
TRAIN_API_STEPS = 20
DRILL_STEPS, DRILL_PREEMPT, DRILL_SAVE_EVERY = 8, (4, 7), 3
CHECK_PERIODS = 2
# 15c: chatglm3-6b through the launcher's defaults, GLM_TRAIN_STEPS
# steps, no checkpoint.
GLM_TRAIN_STEPS = 3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def census():
    """The port's census module (``repro_torch.analysis.census``): the
    card's peaks and each kernel's operations and bytes, the terms of
    every bound here and of the kernel ops' flop formulas."""
    from repro_torch.analysis import census as c
    return c


def bound_ms(L: int, nz: int, P: int, rows: int, cols: int,
             wire: str = "float32"):
    """Least time for one back-projection launch: the larger of bytes over
    HBM rate (volume read and written once, each image, scale block and
    matrix read once) and FLOPs over the FP32 peak."""
    c = census()
    return c.bound_ms(*c.backproject_terms(L, nz, P, rows, cols, wire))


def quant_bound_ms(P: int, rows: int, cols: int):
    """Least time of one row-encoder launch: pixels read as float32 and
    written as int8 once, and the (P, 2, rows) block written once."""
    c = census()
    return c.bound_ms(*c.quant_terms(P, rows, cols))


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
    sources = ("backproject", "quant", "backproject_strip", "gather",
               "slstm")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(_build.load, n) for n in sources]:
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


def odd_case(dev):
    """Row 1's odd shapes: ``(geom, images, mats, slab)`` at L = ODD_L
    with 8 random views, view 2's u row widened three-fold (taps off the
    detector) and view 5's w row crossing 0 mid-volume (w <= 1e-6), and
    a random ODD_NZ-plane slab."""
    from repro_torch.core.geometry import Geometry, projection_matrices

    geom = Geometry().scaled(ODD_L, n_proj=8)
    rng = np.random.default_rng(SEED + 3)
    mats = np.array(projection_matrices(geom), np.float64)
    mats[2, 0] *= 3.0
    centre = geom.O + (ODD_L - 1) / 2 * geom.MM
    mats[5, 2, 3] = -mats[5, 2, :3].sum() * centre
    images = rng.standard_normal((8, geom.n_v, geom.n_u), dtype=np.float32)
    slab = rng.standard_normal((ODD_NZ, ODD_L, ODD_L), dtype=np.float32)
    return (geom, torch.tensor(images, device=dev),
            torch.tensor(mats.astype(np.float32), device=dev),
            torch.tensor(slab, device=dev))


def check_wire(geom, problem, wire):
    """The kernel on ``wire`` against its plain version, max|d| = 0 (P = 8
    plus a P = 5 remainder, P = 1, and the odd shapes of
    :func:`odd_case` at P = 1, 3, 8), then its times at P = 1, 4, 8 on
    the stack the wrapper puts on the wire, and the plain version's at
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
              f"(must be 0)")
        if not torch.equal(out, ref):
            fail(f"{wire} kernel differs from its plain version ({name})")
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
    geom_odd, imgs_odd, mats_odd, slab = odd_case(imgs.device)
    for P in ODD_PS:
        out = backproject_batch(slab.clone(), imgs_odd, mats_odd, geom_odd,
                                pbatch=P, z0=ODD_Z0, strip_dtype=wire)
        ref = backproject_batch_ref(slab.clone(), imgs_odd, mats_odd,
                                    GeomStatic.of(geom_odd), z0=ODD_Z0,
                                    wire=wire)
        compare(f"L={ODD_L} z0={ODD_Z0} nz={ODD_NZ} P={P}", out, ref)

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
        was = EARLIER_ROW1_MS.get((wire, P))
        print(f"  {wire} kernel P={P}: {ms:.4f} ms per launch; bound "
              f"{bms:.4f} ms ({by}); {L ** 3 * P / (ms / 1e3) / 1e9:.2f} "
              f"GUPS; one voxel per thread: "
              + ("not recorded" if was is None else f"{was:.4f} ms"))
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
    the filtered 13-view full-width stack and on a stack off its tiles in
    both modes; its times per engine fold (P = 4) and per served chunk
    (31 views)."""
    from repro_torch.kernels.quant import launch_quantize_rows
    from repro_torch.quant import quantize_rows, quantize_rows_ref

    imgs = problem[0]
    padded = F.pad(imgs, (1, 1, 1, 1)).contiguous()
    P, rows, cols = padded.shape
    # Off the encoder's 32-row block and 64-column tile: random, zero,
    # constant and one-signed rows.
    odd = torch.tensor(np.random.default_rng(SEED + 4).standard_normal(
        (3, 37, 131), dtype=np.float32) * 3, device=padded.device)
    odd[0, 0] = 0.0
    odd[0, 1] = 2.5
    odd[1, 2] = odd[1, 2].abs()
    odd[2, 3] = -odd[2, 3].abs()
    err = 0.0
    for label, x, symmetric in (("full width", padded, False),
                                ("(3, 37, 131)", odd, False),
                                ("(3, 37, 131) symmetric", odd, True)):
        got = quantize_rows(x, symmetric=symmetric)
        torch.cuda.synchronize()
        want = quantize_rows_ref(x, symmetric=symmetric)
        for name, a, b in zip(("codes", "scale", "offset"), got, want):
            diff = int((a != b).sum())
            d = float((a.float() - b.float()).abs().max())
            print(f"  quantize_rows {label} {name}: {diff} of {a.numel()} "
                  f"differ from the plain version (max|d| {d})")
            if diff:
                fail(f"row encoder {name} differ from the plain version "
                     f"({label})")
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


# ----------------------------------------------------------------------
# The strip planner on the card (phase 5)
# ----------------------------------------------------------------------

def np_plan_strips(geom, A, chunk):
    """A numpy copy of the strip planner (the port's algorithm, which is
    the reference's), for the card's planner to be held against:
    ``(r0, c0, active, required_band, required_width)``."""
    A = np.asarray(A, np.float64)
    L = geom.L
    wcoord = geom.O + np.arange(L, dtype=np.float64) * geom.MM
    wy, wz, w0 = wcoord[None, :, None], wcoord[:, None, None], geom.O
    p = [(A[i, 0] * w0 + A[i, 1] * wy + A[i, 2] * wz + A[i, 3])[..., 0]
         for i in range(3)]
    q = [A[i, 0] * geom.MM for i in range(3)]
    (pu, pv, pw), (qu, qv, qw) = p, q

    def halfline(lo, hi, a, b):
        with np.errstate(divide="ignore", invalid="ignore"):
            root = -a / b
        lo2 = np.where(b > 0, np.maximum(lo, root), lo)
        hi2 = np.where(b < 0, np.minimum(hi, root), hi)
        dead = (b == 0) & (a <= 0)
        return np.where(dead, np.inf, lo2), np.where(dead, -np.inf, hi2)

    lo, hi = np.full(pu.shape, -np.inf), np.full(pu.shape, np.inf)
    for a, b in ((pw - 1e-6, qw), (pu + pw, qu + qw),
                 (geom.n_u * pw - pu, geom.n_u * qw - qu),
                 (pv + pw, qv + qw), (geom.n_v * pw - pv,
                                      geom.n_v * qw - qv)):
        lo, hi = halfline(lo, hi, a, np.full_like(pw, b))
    x0 = np.clip(np.ceil(lo), 0, L).astype(np.int32)
    x1 = np.maximum(np.clip(np.floor(hi) + 1, 0, L).astype(np.int32), x0)
    xs = np.arange(L // chunk) * chunk
    fx0 = x0[..., None].astype(np.float64)
    fx1 = x1[..., None].astype(np.float64)
    xa = np.maximum(xs[None, None, :].astype(np.float64), fx0)
    xb = np.maximum(np.minimum((xs + chunk - 1)[None, None, :]
                               .astype(np.float64), fx1 - 1.0), xa)

    def coords(xq):
        u, v = pu[..., None] + qu * xq, pv[..., None] + qv * xq
        w = pw[..., None] + qw * xq
        w = np.where(np.abs(w) < 1e-12, 1e-12, w)
        return (np.clip(u / w, -1.0, float(geom.n_u)),
                np.clip(v / w, -1.0, float(geom.n_v)))

    (ca, ra), (cb, rb) = coords(xa), coords(xb)
    c_lo = np.floor(np.minimum(ca, cb))
    c_hi = np.floor(np.maximum(ca, cb)) + 1
    r_lo = np.floor(np.minimum(ra, rb))
    r_hi = np.floor(np.maximum(ra, rb)) + 1
    active = (np.minimum(fx1, (xs + chunk)[None, None, :].astype(np.float64))
              > np.maximum(fx0, xs[None, None, :].astype(np.float64)))
    req_b = int(np.max(np.where(active, r_hi - r_lo, 0)) + 2)
    req_w = int(np.max(np.where(active, c_hi - c_lo, 0)) + 2)
    band = max(8, (req_b + 7) // 8 * 8)
    width = max(128, (req_w + 127) // 128 * 128)
    r0 = np.clip(r_lo + 1 - 1, 0, geom.n_v + 2 - band).astype(np.int32)
    c0 = np.clip(c_lo + 1 - 1, 0, geom.n_u + 2 - width).astype(np.int32)
    return r0, c0, active, req_b, req_w


def check_planner(geom, dev):
    """Phase 5: the strip planner on the card equals its numpy copy on 4
    matrices (strip origins, active chunks, requirements, at the strip
    kernels' chunk and at strip2's group=8), and its time for all the
    scan's matrices."""
    from repro_torch.core import clipping
    from repro_torch.core.geometry import projection_matrices

    mats = projection_matrices(geom)
    sel = mats[::geom.n_proj // N_VALIDATE][:N_VALIDATE]
    out = {}
    for chunk in (STRIP_TILE[1], 8):
        t_card = t_host = 0.0
        for A in sel:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = clipping.plan_strips(geom, A, chunk, device=dev)
            torch.cuda.synchronize()
            t_card += time.perf_counter() - t0
            t0 = time.perf_counter()
            r0, c0, active, rb, rw = np_plan_strips(geom, A, chunk)
            t_host += time.perf_counter() - t0
            same = (np.array_equal(plan.r0.cpu().numpy(), r0)
                    and np.array_equal(plan.c0.cpu().numpy(), c0)
                    and np.array_equal(plan.active.cpu().numpy(), active)
                    and (plan.required_band, plan.required_width)
                    == (rb, rw))
            if not same:
                fail(f"the planner on the card disagrees with its numpy "
                     f"copy (chunk={chunk})")
        print(f"  chunk={chunk}: card planner equals the numpy copy on "
              f"{len(sel)} matrices; {t_card / len(sel) * 1e3:.1f} ms per "
              f"matrix on the card (one at a time), {t_host / len(sel):.2f}"
              f" s per matrix for numpy on the host")
        out[f"per_matrix_chunk{chunk}"] = {"card_s": t_card / len(sel),
                                           "host_numpy_s": t_host / len(sel)}
    for chunk, ty, what in ((STRIP_TILE[1], STRIP_TILE[0],
                             "the strip kernels' tile"),
                            (8, 1, "strip2's group=8")):
        clipping._NEEDS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        needs = clipping.strip_needs(geom, mats, chunk=chunk, ty=ty,
                                     device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  all {len(mats)} matrices at chunk={chunk}, ty={ty} "
              f"({what}): {dt:.2f} s on the card; needs up to "
              f"{tuple(int(n) for n in needs.max(axis=0))}")
        out[f"all_chunk{chunk}_ty{ty}_s"] = dt
    return out


# ----------------------------------------------------------------------
# The strip kernels against their plain versions (phase 6)
# ----------------------------------------------------------------------

def strip_problem(geom, dev, rng):
    """N_CHECK consecutive views around the mid angle (a projection group
    as a fold sees one), filtered, with their matrices, and a random
    volume."""
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.phantom import forward_project

    k0 = geom.n_proj // 2 - N_CHECK // 2
    idx = np.arange(k0, k0 + N_CHECK)
    raw = forward_project(geom, angles=geom.angles[idx], device=dev)
    imgs = filter_projections(raw, geom, angle_indices=idx, device=dev)
    mats = torch.tensor(projection_matrices(geom)[idx], device=dev)
    vol0 = torch.tensor(rng.standard_normal((geom.L,) * 3,
                                            dtype=np.float32), device=dev)
    return imgs, mats, vol0


def strip_tiling(geom, dev, mats):
    """The strip kernels' tile (the first of STRIP_TILES whose K3 ring of
    windows, and K5's boxes, fit a block) and their strip there: every
    matrix's need, rounded up to 8 rows and 32 columns."""
    from repro_torch.core import clipping
    from repro_torch.core.backproject import GeomStatic
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels.backproject import SMEM_LIMIT, strip_smem_bytes
    from repro_torch.kernels.backproject_ops import (clamp_tiles,
                                                     shared_window_dims)
    from repro_torch.kernels.backproject_ref import padded_dims

    gs = GeomStatic.of(geom)
    all_mats = projection_matrices(geom)
    for ty, chunk in STRIP_TILES:
        if geom.L % chunk:
            continue
        nb, nw = clipping.strip_needs(geom, all_mats, chunk=chunk, ty=ty,
                                      device=dev).max(axis=0)
        band, width = int(-(-nb // 8) * 8), int(-(-nw // 32) * 32)
        k3 = strip_smem_bytes("db", PBATCH, ty=ty, chunk=chunk, band=band,
                              width=width, itemsize=4, depth=4)
        msg = (f"  tile ({ty}, {chunk}): strip ({band}, {width}); shared "
               f"memory per block: K3 depth 4 {k3} B")
        if k3 > SMEM_LIMIT:
            print(f"{msg} (of {SMEM_LIMIT})")
            continue
        sizes = [k3]
        for group, P in ((mats, len(mats)), (all_mats, PBATCH)):
            b, w = shared_window_dims(geom, group, ty=ty, chunk=chunk,
                                      pbatch=P, device=dev)
            _, _, b, w = clamp_tiles(gs, ty, chunk, b, w)
            pr, pc = padded_dims(gs, b, w, 4)
            slot = int(clipping.shared_box_slots(
                gs, group, ty=ty, chunk=chunk, band=b, width=w, pad_rows=pr,
                pad_cols=pc, itemsize=4, pbatch=P, device=dev).max())
            sizes.append(strip_smem_bytes("shared", P, ty=ty, chunk=chunk,
                                          band=b, width=w, itemsize=4,
                                          slot=slot))
        print(f"{msg}, K5 boxes of {len(mats)} views {sizes[1]} B, of "
              f"every {PBATCH}-view group {sizes[2]} B (of {SMEM_LIMIT})")
        if max(sizes) <= SMEM_LIMIT:
            return (ty, chunk), (band, width)
    fail("no strip tile's windows fit a block")


def base_window(geom, dev):
    """The planner's window at the reference's base tile STRIP_TILE over
    every matrix, rounded up to 8 rows and 32 columns (clamped into the
    padded detector): too wide for a ring of windows, while the boxes the
    kernels stage there are small."""
    from repro_torch.core import clipping
    from repro_torch.core.backproject import GeomStatic
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels.backproject_ops import clamp_tiles

    ty, chunk = STRIP_TILE
    nb, nw = clipping.strip_needs(geom, projection_matrices(geom),
                                  chunk=chunk, ty=ty, device=dev).max(axis=0)
    _, _, band, width = clamp_tiles(GeomStatic.of(geom), ty, chunk,
                                    int(-(-nb // 8) * 8),
                                    int(-(-nw // 32) * 32))
    return band, width


def box_bytes(geom, mats, tile, window, wire):
    """Bytes K3/K4 stage per voxel and projection over every tile of
    every z-plane of ``mats``: the mean and the largest box
    (``clipping.corner_boxes`` in the kernels' layout, whole 16-byte
    units per row), and the whole window as a kernel staging windows
    would copy it (4-byte words per row)."""
    import repro_torch.kernels.backproject_ref as R
    from repro_torch.core import clipping
    from repro_torch.core.backproject import GeomStatic

    gs = GeomStatic.of(geom)
    ty, chunk = tile
    band, width = window
    isz = WIRE_BYTES[wire]
    pr, pc = R.padded_dims(gs, band, width, isz)
    total, n, big = 0.0, 0, 0
    for A in mats:
        rows, units = clipping.box_slot_dims(clipping.corner_boxes(
            gs, A[None], ty=ty, chunk=chunk, band=band, width=width,
            pad_rows=pr, pad_cols=pc), isz)
        b = rows * units * 16
        total += float(b.sum(dtype=torch.float64))
        n += b.numel()
        big = max(big, int(b.max()))
    vox = ty * chunk
    return {"mean": total / n / vox, "largest": big / vox,
            "window": band * ((width * isz + 3) // 4 + 1) * 4 / vox}


def check_strip(geom, problem, tile, window, variants=STRIP_VARIANTS):
    """Phase 6: each of ``variants`` (K3 at depth 2 and 4, K4, K5) at
    L = 512 on each wire at P = 1, 4 and 8, each through the wrapper
    (which checks every window with the planner first) against its plain
    version on the same wire stack, max |d| = 0, and on float32 against
    row 1 too; the bytes K3/K4 stage per voxel and projection, each
    launch's slot (K5: its tiles' packed boxes) and bytes per block, and
    the count of boxes a slot cut, which must be 0; then each kernel's
    time per launch, and its plain version's."""
    import repro_torch.kernels.backproject_ref as R
    from repro_torch.core import clipping
    from repro_torch.core.backproject import GeomStatic
    from repro_torch.kernels import backproject_batch
    from repro_torch.kernels.backproject import (SMEM_LIMIT,
                                                 launch_backproject,
                                                 launch_strip, pitch_stack,
                                                 reset_strip_clamped,
                                                 strip_clamped,
                                                 strip_smem_bytes)
    from repro_torch.kernels.backproject_ops import (clamp_tiles,
                                                     shared_window_dims)
    from repro_torch.kernels.quant import launch_quantize_rows

    imgs, mats, vol0 = problem
    gs = GeomStatic.of(geom)
    L = geom.L
    ty, chunk = tile
    band, width = window
    dev = imgs.device
    plain_fn = {"strip_db": R.backproject_strip_ref,
                "strip_micro": R.backproject_micro_ref,
                "strip_shared": R.backproject_shared_ref}
    res = {}
    for wire in ("float32", "bfloat16", "int8"):
        padded = F.pad(imgs, (1, 1, 1, 1)).contiguous()
        rows, cols = padded.shape[1:]
        scales = None
        if wire == "bfloat16":
            padded = padded.to(torch.bfloat16)
        elif wire == "int8":
            padded, scales = launch_quantize_rows(padded)
        values = R.decode_wire(padded, scales)
        pitched = pitch_stack(padded)
        staged = box_bytes(geom, mats, tile, window, wire)
        print(f"  tile {tile}, window {window}, {wire}: K3/K4 stage "
              f"{staged['mean']:.2f} B per voxel and projection (mean box), "
              f"{staged['largest']:.2f} (largest box); the whole window "
              f"{staged['window']:.2f}")
        for key, label, flags in variants:
            kind = key[len("strip_"):]
            for P in (1, PBATCH, N_CHECK):
                if key == "strip_shared":
                    b, w = shared_window_dims(
                        geom, mats[:P], ty=ty, chunk=chunk, pbatch=P,
                        device=dev)
                    _, _, b, w = clamp_tiles(gs, ty, chunk, b, w)
                else:
                    b, w = band, width
                pr, pc = R.padded_dims(gs, b, w, WIRE_BYTES[wire])
                win = dict(ty=ty, chunk=chunk, band=b, width=w,
                           pad_rows=pr, pad_cols=pc)
                extra = {}
                if kind == "db":
                    extra = {"depth": flags["db_depth"]}
                elif kind == "micro":
                    extra = {"group": flags["micro_group"],
                             "gband": flags["micro_band"],
                             "gwidth": flags["micro_width"]}
                if kind == "shared":
                    slot = int(clipping.shared_box_slots(
                        gs, mats[:P], itemsize=WIRE_BYTES[wire], **win)[0])
                else:
                    slot = tuple(int(n) for n in clipping.strip_box_slots(
                        gs, mats[:P], itemsize=WIRE_BYTES[wire],
                        **win).max(axis=0))
                smem = strip_smem_bytes(
                    kind, P, ty=ty, chunk=chunk, band=b, width=w,
                    itemsize=WIRE_BYTES[wire], slot=slot,
                    **({"depth": extra["depth"]} if kind == "db" else {}))
                if smem > SMEM_LIMIT:
                    fail(f"{label} {wire} P={P} at tile {tile}: {smem} B of "
                         f"shared memory per block")
                reset_strip_clamped()
                out = backproject_batch(
                    vol0.clone(), imgs[:P], mats[:P], geom, pbatch=P,
                    strip_dtype=wire, ty=ty, chunk=chunk,
                    **({} if kind == "shared" else dict(band=b, width=w)),
                    **flags)
                ref = vol0.clone()
                a_ev = torch.cuda.Event(enable_timing=True)
                b_ev = torch.cuda.Event(enable_timing=True)
                a_ev.record()
                plain_fn[key](ref, values[:P], mats[:P], gs, **win,
                              **({} if kind != "micro" else
                                 dict(group=extra["group"],
                                      gband=extra["gband"],
                                      gwidth=extra["gwidth"])))
                b_ev.record()
                b_ev.synchronize()
                plain_ms = a_ev.elapsed_time(b_ev)
                err = float((out - ref).abs().max())
                del ref
                err1 = None
                if wire == "float32":
                    row1 = vol0.clone()
                    launch_backproject(row1, padded[:P].contiguous(),
                                       mats[:P].contiguous(), z0=0,
                                       O=gs.O, MM=gs.MM)
                    err1 = float((out - row1).abs().max())
                    del row1
                del out
                work = vol0.clone()
                ms = time_ms(lambda: launch_strip(
                    work, pitched[:P].contiguous(), mats[:P].contiguous(),
                    kind=kind, z0=0, O=gs.O, MM=gs.MM, n_u=gs.n_u,
                    n_v=gs.n_v,
                    scales=None if scales is None else scales[:P]
                    .contiguous(), slot=slot, **win, **extra), reps=5)
                del work
                clamped = strip_clamped(dev)
                bms, by = bound_ms(L, L, P, rows, cols, wire)
                print(f"  {label} {wire} P={P} (band {b}, width {w}; "
                      + (f"slot of packed boxes {slot * 16} B"
                         if kind == "shared" else
                         f"slot {slot[0]} x {slot[1] * 16} B")
                      + f", {smem} B per block, {clamped} boxes cut"
                      + f"): max|d| vs plain {err:.1e}"
                      + ("" if err1 is None else
                         f", vs row 1 {err1:.1e}")
                      + f"; {ms:.4f} ms per launch (bound {bms:.4f}, "
                      f"{by}); plain {plain_ms:.1f} ms")
                if err != 0.0 or (err1 is not None and err1 != 0.0):
                    fail(f"{label} on {wire} at P={P} differs from its "
                         f"plain version or from row 1")
                if clamped:
                    fail(f"{label} on {wire} at P={P}: {clamped} boxes "
                         f"cut by their slot")
                res[(label, wire, P)] = {"err": err, "err_row1": err1,
                                         "ms": ms, "plain_ms": plain_ms,
                                         "bound_ms": bms, "bound_by": by,
                                         "band": b, "width": w,
                                         "slot": slot, "smem": smem,
                                         "clamped": clamped,
                                         "staged_B": staged}
        del padded, values, pitched, scales
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# strategy="auto", served (phase 7)
# ----------------------------------------------------------------------

def serve_auto(geom, dev, projs, mats, filt):
    """Phase 7: ``CTFrontDoor(strategy="auto")`` from an empty tune
    directory: in-situ selection at L = 512 (every candidate's windows
    checked over all 496 matrices on the card's planner), two full scans
    served on the winner, each held to a one-shot on the same plan; a
    second front door resolves from the cache with no sweep."""
    import repro_torch.kernels.backproject_ops as ops
    from repro_torch.api import CTFrontDoor, Dispatcher, set_dispatcher
    from repro_torch.core.backproject import reconstruct
    from repro_torch.kernels import LAUNCHES
    from repro_torch.tune.sweep import sweep_strategies

    tune = tempfile.mkdtemp(prefix="repro_torch_tune_")
    os.environ["REPRO_TORCH_TUNE_DIR"] = tune
    sweeps = []

    def sweep(g, **kw):
        res = sweep_strategies(g, device=dev, **kw)
        sweeps.append(res)
        return res

    set_dispatcher(Dispatcher(sweep_fn=sweep))
    timers = [LaunchTimer(ops, n) for n in ("launch_backproject",
                                            "launch_strip",
                                            "launch_quantize_rows")]
    for t in timers:
        t.__enter__()
    try:
        torch.cuda.synchronize()
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        t0 = time.perf_counter()
        fd = CTFrontDoor(geom, n_slots=2, max_pending=4, policy="fair",
                         strategy="auto", device=dev)
        torch.cuda.synchronize()
        select_s = time.perf_counter() - t0
        selection = dict(LAUNCHES)
        n_timed = [len(t.events) for t in timers]

        async def both():
            return await asyncio.gather(
                _client(fd, projs, mats, "clinic-a", 3),
                _client(fd, projs, mats, "clinic-b", 4))

        t0 = time.perf_counter()
        vols = asyncio.run(both())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        for t in timers:
            t.__exit__()
    serve_ms = [ms for t, n in zip(timers, n_timed) for ms in t.ms()[n:]]
    engine = fd._backend.engine
    plan = engine.exec_plan
    res = sweeps[0]
    print(f"  in-situ selection: {select_s:.2f} s wall, "
          f"{len(res.timings)} candidates timed, {len(res.skipped)} "
          f"skipped; launches {dict((k, v) for k, v in selection.items() if v)}")
    for t in sorted(res.timings, key=lambda t: t.us_per_call):
        print(f"    {t.us_per_call:10.1f} us/projection  {t.label}")
    for label, reason in res.skipped:
        print(f"    skipped {label}: {reason[:160]}")
    kernel = plan.pallas_opts() if plan.use_pallas else None
    print(f"  winner: {plan.label}; "
          + (f"folds through the tuned kernel config {kernel}"
             if kernel else "row 1 (no strip kernel beat the strategies)"))
    for v in vols:
        if v.shape != (geom.L,) * 3 or not bool(torch.isfinite(v).all()):
            fail("auto-served volume is not a finite (L, L, L) volume")
    folds = engine.stats["fold_launches"]
    served = {k: launches[k] - selection[k] for k in launches}
    print(f"  served 2 scans in {wall:.3f} s; launches while serving "
          f"{dict((k, v) for k, v in served.items() if v)}; engine stats "
          f"{engine.stats}")
    if folds != 2 * -(-geom.n_proj // engine.pbatch):
        fail(f"{folds} folds for 2 scans at pbatch={engine.pbatch}")
    if sum(v for k, v in served.items() if k != "quantize_rows") != folds:
        fail(f"served launches {served} do not match {folds} folds")
    if plan.use_pallas and engine.stats["pallas_folds"] != 2 * geom.n_proj:
        fail("the tuned kernel did not fold every projection")
    # Every kernel the sweep timed was launched by it.
    from repro_torch.core.backproject import GeomStatic, strip_wire_dtype
    from repro_torch.kernels.backproject import (WIRE_LAUNCH_KEYS,
                                                 strip_launch_key)
    from repro_torch.kernels.backproject_ops import resolve_variant

    for t in res.timings:
        opts = dict(t.opts)
        if t.strategy != "pallas":
            continue
        wire = strip_wire_dtype(opts.get("strip_dtype", "float32")) \
            or torch.float32
        variant = resolve_variant(GeomStatic.of(geom), **opts)["variant"]
        key = (WIRE_LAUNCH_KEYS[wire] if variant is None else
               strip_launch_key(variant, wire, int(opts.get("pbatch", 1))))
        if not selection[key]:
            fail(f"the sweep timed {t.label} but never launched {key}")
    one_shot = reconstruct(filt, mats, geom, plan=plan, device=dev)
    errs = []
    for i, v in enumerate(vols):
        top = float(v.abs().max())
        err = float((v - one_shot).abs().max())
        errs.append(err)
        print(f"  auto-served scan {i} vs one-shot on the same plan: "
              f"max|d| {err:.3e} (bound {TOL_STREAM * top:.3e})")
        if not err <= TOL_STREAM * top:
            fail("auto-served volume disagrees with the one-shot "
                 "reconstruction on the same plan")
    del one_shot, vols
    n_sweeps = len(sweeps)
    t0 = time.perf_counter()
    fd2 = CTFrontDoor(geom, n_slots=1, policy="fair", strategy="auto",
                      device=dev)
    hit_s = time.perf_counter() - t0
    if len(sweeps) != n_sweeps or fd2._backend.engine.exec_plan != plan:
        fail("a second auto front door did not resolve from the cache")
    print(f"  second front door: cache hit in {hit_s:.3f} s, no sweep, "
          f"same plan")
    del fd2, fd, engine
    torch.cuda.empty_cache()
    return {"select_s": select_s, "wall_s_2_scans": wall,
            "winner": plan.label, "kernel": kernel,
            "timings": [t.as_dict() for t in res.timings],
            "skipped": res.skipped, "selection_launches": selection,
            "served_launches": served, "served_launch_ms": serve_ms,
            "vs_one_shot": errs, "cache_hit_s": hit_s}


# ----------------------------------------------------------------------
# Each strip kernel as a tuned plan folds it (phase 8)
# ----------------------------------------------------------------------

def serve_tuned(geom, dev, mats, filt, v32, tile, window):
    """Phase 8: a full scan folded through each strip kernel as a tuned
    decision names it (``reconstruct(plan=...)`` with the kernel config
    in the plan's ``pallas`` field and ``use_pallas``), at P = 4 and, for
    K3 and K4, P = 1 (TPU kernel rows 7 and 8); and through row 1 at
    P = 1 (row 2).  Each volume is held to the float32 served volume of
    phase 3, and each kernel launched once per batch."""
    from repro_torch.api import ExecutionPlan
    from repro_torch.core.backproject import reconstruct
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.backproject import (reset_strip_clamped,
                                                 strip_clamped)

    ty, chunk = tile
    band, width = window
    cases = [("backproject", 1, None)]
    for key, label, flags in STRIP_VARIANTS:
        if label == "db4":
            continue
        cases.append((key, PBATCH, flags))
        if key != "strip_shared":
            cases.append((key + "_p1", 1, flags))
    out = {}
    for key, P, flags in cases:
        plan = ExecutionPlan.explicit("scalar", pbatch=P)
        if flags is not None:
            tile = dict(ty=ty, chunk=chunk, pbatch=P, **flags)
            if "shared_window" not in flags:
                tile.update(band=band, width=width)
            plan = plan._replace(pallas=tuple(sorted(tile.items())),
                                 use_pallas=True)
        torch.cuda.synchronize()
        reset_strip_clamped()
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        v = reconstruct(filt, mats, geom, plan=plan, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = LAUNCHES[key]
        clamped = strip_clamped(dev)
        top = float(v32.abs().max())
        err = float((v - v32).abs().max())
        print(f"  {key} (P={P}): {n} launches, {wall:.2f} s for "
              f"{geom.n_proj} views ({1e3 * wall / max(n, 1):.3f} ms per "
              f"launch), {clamped} boxes cut; vs the served float32 volume "
              f"max|d| {err:.3e} (bound {TOL_STREAM * top:.3e})")
        if clamped:
            fail(f"{key}: {clamped} boxes cut by their slot")
        if n != -(-geom.n_proj // P) or sum(LAUNCHES.values()) != n:
            fail(f"{key}: {dict(LAUNCHES)} launches for one scan at P={P}")
        if not err <= TOL_STREAM * top:
            fail(f"{key}: the scan disagrees with the served volume")
        out[key] = {"launches": n, "wall_s": wall,
                    "ms_per_launch": 1e3 * wall / max(n, 1), "err": err,
                    "P": P, "clamped": clamped}
        del v
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# The language-model path (phases 9-11)
# ----------------------------------------------------------------------

@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` is ``fn`` while inside."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def per_call_ms(fn, inner: int, reps: int = 5) -> float:
    """ms per call of ``fn``: the median over ``reps`` CUDA-event timings
    of ``inner`` calls back to back."""
    def many():
        for _ in range(inner):
            fn()
    return time_ms(many, reps) / inner


def device_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """ms per call of ``fn`` on the device alone: the median of
    :func:`device_times`."""
    return statistics.median(device_times(fn, inner, reps))


def device_times(fn, inner: int = 20, reps: int = 5) -> list[float]:
    """``reps`` timings, in ms per call, of ``fn`` on the device alone:
    the card first spins (``torch.cuda._sleep``) while the host enqueues
    ``inner`` calls between two CUDA events, so the events time the
    kernels back to back and not the host's launch rate.  The spin is
    doubled until the host finished enqueueing before the card reached
    the first event."""
    fn()
    torch.cuda.synchronize()
    spin, times = 4_000_000, []
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        if a.query():               # the card waited for the host
            b.synchronize()
            spin *= 2
            if spin > 2**31:
                fail("the host could not enqueue ahead of the card")
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return times


def gather_bound(N: int, D: int, itemsize: int, inside: int | None = None):
    """Row 9's least time: the ids read, the rows written, and the rows
    whose ids fall in the table read once."""
    c = census()
    return c.bound_ms(*c.gather_terms(N, D, itemsize, inside))


def gather_grad_bound(N: int, V: int, D: int, itemsize: int):
    """Row 9b's least time: the ids and ``dout`` read, ``d table`` written
    once."""
    c = census()
    return c.bound_ms(*c.gather_backward_terms(N, V, D, itemsize))


def check_gather(cfg, dev, dtypes=(torch.bfloat16, torch.float32),
                 ns=GATHER_NS):
    """Phase 9: the row gather (kernel row 9) against its plain version at
    V = vocab, D = d_model, in ``dtypes`` at N in ``ns`` with ids -1 and
    V mixed in: max |d| = 0, and equal to F.embedding on the in-range
    ids.  Times per launch, the plain version's, F.embedding's (on the
    clamped ids), on cold rows, and the bound (each row read and written
    once, plus the ids)."""
    from repro_torch.kernels.gather import launch_onehot_gather
    from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
    from repro_torch.kernels.gather_ref import gather_ref

    V, D = cfg.vocab, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    for dtype in dtypes:
        table = torch.randn((V, D), generator=g, device=dev).to(dtype)
        name = str(dtype).split(".")[-1]
        for N in ns:
            ids = torch.randint(0, V, (N,), generator=g, device=dev)
            ids[0], ids[1] = -1, V
            out = cuda_onehot_gather(table, ids)
            torch.cuda.synchronize()
            ref = gather_ref(table, ids)
            ok = (ids >= 0) & (ids < V)
            err = float((out.float() - ref.float()).abs().max())
            lib_same = torch.equal(out[ok], F.embedding(ids[ok], table))
            if not torch.equal(out, ref) or not lib_same:
                fail(f"row gather {name} N={N}: differs from its plain "
                     f"version or from F.embedding")
            # Timed launches cycle through id sets whose rows add up to
            # twice the L2 cache, so rows are read from device memory as
            # a prompt's first lookup reads them (not from the last
            # launch's L2 lines).
            n_sets = min(16, -(-2 * L2_BYTES // (N * D
                                                 * table.element_size())))
            sets = [ids] + [torch.randint(0, V, (N,), generator=g,
                                          device=dev)
                            for _ in range(n_sets - 1)]
            ring = itertools.cycle(sets)
            ms = device_ms(lambda: launch_onehot_gather(table, next(ring)))
            paced = per_call_ms(
                lambda: launch_onehot_gather(table, next(ring)), 20)
            plain = per_call_ms(lambda: gather_ref(table, next(ring)), 20)
            clamped = itertools.cycle([i.clamp(0, V - 1) for i in sets])
            lib = device_ms(lambda: F.embedding(next(clamped), table))
            bms, by = gather_bound(N, D, table.element_size())
            print(f"  {name} N={N}: max|d| {err} vs plain, = F.embedding "
                  f"on in-range ids; {ms:.5f} ms per launch on the device "
                  f"(bound {bms:.5f}, {by}), {paced:.5f} ms back to back "
                  f"as the host launches; plain {plain:.5f} ms; "
                  f"F.embedding {lib:.5f} ms on the device")
            res[(name, N)] = {"err": err, "ms": ms, "paced_ms": paced,
                              "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bms, "bound_by": by}
            if N == GATHER_RETIME_N:
                res[(name, N)]["retime"] = retime_gather(
                    lambda: launch_onehot_gather(table, next(ring)),
                    lambda: F.embedding(next(clamped), table), name, N)
        del table
    return res


def retime_gather(kernel, library, name: str, N: int) -> dict:
    """Row 9 against ``F.embedding`` on the device, in turns (kernel,
    library, library, kernel) of ``device_times`` with 5 repetitions
    each: the medians and the spread (max - min) of each side's 10
    timings."""
    k, lib = [], []
    for first, second, a, b in ((kernel, library, k, lib),
                                (library, kernel, lib, k)):
        a += device_times(first)
        b += device_times(second)
    out = {}
    for side, t in (("kernel", k), ("F.embedding", lib)):
        out[side] = {"median_ms": statistics.median(t), "min_ms": min(t),
                     "max_ms": max(t)}
    gap = out["kernel"]["median_ms"] - out["F.embedding"]["median_ms"]
    spread = max(out[s]["max_ms"] - out[s]["min_ms"] for s in out)
    out["gap_ms"], out["spread_ms"] = gap, spread
    print(f"  row 9 re-timed, {name} N={N}, 10 timings each in turns: "
          f"kernel median {out['kernel']['median_ms']:.5f} ms "
          f"[{out['kernel']['min_ms']:.5f}, {out['kernel']['max_ms']:.5f}]"
          f", F.embedding {out['F.embedding']['median_ms']:.5f} ms "
          f"[{out['F.embedding']['min_ms']:.5f}, "
          f"{out['F.embedding']['max_ms']:.5f}]; kernel - F.embedding "
          f"{gap:+.5f} ms against a spread of {spread:.5f} ms")
    return out


def slstm_bound(B: int, S: int, di: int):
    """zifo read (16 B), h written (4 B) per token and feature, the two
    states and r once; the operations over the FP32 peak."""
    c = census()
    return c.bound_ms(*c.slstm_terms(B, S, di))


def slstm_chain_floor() -> dict:
    """The census's chain floor of row 10 (``tools/kernel_census.py``,
    which needs ``cuobjdump`` beside ``nvcc``): the h -> h path of most
    cycles in the steady loop of the SASS of the library phase 10 loads,
    at latencies and the SM clock measured on this card
    (``tools/latency_probe.cu``), as ns a token step."""
    from repro_torch.kernels import _build

    sys.path.insert(0, str(_SRC.parent / "tools"))
    import kernel_census

    out = _SRC.parent / "build" / "census_smoke"
    out.mkdir(parents=True, exist_ok=True)
    lat = kernel_census.latencies(out)
    lib = pathlib.Path(_build.load("slstm")._name)
    return kernel_census.slstm_chain(lib, lat)


def check_slstm(cfg, dev):
    """Phase 10: the sLSTM recurrence (kernel row 10) against its plain
    version at di = d_inner for each (B, S) of SLSTM_SHAPES and the long
    memory SLSTM_LONG, from a fresh and from a carried state: hidden
    states and final state within rtol = atol = SLSTM_TOL.  Times per
    launch, ns a token step beside the chain floor, the plain version's
    time, and the bound.  Keys (B, S, forget shift)."""
    from repro_torch.kernels.slstm import launch_slstm
    from repro_torch.kernels.slstm_ops import slstm_recurrence
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_recurrence_ref)

    chain = slstm_chain_floor()
    print(f"  chain floor: {chain['ns_per_step']:.1f} ns a step "
          f"({chain['ops']} dependent operations, {chain['sfu']} in the "
          f"SFU, {chain['cycles']:.1f} cycles)")
    di = cfg.d_inner
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    res = {}
    for B, S, shift in [(B, S, 0.0) for B, S in SLSTM_SHAPES] + [SLSTM_LONG]:
        zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
        zifo[:, :, 2] += shift
        errs = []
        for fresh in (True, False):
            if fresh:
                state = init_slstm_state(B, di, device=dev)
            else:
                state = torch.randn((4, B, di), generator=g, device=dev)
                state[1] = state[1].abs() + 1.0
            hs, final = slstm_recurrence(zifo, r, state)
            torch.cuda.synchronize()
            want_hs, want = slstm_recurrence_ref(zifo, r, state)
            for got, ref in ((hs, want_hs), (final, want)):
                excess = float(((got - ref).abs() - SLSTM_TOL
                                * (1 + ref.abs())).max())
                if not excess <= 0:
                    fail(f"sLSTM B={B} S={S} forget +{shift} "
                         f"{'fresh' if fresh else 'carried'}: outside "
                         f"rtol = atol = {SLSTM_TOL} of the plain version")
            errs += [float((hs - want_hs).abs().max()),
                     float(((final - want).abs()
                            / (1 + want.abs())).max())]
        state = init_slstm_state(B, di, device=dev)
        inner = 20 if S == 1 else 3
        ms = device_ms(lambda: launch_slstm(zifo, r, state), inner)
        paced = per_call_ms(lambda: launch_slstm(zifo, r, state), inner)
        plain = time_ms(lambda: slstm_recurrence_ref(zifo, r, state),
                        reps=1 if S > 1 else 5)
        bms, by = slstm_bound(B, S, di)
        floor = S * chain["ns_per_step"] * 1e-6
        print(f"  B={B} S={S} forget +{shift}: max|d| h "
              f"{max(errs[0::2]):.3e}, final state {max(errs[1::2]):.3e} "
              f"(relative); {ms:.5f} ms per launch on the device, "
              f"{paced:.5f} ms back to back as the host launches (bound "
              f"{bms:.5f}, {by}; chain floor {floor:.5f}); "
              f"{1e6 * ms / S:.1f} ns a step against the chain's "
              f"{chain['ns_per_step']:.1f}; plain {plain:.3f} ms")
        res[(B, S, shift)] = {
            "err_h": max(errs[0::2]), "err_state_rel": max(errs[1::2]),
            "ms": ms, "paced_ms": paced, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "chain_floor_ms": floor,
            "ns_per_step": 1e6 * ms / S}
        del zifo
    return res, chain


def served_runs(cfg, model, prompts, temps, dev) -> dict:
    """``prompts`` served at ``temps`` (one a request), LM_MAX_TOKENS
    each, through ServingEngine(n_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    with gather_impl="take" and "onehot", after an untimed warm-up of
    both; counts zeroed before each run and read after.  Row 9 must run
    once a prefill and decode call under onehot and never under take,
    row 10 once a call in every sLSTM layer, and no other kernel; the
    greedy requests' tokens must agree.  Returns the two runs."""
    import repro_torch.kernels.gather_kernel_ops as gops
    import repro_torch.kernels.slstm_ops as sops
    import repro_torch.serving.engine as engine_mod
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serving import Request, ServingEngine

    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * cfg.n_periods
    n_tokens = sum(len(p) for p in prompts)
    # Warm-up, untimed: each prompt length's first prefill and the first
    # decode calls pay one-time library costs (kernel loads, matmul
    # heuristics) that would land on whichever run came first.
    warm = {}
    for impl in ("take", "onehot"):
        eng = ServingEngine(dataclasses.replace(cfg, gather_impl=impl),
                            model, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                            seed=SEED, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=2))
        t0 = time.perf_counter()
        eng.run_until_done()
        torch.cuda.synchronize()
        warm[impl] = time.perf_counter() - t0
    print(f"  warm-up, the same prompts at 2 tokens each (first calls "
          f"included): " + ", ".join(f"{i} {w:.3f} s"
                                     for i, w in warm.items()))
    runs = {}
    for impl in ("take", "onehot"):
        cfg_i = dataclasses.replace(cfg, gather_impl=impl)
        eng = ServingEngine(cfg_i, model, n_slots=LM_SLOTS,
                            max_len=LM_MAX_LEN, seed=SEED, device=dev)
        reqs = [Request(rid=i, prompt=p, max_tokens=LM_MAX_TOKENS,
                        temperature=t)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        for r in reqs:
            eng.submit(r)
        timers = {n: LaunchTimer(m, f) for n, (m, f) in {
            "slstm": (sops, "launch_slstm"),
            "onehot_gather": (gops, "launch_onehot_gather"),
            "prefill": (engine_mod, "prefill"),
            "decode": (engine_mod, "_masked_decode_step")}.items()}
        with contextlib.ExitStack() as stack:
            for t in timers.values():
                stack.enter_context(t)
            torch.cuda.synchronize()
            for key in LAUNCHES:
                LAUNCHES[key] = 0
            t0 = time.perf_counter()
            ticks = eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
        ms = {n: t.ms() for n, t in timers.items()}
        n_out = sum(len(r.out_tokens) for r in reqs)
        n_pre, n_dec = len(ms["prefill"]), len(ms["decode"])
        print(f"  served {impl}: {len(reqs)} requests in {wall:.3f} s, "
              f"{ticks} ticks, {n_dec} decode calls, {n_out} tokens = "
              f"{n_out / wall:.1f} tokens/s; launches "
              f"{dict((k, v) for k, v in launches.items() if v)}")
        if not all(r.done and len(r.out_tokens) == LM_MAX_TOKENS
                   and all(0 <= t < cfg.vocab for t in r.out_tokens)
                   for r in reqs):
            fail(f"served {impl}: a request did not finish with "
                 f"{LM_MAX_TOKENS} legal tokens")
        want_onehot = (n_pre + n_dec) if impl == "onehot" else 0
        if launches["slstm"] != n_slstm * (n_pre + n_dec) \
                or launches["onehot_gather"] != want_onehot \
                or sum(launches.values()) != launches["slstm"] \
                + launches["onehot_gather"]:
            fail(f"served {impl}: launches {launches} for {n_pre} prefills "
                 f"and {n_dec} decode calls")
        pre_ms = sum(ms["prefill"]) / n_tokens
        tick_ms = sum(ms["decode"]) / ticks
        print(f"    prefill {pre_ms:.4f} ms per prompt token "
              f"({n_tokens} tokens, {n_pre} prompts); decode "
              f"{statistics.median(ms['decode']):.3f} ms per call (median, "
              f"{LM_SLOTS} slots), {tick_ms:.3f} ms per tick")
        for name in ("slstm", "onehot_gather"):
            if ms[name]:
                print(f"    {name}: {len(ms[name])} launches, median "
                      f"{statistics.median(ms[name]):.5f} ms, total "
                      f"{sum(ms[name]):.2f} ms")
        runs[impl] = {"wall_s": wall, "warmup_s": warm[impl],
                      "ticks": ticks, "decode_calls": n_dec,
                      "prefills": n_pre, "tokens": n_out,
                      "tokens_per_s": n_out / wall,
                      "prefill_ms_per_token": pre_ms,
                      "decode_ms_per_call": statistics.median(ms["decode"]),
                      "decode_ms_per_tick": tick_ms,
                      "launches": {k_: v for k_, v in launches.items() if v},
                      "kernel_ms_median": {
                          n: statistics.median(ms[n]) for n in
                          ("slstm", "onehot_gather") if ms[n]},
                      "out": [r.out_tokens for r in reqs]}
        del eng
    greedy = [[o for o, t in zip(runs[i]["out"], temps) if t == 0.0]
              for i in ("take", "onehot")]
    if greedy[0] != greedy[1]:
        fail("take and onehot served different greedy tokens")
    print(f"  take and onehot served the same greedy tokens "
          f"({len(greedy[0])} requests)")
    return runs


def lm_prompts(cfg) -> list:
    """LM_REQUESTS prompts of LM_PROMPT tokens, from SEED."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [rng.integers(0, cfg.vocab, int(n)) for n in lengths]


def serve_lm(cfg, dev):
    """Phase 11: the model served at full width (the config's widths,
    bfloat16, seeded weights on the card): LM_REQUESTS prompts of
    LM_PROMPT tokens, greedy and temperature=0.8 in turn
    (:func:`served_runs`).  Then one prompt's prefill in bfloat16 and in
    float32 (:func:`check_prefill`), and a forward of LM_FORWARD
    tokens."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import forward, init_model

    t0 = time.perf_counter()
    model = init_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {n_params / 1e6:.2f} M parameters "
          f"({cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; {cfg.n_layers} layers "
          f"{cfg.block_pattern}, d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, vocab {cfg.vocab}")
    prompts = lm_prompts(cfg)
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * cfg.n_periods
    runs = served_runs(cfg, model, prompts,
                       [0.8 if i % 2 else 0.0 for i in range(len(prompts))],
                       dev)

    toks = torch.as_tensor(prompts[0], device=dev)[None]
    pre = {}
    for dtype in ("bfloat16", "float32"):
        cfg_d = dataclasses.replace(cfg, gather_impl="onehot",
                                    param_dtype=dtype)
        pre[dtype] = check_prefill(
            model if dtype == cfg.param_dtype
            else init_model(cfg_d, seed=SEED, device=dev),
            cfg_d, toks, n_slstm)

    B, S = LM_FORWARD
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED))
    torch.cuda.synchronize()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    logits, _ = forward(model, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if logits.shape != (B, S, cfg.vocab) or launches["slstm"] != n_slstm \
            or not bool(torch.isfinite(logits).all()):
        fail(f"forward of {B}x{S}: {tuple(logits.shape)}, launches "
             f"{launches}, or non-finite logits")
    print(f"  forward {B}x{S}: {fwd_s:.3f} s, {B * S / fwd_s:.1f} tokens/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del logits, model
    torch.cuda.empty_cache()
    return {"runs": runs, "prefill": pre, "forward_s": fwd_s,
            "n_params": n_params}


def faulty_recurrence(eps: float):
    """The plain sLSTM recurrence with its h off by the factor 1 + eps (the
    hidden states and the final state's h): a kernel that far off."""
    from repro_torch.kernels.slstm_ref import slstm_recurrence_ref

    def run(zifo, r, state):
        hs, final = slstm_recurrence_ref(zifo, r, state)
        final = final.clone()
        final[2] *= 1 + eps
        return hs * (1 + eps), final
    return run


def cache_err(got: dict, want: dict) -> float:
    """max |d| / (1 + |ref|) over every leaf of two decode caches."""
    return max(float(((a - b).abs() / (1 + b.abs())).max())
               for n in got["blocks"] for a, b in
               zip(got["blocks"][n].values(), want["blocks"][n].values()))


def check_prefill(model, cfg, toks, n_slstm: int) -> dict:
    """One prompt's prefill on the kernels, in ``cfg.param_dtype``: each
    of its sLSTM launches against the plain recurrence on the same inputs
    (hidden states and final state, which is the layer's cache) at
    SLSTM_TOL; the logits (LM_LOGIT_TOL x max(1, max|logits|)) and the
    whole cache (LM_CACHE_TOL) against the same model on the plain
    versions; and the same model on the plain versions with the
    recurrence's h off by LM_CACHE_FAULT must break the cache bound."""
    import repro_torch.kernels.gather_kernel_ops as gops
    import repro_torch.kernels.slstm_ops as sops
    from repro_torch.kernels.gather_ref import gather_ref
    from repro_torch.kernels.slstm_ref import slstm_recurrence_ref
    from repro_torch.models import prefill

    dtype = cfg.param_dtype
    calls, launch = [], sops.launch_slstm

    def recorded(zifo, r, state):
        out = launch(zifo, r, state)
        calls.append(((zifo, r, state), out))
        return out

    with patched(sops, "launch_slstm", recorded):
        lk, ck = prefill(model, cfg, {"tokens": toks}, LM_MAX_LEN)
    torch.cuda.synchronize()
    if len(calls) != n_slstm:
        fail(f"the {dtype} prefill launched the sLSTM kernel {len(calls)} "
             f"times, not {n_slstm}")
    slstm_err = max(float(((a - b).abs() / (1 + b.abs())).max())
                    for args, out in calls
                    for a, b in zip(out, slstm_recurrence_ref(*args)))
    del calls
    plain = {}
    for name, fn in (("plain", slstm_recurrence_ref),
                     ("fault", faulty_recurrence(LM_CACHE_FAULT[dtype]))):
        with patched(sops, "launch_slstm", fn), \
                patched(gops, "launch_onehot_gather", gather_ref):
            plain[name] = prefill(model, cfg, {"tokens": toks}, LM_MAX_LEN)
    torch.cuda.synchronize()
    lp, cp = plain["plain"]
    logit_err = float((lk - lp).abs().max())
    bound = LM_LOGIT_TOL * max(1.0, float(lp.abs().max()))
    err, fault = cache_err(ck, cp), cache_err(plain["fault"][1], cp)
    tol = LM_CACHE_TOL[dtype]
    print(f"  {dtype} prefill of {toks.shape[1]} tokens on the kernels: "
          f"each of its {n_slstm} sLSTM launches against the plain "
          f"recurrence on its inputs max |d|/(1+|ref|) {slstm_err:.3e} "
          f"(bound {SLSTM_TOL}); against the model on the plain versions: "
          f"logits max|d| {logit_err:.3e} (bound {bound:.3e}), cache max "
          f"|d|/(1+|ref|) {err:.3e} (bound {tol}; with h off by "
          f"{LM_CACHE_FAULT[dtype]:g} {fault:.3e})")
    if not (slstm_err <= SLSTM_TOL and logit_err <= bound and err <= tol):
        fail(f"the {dtype} model's prefill on the kernels disagrees with "
             f"its plain versions")
    if not fault > tol:
        fail(f"the {dtype} cache bound {tol} does not see h off by "
             f"{LM_CACHE_FAULT[dtype]}")
    return {"slstm_err": slstm_err, "logit_err": logit_err,
            "logit_bound": bound, "cache_err": err, "cache_bound": tol,
            "fault": LM_CACHE_FAULT[dtype], "fault_cache_err": fault}


# ----------------------------------------------------------------------
# chatglm3-6b and the attention families (phase 12)
# ----------------------------------------------------------------------

def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |d| / (1 + |ref|)."""
    return float(((got.float() - want.float()).abs()
                  / (1 + want.float().abs())).max())


def seeded_ints(high: int, shape, dev, seed: int) -> torch.Tensor:
    return torch.randint(0, high, shape, device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))


def seeded_normal(shape, dev, seed: int) -> torch.Tensor:
    return torch.randn(shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))


def profiled_call(fn, calls: int = 3) -> dict:
    """``fn`` under ``torch.profiler``, per call: the host's wall clock to
    a synchronise, the kernels' summed device time (one stream, so their
    busy time; None where the profiler recorded none), the count of
    kernels, and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall,
            "device_ms": us / 1e3 / calls if us else None,
            "kernels": sum(e.count for e in kernels) / calls,
            "top": [(e.key[:60], dev_us(e) / 1e3 / calls, e.count / calls)
                    for e in top]}


def launch_parts(fn, calls: int = 5) -> list:
    """The device launches of a call of ``fn``, from ``torch.profiler``
    recording device activity alone over ``calls`` calls: ``[(kernel,
    ms a launch, launches a call), ...]``, the longest first (the
    profiler may drop a call's events: the launches a call then read
    under 1, and the ms a launch stand)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out.append((e.key[:60], us / e.count / 1e3, e.count / calls))
    return sorted(out, key=lambda x: -x[1])


def serve_full(cfg, dev, phase: int, fwd_label: str, fwd_shape,
               counted_fn, want_counted: int) -> dict:
    """Phase 12a, 12b, 12e (chatglm3-6b) and 13a-c (jamba): ``cfg`` at
    its published widths in bfloat16 from SEED, served greedily
    (:func:`served_runs`, 8 requests of LM_PROMPT tokens, LM_MAX_TOKENS
    each, take and onehot) beside the weight-bytes floor of a decode
    call (every parameter but the embedding table read once; an MoE
    layer's einsums read every expert); the card's own time of a decode
    call; one prompt's prefill bitwise equal under take and onehot
    (logits and every cache leaf); a timed forward of ``fwd_shape``
    tokens in which ``counted_fn`` (module, name) must run
    ``want_counted`` times (the chunked attention, the scan's chunks)."""
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model, prefill)

    t0 = time.perf_counter()
    model = init_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    wbytes = total - model.embed.numel() * model.embed.element_size()
    floor_ms = 1e3 * wbytes / census().PEAK_BYTES_S
    kinds = [cfg.block_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    moe_at = [i for i in range(cfg.n_layers) if cfg.moe_at(i % cfg.period)]
    print(f"  {cfg.name}: {n_params / 1e9:.4f} B parameters "
          f"({cfg.param_dtype}, {total / 1e9:.2f} GB), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; {cfg.n_layers} layers "
          f"{sorted(set(kinds))}, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, {cfg.n_kv_heads} KV heads, rope {cfg.rope}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}"
          + (f", d_inner {cfg.d_inner}, d_state {cfg.d_state}"
             if "mamba" in kinds else "")
          + (f"; MoE ({cfg.n_experts} experts, top {cfg.top_k}) at layers "
             f"{moe_at}" if moe_at else "")
          + f"; a decode call reads {wbytes / 1e9:.2f} GB of weights (all "
          f"but the embedding): floor {floor_ms:.3f} ms at "
          f"{census().PEAK_BYTES_S / 1e12:.2f} TB/s")
    print(f"phase {phase}a: served, greedy")
    prompts = lm_prompts(cfg)
    runs = served_runs(cfg, model, prompts, [0.0] * len(prompts), dev)
    for impl, r in runs.items():
        print(f"    {impl}: {r['tokens_per_s']:.2f} tokens/s, "
              f"{r['decode_ms_per_call']:.3f} ms per decode call = "
              f"{r['decode_ms_per_call'] / floor_ms:.2f}x the "
              f"{floor_ms:.3f} ms weight-bytes floor; prefill "
              f"{r['prefill_ms_per_token']:.4f} ms per prompt token; row 9 "
              f"{r['launches'].get('onehot_gather', 0)} launches for "
              f"{r['prefills']} prefills + {r['decode_calls']} decode calls")
    cache = init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    toks = seeded_ints(cfg.vocab, (LM_SLOTS, 1), dev, SEED)
    prof = profiled_call(
        lambda: decode_step(model, cfg, cache, toks, LM_MAX_LEN // 2))
    dev_ms, wall_ms = prof["device_ms"], prof["wall_ms"]
    busy = ("device time not measured" if dev_ms is None else
            f"{dev_ms:.3f} ms on the device ({dev_ms / floor_ms:.2f}x the "
            f"floor), busy {dev_ms / wall_ms:.1%} of the call")
    print(f"  a decode call of {LM_SLOTS} slots at index {LM_MAX_LEN // 2}, "
          f"profiled: {wall_ms:.3f} ms wall, {busy}, "
          f"{prof['kernels']:.0f} kernels")
    for name, ms, count in prof["top"]:
        print(f"    {ms:.4f} ms in {count:.0f} x {name}")
    del cache

    print(f"phase {phase}b: one prompt's prefill, take against onehot")
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    out = {impl: prefill(model, dataclasses.replace(cfg, gather_impl=impl),
                         {"tokens": toks}, LM_MAX_LEN)
           for impl in ("take", "onehot")}
    torch.cuda.synchronize()
    (lt, ct), (lo, co) = out["take"], out["onehot"]
    leaves = [(n, k) for n in ct["blocks"] for k in ct["blocks"][n]]
    same = torch.equal(lt, lo) and all(
        torch.equal(ct["blocks"][n][k], co["blocks"][n][k])
        for n, k in leaves)
    print(f"  {toks.shape[1]} tokens: logits and {len(leaves)} cache leaves "
          f"({sorted({k for _, k in leaves})}) bitwise equal: {same}")
    if not same:
        fail("the take and onehot prefills differ")
    del out, ct, co

    B, S = fwd_shape
    print(f"phase {phase}{fwd_label}: a forward of {B}x{S} tokens")
    toks = seeded_ints(cfg.vocab, (B, S), dev, SEED)
    calls = []
    module, name = counted_fn
    orig = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with patched(module, name, counted):
        t0 = time.perf_counter()
        logits, aux = forward(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if logits.shape != (B, S, cfg.vocab) or len(calls) != want_counted \
            or not bool(torch.isfinite(logits).all()) \
            or not bool(torch.isfinite(aux)):
        fail(f"forward of {B}x{S}: {tuple(logits.shape)}, {len(calls)} "
             f"calls of {name} (want {want_counted}), or non-finite logits "
             f"or aux loss")
    print(f"  {fwd_s:.3f} s, {B * S / fwd_s:.1f} tokens/s, {len(calls)} "
          f"calls of {name}, aux loss {float(aux):.4f}; peak memory "
          f"{peak:.2f} GiB")
    del logits, model
    torch.cuda.empty_cache()
    return {"n_params": n_params, "weight_bytes": wbytes,
            "floor_ms": floor_ms, "runs": runs, "decode_profiled": prof,
            "prefill_bitwise": same, "forward_s": fwd_s,
            "forward_peak_gib": peak}


def check_depth_cut(cfg, dev) -> dict:
    """Phase 12c: the model at its published widths cut to GLM_DEPTH
    layers, in float32, three checks, each with a planted fault that must
    break its bound in the same run: prefill then decode against forward
    (GLM_DECODE_TOL; decoding one position late must break it), the
    chunked path against the dense (GLM_CHUNK_TOL; skipping the last KV
    block must break it), and the int8 KV cache against the model's own
    (KV_INT8_REL and KV_INT8_AGREE; scales that drop the 1/127 must break
    them)."""
    import repro_torch.models.attention as attn
    import repro_torch.models.blocks as blocks
    from repro_torch.models import decode_step, forward, init_model, prefill

    cut = dataclasses.replace(cfg, n_layers=GLM_DEPTH, param_dtype="float32")
    model = init_model(cut, seed=SEED, device=dev)
    print(f"  a depth cut: {GLM_DEPTH} of {cfg.n_layers} layers at full "
          f"width, float32, {sum(p.numel() for p in model.parameters()) / 1e9:.3f}"
          f" B parameters")
    res = {}

    n = GLM_DECODE_N
    toks = seeded_ints(cut.vocab, (2, n + 1), dev, SEED + 1)
    full, _ = forward(model, cut, {"tokens": toks})
    _, cache = prefill(model, cut, {"tokens": toks[:, :n]}, LM_MAX_LEN)
    errs = {}
    for name, index in (("decode", n), ("one position late", n + 1)):
        lg, _ = decode_step(model, cut, cache, toks[:, n:n + 1], index)
        errs[name] = rel_err(lg[:, 0], full[:, n])
    print(f"  1. prefill({n}) then decode_step(index={n}) against forward at "
          f"position {n}: max |d|/(1+|ref|) {errs['decode']:.3e} (bound "
          f"{GLM_DECODE_TOL}); decoded at index {n + 1}: "
          f"{errs['one position late']:.3e}")
    if not errs["decode"] <= GLM_DECODE_TOL < errs["one position late"]:
        fail("decode against forward: the bound does not hold, or does not "
             "see a decode one position late")
    res["decode"] = errs
    del full, cache

    B, S = GLM_FORWARD
    toks = seeded_ints(cut.vocab, (B, S), dev, SEED + 2)
    dense_cfg = dataclasses.replace(cut, attn_chunk=0)
    want, _ = forward(model, dense_cfg, {"tokens": toks})
    got, _ = forward(model, cut, {"tokens": toks})
    orig = attn._chunked_attention

    def skip_last_block(q, k, v, causal, chunk, q_offset=0):
        return orig(q, k[:, :-chunk], v[:, :-chunk], causal, chunk, q_offset)

    with patched(attn, "_chunked_attention", skip_last_block):
        bad, _ = forward(model, cut, {"tokens": toks})
    errs = {"chunked": rel_err(got, want), "last block skipped":
            rel_err(bad, want)}
    print(f"  2. {B}x{S} forward, attn_chunk {cut.attn_chunk} (chunked) "
          f"against 0 (dense): max |d|/(1+|ref|) {errs['chunked']:.3e} "
          f"(bound {GLM_CHUNK_TOL}); with the last KV block skipped: "
          f"{errs['last block skipped']:.3e}")
    if not errs["chunked"] <= GLM_CHUNK_TOL < errs["last block skipped"]:
        fail("chunked against dense: the bound does not hold, or does not "
             "see a skipped KV block")
    res["chunked"] = errs
    del want, got, bad

    q8 = dataclasses.replace(cut, kv_cache_dtype="int8")
    toks = seeded_ints(cut.vocab, (KV_INT8_B, n + 2), dev, SEED + 3)
    kv_quant = attn._kv_quant

    def unscaled(t):
        q, s = kv_quant(t)
        return q, (s.float() * 127.0).to(s.dtype)

    def last_logits(c):
        _, cache = prefill(model, c, {"tokens": toks[:, :n]}, LM_MAX_LEN)
        for i in range(2):
            lg, cache = decode_step(model, c, cache, toks[:, n + i:n + i + 1],
                                    n + i)
        return lg[:, 0]

    ref = last_logits(cut)
    got = last_logits(q8)
    with patched(attn, "_kv_quant", unscaled), \
            patched(blocks, "_kv_quant", unscaled):
        bad = last_logits(q8)
    scale = float(ref.abs().max())
    errs = {}
    for name, lg in (("int8", got), ("scales without 1/127", bad)):
        errs[name] = {"rel": float((lg - ref).abs().max()) / max(scale, 1e-6),
                      "agree": float((lg.argmax(-1) == ref.argmax(-1))
                                     .float().mean())}
    print(f"  3. int8 KV cache against the model's own (float32) after a "
          f"prefill of {n} and 2 decode steps, {KV_INT8_B} rows: rel "
          f"{errs['int8']['rel']:.4f} (< {KV_INT8_REL}), argmax agreement "
          f"{errs['int8']['agree']:.3f} (>= {KV_INT8_AGREE}); scales "
          f"without 1/127: rel {errs['scales without 1/127']['rel']:.4f}, "
          f"agreement {errs['scales without 1/127']['agree']:.3f}")
    ok = errs["int8"]["rel"] < KV_INT8_REL \
        and errs["int8"]["agree"] >= KV_INT8_AGREE
    seen = not (errs["scales without 1/127"]["rel"] < KV_INT8_REL
                and errs["scales without 1/127"]["agree"] >= KV_INT8_AGREE)
    if not (ok and seen):
        fail("the int8 cache: the bounds do not hold, or do not see scales "
             "without 1/127")
    res["int8"] = errs
    del model
    torch.cuda.empty_cache()
    return res


def run_family(cfg, dev, batch: dict, max_len: int, start: int) -> dict:
    """Phase 12d: ``cfg`` at its published widths in bfloat16 from SEED:
    a prefill of ``batch`` and LM_DECODE_STEPS decode steps from
    position ``start``; finite logits of the right shape; times."""
    from repro_torch.models import decode_step, init_model, prefill

    model = init_model(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    prefill(model, cfg, batch, max_len)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, batch, max_len)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    B = batch["tokens"].shape[0]
    outs, tok = [logits], logits[:, -1].argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(LM_DECODE_STEPS):
        logits, cache = decode_step(model, cfg, cache, tok, start + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        outs.append(logits)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE_STEPS
    ok = all(o.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(o).all())
             for o in outs)
    print(f"  {cfg.name}: {n_params / 1e9:.4f} B parameters; prefill "
          f"{pre_s * 1e3:.2f} ms, decode {dec_ms:.3f} ms a step; logits "
          f"{tuple(outs[0].shape)} finite: {ok}")
    if not ok:
        fail(f"{cfg.name}: logits of the wrong shape or not finite")
    del model, cache, outs
    torch.cuda.empty_cache()
    return {"n_params": n_params, "prefill_ms": pre_s * 1e3,
            "decode_ms_per_step": dec_ms}


def run_families(dev) -> dict:
    """Phase 12d: whisper-small (WHISPER_FRAMES frames, cross-attention;
    1500 frames must raise, as in the reference) and qwen2-vl-2b (a
    VL_GRID x VL_GRID patch grid and VL_TEXT text tokens, M-RoPE)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_model, prefill
    from repro_torch.models.model import FRONTEND_DIM

    res = {}
    w = ARCHS["whisper-small"]
    frames = seeded_normal((1, WHISPER_FRAMES, FRONTEND_DIM["audio"]), dev,
                           SEED)
    text = seeded_ints(w.vocab, (1, 32), dev, SEED)
    res[w.name] = run_family(w, dev, {"tokens": text, "frames": frames}, 64,
                             32)
    one = dataclasses.replace(w, n_layers=1, n_enc_layers=1)
    model = init_model(one, seed=SEED, device=dev)
    try:
        prefill(model, one, {"tokens": text, "frames": seeded_normal(
            (1, 1500, FRONTEND_DIM["audio"]), dev, SEED)}, 64)
    except AssertionError:
        print("  whisper-small with 1500 frames raises, as the reference "
              f"(1500 keys > attn_chunk {w.attn_chunk}, not a multiple)")
    else:
        fail("whisper-small with 1500 frames did not raise")
    del model
    q = ARCHS["qwen2-vl-2b"]
    n_img = VL_GRID * VL_GRID
    batch = {"tokens": seeded_ints(q.vocab, (1, VL_TEXT), dev, SEED),
             "patches": seeded_normal((1, n_img, FRONTEND_DIM["vision"]),
                                      dev, SEED)}
    res[q.name] = run_family(q, dev, batch, n_img + VL_TEXT + 64,
                             n_img + VL_TEXT)
    return res


# ----------------------------------------------------------------------
# jamba-v0.1-52b and the MoE families (phase 13)
# ----------------------------------------------------------------------

def check_mamba_moe(cfg, dev) -> dict:
    """Phase 13d: one Mamba mixer and one MoE layer at ``cfg``'s widths in
    float32 from SEED, three checks, each with a planted fault that must
    break its bound in the same run: a prefill then steps against one
    forward (the conv carry one token late must break it), a forward in
    chunks of 256 against one chunk (the carry dropped at the chunk
    boundaries must), and ``scatter`` against ``einsum`` on a prompt
    whose capacity drops assignments (one more assignment kept in each
    full expert must)."""
    from repro_torch.models import moe, ssm
    from repro_torch.models.layers import Params

    res = {}
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mixer = Params(torch.float32, dev, gen)
    ssm.init_mamba(mixer, f32)
    with torch.no_grad():                 # a non-trivial step size
        mixer["dt_bias"].normal_(generator=gen)
    S, k = MAMBA_SPLIT
    x = seeded_normal((MAMBA_B, S + k, cfg.d_model), dev, SEED)
    f = dict(dtype=torch.float32)
    full = ssm.mamba_forward(mixer, f32, x, **f)

    def stepped(late: bool):
        out, cache = ssm.mamba_forward(mixer, f32, x[:, :S], return_state=True,
                                       **f)
        if late:                          # the carry of S - 1 tokens
            _, short = ssm.mamba_forward(mixer, f32, x[:, :S - 1],
                                         return_state=True, **f)
            cache = dict(cache, conv=short["conv"])
        outs = [out]
        for t in range(S, S + k):
            y, cache = ssm.mamba_step(mixer, f32, x[:, t:t + 1], cache, **f)
            outs.append(y)
        return torch.cat(outs, 1)

    good, bad = rel_err(stepped(False), full), rel_err(stepped(True), full)
    print(f"  Mamba, prefill {S} + {k} steps against a forward over "
          f"{S + k}: {good:.3e} (bound {MAMBA_TOL:g}); the conv carry one "
          f"token late: {bad:.3e}")
    if not good <= MAMBA_TOL < bad:
        fail(f"13d Mamba steps: {good:.3e} and the late carry {bad:.3e} "
             f"against {MAMBA_TOL:g}")
    res["mamba_steps"] = {"err": good, "fault_err": bad, "bound": MAMBA_TOL}
    del full, x

    x = seeded_normal((1, MAMBA_CHUNKS_S, cfg.d_model), dev, SEED + 1)
    one = ssm.mamba_forward(mixer, f32, x, chunk=MAMBA_CHUNKS_S, **f)
    chunked = ssm.mamba_forward(mixer, f32, x, chunk=256, **f)
    orig = ssm._ssm_scan_chunk

    def dropped(dA, dBx, h0):
        return orig(dA, dBx, torch.zeros_like(h0))

    with patched(ssm, "_ssm_scan_chunk", dropped):
        no_carry = ssm.mamba_forward(mixer, f32, x, chunk=256, **f)
    good, bad = rel_err(chunked, one), rel_err(no_carry, one)
    print(f"  Mamba, {MAMBA_CHUNKS_S} tokens in chunks of 256 against one "
          f"chunk: {good:.3e} (bound {MAMBA_TOL:g}); the carry dropped: "
          f"{bad:.3e}")
    if not good <= MAMBA_TOL < bad:
        fail(f"13d Mamba chunks: {good:.3e} and no carry {bad:.3e} against "
             f"{MAMBA_TOL:g}")
    res["mamba_chunks"] = {"err": good, "fault_err": bad, "bound": MAMBA_TOL}
    del mixer, x, one, chunked, no_carry
    torch.cuda.empty_cache()

    layer = Params(torch.float32, dev, gen)
    moe.init_moe(layer, f32)
    mcfg = dataclasses.replace(f32, capacity_factor=MOE_CF)
    x = seeded_normal((1, MOE_TOKENS, cfg.d_model), dev, SEED + 2)
    _, _, idx = moe._route(layer, mcfg, x[0])
    C = moe.moe_capacity(mcfg, MOE_TOKENS)
    n_drop = int((moe._positions_in_expert(idx.reshape(-1), cfg.n_experts)
                  >= C).sum())
    scat, aux_s = moe.moe_forward(layer, mcfg, x, impl="scatter", **f)
    ein, aux_e = moe.moe_forward(layer, mcfg, x, impl="einsum", **f)
    with patched(moe, "moe_capacity", lambda c, n: C + 1):
        kept, _ = moe.moe_forward(layer, mcfg, x, impl="scatter", **f)
    good, bad = rel_err(scat, ein), rel_err(kept, ein)
    print(f"  MoE, {MOE_TOKENS} tokens at capacity_factor {MOE_CF} (C = {C}): "
          f"{n_drop} of {MOE_TOKENS * cfg.top_k} assignments drop; scatter "
          f"against einsum {good:.3e} (bound {MOE_TOL:g}), aux "
          f"{float(aux_s):.6f} / {float(aux_e):.6f}; one more kept per full "
          f"expert: {bad:.3e}")
    if n_drop == 0 or not good <= MOE_TOL < bad \
            or float(aux_s) != float(aux_e):
        fail(f"13d MoE: {n_drop} drops, {good:.3e} and the kept overflow "
             f"{bad:.3e} against {MOE_TOL:g}")
    res["moe"] = {"err": good, "fault_err": bad, "bound": MOE_TOL,
                  "capacity": C, "dropped": n_drop,
                  "assignments": MOE_TOKENS * cfg.top_k}
    del layer, x, scat, ein, kept
    torch.cuda.empty_cache()
    return res


def run_moe_families(dev) -> dict:
    """Phase 13e: each of MOE_FAMILIES at its published widths cut in
    depth, bfloat16 from SEED: a prefill of MOE_PROMPT tokens and
    LM_DECODE_STEPS decode steps (:func:`run_family`), each model freed
    before the next."""
    from repro_torch.configs import ARCHS

    res = {}
    for name, depth in MOE_FAMILIES:
        cfg = dataclasses.replace(ARCHS[name], n_layers=depth)
        print(f"  {name} cut to {depth} of {ARCHS[name].n_layers} layers "
              f"({cfg.n_experts} experts, top {cfg.top_k}, expert d_ff "
              f"{cfg.moe_d_ff})")
        res[name] = run_family(
            cfg, dev, {"tokens": seeded_ints(cfg.vocab, (1, MOE_PROMPT), dev,
                                             SEED)},
            MOE_PROMPT + 64, MOE_PROMPT)
    return res


def run_jamba(cfg, dev, card: str) -> dict:
    """Phase 13 on ``cfg`` (jamba-v0.1-52b cut to JAMBA_DEPTH layers) and
    the MoE families."""
    import repro_torch.models.ssm as ssm

    print(f"phase 13: {cfg.name} at full width, {cfg.n_layers} layers "
          f"(one period)")
    B, S = JAMBA_FORWARD
    n_mamba = sum(cfg.block_pattern[i % cfg.period] == "mamba"
                  for i in range(cfg.n_layers))
    jam = serve_full(cfg, dev, 13, "c", JAMBA_FORWARD,
                     (ssm, "_ssm_scan_chunk"), n_mamba * S // 256)
    print(f"phase 13d: one Mamba mixer and one MoE layer at {cfg.name}'s "
          f"widths, float32")
    chk = check_mamba_moe(cfg, dev)
    print("phase 13e: qwen3-moe-235b-a22b and kimi-k2-1t-a32b at full "
          "width, bfloat16")
    fam = run_moe_families(dev)
    print(json.dumps({"jamba_detail": {
        "card": card, **{k: v for k, v in jam.items() if k != "runs"},
        "served": {i: {k_: v for k_, v in r.items() if k_ != "out"}
                   for i, r in jam["runs"].items()},
        "float32_checks": chk, "families": fam}}))
    return jam


def run_glm(cfg, dev, card: str) -> dict:
    """Phase 12 on ``cfg`` (chatglm3-6b), whisper-small and qwen2-vl-2b."""
    import repro_torch.models.attention as attn

    print(f"phase 12: {cfg.name} at full width")
    glm = serve_full(cfg, dev, 12, "e", GLM_FORWARD,
                     (attn, "_chunked_attention"), cfg.n_layers)
    print(f"phase 12c: {cfg.name}, float32")
    cut = check_depth_cut(cfg, dev)
    print("phase 12d: whisper-small and qwen2-vl-2b at full width, bfloat16")
    fam = run_families(dev)
    print(json.dumps({"glm_detail": {
        "card": card, **{k: v for k, v in glm.items() if k != "runs"},
        "served": {i: {k_: v for k_, v in r.items() if k_ != "out"}
                   for i, r in glm["runs"].items()},
        "depth_cut": cut, "families": fam}}))
    return glm


def run_lm(cfg, glm_cfg, jamba_cfg, dev, card: str) -> list:
    """Phases 9-11 on ``cfg`` (xlstm-125m), phase 9 also at ``glm_cfg``'s
    table, phase 12 on ``glm_cfg`` (chatglm3-6b) and phase 13 on
    ``jamba_cfg`` (jamba-v0.1-52b one period deep); prints the details
    and returns the ``kernels`` entries of rows 9 and 10."""
    print(f"phase 9: the row gather vs plain at V={cfg.vocab}, "
          f"D={cfg.d_model}")
    gat = check_gather(cfg, dev)
    print(f"  and at {glm_cfg.name}'s table, V={glm_cfg.vocab}, "
          f"D={glm_cfg.d_model}")
    wide = check_gather(glm_cfg, dev, (torch.bfloat16,), GLM_GATHER_NS)
    print(f"phase 10: the sLSTM recurrence vs plain at di={cfg.d_inner}")
    rec, chain = check_slstm(cfg, dev)
    print(f"phase 11: {cfg.name} served at full width")
    lm = serve_lm(cfg, dev)
    glm = run_glm(glm_cfg, dev, card)
    jam = run_jamba(jamba_cfg, dev, card)
    src = "src/repro_torch/kernels/csrc/"
    g4 = gat[("bfloat16", GATHER_NS[0])]
    s4 = rec[(LM_SLOTS, 1, 0.0)]
    by_path = {c.name: m["runs"]["onehot"]["launches"].get(
        "onehot_gather", 0)
        for c, m in ((cfg, lm), (glm_cfg, glm), (jamba_cfg, jam))}
    k = [{"name": "onehot_gather", "route": "cuda",
          "source": src + "gather.cu",
          "replaces": "src/repro/kernels/gather.py:36",
          "launches": sum(by_path.values()),
          "launches_by_path": by_path,
          "max_abs_err": max(v["err"] for d in (gat, wide)
                             for v in d.values()),
          "ms": g4["ms"], "plain_ms": g4["plain_ms"],
          "bound_ms": g4["bound_ms"], "bound_by": g4["bound_by"],
          "library_ms": g4["library_ms"],
          f"retime_N{GATHER_RETIME_N}": {
              d: {"kernel_ms": r["retime"]["kernel"]["median_ms"],
                  "library_ms": r["retime"]["F.embedding"]["median_ms"],
                  "gap_ms": r["retime"]["gap_ms"],
                  "spread_ms": r["retime"]["spread_ms"],
                  "bound_ms": r["bound_ms"]}
              for (d, n), r in gat.items() if n == GATHER_RETIME_N},
          f"V{glm_cfg.vocab}_D{glm_cfg.d_model}": {
              f"{d}/N={n}": {k_: v for k_, v in r.items() if k_ != "retime"}
              | ({"retime_kernel_ms": r["retime"]["kernel"]["median_ms"],
                  "retime_library_ms": r["retime"]["F.embedding"][
                      "median_ms"],
                  "retime_spread_ms": r["retime"]["spread_ms"]}
                 if "retime" in r else {})
              for (d, n), r in wide.items()}},
         {"name": "slstm", "route": "cuda", "source": src + "slstm.cu",
          "replaces": "src/repro/kernels/slstm.py:34",
          "launches": lm["runs"]["take"]["launches"].get("slstm", 0),
          "max_abs_err": max(v["err_h"] for v in rec.values()),
          "ms": s4["ms"], "plain_ms": s4["plain_ms"],
          "bound_ms": s4["bound_ms"], "bound_by": s4["bound_by"],
          "library_ms": None, "chain_floor_ms": s4["chain_floor_ms"]}]
    print(json.dumps({"lm_detail": {
        "card": card,
        "gather": {f"{d}/N={n}": v for (d, n), v in gat.items()},
        "gather_wide": {f"{d}/N={n}": v for (d, n), v in wide.items()},
        "slstm": {f"B={b}/S={s}/f+{f:g}": v
                  for (b, s, f), v in rec.items()},
        "slstm_chain": chain,
        "served": {i: {k_: v for k_, v in r.items() if k_ != "out"}
                   for i, r in lm["runs"].items()},
        **{k_: v for k_, v in lm.items() if k_ != "runs"}}}))
    return k


# ----------------------------------------------------------------------
# The sharded path (phase 14)
# ----------------------------------------------------------------------

def ct_data(geom, dev):
    """Phase 3's data: the phantom's line integrals on the card, the
    projection matrices, and the views filtered CHUNK at a time."""
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.phantom import forward_project

    projs = forward_project(geom, device=dev)
    mats = projection_matrices(geom)
    filt = torch.cat([filter_projections(
        projs[i:i + CHUNK], geom, angle_indices=np.arange(i, i + CHUNK),
        device=dev) for i in range(0, geom.n_proj, CHUNK)])
    return projs, mats, filt


def zero_launches(dev=None) -> None:
    from repro_torch.kernels import LAUNCHES

    if dev is None or dev.type == "cuda":
        torch.cuda.synchronize()
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check_halves(geom, dev, mats, filt) -> dict:
    """14a: ``reconstruct_shards`` on the two z-halves at their ``z0`` on
    the float32 and int8 wires; their concatenation must equal
    ``reconstruct`` on the same plan bitwise."""
    from repro_torch.core.backproject import reconstruct
    from repro_torch.core.pipeline import reconstruct_shards
    from repro_torch.dispatch import ExecutionPlan
    from repro_torch.kernels import LAUNCHES

    half, L = geom.L // 2, geom.L
    batches = -(-geom.n_proj // PBATCH)
    out = {}
    for wire, plan in (
            ("float32", ExecutionPlan.explicit("scalar", pbatch=PBATCH)),
            ("int8", ExecutionPlan.explicit(
                "strip2", {"strip_dtype": "int8"}, PBATCH))):
        whole = reconstruct(filt, mats, geom, plan=plan, device=dev)
        zero_launches()
        t0 = time.perf_counter()
        slabs = [reconstruct_shards(
            filt, mats, geom, plan,
            torch.zeros((half, L, L), dtype=torch.float32, device=dev),
            z0=z0) for z0 in (0, half)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        same = torch.equal(torch.cat(slabs), whole)
        print(f"  {wire}: slabs z0 = 0, {half} against reconstruct: "
              f"{'bitwise' if same else 'DIFFERENT'}; {wall:.3f} s, "
              f"launches {launches}")
        if not same:
            fail(f"14a: the {wire} slabs differ from reconstruct by "
                 f"{float((torch.cat(slabs) - whole).abs().max()):.3e}")
        # The int8 wire encodes a call's whole stack in one launch.
        want = {"float32": {"backproject": 2 * batches},
                "int8": {"backproject_int8": 2 * batches,
                         "quantize_rows": 2}}[wire]
        if launches != want:
            fail(f"14a: {wire} launches {launches}, want {want}")
        out[wire] = {"launches": launches, "wall_s": wall}
        del whole, slabs
    return out


def check_identity_mesh(geom, dev, projs, mats, filt, scan_s) -> tuple:
    """14b and 14c on a 1x1 mesh (a single-process NCCL group): the
    sharded reconstruction with prefiltered and raw views, bitwise equal
    to the one-card path, then one scan served through
    ``CTFrontDoor(mesh=...)``.  Returns the record and 14b's volume."""
    import torch.distributed as dist

    from repro_torch.api import CTFrontDoor, ProjectionChunk
    from repro_torch.core.backproject import reconstruct
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.pipeline import sharded_reconstruct
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_local_mesh

    rec = {}
    batches = -(-geom.n_proj // PBATCH)
    mesh = make_local_mesh(1, 1, device=dev)
    try:
        print(f"phase 14b: sharded_reconstruct on a 1x1 mesh "
              f"({dist.get_backend()}), strip2, pbatch={PBATCH}")
        # The first call makes the NCCL communicator (the plan's
        # broadcast); the second is the scan's own cost.
        for label, stack, prefiltered in (("first", filt, True),
                                          ("prefiltered", filt, True),
                                          ("raw", projs, False)):
            zero_launches()
            t0 = time.perf_counter()
            vol = sharded_reconstruct(stack, mats, geom, mesh,
                                      pbatch=PBATCH, prefiltered=prefiltered,
                                      device=dev).full_tensor()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = LAUNCHES["backproject"]
            if prefiltered:
                want = reconstruct(filt, mats, geom, strategy="strip2",
                                   pbatch=PBATCH, device=dev)
            else:
                # The whole stack filtered in one call, as the one rank
                # filters it.
                want = reconstruct(filter_projections(projs, geom,
                                                      device=dev),
                                   mats, geom, strategy="strip2",
                                   pbatch=PBATCH, device=dev)
            err = float((vol - want).abs().max())
            what = ("reconstruct" if prefiltered
                    else "filter_projections + reconstruct")
            print(f"  {label}: {wall:.3f} s, row 1 launches {n}; against "
                  f"{what}: max|d| {err:.3e}")
            if not torch.equal(vol, want):
                fail(f"14b: the {label} 1x1 volume differs by {err:.3e}")
            if n != batches:
                fail(f"14b: {n} row 1 launches, want {batches}")
            rec[label] = {"wall_s": wall, "launches": n}
            del want
            if not prefiltered:
                v14b = vol
            del vol

        print(f"phase 14c: CTFrontDoor(mesh=...) serves one scan in "
              f"shuffled chunks of {CHUNK}")
        fd = CTFrontDoor(geom, mesh=mesh, n_slots=1, pbatch=PBATCH,
                         device=dev)
        zero_launches()
        t0 = time.perf_counter()
        vol = asyncio.run(_client(fd, projs, mats, "clinic-a", 3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = LAUNCHES["backproject"]
        same = torch.equal(vol, v14b)
        print(f"  served in {wall:.3f} s (phase 3: {scan_s:.3f} s a scan "
              f"with 2 in flight); row 1 launches {n}; against 14b: "
              f"{'bitwise' if same else 'DIFFERENT'}")
        if not same or n != batches:
            fail(f"14c: served volume equal to 14b: {same}; launches {n}")
        del vol

        async def again():
            ticket = await fd.open_scan()
            one = ProjectionChunk(projs[:1], mats[:1], [0])
            await fd.submit(ticket, one)
            try:
                await fd.submit(ticket, one)
            except ValueError as e:
                return str(e)
            finally:
                await fd.cancel(ticket)
            return None

        msg = asyncio.run(again())
        print(f"  a second submission of angle 0 raises: {msg}")
        if msg is None or "exactly once" not in msg:
            fail("14c: a second submission of one angle did not raise")
        rec["served"] = {"wall_s": wall, "launches": n,
                         "phase3_scan_s": scan_s, "stats": dict(fd.stats)}
    finally:
        dist.destroy_process_group()
    return rec, v14b


def shard_rank(rank: int, tmp: str) -> int:
    """One rank of 14d (``chip_smoke.py --shard-rank RANK DIR``): joins
    the gloo world through a FileStore in DIR, makes phase 3's raw
    views, runs ``sharded_reconstruct(prefiltered=False)`` on the 2x2
    mesh, and writes its slab's error against 14b's planes to DIR."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(_SRC))
    from repro_torch.core.geometry import Geometry, projection_matrices
    from repro_torch.core.phantom import forward_project
    from repro_torch.core.pipeline import sharded_reconstruct
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_local_mesh

    d = pathlib.Path(tmp)
    meta = json.loads((d / "meta.json").read_text())
    world = SHARD_MESH[0] * SHARD_MESH[1]
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        dev = torch.device("cuda", 0)
        geom = Geometry()
        projs = forward_project(geom, device=dev)
        same_data = torch.equal(projs.double().sum(dim=(1, 2)).cpu(),
                                torch.from_numpy(np.load(d / "sums.npy")))
        # Four ranks share the card: each keeps the full stack on the
        # host and moves only its own block to the card.
        projs = projs.cpu()
        torch.cuda.empty_cache()
        mats = projection_matrices(geom)
        mesh = make_local_mesh(*SHARD_MESH, device=dev)
        reduce_s = []
        all_reduce = dist.all_reduce

        def timed(tensor, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            work = all_reduce(tensor, *args, **kwargs)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t)
            return work

        # Twice: the first call pays each process's first uses (the
        # kernel library, cuFFT's plans, the host buffers).
        walls, errs = [], []
        dist.all_reduce = timed
        try:
            for _ in range(2):
                dist.barrier()
                zero_launches()
                t0 = time.perf_counter()
                vol = sharded_reconstruct(projs, mats, geom, mesh,
                                          prefiltered=False, pbatch=PBATCH,
                                          device=dev)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                slab = vol.to_local()
                z0 = mesh.get_local_rank("data") * slab.shape[0]
                want = torch.from_numpy(np.array(np.load(
                    d / "vol.npy", mmap_mode="r")[z0:z0 + slab.shape[0]]))
                errs.append(float((slab - want.to(dev)).abs().max()))
                del want
        finally:
            dist.all_reduce = all_reduce
        launches = LAUNCHES["backproject"]
        err = max(errs)
        top = float(slab.abs().max())
        # The slab's all-reduce again, after a barrier: the transfer
        # without the wait for the partner's fold.
        group = mesh.get_group("model")
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(slab.clone(), group=group)
        torch.cuda.synchronize()
        alone = time.perf_counter() - t
        rec = {"rank": rank, "coordinate": mesh.get_coordinate(), "z0": z0,
               "slab": list(slab.shape), "max_abs_err": err,
               "bound": SHARD_TOL * meta["max_abs"], "max_abs": top,
               "same_data": same_data, "launches": launches,
               "wall_s": walls, "all_reduce_s": reduce_s,
               "all_reduce_alone_s": alone,
               "all_reduce_bytes": slab.numel() * slab.element_size()}
    finally:
        dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(rec))
    ok = same_data and top > 0 and err <= SHARD_TOL * meta["max_abs"]
    return 0 if ok else 1


def check_four_ranks(sums: np.ndarray, v14b: np.ndarray) -> dict:
    """14d: four processes on the one card form a 2x2 mesh over gloo
    and run ``sharded_reconstruct(prefiltered=False)``; each rank's slab
    must lie within SHARD_TOL * max|v| of 14b's planes (``v14b``) and be
    nonzero, and each rank's raw views must have the per-view sums
    ``sums`` of phase 3's.  A rank that fails, or outlasts
    SHARD_TIMEOUT_S, fails the phase."""
    world = SHARD_MESH[0] * SHARD_MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        np.save(d / "vol.npy", v14b)
        np.save(d / "sums.npy", sums)
        (d / "meta.json").write_text(json.dumps(
            {"max_abs": float(np.abs(v14b).max())}))
        t0 = time.perf_counter()
        procs = []
        for r in range(world):
            with open(d / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(pathlib.Path(__file__).resolve()),
                     "--shard-rank", str(r), tmp], stdout=log,
                    stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(1.0, t0 + SHARD_TIMEOUT_S
                                   - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        ranks = []
        for r, p in enumerate(procs):
            out = d / f"rank{r}.json"
            if p.returncode != 0 or not out.is_file():
                tail = (d / f"rank{r}.log").read_text()[-3000:]
                fail(f"14d: rank {r} exited {p.returncode}:\n{tail}")
            ranks.append(json.loads(out.read_text()))
    for r in ranks:
        print(f"  rank {r['rank']} {r['coordinate']}: z0 {r['z0']}, "
              f"max|d| {r['max_abs_err']:.3e} (bound {r['bound']:.3e}), "
              f"row 1 launches {r['launches']} a run; first and second "
              f"run {r['wall_s'][0]:.3f}, {r['wall_s'][1]:.3f} s; slab "
              f"all-reduce {r['all_reduce_bytes'] / 2**20:.0f} MiB: "
              f"{', '.join(f'{t:.3f}' for t in r['all_reduce_s'])} s in the "
              f"runs, {r['all_reduce_alone_s']:.3f} s after a barrier")
    print(f"  four ranks in {wall:.2f} s wall (start-up, data, the run)")
    return {"ranks": ranks, "wall_s": wall}


def run_sharded(geom, dev, card: str, scan_s: float) -> dict:
    """Phase 14 at ``geom``'s full width on phase 3's data; prints the
    details and returns row 1's launches per sub-phase."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    projs, mats, filt = ct_data(geom, dev)
    print(f"phase 14a: reconstruct_shards on the two z-halves of L="
          f"{geom.L}, {geom.n_proj} views")
    halves = check_halves(geom, dev, mats, filt)
    ident, v14b = check_identity_mesh(geom, dev, projs, mats, filt, scan_s)
    sums = projs.double().sum(dim=(1, 2)).cpu().numpy()
    v14b = v14b.cpu().numpy()
    # The card is the four ranks' now.
    del projs, mats, filt
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    print(f"phase 14d: four ranks on the one card, a "
          f"{SHARD_MESH[0]}x{SHARD_MESH[1]} mesh over gloo")
    four = check_four_ranks(sums, v14b)
    del v14b
    phase_s = time.perf_counter() - t0
    print(f"  phase 14 took {phase_s:.2f} s")
    launches = {
        "14a": halves["float32"]["launches"]["backproject"],
        "14b": sum(r["launches"] for k, r in ident.items()
                   if k != "served"),
        "14c": ident["served"]["launches"],
        "14d": sum(r["launches"] for r in four["ranks"])}
    print(json.dumps({"sharded_detail": {
        "card": card, "phase_s": phase_s, "halves": halves,
        "identity_mesh": ident, "four_ranks": four,
        "row1_launches": launches}}))
    return {"backproject_batch": launches,
            "backproject_batch_int8": {
                "14a": halves["int8"]["launches"]["backproject_int8"]},
            "quantize_rows": {
                "14a": halves["int8"]["launches"]["quantize_rows"]}}


# ----------------------------------------------------------------------
# Training (phase 15)
# ----------------------------------------------------------------------

def excess(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max(|got - want| - tol (1 + |want|)): > 0 where the bound fails."""
    return float(((got - want).abs() - tol * (1 + want.abs())).max())


def slstm_bwd_bound(B: int, S: int, di: int, chunk: int):
    """Row 10b's least time for the function it computes, (zifo, r, the
    initial state, dhs) -> (d zifo, d r): per token and feature the
    gates (16 B) and dh (4 B) read and d zifo (16 B) written, the
    initial state, r and d r once; the operations (the kernel's, and the
    B-term sums of d r) over the FP32 peak.  Also what this design does
    beyond them: the bytes of the hidden states and saved (c, n, m) it
    reads (16 B a token and feature) and of the saved state the training
    forward writes for it (12 B), and the operations of the chunked
    scan's composition and second pass over the coefficients (chunks of
    ``chunk`` tokens)."""
    c = census()
    ms, by = c.bound_ms(*c.slstm_backward_terms(B, S, di))
    extra_flops, extra_bytes = c.slstm_backward_extra(B, S, di, chunk)
    return ms, by, extra_bytes, extra_flops


def check_slstm_backward(cfg, dev) -> dict:
    """15a, row 10b against autograd through the plain recurrence."""
    from repro_torch.kernels.slstm import (BWD_CHUNK, BWD_WARPS,
                                           backward_config, launch_slstm,
                                           launch_slstm_backward,
                                           launch_slstm_train)
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_backward_ref)

    di = cfg.d_inner
    lay = backward_config()
    W, T = lay["warps"], lay["chunk"]
    if (W, T) != (BWD_WARPS, BWD_CHUNK):
        fail(f"sLSTM backward: the library is built with W={W}, T={T}, "
             f"the launcher names {BWD_WARPS}, {BWD_CHUNK}")
    print(f"  10b layout: W={W} warps a block, T={T} tokens a chunk, "
          f"pieces of {W * T}; {lay['smem_bytes']} B of shared memory a "
          f"block, {lay['blocks_per_sm']} blocks an SM "
          f"({lay['blocks_per_sm'] * lay['smem_bytes'] / SMEM_PER_SM:.1%} "
          f"of its {SMEM_PER_SM} B)")
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    res = {"layout": lay, "edges": {}}
    for S in (T - 1, T, T + 1, W * T, W * T + 1):
        zifo = torch.randn((1, S, 4, di), generator=g, device=dev)
        dhs = torch.randn((1, S, di), generator=g, device=dev)
        state = init_slstm_state(1, di, device=dev)
        hs, _, states = launch_slstm_train(zifo, r, state)
        dz, dr = launch_slstm_backward(zifo, r, state, hs, states, dhs)
        dz2, dr2 = launch_slstm_backward(zifo, r, state, hs, states, dhs)
        want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
        ez, er = excess(dz, want_z, SLSTM_TOL), excess(dr, want_r, SLSTM_TOL)
        same = torch.equal(dz, dz2) and torch.equal(dr, dr2)
        if ez > 0 or er > 0 or not same:
            fail(f"sLSTM backward edge B=1 S={S}: excess {ez:.3e}, {er:.3e} "
                 f"over SLSTM_TOL; two runs equal {same}")
        res["edges"][S] = {"excess_dzifo": ez, "excess_dr": er}
    print(f"  10b edges B=1, S = {', '.join(map(str, res['edges']))}: "
          f"within {SLSTM_TOL}, two runs equal")
    for B, S in TRAIN_SLSTM_SHAPES:
        zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
        dhs = torch.randn((B, S, di), generator=g, device=dev)
        state = init_slstm_state(B, di, device=dev)
        hs, final, states = launch_slstm_train(zifo, r, state)
        served_hs, served_final = launch_slstm(zifo, r, state)
        dz, dr = launch_slstm_backward(zifo, r, state, hs, states, dhs)
        dz2, dr2 = launch_slstm_backward(zifo, r, state, hs, states, dhs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
        torch.cuda.synchronize()
        plain = 1e3 * (time.perf_counter() - t0)
        if not (torch.equal(hs, served_hs) and torch.equal(final,
                                                          served_final)):
            fail(f"sLSTM training forward B={B} S={S}: not the served "
                 f"kernel's bits")
        if not (torch.equal(dz, dz2) and torch.equal(dr, dr2)):
            fail(f"sLSTM backward B={B} S={S}: two runs differ")
        if not (bool(torch.isfinite(dz).all())
                and bool(torch.isfinite(dr).all())):
            fail(f"sLSTM backward B={B} S={S}: non-finite from a fresh "
                 f"state")
        ez, er = excess(dz, want_z, SLSTM_TOL), excess(dr, want_r, SLSTM_TOL)
        if ez > 0 or er > 0:
            fail(f"sLSTM backward B={B} S={S}: outside rtol = atol = "
                 f"{SLSTM_TOL} of autograd through the plain recurrence "
                 f"(excess {ez:.3e}, {er:.3e})")
        fz = excess(dz, want_z * (1 + TRAIN_FAULT), SLSTM_TOL)
        fr = excess(dr, want_r * (1 + TRAIN_FAULT), SLSTM_TOL)
        if fz <= 0 or (S > 1 and fr <= 0):
            fail(f"sLSTM backward B={B} S={S}: the bound does not see a "
                 f"plain gradient off by 1 + {TRAIN_FAULT} (d zifo "
                 f"{fz:.3e}, d r {fr:.3e})")
        inner = 20 if S <= 64 else 3
        call = lambda: launch_slstm_backward(zifo, r, state, hs,  # noqa: E731
                                             states, dhs)
        ms = device_ms(call, inner)
        parts = launch_parts(call)
        fwd_ms = device_ms(lambda: launch_slstm_train(zifo, r, state), inner)
        served_ms = device_ms(lambda: launch_slstm(zifo, r, state), inner)
        bms, by, extra, extra_ops = slstm_bwd_bound(B, S, di, T)
        err_z = float(((dz - want_z).abs() / (1 + want_z.abs())).max())
        err_r = float(((dr - want_r).abs() / (1 + want_r.abs())).max())
        print(f"  10b B={B} S={S}: d zifo {err_z:.3e}, d r {err_r:.3e} "
              f"(relative; faults seen: d zifo {fz:.2e}, d r {fr:.2e}); "
              f"{ms:.5f} ms per launch on the device (bound {bms:.5f}, "
              f"{by}; the design's extra {extra / 1e6:.1f} MB read here "
              f"and written by the training forward, "
              f"{1e3 * extra / census().PEAK_BYTES_S:.5f} ms at the HBM "
              f"rate, and "
              f"{extra_ops / 1e9:.3f} GFLOP of composition and second "
              f"pass, {1e3 * extra_ops / census().PEAK_FP32_FLOPS:.5f} ms "
              f"at the FP32 peak); parts "
              + ", ".join(f"{k} {t * 1e3:.2f} us x{c:g}" for k, t, c in parts)
              + f"; training forward {fwd_ms:.5f} ms, served forward "
              f"{served_ms:.5f}; plain {plain:.1f} ms")
        res[(B, S)] = {"err_dzifo": err_z, "err_dr": err_r,
                       "fault_excess_dzifo": fz, "fault_excess_dr": fr,
                       "ms": ms, "parts": parts, "train_forward_ms": fwd_ms,
                       "served_forward_ms": served_ms, "plain_ms": plain,
                       "bound_ms": bms, "bound_by": by,
                       "design_extra_bytes": extra,
                       "design_extra_ms": 1e3 * extra / census().PEAK_BYTES_S,
                       "design_extra_flops": extra_ops,
                       "design_extra_ops_ms":
                           1e3 * extra_ops / census().PEAK_FP32_FLOPS}
        del zifo, dhs, hs, states, dz, dz2, want_z
    return res


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of the float32 ``x`` (8 bits of
    mantissa; the smallest normal's below it)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_gather_backward(tables, dev) -> dict:
    """15a, row 9b at each (V, D) of ``tables``, bf16 and f32, at N in
    TRAIN_GATHER_NS with a run of repeated ids and ids -1 and V."""
    from repro_torch.kernels.gather import (BLOCK_MAX_N, GRAD_PATHS,
                                            grad_path,
                                            launch_onehot_gather_grad)
    from repro_torch.kernels.gather_ref import gather_grad_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    res = {"edges": {}}
    for case, V, D, N in TRAIN_GATHER_EDGES:
        N = {"at_limit": BLOCK_MAX_N, "above_limit": BLOCK_MAX_N + 1}.get(
            case, N)
        ids = torch.randint(0, V, (N,), generator=g, device=dev)
        if case == "one_run":
            ids[:] = V // 3
        elif case == "all_out":
            ids = torch.where(torch.arange(N, device=dev) % 2 == 0, -1 - ids,
                              V + ids)
        elif N >= 8:
            ids[0], ids[1] = -1, V
            ids[2:6] = ids[6]
        path = grad_path(N, V)
        for dtype in (torch.bfloat16, torch.float32):
            dout = torch.randn((N, D), generator=g, device=dev).to(dtype)
            before = dict(GRAD_PATHS)
            got = launch_onehot_gather_grad(ids, dout, V)
            again = launch_onehot_gather_grad(ids, dout, V)
            torch.cuda.synchronize()
            took = {k: GRAD_PATHS[k] - before[k] for k in GRAD_PATHS}
            if took[path] != 2 or not torch.equal(got, again) or \
                    not torch.equal(got, gather_grad_ref(ids, dout, V)):
                fail(f"gather backward edge {case} V={V} D={D} N={N} "
                     f"{dtype}: paths {took} (want {path}), not the plain "
                     f"version's bits twice")
        res["edges"][case] = {"V": V, "D": D, "N": N, "path": path}
    print("  9b edges, bitwise the plain version in bf16 and f32, twice: "
          + ", ".join(f"{c} (V={e['V']} D={e['D']} N={e['N']}, "
                      f"{e['path']})" for c, e in res["edges"].items()))
    for V, D in tables:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            for N in TRAIN_GATHER_NS:
                ids = torch.randint(0, V, (N,), generator=g, device=dev)
                ids[0], ids[1] = -1, V
                if N >= 8:
                    ids[2:6] = ids[6]
                dout = torch.randn((N, D), generator=g, device=dev).to(dtype)
                got = launch_onehot_gather_grad(ids, dout, V)
                again = launch_onehot_gather_grad(ids, dout, V)
                torch.cuda.synchronize()
                exact = gather_grad_ref(ids, dout.float(), V)
                faulty = ids.clone()
                faulty[2 if N >= 8 else 3] = -1
                wrong = gather_grad_ref(faulty, dout.float(), V)
                if dtype == torch.float32:
                    ok, seen = torch.equal(got, exact), not torch.equal(
                        got, wrong)
                    err = float((got - exact).abs().max())
                else:
                    ok = bool(((got.float() - exact).abs()
                               <= bf16_ulp(exact)).all())
                    seen = not bool(((got.float() - wrong).abs()
                                     <= bf16_ulp(wrong)).all())
                    err = float(((got.float() - exact).abs()
                                 / bf16_ulp(exact)).max())
                bitwise = torch.equal(got, gather_grad_ref(ids, dout, V))
                if not ok or not seen or not torch.equal(got, again):
                    fail(f"gather backward {name} V={V} N={N}: against the "
                         f"float32 sum in the kernel's order: within "
                         f"bound {ok}, dropped id seen {seen}, repeatable "
                         f"{torch.equal(got, again)}")
                del exact, wrong, again, got
                clamped = ids.clamp(0, V - 1)
                call = lambda: launch_onehot_gather_grad(  # noqa: E731
                    ids, dout, V)
                ms = device_ms(call, 5 if N > 512 or D > 1024 else 20)
                parts = launch_parts(call)
                lib = device_ms(lambda: torch.ops.aten.embedding_dense_backward(
                    dout, clamped, V, -1, False),
                    5 if N > 512 or D > 1024 else 20)
                plain = per_call_ms(lambda: gather_grad_ref(ids, dout, V), 2,
                                    reps=3)
                bms, by = gather_grad_bound(N, V, D, dout.element_size())
                print(f"  9b {name} V={V} D={D} N={N}: "
                      f"{'max|d| ' + str(err) if dtype == torch.float32 else f'{err:.3f} ulp'}"
                      f" vs the ordered float32 sum (bitwise the plain "
                      f"version: {bitwise}); {grad_path(N, V)} path, "
                      f"{ms:.5f} ms per launch on the device (bound "
                      f"{bms:.5f}, {by}; parts "
                      + ", ".join(f"{k} {t * 1e3:.2f} us x{c:g}" for k, t, c in parts)
                      + f"); plain {plain:.3f} ms; F.embedding's gradient "
                      f"{lib:.5f} ms")
                res[(V, name, N)] = {"err": err, "bitwise_plain": bitwise,
                                     "path": grad_path(N, V), "ms": ms,
                                     "parts": parts, "plain_ms": plain,
                                     "library_ms": lib, "bound_ms": bms,
                                     "bound_by": by}
                del dout
            torch.cuda.empty_cache()
    return res


def parse_launcher(out: str) -> dict:
    """The losses, the finish line and the summary of the launcher's
    output."""
    import re

    losses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step\s+(\d+) loss=([-\d.naif]+)", out)}
    fin = re.search(r"finished at step (\d+) \((\d+) restarts\)", out)
    summ = re.search(r"(\d+) steps on \S+: median ([\d.]+) s a step \(first "
                     r"([\d.]+) s; the update median ([\d.]+) s\), "
                     r"([\d.]+) tokens/s; loss ([-\d.naif]+) at step (\d+)"
                     r"(?:; peak allocated ([\d.]+) GiB)?", out)
    every = re.search(r"^losses (\{.*\})$", out, re.M)
    coll = re.search(r"; ([\d.]+) collectives a step", out)
    mesh = re.search(r"mesh=(\{[^}]*\})", out)
    if fin is None or summ is None or every is None or coll is None:
        fail(f"the launcher's output lacks its finish, summary or losses "
             f"line:\n{out[-2000:]}")
    return {"losses": losses, "finished_at": int(fin.group(1)),
            "restarts": int(fin.group(2)), "median_s": float(summ.group(2)),
            "first_s": float(summ.group(3)),
            "median_update_s": float(summ.group(4)),
            "tokens_per_s": float(summ.group(5)),
            "last_loss": float(summ.group(6)),
            "peak_gib": (float(summ.group(8)) if summ.group(8) else None),
            "all_losses": {int(k): v for k, v in
                           json.loads(every.group(1)).items()},
            "collectives": float(coll.group(1)),
            "mesh": mesh.group(1) if mesh else None}


def run_launcher(args: list, timeout: float) -> tuple[dict, float]:
    """``python -m repro_torch.launch.train ARGS`` in a child process on
    this card: its parsed output and wall seconds."""
    env = dict(os.environ, PYTHONPATH=str(_SRC))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *args],
            env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"the launcher {args} outlasted {timeout} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the launcher {args} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    for line in proc.stdout.strip().splitlines():
        print(f"    | {line}")
    return parse_launcher(proc.stdout), wall


def train_launcher_xlstm(cfg) -> dict:
    """15b through the launcher: TRAIN_STEPS steps of xlstm-125m at the
    launcher's defaults, a checkpoint every 5; the loss after the last
    step below the first's, and the checkpoints on disk."""
    from repro_torch.ckpt import all_steps

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        res, wall = run_launcher(["--arch", cfg.name, "--steps",
                                  str(TRAIN_STEPS), "--save-every", "5",
                                  "--ckpt", ck], timeout=600)
        steps = all_steps(ck)
    first, last = res["losses"].get(0), res["last_loss"]
    if res["finished_at"] != TRAIN_STEPS or first is None \
            or not np.isfinite(last) or not last < first \
            or steps != [10, 15, 20]:
        fail(f"xlstm launcher: finished at {res['finished_at']}, loss "
             f"{first} -> {last}, checkpoints {steps}")
    print(f"  launcher: {TRAIN_STEPS} steps in {wall:.1f} s (process), "
          f"loss {first:.4f} -> {last:.4f}, median {res['median_s']:.4f} s "
          f"a step (the update {res['median_update_s']:.4f} of it), "
          f"{res['tokens_per_s']:.1f} tokens/s, peak "
          f"{res['peak_gib']} GiB; checkpoints kept {steps}")
    return dict(res, wall_s=wall, checkpoints=steps)


def train_api(cfg, dev) -> dict:
    """15b through the API: TRAIN_API_STEPS steps of ``cfg`` (onehot) at
    TRAIN_SHAPE, each launching rows 9, 9b, 10 (forward and remat) and
    10b as many times as the model has those layers; the counts read
    after the run are the path's launches."""
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.gather import GRAD_PATHS
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    B, S = TRAIN_SHAPE
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * cfg.n_periods
    per_step = {"onehot_gather": 1, "onehot_gather_backward": 1,
                "slstm": 2 * n_slstm, "slstm_backward": n_slstm}
    ds = TokenDataset(cfg.vocab, S, B, device=str(dev))
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=TRAIN_API_STEPS)
    model = init_model(cfg, seed=SEED, device=dev)
    opt = init_opt_state(model, ocfg)
    update_s = []
    step = make_train_step(cfg, ocfg, update_times=update_s)
    batches = [ds.batch(i) for i in range(TRAIN_API_STEPS)]
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    paths = dict(GRAD_PATHS)
    times, losses, counts = [], [], []
    for b in batches:
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        counts.append({k: LAUNCHES[k] - before[k] for k in per_step})
    launches = dict(LAUNCHES)
    paths = {k: GRAD_PATHS[k] - paths[k] for k in GRAD_PATHS}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if paths != {"block": TRAIN_API_STEPS, "sort": 0}:
        fail(f"API training: row 9b took the paths {paths}, not the "
             f"one-block path at every step")
    bad = [i for i, c in enumerate(counts) if c != per_step]
    if bad or not losses[-1] < losses[0] or not np.isfinite(losses).all():
        fail(f"API training: launches per step {counts[bad[0]] if bad else per_step} "
             f"(want {per_step}), loss {losses[0]} -> {losses[-1]}")
    med = statistics.median(times[1:])
    upd = statistics.median(update_s[1:])
    print(f"  API, onehot: {TRAIN_API_STEPS} steps, launches per step "
          f"{per_step}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; median "
          f"{med:.4f} s a step (first {times[0]:.3f}; the AdamW update "
          f"{upd:.4f} of it), {B * S / med:.1f} tokens/s; peak {peak:.2f} "
          f"GiB")
    del model, opt
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step,
            "gather_grad_paths": paths,
            "losses": losses, "step_s": times, "median_s": med,
            "update_s": update_s, "median_update_s": upd,
            "tokens_per_s": B * S / med, "peak_gib": peak}


def preemption_drill(cfg, dev) -> dict:
    """15b, the drill: DRILL_STEPS steps through ``run_with_restarts``,
    preempted once at each of DRILL_PREEMPT, against the same steps
    uninterrupted: the parameters and the optimizer state bitwise, and
    the drill's peak of allocated memory (above what was allocated
    before it) no more than the uninterrupted run's and one leaf: a
    restart holds one copy of the state."""
    from repro_torch.data import TokenDataset
    from repro_torch.ft.manager import (FaultTolerantLoop,
                                        PreemptionSimulator,
                                        run_with_restarts)
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    B, S = TRAIN_SHAPE
    ds = TokenDataset(cfg.vocab, S, B, device=str(dev))
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=DRILL_STEPS)
    step = make_train_step(cfg, ocfg)

    def init_fn():
        model = init_model(cfg, seed=SEED, device=dev).requires_grad_(True)
        return {"params": model, "opt": init_opt_state(model, ocfg)}

    def step_fn(state, i):
        p, o, m = step(state["params"], state["opt"], ds.batch(i))
        return {"params": p, "opt": o}, m

    def peak_above(base: int) -> int:
        return torch.cuda.max_memory_allocated(dev) - base

    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ref = init_fn()
    for i in range(DRILL_STEPS):
        ref, _ = step_fn(ref, i)
    ref_peak = peak_above(base)
    leaf = max(t.numel() * t.element_size() for t in
               [*ref["params"].parameters(), *ref["opt"]["m"].values()])
    sim, fired = PreemptionSimulator(set(DRILL_PREEMPT)), set()

    def health(i):
        if i in sim.at_steps and i not in fired:
            fired.add(i)
            return True
        return False

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        state, n, restarts = run_with_restarts(
            lambda: FaultTolerantLoop(os.path.join(tmp, "ck"),
                                      save_every=DRILL_SAVE_EVERY,
                                      health=health),
            init_fn, step_fn, DRILL_STEPS)
    wall = time.perf_counter() - t0
    drill_peak = peak_above(base)
    same = all(torch.equal(a, b) for a, b in zip(
        state["params"].parameters(), ref["params"].parameters()))
    for key in ("m", "v"):
        same = same and all(torch.equal(state["opt"][key][k],
                                        ref["opt"][key][k])
                            for k in ref["opt"][key])
    if restarts != len(DRILL_PREEMPT) or n != DRILL_STEPS or not same \
            or drill_peak > ref_peak + leaf:
        fail(f"preemption drill: {restarts} restarts, finished at {n}, "
             f"bitwise equal to the uninterrupted run: {same}; peak "
             f"{drill_peak} B against the uninterrupted {ref_peak} B and "
             f"one leaf {leaf} B")
    print(f"  drill: preempted at {list(DRILL_PREEMPT)}, {restarts} "
          f"restarts, {wall:.1f} s; parameters and moments bitwise the "
          f"uninterrupted run's; peak allocated {drill_peak / 2**30:.3f} "
          f"GiB above the start (uninterrupted {ref_peak / 2**30:.3f})")
    del state, ref
    torch.cuda.empty_cache()
    return {"restarts": restarts, "wall_s": wall, "bitwise": same,
            "peak_bytes": drill_peak, "uninterrupted_peak_bytes": ref_peak}


def check_train_step(cfg, dev) -> dict:
    """15b, kernels against plain versions: one step's gradients of
    ``cfg`` cut to CHECK_PERIODS periods in float32 (onehot) at
    TRAIN_SHAPE, on the kernels and on the plain versions (autograd
    through ``slstm_recurrence_ref`` and ``gather_ref``), every leaf
    within SLSTM_TOL of its largest |plain|, a gradient of ``r`` off by
    1 + TRAIN_FAULT must break that; and the parameters after the step
    from the same state (Adam's first step follows each gradient's
    sign: none more than lr from the plain step's, at most 1 % more
    than lr / 10)."""
    import repro_torch.core.gather_ops as gather_ops
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import slstm_ops
    from repro_torch.kernels.gather_ref import gather_ref
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_recurrence_ref)
    from repro_torch.models import init_model, loss_fn
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.train import _grads

    cut = dataclasses.replace(cfg, n_layers=CHECK_PERIODS * cfg.period,
                              param_dtype="float32", gather_impl="onehot")
    B, S = TRAIN_SHAPE
    batch = TokenDataset(cut.vocab, S, B, device=str(dev)).batch(0)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=0)

    def plain_recurrence(zifo, r, state=None):
        if state is None:
            state = init_slstm_state(zifo.shape[0], zifo.shape[-1],
                                     device=zifo.device)
        return slstm_recurrence_ref(zifo.float(), r.float(), state)

    def run(plain: bool):
        model = init_model(cut, seed=SEED, device=dev).requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(patched(slstm_ops, "slstm_recurrence",
                                            plain_recurrence))
                stack.enter_context(patched(
                    gather_ops, "cuda_onehot_gather",
                    lambda t, i, offset=0: gather_ref(
                        t, i.to(t.device) - offset)))
            zero_launches()
            loss, _ = loss_fn(model, cut, batch)
            grads = {k: v.detach() for k, v in _grads(model, loss).items()}
            model, _, _ = make_train_step(cut, ocfg)(
                model, init_opt_state(model, ocfg), batch)
            torch.cuda.synchronize()
        from repro_torch.kernels import LAUNCHES
        params = {k: p.detach() for k, p in model.named_parameters()}
        return float(loss.detach()), grads, params, dict(LAUNCHES)

    lk, gk, pk, launches = run(False)
    lp, gp, pp, plain_launches = run(True)
    n_slstm = CHECK_PERIODS * sum(k == "slstm" for k in cut.block_pattern)
    if launches["slstm_backward"] != 2 * n_slstm \
            or launches["onehot_gather_backward"] != 2 \
            or any(plain_launches.values()):
        fail(f"train-step check: launches {launches}, plain "
             f"{plain_launches}")

    def worst(grads):
        return max(float((grads[k] - gp[k]).abs().max())
                   / max(float(gp[k].abs().max()), 1e-30) for k in gp)

    err = worst(gk)
    r_name = next(k for k in gp if k.endswith("r_zifo"))
    faulty = dict(gk, **{r_name: gp[r_name] * (1 + TRAIN_FAULT)})
    seen = worst(faulty)
    lr = ocfg.lr
    d = {k: (pk[k] - pp[k]).abs() for k in pp}
    far = sum(int((v > lr / 10).sum()) for v in d.values())
    total = sum(v.numel() for v in d.values())
    dmax = max(float(v.max()) for v in d.values())
    if not err <= SLSTM_TOL or not seen > SLSTM_TOL or dmax > lr \
            or far > total // 100 or abs(lk - lp) > SLSTM_TOL * max(1, abs(lp)):
        fail(f"train-step check: gradients {err:.3e} of each leaf's "
             f"largest (bound {SLSTM_TOL}; fault {seen:.3e}), loss {lk} vs "
             f"{lp}, parameters {dmax:.3e} (lr {lr}), {far} of {total} "
             f"beyond lr/10")
    print(f"  one step at {cut.n_layers} layers, float32: gradients within "
          f"{err:.3e} of each leaf's largest (bound {SLSTM_TOL}; d r off "
          f"by 1 + {TRAIN_FAULT}: {seen:.3e}); loss {lk:.6f} vs {lp:.6f}; "
          f"parameters max |d| {dmax:.3e} (lr {lr}), {far} of {total} "
          f"beyond lr/10")
    del gk, gp, pk, pp
    torch.cuda.empty_cache()
    return {"grad_err": err, "fault": seen, "param_max_d": dmax,
            "param_far": far, "params": total, "launches": launches}


def glm_train_reckoning(cfg) -> dict:
    """The peak a chatglm3-6b step needs with float32 moments: parameters
    and gradients in bf16, two float32 moments, and the float32 logits
    (with their log-softmax and gradient) at TRAIN_SHAPE."""
    n = cfg.param_count()
    B, S = TRAIN_SHAPE
    parts = {"params": 2 * n, "grads": 2 * n, "moments": 8 * n,
             "logits": 3 * 4 * B * S * cfg.vocab}
    parts["total"] = sum(parts.values())
    return parts


def run_train(cfg, glm_cfg, dev, card: str) -> list:
    """Phase 15 on ``cfg`` (xlstm-125m) and ``glm_cfg`` (chatglm3-6b);
    prints the details and returns the ``kernels`` entries of rows 9b
    and 10b, and the main path's launches of rows 9 and 10."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    print(f"phase 15a: the backward kernels vs plain: row 10b at "
          f"di={cfg.d_inner}, row 9b at V={cfg.vocab} D={cfg.d_model} and "
          f"V={glm_cfg.vocab} D={glm_cfg.d_model}")
    bwd = check_slstm_backward(cfg, dev)
    gbwd = check_gather_backward(((cfg.vocab, cfg.d_model),
                                   (glm_cfg.vocab, glm_cfg.d_model)), dev)
    print(f"phase 15b: {cfg.name} trained at full width")
    launcher = train_launcher_xlstm(cfg)
    api = train_api(dataclasses.replace(cfg, gather_impl="onehot"), dev)
    drill = preemption_drill(dataclasses.replace(cfg, gather_impl="onehot"),
                             dev)
    check = check_train_step(cfg, dev)
    reck = glm_train_reckoning(glm_cfg)
    print(f"phase 15c: {glm_cfg.name} trained at full width through the "
          f"launcher's defaults, {GLM_TRAIN_STEPS} steps; reckoned peak "
          f"{reck['total'] / 1e9:.2f} GB ({reck['total'] / 2**30:.2f} GiB: "
          f"{', '.join(f'{k} {v / 1e9:.2f}' for k, v in reck.items() if k != 'total')} GB) "
          f"of {torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        glm, glm_wall = run_launcher(["--steps", str(GLM_TRAIN_STEPS),
                                      "--save-every", "0", "--ckpt",
                                      os.path.join(tmp, "ck")], timeout=900)
    if glm["finished_at"] != GLM_TRAIN_STEPS or not np.isfinite(
            glm["last_loss"]) or not np.isfinite(glm["losses"].get(0, np.nan)):
        fail(f"chatglm3-6b training: {glm}")
    B, S = TRAIN_SHAPE
    print(f"  {glm_cfg.name}: loss {glm['losses'][0]:.4f} -> "
          f"{glm['last_loss']:.4f}; median {glm['median_s']:.4f} s a step "
          f"(first {glm['first_s']:.3f}; the AdamW update "
          f"{glm['median_update_s']:.4f} of it), {glm['tokens_per_s']:.1f} "
          f"tokens/s; peak allocated {glm['peak_gib']} GiB (reckoned "
          f"{reck['total'] / 2**30:.2f}); process {glm_wall:.1f} s")
    phase_s = time.perf_counter() - t_phase
    print(f"  phase 15 took {phase_s:.1f} s")
    src = "src/repro_torch/kernels/csrc/"
    main10 = bwd[TRAIN_SHAPE]
    main9 = gbwd[(cfg.vocab, "bfloat16", B * S)]
    k = [{"name": "slstm_backward", "route": "cuda",
          "source": src + "slstm.cu",
          "replaces": "src/repro/kernels/slstm.py:34",
          "derivative_of": "src/repro/models/ssm.py:317",
          "launches": api["launches"]["slstm_backward"],
          "max_abs_err": max(max(v["err_dzifo"], v["err_dr"])
                             for key, v in bwd.items()
                             if key not in ("layout", "edges")),
          "ms": main10["ms"], "plain_ms": main10["plain_ms"],
          "bound_ms": main10["bound_ms"], "bound_by": main10["bound_by"],
          "library_ms": None,
          "layout": bwd["layout"],
          "by_shape": {f"B={key[0]}/S={key[1]}": v
                       for key, v in bwd.items()
                       if key not in ("layout", "edges")}},
         {"name": "onehot_gather_backward", "route": "cuda",
          "source": src + "gather.cu",
          "replaces": "src/repro/kernels/gather.py:36",
          "derivative_of": "src/repro/core/gather_ops.py:52",
          "launches": api["launches"]["onehot_gather_backward"],
          "paths": api["gather_grad_paths"],
          "max_abs_err": max(v["err"] for key, v in gbwd.items()
                             if key != "edges" and key[1] == "float32"),
          "ms": main9["ms"], "plain_ms": main9["plain_ms"],
          "bound_ms": main9["bound_ms"], "bound_by": main9["bound_by"],
          "library_ms": main9["library_ms"],
          "edges": gbwd["edges"],
          "by_case": {f"V={key[0]}/{key[1]}/N={key[2]}": r
                      for key, r in gbwd.items() if key != "edges"}}]
    print(json.dumps({"train_detail": {
        "card": card, "phase_s": phase_s,
        "launcher_xlstm": launcher, "api_onehot": api, "drill": drill,
        "train_step_check": check, "glm_reckoning": reck,
        "glm": dict(glm, wall_s=glm_wall)}}))
    return k, {"onehot_gather": api["launches"]["onehot_gather"],
               "slstm": api["launches"]["slstm"]}, launcher


# ----------------------------------------------------------------------
# The LM stack under a mesh (phase 16)
# ----------------------------------------------------------------------

# Multi-rank parts run as gloo ranks on the one card (NCCL refuses two
# ranks on one device), as phase 14d does.
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
MESH_TRAIN_STEPS = 5                # 16b, at TRAIN_SHAPE
# 16b against one rank: step 0's loss and gradient norm, then each later
# loss (local batches of 4 change the GEMMs' shapes and bf16 rounding),
# or twice the gap of the same steps on one rank in two microbatches of
# 4 rows (accum_steps=2) where that is larger: in bf16 the warm-up's
# Adam steps amplify any rounding (PR 24's first card run: 1.35e-2 and
# 2.40e-2 at steps 3 and 4, 6e-8 at step 0).
MESH_TRAIN_RTOL = (2e-3, 1e-2)
DECODE_SP_SHAPE = (4, 1024, 64, 8)  # 16c: B, max_len, prompt, decode steps
# x max(1, max|ref|): tests/test_decode_sp.py's bounds, for its "bf16"
# cache (the compute dtype's) and the int8 one.
DECODE_SP_TOL = {"bf16": 2e-3, "int8": 2e-2}
EP_ARCH, EP_DEPTH, EP_SHAPE = "qwen3-moe-235b-a22b", 2, (2, 128)
EP_TOL = 1e-4                       # x max(1, max|ref|): test_moe_ep's


def mesh_cfg(meta: dict):
    """A phase's model config from its ``meta.json``: the named
    architecture, cut by ``reduced`` (CPU rehearsals), with overrides."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[meta["arch"]]
    if meta.get("reduced"):
        cfg = dataclasses.replace(cfg.reduced(), vocab=meta["vocab"])
    return dataclasses.replace(cfg, **meta["over"])


def mesh_meta(cfg, base: dict) -> dict:
    """The ``meta.json`` from which a rank rebuilds ``cfg``: its
    architecture and the fields that differ from the registry's."""
    meta = dict(base, arch=cfg.name, over={})
    ref = mesh_cfg(meta)
    meta["over"] = {f.name: getattr(cfg, f.name)
                    for f in dataclasses.fields(cfg)
                    if getattr(cfg, f.name) != getattr(ref, f.name)}
    return meta


def state_leaves(model, opt) -> dict:
    """The training state's leaves by name: parameters, moments (an int8
    moment's codes and scales), step."""
    out = {f"p/{n}": p for n, p in model.named_parameters()}
    for k in ("m", "v"):
        for n, e in opt[k].items():
            for part, t in (e.items() if isinstance(e, dict)
                            else (("", e),)):
                out[f"{k}/{n}/{part}".rstrip("/")] = t
    out["step"] = opt["step"]
    return out


def digest(t: torch.Tensor) -> str:
    import hashlib

    raw = t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def rank_train(rank: int, d: pathlib.Path, dev, meta: dict) -> dict:
    """16b on one rank: MESH_TRAIN_STEPS steps on the data=MESH_RANKS
    mesh, the launches of rows 9, 9b, 10, 10b, the bytes held, then a
    checkpoint and each leaf's block digest."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.dist import fsdp
    from repro_torch.dist.sharding import ShardingRules, sharding_context
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    cfg = mesh_cfg(meta)
    # 16b: (2, 1); 17b: (2, 2), where the rules' tp=("model",) splits.
    mesh = make_local_mesh(*meta.get("mesh", (MESH_RANKS, 1)), device=dev)
    rules = ShardingRules(batch=("pod", "data"), fsdp=("data",))
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=10,
                       total_steps=MESH_TRAIN_STEPS)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                np.load(d / f"batch{i}.npz").items()}
               for i in range(MESH_TRAIN_STEPS)]
    model = init_model(cfg, seed=SEED, device=dev, mesh=mesh,
                       rules=rules).requires_grad_(True)
    with sharding_context(mesh, rules):
        opt = init_opt_state(model, ocfg)
        step = make_train_step(cfg, ocfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        zero_launches(dev)
        before = dict(fsdp.COUNTS)
        losses, gnorms, times = [], [], []
        for b in batches:
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, b)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        coll = {k: (v - before[k]) / MESH_TRAIN_STEPS
                for k, v in fsdp.COUNTS.items()}
        leaves = state_leaves(model, opt)
        held = {k: sum(fsdp.local(t).numel() * t.element_size()
                       for n, t in leaves.items() if n.startswith(k))
                for k in ("p/", "m/", "v/")}
        full = {k: sum(t.numel() * t.element_size()
                       for n, t in leaves.items() if n.startswith(k))
                for k in ("p/", "m/", "v/")}
        save_checkpoint(str(d / "ck"), MESH_TRAIN_STEPS, {"params": model,
                                                         "opt": opt})
        coord = mesh.get_coordinate()
        blocks = {n: {"sha": digest(fsdp.local(t)),
                      "shards": [[mesh.size(i), pl.dim, coord[i]]
                                 for i, pl in enumerate(getattr(
                                     t, "placements", ()))
                                 if pl.is_shard() and mesh.size(i) > 1]}
                  for n, t in leaves.items()}
    rec = {"ok": True, "losses": losses, "grad_norms": gnorms,
           "step_s": times, "launches": launches,
           "collectives_per_step": coll, "held_bytes": held,
           "full_bytes": full, "blocks": blocks}
    if meta.get("split_checks"):
        from repro_torch.dist import tp

        with sharding_context(mesh, rules):
            s = tp.split()
        rec["split_checks"] = split_kernel_checks(cfg, s.r, s.n, dev)
        rec["ok"] = all(c["ok"] for c in rec["split_checks"].values())
    return rec


def rank_decode(rank: int, d: pathlib.Path, dev, meta: dict) -> dict:
    """16c on one rank: the prefill and decode steps under flash-decoding
    on the (1, MESH_RANKS) mesh, held to the one-rank logits, for each KV
    cache dtype."""
    from repro_torch.dist.sharding import ShardingRules, sharding_context
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import decode_step, init_model, prefill

    B, T, P, n = meta["decode"]
    mesh = make_local_mesh(1, MESH_RANKS, device=dev)
    rules = ShardingRules(batch=("data",), fsdp=(), tp=("model",),
                          sp=("model",), flash_decode=True)
    toks = torch.from_numpy(np.load(d / "tokens.npy")).to(dev)
    model = init_model(mesh_cfg(meta), seed=SEED, device=dev)
    out = {}
    zero_launches(dev)
    with torch.no_grad(), sharding_context(mesh, rules):
        for kv in DECODE_SP_TOL:
            cfg = dataclasses.replace(mesh_cfg(meta), kv_cache_dtype=kv)
            ref = np.load(d / f"logits_{kv}.npy")
            lg, cache = prefill(model, cfg, {"tokens": toks[:, :P]}, T)
            errs = [float((lg[:, 0].float().cpu()
                           - torch.from_numpy(ref[0])).abs().max())]
            ms = []
            for i in range(n):
                sync(dev)
                t0 = time.perf_counter()
                lg, cache = decode_step(model, cfg, cache,
                                        toks[:, P + i:P + i + 1], P + i)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                errs.append(float((lg[:, 0].float().cpu() - torch.from_numpy(
                    ref[i + 1])).abs().max()))
            scale = max(1.0, float(np.abs(ref).max()))
            nbytes = sum(v.numel() * v.element_size()
                         for c in cache["blocks"].values()
                         for v in c.values())
            out[kv] = {"max_abs_err": max(errs), "errs": errs,
                       "scale": scale, "bound": DECODE_SP_TOL[kv] * scale,
                       "decode_ms": ms, "cache_bytes": nbytes,
                       "cache_shape": list(cache["blocks"]["b0"]["k"].shape)}
    ok = all(r["max_abs_err"] <= r["bound"] for r in out.values())
    return {"ok": ok, "by_kv": out, "launches": dict(LAUNCHES)}


def rank_ep(rank: int, d: pathlib.Path, dev, meta: dict) -> dict:
    """16d on one rank: the model placed with its experts split over the
    (1, MESH_RANKS) mesh's ``model`` axis, one forward with
    ``moe_impl="ep"``, held to the one-rank scatter logits."""
    from repro_torch.dist.sharding import ShardingRules, sharding_context
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import forward, init_model

    cfg = mesh_cfg(meta)
    mesh = make_local_mesh(1, MESH_RANKS, device=dev)
    rules = ShardingRules(batch=("data",), fsdp=(), tp=(), ep=("model",))
    toks = torch.from_numpy(np.load(d / "tokens.npy")).to(dev)
    # Each parameter is placed as it is drawn: a rank holds at most one
    # whole parameter beside its blocks.
    model = init_model(cfg, seed=SEED, device=dev, mesh=mesh, rules=rules)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    experts = [p for n, p in model.named_parameters()
               if n.endswith(("w_gate", "w_up", "w_down"))]
    held = sum(p.to_local().numel() * p.element_size() for p in experts)
    total = sum(p.numel() * p.element_size() for p in experts)
    own = experts[0].to_local().shape[0]
    ref = torch.from_numpy(np.load(d / "logits.npy"))
    with torch.no_grad(), sharding_context(mesh, rules):
        sync(dev)
        t0 = time.perf_counter()
        lg, _ = forward(model, cfg, {"tokens": toks}, moe_impl="ep",
                        remat=False)
        sync(dev)
        wall = time.perf_counter() - t0
    err = float((lg.float().cpu() - ref).abs().max())
    bound = EP_TOL * max(1.0, float(ref.abs().max()))
    return {"ok": err <= bound and own == cfg.n_experts // MESH_RANKS,
            "max_abs_err": err, "bound": bound, "own_experts": own,
            "expert_bytes_held": held, "expert_bytes_full": total,
            "forward_s": wall}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_rank(phase: str, rank: int, tmp: str) -> int:
    """One rank of phase 16 (``chip_smoke.py --mesh-rank PHASE RANK
    DIR``): joins the gloo world through a FileStore in DIR, runs the
    phase's part and writes its record to DIR."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(_SRC))
    d = pathlib.Path(tmp)
    meta = json.loads((d / "meta.json").read_text())
    dev = (torch.device("cuda", 0) if meta.get("device", "cuda") == "cuda"
           else torch.device("cpu"))
    world = meta.get("world", MESH_RANKS)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        run = {"16b": rank_train, "16c": rank_decode, "16d": rank_ep,
               "17acd": rank_tp, "17b": rank_train, "17e": rank_tp_whole,
               "17f": rank_tp_whole}[phase]
        rec = run(rank, d, dev, meta)
    finally:
        dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0 if rec["ok"] else 1


def mesh_ranks(phase: str, d: pathlib.Path, n: int = MESH_RANKS) -> list:
    """Run phase ``phase``'s ``n`` ranks on DIR ``d``; their records.
    A rank that fails, or outlasts MESH_TIMEOUT_S, fails the phase."""
    t0 = time.perf_counter()
    procs = []
    for r in range(n):
        with open(d / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--mesh-rank", phase, str(r), str(d)], stdout=log,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + MESH_TIMEOUT_S
                               - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    recs = []
    for r, p in enumerate(procs):
        out = d / f"rank{r}.json"
        if p.returncode != 0 or not out.is_file():
            tail = (d / f"rank{r}.log").read_text()[-3000:]
            detail = out.read_text()[-2000:] if out.is_file() else ""
            fail(f"{phase}: rank {r} exited {p.returncode}:\n{tail}\n"
                 f"{detail}")
        recs.append(json.loads(out.read_text()))
    return recs


def mesh_launcher(cfg, dev, launcher15b: dict) -> dict:
    """16a: the launcher with 15b's arguments (a fresh checkpoint
    directory) on its 1x1 mesh: each step's loss bitwise that of the same
    steps through the API with no mesh, and of 15b's run."""
    from repro_torch.data import TokenDataset
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    with tempfile.TemporaryDirectory() as tmp:
        res, wall = run_launcher(["--arch", cfg.name, "--steps",
                                  str(TRAIN_STEPS), "--save-every", "5",
                                  "--ckpt", os.path.join(tmp, "ck")],
                                 timeout=600)
    B, S = TRAIN_SHAPE
    ds = TokenDataset(vocab=cfg.vocab, seq_len=S, global_batch=B,
                      device=str(dev))
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    model = init_model(cfg, seed=0, device=dev).requires_grad_(True)
    opt = init_opt_state(model, ocfg)
    step = make_train_step(cfg, ocfg)
    plain = []
    for i in range(TRAIN_STEPS):
        model, opt, m = step(model, opt, ds.batch(i))
        plain.append(float(m["loss"]))
    del model, opt
    sync(dev)
    torch.cuda.empty_cache()
    got = [res["all_losses"][i] for i in range(TRAIN_STEPS)]
    same = got == plain and got == [launcher15b["all_losses"][i]
                                    for i in range(TRAIN_STEPS)]
    if not same or res["collectives"] != 0:
        fail(f"16a: the 1x1 mesh's losses {got} against the no-mesh "
             f"{plain} and 15b's; {res['collectives']} collectives a step")
    print(f"  16a: {TRAIN_STEPS} launcher steps on its 1x1 mesh, every "
          f"loss bitwise the no-mesh API's and 15b's; median "
          f"{res['median_s']:.4f} s a step (15b: "
          f"{launcher15b['median_s']:.4f}), {res['collectives']:g} "
          f"collectives a step; process {wall:.1f} s")
    return dict(res, wall_s=wall, bitwise=same)


def one_rank_train(cfg, dev, tmp: pathlib.Path) -> tuple:
    """MESH_TRAIN_STEPS steps of ``cfg`` at TRAIN_SHAPE on one rank, in
    one batch and in two microbatches (the batches written to ``tmp`` for
    the ranks): (the runs' (loss, grad norm, s) a step, the microbatched
    run's loss gaps, and the later steps' loss bounds of a mesh run)."""
    from repro_torch.data import TokenDataset
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    B, S = TRAIN_SHAPE
    ds = TokenDataset(cfg.vocab, S, B, device=str(dev))
    batches = [ds.batch(i) for i in range(MESH_TRAIN_STEPS)]
    for i, b in enumerate(batches):
        np.savez(tmp / f"batch{i}.npz",
                 **{k: v.cpu().numpy() for k, v in b.items()})
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=10,
                       total_steps=MESH_TRAIN_STEPS)
    runs = {}
    for accum in (1, 2):
        model = init_model(cfg, seed=SEED, device=dev).requires_grad_(True)
        opt = init_opt_state(model, ocfg)
        step = make_train_step(cfg, ocfg, accum_steps=accum)
        runs[accum] = []
        for b in batches:
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, b)
            runs[accum].append((float(m["loss"]), float(m["grad_norm"]),
                                time.perf_counter() - t0))
        del model, opt
        sync(dev)
        torch.cuda.empty_cache()
    one, two = runs[1], runs[2]
    micro = [abs(two[i][0] - one[i][0]) / abs(one[i][0])
             for i in range(MESH_TRAIN_STEPS)]
    return one, two, micro, [max(MESH_TRAIN_RTOL[1], 2 * g) for g in micro]


def check_mesh_train(cfg, dev, tmp: pathlib.Path, meta: dict) -> dict:
    """16b: MESH_TRAIN_STEPS steps of ``cfg`` (onehot) on MESH_RANKS gloo
    ranks against the same steps on one rank; the launches and bytes
    per rank; the checkpoint the ranks saved restored on one rank, each
    rank's block of every leaf bitwise."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.models import init_model
    from repro_torch.training import AdamWConfig, init_opt_state

    ocfg = AdamWConfig(lr=3e-3, warmup_steps=10,
                       total_steps=MESH_TRAIN_STEPS)
    (tmp / "meta.json").write_text(json.dumps(meta))
    one, two, micro, later = one_rank_train(cfg, dev, tmp)
    recs = mesh_ranks("16b", tmp)
    r0 = recs[0]
    gaps = [abs(r0["losses"][i] - one[i][0]) / abs(one[i][0])
            for i in range(MESH_TRAIN_STEPS)]
    gn_gap = abs(r0["grad_norms"][0] - one[0][1]) / one[0][1]
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * cfg.n_periods
    per_step = {"onehot_gather": 1, "onehot_gather_backward": 1,
                "slstm": 2 * n_slstm, "slstm_backward": n_slstm}
    bad = [i for i, r in enumerate(recs)
           if any(r["launches"].get(k, 0) != v * MESH_TRAIN_STEPS
                  for k, v in per_step.items())]
    if gaps[0] > MESH_TRAIN_RTOL[0] or gn_gap > MESH_TRAIN_RTOL[0] \
            or any(g > b for g, b in zip(gaps[1:], later[1:])) or bad \
            or recs[1]["losses"] != r0["losses"]:
        fail(f"16b: loss gaps {gaps} (bounds {later}; two microbatches on "
             f"one rank: {micro}), grad-norm gap {gn_gap}, ranks with "
             f"launches off {per_step} a step: {bad}")
    # Restore on one rank; each rank's block of each leaf bitwise.
    model = init_model(cfg, seed=SEED + 1, device=dev)
    tree = {"params": model, "opt": init_opt_state(model, AdamWConfig(
        state_dtype=ocfg.state_dtype))}
    _, at = load_checkpoint(str(tmp / "ck"), tree, in_place=True)
    leaves = state_leaves(tree["params"], tree["opt"])
    mismatched = []
    for r, rec in enumerate(recs):
        for n, blk in rec["blocks"].items():
            t = leaves[n]
            for size, dim, c in blk["shards"]:
                t = t.chunk(size, dim)[c]
            if digest(t) != blk["sha"]:
                mismatched.append((r, n))
    del model, tree
    sync(dev)
    torch.cuda.empty_cache()
    if at != MESH_TRAIN_STEPS or mismatched:
        fail(f"16b: restored step {at}; blocks that differ: "
             f"{mismatched[:5]}")
    for i, r in enumerate(recs):
        share = {k: r["held_bytes"][k] / r["full_bytes"][k]
                 for k in r["held_bytes"]}
        print(f"  16b rank {i}: losses {['%.6f' % x for x in r['losses']]}; "
              f"median {statistics.median(r['step_s'][1:]):.4f} s a step "
              f"(first {r['step_s'][0]:.3f}); launches "
              f"{ {k: r['launches'][k] for k in per_step} }; "
              f"collectives a step {r['collectives_per_step']}; holds "
              f"{r['held_bytes']['p/'] / 2**20:.1f} of "
              f"{r['full_bytes']['p/'] / 2**20:.1f} MiB of parameters "
              f"({share['p/']:.3f}), moments m {share['m/']:.3f}, v "
              f"{share['v/']:.3f}")
    print(f"  16b one rank: losses {['%.6f' % x[0] for x in one]}, median "
          f"{statistics.median(x[2] for x in one[1:]):.4f} s a step; gaps "
          f"{['%.2e' % g for g in gaps]} (bounds "
          f"{['%.2e' % b for b in [MESH_TRAIN_RTOL[0]] + later[1:]]}; one "
          f"rank in two microbatches: {['%.2e' % g for g in micro]}), grad "
          f"norm {gn_gap:.2e}; restored on one rank: every block of "
          f"{len(recs[0]['blocks'])} leaves bitwise")
    return {"ranks": [{k: v for k, v in r.items() if k != "blocks"}
                      for r in recs],
            "one_rank": one, "one_rank_accum2": two, "loss_gaps": gaps,
            "accum2_gaps": micro, "bounds": later, "grad_norm_gap": gn_gap,
            "per_step": per_step}


def check_decode_sp(cfg, dev, tmp: pathlib.Path, meta: dict) -> dict:
    """16c: ``cfg`` (onehot) decoded under flash-decoding on MESH_RANKS
    gloo ranks, against one rank's plain decode of the same tokens, with
    the bf16 and int8 caches."""
    from repro_torch.models.model import decode_step, init_model, prefill

    B, T, P, n = DECODE_SP_SHAPE
    (tmp / "meta.json").write_text(json.dumps(dict(meta,
                                                   decode=DECODE_SP_SHAPE)))
    toks = seeded_ints(cfg.vocab, (B, P + n), dev, SEED + 16)
    np.save(tmp / "tokens.npy", toks.cpu().numpy())
    model = init_model(cfg, seed=SEED, device=dev)
    plain_ms, cache_bytes = {}, {}
    with torch.no_grad():
        for kv in DECODE_SP_TOL:
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            lg, cache = prefill(model, c, {"tokens": toks[:, :P]}, T)
            rows, ms = [lg[:, 0].float().cpu()], []
            for i in range(n):
                sync(dev)
                t0 = time.perf_counter()
                lg, cache = decode_step(model, c, cache,
                                        toks[:, P + i:P + i + 1], P + i)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                rows.append(lg[:, 0].float().cpu())
            np.save(tmp / f"logits_{kv}.npy", torch.stack(rows).numpy())
            plain_ms[kv] = ms
            cache_bytes[kv] = sum(v.numel() * v.element_size()
                                  for leaves in cache["blocks"].values()
                                  for v in leaves.values())
            del cache
    del model
    sync(dev)
    torch.cuda.empty_cache()
    recs = mesh_ranks("16c", tmp)
    for i, r in enumerate(recs):
        for kv, v in r["by_kv"].items():
            print(f"  16c rank {i} {kv}: max|d| {v['max_abs_err']:.3e} "
                  f"(bound {v['bound']:.3e}); cache k {v['cache_shape']} "
                  f"(periods, rows, positions, heads, hd), "
                  f"{v['cache_bytes'] / 2**20:.1f} of "
                  f"{cache_bytes[kv] / 2**20:.1f} MiB; "
                  f"decode median {statistics.median(v['decode_ms'][1:]):.2f}"
                  f" ms a step (one rank, plain: "
                  f"{statistics.median(plain_ms[kv][1:]):.2f})")
        if r["launches"].get("onehot_gather") != 2 * (n + 1):
            fail(f"16c: rank {i} launched row 9 {r['launches']} times, "
                 f"not {2 * (n + 1)}")
    return {"ranks": recs, "plain_ms": plain_ms,
            "one_rank_cache_bytes": cache_bytes}


def check_ep(cfg, dev, tmp: pathlib.Path, meta: dict) -> dict:
    """16d: one forward of ``cfg`` with ``moe_impl="ep"`` on MESH_RANKS
    gloo ranks (each with its experts) against one rank's ``scatter``,
    run before the ranks."""
    from repro_torch.models.model import forward, init_model

    (tmp / "meta.json").write_text(json.dumps(meta))
    toks = seeded_ints(cfg.vocab, EP_SHAPE, dev, SEED + 17)
    np.save(tmp / "tokens.npy", toks.cpu().numpy())
    model = init_model(cfg, seed=SEED, device=dev)
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        lg, _ = forward(model, cfg, {"tokens": toks}, moe_impl="scatter",
                        remat=False)
        sync(dev)
        wall = time.perf_counter() - t0
    np.save(tmp / "logits.npy", lg.float().cpu().numpy())
    del model, lg
    sync(dev)
    torch.cuda.empty_cache()
    recs = mesh_ranks("16d", tmp)
    for i, r in enumerate(recs):
        print(f"  16d rank {i}: max|d| {r['max_abs_err']:.3e} (bound "
              f"{r['bound']:.3e}); holds {r['own_experts']} of "
              f"{cfg.n_experts} experts, {r['expert_bytes_held'] / 1e9:.2f} "
              f"of {r['expert_bytes_full'] / 1e9:.2f} GB; forward "
              f"{r['forward_s']:.3f} s (one rank, scatter: {wall:.3f})")
    return {"ranks": recs, "one_rank_forward_s": wall}


def run_mesh(xcfg, glm_cfg, moe_cfg, dev, card: str, launcher15b: dict,
             reduced: dict | None = None) -> dict:
    """Phase 16 on ``xcfg`` (xlstm-125m), ``glm_cfg`` (chatglm3-6b) and
    ``moe_cfg`` (qwen3-moe at EP_DEPTH layers); prints the details and
    returns the ranks' launches of rows 9, 9b, 10 and 10b, and 16b's
    record (phase 17 holds its ranks to 16b's one-rank runs).  ``reduced``
    (``{"vocab": V}``) has the ranks rebuild reduced configs (CPU
    rehearsals)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = {"device": dev.type, **({"reduced": True, **reduced}
                                   if reduced else {})}
    print(f"phase 16a: {xcfg.name} through the launcher on its 1x1 mesh")
    a = mesh_launcher(xcfg, dev, launcher15b)
    onehot = dataclasses.replace(xcfg, gather_impl="onehot")
    print(f"phase 16b: {xcfg.name} (onehot) on {MESH_RANKS} gloo ranks, "
          f"data={MESH_RANKS}, {MESH_TRAIN_STEPS} steps of "
          f"{TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]}")
    # float32, as tests/test_decode_sp.py runs the reference: in bfloat16
    # the logits are bf16 values, whose ulp at max|ref| is above the bound.
    glm = dataclasses.replace(glm_cfg, gather_impl="onehot",
                              param_dtype="float32")
    moe = dataclasses.replace(moe_cfg, param_dtype="float32",
                              capacity_factor=moe_cfg.n_experts
                              / moe_cfg.top_k)
    with tempfile.TemporaryDirectory() as t1, \
            tempfile.TemporaryDirectory() as t2, \
            tempfile.TemporaryDirectory() as t3:
        b = check_mesh_train(onehot, dev, pathlib.Path(t1),
                             mesh_meta(onehot, base))
        print(f"phase 16c: {glm.name} (float32) decoded under "
              f"flash-decoding on a "
              f"(1, {MESH_RANKS}) mesh, B={DECODE_SP_SHAPE[0]}, max_len="
              f"{DECODE_SP_SHAPE[1]}, a {DECODE_SP_SHAPE[2]}-token prefill "
              f"and {DECODE_SP_SHAPE[3]} steps, bf16 and int8 caches")
        c = check_decode_sp(glm, dev, pathlib.Path(t2), mesh_meta(glm, base))
        print(f"phase 16d: {moe.name} ({moe.n_layers} layers, float32) "
              f"with moe_impl='ep' on a (1, {MESH_RANKS}) mesh, "
              f"{EP_SHAPE[0]} x {EP_SHAPE[1]} tokens")
        d = check_ep(moe, dev, pathlib.Path(t3), mesh_meta(moe, base))
    phase_s = time.perf_counter() - t0
    print(f"  phase 16 took {phase_s:.1f} s")
    launches = {k: {"16b": [r["launches"][k] for r in b["ranks"]]}
                for k in ("onehot_gather", "onehot_gather_backward",
                          "slstm", "slstm_backward")}
    launches["onehot_gather"]["16c"] = [r["launches"]["onehot_gather"]
                                        for r in c["ranks"]]
    print(json.dumps({"mesh_detail": {
        "card": card, "phase_s": phase_s, "launcher_1x1": a,
        "train_data2": b, "decode_sp": c, "ep": d}}))
    return launches, b


# ----------------------------------------------------------------------
# Tensor and sequence parallelism (phase 17)
# ----------------------------------------------------------------------

TP_RANKS = 2                        # 17a, 17c, 17d: a (1, 2) mesh
TP_TRAIN_MESH = (2, 2)              # 17b: (data, model)
TP_PROMPTS = 4                      # 17a: prompts of LM_PROMPT tokens
TP_DECODE = 8                       # 17a: teacher-forced decode steps
# x max(1, max|ref|) per element: 16c's float32 bound (17a, 17d's
# logits); 16d's for the experts split over the ranks (17c).
TP_TOL = 1e-5
TP_JAMBA = (64, 4)                  # 17c: prompt, decode steps
TP_JAMBA_TOL = 1e-4
TP_SP = (4, 2, 256)                 # 17d: depth, B, S
TP_SP_RTOL = 1e-5                   # 17d: the loss and the gradient norm
TP_GATHER = ((25152, 768, "bfloat16", 512), (32512, 4096, "float32", 4),
             (32512, 4096, "float32", 512))   # rows 9/9b: a rank's V/2
TP_SLSTM = ((1, 64), (4, 64))       # rows 10/10b at di/2: (B, S)
TP_KERNELS = ("onehot_gather", "onehot_gather_backward", "slstm",
              "slstm_backward")


def tp_rules(sp: bool = False, ep: bool = False):
    from repro_torch.dist.sharding import ShardingRules

    return ShardingRules(batch=("data",), fsdp=(), tp=("model",),
                         ep=("model",) if ep else (),
                         sp_act=("model",) if sp else ())


def free(dev) -> None:
    """Return the memory of what the caller dropped to the card at once
    (a reference cycle would keep a model alive until a collection)."""
    import gc

    gc.collect()
    sync(dev)
    torch.cuda.empty_cache()


def held_bytes(model) -> tuple[int, int]:
    """(bytes this rank holds, bytes of the whole model)."""
    from repro_torch.dist import fsdp

    ps = list(model.parameters())
    return (sum(fsdp.local(p).numel() * p.element_size() for p in ps),
            sum(p.numel() * p.element_size() for p in ps))


def cache_bytes(cache: dict) -> int:
    return sum(v.numel() * v.element_size()
               for leaves in cache["blocks"].values()
               for v in leaves.values())


def tp_decode(model, cfg, prompts, dev, moe_impl="scatter", steps=TP_DECODE):
    """Each prompt's prefill and ``steps`` teacher-forced decode steps:
    (logits (prompts, steps + 1, V) float32 on the host, ms per decode
    step, cache bytes of the last prompt, collectives per step)."""
    from repro_torch.dist import fsdp
    from repro_torch.models.model import decode_step, prefill

    rows, ms, coll = [], [], []
    for p in prompts:
        L = p.shape[1] - steps
        lg, cache = prefill(model, cfg, {"tokens": p[:, :L]}, L + steps,
                            moe_impl=moe_impl)
        out = [lg[0, -1].float().cpu()]
        for i in range(steps):
            sync(dev)
            before = sum(fsdp.COUNTS.values())
            t0 = time.perf_counter()
            lg, cache = decode_step(model, cfg, cache, p[:, L + i:L + i + 1],
                                    L + i, moe_impl=moe_impl)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            coll.append(sum(fsdp.COUNTS.values()) - before)
            out.append(lg[0, -1].float().cpu())
        rows.append(torch.stack(out))
    return torch.stack(rows), ms, cache_bytes(cache), coll


def rank_tp(rank: int, d: pathlib.Path, dev, meta: dict) -> dict:
    """17a, 17c and 17d on one rank of the (1, TP_RANKS) mesh."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import sharding_context
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import forward, init_model, loss_fn
    from repro_torch.training.optim import global_norm

    mesh = make_local_mesh(1, TP_RANKS, device=dev)
    rec = {"ok": True}
    prompts = [torch.from_numpy(np.load(d / f"prompt{i}.npy")).to(dev)
               for i in range(TP_PROMPTS)]
    glm = mesh_cfg(meta["glm"])
    rules = tp_rules()
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(glm, param_dtype=dtype)
        model = init_model(cfg, seed=SEED, device=dev, mesh=mesh,
                           rules=rules)
        zero_launches(dev)
        with torch.no_grad(), sharding_context(mesh, rules):
            lg, ms, cbytes, coll = tp_decode(model, cfg, prompts, dev)
        held, full = held_bytes(model)
        r = {"ms": ms, "cache_bytes": cbytes, "collectives": coll,
             "held_bytes": held, "full_bytes": full,
             "launches": {k: LAUNCHES[k] for k in TP_KERNELS}}
        if dtype == "float32":
            ref = torch.from_numpy(np.load(d / "glm_float32.npy"))
            r["max_abs_err"] = float((lg - ref).abs().max())
            r["bound"] = TP_TOL * max(1.0, float(ref.abs().max()))
            rec["ok"] &= r["max_abs_err"] <= r["bound"]
        else:
            ref = np.load(d / "glm_bfloat16_tokens.npy")
            r["agreement"] = float((lg.argmax(-1).numpy() == ref).mean())
        rec[f"17a_{dtype}"] = r
        del model
        free(dev)
        dist.barrier()
    # 17c: jamba, its experts over ep and the rest over tp.
    cfg = mesh_cfg(meta["jamba"])
    rules = tp_rules(ep=True)
    model = init_model(cfg, seed=SEED, device=dev, mesh=mesh, rules=rules)
    toks = torch.from_numpy(np.load(d / "jamba_tokens.npy")).to(dev)
    zero_launches(dev)
    with torch.no_grad(), sharding_context(mesh, rules):
        lg, ms, cbytes, coll = tp_decode(model, cfg, [toks], dev,
                                         moe_impl="ep", steps=TP_JAMBA[1])
    ref = torch.from_numpy(np.load(d / "jamba.npy"))
    held, full = held_bytes(model)
    err = float((lg - ref).abs().max())
    bound = TP_JAMBA_TOL * max(1.0, float(ref.abs().max()))
    rec["17c"] = {"max_abs_err": err, "bound": bound, "ms": ms,
                  "cache_bytes": cbytes, "collectives": coll,
                  "held_bytes": held, "full_bytes": full}
    rec["ok"] &= err <= bound
    del model
    free(dev)
    dist.barrier()
    # 17d: the stream split along the sequence.
    cfg = mesh_cfg(meta["sp"])
    rules = tp_rules(sp=True)
    model = init_model(cfg, seed=SEED, device=dev, mesh=mesh, rules=rules)
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in np.load(d / "sp_batch.npz").items()}
    want = json.loads((d / "sp_ref.json").read_text())
    with sharding_context(mesh, rules):
        with torch.no_grad():
            lg, _ = forward(model, cfg, {"tokens": batch["tokens"]},
                            remat=False)
        ref = torch.from_numpy(np.load(d / "sp_logits.npy"))
        err = float((lg.float().cpu() - ref).abs().max())
        sync(dev)
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, cfg, batch)
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        gnorm = float(global_norm(dict(zip(named, grads))))
        sync(dev)
        wall = time.perf_counter() - t0
    bound = TP_TOL * max(1.0, float(ref.abs().max()))
    gaps = {"loss": abs(float(loss.detach()) - want["loss"]) / want["loss"],
            "grad_norm": abs(gnorm - want["grad_norm"]) / want["grad_norm"]}
    rec["17d"] = {"max_abs_err": err, "bound": bound,
                  "loss": float(loss.detach()),
                  "grad_norm": gnorm, "gaps": gaps, "step_s": wall}
    rec["ok"] &= err <= bound and max(gaps.values()) <= TP_SP_RTOL
    return rec


def split_kernel_checks(cfg, r: int, n: int, dev) -> dict:
    """Rows 9, 9b, 10 and 10b at this tensor-parallel rank's shapes
    (rank ``r`` of ``n``: V/n rows from r V/n, di/n units), each held to
    its plain version: 9 and 9b bitwise (9b's ids about half outside the
    block), 10 and 10b at SLSTM_TOL."""
    from repro_torch.kernels.gather import launch_onehot_gather_grad
    from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
    from repro_torch.kernels.gather_ref import gather_grad_ref, gather_ref
    from repro_torch.kernels.slstm import (launch_slstm,
                                           launch_slstm_backward,
                                           launch_slstm_train)
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_backward_ref,
                                               slstm_recurrence_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 17 + r)
    V, D = cfg.vocab // n, cfg.d_model
    off = r * V
    ids = torch.randint(0, cfg.vocab, (TRAIN_SHAPE[0] * TRAIN_SHAPE[1],),
                        generator=g, device=dev)
    ids[0], ids[1] = off - 1, off + V
    table = torch.randn((V, D), generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn((ids.shape[0], D), generator=g,
                       device=dev).to(torch.bfloat16)
    got = cuda_onehot_gather(table, ids, offset=off)
    grad = launch_onehot_gather_grad(ids, dout, V, off)
    inside = float(((ids >= off) & (ids < off + V)).float().mean())
    out = {"row9": {"V": V, "offset": off, "ok": torch.equal(
               got, gather_ref(table, ids - off))},
           "row9b": {"V": V, "inside": inside, "ok": torch.equal(
               grad, gather_grad_ref(ids - off, dout, V))}}
    di = cfg.d_inner // n
    B, S = TRAIN_SHAPE[0] // 2, TRAIN_SHAPE[1]
    zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
    rr = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    state = init_slstm_state(B, di, device=dev)
    dhs = torch.randn((B, S, di), generator=g, device=dev)
    hs, _ = launch_slstm(zifo, rr, state)
    ths, _, states = launch_slstm_train(zifo, rr, state)
    dz, dr = launch_slstm_backward(zifo, rr, state, ths, states, dhs)
    want, _ = slstm_recurrence_ref(zifo, rr, state)
    wz, wr = slstm_backward_ref(zifo, rr, state, dhs)
    out["row10"] = {"di": di, "excess": excess(hs, want, SLSTM_TOL)}
    out["row10b"] = {"di": di, "excess": max(excess(dz, wz, SLSTM_TOL),
                                             excess(dr, wr, SLSTM_TOL))}
    for k in ("row10", "row10b"):
        out[k]["ok"] = out[k]["excess"] <= 0
    sync(dev)
    return out


def tp_refs(glm, jamba, sp_cfg, dev, d: pathlib.Path) -> dict:
    """One rank's runs that phase 17 holds the ranks to, written to
    ``d``: 17a's logits (float32) and greedy tokens (bfloat16), 17c's
    logits, 17d's logits, loss and gradient norm."""
    from repro_torch.models.model import forward, init_model, loss_fn
    from repro_torch.training.optim import global_norm

    rng = np.random.default_rng(SEED + 17)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, TP_PROMPTS)
    prompts = []
    for i, L in enumerate(lens):
        p = seeded_ints(glm.vocab, (1, int(L) + TP_DECODE), dev,
                        SEED + 170 + i)
        np.save(d / f"prompt{i}.npy", p.cpu().numpy())
        prompts.append(p)
    out = {"prompt_lens": [int(x) for x in lens]}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(glm, param_dtype=dtype)
        model = init_model(cfg, seed=SEED, device=dev)
        with torch.no_grad():
            lg, ms, cbytes, _ = tp_decode(model, cfg, prompts, dev)
        if dtype == "float32":
            np.save(d / "glm_float32.npy", lg.numpy())
        else:
            np.save(d / "glm_bfloat16_tokens.npy", lg.argmax(-1).numpy())
        out[f"17a_{dtype}"] = {"ms": ms, "cache_bytes": cbytes,
                               "param_bytes": held_bytes(model)[1]}
        del model
        sync(dev)
        torch.cuda.empty_cache()
    model = init_model(jamba, seed=SEED, device=dev)
    toks = seeded_ints(jamba.vocab, (1, sum(TP_JAMBA)), dev, SEED + 171)
    np.save(d / "jamba_tokens.npy", toks.cpu().numpy())
    with torch.no_grad():
        lg, ms, cbytes, _ = tp_decode(model, jamba, [toks], dev,
                                      steps=TP_JAMBA[1])
    np.save(d / "jamba.npy", lg.numpy())
    out["17c"] = {"ms": ms, "cache_bytes": cbytes,
                  "param_bytes": held_bytes(model)[1]}
    del model
    sync(dev)
    torch.cuda.empty_cache()
    _, B, S = TP_SP
    batch = {"tokens": seeded_ints(sp_cfg.vocab, (B, S), dev, SEED + 172),
             "labels": seeded_ints(sp_cfg.vocab, (B, S), dev, SEED + 173)}
    np.savez(d / "sp_batch.npz", **{k: v.cpu().numpy()
                                    for k, v in batch.items()})
    model = init_model(sp_cfg, seed=SEED, device=dev).requires_grad_(True)
    with torch.no_grad():
        lg, _ = forward(model, sp_cfg, {"tokens": batch["tokens"]},
                        remat=False)
    np.save(d / "sp_logits.npy", lg.float().cpu().numpy())
    sync(dev)
    t0 = time.perf_counter()
    loss, _ = loss_fn(model, sp_cfg, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    gnorm = float(global_norm(dict(zip(named, grads))))
    sync(dev)
    out["17d"] = {"loss": float(loss.detach()), "grad_norm": gnorm,
                  "step_s": time.perf_counter() - t0}
    (d / "sp_ref.json").write_text(json.dumps(out["17d"]))
    del model, grads, lg
    sync(dev)
    torch.cuda.empty_cache()
    return out


def time_split_kernels(xcfg, glm, dev) -> dict:
    """Rows 9, 9b, 10 and 10b timed at a tp = 2 rank's shapes (one
    process): ms on the device, the plain version's, the bound and, for
    9 and 9b, the PyTorch call for the same function."""
    from repro_torch.kernels.gather import launch_onehot_gather_grad
    from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
    from repro_torch.kernels.gather_ref import gather_grad_ref, gather_ref
    from repro_torch.kernels.slstm import (BWD_CHUNK, launch_slstm,
                                           launch_slstm_backward,
                                           launch_slstm_train)
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_backward_ref,
                                               slstm_recurrence_ref)

    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    out = {"row9": {}, "row9b": {}, "row10": {}, "row10b": {}}
    for V, D, dt, N in TP_GATHER:
        dtype = getattr(torch, dt)
        ids = torch.randint(0, 2 * V, (N,), generator=g, device=dev)
        table = torch.randn((V, D), generator=g, device=dev).to(dtype)
        dout = torch.randn((N, D), generator=g, device=dev).to(dtype)
        local = ids - V                  # rank 1: about half out of range
        inside = (local >= 0) & (local < V)
        clamped = local.clamp(0, V - 1)
        inner = 5 if N > 512 or D > 1024 else 20
        key = f"V={V} D={D} {dt} N={N}"
        ms = device_ms(lambda: cuda_onehot_gather(table, ids, offset=V),
                       inner)
        lib = device_ms(lambda: F.embedding(clamped, table), inner)
        plain = per_call_ms(lambda: gather_ref(table, local), 2, reps=3)
        bms, by = gather_bound(N, D, dtype.itemsize, int(inside.sum()))
        # The launch the kernels' offset saves: ids - offset on its own.
        sub = device_ms(lambda: ids - V, inner)
        out["row9"][key] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                            "bound_ms": bms, "bound_by": by,
                            "subtract_ms": sub}
        ms = device_ms(lambda: launch_onehot_gather_grad(ids, dout, V, V),
                       inner)
        lib = device_ms(lambda: torch.ops.aten.embedding_dense_backward(
            dout, clamped, V, -1, False), inner)
        plain = per_call_ms(lambda: gather_grad_ref(local, dout, V), 2,
                            reps=3)
        bms, by = gather_grad_bound(N, V, D, dtype.itemsize)
        out["row9b"][key] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                             "bound_ms": bms, "bound_by": by,
                             "inside": float(inside.float().mean())}
    di = xcfg.d_inner // 2
    for B, S in TP_SLSTM:
        zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
        r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
        state = init_slstm_state(B, di, device=dev)
        dhs = torch.randn((B, S, di), generator=g, device=dev)
        key = f"di={di} B={B} S={S}"
        bms, by = slstm_bound(B, S, di)
        out["row10"][key] = {
            "ms": device_ms(lambda: launch_slstm(zifo, r, state)),
            "plain_ms": per_call_ms(
                lambda: slstm_recurrence_ref(zifo, r, state), 1, reps=3),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
        hs, _, states = launch_slstm_train(zifo, r, state)
        bms, by, _, _ = slstm_bwd_bound(B, S, di, BWD_CHUNK)
        out["row10b"][key] = {
            "ms": device_ms(lambda: launch_slstm_backward(
                zifo, r, state, hs, states, dhs)),
            "plain_ms": per_call_ms(
                lambda: slstm_backward_ref(zifo, r, state, dhs), 1, reps=3),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
    for row, entries in out.items():
        for key, e in entries.items():
            lib = ("" if e["library_ms"] is None
                   else f", library {e['library_ms']:.5f}")
            if "subtract_ms" in e:
                lib += f"; ids - offset alone {e['subtract_ms']:.5f}"
            print(f"  17 {row} {key}: {e['ms']:.5f} ms (bound "
                  f"{e['bound_ms']:.5f}, {e['bound_by']}; plain "
                  f"{e['plain_ms']:.4f}{lib})")
    return out


def run_tp(xcfg, glm_cfg, jamba_cfg, dev, card: str,
           b16: dict | None = None,
           reduced: dict | None = None) -> tuple[dict, dict]:
    """Phase 17: ``glm_cfg`` (chatglm3-6b) decoded on a (1, TP_RANKS)
    ``tp`` mesh (17a), ``xcfg`` (xlstm-125m) trained on a TP_TRAIN_MESH
    mesh against 16b's one-rank runs ``b16`` (run here when ``None``;
    17b), ``jamba_cfg`` at one period under ``tp=ep`` (17c), chatglm3-6b
    cut to TP_SP[0] layers under ``sp_act`` (17d), whisper-small and
    xlstm-125m where ``tp`` does not divide some of their widths (17e,
    17f: :data:`TP_WHOLE`), then rows 9, 9b, 10 and 10b timed at the
    split shapes.  Returns the ranks' launches and the timings."""
    t0 = time.perf_counter()
    print(card)
    torch.cuda.empty_cache()
    base = {"device": dev.type, **({"reduced": True, **reduced}
                                   if reduced else {})}
    glm = dataclasses.replace(glm_cfg, gather_impl="onehot",
                              param_dtype="float32")
    jamba = dataclasses.replace(jamba_cfg, param_dtype="float32",
                                capacity_factor=jamba_cfg.n_experts
                                / jamba_cfg.top_k)
    sp_cfg = dataclasses.replace(glm, n_layers=TP_SP[0])
    onehot = dataclasses.replace(xcfg, gather_impl="onehot")
    with tempfile.TemporaryDirectory() as t1, \
            tempfile.TemporaryDirectory() as t2:
        d1, d2 = pathlib.Path(t1), pathlib.Path(t2)
        print("phase 17: one rank's runs of 17a, 17c and 17d")
        ref = tp_refs(glm, jamba, sp_cfg, dev, d1)
        (d1 / "meta.json").write_text(json.dumps(dict(
            base, world=TP_RANKS, glm=mesh_meta(glm, base),
            jamba=mesh_meta(jamba, base), sp=mesh_meta(sp_cfg, base))))
        print(f"phase 17a/c/d: {TP_RANKS} gloo ranks, (1, {TP_RANKS}) mesh")
        recs = mesh_ranks("17acd", d1, TP_RANKS)
        train = check_tp_train(onehot, dev, d2, base, b16)
    whole = check_tp_whole(dev, base)
    one32 = ref["17a_float32"]
    layers = glm.n_layers
    for i, r in enumerate(recs):
        a, a16 = r["17a_float32"], r["17a_bfloat16"]
        per_step = statistics.median(a["collectives"])
        print(f"  17a rank {i} float32: max|d| {a['max_abs_err']:.3e} "
              f"(bound {a['bound']:.3e}); holds "
              f"{a['held_bytes'] / 1e9:.2f} of {a['full_bytes'] / 1e9:.2f} "
              f"GB of parameters ({a['held_bytes'] / a['full_bytes']:.3f}),"
              f" cache {a['cache_bytes'] / 2**20:.2f} of "
              f"{one32['cache_bytes'] / 2**20:.2f} MiB "
              f"({a['cache_bytes'] / one32['cache_bytes']:.3f}); "
              f"{per_step:g} collectives a decode step ({layers} layers); "
              f"decode median {statistics.median(a['ms']):.2f} ms a step "
              f"(one rank: {statistics.median(one32['ms']):.2f}); bf16 "
              f"greedy tokens agree {a16['agreement']:.3f}, decode median "
              f"{statistics.median(a16['ms']):.2f} ms (one rank: "
              f"{statistics.median(ref['17a_bfloat16']['ms']):.2f})")
        want9 = TP_PROMPTS * (1 + TP_DECODE)
        if a["launches"].get("onehot_gather") != want9:
            fail(f"17a: rank {i} launched row 9 {a['launches']} times, "
                 f"not {want9}")
        c = r["17c"]
        print(f"  17c rank {i}: max|d| {c['max_abs_err']:.3e} (bound "
              f"{c['bound']:.3e}); holds {c['held_bytes'] / 1e9:.2f} of "
              f"{c['full_bytes'] / 1e9:.2f} GB; decode median "
              f"{statistics.median(c['ms']):.2f} ms (one rank: "
              f"{statistics.median(ref['17c']['ms']):.2f}), "
              f"{statistics.median(c['collectives']):g} collectives a step")
        s_ = r["17d"]
        print(f"  17d rank {i}: logits max|d| {s_['max_abs_err']:.3e} "
              f"(bound {s_['bound']:.3e}); loss {s_['loss']:.6f} (one rank "
              f"{ref['17d']['loss']:.6f}), grad norm {s_['grad_norm']:.6f} "
              f"(one rank {ref['17d']['grad_norm']:.6f}); gaps "
              f"{s_['gaps']}; forward+backward {s_['step_s']:.3f} s (one "
              f"rank {ref['17d']['step_s']:.3f})")
    timings = time_split_kernels(xcfg, glm, dev)
    phase_s = time.perf_counter() - t0
    print(f"  phase 17 took {phase_s:.1f} s")
    launches = {k: {"17b": [r["launches"][k]
                            for r in train["bfloat16"]["ranks"]]}
                for k in TP_KERNELS}
    launches["onehot_gather"]["17a"] = [
        r["17a_float32"]["launches"]["onehot_gather"] for r in recs]
    for case, w in whole.items():
        for k in ("onehot_gather", "slstm"):
            if w["want"][k]:
                launches[k][case] = [r["launches"][k] for r in w["ranks"]]
    print(json.dumps({"tp_detail": {
        "card": card, "phase_s": phase_s, "one_rank": ref,
        "ranks_17acd": recs, "train_17b": train,
        "split_kernels": timings, "whole_17ef": whole}}))
    return launches, timings


def split_rounding_run(cfg, dev, tmp: pathlib.Path, n: int = 2) -> list:
    """MESH_TRAIN_STEPS steps of ``cfg`` on one rank from ``tmp``'s
    batches, each ``out_proj`` product computed as the ``n`` partial sums
    a ``tp`` split of its input dimension gives, each rounded to the
    compute dtype and then added (xlstm-125m's only row-parallel
    projection): one rank with the split's rounding and nothing else of
    it.  Returns (loss, grad norm) a step."""
    from repro_torch.kernels import slstm_ops
    from repro_torch.models import init_model, layers, ssm
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)

    def dense(params, name, x, compute_dtype=torch.bfloat16):
        if name != "out_proj":
            return layers.dense(params, name, x, compute_dtype)
        w, x = params[name].to(compute_dtype), x.to(compute_dtype)
        parts = [xi @ wi for xi, wi in zip(x.chunk(n, -1), w.chunk(n, 0))]
        return functools.reduce(torch.add, parts)

    ocfg = AdamWConfig(lr=3e-3, warmup_steps=10,
                       total_steps=MESH_TRAIN_STEPS)
    out = []
    with patched(ssm, "dense", dense), patched(slstm_ops, "dense", dense):
        model = init_model(cfg, seed=SEED, device=dev).requires_grad_(True)
        opt = init_opt_state(model, ocfg)
        step = make_train_step(cfg, ocfg)
        for i in range(MESH_TRAIN_STEPS):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in np.load(tmp / f"batch{i}.npz").items()}
            model, opt, m = step(model, opt, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    del model, opt
    sync(dev)
    torch.cuda.empty_cache()
    return out


def check_tp_train(cfg, dev, tmp: pathlib.Path, base: dict,
                   b16: dict | None) -> dict:
    """17b: ``cfg`` (xlstm-125m, ``onehot``) trained MESH_TRAIN_STEPS
    steps on the TP_TRAIN_MESH mesh of gloo ranks, in float32 and in
    bfloat16, against one rank (``b16``: 16b's bfloat16 runs, else run
    here), each rank launching rows 9, 9b, 10 and 10b at its split shapes
    and holding them there to their plain versions.

    float32 is held to 16b's bounds: after step 0, twice the drift of
    one rank's own run in two microbatches, which changes nothing but
    the order of the gradient's sums.  In bfloat16 the split rounds each
    row-parallel partial sum to bfloat16 before the all-reduce, and at
    this initialisation the model's bfloat16 gradients follow their
    rounding, so each step's loss and gradient norm are held to 16b's
    bounds or to twice the gap of one rank that rounds its ``out_proj``
    partial sums the same way (:func:`split_rounding_run`), where that
    is larger.  In float32 that run is printed beside the split, not
    used as a bound: it shows how far the split's order of sums alone
    moves the later steps."""
    n_ranks = TP_TRAIN_MESH[0] * TP_TRAIN_MESH[1]
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * cfg.n_periods
    per_step = {"onehot_gather": 1, "onehot_gather_backward": 1,
                "slstm": 2 * n_slstm, "slstm_backward": n_slstm}
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, param_dtype=dtype)
        d = tmp / dtype
        d.mkdir()
        micro = None
        if dtype == "bfloat16" and b16 is not None:
            one, later = b16["one_rank"], b16["bounds"]
            from repro_torch.data import TokenDataset

            B, S = TRAIN_SHAPE
            ds = TokenDataset(c.vocab, S, B, device=str(dev))
            for i in range(MESH_TRAIN_STEPS):
                np.savez(d / f"batch{i}.npz", **{
                    k: v.cpu().numpy() for k, v in ds.batch(i).items()})
        else:
            one, _, micro, later = one_rank_train(c, dev, d)
        (d / "meta.json").write_text(json.dumps(dict(
            mesh_meta(c, base), world=n_ranks, mesh=list(TP_TRAIN_MESH),
            split_checks=True)))
        print(f"phase 17b: {c.name} ({dtype}, onehot) on {n_ranks} gloo "
              f"ranks, mesh {TP_TRAIN_MESH}, {MESH_TRAIN_STEPS} steps of "
              f"{TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]}")
        recs = mesh_ranks("17b", d, n_ranks)
        r0 = recs[0]
        gaps = [abs(r0["losses"][i] - one[i][0]) / abs(one[i][0])
                for i in range(MESH_TRAIN_STEPS)]
        gn_gap = abs(r0["grad_norms"][0] - one[0][1]) / one[0][1]
        gn_bound = MESH_TRAIN_RTOL[0]
        bounds = [MESH_TRAIN_RTOL[0]] + later[1:]
        emulated = split_rounding_run(c, dev, d, TP_TRAIN_MESH[1])
        drift = [abs(emulated[i][0] - one[i][0]) / abs(one[i][0])
                 for i in range(MESH_TRAIN_STEPS)]
        if dtype == "bfloat16":
            gn_bound = max(gn_bound,
                           2 * abs(emulated[0][1] - one[0][1]) / one[0][1])
            bounds = [max(b, 2 * g) for b, g in zip(bounds, drift)]
        bad = [i for i, r in enumerate(recs)
               if any(r["launches"].get(k, 0) != v * MESH_TRAIN_STEPS
                      for k, v in per_step.items())]
        if any(g > b for g, b in zip(gaps, bounds)) or gn_gap > gn_bound \
                or bad or any(r["losses"] != r0["losses"] for r in recs):
            fail(f"17b {dtype}: loss gaps {gaps} (bounds {bounds}), "
                 f"grad-norm gap {gn_gap} (bound {gn_bound}), ranks with "
                 f"launches off {per_step} a step: {bad}")
        for i, r in enumerate(recs):
            share = {k: r["held_bytes"][k] / r["full_bytes"][k]
                     for k in r["held_bytes"]}
            print(f"  17b {dtype} rank {i}: median "
                  f"{statistics.median(r['step_s'][1:]):.4f} s a step; "
                  f"launches { {k: r['launches'][k] for k in per_step} }; "
                  f"collectives a step {r['collectives_per_step']}; holds "
                  f"parameters {share['p/']:.3f}, m {share['m/']:.3f}, v "
                  f"{share['v/']:.3f}; at the split shapes "
                  + ", ".join(f"{k} {v}"
                              for k, v in r["split_checks"].items()))
        print(f"  17b {dtype}: loss gaps {['%.2e' % g for g in gaps]} "
              f"(bounds {['%.2e' % b for b in bounds]}), grad norm "
              f"{gn_gap:.2e} (bound {gn_bound:.2e}); one rank "
              f"{statistics.median(x[2] for x in one[1:]):.4f} s a step")
        print(f"  17b {dtype}: one rank rounding its out_proj partial "
              f"sums as the split does: losses "
              f"{['%.6f' % x[0] for x in emulated]} (one rank "
              f"{['%.6f' % x[0] for x in one]}, the split "
              f"{['%.6f' % x for x in r0['losses']]}); its loss drift "
              f"{['%.2e' % g for g in drift]}; step 0's grad norm "
              f"{emulated[0][1]:.4f} (one rank {one[0][1]:.4f}, the split "
              f"{r0['grad_norms'][0]:.4f})")
        if micro is not None:
            print(f"  17b {dtype}: one rank in two microbatches, loss drift "
                  f"{['%.2e' % g for g in micro]}")
        out[dtype] = {"ranks": [{k: v for k, v in r.items()
                                 if k != "blocks"} for r in recs],
                      "one_rank": one, "split_rounding": emulated,
                      "split_rounding_drift": drift,
                      "microbatch_drift": micro, "loss_gaps": gaps,
                      "bounds": bounds, "grad_norm_gap": gn_gap,
                      "grad_norm_bound": gn_bound}
    return out


# ----------------------------------------------------------------------
# The divisibility guard under tp (phase 17e, 17f)
# ----------------------------------------------------------------------

# case: (arch, ranks on the (1, n) mesh, dtype).  17e: whisper-small's
# 51865 vocabulary rows replicated, its 12 heads split; 17f: xlstm-125m's
# 4 mLSTM heads whole at tp = 8, the sLSTM's 1536 units split to 192.
TP_WHOLE = {"17e": ("whisper-small", 2, "float32"),
            "17f": ("xlstm-125m", 8, "bfloat16")}
TP_WHOLE_SHAPE = (2, 64, 4)         # B, prompt tokens, decode steps
TP_WHOLE_FRAMES = 256               # 17e's audio frames
# 17f, bfloat16: x max(1, max|ref|), tests/test_torch_lm_archs.py's bf16
# bound, beside the greedy tokens.
TP_WHOLE_BF16_TOL = 5e-2


def whole_cfg(case: str, base: dict):
    """17e/17f's config (``onehot``, its dtype), cut in CPU rehearsals."""
    from repro_torch.configs import ARCHS

    arch, _, dtype = TP_WHOLE[case]
    cfg = ARCHS[arch]
    if base.get("reduced"):
        cfg = dataclasses.replace(cfg.reduced(), name=arch,
                                  vocab=base["whole_vocab"][case])
    return dataclasses.replace(cfg, gather_impl="onehot", param_dtype=dtype)


def whole_batch(cfg, dev, seed: int) -> dict:
    """TP_WHOLE_SHAPE's prompts and teacher-forced tokens (and whisper's
    frames), drawn from ``seed``."""
    from repro_torch.models.model import FRONTEND_DIM

    B, P, n = TP_WHOLE_SHAPE
    batch = {"tokens": seeded_ints(cfg.vocab, (B, P + n), dev, seed)}
    if cfg.frontend == "audio":
        batch["frames"] = seeded_normal(
            (B, TP_WHOLE_FRAMES, FRONTEND_DIM["audio"]), dev, seed + 1)
    return batch


def whole_decode(model, cfg, batch: dict, dev) -> tuple:
    """A prefill of the prompts and TP_WHOLE_SHAPE's teacher-forced
    decode steps: (logits (B, steps + 1, V) float32 on the host, the
    prefill's ms, ms and collectives per decode step, the cache)."""
    from repro_torch.dist import fsdp
    from repro_torch.models.model import decode_step, prefill

    _, P, n = TP_WHOLE_SHAPE
    toks = batch["tokens"]
    first = dict(batch, tokens=toks[:, :P])
    sync(dev)
    t0 = time.perf_counter()
    lg, cache = prefill(model, cfg, first, P + n)
    sync(dev)
    pre_ms = (time.perf_counter() - t0) * 1e3
    out, ms, coll = [lg[:, -1].float().cpu()], [], []
    for i in range(n):
        before = sum(fsdp.COUNTS.values())
        t0 = time.perf_counter()
        lg, cache = decode_step(model, cfg, cache, toks[:, P + i:P + i + 1],
                                P + i)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append(sum(fsdp.COUNTS.values()) - before)
        out.append(lg[:, -1].float().cpu())
    return torch.stack(out, 1), pre_ms, ms, coll, cache


def rank_tp_whole(rank: int, d: pathlib.Path, dev, meta: dict) -> dict:
    """17e or 17f on one rank of the (1, n) ``tp`` mesh: the model placed
    as drawn, a prefill and decode steps held to the one rank's logits;
    the launches of rows 9 and 10; what runs whole and what splits."""
    from repro_torch.dist import fsdp, tp
    from repro_torch.dist.sharding import sharding_context
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import init_model

    case = meta["case"]
    cfg = whole_cfg(case, meta)
    n = TP_WHOLE[case][1]
    mesh = make_local_mesh(1, n, device=dev)
    rules = tp_rules()
    model = init_model(cfg, seed=SEED, device=dev, mesh=mesh, rules=rules)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in np.load(d / "batch.npz").items()}
    ref = torch.from_numpy(np.load(d / "logits.npy"))
    zero_launches(dev)
    fsdp.COUNTS.update({k: 0 for k in fsdp.COUNTS})
    with torch.no_grad(), sharding_context(mesh, rules):
        lg, pre_ms, ms, coll, cache = whole_decode(model, cfg, batch, dev)
        s = tp.split()
        kinds = ["vocab"] + [k for k in ("attn", "mlstm", "slstm")
                             if k in cfg.block_pattern] \
            + ["mlp"] * bool(cfg.d_ff)
        whole = {k: tp.sub_split(cfg, k, s) is None for k in kinds}
    launches = {k: LAUNCHES[k] for k in ("onehot_gather", "slstm")}
    held, full = held_bytes(model)
    scale = max(1.0, float(ref.abs().max()))
    err = float((lg - ref).abs().max())
    rec = {"max_abs_err": err, "scale": scale, "prefill_ms": pre_ms,
           "ms": ms, "collectives": coll, "launches": launches,
           "whole": whole, "held_bytes": held, "full_bytes": full,
           "embed_rows": int(fsdp.local(model.embed).shape[0]),
           "cache_bytes": cache_bytes(cache),
           "cache_shapes": {f"{b}/{k}": list(v.shape)
                            for b, leaves in cache["blocks"].items()
                            for k, v in leaves.items()}}
    if cfg.param_dtype == "float32":
        rec["bound"] = TP_TOL * scale
        rec["ok"] = err <= rec["bound"]
    else:
        # Greedy tokens equal wherever the one rank's top two logits lie
        # further apart than the two runs' logits do.
        top2 = ref.topk(2, -1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * err
        same = lg.argmax(-1) == ref.argmax(-1)
        rec["bound"] = TP_WHOLE_BF16_TOL * scale
        rec["greedy_equal"] = float(same.float().mean())
        rec["greedy_ties"] = int((~clear).sum())
        rec["ok"] = err <= rec["bound"] and bool(same[clear].all())
    if rank == 0:
        rec["kernel_checks"] = whole_kernel_checks(cfg, s, dev)
        rec["ok"] &= all(c["ok"] for c in rec["kernel_checks"].values())
    return rec


def whole_kernel_checks(cfg, s, dev) -> dict:
    """Rows 9 and 10 at the shapes 17e/17f give them, each held to its
    plain version: row 9 bitwise on the rank's block of the vocabulary
    (all of it, offset 0, where ``tp`` does not divide it), row 10 at
    the rank's sLSTM units within SLSTM_TOL, prefill and one step."""
    from repro_torch.dist import tp
    from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
    from repro_torch.kernels.gather_ref import gather_ref
    from repro_torch.kernels.slstm import launch_slstm
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_recurrence_ref)

    B, P, _ = TP_WHOLE_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 177)
    sv = tp.sub_split(cfg, "vocab", s)
    V = cfg.vocab if sv is None else cfg.vocab // sv.n
    off = 0 if sv is None else sv.r * V
    dtype = getattr(torch, cfg.param_dtype)
    table = torch.randn((V, cfg.d_model), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, cfg.vocab, (B * P,), generator=g, device=dev)
    got = cuda_onehot_gather(table, ids, offset=off)
    out = {"row9": {"V": V, "offset": off,
                    "ok": torch.equal(got, gather_ref(table, ids - off))}}
    if "slstm" in cfg.block_pattern:
        ss = tp.sub_split(cfg, "slstm", s)
        di = cfg.d_inner if ss is None else cfg.d_inner // ss.n
        worst = 0.0
        for S in (P, 1):
            zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
            r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
            state = init_slstm_state(B, di, device=dev)
            hs, _ = launch_slstm(zifo, r, state)
            want, _ = slstm_recurrence_ref(zifo, r, state)
            worst = max(worst, excess(hs, want, SLSTM_TOL))
        out["row10"] = {"di": di, "excess": worst, "ok": worst <= 0}
    sync(dev)
    return out


def check_tp_whole(dev, base: dict) -> dict:
    """17e and 17f: each case's one-rank run in this process, then its
    ranks; prints the errors, ms and collectives a decode step, what
    ran whole, and the launches."""
    from repro_torch.models.model import init_model

    out = {}
    for case, (arch, n, dtype) in TP_WHOLE.items():
        cfg = whole_cfg(case, base)
        with tempfile.TemporaryDirectory() as t:
            d = pathlib.Path(t)
            batch = whole_batch(cfg, dev, SEED + 175)
            np.savez(d / "batch.npz", **{k: v.cpu().numpy()
                                         for k, v in batch.items()})
            model = init_model(cfg, seed=SEED, device=dev)
            with torch.no_grad():
                lg, pre_ms, ms, _, cache = whole_decode(model, cfg, batch,
                                                        dev)
            one = {"prefill_ms": pre_ms, "ms": ms,
                   "cache_bytes": cache_bytes(cache)}
            np.save(d / "logits.npy", lg.numpy())
            del model, cache
            free(dev)
            (d / "meta.json").write_text(json.dumps(dict(
                base, world=n, case=case)))
            print(f"phase {case}: {arch} {dtype}, {n} gloo ranks on a "
                  f"(1, {n}) tp mesh")
            recs = mesh_ranks(case, d, n)
        B, P, steps = TP_WHOLE_SHAPE
        want = {"onehot_gather": 1 + steps,
                "slstm": (cfg.block_pattern.count("slstm") * cfg.n_periods
                          * (1 + steps))}
        for i, r in enumerate(recs):
            if r["launches"] != want:
                fail(f"{case}: rank {i} launched {r['launches']}, not "
                     f"{want}")
        r = recs[0]
        extra = ("" if "greedy_equal" not in r else
                 f"; greedy tokens equal {r['greedy_equal']:.3f} "
                 f"({r['greedy_ties']} positions within the logits' gap)")
        print(f"  {case}: max|d| {max(x['max_abs_err'] for x in recs):.3e} "
              f"(bound {r['bound']:.3e}){extra}; whole on each rank: "
              f"{sorted(k for k, v in r['whole'].items() if v)}; embed "
              f"rows a rank {r['embed_rows']} of {cfg.vocab}; holds "
              f"{r['held_bytes'] / 1e9:.3f} of {r['full_bytes'] / 1e9:.3f} "
              f"GB; cache {r['cache_bytes'] / 2**20:.2f} MiB (one rank "
              f"{one['cache_bytes'] / 2**20:.2f}); prefill "
              f"{r['prefill_ms']:.1f} ms (one rank {one['prefill_ms']:.1f});"
              f" {statistics.median(r['collectives']):g} collectives and "
              f"{statistics.median(r['ms']):.2f} ms a decode step a rank "
              f"(one rank {statistics.median(one['ms']):.2f}); launches a "
              f"rank {r['launches']}; kernels {r['kernel_checks']}")
        out[case] = {"one_rank": one, "ranks": recs, "want": want}
    return out


# ----------------------------------------------------------------------
# The analysis tools (phase 18)
# ----------------------------------------------------------------------

# 18b: row 1's bound at a served fold (P = PBATCH at L = 512) as PERF.md's
# kernel table records it; the census's byte term of the same launch
# must equal it, being the same formula.
ROW1_TABLE_BOUND_MS = "0.3263"
# 18c: the dry-run cell.  A tool that outlasts TOOL_TIMEOUT_S fails.
DRYRUN_CELL = ("chatglm3-6b", "decode_32k", "pod")
TOOL_TIMEOUT_S = 240
# 18c: the architectures whose cells were errors before the divisibility
# guard (tp = 16 divides neither their heads nor, for whisper-small, its
# vocabulary): every supported cell of theirs on both meshes, one
# process a cell and mesh, DRYRUN_WORKERS at a time.
DRYRUN_GUARDED = ("xlstm-125m", "qwen2-vl-2b", "whisper-small")
DRYRUN_WORKERS = 8


def tool_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_SRC)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))


def run_tool(module: str, args: list) -> tuple[int, str]:
    """``python -m <module> <args>`` from the checkout, on the host;
    (exit code, standard output).  Any exit but 0 and 1 fails."""
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=tool_env(),
                          cwd=_SRC.parent, timeout=TOOL_TIMEOUT_S)
    if proc.returncode not in (0, 1):
        fail(f"{module} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc.returncode, proc.stdout


def check_lint() -> dict:
    """18a: the contract checker on this checkout exits 0 with its four
    passes, each of which checked something; gather.cu with one argument
    of an entry point dropped, given as a fixture, exits 1 and names
    the entry."""
    rc, out = run_tool("repro_torch.analysis.lint", [])
    rep = json.loads(out)
    checked = {p["pass"]: p["checked"] for p in rep["passes"]}
    if rc != 0 or not rep["ok"] or set(checked) != {
            "ledger", "budget", "hygiene", "cache"} \
            or min(checked.values()) <= 0:
        fail(f"18a: the lint exited {rc} with findings {rep['findings']} "
             f"and checked {checked}")
    text = (_SRC / "repro_torch" / "kernels" / "csrc" / "gather.cu") \
        .read_text()
    head = text.index('extern "C" int onehot_gather_f32_launch(')
    cut = text.index("long long offset,", head)
    planted = text[:cut] + text[cut + len("long long offset,"):]
    with tempfile.TemporaryDirectory() as d:
        fixture = pathlib.Path(d) / "gather_dropped_offset.cu"
        fixture.write_text(planted)
        rc2, out2 = run_tool("repro_torch.analysis.lint",
                             ["--passes", "ledger", "--kernel-fixture",
                              str(fixture)])
    found = [f for f in json.loads(out2)["findings"]
             if f["rule"] == "entry-signature-mismatch"
             and "onehot_gather_f32_launch" in f["detail"]]
    if rc2 != 1 or not found:
        fail(f"18a: the planted fixture exited {rc2}, findings {out2}")
    print(f"  lint: exit 0, checked {checked}; gather.cu with "
          f"onehot_gather_f32_launch's offset dropped: exit 1, "
          f"{found[0]['detail']}")
    return {"checked": checked, "planted": found[0]}


def traced(fn):
    """``fn()`` under an OpTrace, synchronised; returns (its result, the
    trace, each kernel op's count, each LAUNCHES key's delta)."""
    from repro_torch.analysis.trace import OpTrace
    from repro_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    with OpTrace() as tr:
        out = fn()
    torch.cuda.synchronize()
    ops = {k.removeprefix("repro_torch."): v for k, v in tr.counts().items()
           if k.startswith("repro_torch.")}
    delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
             if LAUNCHES[k] != before[k]}
    return out, tr, ops, delta


def check_census(cfg, dev) -> dict:
    """18b: one decode call of ``cfg`` (chatglm3-6b, bfloat16, full width,
    SEED) as phase 12's ServingEngine makes it with gather_impl="onehot",
    traced: each kernel op's count equal to its launches (row 9 once),
    the memory term of the roofline beside the weight-bytes floor and the
    same call's profiled device time; and one row-1 fold at L = 512, P =
    PBATCH, whose byte term must be PERF.md's bound."""
    import repro_torch.serving.engine as engine_mod
    from repro_torch.analysis.trace import analyze_trace
    from repro_torch.core.geometry import Geometry, projection_matrices
    from repro_torch.kernels.backproject import launch_backproject
    from repro_torch.models import init_model
    from repro_torch.serving import Request, ServingEngine

    c = census()
    model = init_model(cfg, seed=SEED, device=dev)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters()) \
        - model.embed.numel() * model.embed.element_size()
    floor_ms = 1e3 * wbytes / c.PEAK_BYTES_S
    eng = ServingEngine(dataclasses.replace(cfg, gather_impl="onehot"),
                        model, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        seed=SEED, device=dev)
    for i, prompt in enumerate(lm_prompts(cfg)[:LM_SLOTS]):
        eng.submit(Request(rid=i, prompt=prompt, max_tokens=4))
    calls = []
    orig = engine_mod._masked_decode_step

    def first_traced(*a):
        if calls:
            return orig(*a)
        out, tr, ops, delta = traced(lambda: orig(*a))
        calls.append((a, tr, ops, delta))
        return out

    with patched(engine_mod, "_masked_decode_step", first_traced):
        eng.step()
    args, tr, ops, delta = calls[0]
    if ops != {"onehot_gather": 1} or delta != {"onehot_gather": 1}:
        fail(f"18b: the decode call's kernel ops {ops}, its launches "
             f"{delta}")
    cost = analyze_trace(tr)
    roof = c.roofline_terms(cost["flops"], cost["bytes"],
                            cost["collectives"]["total"])
    prof = profiled_call(lambda: orig(*args))
    print(f"  a decode call ({LM_SLOTS} slots, index {args[4]}): "
          f"{len(tr.records)} ops dispatched, {cost['census']}; kernel ops "
          f"{ops} = launches {delta}; traced {cost['bytes'] / 1e9:.3f} GB "
          f"and {cost['flops'] / 1e9:.3f} GFLOP: memory term "
          f"{1e3 * roof['memory_s']:.3f} ms, compute term "
          f"{1e3 * roof['compute_s']:.4f} ms (bf16 peak); the weight-bytes "
          f"floor {floor_ms:.3f} ms; profiled "
          + ("device time not measured" if prof["device_ms"] is None else
             f"{prof['device_ms']:.3f} ms on the device")
          + f", {prof['wall_ms']:.3f} ms wall, {prof['kernels']:.0f} kernels")
    del eng, model, args, calls
    free(dev)

    geom = Geometry()
    P, rows, cols = PBATCH, geom.n_v + 2, geom.n_u + 2
    vol = torch.zeros((geom.L,) * 3, dtype=torch.float32, device=dev)
    padded = torch.zeros((P, rows, cols), dtype=torch.float32, device=dev)
    mats = torch.as_tensor(np.asarray(projection_matrices(geom))[:P],
                           dtype=torch.float32, device=dev).contiguous()
    _, tr1, ops1, delta1 = traced(lambda: launch_backproject(
        vol, padded, mats, z0=0, O=geom.O, MM=geom.MM))
    (rec,) = [r for r in tr1.records if r.name == "repro_torch.backproject"]
    term_ms = 1e3 * c.roofline_terms(0, rec.bytes, 0)["memory_s"]
    bms, by = bound_ms(geom.L, geom.L, P, rows, cols)
    if ops1 != {"backproject": 1} or delta1 != {"backproject": 1} \
            or term_ms != bms or f"{term_ms:.4f}" != ROW1_TABLE_BOUND_MS:
        fail(f"18b: row 1's fold traced as {ops1} (launches {delta1}), "
             f"byte term {term_ms} ms against the bound {bms} ms and the "
             f"table's {ROW1_TABLE_BOUND_MS}")
    print(f"  row 1, one fold at L={geom.L}, P={P}: {rec.bytes} B, "
          f"{rec.flops} operations traced; byte term {term_ms:.6f} ms = "
          f"the bound {bms:.6f} ms ({by}; PERF.md: {ROW1_TABLE_BOUND_MS})")
    del vol, padded
    free(dev)
    return {"decode_call": {"ops": ops, "launches": delta,
                            "dispatched": len(tr.records), "cost": cost,
                            "roofline": roof, "floor_ms": floor_ms,
                            "profiled": prof},
            "row1_fold": {"bytes": rec.bytes, "flops": rec.flops,
                          "term_ms": term_ms, "bound_ms": bms}}


def check_dryrun() -> dict:
    """18c: one dry-run cell through ``python -m repro_torch.launch.dryrun``
    on the host (fake tensors, a fake world of 256 ranks); it must
    record ``"status": "ok"``.  Then :func:`check_guarded_cells`."""
    arch, shape, mesh = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rc, out = run_tool("repro_torch.launch.dryrun",
                           ["--arch", arch, "--shape", shape, "--mesh", mesh,
                            "--out", d])
        wall = time.perf_counter() - t0
        path = pathlib.Path(d) / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.is_file() else {}
    if rc != 0 or rec.get("status") != "ok":
        fail(f"18c: the dry run exited {rc}: {out[-2000:]} "
             f"{rec.get('error')} {rec.get('traceback', '')[-2000:]}")
    ro, mem = rec["roofline"], rec["memory"]
    print(f"  {out.strip().splitlines()[-1]}")
    print(f"  {arch} {shape} {mesh}: {wall:.1f} s ({rec['trace_s']} s "
          f"traced); a rank's flops {rec['cost']['flops_per_device']:.4e}, "
          f"bytes {rec['cost']['bytes_accessed_per_device']:.4e}, "
          f"collective bytes "
          f"{rec['cost']['collective_bytes_per_device']['total']}; "
          f"compute {ro['compute_s']:.3e} s, memory {ro['memory_s']:.3e} s, "
          f"collective {ro['collective_s']:.3e} s ({ro['dominant']}); live "
          f"{mem['live_bytes'] / 1e9:.2f} GB; {rec['kv_layout']}")
    return {"record": rec, "wall_s": wall, "guarded": check_guarded_cells()}


def check_guarded_cells() -> dict:
    """18c: every supported cell of DRYRUN_GUARDED's architectures on
    both production meshes through ``python -m repro_torch.launch.dryrun``
    (one process a cell and mesh); each must record ``"status": "ok"``.
    Prints each cell's live GB a rank and whether it fits 80 GB, and the
    error cells on each mesh (0)."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.registry import ARCHS, cell_supported

    todo = [(a, sh, m) for a in DRYRUN_GUARDED for sh in sorted(SHAPES)
            for m in ("pod", "multipod")
            if cell_supported(ARCHS[a], SHAPES[sh])[0]]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        def one(cell):
            a, sh, m = cell
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", a, "--shape", sh, "--mesh", m, "--out", d],
                capture_output=True, text=True, env=tool_env(),
                cwd=_SRC.parent, timeout=TOOL_TIMEOUT_S)
            path = pathlib.Path(d) / f"{a}__{sh}__{m}.json"
            return (json.loads(path.read_text()) if path.is_file() else
                    {"status": "missing", "error": proc.stderr[-2000:]})

        with concurrent.futures.ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
            recs = dict(zip(todo, pool.map(one, todo)))
    wall = time.perf_counter() - t0
    errors = {m: [k for k, r in recs.items() if k[2] == m
                  and r["status"] != "ok"] for m in ("pod", "multipod")}
    for (a, sh, mesh), r in sorted(recs.items()):
        if r["status"] == "ok":
            print(f"  18c {a} {sh} {mesh}: ok, live "
                  f"{r['memory']['live_bytes'] / 1e9:.2f} GB a rank, fits "
                  f"80 GB: {r['fits_80gb_hbm']}; {r['roofline']['dominant']}"
                  f"-bound, traced in {r['trace_s']} s")
    print(f"  18c: {len(todo) // 2} cells of {', '.join(DRYRUN_GUARDED)} on "
          f"each mesh in {wall:.1f} s; error cells: pod "
          f"{len(errors['pod'])}, multipod {len(errors['multipod'])}")
    if any(errors.values()):
        bad = [(k, recs[k].get("error")) for m in errors.values()
               for k in m]
        fail(f"18c: the dry run's error cells {bad}")
    return {"wall_s": wall, "cells": {
        "/".join(k): {"live_bytes": r["memory"]["live_bytes"],
                      "fits_80gb_hbm": r["fits_80gb_hbm"],
                      "trace_s": r["trace_s"],
                      "dominant": r["roofline"]["dominant"]}
        for k, r in recs.items()}}


def run_analysis(glm_cfg, dev, card: str) -> dict:
    """Phase 18: the lint, the census, one dry-run cell and the cells of
    DRYRUN_GUARDED on both meshes; returns the phase's launches by kernel
    record name."""
    t0 = time.perf_counter()
    print("phase 18a: python -m repro_torch.analysis.lint on this checkout")
    lint = check_lint()
    print(f"phase 18b: the census of a served {glm_cfg.name} decode call "
          f"(onehot) and of a row-1 fold")
    cen = check_census(glm_cfg, dev)
    print(f"phase 18c: python -m repro_torch.launch.dryrun "
          f"{' '.join(DRYRUN_CELL)}")
    dry = check_dryrun()
    phase_s = time.perf_counter() - t0
    print(f"  phase 18 took {phase_s:.1f} s")
    print(json.dumps({"phase18": {"card": card, "seconds": phase_s,
                                  "lint": lint, "census": cen,
                                  "dryrun": dry}}))
    return {"onehot_gather": 1, "backproject_batch": 1}


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    if sys.argv[1:2] == ["--shard-rank"]:
        return shard_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
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
    print(f"phase 1: built the backproject, quant, backproject_strip, "
          f"gather and slstm kernels in {build_s:.2f} s")
    dev = torch.device("cuda", 0)
    record = run(Geometry(), dev, card, build_s)
    scan_s = record.pop("served_scan_s")
    from repro_torch.configs import ARCHS
    record["kernels"] += run_lm(
        ARCHS[LM_ARCH], ARCHS[GLM_ARCH],
        dataclasses.replace(ARCHS[JAMBA_ARCH], n_layers=JAMBA_DEPTH), dev,
        card)
    sharded = run_sharded(Geometry(), dev, card, scan_s)
    for entry in record["kernels"]:
        if entry["name"] in sharded:
            entry["sharded_launches"] = sharded[entry["name"]]
    train, train_launches, launcher15b = run_train(
        ARCHS[LM_ARCH], ARCHS[GLM_ARCH], dev, card)
    for entry in record["kernels"]:
        if entry["name"] in train_launches:
            entry["train_launches"] = train_launches[entry["name"]]
    record["kernels"] += train
    mesh, b16 = run_mesh(ARCHS[LM_ARCH], ARCHS[GLM_ARCH],
                         dataclasses.replace(ARCHS[EP_ARCH],
                                             n_layers=EP_DEPTH),
                         dev, card, launcher15b)
    for entry in record["kernels"]:
        if entry["name"] in mesh:
            entry["mesh_launches"] = mesh[entry["name"]]
    tp_launches, tp_times = run_tp(
        ARCHS[LM_ARCH], ARCHS[GLM_ARCH],
        dataclasses.replace(ARCHS[JAMBA_ARCH], n_layers=JAMBA_DEPTH), dev,
        card, b16)
    rows = {"onehot_gather": "row9", "onehot_gather_backward": "row9b",
            "slstm": "row10", "slstm_backward": "row10b"}
    for entry in record["kernels"]:
        if entry["name"] in tp_launches:
            entry["tp_launches"] = tp_launches[entry["name"]]
            entry["tp_split_shapes"] = tp_times[rows[entry["name"]]]
    analysis = run_analysis(ARCHS[GLM_ARCH], dev, card)
    for entry in record["kernels"]:
        if entry["name"] in analysis:
            entry["census_launches"] = analysis[entry["name"]]
    print(f"every phase passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(geom, dev, card: str, build_s: float) -> dict:
    """Phases 2-8 on ``geom``; prints the details and returns the
    ``kernels`` record and phase 3's wall seconds per served scan."""
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
    projs, mats, filt = ct_data(geom, dev)
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

    print("phase 5: the strip planner on the card")
    planner = check_planner(geom, dev)

    print(f"phase 6: the strip kernels K3, K4, K5 vs their plain versions "
          f"at L={geom.L}")
    sproblem = strip_problem(geom, dev, np.random.default_rng(SEED + 1))
    tile, window = strip_tiling(geom, dev, sproblem[1])
    print(f"  tile {tile}, strip {window} (every matrix's need)")
    strip = check_strip(geom, sproblem, tile, window)
    base = base_window(geom, dev)
    print(f"  K3, K4 and K5 at the reference's base tile {STRIP_TILE}, "
          f"the planner's window {base} (K5: its own)")
    strip_base = check_strip(geom, sproblem, STRIP_TILE, base)
    del sproblem
    torch.cuda.empty_cache()

    print("phase 7: CTFrontDoor(strategy='auto') from an empty tune "
          "directory")
    auto = serve_auto(geom, dev, projs, mats, filt)

    print("phase 8: a scan through each strip kernel as a tuned plan "
          "names it, and through row 1 at P=1")
    tuned = serve_tuned(geom, dev, mats, filt, v32, tile, window)

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
        if wire == "float32":
            k.append({"name": "backproject_one", "route": "cuda",
                      "source": src + "backproject.cu",
                      "replaces": "src/repro/kernels/backproject.py:206",
                      "launches": tuned["backproject"]["launches"],
                      "max_abs_err": err, "ms": timing[1][0],
                      "plain_ms": plain_ms[1], "bound_ms": timing[1][1],
                      "bound_by": timing[1][2], "library_ms": None})
    for name, label, P, line in (
            ("strip_db", "db2", PBATCH, 594),
            ("strip_micro", "micro", PBATCH, 714),
            ("strip_shared", "shared", PBATCH, 758),
            ("strip_db_p1", "db2", 1, 376),
            ("strip_micro_p1", "micro", 1, 319)):
        labels = ("db2", "db4") if label == "db2" else (label,)
        r = strip[(label, "float32", P)]
        k.append({"name": name, "route": "cuda",
                  "source": src + "backproject_strip.cu",
                  "replaces": f"src/repro/kernels/backproject.py:{line}",
                  "launches": tuned[name]["launches"],
                  "max_abs_err": max(v["err"] for d in (strip, strip_base)
                                     for key, v in d.items()
                                     if key[0] in labels),
                  "ms": r["ms"], "plain_ms": r["plain_ms"],
                  "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                  "library_ms": None,
                  "base_tile_ms": strip_base[(label, "float32", P)]["ms"],
                  "scan_ms_per_launch": tuned[name]["ms_per_launch"]})
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
                          "psnr_vs_f32_and_drop": w["score16"]},
        "planner": planner, "strip_tile": tile, "strip_window": window,
        "strip": {"/".join(map(str, key)): v for key, v in strip.items()},
        "strip_base_tile": list(STRIP_TILE), "strip_base_window": base,
        "strip_base": {"/".join(map(str, key)): v
                       for key, v in strip_base.items()},
        "auto": {k_: v for k_, v in auto.items()
                 if k_ != "served_launch_ms"},
        "auto_served_launch_ms_median": statistics.median(
            auto["served_launch_ms"]),
        "tuned": tuned}}))
    return {"kernels": k, "served_scan_s": wall / 2}


if __name__ == "__main__":
    sys.exit(main())
