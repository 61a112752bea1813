"""Dry run of every (arch x shape) cell on the production mesh.

The port's counterpart of ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell with XLA on 256 or 512 placeholder
devices and reads the compiled module.  The port runs eagerly, so it
*runs* each cell's step on fake tensors instead
(:class:`torch._subclasses.fake_tensor.FakeTensorMode`: shapes, dtypes
and devices, no memory), as rank 0 of a fake process group of 256
ranks (``pod``, a 16x16 ``("data", "model")`` mesh) or 512
(``multipod``, 2x16x16) from
:func:`repro_torch.launch.mesh.make_production_mesh`, with every
parameter drawn placed (``init_model(mesh=, rules=)``) on fake CUDA
tensors.  The step is the port's own: ``train_step`` (forward, backward
and AdamW) for ``train_4k``, ``prefill`` for ``prefill_32k``,
``decode_step`` (one token against a ``seq_len`` cache) for
``decode_32k`` and ``long_500k``.  A hand-written kernel on that path
is its custom op's fake implementation (:mod:`repro_torch.kernels`);
collectives go to the fake group.

Per cell it records, into ``<out>/<arch>__<shape>__<mesh>.json``, the
reference's keys:

* ``memory``: ``argument_bytes`` (the rank's parameters, moments, cache
  and batch rows), ``output_bytes`` (what the step returns that it
  allocated), ``temp_bytes`` (the peak of storage allocated during the
  step and alive at once, :attr:`repro_torch.analysis.trace.OpTrace.peak_bytes`),
  ``live_bytes`` = argument + temp, and ``fits_80gb_hbm`` (live bytes
  under an H100's 80 GB of HBM, where the reference had 16 GB);
* ``cost``: flops, bytes and collective bytes per rank and the op
  census, from :func:`repro_torch.analysis.trace.analyze_trace`;
* ``roofline``: :func:`repro_torch.analysis.census.roofline_terms`;
* ``useful_flops_ratio``: 6 (train) or 2 x active parameters x tokens,
  over the traced flops of all ranks, as the reference's.

``trace_s`` (the step's seconds on fake tensors) takes the place of
``lower_s``/``compile_s``.  ``kv_layout`` states the decode cache's
layout priced: the reference shards its KV positions over ``sp``
(:func:`_cache_logical_specs`); the port splits them only under
flash-decoding (``--sp`` on a decode cell), else each rank holds every
position of its rows and KV heads.  Where ``tp`` (16 ranks) does not
divide a sub-layer's widths (xlstm-125m's 4 mLSTM heads, qwen2-vl-2b's
and whisper-small's 12 heads, whisper-small's 51865 vocabulary rows)
the sub-layer runs whole on the rank, as GSPMD replicates such a leaf
(:func:`repro_torch.dist.tp.sub_split`), and the cell is priced so.

On a PyTorch built without CUDA the fake CUDA tensors need a CUDA device
guard that does nothing (PyTorch's CUDA builds bring their own):
:func:`_fake_cuda_guard` compiles one (``fake_cuda_guard.cpp``) with the
host's C++ compiler into ``build/repro_torch/`` at first use.  Such a
build's autograd engine refuses a CUDA tensor's gradient (it asks the
CUDA accelerator for its streams), so there a train cell runs on fake
CPU tensors (record key ``fake_device``); the ops are the same, and the
kernel wrappers take the plain versions there (xlstm-125m's sLSTM
recurrence, token by token on fake tensors; every arch gathers with
``take``).

Usage::

    python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..analysis.census import HBM_BYTES, roofline_terms
from ..analysis.trace import OpTrace, analyze_trace
from ..configs import SHAPES, ShapeConfig
from ..configs.registry import ARCHS, cell_supported
from ..dist import fsdp
from ..dist.sharding import ShardingRules, logical_to_spec, \
    sharding_context, valid_spec
from ..models.model import FRONTEND_DIM
from ..training.optim import AdamWConfig

__all__ = ["input_specs", "main", "pick_opt", "pick_rules", "run_cell"]

I32 = torch.int32


# ----------------------------------------------------------------------
# Per-cell policy: rules + optimizer state dtype scale with model size
# ----------------------------------------------------------------------

def pick_rules(cfg, shape: ShapeConfig, mesh,
               sp_act: bool = False) -> ShardingRules:
    """The reference's rules: batch over ``("pod", "data")``, FSDP over
    ``data`` (and ``pod`` above 1e11 parameters), ``tp`` and ``ep`` on
    ``model``, for decode ``sp`` on ``model``; with ``sp_act`` the
    residual stream on ``model`` (attention archs, not decode) or, for
    decode, flash-decoding."""
    batch_axes = ("pod", "data")
    fsdp_axes = ("pod", "data") if cfg.param_count() > 1e11 else ("data",)
    sp = ("model",) if shape.is_decode else ()
    # Sequence-parallel residual only helps archs whose sequence mixing
    # is parallel (attention); a recurrent scan over a seq-sharded stream
    # crosses shards every step.
    use_sp = (sp_act and not shape.is_decode
              and "attn" in cfg.block_pattern)
    rules = ShardingRules(batch=batch_axes, fsdp=fsdp_axes, tp=("model",),
                          ep=("model",), sp=sp,
                          sp_act=("model",) if use_sp else (),
                          flash_decode=bool(sp_act and shape.is_decode))
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if shape.global_batch % math.prod(sizes.get(a, 1) for a in batch_axes):
        rules = dataclasses.replace(rules, batch=())
    return rules


def pick_opt(cfg) -> AdamWConfig:
    n = cfg.param_count()
    state = "int8" if n > 5e11 else ("bfloat16" if n > 1e11
                                     else "float32")
    return AdamWConfig(state_dtype=state)


# ----------------------------------------------------------------------
# Inputs
# ----------------------------------------------------------------------

def input_specs(cfg, shape: ShapeConfig) -> dict:
    """The model inputs of one cell as ``meta`` tensors (shapes and
    dtypes, nothing allocated: the counterpart of the reference's
    ``ShapeDtypeStruct``s)."""
    gb, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": sds((gb, 1), I32)}
    batch = {}
    if cfg.frontend == "vision":
        n_img = S // 4
        batch["patches"] = sds((gb, n_img, FRONTEND_DIM["vision"]),
                               torch.bfloat16)
        batch["tokens"] = sds((gb, S - n_img), I32)
        if shape.kind == "train":
            batch["labels"] = sds((gb, S - n_img), I32)
        return batch
    if cfg.frontend == "audio":
        batch["frames"] = sds((gb, S, FRONTEND_DIM["audio"]),
                              torch.bfloat16)
    batch["tokens"] = sds((gb, S), I32)
    if shape.kind == "train":
        batch["labels"] = sds((gb, S), I32)
    return batch


def _cache_logical_specs(cfg, cache):
    """The reference's logical axes per cache leaf, keyed by block kind
    and leaf name (its ``dryrun.py`` ``_cache_logical_specs``): the KV
    caches' positions on ``sp``."""
    kinds = {f"b{j}": k for j, k in enumerate(cfg.block_pattern)}

    def walk(blocks):
        out = {}
        for bname, leaves in blocks.items():
            kind = kinds[bname]
            sub = {}
            for lname, leaf in leaves.items():
                nd = leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)
                if lname in ("k", "v", "k_s", "v_s"):
                    ax = ("null", "batch", "sp", None, None)
                elif lname in ("cross_k", "cross_v"):
                    ax = ("null", "batch", None, None, None)
                elif kind == "mamba" and lname == "conv":
                    ax = ("null", "batch", None, "tp")
                elif kind == "mamba" and lname == "h":
                    ax = ("null", "batch", "tp", None)
                elif kind == "mlstm" and lname == "C":
                    ax = ("null", "batch", "tp", None, None)
                elif kind == "mlstm" and lname in ("n",):
                    ax = ("null", "batch", "tp", None)
                elif kind == "mlstm" and lname == "m":
                    ax = ("null", "batch", "tp")
                else:                       # slstm scalar-memory states
                    ax = ("null", "batch", "tp")
                if len(ax) != nd:
                    raise ValueError(f"cache leaf {bname}.{lname} has {nd} "
                                     f"axes; its spec {ax} names "
                                     f"{len(ax)}")
                sub[lname] = ax
            out[bname] = sub
        return out

    return {"blocks": walk(cache["blocks"])}


def _spec_bytes(shape, dtype, axes, mesh, rules) -> int:
    """A rank's bytes of a full leaf of ``shape`` laid out by its logical
    ``axes`` on ``mesh`` (a dimension its axes do not divide replicates)."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    spec = valid_spec(tuple(shape), logical_to_spec(axes, rules, mesh), mesh)
    n = math.prod(shape) * dtype.itemsize
    for e in spec:
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n //= sizes[a]
    return n


# ----------------------------------------------------------------------
# The fake world
# ----------------------------------------------------------------------

def _fake_cuda_guard() -> None:
    """Load a CUDA device guard that does nothing, where PyTorch was built
    without CUDA: fake CUDA tensors then take the path a card's would
    (views, copies, indexing enter a device guard).  Compiled from
    ``fake_cuda_guard.cpp`` with the host's C++ compiler at first use."""
    if torch.backends.cuda.is_built() or getattr(_fake_cuda_guard, "done",
                                                 False):
        return
    import ctypes
    import hashlib
    import sysconfig

    from ..kernels._build import build_dir

    src = os.path.join(os.path.dirname(__file__), "fake_cuda_guard.cpp")
    root = os.path.dirname(torch.__file__)
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             "-I", os.path.join(root, "include"),
             "-L", os.path.join(root, "lib"), "-lc10",
             f"-Wl,-rpath,{os.path.join(root, 'lib')}"]
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags).encode()
                             + torch.__version__.encode()).hexdigest()[:16]
    out = build_dir() / f"libfake_cuda_guard_{key}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.so")
        cxx = sysconfig.get_config_var("CXX") or "c++"
        res = subprocess.run([cxx.split()[0], src, "-o", str(tmp), *flags],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the fake CUDA device guard "
                               f"failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    ctypes.CDLL(str(out), mode=ctypes.RTLD_GLOBAL)
    _fake_cuda_guard.done = True


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks, this
    process rank 0 (replacing a fake group of another size)."""
    # DTensor registers its ops as it is imported: outside fake mode that
    # is seconds, inside it (the first placed parameter) a minute.
    import torch.distributed.tensor  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group that is not fake exists: "
                               "the dry run needs its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _nbytes(tree) -> int:
    """Bytes of the rank's blocks of every tensor in ``tree``."""
    from torch.utils._pytree import tree_leaves

    return sum(fsdp.local(t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# ----------------------------------------------------------------------
# One cell
# ----------------------------------------------------------------------

def fake_device(shape: ShapeConfig) -> str:
    """The device type of a cell's fake tensors: ``cuda``, but ``cpu`` for
    a train cell where PyTorch was built without CUDA (module
    docstring)."""
    return ("cpu" if shape.kind == "train"
            and not torch.backends.cuda.is_built() else "cuda")


def trace_cell(cfg, shape: ShapeConfig, mesh, *, moe_impl="scatter",
               remat=True, accum_steps=1, sp_act=False, kv_dtype=None):
    """Run one cell's step on fake tensors of ``mesh``'s device type as
    rank 0 of its fake world; returns ``(trace, memory, meta)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import decode_step, init_cache, init_model, prefill
    from ..training.optim import init_opt_state
    from ..training.train import make_train_step

    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    if shape.is_decode and moe_impl == "ep":
        # The reference's policy: EP for train/prefill, scatter for decode.
        moe_impl = "scatter"
    rules = pick_rules(cfg, shape, mesh, sp_act=sp_act)
    meta = {"rules": dataclasses.asdict(rules),
            "fake_device": mesh.device_type}
    _fake_cuda_guard()
    with FakeTensorMode():
        dev = torch.device(mesh.device_type, 0)
        gen = (torch.Generator(device=dev) if torch.cuda.is_available()
               else torch.Generator())
        model = init_model(cfg, generator=gen, device=dev, mesh=mesh,
                           rules=rules)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in input_specs(cfg, shape).items()}
        rows = max(1, math.prod(
            mesh.size(i) for i in fsdp.batch_dims(mesh, rules)))
        args = {"params": _nbytes(list(model.parameters())),
                "batch": _nbytes(batch) // rows}
        trace = OpTrace()
        if shape.kind == "train":
            opt_cfg = pick_opt(cfg)
            opt = init_opt_state(model, opt_cfg)
            args["opt_state"] = _nbytes(opt)
            step = make_train_step(cfg, opt_cfg, moe_impl=moe_impl,
                                   remat=remat, accum_steps=accum_steps)
            with sharding_context(mesh, rules), trace:
                _, _, out = step(model, opt, batch)
            meta.update(step="train_step", opt_state=opt_cfg.state_dtype)
        elif shape.kind == "prefill":
            with torch.no_grad(), sharding_context(mesh, rules), trace:
                out = prefill(model, cfg, batch, max_len=shape.seq_len,
                              moe_impl=moe_impl)
            meta["step"] = "prefill_step"
        else:
            enc_len = shape.seq_len if cfg.enc_dec else 0
            with torch.no_grad(), sharding_context(mesh, rules):
                cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                                   enc_len, device=dev)
                args["cache"] = _nbytes(cache)
            full = init_cache(cfg, shape.global_batch, shape.seq_len,
                              enc_len, device="meta")
            ref = _cache_logical_specs(cfg, full)["blocks"]
            meta["cache_bytes_reference_layout"] = sum(
                _spec_bytes(leaf.shape, leaf.dtype, ref[b][n], mesh, rules)
                for b, leaves in full["blocks"].items()
                for n, leaf in leaves.items())
            with torch.no_grad(), sharding_context(mesh, rules):
                with trace:
                    out = decode_step(model, cfg, cache, batch["tokens"],
                                      shape.seq_len - 1, moe_impl=moe_impl)
            meta["step"] = "serve_step"
            meta["kv_layout"] = (
                "flash-decoding: KV positions split over sp"
                if rules.flash_decode else
                "KV positions whole on each rank (the reference shards "
                "them over sp)")
    memory = {"argument_bytes": sum(args.values()), "argument_parts": args,
              "output_bytes": _nbytes(out), "temp_bytes": trace.peak_bytes,
              "alias_bytes": 0}
    memory["live_bytes"] = memory["argument_bytes"] + trace.peak_bytes
    memory["peak_bytes"] = memory["live_bytes"]
    return trace, memory, meta


def run_cell(cfg, shape, mesh_name: str, *, out_dir=None, verbose=True,
             **kw):
    """Trace and analyse one cell on the fake world of ``mesh_name``;
    returns the record dict."""
    from .mesh import make_production_mesh

    multi = mesh_name == "multipod"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device=fake_device(shape))
    chips = mesh.size()
    rec = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "chips": chips,
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return _emit(rec, out_dir, verbose)
    t0 = time.time()
    try:
        trace, memory, meta = trace_cell(cfg, shape, mesh, **kw)
        rec.update(meta)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["memory"] = memory
        rec["fits_80gb_hbm"] = bool(memory["live_bytes"] < HBM_BYTES)
        mod = analyze_trace(trace)
        flops, bytes_acc = mod["flops"], mod["bytes"]
        coll = mod["collectives"]
        rec["cost"] = {
            "flops_per_device": flops,
            "bytes_accessed_per_device": bytes_acc,
            "gather_bytes_per_device": mod["gather_bytes"],
            "collective_bytes_per_device": coll,
            "census": mod["census"],
            "kernel_launches": {k.removeprefix("repro_torch."): v
                                for k, v in trace.counts().items()
                                if k.startswith("repro_torch.")},
        }
        rec["roofline"] = roofline_terms(flops, bytes_acc, coll["total"])
        # Useful-compute ratio: model flops / traced flops (global).
        tokens = shape.global_batch * (1 if shape.is_decode
                                       else shape.seq_len)
        mult = 6 if shape.kind == "train" else 2
        model_flops = mult * cfg.active_param_count() * tokens
        rec["model_flops"] = float(model_flops)
        global_flops = flops * chips
        rec["useful_flops_ratio"] = (
            float(model_flops / global_flops) if global_flops else None)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _emit(rec, out_dir, verbose)


def _emit(rec, out_dir, verbose):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"[OK]   {rec['arch']:24s} {rec['shape']:12s} "
                  f"{rec['mesh']:8s} dominant={r['dominant']:10s} "
                  f"c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
                  f"x={r['collective_s']:.3e} "
                  f"live={rec['memory']['live_bytes'] / 1e9:.2f}GB "
                  f"(trace {rec.get('trace_s')}s)", flush=True)
        elif rec["status"] == "skipped":
            print(f"[SKIP] {rec['arch']:24s} {rec['shape']:12s} "
                  f"{rec['mesh']:8s} {rec['reason'][:60]}", flush=True)
        else:
            print(f"[ERR]  {rec['arch']:24s} {rec['shape']:12s} "
                  f"{rec['mesh']:8s} {rec['error'][:120]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Dry run: every (arch x shape) cell's step on fake "
                    "tensors as rank 0 of a fake 256/512-rank world")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--moe-impl", default="scatter",
                    choices=["scatter", "einsum", "grouped", "ep"])
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream (flash-"
                         "decoding on a decode cell)")
    ap.add_argument("--kv-dtype", default=None, choices=["bf16", "int8"],
                    help="decode KV-cache storage dtype")
    args = ap.parse_args(argv)

    meshes = (["pod", "multipod"] if args.mesh == "both"
              else [args.mesh])
    # Explicit --arch/--shape filters win over --all.
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else sorted(SHAPES)

    n_bad = 0
    try:
        for mesh_name in meshes:
            for a in archs:
                for s in shapes:
                    rec = run_cell(ARCHS[a], SHAPES[s], mesh_name,
                                   out_dir=args.out,
                                   accum_steps=args.accum_steps,
                                   moe_impl=args.moe_impl, sp_act=args.sp,
                                   kv_dtype=args.kv_dtype)
                    n_bad += rec["status"] == "error"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
