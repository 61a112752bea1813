"""Count and time the port's row-1 back projection and row encoder, and
hold them against an older checkout's, on one CUDA card.

    python3 tools/kernel_census.py [--parent DIR] [--out DIR] [--reps N]

``--parent`` names an unpacked older checkout (``git archive <commit>``
into a directory that ``.gitignore`` lists, such as ``build/parent``);
``--out`` (default ``build/census``) receives the cubins, libraries,
SASS listings and ``census.json``.

1. **Census.**  Compiles ``csrc/backproject.cu`` and ``csrc/quant.cu``
   of this checkout (and of the parent) to a cubin with the port's
   ``nvcc`` flags and ``-Xptxas -v``, prints each kernel's registers and
   spill bytes, and counts the SASS of each kernel's loops by class
   (FP32, integer/address, LDS, LDG, STS/STG, conversion/MUFU, control,
   other).  For each loop it prints the static count of the whole body
   and of its fast path (from the loop's head to its back branch: the
   fewest calls, then the most unpredicated global loads, then the
   longest; see :func:`fast_path`), and writes the listings to
   ``--out``.
2. **Turns.**  At full RabbitCT width (L = 512, 1248 x 960, filtered
   views of the phantom and a random volume) it launches row 1 on the
   float32, bfloat16 and int8 wires at P = 1, 4 and 8, and the encoder
   at P = 4 and 31, in turns parent, change, change, parent (median of
   ``--reps`` CUDA-event timings each), checks that the two give the
   same bits, and prints one JSON line with the times.

Needs ``nvcc`` and ``cuobjdump`` (``CUDA_HOME`` or ``PATH``); imports no
JAX.  Without a card it stops after the census.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

SOURCES = ("backproject", "quant")
CLASSES = ("fp32", "int", "lds", "ldg", "store", "conv_mufu", "control",
           "other")
_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
         "FSWZADD", "HADD2", "HMUL2", "HFMA2")
_INT = ("IADD", "IMAD", "LEA", "ISETP", "LOP", "SHF", "SEL", "MOV", "IABS",
        "PRMT", "SGXT", "IMNMX", "VIADD", "VIMNMX", "BMSK", "FLO", "POPC",
        "PLOP3", "P2R", "R2P", "SHL", "SHR", "UIADD", "UMOV", "ULDC",
        "UIMAD", "ULOP", "USHF", "ULEA", "USEL", "UISETP", "I2IP", "IDP")
_CONV = ("F2I", "I2F", "FRND", "MUFU", "F2F", "I2I", "F2FP", "I2FP")
_CONTROL = ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC",
            "NOP", "BAR", "DEPBAR", "YIELD", "BREAK", "JMP", "SYNCS")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def classify(op: str) -> str:
    name = op.split(".")[0]
    if name == "LDS":
        return "lds"
    if name in ("LDG", "LD", "LDGSTS"):
        return "ldg"
    if name in ("STS", "STG", "ST", "RED", "ATOM", "ATOMG"):
        return "store"
    for cls, names in (("conv_mufu", _CONV), ("fp32", _FP32),
                       ("control", _CONTROL), ("int", _INT)):
        if any(name.startswith(n) for n in names):
            return cls
    return "other"


def compile_cubin(src: pathlib.Path, out: pathlib.Path) -> str:
    """nvcc ``src`` to ``out`` with the port's flags; returns ptxas's
    ``-v`` report."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    res = subprocess.run(
        [_build.find_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(out), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    return res.stdout + res.stderr


def resources(report: str) -> dict:
    """Registers and spill bytes per kernel from ptxas's report."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.setdefault(fn, {})["spill"] = [int(m.group(1)),
                                              int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def sass(cubin: pathlib.Path) -> dict[str, list[tuple[int, str]]]:
    """``{function: [(address, instruction), ...]}`` of a cubin."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _opcode(ins: str) -> str:
    body = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins)
    return body.split()[0] if body else ""


def _target(ins: str):
    m = re.search(r"\b(?:BRA|JMP)\b.*?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def counts(instrs) -> dict:
    c = dict.fromkeys(CLASSES, 0)
    for _, ins in instrs:
        c[classify(_opcode(ins))] += 1
    c["total"] = len(instrs)
    return c


def loops(code):
    """Each backward branch's loop: ``(head, tail)`` addresses."""
    out = []
    for addr, ins in code:
        t = _target(ins)
        if t is not None and t <= addr:
            out.append((t, addr))
    return out


def _calls(ins: str) -> int:
    return int(_opcode(ins).startswith("CALL"))


def _plain_load(ins: str) -> int:
    return int(not ins.startswith("@") and classify(_opcode(ins)) == "ldg")


def fast_path(code, head: int, tail: int):
    """The fast path through the loop body, from ``head`` to ``tail``:
    of the paths with the fewest calls (a slow path kept out of line:
    the slow path of an IEEE division, the encoder's exact rounding),
    those with the most unpredicated global loads (a tap quad read with
    no per-tap test), and of those the longest (a division taken where
    a branch skips it)."""
    idx = [i for i, (a, _) in enumerate(code) if head <= a <= tail]
    at = {code[i][0]: i for i in idx}
    best: dict[int, tuple] = {}     # (-calls, loads, len), next
    for i in reversed(idx):
        addr, ins = code[i]
        own = (-_calls(ins), _plain_load(ins), 1)
        if addr == tail:
            best[i] = (own, None)
            continue
        op = _opcode(ins)
        t = _target(ins)
        nxt = []
        if not (op in ("BRA", "EXIT", "RET") and not ins.startswith("@")):
            nxt.append(i + 1)
        if t is not None and t > addr and t in at:
            nxt.append(at[t])
        nxt = [j for j in nxt if j in best]
        if nxt:
            j = max(nxt, key=lambda j: best[j][0])
            best[i] = (tuple(a + b for a, b in zip(own, best[j][0])), j)
    path, i = [], at[head] if at[head] in best else None
    while i is not None:
        path.append(code[i])
        i = best[i][1]
    return path


def _short(fn: str) -> str:
    """``backproject_batch_kernel<F32Taps>`` from a mangled name."""
    head, _, tail = fn.partition("_kernel")
    m = re.search(r"([A-Za-z_]+)$", head)
    name = (m.group(1) if m else head) + "_kernel"
    t = re.match(r"INS_\d+(\w+?)E", tail)
    return f"{name}<{t.group(1)}>" if t else name


def census(tree: pathlib.Path, label: str, outdir: pathlib.Path) -> dict:
    rec = {}
    for name in SOURCES:
        src = tree / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        cubin = outdir / f"{label}_{name}.cubin"
        res = resources(compile_cubin(src, cubin))
        for k, (fn, code) in enumerate(sass(cubin).items()):
            entry = {"resources": res.get(fn, {}), "all": counts(code),
                     "loops": []}
            listing = [f"// {fn}"] + [f"/*{a:04x}*/ {s}" for a, s in code]
            for head, tail in loops(code):
                body = [(a, s) for a, s in code if head <= a <= tail]
                path = fast_path(code, head, tail)
                entry["loops"].append({"head": hex(head), "tail": hex(tail),
                                       "body": counts(body),
                                       "fast_path": counts(path)})
                listing.append(f"// loop {hex(head)}..{hex(tail)}")
                listing += [f"/*{a:04x}*/ {s}" for a, s in body]
            rec[f"{name}:{_short(fn)}"] = entry
            (outdir / f"{label}_{name}_{k}.sass").write_text(
                "\n".join(listing) + "\n")
            print(f"{label} {name} {_short(fn)}: {entry['resources']}; "
                  f"{len(entry['loops'])} loops")
            for lp in entry["loops"]:
                print(f"    loop {lp['head']}..{lp['tail']}: body "
                      f"{lp['body']}; fast path {lp['fast_path']}")
    return rec


def _load(tree: pathlib.Path, name: str, outdir: pathlib.Path, label: str):
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    so = outdir / f"{label}_lib{name}.so"
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(so), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(str(so))


def turns(trees: dict, outdir: pathlib.Path, reps: int) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.geometry import Geometry, projection_matrices
    from repro_torch.core.phantom import forward_project

    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [I_] * 6 + [F_, F_, P_]
    entries = {"float32": ("backproject_batch_launch", [P_] * 3 + geo),
               "bfloat16": ("backproject_batch_bf16_launch", [P_] * 3 + geo),
               "int8": ("backproject_batch_int8_launch", [P_] * 4 + geo)}
    libs = {}
    for label, tree in trees.items():
        bp = _load(tree, "backproject", outdir, label)
        qt = _load(tree, "quant", outdir, label)
        fns = {}
        for wire, (sym, argt) in entries.items():
            fn = getattr(bp, sym)
            fn.argtypes, fn.restype = argt, I_
            fns[wire] = fn
        q = qt.quantize_rows_launch
        q.argtypes, q.restype = [P_, P_, P_] + [I_] * 4 + [P_], I_
        fns["quant"] = q
        libs[label] = fns

    dev = torch.device("cuda", 0)
    geom = Geometry()
    L = geom.L
    idx = np.linspace(0, geom.n_proj - 1, 8).astype(int)
    raw = forward_project(geom, angles=geom.angles[idx], device=dev)
    imgs = filter_projections(raw, geom, angle_indices=idx, device=dev)
    mats = torch.tensor(projection_matrices(geom)[idx], device=dev)
    padded = F.pad(imgs, (1, 1, 1, 1)).contiguous()
    _, rows, cols = padded.shape
    vol0 = torch.tensor(np.random.default_rng(0).standard_normal(
        (L, L, L), dtype=np.float32), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def encode(label, x, symmetric=0):
        codes = torch.empty(x.shape, dtype=torch.int8, device=dev)
        scales = torch.empty((x.shape[0], 2, x.shape[1]),
                             dtype=torch.float32, device=dev)
        rc = libs[label]["quant"](x.data_ptr(), codes.data_ptr(),
                                  scales.data_ptr(), x.shape[0], x.shape[1],
                                  x.shape[2], symmetric, stream)
        if rc:
            raise RuntimeError(f"{label} encoder launch failed: {rc}")
        return codes, scales

    codes, scales = encode("parent" if "parent" in libs else "change",
                           padded)
    stacks = {"float32": (padded, None),
              "bfloat16": (padded.to(torch.bfloat16), None),
              "int8": (codes, scales)}

    def time_ms(fn):
        fn()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def row1(label, wire, P, vol):
        stack, sc = stacks[wire]
        head = [vol.data_ptr(), stack.data_ptr()]
        if sc is not None:
            head.append(sc.data_ptr())
        rc = libs[label][wire](*head, mats.data_ptr(), P, L, L, 0, rows,
                               cols, float(geom.O), float(geom.MM), stream)
        if rc:
            raise RuntimeError(f"{label} row 1 launch failed: {rc}")

    order = ["parent", "change", "change", "parent"] if "parent" in libs \
        else ["change", "change"]
    rec = {"row1": {}, "quant": {}, "same_bits": {}}
    for wire in entries:
        for P in (1, 4, 8):
            outs = {}
            for label in dict.fromkeys(order):
                v = vol0.clone()
                row1(label, wire, P, v)
                torch.cuda.synchronize()
                outs[label] = v
            if "parent" in outs:
                same = bool(torch.equal(outs["parent"], outs["change"]))
                rec["same_bits"][f"{wire}/P={P}"] = same
            del outs
            work = vol0.clone()
            t = [time_ms(lambda lb=lb: row1(lb, wire, P, work))
                 for lb in order]
            rec["row1"][f"{wire}/P={P}"] = dict(zip(
                [f"{lb}{i}" for i, lb in enumerate(order)], t))
            print(f"row 1 {wire} P={P}: " + ", ".join(
                f"{lb} {ms:.4f}" for lb, ms in zip(order, t)) + " ms",
                flush=True)
    chunk = padded.repeat(4, 1, 1)[:31].contiguous()
    for n, x in ((4, padded[:4].contiguous()), (31, chunk)):
        for sym in (0, 1):
            outs = {lb: encode(lb, x, sym) for lb in dict.fromkeys(order)}
            if "parent" in outs:
                rec["same_bits"][f"quant/P={n}/sym={sym}"] = all(
                    bool(torch.equal(a, b))
                    for a, b in zip(outs["parent"], outs["change"]))
        t = [time_ms(lambda lb=lb: encode(lb, x)) for lb in order]
        rec["quant"][f"P={n}"] = dict(zip(
            [f"{lb}{i}" for i, lb in enumerate(order)], t))
        print(f"encoder P={n}: " + ", ".join(
            f"{lb} {ms:.4f}" for lb, ms in zip(order, t)) + " ms", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=_ROOT / "build" / "census")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"change": _ROOT}
    if args.parent is not None:
        trees = {"parent": args.parent.resolve(), "change": _ROOT}
    rec = {"census": {lb: census(t, lb, args.out) for lb, t in trees.items()}}
    import torch

    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card)
        rec["card"] = card
        rec.update(turns(trees, args.out, args.reps))
    (args.out / "census.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items() if k != "census"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
