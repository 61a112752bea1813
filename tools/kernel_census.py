"""Count and time the port's row-1 back projection, row encoder, sLSTM
recurrence and backward kernels, and hold them against an older
checkout's, on one CUDA card.

    python3 tools/kernel_census.py [--parent DIR] [--out DIR] [--reps N]
                                   [--only NAME ...]

``--parent`` names an unpacked older checkout (``git archive <commit>``
into a directory that ``.gitignore`` lists, such as ``build/parent``);
``--out`` (default ``build/census``) receives the cubins, libraries,
SASS listings and ``census.json``; ``--only`` keeps some of the sources
``backproject``, ``quant``, ``slstm`` and ``gather`` (default: all
four), and with them their turns (row 1 and the encoder need both of
the first two; ``slstm`` runs the recurrence's and its backward's,
``gather`` the gather backward's); ``--skip-forward`` leaves out the
sLSTM forward's turns; ``--bwd-variants 8x8 4x16 ...`` adds the sLSTM
backward built with W warps a block and chunks of T tokens to its
turns.

1. **Census.**  Compiles ``csrc/<name>.cu`` of this checkout (and of the
   parent) to a cubin with the port's ``nvcc`` flags and ``-Xptxas -v``,
   prints each kernel's registers and spill bytes, and counts the SASS
   of each kernel's loops by class (FP32, integer/address, LDS, LDG,
   STS/STG, conversion/MUFU, control, other).  For each loop it prints
   the static count of the whole body and of its fast path (from the
   loop's head to its back branch: the fewest calls, then the most
   unpredicated global loads, then the longest; see :func:`fast_path`),
   and writes the listings to ``--out``.  For the sLSTM kernels each
   loop's counts are also given per token step (from the loop's ``STG``
   count: one ``h`` store a token in the served recurrence, four stores
   in the training forward and in the backward, whose ``d zifo`` stores
   come last in its piece loop), and for the served recurrence the
   dependent path from one step's ``h`` to the next (:func:`h_chain`, a
   def-use walk over the SASS: its operations, the SFU ones among them,
   and its cycles at the latencies below).
2. **Latencies** (on a card).  ``tools/latency_probe.cu`` times chains of
   dependent FFMA, FADD, MUFU.EX2, MUFU.RCP (less an FADD) and MUFU.LG2
   (less an EX2) with ``clock64`` in one warp, and the SM clock against
   the global timer.
3. **Turns** (on a card).  At full RabbitCT width (L = 512, 1248 x 960,
   filtered views of the phantom and a random volume) it launches row 1
   on the float32, bfloat16 and int8 wires at P = 1, 4 and 8, and the
   encoder at P = 4 and 31, in turns parent, change, change, parent
   (median of ``--reps`` CUDA-event timings each), and checks that the
   two give the same bits.  The sLSTM recurrence runs at di = 1536 and
   (B, S) = (1, 1), (4, 1), (1, 512), (8, 512), (8, 2048) in the same
   turns, timed on the device alone over repeated launches (the card
   spins while the host enqueues) and one launch at a time with the
   gates rewritten before each (as the gate projection leaves them), each
   output held to the plain version at rtol = atol = 2e-4.  Prints one
   JSON line with the times.
4. **Backward turns** (on a card).  The sLSTM backward (row 10b) at di =
   1536 and the training path's (B, S) = (8, 64), (4, 1), (1, 512), (8,
   2048), from the states the training forward saves, each tree's
   ``slstm_backward_launch`` in turns, held to autograd through the
   plain recurrence at rtol = atol = 2e-4 and run twice for the same
   bits.  The gather backward (row 9b) at xlstm-125m's and chatglm3-6b's
   tables, bf16 and f32, N = 4, 512 and 8192, each tree through the
   path its own launcher takes (the one-block sort where the tree has
   it, else ``torch.sort`` and the two kernels), in turns, with
   ``aten.embedding_dense_backward`` timed beside it, held bitwise to
   the plain version and to each other.  Each backward's device
   launches (name, µs) come from ``torch.profiler`` around one call.

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

SOURCES = ("backproject", "quant", "slstm", "gather")
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
    if t:
        return f"{name}<{t.group(1)}>"
    t = re.match(r"ILb([01])E", tail)
    return f"{name}<{'true' if t.group(1) == '1' else 'false'}>" if t \
        else name


def _stores_per_step(fn: str) -> int:
    """Global stores a token step of the sLSTM kernel ``fn``: the served
    recurrence stores h, the training forward h and the saved (c, n, m),
    the backward d zifo; 0 for the others."""
    for key, n in (("slstm_backward_kernel", 4), ("slstm_train_kernel", 4),
                   ("slstm_kernel", 1)):
        if key in fn:
            return n
    return 0


_REG = re.compile(r"(?<![\w.])(U?[RP]\d+)\b")
_NO_DEST = ("ST", "STG", "STS", "STL", "RED", "BRA", "JMP", "EXIT", "BAR",
            "NOP", "YIELD", "DEPBAR", "WARPSYNC", "BSSY", "BSYNC", "CALL",
            "RET", "MEMBAR", "CCTL", "ERRBAR", "BREAK")


def defs_uses(ins: str) -> tuple[set, set]:
    """The registers and predicates ``ins`` writes and reads.  A
    predicated write also reads what it writes (where its guard is off,
    the old value stays)."""
    guard = re.match(r"^@!?(U?P\d+)\s+", ins)
    body = ins[guard.end():] if guard else ins
    op, _, rest = body.partition(" ")
    ops = [o.strip() for o in rest.split(",")] if rest else []
    name = op.split(".")[0]
    n_dest = 0 if name in _NO_DEST else 2 if name.endswith("SETP") else 1
    defs = {r for o in ops[:n_dest] for r in _REG.findall(o)}
    uses = {r for o in ops[n_dest:] for r in _REG.findall(o)}
    if guard:
        uses |= defs | {guard.group(1)}
    return defs, uses


def _cycles(op: str, lat) -> float:
    if lat is None:
        return 1.0
    if op.startswith("MUFU"):
        return lat.get(op.split(".")[1], lat["MUFU"])
    return lat["FP32"]


def h_chain(body, lat=None) -> dict:
    """The dependent path from one token step's ``h`` to the next step's
    in a loop body, by a def-use walk over its SASS in program order.  A
    step's ``h`` is the register its ``STG`` stores; the path starts at
    the instruction that wrote it and ends at the one that writes the
    next store's.  Of all paths between them, the one of most cycles at
    ``lat`` (``{"FP32": c, "EX2": c, "LG2": c, "RCP": c, "MUFU": c}``;
    every instruction one cycle when None, so the longest).  A predicated
    write reads the value it replaces, so two forms of one value under
    opposite predicates count one after the other: an upper bound by the
    shorter form.  Returns its operations, SFU operations, cycles and
    opcodes, the largest over the body's pairs of steps."""
    parsed = [(_opcode(ins), *defs_uses(ins)) for _, ins in body]
    writers = []
    for i, (op, _, _) in enumerate(parsed):
        if op.startswith("STG"):
            reg = _REG.findall(body[i][1])[-1]
            writers.append(max((j for j in range(i) if reg in parsed[j][1]),
                               default=None))
    worst = None
    for w0, w1 in zip(writers, writers[1:]):
        if w0 is None or w1 is None or w1 <= w0:
            continue
        best = {r: (0.0, 0, 0, ()) for r in parsed[w0][1]}
        for j in range(w0 + 1, w1 + 1):
            op, defs, uses = parsed[j]
            srcs = [best[r] for r in uses if r in best]
            for r in defs:
                best.pop(r, None)
            if srcs:
                cyc, n, sfu, path = max(srcs)
                val = (cyc + _cycles(op, lat), n + 1,
                       sfu + op.startswith("MUFU"), path + (op,))
                for r in defs:
                    best[r] = val
        ends = [best[r] for r in parsed[w1][1] if r in best]
        if ends and (worst is None or max(ends) > worst):
            worst = max(ends)
    if worst is None:
        return {}
    return {"ops": worst[1], "sfu": worst[2], "cycles": worst[0],
            "path": list(worst[3])}


def steady_loop(code):
    """The sLSTM kernel's steady token loop: of the loops that store an
    ``h`` (``STG``), the one with the most token steps, then the fewest
    branches.  Returns its body, or None."""
    best, key = None, None
    for head, tail in loops(code):
        body = [(a, s) for a, s in code if head <= a <= tail]
        steps = sum(_opcode(s).startswith("STG") for _, s in body)
        branches = sum(_target(s) is not None for _, s in body)
        if steps and (key is None or (steps, -branches) > key):
            best, key = body, (steps, -branches)
    return best


def slstm_chain(binary: pathlib.Path, lat: dict) -> dict:
    """The h -> h path of most cycles of the sLSTM kernel in ``binary`` (a
    cubin, or the shared library the port builds and loads), in its
    steady loop, at the latencies ``lat`` (:func:`latencies`), and the
    ns a token step it takes at the measured clock: the chain floor.  Of
    the kernel's instances (with and without the L2 prefetch), the
    longer path.  The training instances (``slstm_train_kernel``, which
    also store each step's state) and the backward kernels are not
    read."""
    chain = max((h_chain(steady_loop(code), lat)
                 for fn, code in sass(binary).items()
                 if "slstm_kernel" in fn),
                key=lambda c: c["cycles"])
    chain["ns_per_step"] = 1e3 * chain["cycles"] / lat["clock_mhz"]
    return chain


def census(tree: pathlib.Path, label: str, outdir: pathlib.Path,
           sources=SOURCES, lat=None) -> dict:
    rec = {}
    for name in sources:
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
                lp = {"head": hex(head), "tail": hex(tail),
                      "body": counts(body), "fast_path": counts(path)}
                per = _stores_per_step(fn) if name == "slstm" else 0
                steps = sum(_opcode(s).startswith("STG")
                            for _, s in body) // max(per, 1)
                if per and steps:
                    # Counts per token step, from the loop's stores.
                    lp["steps"] = steps
                    lp["body_per_step"] = {
                        c: v / steps for c, v in lp["body"].items()}
                    lp["fast_path_per_step"] = {
                        c: v / steps for c, v in lp["fast_path"].items()}
                    if per == 1:
                        lp["h_chain"] = h_chain(body)
                        if lat is not None:
                            lp["h_chain_cycles"] = h_chain(body, lat)
                entry["loops"].append(lp)
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
                if "steps" in lp:
                    per = {c: round(v, 3)
                           for c, v in lp["fast_path_per_step"].items()}
                    body = {c: round(v, 3)
                            for c, v in lp["body_per_step"].items()}
                    print(f"      {lp['steps']} token steps; per step: "
                          f"body {body}, fast path {per}")
                if "h_chain" in lp:
                    print(f"      h -> h path {lp['h_chain']}")
                    if "h_chain_cycles" in lp:
                        print(f"      h -> h path of most cycles "
                              f"{lp['h_chain_cycles']}")
    return rec


def _shared_lib(src: pathlib.Path, so: pathlib.Path,
                flags=()) -> ctypes.CDLL:
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *flags,
                          "-o", str(so), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(str(so))


_LIBS: dict = {}


def _load(tree: pathlib.Path, name: str, outdir: pathlib.Path, label: str,
          flags=()):
    """``csrc/<name>.cu`` of ``tree`` built (with the extra nvcc
    ``flags``) and loaded once per label."""
    if (label, name) not in _LIBS:
        src = tree / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        _LIBS[label, name] = _shared_lib(
            src, outdir / f"{label}_lib{name}.so", flags)
    return _LIBS[label, name]


def latencies(outdir: pathlib.Path) -> dict:
    """Cycles per dependent FP32 operation and per SFU function, and the SM
    clock in MHz, from ``tools/latency_probe.cu`` on card 0."""
    import torch

    src = _ROOT / "tools" / "latency_probe.cu"
    cubin = outdir / "latency_probe.cubin"
    compile_cubin(src, cubin)
    for fn, code in sass(cubin).items():
        print(f"latency probe SASS: {counts(code)} "
              f"({sum(_opcode(s).startswith('MUFU') for _, s in code)} "
              f"MUFU)")
    fn = _shared_lib(src, outdir / "liblatency_probe.so").latency_probe
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 2, ctypes.c_int
    dev = torch.device("cuda", 0)
    out = torch.zeros(9, dtype=torch.int64, device=dev)
    for _ in range(2):              # the first run warms the clocks
        rc = fn(out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"latency probe launch failed: {rc}")
        torch.cuda.synchronize()
    v = [int(x) for x in out.cpu()]
    n = v[7]
    ex2 = v[2] / n
    lat = {"FP32": v[0] / n, "FADD": v[1] / n, "EX2": ex2,
           "RCP": (v[3] - v[1]) / n, "LG2": v[4] / n - ex2,
           "clock_mhz": 1e3 * v[5] / v[6]}
    lat["MUFU"] = max(lat["EX2"], lat["RCP"], lat["LG2"])
    print(f"latencies (cycles): {lat}")
    return lat


SLSTM_SHAPES = ((1, 1), (4, 1), (1, 512), (8, 512), (8, 2048))   # (B, S)
SLSTM_DI = 1536          # xlstm-125m's d_inner
SLSTM_TOL = 2e-4         # rtol = atol against the plain version


def device_ms(fn, inner: int, reps: int) -> float:
    """ms per call of ``fn`` on the device alone: the median of ``reps``
    CUDA-event timings of ``inner`` calls enqueued while the card spins
    (``torch.cuda._sleep``), the spin doubled until the host finished
    enqueueing before the card reached the first event."""
    import torch

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
        if a.query():
            b.synchronize()
            spin *= 2
            if spin > 2**31:
                raise RuntimeError("the host could not enqueue ahead of "
                                   "the card")
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def slstm_turns(trees: dict, outdir: pathlib.Path, reps: int) -> dict:
    """Each tree's sLSTM kernel at SLSTM_DI and SLSTM_SHAPES from a fresh
    state, in turns (the labels in order, then reversed): device ms per
    launch and ns per token step over repeated launches, ms per launch
    with the gates rewritten before each (median of ``reps`` single
    launches, each queued behind a spin so that the events time the
    kernel: the gates come from where the copy left them, not from the
    last launch), and each output's largest |d| / (1
    + |ref|) against the plain version (hidden and final state), which
    must stay within SLSTM_TOL."""
    import torch

    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_recurrence_ref)

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for label, tree in trees.items():
        fn = _load(tree, "slstm", outdir, label).slstm_launch
        fn.argtypes, fn.restype = [P_] * 5 + [I_] * 3 + [P_], I_
        fns[label] = fn
    labels = list(trees)
    order = labels + labels[::-1]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    di = SLSTM_DI
    g = torch.Generator(device=dev).manual_seed(0)
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    rec = {}
    for B, S in SLSTM_SHAPES:
        zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
        state = init_slstm_state(B, di, device=dev)
        hs = torch.empty((B, S, di), device=dev)
        final = torch.empty((4, B, di), device=dev)

        def launch(label):
            rc = fns[label](zifo.data_ptr(), r.data_ptr(), state.data_ptr(),
                            hs.data_ptr(), final.data_ptr(), B, S, di,
                            stream)
            if rc:
                raise RuntimeError(f"{label} slstm launch failed: {rc}")

        want_hs, want = slstm_recurrence_ref(zifo, r, state)
        err = {}
        for label in labels:
            launch(label)
            torch.cuda.synchronize()
            err[label] = max(float(((got - ref).abs() / (1 + ref.abs()))
                                   .max())
                             for got, ref in ((hs, want_hs), (final, want)))
            if not err[label] <= SLSTM_TOL:
                raise RuntimeError(f"{label} slstm B={B} S={S}: error "
                                   f"{err[label]:.3e} over {SLSTM_TOL}")
        inner = 50 if S == 1 else max(3, 4096 // (B * S))
        t = [device_ms(lambda lb=lb: launch(lb), inner, reps)
             for lb in order]
        # Fresh gates, as the model's gate projection writes them just
        # before the recurrence: zifo rewritten before each timed launch.
        gates = zifo.clone()
        fresh = []
        for lb in order:
            times = []
            for _ in range(reps + 1):
                zifo.copy_(gates)
                torch.cuda._sleep(2_000_000)    # the launch queued behind a
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                launch(lb)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            fresh.append(statistics.median(times[1:]))
        key = f"B={B}/S={S}"
        names = [f"{lb}{i}" for i, lb in enumerate(order)]
        rec[key] = {"ms": dict(zip(names, t)),
                    "ns_per_step": {n: 1e6 * ms / S
                                    for n, ms in zip(names, t)},
                    "fresh_ms": dict(zip(names, fresh)), "err": err}
        print(f"slstm {key}: " + ", ".join(
            f"{lb} {ms:.5f} ms ({1e6 * ms / S:.1f} ns a step)"
            for lb, ms in zip(order, t)) + "; fresh gates " + ", ".join(
            f"{lb} {ms:.5f}" for lb, ms in zip(order, fresh)) +
            " ms; error " + ", ".join(
            f"{lb} {e:.2e}" for lb, e in err.items()), flush=True)
        del zifo, gates, hs, want_hs
    return rec


SLSTM_BWD_SHAPES = ((8, 64), (4, 1), (1, 512), (8, 2048))   # (B, S)
GATHER_TABLES = ((50304, 768), (65024, 4096))   # xlstm-125m, chatglm3-6b
GATHER_NS = (4, 512, 8192)


def launch_parts(fn, calls: int = 3) -> list:
    """The device launches of one call of ``fn``, from ``torch.profiler``
    over ``calls`` calls: ``[(kernel name, µs a launch, launches a
    call), ...]``, the longest first.  (The profiler may drop a call's
    events: the launches a call then read under 1.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out.append((e.key[:90], us / max(e.count, 1), e.count / calls))
    return sorted(out, key=lambda x: -x[1])


def _rel_err(got, want) -> float:
    return float(((got - want).abs() / (1 + want.abs())).max())


def slstm_bwd_turns(trees: dict, outdir: pathlib.Path, reps: int,
                    variants=()) -> dict:
    """Each tree's sLSTM backward at SLSTM_DI and SLSTM_BWD_SHAPES, from a
    fresh state and the states this checkout's training forward saves, in
    turns: device ms per launch (both kernels), each launch's parts, and
    the largest |d| / (1 + |ref|) of d zifo and d r against autograd
    through the plain recurrence, which must stay within SLSTM_TOL; two
    runs must give the same bits.  ``variants`` (``"WxT"``) add this
    checkout's kernel built with W warps a block and chunks of T tokens
    (``-DSLSTM_BWD_W``, ``-DSLSTM_BWD_T``), labelled ``wWxT``."""
    import torch

    from repro_torch.kernels.slstm import launch_slstm_train
    from repro_torch.kernels.slstm_ref import (init_slstm_state,
                                               slstm_backward_ref)

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    builds = {label: (tree, ()) for label, tree in trees.items()}
    for v in variants:
        W, T = v.split("x")
        builds[f"w{v}"] = (_ROOT, (f"-DSLSTM_BWD_W={W}",
                                   f"-DSLSTM_BWD_T={T}"))
    fns = {}
    for label, (tree, flags) in builds.items():
        fn = _load(tree, "slstm", outdir, label, flags).slstm_backward_launch
        fn.argtypes, fn.restype = [P_] * 9 + [I_] * 3 + [P_], I_
        fns[label] = fn
    labels = list(builds)
    order = labels + labels[::-1]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    di = SLSTM_DI
    g = torch.Generator(device=dev).manual_seed(15)
    r = torch.randn((4, di), generator=g, device=dev) / di ** 0.5
    rec = {}
    for B, S in SLSTM_BWD_SHAPES:
        zifo = torch.randn((B, S, 4, di), generator=g, device=dev)
        dhs = torch.randn((B, S, di), generator=g, device=dev)
        state = init_slstm_state(B, di, device=dev)
        hs, _, states = launch_slstm_train(zifo, r, state)
        dz = torch.empty_like(zifo)
        part = torch.empty((B, 4, di), device=dev)
        dr = torch.empty((4, di), device=dev)

        def launch(label):
            rc = fns[label](zifo.data_ptr(), r.data_ptr(), state.data_ptr(),
                            hs.data_ptr(), states.data_ptr(), dhs.data_ptr(),
                            dz.data_ptr(), part.data_ptr(), dr.data_ptr(),
                            B, S, di, stream)
            if rc:
                raise RuntimeError(f"{label} slstm backward launch failed: "
                                   f"{rc}")

        want_z, want_r = slstm_backward_ref(zifo, r, state, dhs)
        err = {}
        for label in labels:
            launch(label)
            torch.cuda.synchronize()
            first = (dz.clone(), dr.clone())
            launch(label)
            torch.cuda.synchronize()
            if not (torch.equal(first[0], dz) and torch.equal(first[1], dr)):
                raise RuntimeError(f"{label} slstm backward B={B} S={S}: two "
                                   f"runs differ")
            err[label] = max(_rel_err(dz, want_z), _rel_err(dr, want_r))
            if not err[label] <= SLSTM_TOL:
                raise RuntimeError(f"{label} slstm backward B={B} S={S}: "
                                   f"error {err[label]:.3e} over "
                                   f"{SLSTM_TOL}")
            del first
        inner = 20 if S <= 64 else 3
        t = [device_ms(lambda lb=lb: launch(lb), inner, reps) for lb in order]
        parts = {lb: launch_parts(lambda lb=lb: launch(lb)) for lb in labels}
        key = f"B={B}/S={S}"
        names = [f"{lb}{i}" for i, lb in enumerate(order)]
        rec[key] = {"ms": dict(zip(names, t)), "err": err, "parts": parts}
        print(f"slstm backward {key}: " + ", ".join(
            f"{lb} {ms:.5f}" for lb, ms in zip(order, t)) + " ms; error "
            + ", ".join(f"{lb} {e:.2e}" for lb, e in err.items())
            + "; parts " + "; ".join(
                f"{lb} " + ", ".join(f"{k} {us:.2f} us x{n:g}"
                                     for k, us, n in ps)
                for lb, ps in parts.items()), flush=True)
        del zifo, dhs, hs, states, dz, want_z
    return rec


def _gather_grad_launcher(lib, offset: bool):
    """The gather backward of one tree's library as that tree's launcher
    runs it, ``(ids, dout, V) -> d table``: the one-block sort where the
    library has it and :func:`repro_torch.kernels.gather.grad_path`
    chooses it, else ``torch.sort`` and the two kernels.  ``offset``:
    the tree's entry points take a shard offset after ``V`` (passed 0)."""
    import torch

    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    longs = 3 if offset else 2
    extra = (0,) if offset else ()
    sort, block = {}, {}
    for dt, n in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"onehot_gather_grad_{n}_launch")
        fn.argtypes, fn.restype = [P_] * 5 + [L_] * longs + [I_, I_, P_], I_
        sort[dt] = fn
        if hasattr(lib, f"onehot_gather_grad_block_{n}_launch"):
            fn = getattr(lib, f"onehot_gather_grad_block_{n}_launch")
            fn.argtypes, fn.restype = [P_] * 4 + [L_] * longs + [
                I_, I_, P_], I_
            block[dt] = fn

    def launch(ids, dout, V):
        N, D = dout.shape
        dtable = torch.empty((V, D), dtype=dout.dtype, device=dout.device)
        vec16 = int(D * dout.element_size() % 16 == 0
                    and dout.data_ptr() % 16 == 0
                    and dtable.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        if block:
            from repro_torch.kernels.gather import (grad_path,
                                                    grad_scratch_ints)
        if block and grad_path(N, V) == "block":
            scratch = torch.empty((grad_scratch_ints(N, V),),
                                  dtype=torch.int32, device=dout.device)
            rc = block[dout.dtype](ids.data_ptr(), dout.data_ptr(),
                                   scratch.data_ptr(), dtable.data_ptr(), N,
                                   V, *extra, D, vec16, stream)
        else:
            sorted_ids, perm = torch.sort(ids, stable=True)
            starts = torch.empty((V + 1,), dtype=torch.int64,
                                 device=dout.device)
            rc = sort[dout.dtype](sorted_ids.data_ptr(), perm.data_ptr(),
                                  dout.data_ptr(), starts.data_ptr(),
                                  dtable.data_ptr(), N, V, *extra, D, vec16,
                                  stream)
        if rc:
            raise RuntimeError(f"gather backward launch failed: {rc}")
        return dtable

    return launch


def gather_grad_turns(trees: dict, outdir: pathlib.Path, reps: int) -> dict:
    """Each tree's gather backward at GATHER_TABLES, bf16 and f32, N in
    GATHER_NS (a run of repeated ids, ids -1 and V), in turns: device ms
    per call (the whole path, the sort included), each call's device
    launches, ``aten.embedding_dense_backward`` on the same gradient;
    each tree's result equal to the plain version bitwise, twice."""
    import torch

    from repro_torch.kernels.gather_ref import gather_grad_ref

    def takes_offset(tree):
        src = tree / "src" / "repro_torch" / "kernels" / "csrc" / "gather.cu"
        return "long long V, long long offset" in src.read_text()

    launchers = {label: _gather_grad_launcher(
        _load(tree, "gather", outdir, label), takes_offset(tree))
        for label, tree in trees.items()}
    labels = list(trees)
    order = labels + labels[::-1]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(16)
    rec = {}
    for V, D in GATHER_TABLES:
        for dtype in (torch.bfloat16, torch.float32):
            for N in GATHER_NS:
                ids = torch.randint(0, V, (N,), generator=g, device=dev)
                ids[0], ids[1] = -1, V
                if N >= 8:
                    ids[2:6] = ids[6]
                dout = torch.randn((N, D), generator=g, device=dev).to(dtype)
                want = gather_grad_ref(ids, dout, V)
                for label in labels:
                    a = launchers[label](ids, dout, V)
                    b = launchers[label](ids, dout, V)
                    torch.cuda.synchronize()
                    if not (torch.equal(a, want) and torch.equal(a, b)):
                        raise RuntimeError(
                            f"{label} gather backward V={V} {dtype} N={N}: "
                            f"not the plain version's bits twice")
                    del a, b
                del want
                inner = 5 if N > 512 or D > 1024 else 20

                def run(lb):
                    launchers[lb](ids, dout, V)

                t = [device_ms(lambda lb=lb: run(lb), inner, reps)
                     for lb in order]
                clamped = ids.clamp(0, V - 1)
                lib_ms = device_ms(
                    lambda: torch.ops.aten.embedding_dense_backward(
                        dout, clamped, V, -1, False), inner, reps)
                parts = {lb: launch_parts(lambda lb=lb: run(lb))
                         for lb in labels}
                key = f"V={V}/D={D}/{str(dtype).split('.')[-1]}/N={N}"
                names = [f"{lb}{i}" for i, lb in enumerate(order)]
                rec[key] = {"ms": dict(zip(names, t)), "library_ms": lib_ms,
                            "parts": parts}
                print(f"gather backward {key}: " + ", ".join(
                    f"{lb} {ms:.5f}" for lb, ms in zip(order, t))
                    + f" ms; embedding_dense_backward {lib_ms:.5f} ms; "
                    + "parts " + "; ".join(
                        f"{lb} " + ", ".join(f"{k} {us:.2f} us x{n:g}"
                                             for k, us, n in ps)
                        for lb, ps in parts.items()), flush=True)
                del dout
            torch.cuda.empty_cache()
    return rec


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
    ap.add_argument("--only", nargs="+", choices=SOURCES, default=SOURCES)
    ap.add_argument("--skip-forward", action="store_true")
    ap.add_argument("--bwd-variants", nargs="*", default=[],
                    metavar="WxT")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"change": _ROOT}
    if args.parent is not None:
        trees = {"parent": args.parent.resolve(), "change": _ROOT}
    import torch

    rec, lat = {}, None
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card)
        rec["card"] = card
        if "slstm" in args.only:
            lat = rec["latencies"] = latencies(args.out)
    rec["census"] = {lb: census(t, lb, args.out, args.only, lat)
                     for lb, t in trees.items()}
    if torch.cuda.is_available():
        if {"backproject", "quant"} <= set(args.only):
            rec.update(turns(trees, args.out, args.reps))
        if "slstm" in args.only:
            if not args.skip_forward:
                rec["slstm"] = slstm_turns(trees, args.out, args.reps)
            rec["slstm_backward"] = slstm_bwd_turns(
                trees, args.out, args.reps, args.bwd_variants)
        if "gather" in args.only:
            rec["gather_backward"] = gather_grad_turns(trees, args.out,
                                                       args.reps)
    (args.out / "census.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items() if k != "census"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
