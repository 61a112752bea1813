"""Launch-contract pass: the CUDA entry points against their bindings.

The port's counterpart of ``repro/analysis/lint/ledger.py``.  The
reference replays each Pallas kernel's DMA issue and wait order, which
Mosaic checks nowhere.  The CUDA kernels have no DMA semaphores; what
corrupts a launch silently here is the contract between a kernel's
``extern "C"`` entry point and the ``ctypes`` argument types its Python
wrapper binds (``ctypes`` checks a call against the types it was given,
never against the library), and the limits both sides state.  A wrapper
that passes one argument fewer than the entry takes hands the kernel
whatever the ABI leaves in that register.  This pass reads
``kernels/csrc/*.cu`` and the wrappers' binding tables, on the CPU:

* ``entry-signature-mismatch``: an entry point's parameters and its
  binding disagree in count or in kind (pointer, ``int``, ``long long``,
  ``float``);
* ``unbound-entry``: a source exports an entry no wrapper binds;
* ``missing-entry``: a wrapper binds a name its library does not export;
* ``limit-mismatch``: a limit the Python side and the C side both state
  disagrees (:func:`limit_facts`): ``SMEM_LIMIT`` against each shared
  memory opt-in the C side can request, ``MAX_PBATCH`` against the
  48 KB of dynamic shared memory row 1 takes without one, ``KEY_POS_BITS``
  against ``gather.cu``'s packing, the strip kernels' kinds and K5's
  record sets and slots, the sLSTM backward's warps and chunk.

``--kernel-fixture PATH`` checks one ``.cu`` file in place of the
library whose bound entries it exports most of.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re

from .common import Finding, PassResult

__all__ = ["Binding", "bindings", "limit_facts",
           "parse_entries", "run_ledger_pass"]

_CSRC = pathlib.Path(__file__).resolve().parents[2] / "kernels" / "csrc"

# A C parameter's kind, and the kind of each ctypes type.
_CTYPE_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
               ctypes.c_longlong: "long long", ctypes.c_float: "float"}

_ENTRY_RE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


@dataclasses.dataclass(frozen=True)
class Binding:
    """A wrapper's binding of one entry point: the library (``csrc/<lib>.cu``),
    the entry's name, the ``ctypes`` argument types, and the table they
    come from."""

    lib: str
    entry: str
    argtypes: tuple
    table: str


def _kind(param: str) -> str:
    p = " ".join(param.split())
    if "*" in p:
        return "pointer"
    for kind in ("long long", "float", "int"):
        if re.search(rf"\b{kind}\b", p):
            return kind
    return p


def parse_entries(text: str) -> dict:
    """``{entry: (parameter kinds, line)}`` of every ``extern "C"`` entry
    point in a CUDA source."""
    out = {}
    for m in _ENTRY_RE.finditer(text):
        params = [p for p in m.group(2).split(",") if p.strip()]
        if params == ["void"]:
            params = []
        out[m.group(1)] = (tuple(_kind(p) for p in params),
                           text.count("\n", 0, m.start()) + 1)
    return out


def bindings() -> list:
    """Every entry point the wrappers bind, from their own tables."""
    from ...kernels import backproject as bp
    from ...kernels import gather as g
    from ...kernels import quant as q
    from ...kernels import slstm as sl

    out = [Binding("backproject", name, tuple(at), "backproject._ENTRIES")
           for name, at in bp._ENTRIES.values()]
    out.append(Binding("backproject_strip", bp._STRIP_ENTRY,
                       tuple(bp._STRIP_ARGTYPES),
                       "backproject._STRIP_ARGTYPES"))
    for entries, at, table in ((g._ENTRIES, g._ARGTYPES, "_ARGTYPES"),
                               (g._GRAD_ENTRIES, g._GRAD_ARGTYPES,
                                "_GRAD_ARGTYPES"),
                               (g._BLOCK_ENTRIES, g._BLOCK_ARGTYPES,
                                "_BLOCK_ARGTYPES")):
        out += [Binding("gather", name, tuple(at), f"gather.{table}")
                for name in entries.values()]
    out.append(Binding("quant", q._ENTRY, tuple(q._ARGTYPES),
                       "quant._ARGTYPES"))
    out += [Binding("slstm", name, tuple(at), "slstm._ARGTYPES")
            for name, at in sl._ARGTYPES.items()]
    return out


def _int(pattern: str, text: str):
    m = re.search(pattern, text)
    return None if m is None else int(m.group(1))


def limit_facts(sources: dict) -> list:
    """``(name, Python value, C value, holds)`` for each limit both sides
    state; ``sources`` maps a library to its CUDA text.  A C value the
    source no longer states is ``None`` and does not hold."""
    from ...kernels import backproject as bp
    from ...kernels import gather as g
    from ...kernels import slstm as sl

    facts = []
    gather = sources["gather"]
    bits = _int(r"constexpr\s+int\s+kPosBits\s*=\s*(\d+)", gather)
    facts.append(("gather.KEY_POS_BITS == gather.cu kPosBits",
                  g.KEY_POS_BITS, bits, bits == g.KEY_POS_BITS))
    # The one-block sort stages 2 keys a slot of the next power of two of
    # its ids, at most 2^kPosBits of them, and opts in above 48 KB.
    sort = None if bits is None else 2 * (1 << bits) * 4
    facts.append(("gather.cu one-block sort opt-in <= SMEM_LIMIT",
                  bp.SMEM_LIMIT, sort,
                  sort is not None and sort <= bp.SMEM_LIMIT))
    slstm = sources["slstm"]
    w = _int(r"#define\s+SLSTM_BWD_W\s+(\d+)", slstm)
    t = _int(r"#define\s+SLSTM_BWD_T\s+(\d+)", slstm)
    facts.append(("slstm.BWD_WARPS == slstm.cu SLSTM_BWD_W",
                  sl.BWD_WARPS, w, w == sl.BWD_WARPS))
    facts.append(("slstm.BWD_CHUNK == slstm.cu SLSTM_BWD_T",
                  sl.BWD_CHUNK, t, t == sl.BWD_CHUNK))
    stage = _int(r"constexpr\s+int\s+kBwdIn\s*=\s*(\d+)", slstm)
    maps = _int(r"constexpr\s+int\s+kBwdMap\s*=\s*(\d+)", slstm)
    bwd = (None if None in (w, t, stage, maps)
           else (w * t * stage * 32 + w * maps * 32) * 4)
    facts.append(("slstm.cu backward opt-in kBwdSmem <= SMEM_LIMIT",
                  bp.SMEM_LIMIT, bwd, bwd is not None
                  and bwd <= bp.SMEM_LIMIT))
    strip = sources["backproject_strip"]
    kinds = re.search(r"enum\s+Kind\s*\{([^}]*)\}", strip)
    c_kinds = None if kinds is None else [
        int(v) for v in re.findall(r"=\s*(\d+)", kinds.group(1))]
    facts.append(("backproject.STRIP_KINDS == backproject_strip.cu Kind",
                  sorted(bp.STRIP_KINDS.values()), c_kinds,
                  c_kinds == sorted(bp.STRIP_KINDS.values())))
    for py, c in ((bp._SHARED_SETS, "kSharedSets"),
                  (bp._SHARED_SLOTS, "kSharedSlots")):
        v = _int(rf"constexpr\s+int\s+{c}\s*=\s*(\d+)", strip)
        facts.append((f"strip_smem_bytes's K5 count == backproject_strip.cu "
                      f"{c}", py, v, v == py))
    # Row 1 stages P x 12 floats of matrices as dynamic shared memory
    # with no opt-in: MAX_PBATCH of them must fit the 48 KB default.
    row1 = sources["backproject"]
    per = _int(r"\(P\)\s*\*\s*(\d+)\s*\*\s*sizeof\(float\)", row1)
    opt_in = "cudaFuncSetAttribute" in row1
    need = None if per is None else bp.MAX_PBATCH * per * 4
    facts.append(("backproject.MAX_PBATCH matrices <= 48 KB without an "
                  "opt-in", 48 * 1024, need,
                  need is not None and (opt_in or need <= 48 * 1024)))
    return facts


def _sources(fixture=None) -> tuple[dict, dict]:
    """``{lib: text}`` and ``{lib: path}`` of the bound libraries, with
    ``fixture`` in place of the library whose bound entries it exports
    most of."""
    libs = sorted({b.lib for b in bindings()})
    paths = {lib: _CSRC / f"{lib}.cu" for lib in libs}
    if fixture is not None:
        names = set(parse_entries(pathlib.Path(fixture).read_text()))
        score = {lib: sum(b.entry in names for b in bindings()
                          if b.lib == lib) for lib in libs}
        best = max(score.values())
        if best == 0 or list(score.values()).count(best) > 1:
            raise ValueError(f"{fixture}: cannot tell which library it "
                             f"stands for (bound entries exported: "
                             f"{score})")
        paths[max(score, key=score.get)] = pathlib.Path(fixture)
    return {lib: p.read_text() for lib, p in paths.items()}, paths


def _check(sources: dict, paths: dict, only=None) -> tuple[list, int]:
    """Findings and units checked, over the libraries in ``only`` (all
    when ``None``) and every limit fact."""
    findings, checked = [], 0
    exported = {lib: parse_entries(text) for lib, text in sources.items()}
    bound = {}
    for b in bindings():
        bound.setdefault(b.lib, set()).add(b.entry)
        if only is not None and b.lib not in only:
            continue
        checked += 1
        entry = exported[b.lib].get(b.entry)
        if entry is None:
            findings.append(Finding(
                "ledger", "missing-entry", f"{paths[b.lib]}:{b.entry}",
                f"{b.table} binds {b.entry!r}, which {paths[b.lib].name} "
                f"does not export"))
            continue
        want = tuple(_CTYPE_KIND.get(a, str(a)) for a in b.argtypes)
        if entry[0] != want:
            findings.append(Finding(
                "ledger", "entry-signature-mismatch",
                f"{paths[b.lib]}:{entry[1]}",
                f"{b.entry} takes {len(entry[0])} parameters "
                f"{list(entry[0])}; {b.table} binds {len(want)} "
                f"{list(want)}"))
    for lib, entries in exported.items():
        if only is not None and lib not in only:
            continue
        for name, (_, line) in entries.items():
            if name not in bound.get(lib, ()):
                findings.append(Finding(
                    "ledger", "unbound-entry", f"{paths[lib]}:{line}",
                    f"{name} is exported but no wrapper binds it"))
    for name, py, c, holds in limit_facts(sources):
        checked += 1
        if not holds:
            findings.append(Finding(
                "ledger", "limit-mismatch", name,
                f"the Python side states {py}, the C side {c}"))
    return findings, checked


def run_ledger_pass(fixture=None) -> PassResult:
    """The launch-contract pass over ``kernels/csrc/*.cu``, or with
    ``fixture`` over that file in place of its library."""
    sources, paths = _sources(fixture)
    if fixture is not None:
        only = {k for k, p in paths.items() if p == pathlib.Path(fixture)}
        findings, checked = _check(sources, paths, only)
        return PassResult("ledger", findings, checked,
                          [f"fixture {fixture} checked as csrc/"
                           f"{next(iter(only))}.cu"])
    findings, checked = _check(sources, paths)
    findings += [Finding("ledger", "unbound-entry", str(p),
                         "a CUDA source no wrapper binds")
                 for p in sorted(_CSRC.glob("*.cu")) if p.stem not in sources]
    return PassResult("ledger", findings, checked)
