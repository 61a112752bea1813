"""A record of every operator one eager call dispatches, and its totals.

The port's counterpart of ``repro/analysis/hlo_module.py``.  The
reference parses a compiled HLO module and weights each ``while`` body
by its trip count, because ``cost_analysis()`` visits a loop body once.
Eager PyTorch has no loop to weight: a Python loop (the layers, the
attention's KV blocks, a scan's chunks, accumulation steps) dispatches
every iteration, and the trace records each one.

:class:`OpTrace` is a :class:`~torch.utils._python_dispatch.TorchDispatchMode`:
while it is active it records each aten op (not the ``prim`` queries of
a tensor's metadata, which launch nothing), each hand-written kernel
(the ``repro_torch::`` custom ops of :mod:`repro_torch.kernels`) and
each ``c10d`` collective with its operands' and results' types, its
operations and its bytes, and it tracks the bytes of live storage the
call allocates.  It works alike on tensors on the card, on the CPU and
fake tensors (:class:`torch._subclasses.fake_tensor.FakeTensorMode`,
the dry run's), since it reads only shapes and dtypes.

:func:`analyze_trace` returns the keys of the reference's
``analyze_module``:

* ``flops``: from PyTorch's flop-counter registry
  (:data:`torch.utils.flop_counter.flop_registry`: the matrix products,
  convolutions and attention), which holds the kernels' own formulas
  (:func:`repro_torch.analysis.census.register_kernel_op`);
* ``bytes``: each launch's operands read and results written, which is
  what eager mode moves, unfused; a view launches nothing and moves
  nothing; a kernel op moves the bytes of its bound
  (:data:`repro_torch.analysis.census.KERNEL_TERMS`);
* ``gather_bytes``: the bytes of the ops the census classes as gather;
* ``collectives``: bytes per kind, the reference's convention
  (:func:`repro_torch.analysis.census.collective_bytes`);
* ``census``: the paper's op classes
  (:func:`repro_torch.analysis.census.op_census`).
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from . import census

__all__ = ["OpRecord", "OpTrace", "analyze_trace", "type_string"]

# The HLO names of dtypes (the reference's ``_DTYPE_BYTES`` keys).
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
          torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
          torch.bool: "pred", torch.complex64: "c64",
          torch.complex128: "c128"}


def type_string(t: torch.Tensor) -> str:
    """``t``'s type as the reference's HLO writes one: ``bf16[4,8]``."""
    dt = _SHORT.get(t.dtype, str(t.dtype).removeprefix("torch."))
    return f"{dt}[{','.join(str(int(n)) for n in t.shape)}]"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose result aliases an operand without writing it (a view:
    no kernel runs)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: ``name`` (``aten.mm``, ``repro_torch.slstm``,
    ``c10d.allreduce_``), its operands' and results' types, and its
    operations, bytes moved and result bytes."""

    name: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    flops: int
    bytes: int
    out_bytes: int

    @property
    def op_class(self) -> str:
        return census.op_class(self.name)


class OpTrace(TorchDispatchMode):
    """Record every op dispatched while the mode is active (see the module
    docstring).  :attr:`records` holds an :class:`OpRecord` per dispatch;
    :attr:`peak_bytes` is the largest count of bytes of storage allocated
    under the mode and alive at once (:attr:`live_bytes` now)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":        # metadata (.device): no launch
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ns, op = func.namespace, func._overloadpacket.__name__
        name = f"{ns}.{op}"
        flops = 0
        if ns == "repro_torch":
            flops, nbytes = census.KERNEL_TERMS[op](*args)
        else:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                flops = int(formula(*args, **kwargs, out_val=out))
            nbytes = 0 if ns == "c10d" or _is_view(func) else (
                sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        self.records.append(OpRecord(
            name, tuple(map(type_string, ins)), tuple(map(type_string, outs)),
            flops, nbytes, sum(map(_nbytes, outs))))
        if not _is_view(func):
            for t in outs:
                self._track(t)
        return out

    def names(self) -> list[str]:
        """The op name of every dispatch, in order."""
        return [r.name for r in self.records]

    def counts(self) -> Counter:
        """Dispatches by op name."""
        return Counter(self.names())


def analyze_trace(trace: OpTrace) -> dict:
    """Totals of one traced call: the keys of the reference's
    ``analyze_module`` (``flops``, ``bytes``, ``gather_bytes``,
    ``collectives``, ``census``), per rank."""
    recs = trace.records
    return {
        "flops": float(sum(r.flops for r in recs)),
        "bytes": float(sum(r.bytes for r in recs)),
        "gather_bytes": float(sum(r.bytes for r in recs
                                  if r.op_class == "gather")),
        "collectives": census.collective_bytes(
            (r.name, r.out_bytes) for r in recs
            if r.name.startswith("c10d.")),
        "census": census.op_census(trace.names())["classes"],
    }
