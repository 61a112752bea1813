"""Op census, collective bytes and roofline terms of the eager port.

The port's counterpart of ``repro/analysis/hlo.py``.  The reference
classes the opcodes of a compiled HLO module; the port runs eagerly, so
what it classes are the operators one call dispatches, as
:class:`repro_torch.analysis.trace.OpTrace` records them: aten ops, the
hand-written kernels (the ``repro_torch::`` custom ops of
:mod:`repro_torch.kernels`) and the ``c10d`` collectives.  The five
classes are the paper's (Table 2: memory, gather, shuffle, arith,
other).  The row gather's kernels count as gather, and so do the back
projections: their bilinear taps are the scattered access the paper
measures.

The card's constants, in one place (NVIDIA H100 80GB HBM3, SXM, at its
700 W power limit; NVIDIA's data sheet, dense rates):
:data:`PEAK_BF16_FLOPS` (tensor cores), :data:`PEAK_FP32_FLOPS`
(outside the tensor cores), :data:`PEAK_BYTES_S` (HBM3),
:data:`NVLINK_BYTES_S` (each way, to the other cards of the host) and
:data:`HBM_BYTES`.  A card set below 700 W runs slower than these.

The reference's ``GATHER_DERATE`` has no counterpart: it models a TPU,
which has no vector-gather hardware and serialises row gathers at about
1/16 of stream bandwidth.  Hopper's load units gather, and the gather
kernels here are bound by the bytes they move (PERF.md's kernel table),
so a gathered byte is priced like any other.

Each hand-written kernel's operations and bytes are here too
(:data:`KERNEL_TERMS`): the terms of the ``bound_ms`` column of PERF.md's
kernel table, which ``chip_smoke.py`` computes through the same
functions, and which :mod:`repro_torch.kernels` registers as the flop
formula of each custom op.
"""

from __future__ import annotations

import re
from collections import Counter

__all__ = ["COLLECTIVES", "HBM_BYTES", "KERNEL_TERMS", "NVLINK_BYTES_S",
           "PEAK_BF16_FLOPS", "PEAK_BYTES_S", "PEAK_FP32_FLOPS",
           "backproject_terms", "bound_ms", "collective_bytes",
           "gather_backward_terms", "gather_terms",
           "op_class", "op_census", "parse_shape_bytes", "quant_terms",
           "register_kernel_op", "roofline_terms", "slstm_backward_extra",
           "slstm_backward_terms", "slstm_terms"]

PEAK_BF16_FLOPS = 989e12    # tensor cores, dense bf16 (FLOP/s)
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores (FLOP/s)
PEAK_BYTES_S = 3.35e12      # HBM3 (bytes/s)
NVLINK_BYTES_S = 450e9      # NVLink, each way (bytes/s)
HBM_BYTES = 80e9            # device memory (bytes)

# ----------------------------------------------------------------------
# The kernels' operations and bytes
# ----------------------------------------------------------------------

# Back projection (rows 1-8), per voxel: 6 float operations for the
# voxel's world coordinates, 37 per projection (three 3x4 rows, the
# reciprocal, the taps' fractions, the bilinear blend, the 1/w^2 weight,
# the add), and on the int8 wire 2 more per tap for the decode (code *
# scale + offset).
FLOPS_PER_VOXEL = 6
FLOPS_PER_VOXEL_PROJ = 37
WIRE_FLOPS_PER_VOXEL_PROJ = {"float32": 0, "bfloat16": 0, "int8": 4 * 2}
WIRE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
# Row encoder: per pixel 2 operations for the range (pass 1) and 9 for
# the error-feedback step (add, sub, div, round, 2 clamps, mul, add, sub).
QUANT_FLOPS_PER_PIXEL = 11
# Operations of one sLSTM step per feature, a transcendental counted as
# one: 4 r·h products and 4 adds, tanh, sigmoid (3), softplus (6), the
# stabiliser (4), two exponentials, c (3), n (2), h (3).
SLSTM_FLOPS_PER_STEP = 32
# Operations of one step of slstm_backward_kernel per (batch row,
# feature), counted from its body as SLSTM_FLOPS_PER_STEP is (a
# transcendental or a division as one; negations and |x| as none, being
# operand modifiers; a tie test of max as its two comparisons): the
# recomputation 27 (z 3, i 2, f 2, o 5, log f 4, a 1, m 1, the two
# exponentials 4, c 3, n 2), the derivative 59 (dH 1, max(n', 1e-6) 1,
# do 2, dc' 3, d max(n', 1e-6) 4, dn' 4, d ea 3, d eb 2, dz dc dn dA dB
# 5, dm' 2, da 4, di 4, df 3, dz' 3, do' 3, the four d r sums 8, dh 7).
SLSTM_BWD_FLOPS_PER_STEP = 27 + 59
# What the chunked scan does beyond them, counted from its body the same
# way (a multiply-add as two), per token and feature: phase 1 carries the
# step through the map's four columns (map_step, 25 each) and its vector
# (26), and phase 3 derives the step's coefficients a second time from
# the values phase 1 stored (coefs, 29); per chunk, phase 2's hop (16
# multiply-adds, 32).
SLSTM_BWD_COMPOSE_FLOPS_PER_STEP = 4 * 25 + 26 + 29
SLSTM_BWD_HOP_FLOPS = 32


def backproject_terms(L: int, nz: int, P: int, rows: int, cols: int,
                      wire: str = "float32") -> tuple[int, int]:
    """(operations, bytes) of one back-projection launch (rows 1-8) on a
    ``(nz, L, L)`` slab: the volume read and written once, each image,
    scale block and matrix read once."""
    vox = nz * L * L
    nbytes = (2 * vox * 4 + P * rows * cols * WIRE_BYTES[wire] + P * 48
              + (P * 2 * rows * 4 if wire == "int8" else 0))
    flops = vox * (FLOPS_PER_VOXEL + (FLOPS_PER_VOXEL_PROJ
                                      + WIRE_FLOPS_PER_VOXEL_PROJ[wire]) * P)
    return flops, nbytes


def quant_terms(P: int, rows: int, cols: int) -> tuple[int, int]:
    """(operations, bytes) of one row-encoder launch: pixels read as
    float32 and written as int8 once, the (P, 2, rows) block written
    once."""
    return (P * rows * cols * QUANT_FLOPS_PER_PIXEL,
            P * rows * cols * 5 + P * rows * 8)


def gather_terms(N: int, D: int, itemsize: int,
                 inside: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one row gather (row 9): ``N`` ids read, ``N``
    rows written, and the ``inside`` rows whose ids fall in the table
    read (all ``N`` when not given)."""
    inside = N if inside is None else inside
    return 0, N * 8 + (N + inside) * D * itemsize


def gather_backward_terms(N: int, V: int, D: int,
                          itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of the gather's backward (row 9b): ids and
    ``dout`` read, ``d table`` written once.  Its adds are counted as
    none: a row is written, not accumulated, where its id is unique."""
    return 0, (V + N) * D * itemsize + N * 8


def slstm_terms(B: int, S: int, di: int,
                keep_states: bool = False) -> tuple[int, int]:
    """(operations, bytes) of the sLSTM recurrence (row 10): zifo read
    (16 B) and h written (4 B) per token and feature, the two states and
    r once; with ``keep_states`` (the training instance) each step's
    (c, n, m) written too (12 B)."""
    nbytes = B * S * di * (20 + (12 if keep_states else 0)) \
        + 2 * 4 * B * di * 4 + 4 * di * 4
    return B * S * di * SLSTM_FLOPS_PER_STEP, nbytes


def slstm_backward_terms(B: int, S: int, di: int) -> tuple[int, int]:
    """(operations, bytes) of the function row 10b computes, (zifo, r, the
    initial state, dhs) -> (d zifo, d r): per token and feature the gates
    (16 B) and dh (4 B) read and d zifo (16 B) written, the initial
    state, r and d r once; the operations, and the B-term sums of d r."""
    nbytes = B * S * di * 36 + 4 * B * di * 4 + 2 * 4 * di * 4
    return B * S * di * SLSTM_BWD_FLOPS_PER_STEP + B * 4 * di, nbytes


def slstm_backward_extra(B: int, S: int, di: int,
                         chunk: int) -> tuple[int, int]:
    """What row 10b's design does beyond :func:`slstm_backward_terms`:
    (operations of the chunked scan's composition and second pass over
    chunks of ``chunk`` tokens, bytes of the hidden states and saved (c,
    n, m) it reads and of the saved state the training forward writes
    for it)."""
    flops = B * di * (S * SLSTM_BWD_COMPOSE_FLOPS_PER_STEP
                      + -(-S // chunk) * SLSTM_BWD_HOP_FLOPS)
    return flops, B * S * di * (16 + 12)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of ``flops`` float32 operations and ``nbytes``
    bytes on the card, in ms, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


_WIRES = {1: "int8", 2: "bfloat16", 4: "float32"}


def _backproject_op(volume, padded, mats, scales, z0, O, MM):
    P, rows, cols = padded.shape
    return backproject_terms(volume.shape[1], volume.shape[0], P, rows,
                             cols, _WIRES[padded.element_size()])


def _strip_op(volume, stack, mats, scales, clamps, kind, z0, O, MM, n_u,
              n_v, *tiling):
    return backproject_terms(volume.shape[1], volume.shape[0],
                             stack.shape[0], n_v + 2, n_u + 2,
                             _WIRES[stack.element_size()])


def _quant_op(x, symmetric):
    return quant_terms(*x.shape)


def _gather_op(table, ids, offset):
    return gather_terms(ids.shape[0], table.shape[1], table.element_size())


def _gather_grad_op(ids, dout, V, offset):
    return gather_backward_terms(ids.shape[0], V, dout.shape[1],
                                 dout.element_size())


def _slstm_op(zifo, r, state):
    B, S, _, di = zifo.shape
    return slstm_terms(B, S, di)


def _slstm_train_op(zifo, r, state):
    B, S, _, di = zifo.shape
    return slstm_terms(B, S, di, keep_states=True)


def _slstm_backward_op(zifo, r, state, hs, states, dhs):
    B, S, _, di = zifo.shape
    return slstm_backward_terms(B, S, di)


# The custom op of each hand-written kernel (``torch.ops.repro_torch.*``)
# and its (operations, bytes) from the op's arguments (tensors, real or
# fake).
KERNEL_TERMS = {
    "backproject": _backproject_op,
    "backproject_strip": _strip_op,
    "quantize_rows": _quant_op,
    "onehot_gather": _gather_op,
    "onehot_gather_grad": _gather_grad_op,
    "slstm": _slstm_op,
    "slstm_train": _slstm_train_op,
    "slstm_backward": _slstm_backward_op,
}


def register_kernel_op(name: str) -> None:
    """Register kernel op ``torch.ops.repro_torch.<name>``'s operations
    (:data:`KERNEL_TERMS`) as its formula in PyTorch's flop counter, which
    :class:`torch.utils.flop_counter.FlopCounterMode` and
    :func:`repro_torch.analysis.trace.analyze_trace` read."""
    import torch
    from torch.utils.flop_counter import register_flop_formula

    terms = KERNEL_TERMS[name]

    def flops(*args, out_val=None, **kwargs):
        return terms(*args, **kwargs)[0]

    register_flop_formula(getattr(torch.ops.repro_torch, name),
                          get_raw=True)(flops)


# ----------------------------------------------------------------------
# Classes, collectives, roofline
# ----------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")


def parse_shape_bytes(typestr: str) -> int:
    """Total bytes of every type literal (``bf16[4,8]``, as
    :func:`repro_torch.analysis.trace.type_string` writes them) in
    ``typestr``."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(typestr):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


# c10d collectives by kind (the reference's names), from the op name.
COLLECTIVES = {
    "allreduce_": "all-reduce", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "reduce_scatter_tensor_coalesced_":
    "reduce-scatter", "alltoall_": "all-to-all", "alltoall_base_":
    "all-to-all", "broadcast_": "broadcast", "send": "send", "recv_": "recv",
}

# Paper Table-2 instruction classes mapped to aten ops (``aten.<name>``,
# overload dropped) and the kernels' custom ops.
_CLASS = {
    "memory": {"copy_", "_to_copy", "clone", "contiguous", "slice",
               "select", "narrow", "cat", "stack", "constant_pad_nd",
               "empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "zeros", "zeros_like", "new_zeros",
               "ones", "ones_like", "new_ones", "full", "full_like",
               "fill_", "zero_", "arange", "expand", "repeat",
               "slice_scatter", "select_scatter", "split", "split_with_sizes",
               "chunk", "unbind", "lift_fresh", "alias", "detach",
               "_local_scalar_dense", "index_put_", "masked_fill",
               "masked_fill_", "copy"},
    "gather": {"index_select", "embedding", "embedding_dense_backward",
               "gather", "scatter", "scatter_", "scatter_add",
               "scatter_add_", "scatter_reduce", "index", "index_add",
               "index_add_", "index_copy", "index_copy_", "take",
               "onehot_gather", "onehot_gather_grad", "backproject",
               "backproject_strip"},
    "shuffle": {"view", "_unsafe_view", "reshape", "permute", "transpose",
                "t", "unsqueeze", "squeeze", "flip", "roll", "movedim",
                "as_strided", "view_as_real", "view_as_complex",
                "where", "unflatten", "flatten", "sort", "topk"},
    "arith": {"add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_",
              "mm", "bmm", "addmm", "matmul", "baddbmm", "einsum",
              "exp", "exp_", "exp2", "log", "log1p", "rsqrt", "sqrt",
              "maximum", "minimum", "max", "min", "amax", "amin", "clamp",
              "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
              "neg", "pow", "tanh", "sigmoid", "floor", "round", "abs",
              "bitwise_and", "bitwise_or", "bitwise_xor", "sum", "mean",
              "softmax", "_softmax", "_log_softmax", "log_softmax",
              "cumsum", "cos", "sin", "reciprocal", "silu", "gelu",
              "softplus", "rms_norm", "native_layer_norm", "var_mean",
              "convolution", "logsumexp", "sign", "erf", "lerp",
              "addcmul", "addcdiv", "logical_not", "logical_and",
              "logical_or", "argmax", "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention", "quantize_rows",
              "slstm", "slstm_train", "slstm_backward"},
}


def op_class(name: str) -> str:
    """The paper's class of op ``name`` (``aten.mm``, ``repro_torch.slstm``
    or a bare name; the overload is dropped)."""
    base = name.split(".")[1] if "." in name else name
    for cls, names in _CLASS.items():
        if base in names:
            return cls
    return "other"


def op_census(ops) -> dict:
    """Class every dispatched op paper-style (memory / shuffle / arith /
    gather / other).  ``ops``: op names, one per dispatch (an
    :class:`~repro_torch.analysis.trace.OpTrace`'s ``names()``), or a
    ``{name: count}`` mapping.  Counts *dispatches*: eager mode launches
    each one, as one x86 instruction retires."""
    counts = Counter(ops)
    census: Counter = Counter()
    for name, n in counts.items():
        census[op_class(name)] += n
    census["total"] = sum(counts.values())
    return {"classes": dict(census), "ops": dict(counts)}


def collective_bytes(records) -> dict:
    """Bytes moved per rank by collectives, from trace records (``(name,
    output bytes)`` of each ``c10d`` op).

    The reference's convention: per op the *output* bytes, doubled for
    all-reduce (ring = reduce-scatter + all-gather).  Returns ``{kind:
    bytes, ..., "total": bytes}``."""
    out: Counter = Counter()
    for name, nbytes in records:
        base = name.split(".")[1] if "." in name else name
        kind = COLLECTIVES.get(base)
        if kind is None:
            continue
        out[kind] += 2 * nbytes if kind == "all-reduce" else nbytes
    out["total"] = sum(out.values())
    return dict(out)


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_bytes_dev: float, *,
                   peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The three roofline terms, in seconds per step per rank: operations
    over ``peak_flops`` (the bf16 tensor-core rate, the models' compute
    type), bytes over the HBM rate, collective bytes over NVLink."""
    compute = flops_dev / peak_flops
    memory = bytes_dev / PEAK_BYTES_S
    collective = coll_bytes_dev / NVLINK_BYTES_S
    dominant = max((("compute", compute), ("memory", memory),
                    ("collective", collective)), key=lambda kv: kv[1])
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant[0],
            "bound_s": max(compute, memory, collective)}
