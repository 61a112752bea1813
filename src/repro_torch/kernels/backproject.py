"""The bound launchers of the CUDA back-projection kernels.

``csrc/backproject.cu`` replaces the TPU kernels
``repro/kernels/backproject.py::backproject_kernel_batch`` (a batch of
projections folded into a resident volume tile) and
``::backproject_kernel`` (the same for one projection, here a launch
with P = 1), and their int8/bf16 projection wire (``::_dequant_strip``).
:func:`launch_backproject` checks what the kernel takes, launches the
instance for the stack's wire on PyTorch's current stream and counts the
launch in :data:`LAUNCHES`.

``csrc/backproject_strip.cu`` holds the strip-staged kernels that
replace the TPU variants: K3 ``strip_db`` (``::backproject_kernel_batch_db``
and, at P = 1, ``::backproject_kernel_db``), K4 ``strip_micro``
(``::backproject_kernel_batch_micro`` and, at P = 1,
``::backproject_kernel_micro``) and K5 ``strip_shared``
(``::backproject_kernel_batch_shared``).  :func:`launch_strip` launches
one of them; :func:`strip_smem_bytes` is the shared-memory byte model
both it and the tuner's candidate screen use.  Each stages per tile and
projection the box of taps the tile reads: K3 and K4 in slots sized by
the launch's largest box (:func:`repro_torch.core.clipping.strip_box_slots`),
K5 a tile's boxes packed in one slot sized by the launch's largest
per-tile total (:func:`repro_torch.core.clipping.shared_box_slots`); a
box its slot had to cut is counted on the card (:func:`strip_clamped`).
The libraries are built at first use (:mod:`._build`).

Each launch goes through a custom op, ``torch.ops.repro_torch.backproject``
and ``torch.ops.repro_torch.backproject_strip`` (each updates the volume
in place), so that a dispatch mode
(:class:`repro_torch.analysis.trace.OpTrace`, the flop counter) sees it
and a fake tensor reaches the op's fake implementation, not the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _ops

__all__ = ["LAUNCHES", "MAX_PBATCH", "SMEM_LIMIT", "STRIP_KINDS",
           "WIRE_ITEMSIZE", "WIRE_LAUNCH_KEYS", "launch_backproject",
           "launch_strip", "pitch_stack", "reset_strip_clamped",
           "shared_slot_units", "strip_clamped", "strip_launch_key",
           "strip_smem_bytes", "window_units"]

# The LAUNCHES key suffix of each wire's instance.
_WIRE_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16",
                torch.int8: "_int8"}

# The strip kernels and their C ``kind`` codes.
STRIP_KINDS = {"db": 0, "micro": 1, "shared": 2}

# Launches of each CUDA kernel of the port, counted where the kernel is
# launched and nowhere else.  A caller sets a count to 0 before the run
# it wants to read.  The strip kernels count per wire, and K3/K4 launched
# with P = 1 (TPU kernel rows 7 and 8) under their own ``_p1`` keys.
LAUNCHES = {"backproject": 0, "backproject_bf16": 0, "backproject_int8": 0,
            "quantize_rows": 0, "onehot_gather": 0, "slstm": 0,
            "onehot_gather_backward": 0, "slstm_backward": 0}
LAUNCHES.update({f"strip_{k}{w}{p1}": 0 for k in STRIP_KINDS
                 for w in _WIRE_SUFFIX.values()
                 for p1 in ("", "_p1") if k != "shared" or not p1})

# The LAUNCHES key of the back-projection instance for each wire dtype.
WIRE_LAUNCH_KEYS = {w: "backproject" + s for w, s in _WIRE_SUFFIX.items()}

# Shared memory one block may opt in to on an H100 (227 KB).
SMEM_LIMIT = 232448

# Bytes per element of each projection wire (``strip_dtype``).
WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}

# The P x 12 matrices sit in the kernel's dynamic shared memory, which
# needs no opt-in up to 48 KB: 1024 projections per launch.
MAX_PBATCH = 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = [_I, _I, _I, _I, _I, _I, _F, _F, _P]   # P L nz z0 rows cols O MM s
_ENTRIES = {
    torch.float32: ("backproject_batch_launch", [_P, _P, _P] + _GEOM),
    torch.bfloat16: ("backproject_batch_bf16_launch", [_P, _P, _P] + _GEOM),
    torch.int8: ("backproject_batch_int8_launch", [_P, _P, _P, _P] + _GEOM),
}


def _lib(wire: torch.dtype):
    name, argtypes = _ENTRIES[wire]
    fn = getattr(_build.load("backproject"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch_backproject(volume: torch.Tensor, padded: torch.Tensor,
                       mats: torch.Tensor, *, z0: int, O: float,
                       MM: float, scales: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """``volume += Σ_p bilinear(padded[p]) / w_p²`` on the card, in place.

    ``volume``: ``(nz, L, L)`` float32, a z-slab starting at global plane
    ``z0``; ``padded``: ``(P, n_v + 2, n_u + 2)`` with the 1-pixel zero
    border, in the wire's dtype (float32, bfloat16, or int8 codes with
    ``scales`` ``(P, 2, n_v + 2)`` float32: scale, offset per row);
    ``mats``: ``(P, 3, 4)`` float32.  All contiguous, on one CUDA
    device.  Raises on anything else, and when the launch is refused.
    """
    wire = padded.dtype
    if wire not in _ENTRIES:
        raise TypeError(f"padded is {wire}; the kernel takes float32, "
                        f"bfloat16 or int8 projections")
    if (wire == torch.int8) != (scales is not None):
        raise ValueError("int8 codes need their (P, 2, rows) scales, and "
                         "only int8 codes take scales")
    operands = [("volume", volume, torch.float32),
                ("padded", padded, wire), ("mats", mats, torch.float32)]
    if scales is not None:
        operands.append(("scales", scales, torch.float32))
    for name, t, dtype in operands:
        if not t.is_cuda or t.device != volume.device:
            raise ValueError(
                f"{name} lies on {t.device}; the kernel needs every "
                f"operand on {volume.device} (a CUDA device)")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if volume.ndim != 3 or volume.shape[1] != volume.shape[2]:
        raise ValueError(f"volume must be (nz, L, L); got "
                         f"{tuple(volume.shape)}")
    P = int(padded.shape[0]) if padded.ndim == 3 else -1
    if padded.ndim != 3 or mats.shape != (P, 3, 4):
        raise ValueError(
            f"want padded (P, rows, cols) and mats (P, 3, 4); got "
            f"{tuple(padded.shape)} and {tuple(mats.shape)}")
    if not 1 <= P <= MAX_PBATCH:
        raise ValueError(f"P={P} projections per launch; the kernel takes "
                         f"1..{MAX_PBATCH}")
    nz, L = int(volume.shape[0]), int(volume.shape[1])
    rows, cols = int(padded.shape[1]), int(padded.shape[2])
    if scales is not None and scales.shape != (P, 2, rows):
        raise ValueError(f"scales must be (P, 2, rows) = {(P, 2, rows)}; "
                         f"got {tuple(scales.shape)}")
    if (rows + 3) * (cols + 3) >= 2**31 or max(rows, cols) >= 2**21:
        raise ValueError(f"a ({rows}, {cols}) image is too large: the "
                         f"kernel indexes a projection with 32-bit offsets "
                         f"and floors tap coordinates below 2^22")
    if nz == 0:
        return volume
    torch.ops.repro_torch.backproject(volume, padded, mats, scales, int(z0),
                                      float(O), float(MM))
    return volume


def _backproject_op(volume: torch.Tensor, padded: torch.Tensor,
                    mats: torch.Tensor, scales: torch.Tensor | None, z0: int,
                    O: float, MM: float) -> None:
    """Row 1's launch (operands checked by :func:`launch_backproject`)."""
    wire = padded.dtype
    P, rows, cols = (int(n) for n in padded.shape)
    nz, L = int(volume.shape[0]), int(volume.shape[1])
    head = [volume.data_ptr(), padded.data_ptr()]
    if scales is not None:
        head.append(scales.data_ptr())
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    with torch.cuda.device(volume.device):
        rc = _lib(wire)(*head, mats.data_ptr(), P, L, nz, z0, rows, cols, O,
                        MM, stream)
    if rc != 0:
        raise RuntimeError(f"backproject kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[WIRE_LAUNCH_KEYS[wire]] += 1


_ops.define("backproject(Tensor(a!) volume, Tensor padded, Tensor mats, "
            "Tensor? scales, int z0, float O, float MM) -> ()",
            _backproject_op, lambda *args: None)


def strip_launch_key(kind: str, wire: torch.dtype, P: int) -> str:
    """The :data:`LAUNCHES` key of strip kernel ``kind`` on ``wire`` with
    ``P`` projections per launch."""
    p1 = "_p1" if P == 1 and kind != "shared" else ""
    return f"strip_{kind}{_WIRE_SUFFIX[wire]}{p1}"


def window_units(width: int, itemsize: int) -> int:
    """The most 16-byte units a row of a ``width``-element window spans,
    wherever it starts: the largest row a K3/K4 slot can need."""
    return (width * itemsize + 15) // 16 + 1


# Bytes of one K3/K4 item record (window origin and box), and of one K5
# box record (box and offset in its slot), in shared memory.
_ITEM_BYTES = 32
_BOX_BYTES = 32
# K5 plans a tile two ahead of its fold: three sets of P box records,
# and a ring of two slots.
_SHARED_SETS, _SHARED_SLOTS = 3, 2


def shared_slot_units(P: int, band: int, width: int, itemsize: int) -> int:
    """The most 16-byte units a K5 slot can need: ``P`` boxes, each at
    most its ``(band, width)`` window (:func:`window_units` a row)."""
    return P * band * window_units(width, itemsize)


def strip_smem_bytes(kind: str, P: int, *, ty: int, chunk: int, band: int,
                     width: int, itemsize: int, depth: int = 2,
                     group: int = 8, slot=None) -> int:
    """Dynamic shared memory of one block of strip kernel ``kind``: the
    ``P x 12`` matrices, then the rings of K3 (``depth`` slots) and K4
    (2): per slot an item record and ``slot = (rows, units)`` 16-byte
    units, and K4's reduction scratch where a micro group does not divide
    a warp; or K5's three sets of ``P`` box records and two slots of
    ``slot`` 16-byte units each (an int: a tile's packed boxes).
    ``slot=None`` takes the window's worst case, which no box exceeds
    (K3/K4 ``(band, window_units(width, itemsize))``, K5
    :func:`shared_slot_units`).  The int8 scale block is read from
    device memory, not staged.  The launcher refuses a configuration
    above :data:`SMEM_LIMIT`."""
    n = (P * 48 + 15) // 16 * 16
    if kind == "shared":
        units = shared_slot_units(P, band, width, itemsize) if slot is None \
            else int(slot)
        return n + _SHARED_SETS * P * _BOX_BYTES + _SHARED_SLOTS * units * 16
    rows, units = (band, window_units(width, itemsize)) if slot is None \
        else slot
    n += {"db": depth, "micro": 2}[kind] * (_ITEM_BYTES + rows * units * 16)
    if kind == "micro" and 32 % group:
        n += 2 * ty * chunk * 4
    return n


def pitch_stack(stack: torch.Tensor) -> torch.Tensor:
    """``stack`` (``(P, rows, cols)`` on the wire) with each row padded
    with zeros to whole 16-byte units, as the strip kernels take it (a
    stack already so returned as it is)."""
    per = 16 // stack.element_size()
    cols = int(stack.shape[-1])
    pitch = -(-cols // per) * per
    if pitch == cols:
        return stack.contiguous()
    out = stack.new_zeros(stack.shape[:-1] + (pitch,))
    out[..., :cols] = stack
    return out


# One int32 per device: the boxes a strip kernel's slot cut.
_CLAMPED: dict = {}


def _clamp_counter(device: torch.device) -> torch.Tensor:
    c = _CLAMPED.get(device)
    if c is None:
        c = _CLAMPED[device] = torch.zeros(1, dtype=torch.int32,
                                           device=device)
    return c


def strip_clamped(device) -> int:
    """The boxes on ``device`` that a strip kernel's slot had to cut since
    the last :func:`reset_strip_clamped` (it synchronises).  The slots
    are sized by the largest box (K5: the largest tile's boxes), so the
    count stays 0; a cut box drops taps."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = _CLAMPED.get(device)
    return 0 if c is None else int(c.item())


def reset_strip_clamped() -> None:
    """Set every device's clamp count to 0."""
    for c in _CLAMPED.values():
        c.zero_()


_STRIP_ARGTYPES = ([_I, _I, _P, _P, _P, _P] + [_I] * 9 + [_F, _F]
                   + [_I] * 12 + [_P, _P])


_STRIP_ENTRY = "backproject_strip_launch"


def _strip_lib():
    fn = getattr(_build.load("backproject_strip"), _STRIP_ENTRY)
    if fn.argtypes is None:
        fn.argtypes = _STRIP_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_strip(volume: torch.Tensor, stack: torch.Tensor,
                 mats: torch.Tensor, *, kind: str, z0: int, O: float,
                 MM: float, n_u: int, n_v: int, ty: int, chunk: int,
                 band: int, width: int, pad_rows: int, pad_cols: int,
                 depth: int = 2, group: int = 8, gband: int = 8,
                 gwidth: int = 32, scales: torch.Tensor | None = None,
                 slot=None) -> torch.Tensor:
    """``volume += Σ_p bilinear(stack[p]) / w_p²`` through strip kernel
    ``kind`` (``"db"``, ``"micro"`` or ``"shared"``) on the card, in
    place.

    ``volume``: ``(nz, L, L)`` float32 from global plane ``z0``;
    ``stack``: ``(P, n_v + 2, pitch)`` bordered images on the wire
    (float32, bfloat16, or int8 codes with ``scales`` ``(P, 2, n_v +
    2)``), each row zero-padded to whole 16-byte units
    (:func:`pitch_stack`); ``mats``: ``(P, 3, 4)`` float32.  The
    tile ``(ty, chunk)`` divides ``L`` and has at most 1024 voxels; the
    window ``(band, width)`` is clamped into the ``(pad_rows,
    pad_cols)`` image
    (:func:`repro_torch.kernels.backproject_ref.padded_dims`); K3 rings
    ``depth`` (2..8) slots; K4's ``group`` divides ``chunk``, its window
    ``(gband, gwidth)`` lies in the strip.  ``slot``: K3's and K4's
    ``(rows, units)`` per slot, at least the launch's largest box
    (:func:`repro_torch.core.clipping.strip_box_slots`, max over its
    matrices) and at most the window's; K5's 16-byte units per slot (an
    int), at least the launch's largest per-tile total
    (:func:`repro_torch.core.clipping.shared_box_slots`) and at most
    :func:`shared_slot_units`; ``None`` takes the most.  A box its slot
    cuts is counted (:func:`strip_clamped`).  The caller has checked the
    windows against the planner.  Raises on anything else, and when the
    launch is refused.
    """
    if kind not in STRIP_KINDS:
        raise ValueError(f"unknown strip kernel {kind!r}; want one of "
                         f"{tuple(STRIP_KINDS)}")
    wire = stack.dtype
    if wire not in _ENTRIES:
        raise TypeError(f"stack is {wire}; the kernels take float32, "
                        f"bfloat16 or int8 projections")
    if (wire == torch.int8) != (scales is not None):
        raise ValueError("int8 codes need their (P, 2, rows) scales, and "
                         "only int8 codes take scales")
    operands = [("volume", volume, torch.float32), ("stack", stack, wire),
                ("mats", mats, torch.float32)]
    if scales is not None:
        operands.append(("scales", scales, torch.float32))
    for name, t, dtype in operands:
        if not t.is_cuda or t.device != volume.device:
            raise ValueError(
                f"{name} lies on {t.device}; the kernel needs every "
                f"operand on {volume.device} (a CUDA device)")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if volume.ndim != 3 or volume.shape[1] != volume.shape[2]:
        raise ValueError(f"volume must be (nz, L, L); got "
                         f"{tuple(volume.shape)}")
    nz, L = int(volume.shape[0]), int(volume.shape[1])
    P = int(stack.shape[0]) if stack.ndim == 3 else -1
    rows, cols = n_v + 2, n_u + 2
    isz = stack.element_size()
    if (stack.ndim != 3 or stack.shape[1] != rows or stack.shape[2] < cols
            or (stack.shape[2] * isz) % 16):
        raise ValueError(
            f"stack must be (P, {rows}, pitch) with pitch >= {cols}, "
            f"16-byte aligned with whole 16-byte rows (pitch_stack); got "
            f"{tuple(stack.shape)}")
    if mats.shape != (P, 3, 4) or not 1 <= P <= MAX_PBATCH:
        raise ValueError(f"want mats (P, 3, 4) with 1 <= P <= "
                         f"{MAX_PBATCH}; got {tuple(mats.shape)}")
    if scales is not None and scales.shape != (P, 2, rows):
        raise ValueError(f"scales must be (P, 2, rows) = {(P, 2, rows)}; "
                         f"got {tuple(scales.shape)}")
    if L % ty or L % chunk or ty * chunk > 1024:
        raise ValueError(f"tile (ty={ty}, chunk={chunk}) must divide "
                         f"L={L} and hold at most 1024 voxels")
    if not (1 <= band <= pad_rows and 1 <= width <= pad_cols):
        raise ValueError(f"window (band={band}, width={width}) must fit "
                         f"the ({pad_rows}, {pad_cols}) padded image")
    if kind == "db" and not 2 <= depth <= 8:
        raise ValueError(f"db_depth={depth}: the ring takes 2..8 slots")
    if kind == "micro" and (chunk % group or not 1 <= gband <= band
                            or not 1 <= gwidth <= width):
        raise ValueError(
            f"micro window (group={group}, gband={gband}, gwidth="
            f"{gwidth}) needs group | chunk={chunk} and a window inside "
            f"the ({band}, {width}) strip")
    if kind == "shared":
        most = shared_slot_units(P, band, width, isz)
        slot = most if slot is None else int(slot)
        if not 0 <= slot <= most:
            raise ValueError(f"slot of {slot} 16-byte units must lie "
                             f"within the {P} windows' {most}")
        slot_dims = (1, slot)
    else:
        most = (band, window_units(width, isz))
        slot = slot_dims = most if slot is None else (int(slot[0]),
                                                      int(slot[1]))
        if not (0 <= slot[0] <= most[0] and 0 <= slot[1] <= most[1]):
            raise ValueError(f"slot {slot} (rows, 16-byte units) must lie "
                             f"within the window's {most}")
    smem = strip_smem_bytes(kind, P, ty=ty, chunk=chunk, band=band,
                            width=width, itemsize=isz, depth=depth,
                            group=group, slot=slot)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"strip_{kind} needs {smem} B of shared memory per block "
            f"(P={P}, band={band}, width={width}, {wire}); the card "
            f"offers {SMEM_LIMIT} B")
    if nz == 0:
        return volume
    torch.ops.repro_torch.backproject_strip(
        volume, stack, mats, scales, STRIP_KINDS[kind], int(z0), float(O),
        float(MM), n_u, n_v, ty, chunk, band, width, pad_rows, pad_cols,
        depth, group, gband, gwidth, *slot_dims)
    return volume


def _strip_op(volume: torch.Tensor, stack: torch.Tensor, mats: torch.Tensor,
              scales: torch.Tensor | None, kind: int, z0: int, O: float,
              MM: float, n_u: int, n_v: int, ty: int, chunk: int, band: int,
              width: int, pad_rows: int, pad_cols: int, depth: int,
              group: int, gband: int, gwidth: int, slot_rows: int,
              slot_units: int) -> None:
    """A strip kernel's launch (operands checked by :func:`launch_strip`);
    a box its slot cuts is counted in the device's clamp counter."""
    if stack.data_ptr() % 16:
        raise ValueError("stack must be 16-byte aligned (pitch_stack)")
    isz = stack.element_size()
    nz, L = int(volume.shape[0]), int(volume.shape[1])
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    with torch.cuda.device(volume.device):
        rc = _strip_lib()(
            kind, isz, volume.data_ptr(), stack.data_ptr(),
            None if scales is None else scales.data_ptr(), mats.data_ptr(),
            int(stack.shape[0]), L, nz, z0, n_v + 2, n_u + 2,
            (int(stack.shape[2]) * isz) // 4, n_u, n_v, O, MM, ty, chunk,
            band, width, pad_rows, pad_cols, depth, group, gband, gwidth,
            slot_rows, slot_units, _clamp_counter(volume.device).data_ptr(),
            stream)
    name = next(k for k, v in STRIP_KINDS.items() if v == kind)
    if rc != 0:
        raise RuntimeError(f"strip_{name} kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[strip_launch_key(name, stack.dtype, int(stack.shape[0]))] += 1


_ops.define("backproject_strip(Tensor(a!) volume, Tensor stack, Tensor mats, "
            "Tensor? scales, int kind, int z0, float O, float MM, int n_u, "
            "int n_v, int ty, int chunk, int band, int width, int pad_rows, "
            "int pad_cols, int depth, int group, int gband, int gwidth, "
            "int slot_rows, int slot_units) -> ()", _strip_op,
            lambda *args: None)
