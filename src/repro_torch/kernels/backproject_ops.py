"""Public wrapper of the back-projection kernels.

The counterparts of ``repro.kernels.backproject_ops.pallas_backproject_
batch`` / ``pallas_backproject_one``.  On a CUDA volume the wrapper pads
the projection stack once with the 1-pixel zero border the zero-outside
rule relies on, puts it on the wire (``strip_dtype``: float32 as it is,
a bfloat16 cast, or int8 codes from one launch of the row quantiser for
the whole stack, as the reference encodes once per call) and launches a
kernel once per ``pbatch`` projections; it never falls back.  On a CPU
volume, and only there, it runs the kernel's plain version
(:mod:`.backproject_ref`) on the same wire.

The reference's tiling keywords have their Hopper meaning:

* ``ty``, ``chunk``: the ``(ty, chunk)`` voxel tile of one z-plane a
  block owns (one thread per voxel);
* ``band``, ``width``: the strip a block stages per tile and projection;
* ``double_buffer``, ``db_depth``: K3 ``strip_db``, a ``db_depth``-slot
  ring of strips prefetched across tiles (TPU kernel rows 4 and 7);
* ``micro``, ``micro_group``, ``micro_band``, ``micro_width``: K4
  ``strip_micro``, a ``(micro_band, micro_width)`` window per run of
  ``micro_group`` x-voxels inside the strip (rows 5 and 8);
* ``shared_window``, ``shared_band``, ``shared_width``: K5
  ``strip_shared``, one window per tile shared by the projection group,
  sized by the planner unless pinned (row 6).

The variants are exclusive.  With no variant flag, row 1 runs
(``csrc/backproject.cu``): it reads every tap straight from the
bordered image, so a tiling keyword changes nothing there; the keywords
given are still checked as the reference checks them.  A staged window
drops the taps outside it, so every variant's windows are checked
against the strip planner (:mod:`repro_torch.core.clipping`, on the
volume's device) before it runs: an undersized window raises with the
sizes it needs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import as_f32
from ..core.backproject import (DEFAULT_PBATCH, GeomStatic, _stream_batches,
                                strip_wire_dtype)
from ..core.clipping import (_round8, _round128, shared_box_slots,
                             shared_window_cover, strip_box_slots,
                             strip_needs)
from ..core.geometry import Geometry
from .backproject import (WIRE_ITEMSIZE, launch_backproject, launch_strip,
                          pitch_stack)
from .backproject_ref import (backproject_batch_ref, backproject_micro_ref,
                              backproject_shared_ref, backproject_strip_ref,
                              padded_dims, wire_values)
from .quant import launch_quantize_rows

__all__ = ["backproject_batch", "backproject_one", "check_variant_windows",
           "clamp_tiles", "resolve_variant", "shared_window_dims",
           "validate_strip_config"]

# The reference's defaults of the tiling keywords.
_TILE_DEFAULTS = {"ty": 8, "chunk": 128, "band": 16, "width": 512}


def clamp_tiles(gs: GeomStatic, ty: int, chunk: int, band: int,
                width: int) -> tuple[int, int, int, int]:
    """Geometry-clamp the tile parameters, as the reference does.

    The single definition the wrapper and the tuner's candidate
    validation go through, so a config validated by the sweep is
    exactly the config the kernel runs.
    """
    ty = min(ty, gs.L)
    chunk = min(chunk, gs.L)
    band = min(band, max(8, gs.n_v + 2 + (-(gs.n_v + 2)) % 8))
    width = min(width, max(128, gs.n_u + 2 + (-(gs.n_u + 2)) % 128))
    return ty, chunk, band, width


def validate_strip_config(geom: Geometry, A, *, ty: int, chunk: int,
                          band: int, width: int, micro: bool = False,
                          micro_group: int = 8, micro_band: int = 8,
                          micro_width: int = 32, device=None) -> None:
    """Check that ``(band, width)`` covers every tile footprint of the
    matrix ``A`` (``(3, 4)``, or a ``(n, 3, 4)`` stack checked matrix by
    matrix).

    A tile spans ``ty`` lines x ``chunk`` voxels; per-line strip needs
    are exact from the planner (monotone-beam property), and adjacent
    lines' strips merge by their origins' scatter.  Raises with the
    required sizes of the first matrix that does not fit, in the
    reference's words.  With ``micro=True`` the per-group ``(micro_band,
    micro_width)`` window is checked too, against the planner run with
    ``chunk=micro_group``; its requirement saturates at the strip.  The
    planner runs on ``device`` (default: where the matrices lie) and
    memoises each matrix's needs.
    """
    needs = strip_needs(geom, A, chunk=chunk, ty=ty, device=device)
    gneeds = None
    for i, (need_band, need_width) in enumerate(needs):
        if band < need_band or width < need_width:
            raise ValueError(
                f"strip config (band={band}, width={width}) does not cover "
                f"the tile footprint; need at least (band={need_band}, "
                f"width={need_width}) for ty={ty}, chunk={chunk}")
        if not micro:
            continue
        if chunk % micro_group:
            raise ValueError(
                f"micro_group={micro_group} must divide chunk={chunk}")
        if gneeds is None:
            gneeds = strip_needs(geom, A, chunk=micro_group, device=device)
        need_gb = min(int(gneeds[i, 0]), band)
        need_gw = min(int(gneeds[i, 1]), width)
        if micro_band < need_gb or micro_width < need_gw:
            raise ValueError(
                f"micro window (micro_band={micro_band}, "
                f"micro_width={micro_width}) does not cover the "
                f"{micro_group}-voxel group tap footprint; need at least "
                f"(micro_band={need_gb}, micro_width={need_gw}) — "
                f"undersized micro windows drop taps silently")


def shared_window_dims(geom: Geometry, mats, *, ty: int, chunk: int,
                       pbatch: int, shared_band: int | None = None,
                       shared_width: int | None = None, device=None
                       ) -> tuple[int, int]:
    """Size (and check) the shared superset window for a projection set.

    Returns the ``(band, width)`` the shared-window kernel must run
    with: the window K5's own rule needs to hold every tap of the group
    (:func:`repro_torch.core.clipping.shared_window_cover`), saturated at
    the bordered detector (where a window cannot lose a tap), rounded up
    when auto-sized.  Explicit dims smaller than the requirement raise,
    in the reference's words.  (The reference sizes the window by
    :func:`repro_torch.core.clipping.shared_window_requirement`, which
    merges the members' clamped planner origins, the inactive chunks'
    too: it can be too small, and then drops taps, or many times too
    large, ROADMAP Queue 3.)
    """
    gs = GeomStatic.of(geom)
    need = shared_window_cover(geom, mats, ty=ty, chunk=chunk,
                               pbatch=pbatch, device=device)
    need_band = min(need[0], gs.n_v + 2)
    need_width = min(need[1], gs.n_u + 2)
    band = _round8(need_band) if shared_band is None else int(shared_band)
    width = (_round128(need_width) if shared_width is None
             else int(shared_width))
    if band < need_band or width < need_width:
        raise ValueError(
            f"shared window (shared_band={band}, shared_width={width}) "
            f"does not cover the projection group's superset footprint; "
            f"need at least (shared_band={need_band}, "
            f"shared_width={need_width}) for ty={ty}, chunk={chunk}, "
            f"pbatch={pbatch} — undersized windows drop taps silently")
    return band, width


def resolve_variant(gs: GeomStatic, *, ty=None, chunk=None, band=None,
                    width=None, double_buffer=False, db_depth=2,
                    micro=False, micro_group=8, micro_band=8,
                    micro_width=32, shared_window=False, **_) -> dict:
    """The variant and the clamped tile of a keyword set: raises on
    exclusive flags and on a ring depth the kernel does not take.
    ``variant`` is ``"db"``, ``"micro"``, ``"shared"`` or ``None`` (row
    1); ``tiled`` says whether any tiling keyword was given."""
    if (micro and double_buffer
            or shared_window and (micro or double_buffer)):
        raise ValueError(
            f"batch kernel variants are exclusive: got micro={micro}, "
            f"double_buffer={double_buffer}, shared_window="
            f"{shared_window}; a tuned decision names exactly one")
    if double_buffer and int(db_depth) < 2:
        raise ValueError(
            f"db_depth={db_depth}: the pipelined batch kernel needs an "
            f"in-flight slot rotation of at least 2")
    if double_buffer and int(db_depth) > 8:
        raise ValueError(f"db_depth={db_depth}: the CUDA ring takes at "
                         f"most 8 slots")
    given = {"ty": ty, "chunk": chunk, "band": band, "width": width}
    tile = clamp_tiles(gs, *(int(_TILE_DEFAULTS[k] if v is None else v)
                             for k, v in given.items()))
    variant = ("shared" if shared_window else "db" if double_buffer
               else "micro" if micro else None)
    return {"variant": variant, "ty": tile[0], "chunk": tile[1],
            "band": tile[2], "width": tile[3], "db_depth": int(db_depth),
            "micro_group": int(micro_group),
            "micro_band": min(int(micro_band), tile[2]),
            "micro_width": min(int(micro_width), tile[3]),
            "tiled": any(v is not None for v in given.values())}


def check_variant_windows(geom: Geometry, mats, opts: dict,
                          device=None) -> None:
    """The window check a fold through the kernel config ``opts`` (the
    tuned kernel keywords) needs before it runs: the strip (and micro)
    windows of K3/K4, and the tiling keywords given to row 1, against
    every matrix of ``mats``.  K5 sizes its window per projection group
    at each call, so it needs no check here."""
    v = resolve_variant(GeomStatic.of(geom), **opts)
    if v["variant"] == "shared" or (v["variant"] is None
                                    and not v["tiled"]):
        return
    validate_strip_config(
        geom, mats, ty=v["ty"], chunk=v["chunk"], band=v["band"],
        width=v["width"], micro=v["variant"] == "micro",
        micro_group=v["micro_group"], micro_band=v["micro_band"],
        micro_width=v["micro_width"], device=device)


def _operands(volume, images, mats, gs: GeomStatic):
    if not torch.is_tensor(volume) or volume.dtype != torch.float32:
        raise TypeError("volume must be a float32 tensor (updated in place)")
    if volume.ndim != 3 or tuple(volume.shape[1:]) != (gs.L, gs.L):
        raise ValueError(f"volume must be (nz, {gs.L}, {gs.L}); got "
                         f"{tuple(volume.shape)}")
    if not torch.is_tensor(images) or images.dtype != torch.float32:
        raise TypeError("images must be a float32 tensor")
    if images.ndim != 3 or tuple(images.shape[1:]) != (gs.n_v, gs.n_u):
        raise ValueError(f"images must be (P, {gs.n_v}, {gs.n_u}); got "
                         f"{tuple(images.shape)}")
    if images.device != volume.device:
        raise ValueError(f"images lie on {images.device}, volume on "
                         f"{volume.device}")
    mats = as_f32(mats, volume.device).reshape(-1, 3, 4).contiguous()
    if mats.shape[0] != images.shape[0]:
        raise ValueError(f"{images.shape[0]} images but {mats.shape[0]} "
                         f"matrices")
    return mats


def _on_wire(images, wire):
    """The zero-bordered CUDA stack on the wire: a tensor (float32,
    bfloat16) or the int8 ``(codes, scales)`` pair from one encoder
    launch."""
    padded = F.pad(images, (1, 1, 1, 1)).contiguous()
    if wire is None:
        return padded
    if wire is torch.bfloat16:
        return padded.to(torch.bfloat16)
    return launch_quantize_rows(padded)


def _split(stack):
    return stack if isinstance(stack, tuple) else (stack, None)


def _tuned(geom, opts: dict) -> dict:
    """``strategy="auto"``: the process dispatcher's kernel config for
    this key overrides every keyword it names."""
    from ..dispatch import get_dispatcher

    tuned = get_dispatcher().resolve_kernel(geom)
    if tuned is not None:
        opts.update(tuned)
    return opts


def backproject_batch(volume, images, mats, geom: Geometry | GeomStatic, *,
                      pbatch: int = DEFAULT_PBATCH, z0: int = 0,
                      strip_dtype: str = "float32", ty: int | None = None,
                      chunk: int | None = None, band: int | None = None,
                      width: int | None = None, double_buffer: bool = False,
                      db_depth: int = 2, micro: bool = False,
                      micro_group: int = 8, micro_band: int = 8,
                      micro_width: int = 32, shared_window: bool = False,
                      shared_band: int | None = None,
                      shared_width: int | None = None, validate: bool = True,
                      strategy: str = "fixed"):
    """Add a stack of projections to ``volume`` in place, ``pbatch`` per
    kernel launch; returns ``volume``.

    ``volume``: ``(nz, L, L)`` float32, a z-slab starting at global
    plane ``z0`` (the whole volume at ``z0=0``); ``images``: unpadded
    ``(n_proj, n_v, n_u)`` float32 on the volume's device; ``mats``:
    ``(n_proj, 3, 4)``; ``strip_dtype``: the projection wire,
    ``"float32"``, ``"bfloat16"`` or ``"int8"``.  A ``pbatch ∤ n_proj``
    remainder runs as one final smaller launch.

    The tiling keywords pick and shape the kernel (module docstring).
    ``validate=True`` checks the strip and micro windows of K3/K4 (and
    the tiling keywords given to row 1) against the planner first,
    memoised per matrix; pass ``False`` only where the same geometry,
    matrices and tile were checked before.  K5 sizes its window per
    projection group at every call, whatever ``validate`` says: it is
    the variant's guard, not an option.  Checking and sizing need the
    full :class:`Geometry`.  ``strategy="auto"`` takes every keyword the
    process dispatcher's tuned kernel config names
    (:mod:`repro_torch.dispatch`); ``"fixed"`` runs the keywords as
    given.
    """
    opts = dict(pbatch=pbatch, strip_dtype=strip_dtype, ty=ty, chunk=chunk,
                band=band, width=width, double_buffer=double_buffer,
                db_depth=db_depth, micro=micro, micro_group=micro_group,
                micro_band=micro_band, micro_width=micro_width,
                shared_window=shared_window, shared_band=shared_band,
                shared_width=shared_width)
    if strategy == "auto":
        opts = _tuned(geom, opts)
    elif strategy != "fixed":
        raise ValueError(
            f"unknown strategy {strategy!r}; want 'fixed' or 'auto'")
    gs = geom if isinstance(geom, GeomStatic) else GeomStatic.of(geom)
    v = resolve_variant(gs, **opts)
    strip_dtype = str(opts["strip_dtype"])
    wire = strip_wire_dtype(strip_dtype)
    mats = _operands(volume, images, mats, gs)
    n_proj = int(images.shape[0])
    pbatch = max(1, min(int(opts["pbatch"]), n_proj)) if n_proj else 1
    kind, band, width = v["variant"], v["band"], v["width"]
    if (kind is not None or v["tiled"]) and (validate or kind == "shared") \
            and isinstance(geom, GeomStatic):
        raise ValueError(
            "checking or sizing a kernel's windows needs the full "
            "Geometry (pass validate=False where they were checked)")
    if kind == "shared":
        band, width = shared_window_dims(
            geom, mats, ty=v["ty"], chunk=v["chunk"], pbatch=pbatch,
            shared_band=opts["shared_band"],
            shared_width=opts["shared_width"], device=volume.device)
        _, _, band, width = clamp_tiles(gs, v["ty"], v["chunk"], band,
                                        width)
    elif validate and (kind is not None or v["tiled"]):
        check_variant_windows(geom, mats, opts, device=volume.device)

    if kind is None:
        return _row1(volume, images, mats, gs, pbatch, z0, wire,
                     strip_dtype)
    pad_rows, pad_cols = padded_dims(gs, band, width,
                                     WIRE_ITEMSIZE[strip_dtype])
    win = dict(ty=v["ty"], chunk=v["chunk"], band=band, width=width,
               pad_rows=pad_rows, pad_cols=pad_cols)
    if kind == "micro":
        micro_win = dict(group=v["micro_group"], gband=v["micro_band"],
                         gwidth=v["micro_width"])
    if volume.is_cuda:
        extra = {"depth": v["db_depth"]} if kind == "db" else \
            micro_win if kind == "micro" else {}
        codes, scales = _split(_on_wire(images, wire))
        stack = pitch_stack(codes) if scales is None \
            else (pitch_stack(codes), scales)
        # Every launch sizes its slots from its own matrices: K3/K4 by
        # each matrix's largest tap box, K5 by its group's largest tile.
        isz = WIRE_ITEMSIZE[strip_dtype]
        if kind == "shared":
            per_group = shared_box_slots(gs, mats, itemsize=isz,
                                         pbatch=pbatch, **win)
            slots = torch.from_numpy(per_group.repeat(pbatch)[:len(mats)])
        else:
            slots = torch.from_numpy(strip_box_slots(gs, mats, itemsize=isz,
                                                     **win))

        def launch(vol, part, ms):
            sl, st = part
            c, s = _split(st)
            slot = int(sl.max()) if kind == "shared" else \
                tuple(int(n) for n in sl.amax(dim=0))
            return launch_strip(
                vol, c.contiguous(), ms.contiguous(), kind=kind, z0=z0,
                O=gs.O, MM=gs.MM, n_u=gs.n_u, n_v=gs.n_v,
                scales=None if s is None else s.contiguous(), slot=slot,
                **win, **extra)

        return _stream_batches((slots, stack), mats, volume, pbatch, launch)
    _cpu_only(volume)
    plain = {"db": backproject_strip_ref, "micro": backproject_micro_ref,
             "shared": backproject_shared_ref}[kind]
    if kind == "micro":
        win.update(micro_win)
    values = wire_values(F.pad(images, (1, 1, 1, 1)), strip_dtype)
    return _stream_batches(
        values, mats, volume, pbatch,
        lambda vol, vals, ms: plain(vol, vals, ms, gs, z0=z0, **win))


def _cpu_only(volume):
    if volume.device.type != "cpu":
        raise ValueError(f"no back projection for device {volume.device}")


def _row1(volume, images, mats, gs, pbatch, z0, wire, strip_dtype):
    """Row 1: taps read straight from the bordered image."""
    if volume.is_cuda:
        def launch(vol, stack, ms):
            codes, scales = _split(stack)
            return launch_backproject(
                vol, codes.contiguous(), ms.contiguous(), z0=z0, O=gs.O,
                MM=gs.MM,
                scales=None if scales is None else scales.contiguous())

        return _stream_batches(_on_wire(images, wire), mats, volume, pbatch,
                               launch)
    _cpu_only(volume)
    return _stream_batches(
        images, mats, volume, pbatch,
        lambda vol, imgs, ms: backproject_batch_ref(
            vol, imgs, ms, gs, z0=z0, wire=strip_dtype))


def backproject_one(volume, image, A, geom: Geometry | GeomStatic, *,
                    z0: int = 0, strip_dtype: str = "float32",
                    strategy: str = "fixed", **tile_opts):
    """Add one ``(n_v, n_u)`` projection with its ``(3, 4)`` matrix to
    ``volume`` in place: the batch kernels launched with P = 1 (K3 and
    K4 at P = 1 are TPU kernel rows 7 and 8).  ``strategy="auto"`` takes
    the tuned kernel config but not its ``pbatch``: one projection has
    nothing to batch."""
    if not torch.is_tensor(image) or image.ndim != 2:
        raise ValueError("image must be one (n_v, n_u) tensor")
    if strategy == "auto":
        tile_opts = _tuned(geom, dict(tile_opts, strip_dtype=strip_dtype))
        strip_dtype = tile_opts.pop("strip_dtype")
        strategy = "fixed"
    tile_opts.pop("pbatch", None)
    return backproject_batch(volume, image[None], A, geom, pbatch=1, z0=z0,
                             strip_dtype=strip_dtype, strategy=strategy,
                             **tile_opts)
