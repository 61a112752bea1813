"""Autotuner search space: candidate (strategy, option) points.

The counterpart of ``repro.tune.space``, with the reference's candidate
set and order: the five strategies with their window options and wires,
and the kernel configurations (``"pallas"`` candidates: the reference's
name, which here names the CUDA kernels of
:mod:`repro_torch.kernels.backproject_ops`), each crossed with the
``pbatch`` axis.  Where the reference screened a kernel candidate
against its VMEM budget, the port screens it against the card's shared
memory per block (:func:`kernel_smem_bytes`): the staged windows (K5:
its tiles' packed tap boxes) at the wire's itemsize and the ``P x 12``
matrices, the one byte model the launcher also enforces.  The CUDA
kernels build no one-hot temporaries, so none are counted.
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.backproject import GeomStatic
from ..kernels.backproject import (SMEM_LIMIT, WIRE_ITEMSIZE,
                                   strip_smem_bytes)

__all__ = ["Candidate", "WIRE_ITEMSIZE", "default_space", "jnp_candidates",
           "kernel_smem_bytes", "pallas_batch_fits_smem",
           "pallas_candidates"]

# pbatch depths proposed per candidate family (clamped to n_proj at
# sweep/run time; 1 = the per-projection nest).
_PBATCHES = (1, 4)


def pallas_batch_fits_smem(*, pbatch: int, ty: int, chunk: int, band: int,
                           width: int, depth: int = 2,
                           itemsize: int = 4) -> bool:
    """Does a kernel staging ``depth`` ``(band, width)`` windows at
    ``itemsize`` fit one block's shared memory, with ``pbatch`` matrices
    beside them?  (The candidate screen, also of K5 as the reference
    screened it: a ``pbatch``-deep slab, ``depth=pbatch``.)"""
    return strip_smem_bytes("db", pbatch, ty=ty, chunk=chunk, band=band,
                            width=width, itemsize=itemsize,
                            depth=depth) <= SMEM_LIMIT


def kernel_smem_bytes(gs: GeomStatic, cfg: dict,
                      slot: int | None = None) -> int:
    """Shared memory per block of the kernel a tuned config runs, at its
    clamped tile: 0 for row 1 (it stages only the matrices, which need no
    opt-in), the ring of K3/K4, or K5's box records and its two slots of
    ``slot`` 16-byte units: the launch's largest tile of packed boxes,
    which only the matrices tell
    (:func:`repro_torch.core.clipping.shared_box_slots`; the sweep
    sizes it so).  Without them, K5 counts its records alone: the screen
    refuses only a group whose records cannot fit a block."""
    from ..kernels.backproject_ops import clamp_tiles

    ty, chunk, band, width = clamp_tiles(
        gs, int(cfg.get("ty", 8)), int(cfg.get("chunk", 128)),
        int(cfg.get("band", 16)), int(cfg.get("width", 512)))
    pbatch = max(1, int(cfg.get("pbatch", 1)))
    itemsize = WIRE_ITEMSIZE[str(cfg.get("strip_dtype", "float32"))]
    if cfg.get("shared_window", False):
        return strip_smem_bytes("shared", pbatch, ty=ty, chunk=chunk,
                                band=band, width=width, itemsize=itemsize,
                                slot=slot or 0)
    if cfg.get("double_buffer", False):
        return strip_smem_bytes("db", pbatch, ty=ty, chunk=chunk, band=band,
                                width=width, itemsize=itemsize,
                                depth=int(cfg.get("db_depth", 2)))
    if cfg.get("micro", False):
        return strip_smem_bytes("micro", pbatch, ty=ty, chunk=chunk,
                                band=band, width=width, itemsize=itemsize,
                                group=int(cfg.get("micro_group", 8)))
    return 0


class Candidate(NamedTuple):
    """One sweep point: a strategy name plus its static options.

    ``strategy`` is one of :data:`repro_torch.core.backproject.STRATEGIES`
    or ``"pallas"`` (a kernel configuration); ``opts`` is a sorted
    ``(key, value)`` tuple so candidates are hashable and stable as
    cache-file keys.  ``opts`` may carry ``pbatch``.
    """

    strategy: str
    opts: tuple

    @classmethod
    def of(cls, strategy: str, **opts) -> "Candidate":
        return cls(strategy, tuple(sorted(opts.items())))

    @property
    def label(self) -> str:
        if not self.opts:
            return self.strategy
        txt = ",".join(f"{k}={v}" for k, v in self.opts)
        return f"{self.strategy}[{txt}]"

    @property
    def pbatch(self) -> int:
        return int(dict(self.opts).get("pbatch", 1))


def jnp_candidates(gs: GeomStatic,
                   pbatches: tuple[int, ...] = _PBATCHES
                   ) -> list[Candidate]:
    """Candidate grid for the five strategies, clamped to ``gs`` and
    crossed with the ``pbatch`` axis (the reference's grid)."""
    L = gs.L
    bases = [Candidate.of("scalar"), Candidate.of("gather")]
    for vb in (256, 512):
        bases.append(Candidate.of("onehot", vox_block=min(vb, L * L)))
    for chunk, band, width in ((32, 16, 128), (64, 16, 256)):
        bases.append(Candidate.of(
            "strip", chunk=min(chunk, L), band=min(band, gs.n_v + 2),
            width=min(width, gs.n_u + 2)))
    for group, gband, gwidth in ((8, 8, 64), (8, 8, 32), (16, 8, 128)):
        bases.append(Candidate.of(
            "strip2", group=min(group, L), gband=min(gband, gs.n_v + 2),
            gwidth=min(gwidth, gs.n_u + 2)))
    # The wire axis on the best strip window: bf16 and int8.
    for wire in ("bfloat16", "int8"):
        bases.append(Candidate.of(
            "strip2", group=min(8, L), gband=min(8, gs.n_v + 2),
            gwidth=min(64, gs.n_u + 2), strip_dtype=wire))
    cands = [Candidate.of(b.strategy, **dict(b.opts), pbatch=pb)
             for b in bases for pb in pbatches]
    # De-dup clamped collisions on tiny geometries.
    return list(dict.fromkeys(cands))


def pallas_candidates(gs: GeomStatic,
                      pbatches: tuple[int, ...] = _PBATCHES
                      ) -> list[Candidate]:
    """Kernel configurations at a geometry-clamped base tile: row 1 /
    K3 / K4 per projection, plus the batched kernels crossed ``pbatch x
    {row 1, K3 at depth 2, K4}`` at every depth that fits, the bf16 and
    int8 wires of row 1, K5 on each wire, and a 4-deep K3 ring at the
    deepest fitting ``pbatch`` (the reference's set and order).  Each
    variant names its full surface (``db_depth``, the micro window), so
    the values it is checked and timed at are the values that persist.
    """
    base = dict(ty=min(8, gs.L), chunk=min(32, gs.L), band=16, width=128)
    micro_win = dict(micro=True, micro_group=min(8, gs.L), micro_band=8,
                     micro_width=32)
    cands = [
        Candidate.of("pallas", **base),
        Candidate.of("pallas", double_buffer=True, **base),
        Candidate.of("pallas", **micro_win, **base),
    ]
    batched = [pb for pb in pbatches
               if pb > 1 and pallas_batch_fits_smem(pbatch=pb, **base)]
    for pb in batched:
        cands.append(Candidate.of("pallas", pbatch=pb, **base))
        cands.append(Candidate.of("pallas", pbatch=pb, double_buffer=True,
                                  db_depth=2, **base))
        cands.append(Candidate.of("pallas", pbatch=pb, **micro_win,
                                  **base))
        cands.append(Candidate.of("pallas", pbatch=pb,
                                  strip_dtype="bfloat16", **base))
        if pallas_batch_fits_smem(pbatch=pb, itemsize=1, **base):
            cands.append(Candidate.of("pallas", pbatch=pb,
                                      strip_dtype="int8", **base))
        # K5: the reference's screen, a slab of up to twice the base
        # strip, keeps its candidate set; the sweep then sizes K5's
        # window and box slots from the planner over every matrix.
        if pallas_batch_fits_smem(pbatch=pb, ty=base["ty"],
                                  chunk=base["chunk"],
                                  band=2 * base["band"],
                                  width=2 * base["width"], depth=pb):
            for wire in ("float32", "bfloat16", "int8"):
                extra = {} if wire == "float32" else {"strip_dtype": wire}
                cands.append(Candidate.of("pallas", pbatch=pb,
                                          shared_window=True, **extra,
                                          **base))
    if batched:
        pb = max(batched)
        if pallas_batch_fits_smem(pbatch=pb, depth=4, **base):
            cands.append(Candidate.of("pallas", pbatch=pb,
                                      double_buffer=True, db_depth=4,
                                      **base))
    return cands


def default_space(gs: GeomStatic,
                  include_pallas: bool = True) -> list[Candidate]:
    cands = jnp_candidates(gs)
    if include_pallas:
        cands += pallas_candidates(gs)
    return cands
