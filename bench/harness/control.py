"""The control of a configuration's comparison: what the configuration's
precision one step lower reads, so that the limits are shown to fail it.

The limits file names it.  ``{"config": {...}}``: the program itself
with a lower-precision path of its own switched on (merged into the
configuration), run as a cell is run.  ``{"reference_wire": "int4"}``:
the reference on that wire put in the program's place, its volumes
compared as the program's are; it needs no window.
"""

from __future__ import annotations

import torch

from ..reference.backproject import voxel_coords
from ..reference.geometry import Scan
from ..reference.phantom import densities
from . import cell, check, registry
from .inputs import Inputs


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        device: torch.device, t_start: float, tiny: dict | None = None):
    """``(checks, correct)`` of the control on ``seed``; ``tiny`` as
    :func:`bench.harness.cell.run`'s ``overrides`` (tests)."""
    tiny = tiny or {}
    c = registry.cell(bench, cell_name)
    ctl = registry.limits(c["config"])["control"]
    if "config" in ctl:
        over = dict(tiny, config=cell._merge(tiny.get("config", {}),
                                              ctl["config"]))
        out = cell.run(bench, cell_name, seed, seconds, False, device,
                       t_start, overrides=over)
        return out["checks"], out["correct"]
    cfg = cell._merge(registry.config(bench, c["config"]),
                      tiny.get("config", {}))
    traffic = cell._merge(registry.traffic(c["traffic"]),
                          tiny.get("traffic", {}))
    limits = cell._merge(registry.limits(c["config"])["checks"],
                         cfg.get("guarantee", {}))
    scan = Scan.from_config(cfg["geometry"])
    inputs = Inputs(scan, seed, traffic["scans"], traffic["views"], device)
    wire, low = cfg["engine"].get("strip_dtype", "float32"), \
        ctl["reference_wire"]
    envelope = bool({"psnr_db", "drop_db"} & set(limits))
    refs = cell.references(inputs, sorted({wire, low, "float32"}), device)
    zyx = voxel_coords(inputs.flat, scan.L)
    phantom = [densities(scan, e, zyx) for e in inputs.ells] \
        if envelope else None
    samples = [(s, r[low]) for s, r in enumerate(refs)]
    values = check.numbers(samples, refs, wire, envelope,
                           check.roi(zyx, scan.L), phantom)
    return check.judge(values, limits)
