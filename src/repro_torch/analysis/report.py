"""Render the dry run's roofline tables from its JSON records.

The port's counterpart of ``repro/analysis/report.py``, on the records
:mod:`repro_torch.launch.dryrun` writes (one per arch x shape x mesh).
The reference's "fits 16GB" column (a TPU v5e's HBM) is "fits 80 GB"
here: the rank's live bytes against the 80 GB of an H100's HBM
(record key ``fits_80gb_hbm``).

    PYTHONPATH=src python -m repro_torch.analysis.report experiments/dryrun_torch
"""

from __future__ import annotations

import glob
import json
import os
import sys

__all__ = ["load", "roofline_table", "summary", "main"]


def load(dirname: str):
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x):
    if x == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6),
                        ("ns", 1e-9)):
        if x >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.1e}s"


def roofline_table(recs, mesh: str) -> str:
    rows = ["| arch | shape | step | compute | memory | collective | "
            "dominant | MFU-bound | useful/traced | live GB | "
            "fits 80 GB (H100 HBM) |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                        f"skip | — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | "
                        f"| | | | |")
            continue
        ro = r["roofline"]
        # MFU bound: fraction of peak if the dominant term were the
        # only cost (compute_s / bound_s).
        mfu = ro["compute_s"] / ro["bound_s"] if ro["bound_s"] else 0.0
        ur = r.get("useful_flops_ratio")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r.get('step', '')} "
            f"| {_fmt_s(ro['compute_s'])} | {_fmt_s(ro['memory_s'])} "
            f"| {_fmt_s(ro['collective_s'])} | {ro['dominant']} "
            f"| {mfu:.1%} | {ur:.2f} "
            f"| {r['memory']['live_bytes'] / 1e9:.1f} "
            f"| {'yes' if r.get('fits_80gb_hbm') else 'NO'} |")
    return "\n".join(rows)


def summary(recs):
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skipped"]
    err = [r for r in recs if r["status"] == "error"]
    lines = [f"cells: {len(ok)} ok, {len(skip)} skipped, "
             f"{len(err)} error"]
    for r in err:
        lines.append(f"  ERROR {r['arch']} {r['shape']} {r['mesh']}: "
                     f"{r.get('error', '?')[:120]}")
    return "\n".join(lines)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    recs = load(d)
    print(summary(recs))
    for mesh in ("pod", "multipod"):
        if any(r["mesh"] == mesh for r in recs):
            print(f"\n### Roofline — mesh `{mesh}` "
                  f"({'256' if mesh == 'pod' else '512'} chips)\n")
            print(roofline_table(recs, mesh))


if __name__ == "__main__":
    main()
