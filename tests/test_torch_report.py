"""The port's dry-run report (``repro_torch.analysis.report``) against the
reference's (``repro.analysis.report``) on the golden records of
``tests/test_report.py``: the same lines, apart from the memory column,
which reads ``fits_80gb_hbm`` (an H100's HBM) where the reference reads
``fits_16gb_hbm``, and the header's names of it and of the useful-flops
ratio.  Under 1 s (``--durations``).
"""

import json

import pytest

import repro.analysis.report as ref
import repro_torch.analysis.report as ours


def _rec(arch="a100", shape="1b", mesh="pod", status="ok", fits=True,
         **over):
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh, "status": status,
        "step": "train",
        "roofline": {"compute_s": 2e-3, "memory_s": 4e-3,
                     "collective_s": 5e-4, "dominant": "memory",
                     "bound_s": 4e-3},
        "useful_flops_ratio": 0.62,
        "memory": {"live_bytes": 12.8e9},
        "fits_16gb_hbm": fits, "fits_80gb_hbm": fits,
    }
    rec.update(over)
    return rec


GOLDEN = [
    _rec(arch="h100", shape="8b", status="skipped"),
    _rec(),
    _rec(arch="h100", shape="1b", status="error", error="OOM during layout"),
    _rec(mesh="multipod"),
    _rec(arch="b200", fits=False),
]


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_roofline_table_renders_as_the_reference(mesh):
    got = ours.roofline_table(GOLDEN, mesh).splitlines()
    want = ref.roofline_table(GOLDEN, mesh).splitlines()
    assert len(got) == len(want) > 2
    assert "fits 80 GB (H100 HBM)" in got[0] and "fits 16GB" in want[0]
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        assert g.rsplit("|", 2)[0] == w.rsplit("|", 2)[0]
        assert g.rsplit("|", 2)[1] == w.rsplit("|", 2)[1]


def test_the_memory_column_reads_80_gb():
    r = _rec(fits=True)
    r["fits_16gb_hbm"] = False
    assert ours.roofline_table([r], "pod").endswith("| yes |")
    assert ref.roofline_table([r], "pod").endswith("| NO |")


def test_fmt_s_and_summary_as_the_reference():
    for x in (0, 1.5, 2.5e-3, 42e-6, 7e-9, 3e-10):
        assert ours._fmt_s(x) == ref._fmt_s(x)
    recs = GOLDEN + [_rec(status="error", error="x" * 200)]
    assert ours.summary(recs) == ref.summary(recs)


def test_load_and_main(tmp_path, capsys, monkeypatch):
    for i, r in enumerate(GOLDEN):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    (tmp_path / "notes.txt").write_text("ignored")
    assert ours.load(str(tmp_path)) == ref.load(str(tmp_path))
    monkeypatch.setattr("sys.argv", ["report", str(tmp_path)])
    ours.main()
    got = capsys.readouterr().out
    ref.main()
    want = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0] \
        == "cells: 3 ok, 1 skipped, 1 error"
    assert "### Roofline — mesh `pod` (256 chips)" in got
    assert "### Roofline — mesh `multipod` (512 chips)" in got
    assert len(got.splitlines()) == len(want.splitlines())
