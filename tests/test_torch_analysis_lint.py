"""The port's contract checker (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``).

- hygiene: the same ``(rule, where)`` findings as the reference on every
  file under ``src/`` and on every snippet of ``tests/test_lint.py``;
  ``torch.compile`` in a function is the port's one addition;
- budget: the same candidate labels as the reference's tuner at L = 8,
  32, 512, all within a block's shared memory; a planted config over
  ``SMEM_LIMIT`` flagged;
- cache: the reference's fixtures (``tests/lint_fixtures``), a planted
  config over ``SMEM_LIMIT``, and the untuned default;
- ledger (the launch contract): clean on the tree, and one planted
  fixture per rule, cut from the real sources here;
- the CLI: the reference's JSON document, exit 0 on the clean tree and
  1 on each fixture.

About 20 s in one process (``--durations``: the seven CLI runs, started
together, 7 s; the two hygiene walks 7 s; the rest under 3 s each).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import check_source as ref_check_source
from repro.analysis.lint import audit_cache_file as ref_audit_cache_file
from repro.core.backproject import GeomStatic as RefGeomStatic
from repro.core.geometry import default_geometry as ref_default_geometry
from repro.tune.space import pallas_candidates as ref_pallas_candidates
from repro_torch.analysis.lint import (audit_cache_file, check_source,
                                       run_cache_audit_pass,
                                       run_hygiene_pass, run_ledger_pass,
                                       screen_candidate_spaces)
from repro_torch.analysis.lint.budget import _SCREEN_SCALES
from repro_torch.core.backproject import GeomStatic
from repro_torch.core.geometry import default_geometry
from repro_torch.kernels.backproject import MAX_PBATCH, SMEM_LIMIT
from repro_torch.tune.cache import TUNE_SCHEMA_VERSION
from repro_torch.tune.space import kernel_smem_bytes, pallas_candidates

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
FIXTURE_KEY = "ct-L16-u39-v30-O-120-MM16--cpu--cpu.json"


def _key(findings):
    return [(f.rule, f.where) for f in findings]


# ----------------------------------------------------------------------
# Hygiene
# ----------------------------------------------------------------------

def _snippets():
    """The source snippets ``tests/test_lint.py`` hands to ``_rules``."""
    tree = ast.parse((REPO / "tests" / "test_lint.py").read_text())
    return [textwrap.dedent(n.args[0].value) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == "_rules" and n.args
            and isinstance(n.args[0], ast.Constant)]


def test_hygiene_equals_the_reference_on_src_and_its_snippets():
    files = sorted((REPO / "src").rglob("*.py"))
    assert len(files) > 50
    for path in files:
        text = path.read_text()
        assert _key(check_source(str(path), text)) == \
            _key(ref_check_source(str(path), text)), path
    snippets = _snippets()
    assert len(snippets) >= 11
    flagged = 0
    for i, text in enumerate(snippets):
        got = _key(check_source(f"<s{i}>", text))
        assert got == _key(ref_check_source(f"<s{i}>", text)), text
        flagged += bool(got)
    assert flagged >= 6


def test_hygiene_names_torch_compile_in_a_function():
    src = textwrap.dedent("""
        import re
        import torch
        STEP = torch.compile(len)
        PATTERN = re.compile("x")
        def hot(m):
            return torch.compile(m)
        def ok(m):
            return torch.compile(m)  # lint: ok(jit-in-fn)
        def words(s):
            return re.compile(s)
        """)
    assert _key(check_source("<t>", src)) == [("jit-in-fn", "<t>:7")]
    assert ref_check_source("<t>", src) == []


def test_hygiene_clean_tree():
    res = run_hygiene_pass(str(REPO / "src"))
    assert res.findings == [] and res.checked > 50


# ----------------------------------------------------------------------
# Budget: the tuner's shared-memory model over its candidates
# ----------------------------------------------------------------------

def test_budget_screens_the_reference_candidate_labels():
    findings, checked = screen_candidate_spaces()
    assert findings == []
    n = 0
    for L in _SCREEN_SCALES:
        ours = [c.label for c in pallas_candidates(
            GeomStatic.of(default_geometry().scaled(L)))]
        ref = [c.label for c in ref_pallas_candidates(
            RefGeomStatic.of(ref_default_geometry().scaled(L)))]
        assert ours == ref, L
        n += len(ours)
    assert checked == n > 0


def test_budget_flags_a_config_over_smem():
    gs = GeomStatic.of(default_geometry())
    cfg = {"double_buffer": True, "db_depth": 8, "ty": 8, "chunk": 32,
           "band": 64, "width": 1248}
    assert kernel_smem_bytes(gs, cfg) > SMEM_LIMIT
    findings, checked = screen_candidate_spaces(
        extra_configs=[("planted", gs, cfg)])
    assert checked > 1
    assert [(f.rule, f.where) for f in findings] == [("config-over-smem",
                                                      "planted")]


# ----------------------------------------------------------------------
# Cache audit
# ----------------------------------------------------------------------

def test_cache_flags_the_stale_fixture_as_the_reference():
    path = FIXTURES / "stale_tune" / FIXTURE_KEY
    ours = [f.rule for f in audit_cache_file(path)]
    assert ours == [f.rule for f in ref_audit_cache_file(path)] \
        == ["stale-schema"]


def test_cache_overflow_fixture(tmp_path):
    """The reference flags the fixture's pallas config (pbatch 1024, row
    1's plain batch kernel) for its VMEM strips.  The port flags the
    file too, its schema being the reference's (5), not the port's; read
    at the port's schema its config fits a Hopper block: row 1 stages
    only the P x 12 float32 matrices, 1024 x 48 = 49152 B, the 48 KB a
    launch may take with no opt-in, so no shared-memory reason."""
    path = FIXTURES / "overflow_tune" / FIXTURE_KEY
    assert [f.rule for f in audit_cache_file(path)] == ["stale-schema"]
    assert [f.rule for f in ref_audit_cache_file(path)] == [
        "planner-invalid"]
    data = json.loads(path.read_text())
    assert data["pallas"]["pbatch"] == MAX_PBATCH
    gs = GeomStatic(L=16, n_u=39, n_v=30, O=-120.0, MM=16.0)
    assert kernel_smem_bytes(gs, data["pallas"]) == 0
    assert MAX_PBATCH * 12 * 4 == 48 * 1024
    ours = tmp_path / FIXTURE_KEY
    ours.write_text(json.dumps(dict(data, version=TUNE_SCHEMA_VERSION)))
    assert audit_cache_file(ours) == []


def test_cache_flags_a_planted_config_over_smem(tmp_path):
    d = tmp_path / "tune"
    d.mkdir()
    # An O no default geometry has: the audit's static checks only.
    path = d / "ct-L512-u1248-v960-O-999-MM0.5--cuda--card.json"
    path.write_text(json.dumps({
        "strategy": "strip2", "opts": {"pbatch": 4}, "backend": "cuda",
        "device_kind": "card", "us_per_call": 1.0,
        "pallas": {"double_buffer": True, "db_depth": 8, "ty": 8,
                   "chunk": 32, "band": 64, "width": 1248},
        "version": TUNE_SCHEMA_VERSION}))
    res = run_cache_audit_pass(d)
    assert res.checked == 3                  # the file and the default x 2
    assert [f.rule for f in res.findings] == ["planner-invalid"]
    assert "shared memory" in res.findings[0].detail


def test_cache_audits_the_untuned_default_in_an_empty_dir(tmp_path):
    res = run_cache_audit_pass(tmp_path / "nothing-here")
    assert res.findings == [] and res.checked == 2 and res.notes


# ----------------------------------------------------------------------
# Ledger: the launch contract
# ----------------------------------------------------------------------

def _planted(tmp_path, rule: str) -> Path:
    """gather.cu with one fault of ``rule`` planted."""
    text = (CSRC / "gather.cu").read_text()
    head = text.index('extern "C" int onehot_gather_f32_launch(')
    if rule == "entry-signature-mismatch":
        cut = text.index("long long offset,", head)
        text = text[:cut] + text[cut + len("long long offset,"):]
    elif rule == "unbound-entry":
        text += ('\nextern "C" int onehot_gather_spare_launch(void* x, '
                 'int n) { return 0; }\n')
    elif rule == "missing-entry":
        text = text.replace("onehot_gather_bf16_launch(",
                            "onehot_gather_half_launch(", 1)
    else:
        text = text.replace("constexpr int kPosBits = 14;",
                            "constexpr int kPosBits = 15;")
    path = tmp_path / f"gather_{rule}.cu"
    path.write_text(text)
    return path


RULES = ("entry-signature-mismatch", "unbound-entry", "missing-entry",
         "limit-mismatch")


def test_ledger_clean_on_the_tree():
    res = run_ledger_pass()
    assert res.findings == []
    assert res.checked >= 20


@pytest.mark.parametrize("rule", RULES)
def test_ledger_flags_each_planted_fault(tmp_path, rule):
    res = run_ledger_pass(fixture=str(_planted(tmp_path, rule)))
    assert rule in {f.rule for f in res.findings}
    assert "gather" in res.notes[0]


def test_ledger_names_the_entry_and_both_counts(tmp_path):
    """The planted signature fault: the entry with the offset dropped
    against the binding that passes it."""
    res = run_ledger_pass(fixture=str(_planted(tmp_path, RULES[0])))
    (f,) = [f for f in res.findings if f.rule == RULES[0]]
    assert "onehot_gather_f32_launch takes 8 parameters" in f.detail
    assert "gather._ARGTYPES binds 9" in f.detail


# ----------------------------------------------------------------------
# The CLI (its seven runs started together, each test reading one)
# ----------------------------------------------------------------------

CLI_CASES = {"clean": (), **{
    rule: ("--passes", "ledger", "--kernel-fixture", rule) for rule in RULES},
    **{fx: ("--passes", "cache", "--tune-dir", str(FIXTURES / fx))
       for fx in ("stale_tune", "overflow_tune")}}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``{case: (exit code, report)}`` of ``python -m
    repro_torch.analysis.lint`` on each of :data:`CLI_CASES`, with
    ``--json``, whose file must hold the printed report."""
    tmp = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_TUNE_DIR=str(tmp / "tune"))
    procs = {}
    for case, args in CLI_CASES.items():
        args = tuple(str(_planted(tmp, a)) if a in RULES else a
                     for a in args)
        out = tmp / f"{case}.json"
        procs[case] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis.lint", *args,
             "--json", str(out)], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    runs = {}
    for case, (out, proc) in procs.items():
        stdout, _ = proc.communicate(timeout=300)
        report = json.loads(stdout)
        assert json.loads(out.read_text()) == report
        runs[case] = (proc.returncode, report)
    return runs


def test_cli_clean_tree_exits_zero(cli_runs):
    code, report = cli_runs["clean"]
    assert code == 0
    assert set(report) == {"ok", "findings", "passes"}
    assert report["ok"] and report["findings"] == []
    by_name = {p["pass"]: p for p in report["passes"]}
    assert list(by_name) == ["ledger", "budget", "hygiene", "cache"]
    for name, p in by_name.items():
        assert p["checked"] > 0, name
        assert set(p) == {"pass", "checked", "findings", "notes"}


@pytest.mark.parametrize("rule", RULES)
def test_cli_exits_one_on_each_kernel_fixture(cli_runs, rule):
    code, report = cli_runs[rule]
    assert code == 1 and not report["ok"]
    assert rule in {f["rule"] for f in report["findings"]}


@pytest.mark.parametrize("fixture", ["stale_tune", "overflow_tune"])
def test_cli_exits_one_on_the_tune_fixtures(cli_runs, fixture):
    code, report = cli_runs[fixture]
    assert code == 1 and not report["ok"]
    assert {f["rule"] for f in report["findings"]} == {"stale-schema"}
