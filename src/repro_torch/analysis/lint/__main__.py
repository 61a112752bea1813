"""``python -m repro_torch.analysis.lint``: run the port's contract
checker.

The counterpart of ``python -m repro.analysis.lint``, with its four pass
names, flags and JSON document.  Runs the four passes (or a
``--passes`` subset), prints one JSON document (``{"ok", "findings",
"passes"}``) to stdout, and exits nonzero when any finding survives.
``--kernel-fixture`` checks one ``.cu`` file in place of the kernel
library it stands for (the launch-contract pass); ``--tuned-config``
audits a single cache file instead of the tune dir.
"""

from __future__ import annotations

import argparse
import json
import sys

from .budget import screen_candidate_spaces
from .cache_audit import audit_cache_file, run_cache_audit_pass
from .common import PassResult
from .hygiene import run_hygiene_pass
from .ledger import run_ledger_pass

PASSES = ("ledger", "budget", "hygiene", "cache")


def _budget_pass() -> PassResult:
    findings, checked = screen_candidate_spaces()
    return PassResult("budget", findings, checked)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Kernel contract checker: launch contract, shared-"
                    "memory budget, trace hygiene, tuned-cache audit.")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {PASSES}")
    ap.add_argument("--root", default="src",
                    help="source tree the hygiene pass walks")
    ap.add_argument("--tune-dir", default=None,
                    help="cache dir to audit (default: tune_dir())")
    ap.add_argument("--kernel-fixture", default=None, metavar="PATH",
                    help="check this .cu file against the bindings of the "
                         "kernel library it stands for, in its place")
    ap.add_argument("--tuned-config", default=None, metavar="PATH",
                    help="audit this one cache file instead of the tune "
                         "dir")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the JSON report here")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 when findings survive (the default; "
                         "kept explicit for CI)")
    args = ap.parse_args(argv)

    selected = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in selected if p not in PASSES]
    if unknown:
        ap.error(f"unknown pass(es) {unknown}; choose from {PASSES}")

    results = []
    if "ledger" in selected:
        results.append(run_ledger_pass(fixture=args.kernel_fixture))
    if "budget" in selected:
        results.append(_budget_pass())
    if "hygiene" in selected:
        results.append(run_hygiene_pass(args.root))
    if "cache" in selected:
        if args.tuned_config is not None:
            findings = audit_cache_file(args.tuned_config)
            results.append(PassResult("cache", findings, 1))
        else:
            results.append(run_cache_audit_pass(args.tune_dir))

    findings = [f for r in results for f in r.findings]
    report = {"ok": not findings,
              "findings": [f.as_dict() for f in findings],
              "passes": [r.as_dict() for r in results]}
    text = json.dumps(report, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(text + "\n")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
